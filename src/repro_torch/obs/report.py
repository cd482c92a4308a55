"""Per-request cache-decision explainers.

A :class:`CacheReport` answers, for ONE served request, the question the
aggregate metrics can't: *which steps did the cache actually skip for
me, what did the proxy signal look like against τ, and how much compute
did I really pay?*  The serving engine builds one per request at batch
finish (``telemetry=True``) from whatever the run state recorded:

* **fused adaptive** runs carry the full per-row desired-skip trace —
  and, with step telemetry on, the per-row proxy values — in tensors the
  fused step writes on the device, so the report is exact per row and
  costs one device read of each at the finish boundary
  (``host_sync_count`` stays 0);
* **host-dispatched adaptive** runs record the realized (batch-AND)
  decisions only — desired == realized in their reports;
* **static** entries derive the report from the schedule (every row
  identical, by construction).

Step 0's proxy is reported as ``None``: the fused step's previous-input
buffer is zeros before the first step, so the raw value is meaningless
(the decision rule force-computes step 0 for the same reason).  The
PyTorch port of the JAX package's ``obs.report``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CacheReport:
    """Cache behavior of one request (one batch row) over its run.

    ``desired[s]`` is the skip set this row's own accumulator state
    wanted at step ``s``; ``realized[s]`` is the skip set the batch
    executed (the AND over co-batched rows — ``desired`` minus what a
    conservative neighbor forced to compute).  ``proxy[s]`` is the row's
    relative-L1 change signal when step telemetry recorded it."""
    tau: float
    types: Tuple[str, ...]
    desired: Tuple[Tuple[str, ...], ...]
    realized: Tuple[Tuple[str, ...], ...]
    proxy: Optional[Tuple[Optional[float], ...]] = None

    @property
    def num_steps(self) -> int:
        return len(self.realized)

    def skipped_per_type(self) -> Dict[str, int]:
        """Executed (realized) skip count per layer type."""
        out = {t: 0 for t in self.types}
        for skips in self.realized:
            for t in skips:
                out[t] = out.get(t, 0) + 1
        return out

    def desired_per_type(self) -> Dict[str, int]:
        out = {t: 0 for t in self.types}
        for skips in self.desired:
            for t in skips:
                out[t] = out.get(t, 0) + 1
        return out

    def realized_compute_fraction(self) -> float:
        """Fraction of this row's (step × type) layer evaluations that
        actually ran."""
        total = self.num_steps * len(self.types)
        if total == 0:
            return 1.0
        skipped = sum(len(s) for s in self.realized)
        return 1.0 - skipped / float(total)

    def proxy_vs_threshold(self) -> List[Dict]:
        """Per-step trajectory rows ``{step, proxy, desired, realized}``
        for plotting the signal against ``tau``."""
        out = []
        for s in range(self.num_steps):
            out.append({
                "step": s,
                "proxy": None if self.proxy is None else self.proxy[s],
                "desired": list(self.desired[s]),
                "realized": list(self.realized[s]),
            })
        return out

    def to_jsonable(self) -> Dict:
        return {
            "tau": self.tau,
            "types": list(self.types),
            "num_steps": self.num_steps,
            "skipped_per_type": self.skipped_per_type(),
            "desired_per_type": self.desired_per_type(),
            "realized_compute_fraction": self.realized_compute_fraction(),
            "trajectory": self.proxy_vs_threshold(),
        }


def _sig(types: Tuple[str, ...], row) -> Tuple[str, ...]:
    return tuple(t for t, bit in zip(types, row) if bool(bit))


def _host(a) -> np.ndarray:
    """One device→host read of a tensor (numpy arrays pass through)."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def fused_cache_reports(rs) -> List["CacheReport"]:
    """Exact per-row reports from a fused run's on-device trace — ONE
    boundary device read of the (S, B, T) bool trace (plus one of the
    (S, B) proxy trace when step telemetry was on), never a per-step
    sync."""
    bits = _host(rs.trace[: rs.step])                        # (S, B, T)
    types = tuple(rs.pool_types)
    realized = tuple(_sig(types, row)
                     for row in bits.all(axis=1))            # AND over rows
    proxy_rows = None
    if getattr(rs, "proxy_trace", None) is not None:
        proxy_rows = _host(rs.proxy_trace[: rs.step])
    out = []
    for b in range(bits.shape[1] if bits.ndim == 3 else 0):
        desired = tuple(_sig(types, bits[s, b])
                        for s in range(bits.shape[0]))
        proxy = None
        if proxy_rows is not None:
            proxy = tuple(None if s == 0 else float(proxy_rows[s, b])
                          for s in range(proxy_rows.shape[0]))
        out.append(CacheReport(tau=float(rs.tau), types=types,
                               desired=desired, realized=realized,
                               proxy=proxy))
    return out


def schedule_cache_report(schedule, tau: float = 0.0) -> "CacheReport":
    """Static entry: the schedule IS the decision record, identical for
    every row."""
    types = tuple(sorted(schedule.skip))
    decisions = tuple(
        tuple(t for t in types if schedule.skip[t][s])
        for s in range(schedule.num_steps))
    return CacheReport(tau=float(tau), types=types, desired=decisions,
                       realized=decisions)


def run_cache_reports(rs, batch: int, schedule=None,
                      tau: float = 0.0) -> List["CacheReport"]:
    """Best-effort reports for any run-state kind (the engine's single
    entry point).  Fused states yield exact per-row reports; states that
    only expose realized ``decisions`` (host adaptive loop, fakes) yield
    desired == realized; static runs fall back to the schedule.  Returns
    ``[]`` when nothing is reconstructible."""
    if getattr(rs, "trace", None) is not None \
            and hasattr(rs, "pool_types"):
        return fused_cache_reports(rs)
    decisions = getattr(rs, "decisions", None)
    if decisions:
        types = tuple(getattr(rs, "pool_types", None)
                      or (sorted(schedule.skip) if schedule is not None
                          else sorted({t for d in decisions for t in d})))
        realized = tuple(tuple(d) for d in decisions)
        rep = CacheReport(tau=float(getattr(rs, "tau", tau)), types=types,
                          desired=realized, realized=realized)
        return [rep] * batch
    if schedule is not None:
        return [schedule_cache_report(schedule, tau)] * batch
    return []
