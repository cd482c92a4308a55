"""Load estimation: the calibrated per-step service cost and the backlog.

The load signal is **queue depth × calibrated per-step service cost**: the
:class:`ServiceCostModel` learns seconds-per-sampling-step online from the
engine's finished batches (an EWMA, optionally per store entry — a heavily
cached entry's steps are cheaper than full compute), and the
:class:`LoadEstimator` turns the ready queue plus the in-flight runs'
remaining steps into an estimated backlog in seconds.  The engine builds
both; EDF scheduling reads the cost model.  The JAX package's
``AdmissionController`` (admit / defer / shed against the backlog) is not
ported yet (``ROADMAP.md`` queue 1, item 8).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional


class ServiceCostModel:
    """Online EWMA of observed service seconds per sampling step.

    ``observe`` is fed per finished micro-batch (service time of the whole
    batch over its step count — batching amortizes, so this is a per-batch
    step cost, and under interleaving it includes contention from
    co-scheduled runs, which is exactly the pessimism an admission wait
    estimate wants).  EWMAs are keyed on ``(group, bucket)`` — the group
    is the *resolved* store entry, i.e. the ladder rung a batch actually
    ran, and the bucket its power-of-two batch size — so a ladder move or
    a continuous-batching regroup never transiently mis-prices the
    backlog with another rung's (or another batch shape's) step cost.
    ``per_step(group, bucket)`` falls back ``(rung, bucket)`` → rung →
    global → seed default, so coarse estimates remain available before
    a key has observations.
    """

    def __init__(self, default_step_cost: float = 0.1, alpha: float = 0.3):
        if default_step_cost <= 0:
            raise ValueError(f"default_step_cost must be > 0, got "
                             f"{default_step_cost}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.default_step_cost = float(default_step_cost)
        self.alpha = float(alpha)
        self._global: Optional[float] = None
        self._per_group: Dict[str, float] = {}
        self._per_key: Dict[tuple, float] = {}

    def _ewma(self, prev: Optional[float], c: float) -> float:
        return c if prev is None else \
            (1 - self.alpha) * prev + self.alpha * c

    def observe(self, group: str, service_s: float, num_steps: int,
                bucket: Optional[int] = None) -> None:
        if num_steps < 1 or service_s < 0:
            return
        c = service_s / float(num_steps)
        self._global = self._ewma(self._global, c)
        self._per_group[group] = self._ewma(self._per_group.get(group), c)
        if bucket is not None:
            key = (group, int(bucket))
            self._per_key[key] = self._ewma(self._per_key.get(key), c)

    def per_step(self, group: Optional[str] = None,
                 bucket: Optional[int] = None) -> float:
        if group is not None and bucket is not None:
            key = (group, int(bucket))
            if key in self._per_key:
                return self._per_key[key]
        if group is not None and group in self._per_group:
            return self._per_group[group]
        if self._global is not None:
            return self._global
        return self.default_step_cost

    def estimate(self, num_steps: int, group: Optional[str] = None,
                 bucket: Optional[int] = None) -> float:
        """Estimated service seconds for a run of ``num_steps`` steps."""
        return self.per_step(group, bucket) * max(int(num_steps), 0)

    def snapshot(self) -> Dict:
        """The calibrated state as one JSON-safe dict — what the engine
        exports into the metrics registry as ``slo.step_cost_s`` gauges
        (observability of the admission pricing, not just its
        decisions)."""
        return {
            "global": self._global,
            "per_group": dict(sorted(self._per_group.items())),
            "per_key": {f"{g}|b{b}": v for (g, b), v in
                        sorted(self._per_key.items())},
        }


class LoadEstimator:
    """Backlog in seconds from queue depth and in-flight remaining work.

    ``batch_factor`` amortizes queued requests over micro-batching (under
    load, batches fill up to ``max_batch``, so ``max_batch`` queued
    requests cost roughly one run).  In-flight step counts are already
    per batch and enter unamortized."""

    def __init__(self, cost_model: ServiceCostModel, *,
                 batch_factor: float = 1.0):
        if batch_factor < 1:
            raise ValueError(f"batch_factor must be >= 1, got "
                             f"{batch_factor}")
        self.cost_model = cost_model
        self.batch_factor = float(batch_factor)

    def backlog_seconds(self, queued_steps: Iterable[int],
                        inflight_steps: Iterable[int]) -> float:
        c = self.cost_model.per_step()
        queued = sum(max(int(s), 0) for s in queued_steps)
        inflight = sum(max(int(s), 0) for s in inflight_steps)
        return c * (queued / self.batch_factor + inflight)
