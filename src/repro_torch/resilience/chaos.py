"""Deterministic fault injection for the serving stack.

A :class:`FaultPlan` is a *seeded schedule* of faults keyed by batch
serial number (the order in which the engine launches runs): given the
same seed and the same trace, the same batches fault in the same way on
the same advance — chaos tests are exact, replayable assertions, not
flaky coin flips.  :class:`ChaosExecutor` wraps any executor (real or the
test fakes) and applies the plan at advance boundaries:

* ``nan_latent`` — poison one row's latent (a real latent tensor gets an
  actual NaN written into a copy of it, so the executor's health
  sentinels must catch it; fake run states without latents get the row
  marked on the wrapper's health flags directly),
* ``stuck_batch`` — stall the clock past the engine watchdog's deadline,
* ``injected``  — raise a :class:`~repro_torch.resilience.faults.BatchFault`
  mid-advance (models an executor-level crash the engine must absorb).

:class:`ChaosClock` independently slows a seeded fraction of virtual
advances (degraded-device weather), and :func:`corrupt_artifact` bit-rots
an artifact file on disk without updating its checksum — the store's
integrity layer must refuse it.

Nothing here imports the engine or the store: the harness is a pure
wrapper layer the benchmarks and tests compose from the outside.  The
PyTorch port of the JAX package's ``resilience.chaos``: the plans draw
from the same seed strings, so a plan strikes the same serials, rows and
chunks in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import random
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.resilience import faults
from repro_torch.resilience.faults import BatchFault


# ---------------------------------------------------------------------------
# Fault schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: strike ``kind`` on the ``chunk``-th advance
    (1-based) of a run.  ``row`` picks the poisoned sample for
    ``nan_latent`` (None ⇒ row 0); ``stall_s`` is the injected stall for
    ``stuck_batch``."""
    kind: str
    row: Optional[int] = None
    chunk: int = 1
    stall_s: float = 0.0

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError(f"chunk counts from 1, got {self.chunk}")


@dataclasses.dataclass
class FaultPlan:
    """Seeded per-batch fault schedule.

    ``for_batch(serial, bucket)`` draws (memoized — repeated calls agree)
    from ``random.Random((seed, serial))``: with probability ``nan_rate``
    a NaN-latent fault on a uniform row, then ``stuck_rate`` a stalled
    advance of ``stall_s``, then ``error_rate`` an injected exception;
    otherwise the batch runs clean.  Explicit ``faults[serial]`` entries
    override the draw — how a test targets exactly the first batch.
    Retries launch new runs with new serials, so a faulted request's
    re-run is (with high probability) clean — the recovery path, not the
    fault, is what gets exercised repeatedly."""
    seed: int = 0
    nan_rate: float = 0.0
    stuck_rate: float = 0.0
    error_rate: float = 0.0
    stall_s: float = 5.0
    max_chunk: int = 2                # faults strike on advance 1..max_chunk
    faults: Dict[int, FaultSpec] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for name in ("nan_rate", "stuck_rate", "error_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.nan_rate + self.stuck_rate + self.error_rate > 1.0 + 1e-12:
            raise ValueError("fault rates must sum to <= 1")
        if self.max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {self.max_chunk}")
        self._memo: Dict[tuple, Optional[FaultSpec]] = {}

    @property
    def fault_rate(self) -> float:
        return self.nan_rate + self.stuck_rate + self.error_rate

    def for_batch(self, serial: int, bucket: int) -> Optional[FaultSpec]:
        key = (int(serial), int(bucket))
        if key in self._memo:
            return self._memo[key]
        spec = self.faults.get(int(serial))
        if spec is None and self.fault_rate > 0:
            # str seeds hash via sha512 — stable across processes and
            # Python versions (tuple seeding is deprecated + randomized)
            rng = random.Random(f"{self.seed}:{int(serial)}")
            u = rng.random()
            chunk = 1 + rng.randrange(self.max_chunk)
            if u < self.nan_rate:
                spec = FaultSpec(faults.NAN_LATENT,
                                 row=rng.randrange(max(1, bucket)),
                                 chunk=chunk)
            elif u < self.nan_rate + self.stuck_rate:
                spec = FaultSpec(faults.STUCK_BATCH, chunk=chunk,
                                 stall_s=self.stall_s)
            elif u < self.fault_rate:
                spec = FaultSpec(faults.INJECTED, chunk=chunk)
        self._memo[key] = spec
        return spec


class ChaosClock:
    """Clock wrapper that deterministically slows a seeded fraction of
    ``advance`` calls by ``slow_s`` — degraded-device weather for
    virtual-clock benches.  ``now``/``sleep_until`` pass through."""

    def __init__(self, inner, seed: int = 0, slow_rate: float = 0.0,
                 slow_s: float = 0.0):
        if not (0.0 <= slow_rate <= 1.0):
            raise ValueError(f"slow_rate must be in [0, 1], got {slow_rate}")
        self._inner = inner
        self.seed = seed
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self.slowed = 0                       # advances that got the tax
        self._n = 0

    def now(self) -> float:
        return self._inner.now()

    def sleep_until(self, t: float) -> None:
        self._inner.sleep_until(t)

    def advance(self, dt: float) -> float:
        self._n += 1
        if (self.slow_rate
                and random.Random(f"{self.seed}:{self._n}").random()
                < self.slow_rate):
            dt = float(dt) + self.slow_s
            self.slowed += 1
        return self._inner.advance(dt)


# ---------------------------------------------------------------------------
# Executor wrapper
# ---------------------------------------------------------------------------

class ChaosRun:
    """Run-state proxy: delegates everything to the wrapped state, tracks
    the advance count against the batch's :class:`FaultSpec`, and merges
    chaos-marked poisoned rows into the ``healthy`` flags the engine
    reads."""

    def __init__(self, inner, spec: Optional[FaultSpec], batch: int,
                 serial: int):
        self._inner = inner
        self._spec = spec
        self._batch = int(batch)
        self._serial = int(serial)
        self._advances = 0
        self._struck = False
        self._poisoned = set()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def healthy(self):
        inner = getattr(self._inner, "healthy", None)
        if not self._poisoned:
            return inner
        if inner is None:
            flags = np.ones(self._batch, bool)
        elif isinstance(inner, torch.Tensor):
            flags = inner.cpu().numpy().astype(bool)
        else:
            flags = np.asarray(inner).astype(bool).copy()
        for r in self._poisoned:
            if 0 <= r < flags.shape[0]:
                flags[r] = False
        return flags


class ChaosExecutor:
    """Executor wrapper applying a :class:`FaultPlan` at advance
    boundaries.

    ``mutate_latent`` (default True) writes a real NaN into the run's
    latent when one exists — the wrapped executor's sentinels must then
    detect it (set ``mark_flags=False`` to test *only* that detection
    path).  ``mark_flags`` (default True) additionally marks the row on
    the proxy's health flags, which is what makes NaN faults visible on
    test fakes that carry no latents mid-run.  Everything not overridden
    here (``sample``, compile counters, ``supports_fused_adaptive``,
    ``host_sync_count`` …) delegates to the wrapped executor untouched.
    """

    def __init__(self, inner, plan: FaultPlan, clock=None, *,
                 mutate_latent: bool = True, mark_flags: bool = True):
        self._inner = inner
        self.plan = plan
        self.clock = clock
        self.mutate_latent = mutate_latent
        self.mark_flags = mark_flags
        self.serial = 0                       # runs launched so far
        self.injected: Dict[str, int] = {}    # kind → count actually struck

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name == "fused_step_for":
            # takes a run state: the wrapped executor's step is keyed on
            # the real one (present only where the wrapped executor has a
            # fused step, as a serving engine probes for it)
            return lambda params, rs: attr(
                params, rs._inner if isinstance(rs, ChaosRun) else rs)
        return attr

    # -- run lifecycle -------------------------------------------------------

    def _wrap(self, rs, batch: int) -> ChaosRun:
        serial = self.serial
        self.serial += 1
        return ChaosRun(rs, self.plan.for_batch(serial, batch), batch,
                        serial)

    def start_run(self, params, key, batch, **kw):
        return self._wrap(self._inner.start_run(params, key, batch, **kw),
                          batch)

    def start_adaptive_run(self, params, key, batch, **kw):
        return self._wrap(
            self._inner.start_adaptive_run(params, key, batch, **kw), batch)

    def start_adaptive_fused_run(self, params, key, batch, **kw):
        return self._wrap(
            self._inner.start_adaptive_fused_run(params, key, batch, **kw),
            batch)

    def advance_run(self, params, rs: ChaosRun, **kw):
        rs._inner = self._inner.advance_run(params, rs._inner, **kw)
        rs._advances += 1
        self._strike(rs)
        return rs

    def advance_adaptive_run(self, params, rs: ChaosRun, **kw):
        rs._inner = self._inner.advance_adaptive_run(params, rs._inner,
                                                     **kw)
        rs._advances += 1
        self._strike(rs)
        return rs

    def advance_adaptive_fused(self, params, rs: ChaosRun, **kw):
        rs._inner = self._inner.advance_adaptive_fused(params, rs._inner,
                                                       **kw)
        rs._advances += 1
        self._strike(rs)
        return rs

    # -- split / merge (continuous batching) ---------------------------------

    def split_run(self, rs, groups):
        """Forward a run-state split through the proxy: the wrapped
        states are split for real, and each sub-run keeps the poisoned
        rows that landed in its group (remapped to sub-run indices).
        Sub-runs carry no pending :class:`FaultSpec` — an unstruck fault
        dies with the split; chaos plans key on launch serials, and a
        split is not a launch."""
        if not isinstance(rs, ChaosRun):
            return self._inner.split_run(rs, groups)
        subs = self._inner.split_run(rs._inner, groups)
        out = []
        for g, sub in zip(groups, subs):
            cr = ChaosRun(sub, None, len(g), rs._serial)
            cr._advances = rs._advances
            cr._struck = rs._struck
            cr._poisoned = {i for i, j in enumerate(g)
                            if j in rs._poisoned}
            out.append(cr)
        return out

    def merge_runs(self, runs):
        """Merge through the proxy; poisoned-row marks concatenate with
        the rows."""
        if not any(isinstance(r, ChaosRun) for r in runs):
            return self._inner.merge_runs(runs)
        inners = [r._inner if isinstance(r, ChaosRun) else r
                  for r in runs]
        merged = self._inner.merge_runs(inners)
        batches = [(r._batch if isinstance(r, ChaosRun)
                    else int(r.x.shape[0])) for r in runs]
        cr = ChaosRun(merged, None, sum(batches),
                      next(r._serial for r in runs
                           if isinstance(r, ChaosRun)))
        cr._advances = max(r._advances for r in runs
                           if isinstance(r, ChaosRun))
        cr._struck = True                     # never re-strike a merge
        off = 0
        pois = set()
        for r, b in zip(runs, batches):
            if isinstance(r, ChaosRun):
                pois |= {off + i for i in r._poisoned}
            off += b
        cr._poisoned = pois
        return cr

    # -- snapshot seams (durable serving) ------------------------------------

    def export_run(self, rs):
        """Unwrap the proxy and export the real run state.  Chaos
        bookkeeping (pending :class:`FaultSpec`, poisoned-row marks) is
        deliberately NOT serialized — a restart is a fresh process and
        the plan keys on launch serials, which a restore is not."""
        inner = rs._inner if isinstance(rs, ChaosRun) else rs
        return self._inner.export_run(inner)

    def import_run(self, params, kind, arrays, static, **kw):
        """Import through the wrapped executor, then re-wrap so the
        engine keeps seeing the proxy type it launched with.  The
        restored run carries no pending fault (same rationale as
        :meth:`split_run`)."""
        rs = self._inner.import_run(params, kind, arrays, static, **kw)
        return ChaosRun(rs, None, int(static["batch"]), -1)

    # -- fault application ---------------------------------------------------

    def _strike(self, rs: ChaosRun) -> None:
        spec = rs._spec
        if spec is None or rs._struck or rs._advances < spec.chunk:
            return
        rs._struck = True
        self.injected[spec.kind] = self.injected.get(spec.kind, 0) + 1
        if spec.kind == faults.INJECTED:
            raise BatchFault(faults.INJECTED,
                             detail=f"chaos plan, run serial {rs._serial}")
        if spec.kind == faults.STUCK_BATCH:
            adv = getattr(self.clock, "advance", None)
            if adv is not None:
                adv(spec.stall_s)
            else:                              # wall clock: really stall
                time.sleep(spec.stall_s)
            return
        if spec.kind == faults.NAN_LATENT:
            row = 0 if spec.row is None else int(spec.row) % rs._batch
            x = getattr(rs._inner, "x", None)
            if (self.mutate_latent and isinstance(x, torch.Tensor)
                    and dataclasses.is_dataclass(rs._inner)):
                # out of place: the run's latent may be shared (a split
                # sibling's rows, a fused graph's unloaded copy), and an
                # in-place write would poison rows no plan named
                poisoned = x.clone()
                poisoned[row] = float("nan")
                rs._inner = dataclasses.replace(rs._inner, x=poisoned)
            if self.mark_flags:
                rs._poisoned.add(row)
            return
        raise ValueError(f"unknown fault kind in plan: {spec.kind!r}")


# ---------------------------------------------------------------------------
# On-disk corruption
# ---------------------------------------------------------------------------

def corrupt_artifact(path, seed: int = 0):
    """Bit-rot an artifact file in place: perturb one numeric leaf of the
    JSON payload (seeded choice) *without* touching the stored checksum —
    exactly the corruption
    :func:`repro_torch.resilience.integrity.verify_payload`
    exists to catch.  Returns ``path``."""
    with open(path) as f:
        obj = json.load(f)
    leaves = []

    def collect(container):
        items = (container.items() if isinstance(container, dict)
                 else enumerate(container) if isinstance(container, list)
                 else ())
        for k, v in items:
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                if k != "format_version":
                    leaves.append((container, k))
            elif isinstance(v, (dict, list)):
                collect(v)

    collect(obj)
    rng = random.Random(seed)
    if leaves:
        c, k = leaves[rng.randrange(len(leaves))]
        c[k] = float(c[k]) * 3.0 + 1.25
    else:
        obj["__chaos__"] = int(seed)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path
