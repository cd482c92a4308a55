"""Degrade-don't-die recovery policy: bounded retries + the fault ladder.

The serving engine owns the mechanics (re-queueing survivors, resubmitting
faulted requests, terminal sheds); this module owns the *policy* knobs —
how many retries a faulted request gets, how long to back off between
attempts, and whether a retry also steps the request down the degradation
ladder (current rung → τ=0 → ``no_cache``, materialized by
:meth:`repro_torch.serve.store.ArtifactStore.degraded_entry_name`).

Everything here is deterministic: backoff jitter is a pure function of
``(seed, rid, attempt)``, never of wall time or a global RNG, so a
virtual-clock replay of a faulty trace reproduces the exact same retry
schedule — the property the chaos tests assert.  A plain Python copy of
the JAX package's ``resilience.recovery``: the same seed strings, so the
same delays, float for float.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``delay(attempt, rid)`` (attempt counts from 1) returns
    ``base × factor^(attempt-1)`` scaled by a jitter factor drawn
    uniformly from ``[1-jitter, 1+jitter]`` — seeded per (rid, attempt),
    so the schedule is reproducible on both :class:`VirtualClock` and
    :class:`WallClock` runs."""
    max_retries: int = 2
    backoff_base: float = 0.05            # seconds before the first retry
    backoff_factor: float = 2.0
    jitter: float = 0.1                   # ± fraction of the delay
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_base < 0 or self.backoff_factor < 1:
            raise ValueError("backoff needs base >= 0 and factor >= 1")
        if not (0 <= self.jitter < 1):
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay(self, attempt: int, rid: int = 0) -> float:
        if attempt < 1:
            raise ValueError(f"attempt counts from 1, got {attempt}")
        d = self.backoff_base * self.backoff_factor ** (attempt - 1)
        if self.jitter:
            # str seed: stable sha512 path (tuple seeding is deprecated)
            u = random.Random(
                f"{self.seed}:{int(rid)}:{int(attempt)}").random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return d


@dataclasses.dataclass
class ResiliencePolicy:
    """Engine-wide fault handling configuration.

    Passing one to :class:`~repro_torch.serve.engine.ServeEngine` turns the
    fault path on: health flags are read at every advance boundary,
    ``BatchFault`` s raised mid-advance are recovered instead of
    propagated, the stall guard sheds (reason ``stalled``) instead of
    raising, and — when ``watchdog_factor`` is set — an advance whose
    wall/virtual duration exceeds ``estimate × factor + floor`` is
    treated as a ``stuck_batch`` fault: the run is abandoned and every
    member re-queued at its original arrival.  The estimate comes from
    the engine's :class:`~repro_torch.slo.admission.ServiceCostModel` keyed on
    the batch's ``(rung, bucket)``, the same key admission prices with —
    a ladder move or a regrouped bucket size gets its own deadline, not
    another shape's.  ``None`` (the engine default) keeps the exact
    pre-resilience behavior: zero health reads, zero overhead."""
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    #: advance deadline = cost_model.estimate(steps, rung, bucket) ×
    #: factor + floor; None disables the watchdog (health sentinels stay
    #: active)
    watchdog_factor: Optional[float] = None
    watchdog_floor_s: float = 1.0
    #: when a per-row fault hits a divisible run (the executor exposes
    #: ``split_run`` and the solver is deterministic), split the faulted
    #: rows out and let survivors *continue* with their run-state intact
    #: instead of abandoning the whole batch; faulted rows still follow
    #: the retry/degradation ladder.  False restores restart-everyone.
    split_retry: bool = True
    #: step faulted requests down the store's degradation ladder
    #: (current rung → τ=0 → no_cache) on each retry; False retries on
    #: the original entry
    degrade: bool = True
    #: consecutive engine-observed faults after which an entry is marked
    #: unhealthy in the store's registry (unresolvable at formation);
    #: None never trips
    entry_fault_threshold: Optional[int] = None

    def deadline(self, est_s: float) -> float:
        """Watchdog deadline for an advance with estimated service time
        ``est_s`` — the ``est × factor + floor`` formula lives here (the
        policy layer) so the engine only supplies the estimate.  Raises
        when the watchdog is disabled (``watchdog_factor=None``); callers
        gate on that, as the engine does."""
        if self.watchdog_factor is None:
            raise ValueError("watchdog disabled (watchdog_factor=None)")
        return float(est_s) * self.watchdog_factor + self.watchdog_floor_s

    def __post_init__(self):
        if self.watchdog_factor is not None and self.watchdog_factor <= 0:
            raise ValueError("watchdog_factor must be > 0 or None")
        if self.watchdog_floor_s < 0:
            raise ValueError("watchdog_floor_s must be >= 0")
        if (self.entry_fault_threshold is not None
                and self.entry_fault_threshold < 1):
            raise ValueError("entry_fault_threshold must be >= 1 or None")
