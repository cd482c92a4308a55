"""τ-elastic degradation controller.

SmoothCache's error budget τ is the one load lever an LLM server does not
have: under overload the deployment can *degrade quality smoothly* —
serve at a higher τ rung, reusing more layer outputs per step — instead of
queueing into deadline misses or dropping requests.  The mechanism is the
τ **ladder** registered in the
:class:`~repro_torch.serve.store.ArtifactStore`: several rungs of the *same*
artifact, identical schedule / candidate pool / proxy→error map, differing
only in the runtime threshold τ.  Because the fused adaptive path reads
τ (and ``k_max``) from buffers of the one captured CUDA graph per batch
bucket (:mod:`repro_torch.core.fused`), moving between τ > 0 rungs
captures **no** new graph — rung changes are a host-side pointer swap.

:class:`ElasticTauController` closes the loop: it observes realized queue
waits (fed by the ``elastic`` scheduling policy from finished batches),
compares the rolling p95 against ``target_p95_wait_s``, and moves the
active rung up (degrade) or down (recover).  Flap suppression is
threefold — a dead band around the target, a cooldown after any change,
and a ``settle`` count of consecutive calm windows required before
stepping back down — asserted by the hysteresis test on a steady trace.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple


def _p95(xs: Sequence[float]) -> float:
    """Linear-interpolation p95 (local so the slo layer stays free of
    serve imports; the definition of
    repro_torch.serve.metrics.percentile)."""
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = 0.95 * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (rank - lo))


class ElasticTauController:
    """Feedback loop: measured p95 queue wait vs target → ladder rung.

    ``update(now)`` evaluates at most once per ``interval_s`` and needs at
    least ``min_samples`` waits in the window:

    * p95 > target × (1 + band)  →  step **up** one rung (more reuse,
      cheaper steps) — at most once per ``cooldown_s``;
    * p95 < target × (1 − band) for ``settle`` consecutive windows →
      step **down** one rung (recover quality);
    * otherwise hold.

    The wait window is cleared on every rung change so the next decision
    measures the *new* operating point rather than averaging across the
    transition.  ``history`` records ``(time, rung, p95)`` at each change
    for tests and the benchmark's controller trace."""

    def __init__(self, num_rungs: int, target_p95_wait_s: float, *,
                 window: int = 64, min_samples: int = 4,
                 interval_s: float = 1.0, band: float = 0.25,
                 cooldown_s: float = 3.0, settle: int = 2,
                 start_rung: int = 0, registry=None, tracer=None):
        if num_rungs < 1:
            raise ValueError(f"num_rungs must be >= 1, got {num_rungs}")
        if target_p95_wait_s <= 0:
            raise ValueError(f"target_p95_wait_s must be > 0, got "
                             f"{target_p95_wait_s}")
        if not 0 <= band < 1:
            raise ValueError(f"band must be in [0, 1), got {band}")
        if not 0 <= start_rung < num_rungs:
            raise ValueError(f"start_rung {start_rung} outside ladder of "
                             f"{num_rungs} rungs")
        self.num_rungs = int(num_rungs)
        self.target = float(target_p95_wait_s)
        self.window = int(window)
        self.min_samples = max(int(min_samples), 1)
        self.interval_s = float(interval_s)
        self.band = float(band)
        self.cooldown_s = float(cooldown_s)
        self.settle = max(int(settle), 1)
        self.rung = int(start_rung)
        #: optional observability hooks (repro_torch.obs): the registry gets
        #: ``slo.p95_wait_s`` / ``slo.rung`` ring-buffer time series at
        #: every evaluation (not just changes — trajectories need the
        #: holds too); the tracer gets a ``rung_move`` instant per change
        self.registry = registry
        self.tracer = tracer
        self.history: List[Tuple[float, int, float]] = []
        self._waits: Deque[float] = deque(maxlen=self.window)
        self._last_eval: Optional[float] = None
        self._last_change: Optional[float] = None
        self._calm = 0

    def observe_wait(self, wait_s: float, now: float) -> None:
        self._waits.append(float(wait_s))

    def _cooled(self, now: float) -> bool:
        return (self._last_change is None
                or now - self._last_change >= self.cooldown_s)

    def _move(self, now: float, rung: int, p95: float) -> int:
        old = self.rung
        self.rung = rung
        self.history.append((now, rung, p95))
        self._last_change = now
        self._waits.clear()
        self._calm = 0
        if self.tracer is not None:
            self.tracer.instant("rung_move", rung=rung, from_rung=old,
                                p95_wait_s=p95)
        if self.registry is not None:
            self.registry.series("slo.rung").record(now, float(rung))
        return rung

    def update(self, now: float) -> Optional[int]:
        """Evaluate the loop; returns the new rung index on a change,
        None otherwise."""
        if self._last_eval is not None \
                and now - self._last_eval < self.interval_s:
            return None
        if len(self._waits) < self.min_samples:
            return None
        self._last_eval = now
        p95 = _p95(self._waits)
        if self.registry is not None:
            self.registry.series("slo.p95_wait_s").record(now, p95)
        if p95 > self.target * (1 + self.band):
            self._calm = 0
            if self.rung + 1 < self.num_rungs and self._cooled(now):
                return self._move(now, self.rung + 1, p95)
            return None
        if p95 < self.target * (1 - self.band):
            self._calm += 1
            if self._calm >= self.settle and self.rung > 0 \
                    and self._cooled(now):
                return self._move(now, self.rung - 1, p95)
            return None
        self._calm = 0
        return None
