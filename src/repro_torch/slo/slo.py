"""Per-request service-level objectives.

An :class:`SLO` rides on a :class:`~repro_torch.serve.request.Request`
and makes three production intents explicit:

* ``deadline`` — absolute engine-clock time by which the result must be
  materialized.  Deadlines drive EDF scheduling (urgency replaces
  round-robin) and the attainment / goodput accounting in
  :class:`~repro_torch.serve.metrics.ServerMetrics`.
* ``max_tau`` — the request's *quality floor*, expressed as the largest
  SmoothCache error budget τ it tolerates.  A capped request is only ever
  served at a rung with ``tau <= max_tau`` (or shed with reason
  ``quality_floor`` when no registered rung qualifies).
* ``cls`` — a priority-class label for metrics and trace generation; the
  scheduling weight itself stays ``Request.priority``.

Deadlines compose with the executor's resumable-run surface through
:func:`remaining_steps`: every run state (static-plan, adaptive, and the
test fakes) exposes how many sampling steps are
left, so slack is estimated as ``deadline - now - remaining_steps ×
calibrated_step_cost`` and a micro-batch is preempted only at
segment/chunk boundaries — exactly the granularity the engine's
``advance`` already uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objective of one request (all fields optional — a
    bare ``SLO()`` is equivalent to no SLO at all)."""
    deadline: Optional[float] = None          # absolute engine-clock time
    max_tau: Optional[float] = None           # quality floor: largest τ ok
    cls: str = "default"                      # class label (metrics/traces)

    def __post_init__(self):
        if self.max_tau is not None and self.max_tau < 0:
            raise ValueError(f"max_tau must be >= 0, got {self.max_tau}")

    def attained(self, finished: Optional[float]) -> bool:
        """Did a request finishing at ``finished`` meet this SLO?  A shed
        request (``finished is None``) never attains; without a deadline
        any finish attains."""
        if finished is None:
            return False
        return self.deadline is None or finished <= self.deadline


def remaining_steps(rs) -> int:
    """Sampling steps left in a resumable run state.

    Every executor run state exposes ``num_steps``/``step`` (the adaptive
    state directly, the static-plan state via properties); plan
    states that predate those properties are handled through
    ``plan.runs[run_index:]``.  Eager stand-ins without either shape count
    as 0 — they complete in one advance."""
    num = getattr(rs, "num_steps", None)
    step = getattr(rs, "step", None)
    if num is not None and step is not None:
        return max(int(num) - int(step), 0)
    plan = getattr(rs, "plan", None)
    idx = getattr(rs, "run_index", None)
    if plan is not None and idx is not None:
        return sum(run.length for run in plan.runs[idx:])
    return 0


def batch_deadline(requests: Sequence) -> float:
    """Earliest member deadline of a micro-batch (``inf`` when no member
    carries one) — the quantity EDF orders in-flight batches by."""
    dls = [r.deadline for r in requests
           if getattr(r, "deadline", None) is not None]
    return min(dls) if dls else math.inf


def slack(deadline: Optional[float], now: float,
          est_remaining_s: float) -> float:
    """Estimated time to spare: ``deadline - now - est_remaining_s``
    (``inf`` without a deadline).  Negative slack means the deadline will
    be missed even if the run is serviced exclusively from now on."""
    if deadline is None:
        return math.inf
    return deadline - now - est_remaining_s
