"""Pluggable scheduling policies for the serve engine.

:class:`~repro_torch.serve.engine.ServeEngine` takes a policy *object*
behind one small interface — ``select`` picks which in-flight micro-batch
advances this tick, ``rotate`` says whether the advanced batch moves to
the back of the rotation, ``on_finish`` observes completed batches.
Strings name the built-ins (:func:`resolve_policy`).

Policies:

* ``interleave`` (:class:`FairnessPolicy`) — round-robin timeslicing, the
  default: always advance the head, rotate it to the back.
* ``fcfs`` (:class:`FcfsPolicy`) — run the head to completion (the convoy
  baseline).
* ``edf`` (:class:`EDFPolicy`) — earliest-deadline-first by *slack*:
  ``min member deadline − now − remaining_steps × calibrated step cost``,
  so urgency reflects work left, not just deadlines.  Deadline-less
  batches have infinite slack and fall back to round-robin among
  themselves.  Preemption happens only at the engine's advance
  granularity (a plan segment / an adaptive step-chunk) — a batch is
  never torn mid-step.

The JAX package's ``elastic`` policy (EDF plus the τ-elastic controller)
is not ported yet (``ROADMAP.md`` queue 1, item 8).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.slo.slo import batch_deadline, remaining_steps


class SchedulingPolicy:
    """Interface: which in-flight run advances, and what to observe."""

    name = "policy"

    def select(self, engine, now: float) -> int:
        """Index into ``engine._inflight`` of the run to advance."""
        return 0

    def rotate(self) -> bool:
        """Move the advanced (unfinished) run to the back of the list?"""
        return False

    def on_finish(self, engine, record, requests: Sequence,
                  now: float) -> None:
        """Observe a completed micro-batch (record + member requests)."""


class FairnessPolicy(SchedulingPolicy):
    """Round-robin timeslicing (``interleave``)."""

    name = "interleave"

    def rotate(self) -> bool:
        return True


class FcfsPolicy(SchedulingPolicy):
    """Run the head micro-batch to completion (convoy baseline)."""

    name = "fcfs"


class EDFPolicy(SchedulingPolicy):
    """Least-slack-first over in-flight micro-batches."""

    name = "edf"

    def select(self, engine, now: float) -> int:
        best, best_slack = 0, math.inf
        step_cost = engine.cost_model
        for i, fl in enumerate(engine._inflight):
            dl = batch_deadline(fl.mb.requests)
            if dl is math.inf:
                continue
            rem = remaining_steps(fl.rs) * step_cost.per_step(fl.mb.group)
            s = dl - now - rem
            if s < best_slack:
                best, best_slack = i, s
        return best

    def rotate(self) -> bool:
        # deadline-less runs all tie at infinite slack; rotating keeps
        # them round-robin fair instead of convoying behind index 0
        return True


_BUILTINS = {
    "interleave": FairnessPolicy,
    "fairness": FairnessPolicy,
    "fcfs": FcfsPolicy,
    "edf": EDFPolicy,
}


def resolve_policy(spec) -> SchedulingPolicy:
    """A policy object passes through; a string resolves a built-in."""
    if isinstance(spec, SchedulingPolicy):
        return spec
    if spec == "elastic":
        raise NotImplementedError(
            "the elastic scheduling policy (EDF + the τ-elastic "
            "controller) is not ported yet: ROADMAP.md queue 1, item 8")
    if spec not in _BUILTINS:
        raise ValueError(
            f"scheduler must be one of {sorted(_BUILTINS)} (or a "
            f"SchedulingPolicy object), got {spec!r}")
    return _BUILTINS[spec]()
