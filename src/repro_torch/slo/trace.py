"""Deterministic SLO traffic traces.

The SLO tests and the card's ``slo`` smoke phase need overload scenarios
that are fast and *exactly* reproducible: everything runs on a
:class:`~repro_torch.serve.request.VirtualClock` (or the wall clock) with
a seeded RNG, so scheduler decisions, shed counts, and controller rung
changes are bit-stable assertions, and one seed gives the JAX package's
trace.  :func:`overload_trace` composes the existing ``poisson_arrivals``
helper into an **arrival-rate ramp**: a sequence of ``(rate, n)`` phases
drained back-to-back (e.g. warm → surge → cool), with each arrival
assigned a traffic class by weight — its policy/ladder, priority,
per-class deadline draw (relative budget, turned absolute at the arrival
timestamp), and quality floor ``max_tau``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.serve.request import Request, poisson_arrivals
from repro_torch.slo.slo import SLO

#: a fixed relative deadline budget, or a (lo, hi) uniform draw
Budget = Union[float, Tuple[float, float]]


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One traffic class of a synthetic trace."""
    name: str
    policy: str                               # store entry or ladder name
    weight: float = 1.0                       # class mix (relative)
    priority: int = 0
    deadline_budget: Optional[Budget] = None  # seconds after arrival
    max_tau: Optional[float] = None           # quality floor

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"class {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")

    def draw_deadline(self, arrival: float, rng) -> Optional[float]:
        if self.deadline_budget is None:
            return None
        b = self.deadline_budget
        if isinstance(b, tuple):
            b = float(rng.uniform(b[0], b[1]))
        return arrival + float(b)


def overload_trace(classes: Sequence[RequestClass],
                   phases: Sequence[Tuple[float, int]], rng, *,
                   start: float = 0.0, rid_start: int = 0
                   ) -> List[Request]:
    """Build a rate-ramp trace: for each ``(rate, n)`` phase, ``n``
    Poisson arrivals at ``rate`` req/s continuing from the previous
    phase's last arrival; each request draws its class by weight and its
    deadline from the class budget.  ``rng`` is a seeded numpy
    RandomState/Generator — same seed, same trace."""
    if not classes:
        raise ValueError("overload_trace needs at least one RequestClass")
    total_w = sum(c.weight for c in classes)
    reqs: List[Request] = []
    t = float(start)
    rid = rid_start
    for rate, n in phases:
        arrivals = poisson_arrivals(rate, n, rng, start=t)
        if arrivals:
            t = arrivals[-1]
        for a in arrivals:
            u = float(rng.uniform(0.0, total_w))
            acc, cls = 0.0, classes[-1]
            for c in classes:
                acc += c.weight
                if u < acc:
                    cls = c
                    break
            slo = SLO(deadline=cls.draw_deadline(a, rng),
                      max_tau=cls.max_tau, cls=cls.name)
            reqs.append(Request(rid=rid, seed=rid, policy=cls.policy,
                                priority=cls.priority, arrival=a, slo=slo))
            rid += 1
    return reqs
