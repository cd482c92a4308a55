"""Requests, clocks, and the arrival queue.

A :class:`Request` is one generation job: a seed, an optional class label,
and the name of the :class:`~repro_torch.serve.store.ArtifactStore` entry
whose schedule/plan should serve it.  Requests carry *real* arrival
timestamps — queue wait and service time are separate, measurable
quantities.

Time comes from a :class:`Clock` so the whole serving stack runs in two
modes: :class:`WallClock` for real deployments, and :class:`VirtualClock`
for deterministic tests — a fake executor charges virtual seconds per
segment and the scheduler's decisions (batch formation, interleaving,
fairness) become exactly reproducible assertions.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Optional, Sequence


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------

class WallClock:
    """Monotonic real time; ``sleep_until`` actually sleeps."""

    def now(self) -> float:
        return time.monotonic()

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Deterministic test clock: time moves only when told to."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def sleep_until(self, t: float) -> None:
        self._now = max(self._now, float(t))

    def advance(self, dt: float) -> float:
        """Charge ``dt`` virtual seconds (fake executors call this to model
        per-segment compute cost)."""
        self._now += float(dt)
        return self._now


def poisson_arrivals(rate: float, n: int, rng, start: float = 0.0,
                     deadline_budget=None) -> List:
    """``n`` arrival timestamps of a Poisson process with ``rate`` req/s
    (i.i.d. exponential gaps) — the synthetic open-loop arrival trace the
    serving example and benchmark share.  ``rng`` is a seeded
    ``np.random.RandomState``/``Generator`` so traces are reproducible.

    With ``deadline_budget`` (a fixed relative budget in seconds, or a
    ``(lo, hi)`` uniform draw — the per-class deadline model of the SLO
    traces) each element becomes an ``(arrival, deadline)`` pair with the
    absolute deadline ``arrival + budget``; without it the return stays a
    plain arrival list, so existing callers are untouched."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    t = float(start)
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate))
        if deadline_budget is None:
            out.append(t)
        else:
            b = deadline_budget
            if isinstance(b, (tuple, list)):
                b = float(rng.uniform(b[0], b[1]))
            out.append((t, t + float(b)))
    return out


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One generation job.

    ``seed`` feeds the micro-batch generator (see
    :func:`repro_torch.serve.engine.batch_generator`); ``policy`` names the
    store entry (artifact / calibration-free policy) that serves it;
    ``priority`` breaks ties ahead of arrival order (higher first).
    ``arrival`` is stamped by the queue at submit time unless given
    explicitly (virtual-clock tests and replayed traces pass it).
    ``slo`` optionally attaches a :class:`repro_torch.slo.SLO` (deadline /
    quality floor / class label) — requests without one serve exactly as
    without SLOs."""
    rid: int
    seed: int
    policy: str
    label: Optional[int] = None
    priority: int = 0
    slo: Optional[object] = None              # repro_torch.slo.SLO, if any
    arrival: Optional[float] = None
    started: Optional[float] = None           # micro-batch launch time
    finished: Optional[float] = None          # result materialized
    joined_at: Optional[float] = None         # boundary join, if any

    @property
    def queue_wait(self) -> Optional[float]:
        if self.started is None or self.arrival is None:
            return None
        return self.started - self.arrival

    @property
    def service_time(self) -> Optional[float]:
        if self.finished is None or self.started is None:
            return None
        return self.finished - self.started

    @property
    def joined(self) -> bool:
        """Whether this request entered service through a boundary join
        (a chaser launch) rather than a fresh batch formation."""
        return self.joined_at is not None

    @property
    def deadline(self) -> Optional[float]:
        return self.slo.deadline if self.slo is not None else None

    @property
    def max_tau(self) -> Optional[float]:
        """Quality floor: the largest SmoothCache τ this request accepts
        (None ⇒ any registered rung)."""
        return self.slo.max_tau if self.slo is not None else None

    def attained(self) -> bool:
        """Deadline attainment: a finished request without a deadline
        always attains; an unfinished (shed / in-flight) one never does."""
        if self.finished is None:
            return False
        return self.deadline is None or self.finished <= self.deadline


class RequestQueue:
    """Arrival-ordered request queue with per-policy grouping.

    Requests become *ready* once the clock passes their arrival timestamp;
    ready requests are handed out per policy group in ``(-priority,
    arrival, rid)`` order.  The queue never forms batches itself — that is
    :class:`~repro_torch.serve.batcher.MicroBatcher`'s job."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else WallClock()
        self._future: List = []               # heap of (arrival, tie, req)
        self._ready: Dict[str, List[Request]] = {}
        self._tie = itertools.count()

    def submit(self, req: Request) -> Request:
        if req.arrival is None:
            req.arrival = self.clock.now()
        heapq.heappush(self._future, (req.arrival, next(self._tie), req))
        return req

    def submit_many(self, reqs: Sequence[Request]) -> List[Request]:
        return [self.submit(r) for r in reqs]

    def _absorb(self, now: float) -> None:
        while self._future and self._future[0][0] <= now:
            _, _, req = heapq.heappop(self._future)
            group = self._ready.setdefault(req.policy, [])
            group.append(req)
            group.sort(key=lambda r: (-r.priority, r.arrival, r.rid))

    def ready_groups(self, now: Optional[float] = None) -> Dict[str, int]:
        """{policy name: number of ready requests} at time ``now``."""
        self._absorb(self.clock.now() if now is None else now)
        return {g: len(rs) for g, rs in self._ready.items() if rs}

    def peek(self, group: str, now: Optional[float] = None) -> List[Request]:
        self._absorb(self.clock.now() if now is None else now)
        return list(self._ready.get(group, ()))

    def take(self, group: str, n: int,
             now: Optional[float] = None) -> List[Request]:
        """Remove and return the ``n`` highest-priority/oldest ready
        requests of ``group``."""
        self._absorb(self.clock.now() if now is None else now)
        rs = self._ready.get(group, [])
        taken, self._ready[group] = rs[:n], rs[n:]
        return taken

    def take_rids(self, group: str, rids: Sequence[int],
                  now: Optional[float] = None) -> List[Request]:
        """Remove and return specific ready requests of ``group`` by rid,
        preserving ready order — how the batcher lifts a rung-compatible
        subset, and how the engine sheds/defer-removes one request
        without disturbing its neighbors.  Unknown rids are ignored."""
        self._absorb(self.clock.now() if now is None else now)
        want = set(rids)
        rs = self._ready.get(group, [])
        taken = [r for r in rs if r.rid in want]
        self._ready[group] = [r for r in rs if r.rid not in want]
        return taken

    def resubmit(self, req: Request, not_before: float) -> None:
        """Defer: re-enqueue an already-removed request so it becomes
        ready again at ``not_before``.  The original ``arrival`` stamp is
        deliberately untouched — queue-wait accounting keeps charging the
        full time since first arrival, so deferral cannot launder latency."""
        heapq.heappush(self._future,
                       (float(not_before), next(self._tie), req))

    def next_arrival(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest not-yet-ready arrival timestamp (None when everything
        submitted has already arrived)."""
        self._absorb(self.clock.now() if now is None else now)
        return self._future[0][0] if self._future else None

    def __len__(self) -> int:
        return len(self._future) + sum(len(rs) for rs in
                                       self._ready.values())

    def drain_all(self) -> List[Request]:
        """Remove and return every queued request (ready and future) —
        the engine's stall-shed path: when nothing queued can ever become
        schedulable, each drained request gets an explicit shed outcome
        instead of an engine-killing exception."""
        out = [req for _, _, req in sorted(self._future)]
        self._future = []
        for rs in self._ready.values():
            out.extend(rs)
        self._ready = {}
        return out
