"""Kill–restart chaos harness: crash the engine at scheduler-tick
boundaries and prove the durable layer loses nothing.

A :class:`KillPlan` is the durability sibling of
``repro_torch.resilience.chaos.FaultPlan``: a *seeded schedule* of process
kills keyed by the global scheduler-tick count, memoized so repeated
queries agree and explicit tick overrides let a test strike exactly
where it wants.  :func:`drain_with_kills` then runs an engine the way
``run_until_drained`` would — but whenever the plan says so it "crashes"
the process (drops the engine on the floor, closing only the journal
file handle the way the OS would), builds a fresh engine via the
caller's factory, and calls ``recover()`` on it.  The tick counter is
global across incarnations, so a kill schedule spans restarts.

Nothing here imports the engine: the harness duck-types it (``step`` /
``queue`` / ``batcher`` / ``clock`` / ``results`` / ``recover``), the
same contract ``run_until_drained`` relies on, so benchmarks can drive
the real ``ServeEngine`` or a virtual-clock fake identically.  A copy of
the JAX package's ``repro.durable.harness``: the same seeds give the same
kill schedule.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, FrozenSet, Optional

_STALL_SPINS = 64    # mirror the engine's own no-progress guard


@dataclasses.dataclass
class KillPlan:
    """Seeded schedule of engine kills at scheduler-tick boundaries.

    ``should_kill(tick)`` draws (memoized) from
    ``random.Random(f"{seed}:{tick}")`` with probability ``kill_rate``;
    explicit ``kills`` ticks override the draw; ``max_kills`` bounds the
    total so a high rate cannot livelock a drain."""

    seed: int = 0
    kill_rate: float = 0.0
    kills: FrozenSet[int] = frozenset()
    max_kills: Optional[int] = None

    def __post_init__(self):
        if not (0.0 <= self.kill_rate <= 1.0):
            raise ValueError(
                f"kill_rate must be in [0, 1], got {self.kill_rate}")
        self.kills = frozenset(int(t) for t in self.kills)
        self.killed = 0
        self._memo: Dict[int, bool] = {}

    def should_kill(self, tick: int) -> bool:
        t = int(tick)
        if self.max_kills is not None and self.killed >= self.max_kills:
            return False
        hit = self._memo.get(t)
        if hit is None:
            if t in self.kills:
                hit = True
            elif self.kill_rate > 0:
                # str seeds hash stably across processes (same idiom as
                # FaultPlan) — kill schedules replay exactly
                hit = (random.Random(f"{self.seed}:{t}").random()
                       < self.kill_rate)
            else:
                hit = False
            self._memo[t] = hit
        if hit:
            self.killed += 1
        return hit


@dataclasses.dataclass
class KillReport:
    """What a killed-and-restarted drain did end to end."""
    restarts: int
    ticks: int
    delivered: Dict
    engine: object     # the final incarnation (for metrics/journal asserts)


def crash(engine) -> None:
    """Simulate a process death: the engine object is abandoned with no
    shutdown courtesy — only its journal file handle is closed, which is
    what the OS would do to the fd anyway.  In-flight run states, queue
    contents, and results that were never journaled are *gone*; that is
    the point."""
    j = getattr(engine, "journal", None)
    if j is not None and not j.closed:
        j.close()


def drain_with_kills(factory: Callable[[], object], plan: KillPlan, *,
                     max_restarts: int = 64,
                     max_ticks: int = 100000) -> KillReport:
    """Drain an engine to empty while ``plan`` kills it at tick
    boundaries.  ``factory()`` must build a *fresh* engine over the same
    journal path / snapshot dir (that is what makes recovery real).

    Results delivered before each crash are collected first — a real
    client would have received them (the finish was journaled + fsynced
    before delivery), so they count; everything still in flight at the
    kill must be re-delivered by a later incarnation."""
    eng = factory()
    eng.recover()
    delivered: Dict = {}
    restarts = 0
    ticks = 0
    stalls = 0
    while ticks < max_ticks:
        progressed = eng.step()
        if progressed:
            stalls = 0
            ticks += 1
            if plan.should_kill(ticks):
                delivered.update(eng.results)
                crash(eng)
                restarts += 1
                if restarts > max_restarts:
                    raise RuntimeError(
                        f"kill plan exceeded max_restarts={max_restarts}")
                eng = factory()
                eng.recover()
            continue
        if len(eng.queue) == 0:
            break
        now = eng.clock.now()
        t = eng.batcher.next_event(now)
        if t is None:
            raise RuntimeError(
                f"durability drain stalled: {len(eng.queue)} queued "
                "requests but no next event")
        if t <= now:
            stalls += 1
            if stalls > _STALL_SPINS:
                raise RuntimeError(
                    "durability drain made no progress across "
                    f"{_STALL_SPINS} scheduler passes")
            continue
        stalls = 0
        eng.clock.sleep_until(t)
    else:
        raise RuntimeError(f"durability drain hit max_ticks={max_ticks}")
    delivered.update(eng.results)
    return KillReport(restarts=restarts, ticks=ticks, delivered=delivered,
                      engine=eng)
