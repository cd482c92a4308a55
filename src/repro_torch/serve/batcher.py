"""Admission + micro-batching.

Requests are grouped by **store entry** (their policy name) and emitted
in **power-of-two buckets**; the entry — schedule, plan, version — is
snapshotted atomically at batch formation, so a micro-batch always runs
one signature set and one version even across hot swaps.  Model-call
variants specialize on batch shape, so admitting arbitrary tail sizes
would dispatch one variant set per size; padding tails to the full batch
wastes the padded rows' compute instead.  Power-of-two buckets are the
middle ground: a tail of 5 requests runs as a 4-batch plus a 1-batch,
every row is a real request, and the shape-specialized variant count is
bounded by ``log2(max_batch)+1`` buckets × the signature pool — the
program-budget math the engine's metrics report against.

Formation policy per group, evaluated oldest-request-first:

* a full ``max_batch`` bucket forms immediately;
* a partial bucket forms once the group's oldest ready request has waited
  ``max_wait`` (0 ⇒ greedy: partial buckets form as soon as the engine has
  capacity — lowest latency, more small-bucket programs);
* otherwise the group holds, accumulating arrivals.

Groups are drained round-robin so a busy policy cannot starve a quiet one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.obs import NULL_TRACER
from repro_torch.serve.request import Request, RequestQueue
from repro_torch.serve.store import ArtifactStore, ServableEntry


def bucket_for(n: int, max_batch: int) -> int:
    """Largest power-of-two ≤ min(n, max_batch)."""
    if n < 1:
        raise ValueError(f"bucket_for needs n >= 1, got {n}")
    b = 1
    while b * 2 <= min(n, max_batch):
        b *= 2
    return b


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """The admissible bucket set {1, 2, 4, ..., max_batch}."""
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


@dataclasses.dataclass
class MicroBatch:
    """A formed batch: compatible requests + the store entry (snapshotted
    at formation, so a hot swap never changes an already-formed batch)."""
    requests: Tuple[Request, ...]
    entry: ServableEntry
    formed_at: float

    @property
    def bucket(self) -> int:
        return len(self.requests)

    @property
    def group(self) -> str:
        return self.entry.name

    @property
    def rids(self) -> Tuple[int, ...]:
        return tuple(r.rid for r in self.requests)

    @property
    def seeds(self) -> Tuple[int, ...]:
        return tuple(r.seed for r in self.requests)

    @property
    def labels(self) -> Tuple[Optional[int], ...]:
        return tuple(r.label for r in self.requests)

    @property
    def prompts(self) -> Tuple[Optional[str], ...]:
        return tuple(r.prompt for r in self.requests)


class MicroBatcher:
    """Pulls ready requests from a :class:`RequestQueue` and forms
    :class:`MicroBatch` es against the current store entries."""

    def __init__(self, queue: RequestQueue, store: ArtifactStore, *,
                 max_batch: int = 8, max_wait: float = 0.0):
        if max_batch < 1 or (max_batch & (max_batch - 1)) != 0:
            raise ValueError(f"max_batch must be a power of two, got "
                             f"{max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.queue = queue
        self.store = store
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._rr: List[str] = []              # round-robin group order
        #: observability hook; the engine installs its tracer so batch
        #: formation emits instant events on the engine track
        self.tracer = NULL_TRACER

    def _group_order(self, groups) -> List[str]:
        for g in sorted(groups):
            if g not in self._rr:
                self._rr.append(g)
        return [g for g in self._rr if g in groups]

    def next_batch(self, now: float) -> Optional[MicroBatch]:
        """Form and return one micro-batch, or None if no group is ready
        to form one at ``now``.  Unknown policy names raise KeyError —
        submission should have validated against the store.

        A group's requests resolve to a store entry through
        ``store.resolve_entry_for`` (for τ ladders: the active rung,
        clamped to each request's quality floor), and one micro-batch
        runs one entry — so the batch is the oldest resolvable request's
        rung plus every group-mate sharing it; other rungs' requests stay
        queued for the next formation pass.  Quality-infeasible requests
        (no admissible rung) are skipped here; the engine's SLO sweep
        sheds them with an explicit reason."""
        groups = self.queue.ready_groups(now)
        for g in self._group_order(groups):
            entry, eligible = None, []
            for r in self.queue.peek(g, now):
                e = self.store.resolve_entry_for(g, r)
                if e is None:
                    continue
                if entry is None:
                    entry = e
                    eligible = [r]
                elif e.name == entry.name:
                    eligible.append(r)
            if entry is None:
                continue
            n = len(eligible)
            if n >= self.max_batch:
                take = self.max_batch
            elif self.max_wait == 0.0 or (
                    now >= eligible[0].arrival + self.max_wait):
                # the expiry test must be the SAME float expression
                # ``arrival + max_wait`` that next_event() reports: under
                # a virtual clock the engine sleeps to exactly that value,
                # and ``now - arrival >= max_wait`` can round the other
                # way ((a+w)-a < w), freezing the clock in a livelock
                take = bucket_for(n, self.max_batch)
            else:
                continue
            reqs = tuple(self.queue.take_rids(
                g, [r.rid for r in eligible[:take]], now))
            # move the drained group to the back of the rotation
            self._rr.remove(g)
            self._rr.append(g)
            if self.tracer.enabled:
                self.tracer.instant(
                    "form", group=g, entry=entry.name, bucket=len(reqs),
                    rids=[r.rid for r in reqs],
                    oldest_wait_s=now - reqs[0].arrival)
            return MicroBatch(requests=reqs, entry=entry, formed_at=now)
        return None

    def take_join(self, now: float, entry: ServableEntry,
                  bucket: int) -> List[Request]:
        """Continuous feeder: lift up to ``k`` waiting requests that could
        *join* an in-flight run of ``entry`` whose batch size is
        ``bucket`` — the largest ``k`` with both ``k`` and ``bucket + k``
        admissible power-of-two buckets (the joiners run as their own
        catch-up batch before merging, so both shapes must be budgeted;
        for p2 buckets that means ``k == bucket``, a join doubles).
        Candidates must resolve to the **same entry name and version** the
        run took at formation: a hot swap or a ladder move in between
        makes a request join-ineligible rather than run a stale artifact.
        Returns ``[]`` when nothing fits; requests are taken in the
        queue's ``(-priority, arrival, rid)`` ready order."""
        sizes = set(bucket_sizes(self.max_batch))
        grown = [s for s in sizes if s > bucket and (s - bucket) in sizes]
        if not grown:
            return []                         # already at max_batch
        out: List[Request] = []
        src = None
        for g in self._group_order(self.queue.ready_groups(now)):
            for r in self.queue.peek(g, now):
                e = self.store.resolve_entry_for(g, r)
                if (e is None or e.name != entry.name
                        or e.version != entry.version):
                    continue
                out.append(r)
            if out:
                src = g
                break
        # keep the joined size on an admissible bucket
        best = max((s - bucket for s in grown if s - bucket <= len(out)),
                   default=0)
        if best <= 0:
            return []
        return self.queue.take_rids(src, [r.rid for r in out[:best]], now)

    def next_event(self, now: float) -> Optional[float]:
        """Earliest future time at which a batch *could* form: the next
        arrival, or a held group's hold window expiring.  None when the
        queue is empty.

        The hold candidate is based on the group's oldest *resolvable*
        request — the same request whose arrival anchors next_batch()'s
        expiry test — so the time reported here is guaranteed to actually
        form a batch (quality-infeasible requests never expire a window;
        the engine's SLO sweep sheds them)."""
        candidates = []
        nxt = self.queue.next_arrival(now)
        if nxt is not None:
            candidates.append(nxt)
        for g in self.queue.ready_groups(now):
            for r in self.queue.peek(g, now):
                if self.store.resolve_entry_for(g, r) is not None:
                    candidates.append(max(now, r.arrival + self.max_wait))
                    break
        return min(candidates) if candidates else None
