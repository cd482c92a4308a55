"""Schedule → execution plan: segmentation + branch-cache liveness.

A static :class:`~repro_torch.core.schedule.Schedule` touches every layer type at
every step — each step either *computes* a type (overwriting its cache slot)
or *skips* it (reading the slot).  Two structural facts follow:

* **Liveness is next-step lookahead.**  A cached branch output survives a
  step boundary iff the next step *reads* it (skips its type); a compute at
  the next step overwrites the slot before anything reads it.  A type that
  is never skipped is dead everywhere: its branches must never be
  collected, merged, or kept resident.
* **Schedules are piecewise-constant** (Δ-DiT, FORA: long runs of identical
  masks), so steps run-length encode into constant-mask segments.

A signature is a mask plus its *canonical* collect set
``computed(mask) ∩ ever-live`` — canonical rather than exact-per-step so
that the cache structure is invariant over a segment's steps.  Exact
per-step liveness is enforced at segment boundaries, where dead entries
are dropped (each :class:`SigRun` carries its exact ``live_out``), and is
available per step via :meth:`ExecutionPlan.collect_at` /
:meth:`ExecutionPlan.live_in_at` for accounting.

:func:`analyze` performs the analysis and returns an
:class:`ExecutionPlan`: the unit of provenance that
:class:`~repro_torch.cache.artifact.CacheArtifact` serializes so a serving
process reloads a pre-analyzed plan instead of re-deriving it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Mapping, Optional, Tuple

MaskItems = Tuple[Tuple[str, bool], ...]


def schedule_fingerprint(schedule) -> str:
    """Short stable digest of a schedule's content (provenance checks) —
    memoized on the Schedule so hot-path validation stays O(1)."""
    if hasattr(schedule, "fingerprint"):
        return schedule.fingerprint()
    return hashlib.sha256(
        schedule.content_key().encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class ProgramSig:
    """Compilation signature of a segment program.

    ``mask``: sorted ``(type, skip)`` pairs — the static skip mask.
    ``collect``: sorted types whose fresh branch outputs the program writes
    into the cache — ``computed(mask) ∩ ever-live``.  Skipped types pass
    their entries through, collected types are overwritten every step, so
    the cache structure (``live_in ∪ collect``) is a loop invariant.
    """
    mask: MaskItems
    collect: Tuple[str, ...]

    @property
    def skip(self) -> Dict[str, bool]:
        return dict(self.mask)

    @property
    def live_in(self) -> Tuple[str, ...]:
        """Types whose cache entry the program *reads* (= skipped types)."""
        return tuple(sorted(t for t, sk in self.mask if sk))

    @property
    def structure(self) -> Tuple[str, ...]:
        """Types with a resident cache entry while this program runs."""
        return tuple(sorted(set(self.live_in) | set(self.collect)))


@dataclasses.dataclass(frozen=True)
class SigRun:
    """``length`` consecutive steps starting at ``start`` sharing one mask.

    ``live_out``: the *exact* live set after the run's final step — the
    types the next segment reads.  Everything else in the program's
    structure is dead at the boundary and is dropped before the next
    segment starts."""
    sig: ProgramSig
    start: int
    length: int
    live_out: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Run-length-encoded constant-mask segments for one schedule."""
    num_steps: int
    runs: Tuple[SigRun, ...]
    schedule_fingerprint: Optional[str] = None

    # -- derived -------------------------------------------------------------

    @property
    def signatures(self) -> Tuple[ProgramSig, ...]:
        """Unique signatures in order of first appearance — the compile set
        (one per distinct mask)."""
        seen: List[ProgramSig] = []
        for r in self.runs:
            if r.sig not in seen:
                seen.append(r.sig)
        return tuple(seen)

    @property
    def num_unique_signatures(self) -> int:
        return len(self.signatures)

    def run_at(self, s: int) -> SigRun:
        for r in self.runs:
            if r.start <= s < r.start + r.length:
                return r
        raise IndexError(f"step {s} outside plan of {self.num_steps} steps")

    def sig_at(self, s: int) -> ProgramSig:
        return self.run_at(s).sig

    # -- exact per-step liveness (monolith path, tests, accounting) ----------

    def live_in_at(self, s: int) -> Tuple[str, ...]:
        """Types whose cached entry step ``s`` reads (= skipped types)."""
        return self.sig_at(s).live_in

    def live_out_at(self, s: int) -> Tuple[str, ...]:
        """Exact live set after step ``s``: what step ``s+1`` reads."""
        return self.live_in_at(s + 1) if s + 1 < self.num_steps else ()

    def collect_at(self, s: int) -> Tuple[str, ...]:
        """Exact collect set of step ``s``: types computed at ``s`` whose
        output the next step reads.  (Segment programs over-collect to the
        canonical ``sig.collect`` so their carry structure is loop
        invariant; the surplus is dropped at the segment boundary.)"""
        skip = self.sig_at(s).skip
        return tuple(t for t in self.live_out_at(s) if not skip.get(t, False))

    def live_types(self) -> Tuple[str, ...]:
        """Types that are ever cached (read at some step).  A type absent
        here is *dead everywhere*: never collected, never resident."""
        out = set()
        for r in self.runs:
            out.update(r.sig.live_in)
        return tuple(sorted(out))

    def boundaries(self) -> Tuple[int, ...]:
        """Steps at which the host regains control between segments —
        every segment start plus ``num_steps`` (the end).  These are the
        join/split/merge points of continuous batching: a run advanced
        segment-by-segment sits exactly at one of them, so two runs of
        this plan are merge-compatible iff they sit on the same boundary
        (same ``run_index``)."""
        return tuple(r.start for r in self.runs) + (self.num_steps,)

    def run_label(self, i: int) -> str:
        """Human-readable tag of segment ``i`` for trace spans and logs:
        step range plus the skipped types of its mask."""
        if not 0 <= i < len(self.runs):
            raise IndexError(f"segment {i} outside plan of "
                             f"{len(self.runs)} segments")
        r = self.runs[i]
        skips = sorted(t for t, sk in r.sig.skip.items() if sk)
        return (f"seg[{i}] steps[{r.start},{r.start + r.length}) "
                f"skip={','.join(skips) if skips else '-'}")

    def summary(self) -> str:
        rows = [f"ExecutionPlan: {self.num_steps} steps, {len(self.runs)} "
                f"segments, {self.num_unique_signatures} unique signatures"]
        for r in self.runs:
            skip = [t for t, sk in r.sig.mask if sk]
            rows.append(f"  [{r.start:3d}..{r.start + r.length - 1:3d}] "
                        f"skip={skip or '∅'} "
                        f"live_out={list(r.live_out) or '∅'}")
        return "\n".join(rows)

    # -- memory accounting ---------------------------------------------------

    def peak_live_bytes(self, type_bytes: Mapping[str, int]) -> int:
        """Peak resident branch-cache bytes under the segmented path, given
        per-type cache-entry sizes (see :func:`branch_cache_type_bytes`):
        the largest per-segment structure (``live_in ∪ collect``)."""
        peak = 0
        for r in self.runs:
            for types in (r.sig.structure, r.live_out):
                peak = max(peak, sum(type_bytes.get(t, 0) for t in types))
        return peak

    # -- (de)serialization ---------------------------------------------------

    def to_jsonable(self) -> Dict:
        return {
            "num_steps": self.num_steps,
            "schedule_fingerprint": self.schedule_fingerprint,
            "runs": [{
                "start": r.start, "length": r.length,
                "mask": {t: bool(sk) for t, sk in r.sig.mask},
                "collect": list(r.sig.collect),
                "live_out": list(r.live_out),
            } for r in self.runs],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_jsonable(), sort_keys=True)

    @staticmethod
    def from_jsonable(d: Mapping) -> "ExecutionPlan":
        runs = tuple(
            SigRun(sig=ProgramSig(mask=tuple(sorted(r["mask"].items())),
                                  collect=tuple(r["collect"])),
                   start=int(r["start"]), length=int(r["length"]),
                   live_out=tuple(r["live_out"]))
            for r in d["runs"])
        return ExecutionPlan(num_steps=int(d["num_steps"]), runs=runs,
                             schedule_fingerprint=d.get("schedule_fingerprint"))

    @staticmethod
    def from_json(s: str) -> "ExecutionPlan":
        return ExecutionPlan.from_jsonable(json.loads(s))


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def analyze(schedule) -> ExecutionPlan:
    """Segment a schedule and compute branch liveness.

    Raises if the first step reads a cache slot (nothing has filled it)."""
    s_total = schedule.num_steps
    masks = [schedule.mask_key_at(s) for s in range(s_total)]
    reads = [tuple(sorted(t for t, sk in m if sk)) for m in masks]
    if reads[0]:
        raise ValueError(
            f"schedule skips {list(reads[0])} at step 0 — the cache is empty "
            "before the first step, so step 0 must compute everything")
    ever_live = set()
    for r in reads:
        ever_live.update(r)
    spans: List[List[int]] = []           # [start, length] per mask run
    for s in range(s_total):
        if spans and masks[s] == masks[spans[-1][0]]:
            spans[-1][1] += 1
        else:
            spans.append([s, 1])
    runs = []
    for i, (start, length) in enumerate(spans):
        m = masks[start]
        collect = tuple(sorted(
            t for t, sk in m if not sk and t in ever_live))
        nxt = spans[i + 1][0] if i + 1 < len(spans) else None
        live_out = reads[nxt] if nxt is not None else ()
        runs.append(SigRun(sig=ProgramSig(mask=m, collect=collect),
                           start=start, length=length, live_out=live_out))
    return ExecutionPlan(num_steps=s_total, runs=tuple(runs),
                         schedule_fingerprint=schedule_fingerprint(schedule))


# ---------------------------------------------------------------------------
# Adaptive candidate pool
# ---------------------------------------------------------------------------

#: hard cap on ever-skipped types for pool derivation (2^n programs)
MAX_LATTICE_TYPES = 8


def mask_lattice(schedule) -> Tuple[ProgramSig, ...]:
    """Candidate signature pool for input-adaptive runtime dispatch: the
    full mask lattice over the schedule's *ever-skipped* type set.

    A runtime policy (``repro_torch.cache.AdaptivePolicy``) decides per step which
    layer types to reuse, so ahead of time we only know the *menu* of masks
    it may pick: any subset of the types the offline schedule ever skips
    (types the offline analysis deems cache-eligible).  This returns one
    :class:`ProgramSig` per subset — ``2^|ever-skipped|`` signatures,
    typically 4 for {attn, ffn} — with the canonical collect set
    ``computed ∩ ever-skipped``.  That choice makes every pool signature's
    cache structure the *same* set (the ever-skipped types), so the branch
    cache pytree is invariant across the whole adaptive run and per-step
    dispatch among precompiled programs needs no restructuring.

    The pool is ordered by skip-set size (all-compute first) and contains
    every mask of the static schedule, so a τ=0 adaptive run dispatches the
    exact static masks.  The executor compiles at most ``len(pool)``
    programs, never one per step.
    """
    masks = [schedule.mask_key_at(s) for s in range(schedule.num_steps)]
    types = sorted(t for t, _ in masks[0])
    ever = sorted({t for m in masks for t, sk in m if sk})
    if len(ever) > MAX_LATTICE_TYPES:
        raise ValueError(
            f"mask lattice over {len(ever)} skippable types would need "
            f"2^{len(ever)} programs; restrict the base schedule (e.g. a "
            "per_type composite with NoCache for some types)")
    subsets: List[Tuple[str, ...]] = [()]
    for t in ever:
        subsets += [sub + (t,) for sub in subsets]
    subsets.sort(key=lambda sub: (len(sub), sub))
    pool = []
    for sub in subsets:
        skipset = set(sub)
        mask = tuple(sorted((t, t in skipset) for t in types))
        collect = tuple(sorted(t for t in ever if t not in skipset))
        pool.append(ProgramSig(mask=mask, collect=collect))
    return tuple(pool)


def pool_index(pool) -> Dict[frozenset, ProgramSig]:
    """Runtime dispatch table: frozenset of skipped types → signature."""
    return {frozenset(sig.live_in): sig for sig in pool}


def mask_signature(types, bits) -> Tuple[str, ...]:
    """Canonical hashable mask signature from per-type skip bits (bit
    order follows ``types``) — the key continuous serving regroups rows
    by at chunk boundaries: rows whose desired signatures agree can share
    a batch without forcing each other's computes."""
    return tuple(t for t, hit in zip(types, bits) if hit)


@dataclasses.dataclass(frozen=True)
class SwitchTable:
    """On-device dispatch table over a candidate pool: ``branches[code]``
    is the signature whose skip set is ``{types[i] : bit i of code}``, so
    the fused adaptive step turns per-type skip bits into a branch index
    with one dot product against ``2^i`` — no host round-trip.  Hashable
    (it keys the executor's captured graphs: one per table and batch)."""
    types: Tuple[str, ...]                    # bit order (sorted)
    branches: Tuple[ProgramSig, ...]          # len == 2^len(types)

    def code_of(self, skipset) -> int:
        """Host-side branch index of a skip set (tests, accounting)."""
        skipset = set(skipset)
        unknown = skipset - set(self.types)
        if unknown:
            raise KeyError(f"skip set contains types {sorted(unknown)} "
                           f"outside the pool {list(self.types)}")
        return sum(1 << i for i, t in enumerate(self.types) if t in skipset)


def switch_branch_table(pool) -> SwitchTable:
    """Arrange a candidate pool for on-device dispatch.

    Requires the *full* mask lattice (every subset of the pool's type set
    present — :func:`mask_lattice` constructs exactly that): the fused
    step computes the branch index arithmetically from the per-type skip
    bits, so every bit pattern must name a signature."""
    idx = pool_index(pool)
    union = frozenset().union(*idx) if idx else frozenset()
    types = tuple(sorted(union))
    branches = []
    for code in range(1 << len(types)):
        skipset = frozenset(t for i, t in enumerate(types)
                            if code >> i & 1)
        sig = idx.get(skipset)
        if sig is None:
            raise ValueError(
                f"candidate pool is not a full mask lattice over "
                f"{list(types)}: skip set {sorted(skipset)} has no "
                "signature — derive the pool via mask_lattice()")
        branches.append(sig)
    return SwitchTable(types=types, branches=tuple(branches))


# ---------------------------------------------------------------------------
# Cache-size accounting
# ---------------------------------------------------------------------------

def branch_cache_type_bytes(cfg, batch: int, *, dtype_bytes: int = 4,
                            cfg_doubled: bool = False) -> Dict[str, int]:
    """Bytes of one resident cache entry per layer *type*: every layer of the
    type holds one pre-residual output of shape (B, N, d_model), B doubled
    under CFG (``cfg_doubled``).  ``dtype_bytes`` 4: the port's caches are
    f32."""
    from repro_torch.core import diffusion  # late: diffusion imports models
    n_tok, _, _ = diffusion.token_shape(cfg)
    b = 2 * batch if cfg_doubled else batch
    per_layer = b * n_tok * cfg.d_model * dtype_bytes
    out: Dict[str, int] = {}
    for st in cfg.stages:
        for blk in st.unit:
            for t in blk.branch_types():
                out[t] = out.get(t, 0) + st.repeat * per_layer
    return out
