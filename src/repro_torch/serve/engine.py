"""Step-interleaved continuous-batching serving engine.

The engine drains a :class:`~repro_torch.serve.request.RequestQueue`
through the executor's **resumable stepping API**: ``start_run`` /
``advance_run`` for static plans (one
:class:`~repro_torch.core.plan.ExecutionPlan` segment per advance) and,
for adaptive entries, ``start_adaptive_fused_run`` /
``advance_adaptive_fused`` when the executor supports the fused path (a
whole ``adaptive_chunk`` of steps as replays of one captured CUDA graph,
the decisions made on the device: no per-step host read), else the
host-dispatched ``start_adaptive_run`` / ``advance_adaptive_run`` loop
(one decision sync per τ > 0 step).  Several in-flight micro-batches timeslice
the device: which one advances each tick is decided by a pluggable
:class:`repro_torch.slo.SchedulingPolicy` — the default ``interleave``
(round-robin, so a short, heavily-cached schedule admitted behind a
full-compute one finishes early instead of convoying behind it), ``fcfs``
(the convoy baseline), ``edf`` (least-slack-first over member deadlines)
or an ``elastic`` policy object that also drives the store's τ ladders
from measured p95 waits.  Preemption granularity is the advance unit — a
batch is never torn mid-step.

SLO semantics (optional): requests may carry a :class:`repro_torch.slo.SLO`;
each tick first runs an SLO sweep that sheds quality-infeasible requests
(no registered rung at or below the request's ``max_tau``) and, when an
:class:`repro_torch.slo.AdmissionController` is installed, sheds or defers
against the estimated backlog (queue depth × the online-calibrated
per-step service cost).  Every rejection is recorded with a reason in
``ServeEngine.shed`` and the metrics — :meth:`ServeEngine.outcome`
resolves any rid.

Continuous batching (``continuous=True``): waiting compatible requests
*join* an in-flight run at its next boundary (a catch-up chaser replays
them to the run's step, then the two run states merge), τ > 0 fused runs
*regroup* by their rows' desired masks at chunk boundaries, and aligned
runs of one entry *coalesce* back.  Launches then draw each row from its
own generator (``row_keys``), so every request replays alone as
``generate(params, batch_generator([seed]), 1)`` whatever its lineage,
bitwise (the executor's per-row contract).

Determinism contract: a micro-batch over requests ``[r0..rn-1]`` samples
with ``batch_generator(seeds)`` — serving a batch is *bit-identical* to
calling ``DiffusionPipeline.generate(params, batch_generator(seeds), n,
label=...)`` with the same store entry, because start + advance-until-done
executes exactly the ops of ``sample_with_plan`` / ``sample_adaptive``
(and the fused path equals the host loop bitwise).  Torch cannot
reproduce JAX's random bits, so the generator is the port's own; the
contract, not the bits, is the JAX package's.

Program budget: model-call variants specialize on (signature, batch
shape), so the variants the engine dispatches are bounded by |buckets| ×
Σ per-entry signature pool — :meth:`ServeEngine.report` shows the
executor's total ``model_variants`` against :meth:`program_budget`.
Eager PyTorch compiles nothing: the count is of dispatched shapes, the
programs a compiled version would build.

Fault recovery (``resilience=`` a
:class:`~repro_torch.resilience.ResiliencePolicy`): health flags are
read at every advance boundary, a ``BatchFault`` raised mid-advance or an
advance past its watchdog deadline aborts the batch instead of the
engine, poisoned rows retry down the store's degradation ladder (rung →
τ = 0 → ``no_cache``) with deterministic backoff, healthy rows either
continue in split-off sub-runs (per-row split-retry) or re-queue at their
original arrival, and a request that keeps faulting ends as an explicit
``fault:<kind>`` shed.  Telemetry (``telemetry=True``): fused adaptive
runs record their per-row proxy signals on the device, and every
delivered request gets a :class:`~repro_torch.obs.CacheReport` in
``cache_reports``, built from one read of the traces at the batch's
finish.

Durability (``journal=`` a path or a
:class:`~repro_torch.durable.RequestJournal`, ``snapshot_dir=``): every
submission is on disk (one fsync per submit burst) before the queue acts
on it, finishes and sheds are journaled and synced before the engine
moves on, and every ``checkpoint_every``-th boundary advance of a run
writes a provenance-stamped snapshot of its state (device→host copy,
sha256, file write — outside any graph replay, never a decision sync).
After a crash, :meth:`ServeEngine.recover` on a fresh engine (and a fresh
executor) answers ``outcome`` for journaled verdicts, restores in-flight
runs from their newest valid snapshots, quarantines refused ones with a
reason, and replays the rest from the start — bitwise the uninterrupted
run either way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointError
from repro_torch.durable import (JournalState, RequestJournal, SnapshotError,
                                 SnapshotStore)
from repro_torch.obs import NULL_TRACER, MetricsRegistry, run_cache_reports
from repro_torch.resilience.faults import NAN_LATENT, STUCK_BATCH, BatchFault
from repro_torch.serve.batcher import MicroBatch, MicroBatcher, bucket_sizes
from repro_torch.serve.metrics import ServerMetrics
from repro_torch.serve.request import Request, RequestQueue, WallClock
from repro_torch.serve.store import ArtifactStore
from repro_torch.slo.admission import LoadEstimator, ServiceCostModel
from repro_torch.slo.policy import resolve_policy
from repro_torch.slo.slo import SLO, remaining_steps

#: built-in scheduler names (resolved through repro_torch.slo.resolve_policy)
SCHEDULERS = ("interleave", "fcfs", "edf")

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finalizer: a bijective 64-bit mix."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def batch_seed(seeds: Sequence[int]) -> int:
    """Deterministic 64-bit seed of a micro-batch: an order-sensitive fold
    of ``len(seeds)`` and each member seed's low 32 bits (seeds differing
    only in bit 31 give different batches)."""
    h = _mix64(len(seeds))
    for s in seeds:
        h = _mix64(h ^ (int(s) & 0xFFFFFFFF))
    return h


def batch_generator(seeds: Sequence[int]) -> torch.Generator:
    """The CPU generator a micro-batch samples its noise from.  Exposed so
    tests and clients can replay any served batch through
    ``DiffusionPipeline.generate`` and get bit-identical latents."""
    return torch.Generator().manual_seed(batch_seed(seeds))


@dataclasses.dataclass
class BatchRecord:
    """Provenance of one served micro-batch (enough to replay it)."""
    group: str
    version: int
    bucket: int
    rids: Tuple[int, ...]
    seeds: Tuple[int, ...]
    labels: Tuple[Optional[int], ...]
    num_steps: int
    compute_fraction: float
    formed_at: float
    finished_at: float
    decisions: Optional[Tuple[tuple, ...]] = None   # adaptive runs only
    tau: float = 0.0                          # realized τ (rung at launch)
    quality_cost: Optional[float] = None      # predicted, from proxy map
    #: continuous-batching provenance: every join / regroup / coalesce /
    #: split-retry event this batch's run state went through, in order
    #: (``join@<step>:<rids>``, ``regroup@<step>:<rids>``, …); empty for a
    #: batch that rode formation → finish unchanged
    lineage: Tuple[str, ...] = ()


class _EagerState:
    """Run-state stand-in for the ``eager`` escape hatch (whole batch
    sampled in one advance; no interleaving)."""

    def __init__(self):
        self.x = None
        self.decisions = None

    @property
    def done(self) -> bool:
        return self.x is not None


@dataclasses.dataclass
class _Inflight:
    mb: MicroBatch
    kind: str          # "plan" | "adaptive" | "adaptive_fused" | "eager"
    rs: object
    label: object
    #: per-row health known so far (np bool, True = healthy); None = all
    #: healthy.  Monotone: a poisoned row never recovers mid-run.
    taint: object = None
    #: exclude this batch's service time from the cost-model EWMA (it
    #: faulted / stalled — retries must not poison admission estimates)
    cost_excluded: bool = False
    #: continuous-batching linkage: a *chaser* replays joiners from step 0
    #: up to its target's boundary (``chaser_for`` points at the parked
    #: target, whose ``parked_by`` points back); ``row_keyed`` records the
    #: per-row generator contract that makes join/regroup replayable per
    #: request; ``lineage`` accumulates the run state's history
    chaser_for: object = None
    parked_by: object = None
    row_keyed: bool = False
    lineage: Tuple[str, ...] = ()
    #: tracer track of this run's span (0 = tracing off at launch) and the
    #: engine-wide batch serial the track is named after
    track: int = 0
    serial: int = 0
    #: durability: boundary advances survived so far — the checkpoint
    #: cadence counter (a snapshot lands every ``checkpoint_every``-th)
    advances: int = 0


class ServeEngine:
    """Queue → batcher → interleaved executor runs → metrics.  Runs on the
    executor's device; ``results`` hold numpy rows."""

    def __init__(self, executor, params, store: ArtifactStore, *,
                 clock=None, max_batch: int = 8, max_wait: float = 0.0,
                 max_inflight: int = 2, scheduler="interleave",
                 adaptive_chunk: int = 4, eager: bool = False,
                 check: bool = False, cost_model=None, tracer=None,
                 registry=None, continuous: bool = False,
                 join_horizon: float = 0.5, admission=None,
                 resilience=None, telemetry: bool = False, journal=None,
                 snapshot_dir=None, checkpoint_every: int = 1):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if adaptive_chunk < 1:
            raise ValueError(f"adaptive_chunk must be >= 1, got "
                             f"{adaptive_chunk}")
        if not 0.0 <= join_horizon <= 1.0:
            raise ValueError(f"join_horizon must be in [0, 1], got "
                             f"{join_horizon}")
        self.executor = executor
        self.params = params
        # the linear kernel's prepared weights, made before any batch runs
        # or a fused graph captures
        prepare = getattr(executor, "prepare_params", None)
        if prepare is not None:
            prepare(params)
        self.store = store
        self.clock = clock if clock is not None else WallClock()
        self.queue = RequestQueue(self.clock)
        self.batcher = MicroBatcher(self.queue, store, max_batch=max_batch,
                                    max_wait=max_wait)
        #: one MetricsRegistry backs every ServerMetrics counter; the
        #: tracer (NULL_TRACER by default — all hooks are no-ops) records
        #: the batch lifecycle as Chrome trace events, one track per
        #: in-flight batch
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.metrics = ServerMetrics(registry=self.registry)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            store.tracer = tracer
            self.batcher.tracer = tracer
        #: ``telemetry=True`` asks fused adaptive runs to carry their
        #: per-step proxy values on the device (read only at finish — no
        #: extra host sync), so every delivered request gets a
        #: :class:`repro_torch.obs.CacheReport` in ``cache_reports``
        self.telemetry = bool(telemetry)
        self.cache_reports: Dict[int, object] = {}   # rid → CacheReport
        self._serial = 0                      # batch serial (trace tracks)
        #: the scheduling policy object; ``scheduler`` may be a built-in
        #: name or any repro_torch.slo.SchedulingPolicy (e.g.
        #: ElasticPolicy(controller))
        self.policy = resolve_policy(scheduler)
        self.scheduler = self.policy.name
        #: a repro_torch.slo.AdmissionController, or None
        self.admission = admission
        self.cost_model = (cost_model if cost_model is not None
                           else ServiceCostModel())
        self.load = LoadEstimator(self.cost_model, batch_factor=max_batch)
        self.max_inflight = max_inflight
        self.adaptive_chunk = adaptive_chunk
        self.eager = eager
        self.check = check
        #: continuous in-flight batching (joins, regroups, coalesces) —
        #: needs an executor with ``split_run`` / ``merge_runs`` and a
        #: deterministic solver (``supports_split``)
        self.continuous = continuous
        #: latest join point as a fraction of the run (a joiner replays
        #: the target's past steps, so late joins cost more than they save)
        self.join_horizon = float(join_horizon)
        #: a repro_torch.resilience.ResiliencePolicy, or None — None keeps
        #: the engine without a fault path: no health reads, no watchdog,
        #: BatchFaults propagate, the stall guard raises
        self.resilience = resilience
        if resilience is not None and resilience.entry_fault_threshold \
                is not None:
            store.health.fault_threshold = resilience.entry_fault_threshold
        #: advances whose health flags the fault path read on the host (one
        #: device→host read each on a card; not decision syncs, so never
        #: in the executor's ``host_sync_count``)
        self.health_reads = 0
        self.results: Dict[int, np.ndarray] = {}
        self.records: List[BatchRecord] = []
        self.shed: Dict[int, Tuple[str, float]] = {}   # rid → (reason, t)
        self._inflight: List[_Inflight] = []
        self._rids: set = set()               # every rid ever submitted
        self._attempts: Dict[int, int] = {}   # rid → fault retry count
        self._requeues: Dict[int, int] = {}   # rid → survivor re-queues
        self._level: Dict[int, int] = {}      # rid → degradation level
        self._origin: Dict[int, str] = {}     # rid → group first submitted
        #: durability (repro_torch.durable): optional write-ahead journal
        #: (a path or a RequestJournal) + boundary run-state snapshots;
        #: ``recover()`` replays both after a restart
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{checkpoint_every}")
        self.checkpoint_every = int(checkpoint_every)
        self.journal = None
        if journal is not None:
            self.journal = (journal if isinstance(journal, RequestJournal)
                            else RequestJournal(str(journal)))
        self._snapshots = None
        if snapshot_dir is not None:
            if not getattr(executor, "supports_export", False):
                raise ValueError(
                    "snapshot_dir= needs an executor with run-state "
                    "export/import seams (supports_export)")
            self._snapshots = SnapshotStore(str(snapshot_dir))
        self._done: set = set()               # journal-known finishes
        self._sweep_needed = (admission is not None
                              or resilience is not None)

    # -- submission ----------------------------------------------------------

    def submit(self, *reqs: Request) -> None:
        """Enqueue requests (arrival stamped now unless preset).

        Invalid submissions become *reasoned outcomes*, never exceptions
        that would kill a serving loop mid-stream: an unknown policy name
        is recorded as a ``no_entry`` shed (``outcome(rid)`` reports it),
        and a duplicate rid — against *every* rid ever submitted — is
        dropped and counted, leaving the original request untouched."""
        now = self.clock.now()
        accepted = []
        recs = []
        for r in reqs:
            if r.rid in self._rids:
                self.metrics.observe_reject("duplicate_rid")
                self.tracer.instant("reject", rid=r.rid,
                                    reason="duplicate_rid")
                continue
            self._rids.add(r.rid)
            if self.journal is not None:
                recs.append(self._submit_rec(r, now))
            if r.policy not in self.store:
                self.shed[r.rid] = ("no_entry", now)
                self.metrics.observe_shed(r, "no_entry", now)
                self.metrics.observe_reject("no_entry")
                self.tracer.instant("reject", rid=r.rid, reason="no_entry")
                if self.journal is not None:
                    recs.append({"ev": "shed", "rid": r.rid,
                                 "reason": "no_entry", "t": now})
                continue
            accepted.append(r)
            if r.max_tau is not None:
                self._sweep_needed = True
            if self.tracer.enabled:
                self.tracer.instant("submit", rid=r.rid, policy=r.policy,
                                    priority=r.priority)
        if recs:
            # the write-ahead contract: a submission is on disk (fsynced)
            # before the queue can act on it — a crash after this line
            # cannot lose an accepted request
            self.journal.append_many(recs, sync=True)
        self.queue.submit_many(accepted)

    def outcome(self, rid: int):
        """Explicit fate of a submitted request — never silently dropped:
        ``("done", latent)``, ``("shed", reason)``, or ``("pending",
        None)``.  After a restart the *verdict* of a pre-crash finish
        survives via the journal — ``("done", None)``: the latent itself
        is not journaled (it was delivered before the crash), but the
        request is provably not lost."""
        if rid not in self._rids:
            raise KeyError(f"rid {rid} was never submitted")
        if rid in self.results:
            return ("done", self.results[rid])
        if rid in self.shed:
            return ("shed", self.shed[rid][0])
        if rid in self._done:
            return ("done", None)
        return ("pending", None)

    # -- durability plumbing --------------------------------------------------

    def _submit_rec(self, r: Request, now: float) -> Dict:
        """The journaled form of one submission — everything needed to
        rebuild the Request verbatim after a restart (original arrival
        included, so re-admission never launders queue wait)."""
        rec = {"ev": "submit", "rid": r.rid, "seed": int(r.seed),
               "policy": r.policy,
               "arrival": float(r.arrival) if r.arrival is not None
               else float(now)}
        if r.label is not None:
            rec["label"] = int(r.label)
        if r.priority:
            rec["priority"] = int(r.priority)
        if r.slo is not None:
            rec["slo"] = {"deadline": r.slo.deadline,
                          "max_tau": r.slo.max_tau, "cls": r.slo.cls}
        return rec

    def _journal(self, ev: str, *, sync: bool = True, **fields) -> None:
        if self.journal is not None:
            self.journal.append(ev, sync=sync, **fields)

    def _drop_snapshot(self, fl: "_Inflight") -> None:
        """The run left flight (finished / faulted / merged away /
        regrouped / split) — its snapshot no longer describes anything."""
        if self._snapshots is not None:
            self._snapshots.drop(fl.serial)

    # -- SLO sweep (quality floors + admission) ------------------------------

    def _backlog_seconds(self, now: float) -> float:
        """Load estimate: queued steps (batch-amortized) + in-flight
        remaining steps, priced at the calibrated per-step cost."""
        queued = []
        for g in self.queue.ready_groups(now):
            for r in self.queue.peek(g, now):
                e = self.store.resolve_entry_for(g, r)
                queued.append(e.plan.num_steps if e is not None else 0)
        inflight = [remaining_steps(fl.rs) for fl in self._inflight]
        return self.load.backlog_seconds(queued, inflight)

    def _shed(self, req: Request, reason: str, now: float) -> None:
        self.queue.take_rids(req.policy, [req.rid], now)
        self.shed[req.rid] = (reason, now)
        self.metrics.observe_shed(req, reason, now)
        self.tracer.instant("shed", rid=req.rid, reason=reason)
        self._journal("shed", rid=req.rid, reason=reason, t=float(now))

    def _slo_sweep(self, now: float) -> None:
        """Walk the ready queue: shed requests whose quality floor no
        registered rung satisfies (or whose entry the health registry
        marked unhealthy), then let the admission controller shed or defer
        against the backlog estimate.  The backlog is snapshotted once per
        sweep so decisions are order-independent."""
        if not self._sweep_needed:
            return
        backlog = None
        for g in list(self.queue.ready_groups(now)):
            for r in self.queue.peek(g, now):
                entry = self.store.resolve_entry_for(g, r)
                if entry is None:
                    reason = ("unhealthy_entry"
                              if not self.store.health.is_servable(g)
                              else "quality_floor")
                    self._shed(r, reason, now)
                    continue
                if self.admission is None:
                    continue
                if backlog is None:
                    backlog = self._backlog_seconds(now)
                    self.registry.series("slo.backlog_s").record(now,
                                                                 backlog)
                est = self.cost_model.estimate(entry.plan.num_steps,
                                               group=entry.name)
                d = self.admission.decide(r, now, backlog_s=backlog,
                                          est_service_s=est)
                if d.action == "shed":
                    self._shed(r, d.reason, now)
                elif d.action == "defer":
                    self.queue.take_rids(g, [r.rid], now)
                    self.metrics.observe_defer(r, now)
                    self.tracer.instant("defer", rid=r.rid,
                                        retry_at=d.retry_at)
                    self.queue.resubmit(r, d.retry_at)

    # -- scheduling ----------------------------------------------------------

    def _active_inflight(self) -> int:
        """In-flight runs that advance — a parked join target waits on its
        chaser and takes no timeslice."""
        return sum(1 for f in self._inflight if f.parked_by is None)

    def _admit(self, now: float) -> None:
        while self._active_inflight() < self.max_inflight:
            mb = self.batcher.next_batch(now)
            if mb is None:
                break
            self._launch(mb, now)
        if self.continuous:
            self._join_waiting(now)

    def _begin_track(self, mb: MicroBatch, kind: str, *, parent=None,
                     via=None, chaser_for=None) -> Tuple[int, int]:
        """Allocate the next batch serial and — when tracing — a tracer
        track with an open ``run`` span.  Lineage events (join / regroup)
        name the parent serial in the child span's args, the trace-side
        mirror of ``BatchRecord.lineage``."""
        self._serial += 1
        serial, track = self._serial, 0
        if self.tracer.enabled:
            track = self.tracer.new_track(
                f"batch#{serial} {mb.entry.name} b{mb.bucket}")
            args = {"group": mb.entry.name, "version": mb.entry.version,
                    "bucket": mb.bucket, "kind": kind,
                    "rids": list(mb.rids)}
            for k, v in (("parent", parent), ("via", via),
                         ("chaser_for", chaser_for)):
                if v is not None:
                    args[k] = v
            self.tracer.begin(track, "run", **args)
        return serial, track

    def _labels(self, mb: MicroBatch):
        if not any(lab is not None for lab in mb.labels):
            return None
        return torch.tensor([0 if lab is None else int(lab)
                             for lab in mb.labels], dtype=torch.int64,
                            device=self.executor.device)

    @property
    def _fused_adaptive(self) -> bool:
        """Serve adaptive entries through the fused on-device path when
        the executor offers it: one captured graph per entry and bucket
        instead of pool-size variants, no per-step decision sync."""
        return bool(getattr(self.executor, "supports_fused_adaptive",
                            False))

    def _launch(self, mb: MicroBatch, now: float, *,
                chaser_for=None) -> _Inflight:
        entry = mb.entry
        gen = batch_generator(mb.seeds)
        extra = {}
        row_keyed = (self.continuous and not self.eager
                     and getattr(self.executor, "supports_split", False))
        if row_keyed:
            # per-row generators: row i is the B = 1 draw of its own seed,
            # so join/regroup never change a request's bits and replay is
            # per request
            extra["row_keys"] = [batch_generator([s]) for s in mb.seeds]
        label = self._labels(mb)
        if self.eager:
            kind, rs = "eager", _EagerState()
        elif entry.adaptive:
            kind = "adaptive_fused" if self._fused_adaptive else "adaptive"
            start = (self.executor.start_adaptive_fused_run
                     if self._fused_adaptive
                     else self.executor.start_adaptive_run)
            if self.telemetry and self._fused_adaptive:
                # passed only when on, so executors (and test fakes)
                # without the keyword keep working
                extra["telemetry"] = True
            rs = start(self.params, gen, mb.bucket, schedule=entry.schedule,
                       tau=entry.tau, proxy_map=entry.proxy_map,
                       pool=entry.pool(), k_max=entry.k_max, label=label,
                       **extra)
        else:
            kind = "plan"
            rs = self.executor.start_run(
                self.params, gen, mb.bucket, plan=entry.plan,
                schedule=entry.schedule, label=label, **extra)
        for r in mb.requests:
            r.started = now
        serial, track = self._begin_track(
            mb, kind,
            chaser_for=chaser_for.serial if chaser_for is not None
            else None)
        fl = _Inflight(mb=mb, kind=kind, rs=rs, label=label, track=track,
                       serial=serial, row_keyed=row_keyed,
                       chaser_for=chaser_for)
        self._inflight.append(fl)
        # progress event, not an ack — flushed, not fsynced: losing it in
        # a crash only re-launches the batch from its submit records
        self._journal("launch", sync=False, serial=serial, kind=kind,
                      entry=entry.name, version=entry.version,
                      bucket=mb.bucket, rids=list(mb.rids), t=float(now))
        return fl

    def _advance(self, fl: _Inflight) -> None:
        if fl.kind == "plan":
            fl.rs = self.executor.advance_run(self.params, fl.rs,
                                              check=self.check)
        elif fl.kind in ("adaptive", "adaptive_fused"):
            # a chaser clamps to its parked target's boundary so the two
            # align exactly for the merge
            n = self.adaptive_chunk
            if fl.chaser_for is not None:
                n = min(n, fl.chaser_for.rs.step - fl.rs.step)
            n = max(n, 1)
            if fl.kind == "adaptive_fused":
                # the whole chunk: graph replays, no host read
                fl.rs = self.executor.advance_adaptive_fused(
                    self.params, fl.rs, n_steps=n)
            else:
                for _ in range(n):
                    if fl.rs.done:
                        break
                    fl.rs = self.executor.advance_adaptive_run(self.params,
                                                               fl.rs)
        else:                                  # eager escape hatch
            fl.rs.x = self.executor.sample(
                self.params, batch_generator(fl.mb.seeds), fl.mb.bucket,
                schedule=fl.mb.entry.schedule, label=fl.label)

    def _advance_traced(self, fl: _Inflight) -> None:
        """``_advance`` under a per-advance span on the batch's track —
        the try/finally keeps B/E pairs matched even when the advance
        raises, so exported traces always validate."""
        tr = self.tracer
        if not tr.enabled or not fl.track:
            self._advance(fl)
            return
        args = {"kind": fl.kind}
        step = getattr(fl.rs, "step", None)
        if step is not None:
            args["step_from"] = int(step)
        if fl.kind == "plan":
            args["segment"] = fl.rs.plan.run_label(fl.rs.run_index)
        tr.begin(fl.track, "advance", **args)
        try:
            self._advance(fl)
        finally:
            end = {}
            step = getattr(fl.rs, "step", None)
            if step is not None:
                end["step_to"] = int(step)
            tr.end(fl.track, "advance", **end)

    # -- continuous batching (join / regroup / coalesce) ---------------------

    @staticmethod
    def _p2_groups(rows: List[int]) -> List[List[int]]:
        """Decompose a row list into power-of-two-sized groups, largest
        first — every sub-run lands on a budgeted bucket shape, so
        regrouping never grows the variant count."""
        out = []
        rows = list(rows)
        while rows:
            take = 1
            while take * 2 <= len(rows):
                take *= 2
            out.append(rows[:take])
            rows = rows[take:]
        return out

    def _is_linked(self, fl: _Inflight) -> bool:
        return (fl.parked_by is not None or fl.chaser_for is not None
                or any(o.chaser_for is fl for o in self._inflight))

    def _unlink(self, fl: _Inflight) -> None:
        """Detach a run leaving flight (fault/abort) from any join pair
        so its partner does not wait forever: a dying chaser unparks its
        target; a dying target releases its chaser to run to completion
        on its own."""
        if fl.chaser_for is not None and fl.chaser_for.parked_by is fl:
            fl.chaser_for.parked_by = None
        fl.chaser_for = None
        if fl.parked_by is not None:
            fl.parked_by.chaser_for = None
            fl.parked_by = None
        for o in self._inflight:
            if o.chaser_for is fl:
                o.chaser_for = None

    def _join_waiting(self, now: float) -> None:
        """Continuous feeder: waiting compatible requests join an in-flight
        run at its next boundary instead of queuing for a fresh slot.  The
        join is a *catch-up chaser*: the joiners launch as their own p2
        batch at step 0 (their queue wait ends here), the target parks,
        the chaser replays to the target's boundary (clamped advances),
        and the two run states merge — a row concat, bitwise per row —
        once aligned."""
        if not getattr(self.executor, "supports_split", False):
            return
        for fl in list(self._inflight):
            if (fl.kind == "eager" or not fl.row_keyed or fl.rs.done
                    or self._is_linked(fl)):
                continue
            steps = fl.mb.entry.plan.num_steps
            if steps - remaining_steps(fl.rs) > self.join_horizon * steps:
                continue                      # too far gone to chase
            joiners = self.batcher.take_join(now, fl.mb.entry,
                                             fl.mb.bucket)
            if not joiners:
                continue
            mb = MicroBatch(requests=tuple(joiners), entry=fl.mb.entry,
                            formed_at=now)
            chaser = self._launch(mb, now, chaser_for=fl)
            fl.parked_by = chaser
            for r in joiners:
                r.joined_at = now
            self.metrics.observe_join(len(joiners))
            if self.tracer.enabled:
                self.tracer.instant(
                    "join", tid=fl.track, at_step=int(fl.rs.step),
                    chaser=chaser.serial, rids=[r.rid for r in joiners])
            self._try_merge(chaser)           # step-0 target: merge now

    def _merge_pair(self, a: _Inflight, b: _Inflight,
                    tag: str) -> _Inflight:
        """Merge two aligned in-flight runs (rows of ``a`` first, as
        ``merge_runs`` concatenates) into one new in-flight record."""
        merged_rs = self.executor.merge_runs([a.rs, b.rs])
        mb = MicroBatch(requests=a.mb.requests + b.mb.requests,
                        entry=a.mb.entry, formed_at=a.mb.formed_at)
        taint = None
        if a.taint is not None or b.taint is not None:
            ta = (a.taint if a.taint is not None
                  else np.ones(a.mb.bucket, bool))
            tb = (b.taint if b.taint is not None
                  else np.ones(b.mb.bucket, bool))
            taint = np.concatenate([ta, tb])
        rids = ",".join(str(r) for r in b.mb.rids)
        # the merged run keeps a's track and serial — in the trace b's
        # span ends here with a "merged into a" outcome
        if self.tracer.enabled and b.track:
            self.tracer.end(b.track, "run", outcome=f"merged:{tag}",
                            into=a.serial)
        # b's run state is gone; a's snapshot (if any) is superseded at its
        # next boundary checkpoint and the rid-vs-pending staleness check
        # guards the window in between
        self._drop_snapshot(b)
        merged = _Inflight(
            mb=mb, kind=a.kind, rs=merged_rs, label=self._labels(mb),
            taint=taint, cost_excluded=a.cost_excluded or b.cost_excluded,
            row_keyed=True,
            lineage=a.lineage + b.lineage + (f"{tag}@{a.rs.step}:{rids}",),
            track=a.track, serial=a.serial)
        self._inflight[self._inflight.index(a)] = merged
        self._inflight.remove(b)
        self.metrics.observe_merge(kind=tag)
        self.metrics.observe_lineage(tag)
        return merged

    def _try_merge(self, chaser: _Inflight) -> None:
        target = chaser.chaser_for
        if target is None or chaser.rs.step != target.rs.step:
            return
        target.parked_by = None
        chaser.chaser_for = None
        self._merge_pair(target, chaser, "join")

    def _maybe_regroup(self, fl: _Inflight) -> None:
        """At a fused chunk boundary, split a τ > 0 batch whose rows now
        *want* different masks into per-signature sub-runs (p2 sizes
        only): each sub-run's executed mask is the AND over fewer rows,
        so cache-willing rows stop being dragged to full compute by one
        conservative neighbour."""
        if (fl.kind != "adaptive_fused" or fl.mb.entry.tau <= 0
                or fl.mb.bucket <= 1 or not fl.row_keyed or fl.rs.done
                or self._is_linked(fl)
                or not getattr(self.executor, "supports_split", False)):
            return
        sigs = fl.rs.row_signatures()
        if sigs is None or len(set(sigs)) <= 1:
            return
        bysig: Dict[tuple, List[int]] = {}
        for j, sig in enumerate(sigs):
            bysig.setdefault(sig, []).append(j)
        groups = []
        for sig in sorted(bysig):              # deterministic order
            groups.extend(self._p2_groups(bysig[sig]))
        subs = self.executor.split_run(fl.rs, groups)
        if self.tracer.enabled and fl.track:
            self.tracer.end(fl.track, "run",
                            outcome=f"regroup:{len(groups)}")
        self._drop_snapshot(fl)
        idx = self._inflight.index(fl)
        repl = []
        for g, sub in zip(groups, subs):
            mb = MicroBatch(requests=tuple(fl.mb.requests[j] for j in g),
                            entry=fl.mb.entry, formed_at=fl.mb.formed_at)
            rids = ",".join(str(r.rid) for r in mb.requests)
            serial, track = self._begin_track(mb, fl.kind, parent=fl.serial,
                                              via="regroup")
            repl.append(_Inflight(
                mb=mb, kind=fl.kind, rs=sub, label=self._labels(mb),
                taint=(None if fl.taint is None
                       else fl.taint[np.asarray(g)]),
                cost_excluded=fl.cost_excluded, row_keyed=True,
                lineage=fl.lineage + (f"regroup@{fl.rs.step}:{rids}",),
                track=track, serial=serial))
        self._inflight[idx:idx + 1] = repl
        self.metrics.observe_regroup(len(repl))
        self.metrics.observe_lineage("regroup", len(repl))

    def _coalesce(self) -> None:
        """Opportunistic reverse of regroup: two unlinked runs of the same
        entry, version and kind, aligned at one step with equal buckets,
        merge back into one (2·b stays p2, so still on budget).  A τ > 0
        fused pair must currently want one and the same mask — merging
        divergent rows would re-impose the AND that regroup removed."""
        if not getattr(self.executor, "supports_split", False):
            return
        for a in list(self._inflight):
            if a not in self._inflight:
                continue
            if (a.kind == "eager" or not a.row_keyed or a.rs.done
                    or self._is_linked(a)):
                continue
            for b in list(self._inflight):
                if (b is a or b not in self._inflight
                        or a not in self._inflight):
                    continue
                if (b.kind != a.kind or not b.row_keyed or b.rs.done
                        or self._is_linked(b)
                        or b.mb.entry.name != a.mb.entry.name
                        or b.mb.entry.version != a.mb.entry.version
                        or b.mb.bucket != a.mb.bucket
                        or a.mb.bucket + b.mb.bucket
                        > self.batcher.max_batch
                        or b.rs.step != a.rs.step):
                    continue
                if a.kind == "adaptive_fused" and a.mb.entry.tau > 0:
                    sa, sb = a.rs.row_signatures(), b.rs.row_signatures()
                    if sa is None or sb is None or set(sa) != set(sb) \
                            or len(set(sa)) != 1:
                        continue
                self._merge_pair(a, b, "coalesce")

    # -- fault handling (degrade, don't die) ---------------------------------

    def _read_health(self, fl: _Inflight):
        """Merge the run state's sentinel flags into the in-flight taint
        record.  Returns the merged (B,) bool array, or None when neither
        the sentinels nor the chaos harness flagged anything.  Newly
        poisoned rows are counted as one fault event against the group.
        On a card this is one device→host read (``health_reads``), made
        after the advance, outside any graph replay."""
        flags = getattr(fl.rs, "healthy", None)
        if flags is None:
            return fl.taint
        self.health_reads += 1
        if isinstance(flags, torch.Tensor):
            flags = flags.cpu().numpy()
        cur = np.asarray(flags).astype(bool)
        if fl.taint is not None:
            cur = cur & fl.taint
        prev = fl.taint
        newly = (~cur) if prev is None else (prev & ~cur)
        if newly.any():
            self.metrics.observe_fault(fl.mb.group, NAN_LATENT)
            self.store.report_fault(fl.mb.group, NAN_LATENT)
        fl.taint = cur
        return cur

    def _fault_abort(self, fl: _Inflight, kind: str, sample_flags,
                     now: float, *, count: bool = True) -> None:
        """Abandon an in-flight batch after a fault.  Rows flagged healthy
        (per-sample resolution) or all rows (no resolution) *survive*:
        they re-queue at their original arrival time (``resubmit`` never
        touches ``arrival``, so queue-wait accounting keeps charging from
        first arrival).  Poisoned rows go down the degradation ladder via
        :meth:`_retry_or_fail`.  Survivors that keep landing in aborted
        batches are bounded too — past the retry budget they join the
        fault path instead of looping forever."""
        mb = fl.mb
        self._unlink(fl)
        self._drop_snapshot(fl)
        if self.tracer.enabled and fl.track:
            self.tracer.end(fl.track, "run", outcome=f"fault:{kind}")
        if count:
            self.metrics.observe_fault(mb.group, kind)
            self.store.report_fault(mb.group, kind)
        flags = sample_flags if sample_flags is not None else fl.taint
        budget = self.resilience.retry.max_retries
        for j, r in enumerate(mb.requests):
            ok = True if flags is None else bool(flags[j])
            if not ok:
                self._retry_or_fail(r, kind, now)
                continue
            n = self._requeues.get(r.rid, 0) + 1
            self._requeues[r.rid] = n
            if n > budget + 1:
                # repeatedly a bystander of dying batches — stop looping
                self._retry_or_fail(r, kind, now)
            else:
                r.started = None
                self.queue.resubmit(r, now)
                self.metrics.observe_requeue(1)

    def _retry_or_fail(self, r: Request, kind: str, now: float) -> None:
        """Bounded retry of one faulted request, stepping down the
        degradation ladder (current rung → τ=0 → no_cache) with
        deterministic backoff; past the budget the request ends as a
        reasoned terminal outcome (``fault:<kind>``), counted like any
        shed — never a crash, never a silent drop."""
        pol = self.resilience
        att = self._attempts.get(r.rid, 0) + 1
        self._attempts[r.rid] = att
        if att > pol.retry.max_retries:
            self.shed[r.rid] = (f"fault:{kind}", now)
            self.metrics.observe_shed(r, f"fault:{kind}", now)
            self.tracer.instant("shed", rid=r.rid, reason=f"fault:{kind}")
            self._journal("shed", rid=r.rid, reason=f"fault:{kind}",
                          t=float(now))
            return
        origin = self._origin.setdefault(r.rid, r.policy)
        if pol.degrade:
            level = self._level.get(r.rid, 0) + 1
            target = self.store.degraded_entry_name(origin, level)
            if target is None:    # no τ=0 form for this group: skip a rung
                level = 2
                target = self.store.degraded_entry_name(origin, level)
            self._level[r.rid] = level
            if target != r.policy:
                r.policy = target
                self.metrics.observe_degrade(r)
        r.started = None
        self.metrics.observe_retry(r)
        self.tracer.instant("retry", rid=r.rid, attempt=att,
                            policy=r.policy)
        self._journal("retry", sync=False, rid=r.rid, attempt=att,
                      policy=r.policy, level=self._level.get(r.rid, 0),
                      t=float(now))
        self.queue.resubmit(r, now + pol.retry.delay(att, r.rid))

    def _stall_shed(self, reason: str, now: float) -> None:
        """Degrade-don't-die replacement for the stall guard: every queued
        request gets an explicit shed outcome instead of the engine
        raising out of its serving loop."""
        recs = []
        for r in self.queue.drain_all():
            self.shed[r.rid] = (reason, now)
            self.metrics.observe_shed(r, reason, now)
            self.tracer.instant("shed", rid=r.rid, reason=reason)
            recs.append({"ev": "shed", "rid": r.rid, "reason": reason,
                         "t": float(now)})
        if recs and self.journal is not None:
            self.journal.append_many(recs, sync=True)

    def _watchdog_deadline(self, steps: int, group: str,
                           bucket: Optional[int] = None) -> float:
        # keyed on the same (rung, bucket) the cost model learns on, so
        # a ladder move or a regrouped bucket size gets its own deadline
        est = self.cost_model.estimate(max(int(steps), 1), group=group,
                                       bucket=bucket)
        return self.resilience.deadline(est)

    def _advance_guarded(self, i: int, fl: _Inflight) -> bool:
        """Advance under the fault net: a ``BatchFault`` raised
        mid-advance, a blown watchdog deadline, or sentinel-flagged rows
        all route into the recovery path instead of propagating.  Returns
        True when the batch was aborted (``fl`` removed from flight)."""
        pol = self.resilience
        build = getattr(self.executor, "fused_step_for", None)
        if fl.kind == "adaptive_fused" and build is not None:
            # a new fused step's warm-up and capture happen here, before
            # the watchdog's clock starts: a capture is not a stall
            build(self.params, fl.rs)
        before = self.clock.now()
        steps_before = remaining_steps(fl.rs)
        try:
            self._advance_traced(fl)
        except BatchFault as bf:
            self._inflight.pop(i)
            self._fault_abort(fl, bf.kind, bf.sample_flags,
                              self.clock.now())
            return True
        after = self.clock.now()
        if pol.watchdog_factor is not None:
            steps_adv = steps_before - remaining_steps(fl.rs)
            deadline = self._watchdog_deadline(steps_adv, fl.mb.group,
                                               fl.mb.bucket)
            if after - before > deadline:
                self.tracer.instant("watchdog_fire", tid=fl.track,
                                    group=fl.mb.group,
                                    elapsed_s=after - before,
                                    deadline_s=deadline)
                if fl.rs.done:
                    # too late to re-queue — deliver, but keep the stall
                    # out of the cost model and on the books
                    fl.cost_excluded = True
                    self.metrics.observe_fault(fl.mb.group, STUCK_BATCH)
                    self.store.report_fault(fl.mb.group, STUCK_BATCH)
                else:
                    self._inflight.pop(i)
                    self._fault_abort(fl, STUCK_BATCH, None, after)
                    return True
        flags = self._read_health(fl)
        if flags is not None and not flags.any() and not fl.rs.done:
            # every row is poisoned — nothing left worth carrying to the
            # finish line (already counted by _read_health)
            self._inflight.pop(i)
            self._fault_abort(fl, NAN_LATENT, flags, after, count=False)
            return True
        if (flags is not None and not flags.all() and not fl.rs.done
                and pol.split_retry
                and fl.mb.bucket > 1 and fl.kind != "eager"
                and not self._is_linked(fl)
                and getattr(self.executor, "supports_split", False)):
            # per-row retry within a continuing batch: faulted rows split
            # out and go down the ladder now, survivors keep their run
            # state (p2 sub-batches — no new shapes) instead of dragging
            # dead rows to the finish line
            self._split_retry(i, fl, flags, after)
            return True
        return False

    def _split_retry(self, i: int, fl: _Inflight, flags,
                     now: float) -> None:
        good = [j for j in range(fl.mb.bucket) if flags[j]]
        bad = [j for j in range(fl.mb.bucket) if not flags[j]]
        groups = self._p2_groups(good)
        subs = self.executor.split_run(fl.rs, groups)
        if self.tracer.enabled and fl.track:
            self.tracer.end(fl.track, "run",
                            outcome=f"split_retry:{len(bad)}")
        self._drop_snapshot(fl)
        self._inflight.pop(i)
        for g, sub in zip(groups, subs):
            mb = MicroBatch(requests=tuple(fl.mb.requests[j] for j in g),
                            entry=fl.mb.entry, formed_at=fl.mb.formed_at)
            rids = ",".join(str(r.rid) for r in mb.requests)
            serial, track = self._begin_track(mb, fl.kind, parent=fl.serial,
                                              via="split_retry")
            self._inflight.append(_Inflight(
                mb=mb, kind=fl.kind, rs=sub, label=self._labels(mb),
                cost_excluded=fl.cost_excluded, row_keyed=fl.row_keyed,
                lineage=fl.lineage + (f"split_retry@{fl.rs.step}:{rids}",),
                track=track, serial=serial))
        for j in bad:
            self._retry_or_fail(fl.mb.requests[j], NAN_LATENT, now)
        self.metrics.observe_row_retry(len(bad))
        self.metrics.observe_lineage("split_retry", len(groups))

    def _finish(self, fl: _Inflight) -> None:
        mb, rs = fl.mb, fl.rs
        # the one device→host copy of a batch (it waits for the device)
        x = rs.x
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        done = self.clock.now()
        # service time of the whole batch, taken before any faulted row's
        # re-queue resets its start stamp
        service = done - mb.requests[0].started
        flags = None
        if self.resilience is not None:
            # rows are computationally independent (attention is within a
            # sample, CFG doubles per sample, every product runs the
            # batch-invariant linear kernel), so a poisoned row never
            # reaches its neighbours: deliver the healthy rows — bitwise
            # an uninjected run's — and send only the poisoned ones down
            # the ladder
            finite = np.isfinite(x.reshape(x.shape[0], -1)).all(axis=1)
            flags = finite if fl.taint is None else (fl.taint & finite)
            if flags.all():
                flags = None
            else:
                newly = ((~flags) if fl.taint is None
                         else (fl.taint & ~flags))
                if newly.any():
                    # the final-latent check found poison the sentinels
                    # had not counted (paths without health flags)
                    self.metrics.observe_fault(mb.group, NAN_LATENT)
                    self.store.report_fault(mb.group, NAN_LATENT)
        delivered = []
        for j, r in enumerate(mb.requests):
            if flags is not None and not flags[j]:
                self._retry_or_fail(r, NAN_LATENT, done)
                continue
            r.finished = done
            self.results[r.rid] = x[j]
            self.metrics.observe_request(r)
            delivered.append(r)
        if delivered and self.journal is not None:
            # ack event: the finish verdict is on disk before the engine
            # moves on — outcome(rid) survives the process
            self.journal.append("finish", sync=True,
                                rids=[r.rid for r in delivered],
                                t=float(done))
        for r in delivered:
            self._done.add(r.rid)
        self._drop_snapshot(fl)
        entry = mb.entry
        num_types = len(entry.schedule.skip)
        decisions = rs.decisions
        if decisions:
            skipped = sum(len(d) for d in decisions)
            frac = 1.0 - skipped / float(entry.plan.num_steps * num_types)
        else:
            frac = entry.compute_fraction()
        self.metrics.observe_batch(mb.group, mb.bucket, frac,
                                   entry.plan.num_steps, num_types)
        # feed the calibrated per-step cost model (service time of the
        # whole batch — includes interleaving contention); faulted and
        # stalled batches stay out, so retries do not skew admission
        if flags is None and not fl.cost_excluded:
            self.cost_model.observe(mb.group, service, entry.plan.num_steps,
                                    bucket=mb.bucket)
        qcost = entry.predicted_quality_cost(decisions)
        self.metrics.observe_quality(entry.tau, qcost, n=mb.bucket)
        if self.tracer.enabled and fl.track:
            self.tracer.end(fl.track, "run", outcome="done",
                            compute_fraction=frac)
        if self.telemetry:
            # per-request cache-decision explainers: one boundary read of
            # the fused run's traces per finished batch
            reports = run_cache_reports(rs, mb.bucket,
                                        schedule=entry.schedule,
                                        tau=entry.tau)
            for j, r in enumerate(mb.requests):
                if j < len(reports) and (flags is None or flags[j]):
                    self.cache_reports[r.rid] = reports[j]
        record = BatchRecord(
            group=mb.group, version=entry.version, bucket=mb.bucket,
            rids=mb.rids, seeds=mb.seeds, labels=mb.labels,
            num_steps=entry.plan.num_steps, compute_fraction=frac,
            formed_at=mb.formed_at, finished_at=done, decisions=decisions,
            tau=entry.tau, quality_cost=qcost, lineage=fl.lineage)
        self.records.append(record)
        self.policy.on_finish(self, record,
                              delivered if flags is not None
                              else mb.requests, done)

    # -- durability: boundary checkpoints + restart recovery ------------------

    def _maybe_checkpoint(self, fl: _Inflight) -> None:
        """Count a survived boundary advance; every
        ``checkpoint_every``-th one snapshots the run.  Eager runs have
        no boundaries (one advance = the whole batch) and finished runs
        are about to deliver — neither checkpoints."""
        if self._snapshots is None or fl.kind == "eager" or fl.rs.done:
            return
        fl.advances += 1
        if fl.advances % self.checkpoint_every:
            return
        self._checkpoint(fl)

    def _checkpoint(self, fl: _Inflight) -> None:
        """Snapshot one in-flight run (tensors via the executor's export
        seam, provenance-stamped meta via the entry).  Degrade, don't
        die: a failed write is counted and traced, never raised — the
        batch just loses restore coverage until the next boundary."""
        now = self.clock.now()
        entry = fl.mb.entry
        try:
            kind, arrays, static = self.executor.export_run(fl.rs)
            meta = dict(entry.provenance(), kind=kind, serial=fl.serial,
                        static=static, rids=list(fl.mb.rids),
                        seeds=[int(s) for s in fl.mb.seeds],
                        priorities=[int(r.priority)
                                    for r in fl.mb.requests],
                        formed_at=float(fl.mb.formed_at),
                        row_keyed=bool(fl.row_keyed),
                        lineage=list(fl.lineage), t=float(now))
            name, nbytes = self._snapshots.save(fl.serial, arrays, meta)
        except Exception as e:
            self.metrics.observe_checkpoint_error()
            self.tracer.instant("checkpoint_error", serial=fl.serial,
                                error=type(e).__name__)
            return
        self.metrics.observe_checkpoint(nbytes)
        step = static.get("step", static.get("run_index", 0))
        self._journal("checkpoint", sync=False, serial=fl.serial,
                      snapshot=name, step=int(step),
                      rids=list(fl.mb.rids), t=float(now))
        if self.tracer.enabled:
            self.tracer.instant("checkpoint", tid=fl.track, snapshot=name,
                                bytes=int(nbytes))

    def _rebuild_request(self, rec: Dict) -> Request:
        """Journal submit record → Request, verbatim (original arrival,
        label, priority, SLO)."""
        slo = None
        if rec.get("slo") is not None:
            s = rec["slo"]
            slo = SLO(deadline=s.get("deadline"), max_tau=s.get("max_tau"),
                      cls=s.get("cls", "default"))
        return Request(rid=rec["rid"], seed=rec["seed"],
                       policy=rec["policy"], label=rec.get("label"),
                       priority=int(rec.get("priority", 0)), slo=slo,
                       arrival=rec.get("arrival"))

    def _refuse_snapshot(self, path: str, reason: str,
                         summary: Dict) -> None:
        """A snapshot that cannot be trusted (torn file, checksum
        mismatch, provenance drift, import failure): quarantined on disk
        and in the store's health ledger — its requests take the
        replay-from-start path, which the determinism contract makes
        bitwise the same anyway."""
        qname = self._snapshots.quarantine(path)
        self.store.health.quarantine(f"snapshot:{qname}", reason)
        summary["refused"].append((qname, reason))
        self.metrics.observe_snapshot_refused()
        self.tracer.instant("snapshot_refused", snapshot=qname,
                            reason=reason)

    def _restore_snapshot(self, path: str, pending: Dict, restored: set,
                          started: Dict, now: float,
                          summary: Dict) -> None:
        try:
            arrays, meta = self._snapshots.load(path)
        except (CheckpointError, SnapshotError, OSError, ValueError) as e:
            self._refuse_snapshot(path, f"{type(e).__name__}: {e}",
                                  summary)
            return
        rids = list(meta.get("rids", ()))
        if not rids or any(r in restored for r in rids) \
                or not all(r in pending for r in rids):
            # superseded, not suspect: its requests already finished /
            # shed / were restored from a newer snapshot — silent delete
            self._snapshots.discard(path)
            summary["stale"] += 1
            return
        try:
            entry = self.store.get(meta.get("entry"))
        except KeyError:
            self._refuse_snapshot(
                path, f"entry {meta.get('entry')!r} no longer in store",
                summary)
            return
        prov = entry.provenance()
        for k in ("version", "schedule_fp", "plan_hash",
                  "artifact_checksum", "tau", "k_max"):
            if meta.get(k) != prov.get(k):
                self._refuse_snapshot(
                    path, f"provenance drift on {k}: snapshot "
                    f"{meta.get(k)!r} vs entry {prov.get(k)!r}", summary)
                return
        kind = meta.get("kind")
        if kind == "plan":
            kw = {"plan": entry.plan}
        else:
            kw = dict(schedule=entry.schedule, tau=entry.tau,
                      proxy_map=entry.proxy_map, pool=entry.pool(),
                      k_max=entry.k_max)
        try:
            rs = self.executor.import_run(self.params, kind, arrays,
                                          meta["static"], **kw)
        except (KeyError, TypeError, ValueError) as e:
            self._refuse_snapshot(
                path, f"import failed: {type(e).__name__}: {e}", summary)
            return
        reqs = []
        for r in rids:
            req = self._rebuild_request(pending[r])
            req.started = started.get(r, now)
            reqs.append(req)
        mb = MicroBatch(requests=tuple(reqs), entry=entry,
                        formed_at=float(meta.get("formed_at", now)))
        serial, track = self._begin_track(mb, kind, via="restore")
        static = meta.get("static", {})
        at = int(static.get("step", static.get("run_index", 0)))
        fl = _Inflight(mb=mb, kind=kind, rs=rs, label=self._labels(mb),
                       row_keyed=bool(meta.get("row_keyed", False)),
                       lineage=tuple(meta.get("lineage", ()))
                       + (f"restore@{at}",),
                       track=track, serial=serial)
        self._inflight.append(fl)
        self._snapshots.adopt(serial, path)
        for r in rids:
            restored.add(r)
            pending.pop(r, None)
        summary["restored_runs"] += 1
        summary["restored_requests"] += len(rids)

    def recover(self, journal=None, snapshot_dir=None) -> Dict:
        """Restart recovery: replay the write-ahead journal, restore
        in-flight batches from their newest valid snapshots, and re-admit
        everything else at its original arrival.

        * journal verdicts seed ``outcome()`` — finished/shed requests
          stay finished/shed across the restart (``("done", None)`` for a
          pre-crash finish: the verdict survives, the delivered payload
          was the old process's to lose);
        * snapshots are scanned newest-sequence-first with rid dedup:
          a valid snapshot whose requests are all still pending restores
          as a live in-flight batch and continues through the normal
          ``advance_*`` path; an invalid one (torn, tampered, provenance
          drift) is quarantined with a reason; a superseded one is
          deleted;
        * every pending request not covered by a restored run replays
          from the start — bitwise the same as never having crashed, by
          the determinism contract (per-row generators under
          ``continuous=True``, the batch generator of the same seeds
          otherwise).

        Pass ``journal``/``snapshot_dir`` to attach durability to an
        engine constructed without it (the factory pattern of the kill
        harness); both default to whatever the constructor wired.
        Returns a JSON-safe summary (the JAX engine's keys) and journals
        a ``recover`` event."""
        if journal is not None:
            self.journal = (journal if isinstance(journal, RequestJournal)
                            else RequestJournal(str(journal)))
        if snapshot_dir is not None:
            self._snapshots = SnapshotStore(str(snapshot_dir))
        summary: Dict = {"done": 0, "shed": 0, "restored_runs": 0,
                         "restored_requests": 0, "replayed": 0,
                         "refused": [], "stale": 0, "journal_skipped": 0}
        if self.journal is None:
            return summary
        st = JournalState.replay(self.journal.path)
        summary["journal_skipped"] = st.skipped
        now = self.clock.now()
        self._rids.update(st.submitted)
        self._done.update(st.done)
        self.shed.update(st.shed)
        self._attempts.update(st.attempts)
        self._level.update(st.levels)
        summary["done"] = len(st.done)
        summary["shed"] = len(st.shed)
        pending = st.pending()
        restored: set = set()
        if self._snapshots is not None:
            for path in self._snapshots.scan():
                self._restore_snapshot(path, pending, restored,
                                       st.started, now, summary)
        replay = [self._rebuild_request(rec)
                  for _, rec in sorted(
                      pending.items(),
                      key=lambda kv: (kv[1].get("arrival", 0.0),
                                      str(kv[0])))]
        if any(r.max_tau is not None for r in replay):
            self._sweep_needed = True
        self.queue.submit_many(replay)
        summary["replayed"] = len(replay)
        self.metrics.observe_recovery(summary["restored_runs"],
                                      summary["restored_requests"],
                                      summary["replayed"],
                                      summary["stale"])
        self._journal("recover", sync=True,
                      restored_runs=summary["restored_runs"],
                      restored_requests=summary["restored_requests"],
                      replayed=summary["replayed"],
                      refused=len(summary["refused"]), t=float(now))
        self.tracer.instant("recover", **{
            k: v for k, v in summary.items() if k != "refused"})
        return summary

    def step(self) -> bool:
        """One scheduling tick: sweep SLOs (quality-floor sheds, admission
        shed/defer), admit what fits, then advance the in-flight run the
        scheduling policy selects by one unit (a plan segment / an
        adaptive step-chunk / a whole eager batch).  Returns False when
        nothing is runnable *right now* (requests may still be in flight
        toward their arrival)."""
        now = self.clock.now()
        self._slo_sweep(now)
        self._admit(now)
        if not self._inflight:
            return False
        i = self.policy.select(self, now)
        fl = self._inflight[i]
        if fl.parked_by is not None:
            # a parked join target does not advance — its timeslice goes
            # to the chaser catching up with it
            fl = fl.parked_by
            i = self._inflight.index(fl)
        if self.resilience is None:
            self._advance_traced(fl)
        elif self._advance_guarded(i, fl):
            return True                       # batch aborted into recovery
        if fl.rs.done:
            self._inflight.pop(i)
            self._finish(fl)
        else:
            if self.continuous:
                if fl.chaser_for is not None:
                    self._try_merge(fl)
                else:
                    self._maybe_regroup(fl)
                self._coalesce()
            if fl in self._inflight:
                # boundary checkpoint: the host just finished an advance
                # (plan segment / adaptive chunk) — the only place a
                # snapshot is taken, so the fused path's host_sync_count
                # stays where it was
                self._maybe_checkpoint(fl)
            if fl in self._inflight and self.policy.rotate():
                self._inflight.remove(fl)
                self._inflight.append(fl)
        return True

    def run_until_drained(self) -> Dict[int, np.ndarray]:
        """Serve until every submitted request has an *outcome* — a result
        or an explicit shed — sleeping the clock across arrival gaps,
        batching windows and deferral retries.  Returns {rid: latent row}
        for the served ones; :meth:`outcome` resolves any rid's fate."""
        stalled = 0
        last_now = None
        while True:
            if self.step():
                stalled = 0
                continue
            if len(self.queue) == 0:
                break
            now = self.clock.now()
            t = self.batcher.next_event(now)
            if t is None:
                # with a resilience policy the stall guard degrades
                # instead of dying: every stuck request becomes an
                # explicit "stalled" shed and the drain completes
                if self.resilience is not None:
                    self._stall_shed("stalled", now)
                    continue
                raise RuntimeError(
                    "serve engine stalled: queued requests but no "
                    "schedulable event")
            if t <= now:
                # wall clock crossed an arrival / batching window between
                # step()'s reading and this one — re-tick.  Under a frozen
                # VirtualClock a repeat with no progress is a livelock:
                # fail loudly instead of spinning forever.
                stalled = stalled + 1 if now == last_now else 0
                last_now = now
                if stalled > 64:
                    if self.resilience is not None:
                        self._stall_shed("stalled", now)
                        stalled = 0
                        continue
                    raise RuntimeError(
                        f"serve engine livelocked at t={now}: "
                        f"next_event={t} never becomes schedulable")
                continue
            last_now = now
            self.clock.sleep_until(t)
        return self.results

    # -- reporting -----------------------------------------------------------

    def program_budget(self) -> int:
        """Static upper bound on the shape-specialized model-call variants
        this deployment may dispatch: |admissible buckets| × Σ per-entry
        cost — a fused adaptive entry costs 1 per bucket (the whole pool
        rides inside one captured graph), a host-dispatched adaptive entry
        its pool size (2^|ever-skipped| signatures), a static entry its
        plan's unique signatures.  Independent of the traffic served."""
        buckets = len(bucket_sizes(self.batcher.max_batch))
        return buckets * sum(
            self.store.get(name).program_cost(fused=self._fused_adaptive)
            for name in self.store.names())

    #: executor variant kinds that are *model* calls (the budgeted set)
    MODEL_PROGRAM_KINDS = ("seg", "sigstep", "eager", "fused")

    def report(self) -> Dict:
        counts = {kind: self.executor.compiled_variant_count(kind)
                  for kind in self.MODEL_PROGRAM_KINDS}
        variants = {kind: n for kind, n in counts.items() if n}
        variants["model_variants"] = sum(counts.values())
        # export the calibrated per-step cost model as registry gauges
        snap = self.cost_model.snapshot()
        if snap["global"] is not None:
            self.registry.set_gauge("slo.step_cost_s", snap["global"])
        for g, v in snap["per_group"].items():
            self.registry.set_gauge("slo.step_cost_s", v, group=g)
        return self.metrics.report(compile_counts=variants,
                                   program_budget=self.program_budget())
