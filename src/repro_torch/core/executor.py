"""SmoothCache execution engine.

Runs a diffusion sampler where each step's per-type skip mask comes from a
static `Schedule`, or — on the input-adaptive path — from a per-step
decision over the schedule's candidate pool.  A skipped type's branches
are not computed: their outputs come from an explicit branch cache
threaded between steps.

Two static paths, bitwise equal on the same inputs:

* ``sample`` — **eager**: every computed branch is collected and merged
  into a full-structure cache.  The reference path, and the one
  calibration hooks into (it observes *all* branch outputs).
* ``sample_compiled`` — **segmented**: :mod:`repro_torch.core.plan` run-length
  encodes the schedule into constant-mask segments and computes branch
  liveness.  Types that are never read are never collected nor resident;
  exact liveness is enforced at segment boundaries by dropping dead
  entries.  A segment is a Python loop over its steps; ``start_run`` /
  ``advance_run`` expose it one segment at a time.

Two adaptive paths, bitwise equal on the same inputs:

* ``sample_adaptive`` (``start_adaptive_run`` / ``advance_adaptive_run``)
  — the host-dispatched loop: each step evaluates the reuse rule on the
  device, reads the realized skip bits on the host (one device→host sync
  per τ > 0 step, counted in ``host_sync_count``) and runs the matching
  pool signature.
* ``sample_adaptive_fused`` (``start_adaptive_fused_run`` /
  ``advance_adaptive_fused``) — decision and dispatch on the device: on a
  CUDA device each step is one replay of a captured CUDA graph whose pool
  signatures sit in conditional nodes (:mod:`repro_torch.core.fused`), so
  a chunk of steps makes no host read at all.

Run states of all three kinds are divisible values (``split_run`` /
``merge_runs``): row gathers and concatenations, bitwise per row, the
ground continuous batching stands on.  ``row_keys`` draws each row from
its own generator so that any grouping of the rows samples each row as
its solo run does, bitwise: on a card the model's products go through the
batch-invariant ``ops.linear`` kernel and the proxy's row sums through
one fixed tree (``calibration.row_sums``).

Eager PyTorch compiles nothing, so where the JAX package counts compiled
programs the executor records every distinct model-call *variant* it
dispatches, as ``(kind, signature, batch)`` with kinds ``"seg"``,
``"sigstep"``, ``"eager"`` and ``"fused"`` (one per captured graph;
``fn_keys``, ``compiled_variant_count``): the shapes a compiled version
would specialize on, which the serving program budget bounds.

Classifier-free guidance doubles the batch ([cond; uncond]) exactly as in
the paper's DiT-XL protocol; the cache covers both halves.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core import calibration, cuda_graphs, fused
from repro_torch.core import diffusion, plan as plan_lib, schedule as schedule_lib
from repro_torch.core.fused import rows_finite
from repro_torch.core.solvers import Solver, StepTable


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _take_rows(tree, idx, batch, axis: int = 0):
    """Slice rows ``idx`` out of every batch-shaped leaf of ``tree`` along
    ``axis``: dim == ``batch`` → those rows; == ``2*batch`` (a CFG-doubled
    branch cache, ``[cond; uncond]``) → the rows from both halves, the
    halves kept contiguous; anything else (None included) passes through.
    Pure gathers — no model compute.  (Branch-cache leaves carry each
    stage's stacked repeat axis first, so their batch axis is 1.)"""
    idx = list(idx)

    def take(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() <= axis:
            return leaf
        n = leaf.shape[axis]
        if n == batch:
            rows = idx
        elif n == 2 * batch:
            rows = idx + [i + batch for i in idx]
        else:
            return leaf
        return leaf.index_select(axis, torch.as_tensor(rows,
                                                       device=leaf.device))

    return _map_leaves(take, tree)


def _concat_rows(trees, batches, axis: int = 0):
    """Concatenate the runs' leaves along the batch ``axis`` — the merge
    dual of :func:`_take_rows`: batch-shaped leaves concat directly,
    CFG-doubled leaves concat all cond halves then all uncond halves;
    non-batch leaves are shared and the first run's value is kept."""
    def dim(leaf):
        return (leaf.shape[axis] if isinstance(leaf, torch.Tensor)
                and leaf.dim() > axis else None)

    def cat(leaves):
        if all(dim(lf) == b for lf, b in zip(leaves, batches)):
            return torch.cat(leaves, dim=axis)
        if all(dim(lf) == 2 * b for lf, b in zip(leaves, batches)):
            halves = [lf.split(b, dim=axis)
                      for lf, b in zip(leaves, batches)]
            return torch.cat([h[0] for h in halves]
                             + [h[1] for h in halves], dim=axis)
        return leaves[0]

    def walk(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: walk([n[k] for n in nodes]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(walk([n[i] for n in nodes])
                               for i in range(len(first)))
        return cat(nodes)

    return walk(list(trees))


def merge_branch_caches(cfg: ModelConfig, computed, old):
    """Fill skipped branches from the previous cache → full-structure cache
    (the eager path's collect-everything merge)."""
    out = []
    for si, st in enumerate(cfg.stages):
        stage = []
        comp_stage = computed[si] if computed is not None else None
        for bi, b in enumerate(st.unit):
            comp = (comp_stage[bi] if comp_stage is not None else None) or {}
            stage.append({name: comp[name] if comp.get(name) is not None
                          else old[si][bi][name]
                          for name in b.branch_names()})
        out.append(tuple(stage))
    return out


def empty_branch_cache(cfg: ModelConfig):
    """Structure-complete cache with no resident entries."""
    return [tuple({} for _ in st.unit) for st in cfg.stages]


def pruned_branch_caches(cfg: ModelConfig, computed, old, collect, live):
    """Build a post-step cache holding only branches of ``live`` types:
    fresh outputs for ``collect`` types, passed-through entries otherwise."""
    collect = set(collect)
    live = set(live)
    out = []
    for si, st in enumerate(cfg.stages):
        comp_stage = computed[si] if computed is not None else None
        stage = []
        for bi, b in enumerate(st.unit):
            comp = (comp_stage[bi] or {}) if comp_stage is not None else {}
            d = {}
            for name, t in zip(b.branch_names(), b.branch_types()):
                if t not in live:
                    continue
                d[name] = comp[name] if t in collect else old[si][bi][name]
            stage.append(d)
        out.append(tuple(stage))
    return out


def prune_cache(cfg: ModelConfig, cache, live):
    """Drop every cache entry whose type is not in ``live`` (segment
    boundaries)."""
    live = set(live)
    out = []
    for si, st in enumerate(cfg.stages):
        stage = []
        for bi, b in enumerate(st.unit):
            types = dict(zip(b.branch_names(), b.branch_types()))
            stage.append({n: v for n, v in cache[si][bi].items()
                          if types[n] in live})
        out.append(tuple(stage))
    return out


def cache_entry_names(cfg: ModelConfig, types) -> List[tuple]:
    """(stage, block, branch_name) triples a cache restricted to ``types``
    must contain — the liveness invariant checked by the segmented loop."""
    ts = set(types)
    out = []
    for si, st in enumerate(cfg.stages):
        for bi, b in enumerate(st.unit):
            for name, t in zip(b.branch_names(), b.branch_types()):
                if t in ts:
                    out.append((si, bi, name))
    return out


@dataclasses.dataclass
class RunState:
    """In-flight state of one segmented sampling run.

    ``start_run`` creates it, ``advance_run`` consumes one plan segment per
    call (``sample_with_plan`` *is* start + advance-until-done, so a run
    driven incrementally produces bitwise the same latents)."""
    x: Any                                   # latent (B, H, W, C)
    cache: Any                               # branch cache (exactly live)
    plan: plan_lib.ExecutionPlan
    run_index: int                           # next plan.runs entry
    label: Any = None
    #: (B,) bool tensor on the run's device — per-sample numerical health,
    #: updated every step without a host sync; read it at boundaries
    healthy: Any = None

    @property
    def done(self) -> bool:
        return self.run_index >= len(self.plan.runs)

    @property
    def step(self) -> int:
        """Next sampling step to execute (== num_steps when done)."""
        if self.done:
            return self.plan.num_steps
        return self.plan.runs[self.run_index].start

    @property
    def num_steps(self) -> int:
        return self.plan.num_steps

    #: adaptive runs record realized skip sets; static runs have none
    decisions = None


@dataclasses.dataclass
class AdaptiveRunState:
    """In-flight state of one host-dispatched input-adaptive run (one step
    per ``advance_adaptive_run``: decision, model call, solver step).  The
    accumulator/lag decision state lives on the run's device (float32 /
    int32 over ``pool_types``); only the realized skip *bits* cross to the
    host — one small device→host sync per τ > 0 step."""
    x: Any
    cache: Any
    step: int                                # next step to execute
    x_prev: Any                              # model input of previous step
    acc: Any                                 # (B, T) f32 per-row est. error
    lag: Any                                 # (B, T) i32 per-row cache age
    decisions: Tuple[tuple, ...]             # realized per-step skip sets
    schedule: Any
    tau: float
    by_skipset: Dict[frozenset, plan_lib.ProgramSig]
    pool_types: Tuple[str, ...]              # acc/lag/coeff column order
    coeff_a: Any                             # (T,) f32 proxy-map slopes
    coeff_b: Any                             # (T,) f32 proxy-map intercepts
    k_max: int
    label: Any = None
    #: (B,) bool tensor — per-sample numerical health, folding in the
    #: decision accumulator's per-row finiteness; never read per step
    healthy: Any = None

    @property
    def done(self) -> bool:
        return self.step >= self.schedule.num_steps

    @property
    def num_steps(self) -> int:
        return self.schedule.num_steps


@dataclasses.dataclass
class FusedAdaptiveRunState:
    """In-flight state of one *fused* adaptive run: everything the decision
    rule touches — latent, previous model input, branch cache (the pool's
    uniform structure), accumulator/lag, per-step decision trace — is a
    tensor on the run's device, and ``advance_adaptive_fused(n_steps)``
    runs a chunk of steps with **no** host read.  ``decisions`` reads the
    trace on the host — call it after the run (or a chunk), never per
    step."""
    x: Any
    x_prev: Any                              # model input of previous step
    cache: Any                               # pool-uniform structure
    acc: Any                                 # (B, T) f32 per-row est. error
    lag: Any                                 # (B, T) i32 per-row cache age
    trace: Any                               # (S, B, T) bool per-row desires
    step: int                                # next step to execute
    schedule: Any
    tau: float
    k_max: int
    table: plan_lib.SwitchTable
    runtime: bool                            # tau > 0: on-device rule
    skip_table: Any                          # (S, T) bool static decisions
    coeff_a: Any                             # (T,) float32
    coeff_b: Any                             # (T,) float32
    label: Any = None
    #: (B,) bool tensor — per-sample health, folded inside the step (the
    #: accumulator's finiteness included), read only at boundaries
    healthy: Any = None
    #: (S, B) float32 tensor of per-row proxy signals, or None — step
    #: telemetry (``start_adaptive_fused_run(telemetry=True)``): written
    #: by the fused step like ``trace``, read only at the boundaries the
    #: host already reads, so it keeps ``host_sync_count`` at 0.  Step 0's
    #: value is meaningless (``x_prev`` is zeros before the first step);
    #: report layers mask it
    proxy_trace: Any = None

    @property
    def done(self) -> bool:
        return self.step >= self.schedule.num_steps

    @property
    def num_steps(self) -> int:
        return self.schedule.num_steps

    @property
    def pool_types(self) -> Tuple[str, ...]:
        return self.table.types

    @property
    def decisions(self) -> Tuple[tuple, ...]:
        """Realized per-step skip sets of the executed steps — the AND
        over the trace's per-row desired bits, i.e. the masks the batch
        ran.  One device→host read of the bool trace, not a per-step
        sync."""
        bits = self.trace[:self.step].cpu().numpy().all(axis=1)
        return tuple(plan_lib.mask_signature(self.table.types, row)
                     for row in bits)

    def row_signatures(self) -> Optional[Tuple[tuple, ...]]:
        """Per-row desired skip sets at the last executed step — the
        signature a serving engine regroups by at chunk boundaries.  One
        small device→host read of a single trace row; None before any
        step."""
        if self.step == 0:
            return None
        return tuple(plan_lib.mask_signature(self.table.types, row)
                     for row in self.trace[self.step - 1].cpu().tolist())


class SmoothCacheExecutor:
    """Owns the plan memo and the sampling loops for one model config,
    solver and guidance scale, on one device (``cuda`` unless
    ``device="cpu"`` is passed)."""

    def __init__(self, cfg: ModelConfig, solver: Solver, *,
                 cfg_scale: Optional[float] = None, device=None):
        if cfg.task != "diffusion":
            raise ValueError(f"{cfg.name} is not a diffusion config")
        self.cfg = cfg
        self.solver = solver
        self.cfg_scale = cfg_scale
        self.device = resolve_device(device)
        self._plans = {}
        self._variants = set()
        self._model_times = StepTable(solver.model_times.numpy()[None])
        self._fused: Dict[tuple, fused.FusedGraph] = {}
        self._capture = None
        #: per-step device→host decision syncs of the host-dispatched
        #: adaptive loop (one per τ > 0 step); the fused path never
        #: increments it
        self.host_sync_count: int = 0

    @property
    def supports_fused_adaptive(self) -> bool:
        """Whether :meth:`sample_adaptive_fused` is available: the solver
        step must take a device step index (``solver.scannable``).  A fact
        about the solver — on a CUDA device without graph conditional
        nodes the fused path raises, it is not rerouted."""
        return self.solver.scannable

    @property
    def supports_split(self) -> bool:
        """Whether run states are divisible values (:meth:`split_run` /
        :meth:`merge_runs`): needs a deterministic solver, whose rows do
        not depend on the batch they ride in."""
        return not self.solver.stochastic

    def prepare_params(self, params) -> int:
        """Make the linear kernel's prepared weights for ``params`` up front
        (``diffusion.prepare_linear``; a no-op on the CPU).  Returns the
        bytes they hold."""
        return diffusion.prepare_linear(params)

    # -- instrumentation -----------------------------------------------------

    def _dispatch(self, kind: str, signature, batch: int) -> None:
        self._variants.add((kind, signature, batch))

    def fn_keys(self, kind: Optional[str] = None):
        """Distinct ``(kind, signature, batch)`` model-call variants
        dispatched so far (all kinds, or one)."""
        return [k for k in self._variants if kind is None or k[0] == kind]

    def compiled_variant_count(self, kind: Optional[str] = None) -> int:
        """Number of distinct model-call variants dispatched — the shapes
        a compiled version would build one program each for."""
        return len(self.fn_keys(kind))

    # -- plan resolution -----------------------------------------------------

    def plan_for(self, schedule) -> plan_lib.ExecutionPlan:
        """Memoized liveness/segmentation analysis of a schedule."""
        ck = schedule.content_key()
        if ck not in self._plans:
            self._plans[ck] = plan_lib.analyze(schedule)
        return self._plans[ck]

    # -- model step ---------------------------------------------------------

    def _model_call(self, params, x, t, label, branch_caches, *, skip,
                    collect):
        """One denoiser evaluation (CFG-doubled when configured).

        ``collect`` is ``True`` (eager/calibration: keep every branch), a
        collection of layer types (segmented: keep only live branches) or
        falsy (keep none)."""
        if self.cfg_scale is not None:
            x2 = torch.cat([x, x], dim=0)
            t2 = torch.cat([t, t], dim=0)
            lab2 = None
            if label is not None:
                null = torch.full_like(label, self.cfg.num_classes)
                lab2 = torch.cat([label, null], dim=0)
            pred, aux = diffusion.apply(
                self.cfg, params, x2, t2, label=lab2, skip=skip,
                branch_caches=branch_caches, collect_branches=collect)
            c, u = torch.chunk(pred, 2, dim=0)
            out = u + self.cfg_scale * (c - u)
        else:
            out, aux = diffusion.apply(
                self.cfg, params, x, t, label=label, skip=skip,
                branch_caches=branch_caches, collect_branches=collect)
        return out, aux["branch"]

    def _times(self, s, batch: int):
        """The model times of step ``s`` (an int, or the device step
        counter of a captured graph) as a (batch,) tensor on the device."""
        return self._model_times.at(s, self.device)[0].expand(batch)

    # -- sampling loops ------------------------------------------------------

    def latent_batch_shape(self, batch):
        return (batch,) + tuple(self.cfg.latent_shape)

    def initial_latent(self, generator: torch.Generator, batch: int):
        """The noise-init convention shared by every sampling path: a
        standard normal latent drawn on the CPU from ``generator`` (so a
        seed gives the same noise on every device), moved to the device."""
        x = torch.randn(self.latent_batch_shape(batch), generator=generator,
                        dtype=torch.float32)
        return x.to(self.device)

    def initial_latent_rows(self, generators, batch: Optional[int] = None):
        """Per-row noise init: row ``i`` is exactly the batch-1
        :meth:`initial_latent` draw of ``generators[i]``, so ANY grouping
        of the rows — one big batch, singletons, any split/merge in
        between — samples each row as its own solo run does (the
        continuous-batching determinism contract, bitwise).  Stochastic
        solvers are refused: their noise depends on the batch shape."""
        generators = list(generators)
        if batch is not None and int(batch) != len(generators):
            raise ValueError(f"row_keys has {len(generators)} entries for "
                             f"batch {batch}")
        if not generators:
            raise ValueError("row_keys must be non-empty")
        if self.solver.stochastic:
            raise ValueError(
                f"solver {self.solver.name!r} is stochastic: its noise "
                "depends on the batch shape, so per-row generators cannot "
                "make rows batch-invariant — use a single batch generator")
        return torch.cat([self.initial_latent(g, 1) for g in generators])

    def _initial(self, generator, batch, row_keys):
        if row_keys is not None:
            return self.initial_latent_rows(row_keys, batch)
        return self.initial_latent(generator, batch)

    def sample(self, params, generator, batch: int, *, schedule=None,
               label=None, collect_hook: Optional[Callable] = None,
               return_trajectory: bool = False):
        """Eager reference sampler.  ``schedule=None`` → no caching.
        ``collect_hook(s, branch_tree)`` sees every branch output of step
        ``s`` (forces the collecting path)."""
        s_total = self.solver.num_steps
        if schedule is None:
            schedule = schedule_lib.no_cache(self.cfg.layer_types(), s_total)
        if schedule.num_steps != s_total:
            raise ValueError(f"schedule has {schedule.num_steps} steps, "
                             f"solver {s_total}")
        x = self.initial_latent(generator, batch)
        caching = (collect_hook is not None
                   or any(v.any() for v in schedule.skip.values()))
        cache = None
        traj = []
        for s in range(s_total):
            t = self._times(s, batch)
            mask_key = schedule.mask_key_at(s) if caching else None
            self._dispatch("eager", (mask_key, cache is not None), batch)
            if caching:
                skip = dict(mask_key)
                pred, computed = self._model_call(
                    params, x, t, label, cache, skip=skip, collect=True)
                cache = (computed if cache is None
                         else merge_branch_caches(self.cfg, computed, cache))
                if collect_hook is not None:
                    collect_hook(s, cache)
            else:
                pred, _ = self._model_call(params, x, t, label, None,
                                           skip=None, collect=False)
            x = self.solver.step(x, pred, s)
            if return_trajectory:
                traj.append(x)
        return (x, traj) if return_trajectory else x

    def start_run(self, params, generator, batch: int, *,
                  plan: plan_lib.ExecutionPlan, schedule=None,
                  label=None, row_keys=None) -> RunState:
        """Begin a resumable segmented run: validate the plan, draw the
        initial latent, and return a :class:`RunState` positioned before
        the first segment.  Drive it with :meth:`advance_run`.
        ``row_keys`` (one generator per row, replaces ``generator``) draws
        each row via :meth:`initial_latent_rows`, so the run can be split
        and merged bitwise per row."""
        if plan.num_steps != self.solver.num_steps:
            raise ValueError(f"plan has {plan.num_steps} steps, solver "
                             f"{self.solver.num_steps}")
        if (schedule is not None and plan.schedule_fingerprint is not None
                and plan.schedule_fingerprint
                != plan_lib.schedule_fingerprint(schedule)):
            raise ValueError("plan was analyzed from a different schedule "
                             "(fingerprint mismatch) — re-run plan_for()")
        x = self._initial(generator, batch, row_keys)
        return RunState(
            x=x, cache=empty_branch_cache(self.cfg), plan=plan, run_index=0,
            label=label,
            healthy=torch.ones(batch, dtype=torch.bool, device=self.device))

    def advance_run(self, params, rs: RunState, *,
                    check: bool = False) -> RunState:
        """Advance an in-flight run by one plan segment: run the segment's
        steps under its signature (skipped types read the cache, the
        canonical collect set writes fresh outputs), then enforce exact
        liveness at the boundary."""
        if rs.done:
            raise ValueError("run is already complete")
        run = rs.plan.runs[rs.run_index]
        sig = run.sig
        skip, collect = sig.skip, frozenset(sig.collect)
        reads = any(skip.values())
        x, cache, healthy = rs.x, rs.cache, rs.healthy
        self._dispatch("seg", sig, x.shape[0])
        for s in range(run.start, run.start + run.length):
            pred, computed = self._model_call(
                params, x, self._times(s, x.shape[0]), rs.label,
                cache if reads else None, skip=skip, collect=collect)
            cache = pruned_branch_caches(self.cfg, computed, cache, collect,
                                         sig.structure)
            x = self.solver.step(x, pred, s)
            healthy = healthy & rows_finite(x)
        cache = prune_cache(self.cfg, cache, run.live_out)
        if check:
            expect = set(cache_entry_names(self.cfg, run.live_out))
            got = {(si, bi, name)
                   for si, stage in enumerate(cache)
                   for bi, d in enumerate(stage)
                   for name in d}
            if got != expect:
                raise AssertionError(
                    f"liveness violation after steps "
                    f"[{run.start}, {run.start + run.length}): resident "
                    f"{sorted(got)} != live {sorted(expect)}")
        return dataclasses.replace(rs, x=x, cache=cache,
                                   run_index=rs.run_index + 1,
                                   healthy=healthy)

    def sample_with_plan(self, params, generator, batch: int, *,
                         plan: plan_lib.ExecutionPlan, schedule=None,
                         label=None, check: bool = False):
        """Segmented sampler: Python dispatch per *segment*.  ``check=True``
        verifies after every segment that the resident cache holds exactly
        the plan's live entries."""
        rs = self.start_run(params, generator, batch, plan=plan,
                            schedule=schedule, label=label)
        while not rs.done:
            rs = self.advance_run(params, rs, check=check)
        return rs.x

    def sample_compiled(self, params, generator, batch: int, *,
                        schedule=None, label=None, plan=None,
                        check: bool = False):
        """Segmented-plan sampler (the serving path): analyzes the schedule
        (memoized, or pass a pre-analyzed ``plan`` from a
        :class:`~repro_torch.cache.artifact.CacheArtifact`)."""
        if schedule is None:
            schedule = schedule_lib.no_cache(self.cfg.layer_types(),
                                             self.solver.num_steps)
        if plan is None:
            plan = self.plan_for(schedule)
        return self.sample_with_plan(params, generator, batch, plan=plan,
                                     schedule=schedule, label=label,
                                     check=check)

    # -- input-adaptive runtime dispatch ------------------------------------

    def sample_adaptive(self, params, generator, batch: int, *, schedule,
                        tau: float, proxy_map=None, pool=None, k_max: int = 3,
                        label=None, return_decisions: bool = False):
        """Input-adaptive sampler: per-step reuse decisions dispatched over
        the schedule's candidate pool (the mask lattice over its
        ever-skipped types).

        ``tau == 0`` follows the base ``schedule`` verbatim (bitwise
        :meth:`sample_compiled` on the same schedule).  With ``tau > 0``,
        before each model call the proxy signal (per-row relative L1
        change of the latent) is mapped through the calibrated
        ``proxy_map`` to a per-type error estimate; a type is reused while
        the error accumulated since its last compute stays under ``tau``
        and the cache age stays ≤ ``k_max`` (``calibration.batch_rule``).
        ``return_decisions=True`` also returns the realized per-step skip
        sets (tuple of sorted type tuples)."""
        rs = self.start_adaptive_run(
            params, generator, batch, schedule=schedule, tau=tau,
            proxy_map=proxy_map, pool=pool, k_max=k_max, label=label)
        while not rs.done:
            rs = self.advance_adaptive_run(params, rs)
        if return_decisions:
            return rs.x, rs.decisions
        return rs.x

    def _adaptive_setup(self, schedule, tau, proxy_map, pool, k_max):
        """Validation + pool derivation of the adaptive path.  Returns
        ``(schedule, tau, by_skipset, pool_types, coeff_a, coeff_b)`` with
        the proxy-map coefficients stacked on the device (zeros when τ = 0
        never evaluates them)."""
        s_total = self.solver.num_steps
        if schedule is None:
            schedule = schedule_lib.no_cache(self.cfg.layer_types(), s_total)
        if schedule.num_steps != s_total:
            raise ValueError(f"schedule has {schedule.num_steps} steps, "
                             f"solver {s_total}")
        tau = float(tau)
        if tau < 0:
            raise ValueError(f"tau must be >= 0, got {tau}")
        if int(k_max) < 1:
            raise ValueError(
                f"adaptive k_max must be >= 1, got {k_max} — k_max=0 "
                "would dispatch the whole candidate pool yet never reuse "
                "a cache entry (silently behaving like no_cache)")
        if tau > 0 and proxy_map is None:
            raise ValueError(
                "sample_adaptive with tau > 0 needs a calibrated proxy_map "
                "(calibrate the adaptive policy or load its artifact)")
        if pool is None:
            pool = plan_lib.mask_lattice(schedule)
        by_skipset = plan_lib.pool_index(pool)
        pool_types = tuple(sorted(frozenset().union(*by_skipset)))
        if tau > 0:
            try:
                a, b = proxy_map.stacked(pool_types)
            except KeyError as e:
                raise ValueError(f"proxy_map lacks coefficients for the "
                                 f"candidate pool — recalibrate: {e}")
        else:
            a = b = torch.zeros(len(pool_types))
        coeff_a, coeff_b = (torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device)
                            for v in (a, b))
        return schedule, tau, by_skipset, pool_types, coeff_a, coeff_b

    def start_adaptive_run(self, params, generator, batch: int, *, schedule,
                           tau: float, proxy_map=None, pool=None,
                           k_max: int = 3, label=None,
                           row_keys=None) -> AdaptiveRunState:
        """Begin a resumable host-dispatched adaptive run: validate the
        decision parameters, index the candidate pool, draw the initial
        latent (per row with ``row_keys``, see :meth:`start_run`).  Drive
        it with :meth:`advance_adaptive_run` (one step per call);
        start + advance-until-done is :meth:`sample_adaptive`."""
        schedule, tau, by_skipset, pool_types, coeff_a, coeff_b = \
            self._adaptive_setup(schedule, tau, proxy_map, pool, k_max)
        shape = (batch, len(pool_types))
        return AdaptiveRunState(
            x=self._initial(generator, batch, row_keys),
            cache=empty_branch_cache(self.cfg), step=0, x_prev=None,
            acc=torch.zeros(shape, dtype=torch.float32, device=self.device),
            lag=torch.zeros(shape, dtype=torch.int32, device=self.device),
            decisions=(), schedule=schedule, tau=tau, by_skipset=by_skipset,
            pool_types=pool_types, coeff_a=coeff_a, coeff_b=coeff_b,
            k_max=int(k_max), label=label,
            healthy=torch.ones(batch, dtype=torch.bool, device=self.device))

    def advance_adaptive_run(self, params,
                             rs: AdaptiveRunState) -> AdaptiveRunState:
        """Advance an in-flight adaptive run by one step: evaluate the
        decision rule on the device, read the realized skip bits on the
        host (the one per-step sync of this path, τ > 0 only), run the
        model under the matching pool signature and the solver step.
        Step 0 computes every type (the cache is empty); a skipped type
        reads the entry its last compute wrote."""
        if rs.done:
            raise ValueError("run is already complete")
        s, x = rs.step, rs.x
        acc, lag = rs.acc, rs.lag
        if s == 0:
            skipset = frozenset()
        elif rs.tau == 0.0:
            # the offline schedule verbatim (bitwise sample_compiled)
            skipset = frozenset(t for t, sk in rs.schedule.mask_key_at(s)
                                if sk)
        else:
            _, realized, acc, lag = calibration.batch_rule(
                calibration.rel_l1_change_rows(x, rs.x_prev), rs.acc,
                rs.lag, rs.coeff_a, rs.coeff_b,
                *calibration.rule_limits(rs.tau, rs.k_max, self.device))
            bits = realized.tolist()
            self.host_sync_count += 1       # the per-step device→host sync
            skipset = frozenset(t for t, hit in zip(rs.pool_types, bits)
                                if hit)
        sig = rs.by_skipset.get(skipset)
        if sig is None:
            raise ValueError(
                f"static schedule mask at step {s} skips "
                f"{sorted(skipset)}, absent from the candidate pool — "
                "derive the pool from this schedule via mask_lattice()")
        self._dispatch("sigstep", sig, x.shape[0])
        collect = frozenset(sig.collect)
        pred, computed = self._model_call(
            params, x, self._times(s, x.shape[0]), rs.label,
            rs.cache if skipset else None, skip=sig.skip, collect=collect)
        cache = pruned_branch_caches(self.cfg, computed, rs.cache, collect,
                                     sig.structure)
        x_next = self.solver.step(x, pred, s)
        healthy = (rs.healthy & rows_finite(x_next)
                   & torch.isfinite(acc).all(dim=-1))
        return dataclasses.replace(
            rs, x=x_next, cache=cache, step=s + 1, x_prev=x, acc=acc,
            lag=lag, healthy=healthy,
            decisions=rs.decisions + (tuple(sorted(skipset)),))

    # -- fused adaptive sampling (decision + dispatch on the device) ---------

    def _branch_structs(self, batch: int):
        """Shape of every branch-cache entry at ``batch`` rows: per stage,
        per unit block, ``{branch: (repeat, batch·{1,2}, tokens,
        d_model)}`` — the model's pre-residual branch outputs, CFG-doubled
        when guidance is on."""
        n_tok, _ = diffusion.token_shape(self.cfg)
        rows = batch * (2 if self.cfg_scale is not None else 1)
        return [tuple({name: (st.repeat, rows, n_tok, self.cfg.d_model)
                       for name in b.branch_names()} for b in st.unit)
                for st in self.cfg.stages]

    def _enter_run_cache(self, cache, sig: plan_lib.ProgramSig, structs):
        """Restructure a boundary cache into a run's loop-invariant
        structure: pass through the entries the mask reads, and add
        zero placeholders for the collect entries (the first step
        overwrites them before anything reads them)."""
        live_in, collect = set(sig.live_in), set(sig.collect)
        out = []
        for si, st in enumerate(self.cfg.stages):
            stage = []
            for bi, b in enumerate(st.unit):
                d = {}
                for name, t in zip(b.branch_names(), b.branch_types()):
                    if t in live_in:
                        d[name] = cache[si][bi][name]
                    elif t in collect:
                        d[name] = torch.zeros(structs[si][bi][name],
                                              device=self.device)
                stage.append(d)
            out.append(tuple(stage))
        return out

    def _graph_capture(self):
        """What every fused graph of this executor shares (they replay one
        after another on one stream): the memory pool, and the IF bodies'
        pool and streams."""
        if self._capture is None:
            self._capture = cuda_graphs.GraphCapture(self.device)
        return self._capture

    def fused_graphs(self) -> List[dict]:
        """One record per fused step built so far: batch, pool types,
        branches, τ > 0 or not, and on a CUDA device the warm-up and
        capture seconds and the kernel calls captured."""
        return [dict(g.stats) for g in self._fused.values()]

    def sample_adaptive_fused(self, params, generator, batch: int, *,
                              schedule, tau: float, proxy_map=None,
                              pool=None, k_max: int = 3, label=None,
                              return_decisions: bool = False):
        """Input-adaptive sampler with the decision and the dispatch on
        the device: on a CUDA device each step is one replay of a captured
        graph (proxy, ``batch_rule``, the pool's signatures in conditional
        nodes, DDIM step, trace, health), so the run makes **zero**
        per-step host syncs and builds one graph per (batch, pool) instead
        of dispatching pool-size variants.

        Decisions and latents equal :meth:`sample_adaptive`'s bitwise, and
        at ``tau=0`` the run equals :meth:`sample_compiled` on the same
        schedule bitwise.  ``return_decisions=True`` also returns the
        realized per-step skip sets, read from the trace after the run."""
        rs = self.start_adaptive_fused_run(
            params, generator, batch, schedule=schedule, tau=tau,
            proxy_map=proxy_map, pool=pool, k_max=k_max, label=label)
        rs = self.advance_adaptive_fused(params, rs)
        if return_decisions:
            return rs.x, rs.decisions
        return rs.x

    def _fused_setup(self, schedule, tau, proxy_map, pool, k_max):
        """Validation and derivation of a fused run: :meth:`_adaptive_setup`,
        the branch table, and the static ``skip_table`` (τ = 0) or its
        shape-stable dummy (τ > 0)."""
        if not self.supports_fused_adaptive:
            raise ValueError(
                f"solver {self.solver.name!r} is not scannable; the fused "
                "adaptive path needs a device-indexed solver step — use "
                "sample_adaptive (host dispatch) instead")
        schedule, tau, by_skipset, _, coeff_a, coeff_b = \
            self._adaptive_setup(schedule, tau, proxy_map, pool, k_max)
        table = plan_lib.switch_branch_table(
            pool if pool is not None else plan_lib.mask_lattice(schedule))
        runtime = tau > 0
        if runtime:
            # the rule picks subsets of the pool types; the table is unread
            skip_table = np.zeros((1, len(table.types)), bool)
        else:
            for s in range(schedule.num_steps):
                skipset = frozenset(t for t, sk in schedule.mask_key_at(s)
                                    if sk)
                if skipset not in by_skipset:
                    raise ValueError(
                        f"static schedule mask at step {s} skips "
                        f"{sorted(skipset)}, absent from the candidate "
                        "pool — derive the pool from this schedule via "
                        "mask_lattice()")
            skip_table = np.zeros((schedule.num_steps, len(table.types)),
                                  bool)
            for i, t in enumerate(table.types):
                skip_table[:, i] = np.asarray(schedule.skip[t], bool)
        return (schedule, tau, table, runtime,
                torch.as_tensor(skip_table, device=self.device),
                coeff_a, coeff_b)

    def start_adaptive_fused_run(self, params, generator, batch: int, *,
                                 schedule, tau: float, proxy_map=None,
                                 pool=None, k_max: int = 3, label=None,
                                 row_keys=None, telemetry: bool = False
                                 ) -> FusedAdaptiveRunState:
        """Begin a resumable fused adaptive run.  Drive it with
        :meth:`advance_adaptive_fused` — a serving engine timeslices with
        ``n_steps`` chunks, each a run of graph replays.  ``row_keys``
        draws per-row initial latents (see :meth:`start_run`).
        ``telemetry=True`` also records each row's proxy signal per step
        into ``rs.proxy_trace`` (computed at τ = 0 too, where the rule
        never reads it), for per-request
        :class:`repro_torch.obs.CacheReport` explainers: a graph of its
        own, still no host read, and the latents' bits unchanged."""
        schedule, tau, table, runtime, skip_table, coeff_a, coeff_b = \
            self._fused_setup(schedule, tau, proxy_map, pool, k_max)
        x = self._initial(generator, batch, row_keys)
        cache = self._enter_run_cache(empty_branch_cache(self.cfg),
                                      table.branches[0],
                                      self._branch_structs(batch))
        shape = (batch, len(table.types))
        return FusedAdaptiveRunState(
            x=x, x_prev=torch.zeros_like(x), cache=cache,
            acc=torch.zeros(shape, dtype=torch.float32, device=self.device),
            lag=torch.zeros(shape, dtype=torch.int32, device=self.device),
            trace=torch.zeros((schedule.num_steps,) + shape,
                              dtype=torch.bool, device=self.device),
            step=0, schedule=schedule, tau=tau, k_max=int(k_max),
            table=table, runtime=runtime, skip_table=skip_table,
            coeff_a=coeff_a, coeff_b=coeff_b, label=label,
            healthy=torch.ones(batch, dtype=torch.bool, device=self.device),
            proxy_trace=(torch.zeros((schedule.num_steps, batch),
                                     dtype=torch.float32, device=self.device)
                         if telemetry else None))

    def fused_step_for(self, params, rs: FusedAdaptiveRunState):
        """The fused step that runs ``rs`` (built, and on a CUDA device
        captured, on first use).  Call it before a guarded region so the
        capture happens outside it."""
        key = fused.graph_key(rs, params)
        g = self._fused.get(key)
        if g is None:
            self._dispatch("fused", key[1:5], key[0])
            g = fused.FusedGraph(self, params, rs, [
                cache_entry_names(self.cfg, sig.collect)
                for sig in rs.table.branches])
            self._fused[key] = g
        return g

    def advance_adaptive_fused(self, params, rs: FusedAdaptiveRunState,
                               n_steps: Optional[int] = None
                               ) -> FusedAdaptiveRunState:
        """Advance an in-flight fused run by ``n_steps`` sampling steps
        (default: all remaining): copy the state into the step's buffers,
        replay it ``n_steps`` times, copy the state out — device to
        device, no host read."""
        if rs.done:
            raise ValueError("run is already complete")
        remaining = rs.num_steps - rs.step
        length = remaining if n_steps is None else min(int(n_steps),
                                                       remaining)
        if length < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        out = self.fused_step_for(params, rs).run(self, rs, length)
        return dataclasses.replace(rs, step=rs.step + length, **out)

    # -- run-state split / merge (continuous batching) ------------------------

    #: per-kind fields holding per-row (or CFG-doubled) tensors, with each
    #: field's batch axis — branch caches are stacked ``(repeat,
    #: batch·{1,2}, ...)`` so their batch axis is 1; everything else in a
    #: run state is shared by its rows
    _ROW_FIELDS = {
        RunState: (("x", 0), ("cache", 1), ("label", 0), ("healthy", 0)),
        AdaptiveRunState: (("x", 0), ("cache", 1), ("label", 0),
                           ("healthy", 0), ("x_prev", 0), ("acc", 0),
                           ("lag", 0)),
        FusedAdaptiveRunState: (("x", 0), ("cache", 1), ("label", 0),
                                ("healthy", 0), ("x_prev", 0), ("acc", 0),
                                ("lag", 0)),
    }

    def _check_split(self, rs):
        if not self.supports_split:
            raise ValueError(
                f"solver {self.solver.name!r} is stochastic: run states "
                "are not divisible (its noise depends on the batch shape, "
                "so split rows would diverge from their batch)")
        fields = self._ROW_FIELDS.get(type(rs))
        if fields is None:
            raise ValueError(
                f"not a divisible run state: {type(rs).__name__}")
        return fields

    def split_run(self, rs, groups) -> List[Any]:
        """Split one in-flight run into independent sub-runs over disjoint
        row groups — row gathers only, no model compute, bitwise per row:
        each sub-run advances exactly as its rows would have in the
        original batch.  τ > 0 adaptive sub-runs carry their per-row
        acc/lag with them and realize their OWN mask AND from the split
        on — what a boundary regroup exploits.  Rows in no group are
        dropped.  Landing on existing bucket shapes is the caller's job."""
        fields = self._check_split(rs)
        batch = int(rs.x.shape[0])
        groups = [tuple(int(i) for i in g) for g in groups]
        if not groups:
            raise ValueError("split_run needs at least one row group")
        seen = set()
        for g in groups:
            if not g:
                raise ValueError("split groups must be non-empty")
            for i in g:
                if not 0 <= i < batch:
                    raise ValueError(
                        f"row index {i} out of range for batch {batch}")
                if i in seen:
                    raise ValueError(f"row index {i} appears in two groups")
                seen.add(i)
        out = []
        for g in groups:
            upd = {f: _take_rows(getattr(rs, f), g, batch, axis=ax)
                   for f, ax in fields}
            if isinstance(rs, FusedAdaptiveRunState):
                upd["trace"] = _take_rows(rs.trace, g, batch, axis=1)
                if rs.proxy_trace is not None:
                    upd["proxy_trace"] = _take_rows(rs.proxy_trace, g,
                                                    batch, axis=1)
            out.append(dataclasses.replace(rs, **upd))
        return out

    def merge_runs(self, runs) -> Any:
        """Merge position-aligned sub-runs into one batch — the concat
        dual of :meth:`split_run`, bitwise per row.  Runs must be of one
        kind at one position with the same execution parameters (same
        plan and segment, or same schedule/τ/k_max/pool and step); per-row
        tensors concatenate, shared parameters come from the first run.
        From the merge on, τ > 0 decisions realize the AND over the
        union's rows; each row's acc/lag rows merge untouched."""
        runs = list(runs)
        if not runs:
            raise ValueError("merge_runs needs at least one run")
        r0 = runs[0]
        fields = self._check_split(r0)
        if len(runs) == 1:
            return r0
        if any(type(r) is not type(r0) for r in runs[1:]):
            raise ValueError("cannot merge runs of different kinds")
        batches = [int(r.x.shape[0]) for r in runs]
        if isinstance(r0, RunState):
            for r in runs[1:]:
                if r.plan is not r0.plan and r.plan != r0.plan:
                    raise ValueError(
                        "cannot merge runs with different plans")
                if r.run_index != r0.run_index:
                    raise ValueError(
                        "cannot merge runs at different segments")
        else:
            for r in runs[1:]:
                if (r.schedule.content_key() != r0.schedule.content_key()
                        or r.tau != r0.tau or r.k_max != r0.k_max):
                    raise ValueError(
                        "cannot merge adaptive runs with different "
                        "schedule/tau/k_max")
                if r.step != r0.step:
                    raise ValueError(
                        "cannot merge adaptive runs at different steps")
                if r.pool_types != r0.pool_types:
                    raise ValueError(
                        "cannot merge runs over different pools")
        upd = {f: _concat_rows([getattr(r, f) for r in runs], batches,
                               axis=ax)
               for f, ax in fields}
        if isinstance(r0, AdaptiveRunState):
            # split siblings share one realized history; a join brings
            # another — drop to "no per-step record" rather than claim one
            # side's history for every row
            if any(r.decisions != r0.decisions for r in runs[1:]):
                upd["decisions"] = ()
        elif isinstance(r0, FusedAdaptiveRunState):
            # per-row desired traces concat exactly; ``decisions`` (the
            # AND over rows) becomes conservative for pre-merge steps
            upd["trace"] = torch.cat([r.trace for r in runs], dim=1)
            if all(r.proxy_trace is not None for r in runs):
                upd["proxy_trace"] = torch.cat([r.proxy_trace for r in runs],
                                               dim=1)
            elif any(r.proxy_trace is not None for r in runs):
                # mixed telemetry: no honest merged trace exists
                upd["proxy_trace"] = None
        return dataclasses.replace(r0, **upd)

    # -- run-state snapshot seams (durable serving) ---------------------------

    @property
    def supports_export(self) -> bool:
        """Whether run states can cross a process boundary via
        :meth:`export_run` / :meth:`import_run` — true for all three run
        kinds of this executor (the durable layer checks the attribute so
        test fakes opt in explicitly)."""
        return True

    def export_run(self, rs) -> Tuple[str, Dict, Dict]:
        """Run state → ``(kind, arrays, static)``, the snapshot seam of
        the durable serving layer.  ``arrays`` is a tree of the run's
        tensors, on its device (:mod:`repro_torch.checkpoint.io` copies
        them to the host); ``static`` is the small JSON-safe
        position/parameter stamp needed to rebuild the rest.  Derived
        objects — plan, schedule, pool index, branch table, proxy-map
        coefficients — are deliberately NOT exported: :meth:`import_run`
        rebuilds them from the serving entry, and the caller's provenance
        stamp (entry name/version, schedule fingerprint, plan hash) is
        what guarantees it rebuilds the *same* ones.  Reading the arrays
        is a boundary transfer the host was already allowed to make —
        never a per-step sync, so ``host_sync_count`` stays untouched."""
        if not isinstance(rs, (RunState, AdaptiveRunState,
                               FusedAdaptiveRunState)):
            raise ValueError(
                f"not an exportable run state: {type(rs).__name__}")
        arrays = {"x": rs.x, "cache": rs.cache, "label": rs.label,
                  "healthy": rs.healthy}
        if isinstance(rs, RunState):
            return "plan", arrays, {"batch": int(rs.x.shape[0]),
                                    "run_index": int(rs.run_index)}
        arrays.update(x_prev=rs.x_prev, acc=rs.acc, lag=rs.lag)
        static = {"batch": int(rs.x.shape[0]), "step": int(rs.step),
                  "tau": float(rs.tau), "k_max": int(rs.k_max)}
        if isinstance(rs, AdaptiveRunState):
            static["decisions"] = [list(d) for d in rs.decisions]
            return "adaptive", arrays, static
        arrays.update(trace=rs.trace, proxy_trace=rs.proxy_trace)
        return "adaptive_fused", arrays, static

    def import_run(self, params, kind: str, arrays: Dict, static: Dict, *,
                   plan=None, schedule=None, tau: float = 0.0,
                   proxy_map=None, pool=None, k_max: int = 3):
        """``(kind, arrays, static)`` → run state on this executor's
        device, the inverse of :meth:`export_run`.  The entry-side
        parameters (``plan`` / ``schedule`` / ``tau`` / ``proxy_map`` /
        ``pool`` / ``k_max``) come from the serving entry the run launched
        under; every derived structure is rebuilt exactly as the matching
        ``start_*`` builds it, and every tensor lands on the device with
        its saved dtype, so advancing the restored state is bitwise
        advancing the original (a fused run keeps its ``graph_key``: it
        replays the graph this executor already holds, or captures one).
        Disagreements between the snapshot stamp and the entry are refused
        (``ValueError``), not absorbed — the caller quarantines and
        replays from the start.  ``params`` is unused (the run states hold
        no parameter-derived tensors); the seam keeps the JAX package's
        signature."""
        del params
        on_dev = functools.partial(_map_leaves, lambda a: (
            a.to(self.device) if isinstance(a, torch.Tensor) else a))
        arrays = {k: on_dev(v) for k, v in arrays.items()}
        common = dict(x=arrays["x"], cache=arrays["cache"],
                      label=arrays.get("label"),
                      healthy=arrays.get("healthy"))
        if kind == "plan":
            if plan is None:
                raise ValueError(
                    "import_run kind='plan' needs the plan= the run was "
                    "launched with")
            run_index = int(static["run_index"])
            if not 0 <= run_index <= len(plan.runs):
                raise ValueError(
                    f"snapshot run_index {run_index} out of range for a "
                    f"{len(plan.runs)}-segment plan — wrong plan?")
            return RunState(plan=plan, run_index=run_index, **common)
        if kind not in ("adaptive", "adaptive_fused"):
            raise ValueError(f"unknown run kind {kind!r}")
        # defense in depth: the stamp's decision parameters must equal the
        # entry's — a drifted τ/k_max would silently change every decision
        # from the restore point on
        if float(static.get("tau", tau)) != float(tau) \
                or int(static.get("k_max", k_max)) != int(k_max):
            raise ValueError(
                f"snapshot tau/k_max ({static.get('tau')}/"
                f"{static.get('k_max')}) disagree with the serving entry "
                f"({float(tau)}/{int(k_max)})")
        step = int(static["step"])
        common.update(x_prev=arrays.get("x_prev"), acc=arrays["acc"],
                      lag=arrays["lag"], step=step, k_max=int(k_max))
        if kind == "adaptive":
            schedule, tau, by_skipset, pool_types, coeff_a, coeff_b = \
                self._adaptive_setup(schedule, tau, proxy_map, pool, k_max)
            _check_step(step, schedule)
            return AdaptiveRunState(
                decisions=tuple(tuple(d)
                                for d in static.get("decisions", ())),
                schedule=schedule, tau=tau, by_skipset=by_skipset,
                pool_types=pool_types, coeff_a=coeff_a, coeff_b=coeff_b,
                **common)
        schedule, tau, table, runtime, skip_table, coeff_a, coeff_b = \
            self._fused_setup(schedule, tau, proxy_map, pool, k_max)
        _check_step(step, schedule)
        return FusedAdaptiveRunState(
            trace=arrays["trace"], schedule=schedule, tau=tau, table=table,
            runtime=runtime, skip_table=skip_table, coeff_a=coeff_a,
            coeff_b=coeff_b, proxy_trace=arrays.get("proxy_trace"),
            **common)


def _check_step(step: int, schedule) -> None:
    if not 0 <= step <= schedule.num_steps:
        raise ValueError(
            f"snapshot step {step} out of range for the schedule's "
            f"{schedule.num_steps} steps — wrong schedule?")
