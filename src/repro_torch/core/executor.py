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

The adaptive path, ``sample_adaptive`` (``start_adaptive_run`` /
``advance_adaptive_run``), is the host-dispatched loop: each step evaluates
the reuse rule on the device, reads the realized skip bits on the host
(one device→host sync per τ > 0 step, counted in ``host_sync_count``) and
runs the matching pool signature.

Eager PyTorch compiles nothing, so where the JAX package counts compiled
programs the executor records every distinct model-call *variant* it
dispatches, as ``(kind, signature, batch)`` with kinds ``"seg"``,
``"sigstep"`` and ``"eager"`` (``fn_keys``, ``compiled_variant_count``):
the shapes a compiled version would specialize on, which the serving
program budget bounds.

Classifier-free guidance doubles the batch ([cond; uncond]) exactly as in
the paper's DiT-XL protocol; the cache covers both halves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core import calibration
from repro_torch.core import diffusion, plan as plan_lib, schedule as schedule_lib
from repro_torch.core.solvers import Solver


def _rows_finite(x):
    """Per-sample ``isfinite`` reduction of a latent batch: ``(B,)`` bool,
    True where row ``i`` contains no NaN/Inf."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


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
        #: per-step device→host decision syncs of the host-dispatched
        #: adaptive loop (one per τ > 0 step)
        self.host_sync_count: int = 0

    #: no on-device adaptive program and no run-state split/merge yet:
    #: a serving engine takes the host loop and refuses continuous batching
    supports_fused_adaptive = False
    supports_split = False

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

    def _times(self, s: int, batch: int):
        return self.solver.model_times[s].expand(batch).to(self.device)

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
                  label=None) -> RunState:
        """Begin a resumable segmented run: validate the plan, draw the
        initial latent, and return a :class:`RunState` positioned before
        the first segment.  Drive it with :meth:`advance_run`."""
        if plan.num_steps != self.solver.num_steps:
            raise ValueError(f"plan has {plan.num_steps} steps, solver "
                             f"{self.solver.num_steps}")
        if (schedule is not None and plan.schedule_fingerprint is not None
                and plan.schedule_fingerprint
                != plan_lib.schedule_fingerprint(schedule)):
            raise ValueError("plan was analyzed from a different schedule "
                             "(fingerprint mismatch) — re-run plan_for()")
        x = self.initial_latent(generator, batch)
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
            healthy = healthy & _rows_finite(x)
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
                           k_max: int = 3, label=None) -> AdaptiveRunState:
        """Begin a resumable host-dispatched adaptive run: validate the
        decision parameters, index the candidate pool, draw the initial
        latent.  Drive it with :meth:`advance_adaptive_run` (one step per
        call); start + advance-until-done is :meth:`sample_adaptive`."""
        schedule, tau, by_skipset, pool_types, coeff_a, coeff_b = \
            self._adaptive_setup(schedule, tau, proxy_map, pool, k_max)
        shape = (batch, len(pool_types))
        return AdaptiveRunState(
            x=self.initial_latent(generator, batch),
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
                rs.lag, rs.coeff_a, rs.coeff_b, rs.tau, rs.k_max)
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
        healthy = (rs.healthy & _rows_finite(x_next)
                   & torch.isfinite(acc).all(dim=-1))
        return dataclasses.replace(
            rs, x=x_next, cache=cache, step=s + 1, x_prev=x, acc=acc,
            lag=lag, healthy=healthy,
            decisions=rs.decisions + (tuple(sorted(skipset)),))
