"""`DiffusionPipeline` — the one-object facade over calibrate → schedule →
execute::

    pipe = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                             cfg_scale=1.5)
    art = pipe.calibrate(params, gen, batch=10, cond_args={"label": labels})
    # a text-to-video model: cond_args={"memory": m}, generate(memory=m)
    pipe.save_artifact("dit_xl_ddim50.cache.json")
    ...
    serve = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                              cfg_scale=1.5)
    serve.load_artifact("dit_xl_ddim50.cache.json", strict=True)
    x = serve.generate(params, gen2, batch, label=labels)

The calibration result is a serializable :class:`CacheArtifact`, so a
serving process loads it and never recalibrates.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from repro_torch.cache import registry
from repro_torch.cache.artifact import CacheArtifact
from repro_torch.cache.policy import AdaptivePolicy, CachePolicy
from repro_torch.core import calibration as calibration_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import solvers as solvers_lib
from repro_torch.core.executor import SmoothCacheExecutor
from repro_torch.core.schedule import Schedule

_UNSET = object()


class DiffusionPipeline:
    """Owns an executor + a :class:`CachePolicy` + (optionally) a resolved
    :class:`CacheArtifact`, and exposes calibrate/generate.  Runs on
    ``cuda`` unless ``device="cpu"`` is passed; ``graphs=False`` runs the
    segmented path's step uncaptured instead of step-graph replays (the
    JAX package's ``jit=False``)."""

    def __init__(self, cfg, solver, policy: Union[str, dict, CachePolicy]
                 = "none", *, cfg_scale: Optional[float] = None,
                 device=None, graphs: bool = True):
        if isinstance(solver, str):
            raise TypeError(
                f"solver must be a Solver object, e.g. "
                f"solvers.{solver}(num_steps); got the string {solver!r}")
        self.policy = registry.get(policy)
        self.executor = SmoothCacheExecutor(cfg, solver, cfg_scale=cfg_scale,
                                            device=device, graphs=graphs)
        self.artifact: Optional[CacheArtifact] = None
        self.per_sample: Optional[Dict[str, np.ndarray]] = None
        self._schedule: Optional[Schedule] = None
        self._plan: Optional[plan_lib.ExecutionPlan] = None
        self._proxy_map: Optional[calibration_lib.ProxyMap] = None

    # -- introspection -------------------------------------------------------

    @property
    def cfg(self):
        return self.executor.cfg

    @property
    def solver(self) -> solvers_lib.Solver:
        return self.executor.solver

    @property
    def schedule(self) -> Optional[Schedule]:
        """The resolved schedule, if calibration/preparation has run."""
        return self._schedule

    @property
    def plan(self) -> Optional[plan_lib.ExecutionPlan]:
        """Segmentation/liveness analysis of the resolved schedule (loaded
        from the artifact when serving, derived once otherwise)."""
        if self._plan is None and self._schedule is not None:
            self._plan = self.executor.plan_for(self._schedule)
        return self._plan

    @property
    def proxy_map(self) -> Optional[calibration_lib.ProxyMap]:
        return self._proxy_map

    def summary(self) -> str:
        head = (f"DiffusionPipeline({self.cfg.name}, {self.solver.name}"
                f"x{self.solver.num_steps}, policy={self.policy.spec()})")
        if self._schedule is not None:
            return head + "\n" + self._schedule.summary()
        return head

    # -- calibration ---------------------------------------------------------

    def calibrate(self, params, generator, batch: int = 8, *,
                  cond_args: Optional[Dict] = None,
                  k_max: Optional[int] = None) -> CacheArtifact:
        """Run one uncached calibration pass (paper uses 10 samples), resolve
        the policy's schedule, and return a serializable artifact.  Also
        stores per-sample curves on ``self.per_sample``."""
        k = k_max if k_max is not None else max(self.policy.k_max, 1)
        rec = calibration_lib.calibrate_record(
            self.executor, params, generator, batch, cond_args=cond_args,
            k_max=k)
        curves = rec.curves
        self.per_sample = rec.per_sample
        sch = self.policy.build(self.cfg.layer_types(),
                                self.solver.num_steps,
                                curves if self.policy.requires_calibration
                                else None)
        self._plan = self.executor.plan_for(sch)
        adaptive = None
        if isinstance(self.policy, AdaptivePolicy):
            self._proxy_map = rec.proxy_map
            pool = plan_lib.mask_lattice(sch)
            pool_types = sorted({t for sig in pool for t in sig.live_in})
            coeff_a, coeff_b = rec.proxy_map.stacked(pool_types)
            adaptive = {
                "tau": self.policy.tau,
                "k_max": self.policy.k_max,
                "proxy_map": rec.proxy_map.to_jsonable(),
                "proxy_map_stacked": {
                    "types": pool_types,
                    "a": [float(v) for v in coeff_a],
                    "b": [float(v) for v in coeff_b],
                },
                "pool": [list(sig.live_in) for sig in pool],
            }
        self.artifact = CacheArtifact(
            arch=self.cfg.name, solver=self.solver.name,
            num_steps=self.solver.num_steps,
            policy=self.policy.to_config(), curves=curves, schedule=sch,
            plan=self._plan.to_jsonable(), adaptive=adaptive,
            meta={"calib_batch": batch, "k_max": k,
                  "cfg_scale": self.executor.cfg_scale,
                  # under CFG only the conditioned half of the doubled
                  # [cond; uncond] batch enters the curves
                  "calib_cfg_half": "cond" if rec.cfg_halved else None})
        self._schedule = sch
        return self.artifact

    def prepare(self, params=None, generator=None, *, calib_batch: int = 8,
                cond_args: Optional[Dict] = None) -> Schedule:
        """Resolve the schedule without building an artifact — calibrates
        only if the policy needs curves and no artifact is loaded."""
        if self._schedule is not None:
            return self._schedule
        if self.policy.requires_calibration and self.artifact is None:
            if params is None or generator is None:
                raise ValueError(
                    f"policy {self.policy.spec()!r} needs calibration; pass "
                    "(params, generator) to prepare() or load_artifact() "
                    "first")
            self.calibrate(params, generator, calib_batch,
                           cond_args=cond_args)
            return self._schedule
        curves = self.artifact.curves if self.artifact is not None else None
        self._schedule = self.policy.prepare(self.executor, curves=curves)
        self._plan = None                     # re-derived lazily via .plan
        return self._schedule

    def schedule_for(self, policy: Union[str, dict, CachePolicy]) -> Schedule:
        """Resolve *another* policy against this pipeline's calibration
        curves (many α / budgets, one calibration)."""
        p = registry.get(policy)
        curves = self.artifact.curves if self.artifact is not None else None
        return p.prepare(self.executor, curves=curves)

    # -- artifact round-trip -------------------------------------------------

    def save_artifact(self, path: str) -> str:
        if self.artifact is None:
            raise ValueError("no artifact: run calibrate() first")
        return self.artifact.save(path)

    def load_artifact(self, path_or_artifact: Union[str, CacheArtifact],
                      *, strict: bool = True) -> CacheArtifact:
        """Adopt a saved artifact: serving skips calibration entirely.  The
        stored schedule is used verbatim when present; otherwise it is
        re-resolved from the stored curves with this pipeline's policy."""
        art = (path_or_artifact if isinstance(path_or_artifact, CacheArtifact)
               else CacheArtifact.load(path_or_artifact))
        if strict:
            art.validate_for(
                arch=self.cfg.name, solver=self.solver.name,
                num_steps=self.solver.num_steps,
                cfg_scale=self.executor.cfg_scale,
                policy=self.policy if isinstance(self.policy, AdaptivePolicy)
                else None)
        self.artifact = art
        if art.adaptive and art.adaptive.get("proxy_map"):
            self._proxy_map = calibration_lib.ProxyMap.from_jsonable(
                art.adaptive["proxy_map"])
        self._schedule = (art.schedule if art.schedule is not None
                          else art.resolve(self.policy))
        # serving reloads the pre-analyzed plan instead of re-deriving it
        self._plan = (art.execution_plan() if art.schedule is not None
                      else plan_lib.analyze(self._schedule))
        return art

    # -- generation ----------------------------------------------------------

    def generate(self, params, generator, batch: int, *, label=None,
                 memory=None, schedule=_UNSET, compiled: bool = True,
                 return_decisions: bool = False):
        """Sample a batch under the pipeline's schedule.  ``schedule=`` (a
        Schedule, a policy spec, or None for the uncached baseline)
        overrides per call; ``compiled=True`` takes the segmented-plan
        path (reusing the pipeline's pre-analyzed plan), ``False`` the
        eager reference path.  ``memory`` (B, Lm, cond_dim) is a
        text-conditioned model's cross-attention memory.

        Adaptive policies run the executor's fused path
        (``sample_adaptive_fused``: decision and dispatch on the device, no
        per-step host read) when ``supports_fused_adaptive``, else the
        host-dispatched ``sample_adaptive`` loop — both make the same
        decisions bitwise; ``return_decisions=True`` also returns the
        realized per-step skip sets.  An explicit ``schedule=`` override,
        or ``compiled=False``, takes the static paths."""
        if schedule is _UNSET:
            sch = self._schedule
            if sch is None and self.policy.requires_calibration:
                raise ValueError(
                    f"policy {self.policy.spec()!r} needs calibration — run "
                    "calibrate()/load_artifact() before generate()")
            if sch is None:
                sch = self.policy.build(self.cfg.layer_types(),
                                        self.solver.num_steps)
                self._schedule = sch
            if isinstance(self.policy, AdaptivePolicy) and compiled:
                if self.policy.tau > 0 and self._proxy_map is None:
                    raise ValueError(
                        f"policy {self.policy.spec()!r} needs a calibrated "
                        "proxy map — run calibrate()/load_artifact() before "
                        "generate()")
                sampler = (self.executor.sample_adaptive_fused
                           if self.executor.supports_fused_adaptive
                           else self.executor.sample_adaptive)
                return sampler(
                    params, generator, batch, schedule=sch,
                    tau=self.policy.tau, proxy_map=self._proxy_map,
                    k_max=self.policy.k_max, label=label, memory=memory,
                    return_decisions=return_decisions)
        elif schedule is None or isinstance(schedule, Schedule):
            sch = schedule
        else:
            sch = self.schedule_for(schedule)
        if return_decisions:
            raise ValueError("return_decisions is only meaningful on the "
                             "adaptive path (no schedule= override, "
                             "compiled=True)")
        if compiled:
            plan = self.plan if (sch is not None
                                 and sch is self._schedule) else None
            return self.executor.sample_compiled(
                params, generator, batch, schedule=sch, label=label,
                memory=memory, plan=plan)
        return self.executor.sample(params, generator, batch, schedule=sch,
                                    label=label, memory=memory)

    def compute_fraction(self) -> float:
        """Mean fraction of layer evaluations actually computed."""
        if self._schedule is None:
            return 1.0
        return float(np.mean([self._schedule.compute_fraction(t)
                              for t in self._schedule.skip]))
