"""First-class caching policies.

A :class:`CachePolicy` is a declarative description of *how to decide which
sampler steps recompute which layer types*.  Policies are pure objects: they
hold hyperparameters (α, interval, compute budget, per-type composition) and
turn calibration error curves into a static :class:`~repro_torch.core.schedule.Schedule`
via :meth:`build`.  The stateful parts — running the calibration pass, caching
compiled variants — live in the executor / pipeline, so a policy can be
constructed from a string (``repro_torch.cache.get("smoothcache:alpha=0.18")``),
serialized into a :class:`~repro_torch.cache.artifact.CacheArtifact`, and shipped to
a serving fleet without ever touching model code.

Implemented policies
--------------------
``NoCache``               every step computes every layer (baseline).
``StaticInterval(n)``     FORA [arXiv:2407.01425]: compute every n-th step.
``SmoothCache(alpha)``    paper Eq. 4 greedy thresholding of error curves.
``BudgetedSmoothCache``   α searched so the schedule hits a target compute
                          fraction (paper §2.2 "brief linear search").
``PerLayerType``          different sub-policy per layer type — the
                          Δ-DiT [arXiv:2406.01125] / CorGi block-tailored
                          direction, expressed compositionally.
``AdaptivePolicy``        TeaCache-style input-adaptive runtime rule over a
                          static base policy: the base schedule defines the
                          precompiled candidate pool, a calibrated
                          proxy→error map + threshold τ decide per step and
                          per input what to reuse (τ=0 ⇒ the static
                          schedule, bit-identically).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core import schedule as schedule_lib
from repro_torch.core.schedule import Schedule


class CachePolicy(abc.ABC):
    """Protocol: ``prepare(executor, params, generator) -> Schedule`` + metadata.

    Subclasses implement :meth:`build` (curves → schedule); :meth:`prepare`
    is the convenience entry that runs a calibration pass first when the
    policy needs one.
    """

    #: registry name; set by subclasses
    name: str = "policy"
    #: does :meth:`build` need calibration error curves?
    requires_calibration: bool = False
    #: calibration lag horizon this policy needs (max cache age it may use)
    k_max: int = 3

    @abc.abstractmethod
    def build(self, types: Sequence[str], num_steps: int,
              curves: Optional[Mapping[str, np.ndarray]] = None) -> Schedule:
        """Resolve the static schedule for the given layer types / step count.
        ``curves[t]`` is the (S, K+1) mean L1-relative error curve when the
        policy is calibration-based; calibration-free policies ignore it."""

    def to_config(self) -> Dict:
        """JSON-safe ``{"name": ..., **hyperparams}`` (round-trips through
        :func:`repro_torch.cache.registry.from_config`)."""
        return {"name": self.name}

    def spec(self) -> str:
        """Canonical registry spec string for this policy."""
        cfg = self.to_config()
        args = ",".join(f"{k}={v}" for k, v in sorted(cfg.items())
                        if k != "name")
        return cfg["name"] + (f":{args}" if args else "")

    def prepare(self, executor, params=None, generator=None, *,
                curves: Optional[Mapping[str, np.ndarray]] = None,
                calib_batch: int = 8, cond_args: Optional[Dict] = None
                ) -> Schedule:
        """Resolve a schedule for ``executor``; runs a calibration pass when
        the policy needs curves and none were supplied."""
        types = executor.cfg.layer_types()
        num_steps = executor.solver.num_steps
        if self.requires_calibration and curves is None:
            if params is None or generator is None:
                raise ValueError(
                    f"policy {self.spec()!r} needs calibration curves; pass "
                    "curves= or (params, generator) so prepare() can "
                    "calibrate")
            from repro_torch.core import calibration
            curves = calibration.calibrate_record(
                executor, params, generator, calib_batch,
                cond_args=cond_args, k_max=self.k_max).curves
        return self.build(types, num_steps, curves)

    def __repr__(self):
        return f"{type(self).__name__}({self.spec()!r})"

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.to_config() == other.to_config())

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(
            (k, str(v)) for k, v in self.to_config().items()))))


# ---------------------------------------------------------------------------
# Calibration-free policies
# ---------------------------------------------------------------------------

class NoCache(CachePolicy):
    """Baseline: compute everything at every step."""
    name = "none"
    k_max = 0

    def build(self, types, num_steps, curves=None) -> Schedule:
        return schedule_lib.no_cache(types, num_steps)


class StaticInterval(CachePolicy):
    """FORA-style static caching: compute every ``n``-th step, reuse in
    between, uniformly across all layer types."""
    name = "static"

    def __init__(self, n: int = 2):
        if n < 1:
            raise ValueError(f"StaticInterval needs n >= 1, got {n}")
        self.n = int(n)
        self.k_max = max(self.n - 1, 1)

    def build(self, types, num_steps, curves=None) -> Schedule:
        return schedule_lib.fora(types, num_steps, self.n)

    def to_config(self):
        return {"name": self.name, "n": self.n}


# ---------------------------------------------------------------------------
# Calibration-based policies
# ---------------------------------------------------------------------------

def _check_curves(curves, num_steps: int, k_max: int, name: str):
    """Reject curves that would silently produce a different schedule than
    the policy asks for: wrong step count, or a lag horizon smaller than
    the policy's k_max (smoothcache() would quietly clamp it)."""
    for t, err in curves.items():
        if err.shape[0] != num_steps:
            raise ValueError(
                f"{name}: calibration curves for {t!r} cover {err.shape[0]} "
                f"steps but the solver runs {num_steps}; recalibrate with "
                "this solver")
        if err.shape[1] - 1 < k_max:
            raise ValueError(
                f"{name}: curves for {t!r} were calibrated with "
                f"k_max={err.shape[1] - 1} < policy k_max={k_max}; "
                "recalibrate with the larger horizon")

class SmoothCache(CachePolicy):
    """Paper Eq. 4: greedy α-thresholding of the calibration error curves."""
    name = "smoothcache"
    requires_calibration = True

    def __init__(self, alpha: float = 0.18, k_max: int = 3):
        self.alpha = float(alpha)
        self.k_max = int(k_max)

    def build(self, types, num_steps, curves=None) -> Schedule:
        if curves is None:
            raise ValueError("SmoothCache.build needs calibration curves")
        _check_curves(curves, num_steps, self.k_max, self.name)
        return schedule_lib.smoothcache(curves, self.alpha, self.k_max)

    def to_config(self):
        return {"name": self.name, "alpha": self.alpha, "k_max": self.k_max}


class BudgetedSmoothCache(CachePolicy):
    """SmoothCache with α chosen by bisection so the schedule computes
    ~``target`` of all layer evaluations (declarative compute budgets —
    'give me the best schedule at 50% compute')."""
    name = "budget"
    requires_calibration = True

    def __init__(self, target: float = 0.5, k_max: int = 3):
        if not 0.0 < target <= 1.0:
            raise ValueError(f"target compute fraction must be in (0, 1], "
                             f"got {target}")
        self.target = float(target)
        self.k_max = int(k_max)

    def build(self, types, num_steps, curves=None) -> Schedule:
        if curves is None:
            raise ValueError("BudgetedSmoothCache.build needs calibration "
                             "curves")
        _check_curves(curves, num_steps, self.k_max, self.name)
        alpha = schedule_lib.alpha_for_budget(curves, self.target, self.k_max)
        sch = schedule_lib.smoothcache(curves, alpha, self.k_max)
        return dataclasses.replace(sch, name=f"budget_{self.target:g}")

    def to_config(self):
        return {"name": self.name, "target": self.target, "k_max": self.k_max}


# ---------------------------------------------------------------------------
# Input-adaptive runtime policy
# ---------------------------------------------------------------------------

class AdaptivePolicy(CachePolicy):
    """Input-adaptive runtime caching over a static ``base`` policy.

    The base policy's schedule is resolved offline as usual; it defines the
    *candidate signature pool* (the mask lattice over its ever-skipped
    types — see :func:`repro_torch.core.plan.mask_lattice`) and the static
    fallback.  At runtime the executor's ``sample_adaptive`` path maps a
    cheap per-step proxy signal (relative L1 change of the latent) through
    a calibrated proxy→error map and reuses each layer type while the
    error accumulated since its last compute stays below ``tau``,
    dispatching among the pool's precompiled programs — so per-input
    schedules never trigger per-step compilation.

    ``tau=0`` disables the runtime rule and reproduces the base schedule
    bit-identically; larger ``tau`` grants each cache run a larger
    estimated-error budget (more reuse on easy inputs, earlier recompute
    on hard ones).  Calibration-free bases (e.g. ``static``) still require
    calibration: the proxy→error map is fitted from the same pass.
    """
    name = "adaptive"
    requires_calibration = True

    def __init__(self, base: Union[str, Dict, CachePolicy] = "smoothcache",
                 tau: float = 0.05, k_max: Optional[int] = None):
        from repro_torch.cache import registry   # late: registry imports policy
        self.base = registry.get(base)
        if isinstance(self.base, AdaptivePolicy):
            raise ValueError("adaptive policies do not nest")
        if tau < 0:
            raise ValueError(f"tau must be >= 0, got {tau}")
        self.tau = float(tau)
        self._k_max_override = None if k_max is None else int(k_max)
        self.k_max = (self.base.k_max if k_max is None else int(k_max))
        if self.k_max < 1:
            raise ValueError(
                f"adaptive k_max must be >= 1, got {self.k_max}"
                + ("" if k_max is not None else
                   f" from base {self.base.spec()!r}")
                + " — k_max=0 would compile the whole candidate pool yet "
                "never reuse a cache entry (silently behaving like "
                "no_cache), and negative values are nonsense")

    def build(self, types, num_steps, curves=None) -> Schedule:
        """The *static* base schedule — the adaptive runtime's fallback and
        the source of its candidate pool."""
        return self.base.build(
            types, num_steps,
            curves if self.base.requires_calibration else None)

    def to_config(self):
        cfg = {"name": self.name, "base": self.base.to_config(),
               "tau": self.tau}
        if self._k_max_override is not None:
            cfg["k_max"] = self._k_max_override
        return cfg

    def spec(self) -> str:
        s = self.base.spec()
        base = s.replace(":", "(", 1) + ")" if ":" in s else s
        spec = f"adaptive:base={base},tau={self.tau:g}"
        if self._k_max_override is not None:
            spec += f",k_max={self._k_max_override}"
        return spec


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

class PerLayerType(CachePolicy):
    """Block-tailored composite: a different sub-policy per layer type
    (e.g. aggressive caching for ``mlp``, conservative for ``attn`` — the
    Δ-DiT / CorGi observation that blocks tolerate very different reuse).

    ``policies`` maps layer-type name → sub-policy; types not listed fall
    back to ``default`` (NoCache unless overridden).
    """
    name = "per_type"

    def __init__(self, policies: Mapping[str, CachePolicy],
                 default: Optional[CachePolicy] = None):
        self.policies = dict(policies)
        self.default = default if default is not None else NoCache()
        subs = list(self.policies.values()) + [self.default]
        self.requires_calibration = any(p.requires_calibration for p in subs)
        self.k_max = max(p.k_max for p in subs)

    def build(self, types, num_steps, curves=None) -> Schedule:
        skip: Dict[str, np.ndarray] = {}
        for t in types:
            p = self.policies.get(t, self.default)
            sub_curves = None
            if p.requires_calibration:
                if curves is None or t not in curves:
                    raise ValueError(
                        f"per-type sub-policy {p.spec()!r} for layer type "
                        f"{t!r} needs calibration curves for that type")
                sub_curves = {t: curves[t]}
            sub = p.build([t], num_steps, sub_curves)
            if sub.num_steps != num_steps or len(sub.skip[t]) != num_steps:
                raise ValueError(
                    f"per-type sub-policy {p.spec()!r} for {t!r} produced a "
                    f"{sub.num_steps}-step schedule; expected {num_steps}")
            skip[t] = np.asarray(sub.skip[t], bool)
        return Schedule(skip, num_steps, name=self.spec())

    def to_config(self):
        return {"name": self.name,
                "policies": {t: p.to_config()
                             for t, p in sorted(self.policies.items())},
                "default": self.default.to_config()}

    def spec(self) -> str:
        def paren(p: CachePolicy) -> str:
            # nested specs use the parenthesized form: name(k=v,...)
            s = p.spec()
            return s.replace(":", "(", 1) + ")" if ":" in s else s
        inner = ",".join(f"{t}={paren(p)}"
                         for t, p in sorted(self.policies.items()))
        if not isinstance(self.default, NoCache):
            inner += ("," if inner else "") + f"default={paren(self.default)}"
        return f"per_type({inner})"
