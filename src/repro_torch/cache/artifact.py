"""Serializable calibration artifacts.

A :class:`CacheArtifact` bundles everything needed to *reproduce* a caching
schedule without re-running calibration: the per-type mean error curves, the
resolved schedule, and provenance (architecture, solver, step count, policy
hyperparameters).  Serving loads the artifact and goes straight to compiled
sampling; curves are stored at full float64 precision (Python ``repr`` floats
are shortest-roundtrip) so a reload rebuilds the *bit-identical* schedule.
The format is the JAX package's: an artifact written by either package
loads in the other.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np

from repro_torch.cache import registry
from repro_torch.cache.policy import CachePolicy
from repro_torch.core import plan as plan_lib
from repro_torch.core.schedule import Schedule
from repro_torch.resilience.integrity import (CHECKSUM_KEY, payload_checksum,
                                        verify_payload)

# v2: adds the optional ``adaptive`` payload (tau + fitted proxy→error map
# + candidate pool provenance); v3: embeds a content checksum (verified on
# load — on-disk corruption fails loudly instead of serving a mangled
# schedule) and encodes ±Inf curve values explicitly ("Infinity" /
# "-Infinity" strings; NaN stays null).  v1/v2 artifacts load unchanged.
FORMAT_VERSION = 3

_UNSET = object()


@dataclass
class CacheArtifact:
    """Calibration curves + resolved schedule + provenance."""
    arch: str                                 # ModelConfig.name
    solver: str                               # Solver.name
    num_steps: int
    policy: Dict                              # CachePolicy.to_config()
    curves: Dict[str, np.ndarray]             # {type: (S, K+1) float64}
    schedule: Optional[Schedule] = None       # resolved skip masks
    plan: Optional[Dict] = None               # ExecutionPlan.to_jsonable()
    adaptive: Optional[Dict] = None           # tau, proxy_map, pool, k_max
    meta: Dict = field(default_factory=dict)  # calib_batch, k_max, cfg_scale…

    # -- resolution ----------------------------------------------------------

    def resolve(self, policy: Optional[CachePolicy] = None) -> Schedule:
        """Rebuild the schedule from the stored curves — with the stored
        policy by default, or any other policy against the same curves."""
        p = registry.get(policy) if policy is not None \
            else registry.from_config(self.policy)
        types = sorted(self.curves) if self.curves else \
            list(self.schedule.skip) if self.schedule else []
        return p.build(types, self.num_steps,
                       self.curves if self.curves else None)

    def execution_plan(self) -> Optional[plan_lib.ExecutionPlan]:
        """The pre-analyzed segmentation/liveness plan, when stored — a
        serving process hands it straight to the executor instead of
        re-deriving it.  Validated against the stored schedule; a stale
        plan (fingerprint mismatch) is discarded and re-analyzed."""
        if self.plan is not None:
            p = plan_lib.ExecutionPlan.from_jsonable(self.plan)
            if (self.schedule is None
                    or p.schedule_fingerprint
                    == plan_lib.schedule_fingerprint(self.schedule)):
                return p
        if self.schedule is not None:
            return plan_lib.analyze(self.schedule)
        return None

    # -- validation ----------------------------------------------------------

    def validate_for(self, *, arch: Optional[str] = None,
                     solver: Optional[str] = None,
                     num_steps: Optional[int] = None,
                     cfg_scale=_UNSET, policy=None) -> None:
        """Strict serving-side compatibility check: raise ``ValueError``
        when this artifact cannot serve the given deployment (wrong
        architecture, solver/step count, guidance strength, or — for
        adaptive artifacts — mismatched runtime decision parameters).

        Pass only the facts you want checked; ``cfg_scale`` is compared
        only when the artifact recorded one (legacy artifacts without the
        key are tolerated)."""
        # diverged calibration: an ±Inf mean-error entry means the curve
        # fit blew up — such a schedule must never serve (NaN entries are
        # legitimate: lag k > step s is structurally unmeasurable)
        for t, c in sorted(self.curves.items()):
            if np.isinf(np.asarray(c)).any():
                raise ValueError(
                    f"artifact curve for layer type {t!r} contains "
                    "non-finite (±Inf) mean-error values — the "
                    "calibration diverged; recalibrate before serving")
        if arch is not None and self.arch != arch:
            raise ValueError(f"artifact was calibrated on {self.arch!r}, "
                             f"pipeline runs {arch!r}")
        if ((solver is not None and self.solver != solver)
                or (num_steps is not None and self.num_steps != num_steps)):
            raise ValueError(
                f"artifact solver {self.solver}x{self.num_steps} != "
                f"pipeline {solver}x{num_steps}")
        # the curves depend on guidance strength; legacy artifacts
        # without the key are tolerated, a recorded mismatch is not
        if (cfg_scale is not _UNSET and "cfg_scale" in self.meta
                and self.meta["cfg_scale"] != cfg_scale):
            raise ValueError(
                f"artifact was calibrated at "
                f"cfg_scale={self.meta['cfg_scale']}, pipeline runs "
                f"cfg_scale={cfg_scale}")
        # adaptive provenance: the runtime rule must use the artifact's
        # decision parameters, not whatever the consumer was typo'd with
        if self.adaptive and policy is not None \
                and getattr(policy, "name", None) == "adaptive":
            for k, mine in (("tau", policy.tau), ("k_max", policy.k_max)):
                if k in self.adaptive and self.adaptive[k] != mine:
                    raise ValueError(
                        f"artifact's adaptive policy has {k}="
                        f"{self.adaptive[k]}, pipeline policy has "
                        f"{k}={mine}")
        # the stacked device representation (what the fused sampling
        # program evaluates) must agree with the fitted proxy map — a
        # mismatch means the payload was edited or mispaired
        if (self.adaptive and self.adaptive.get("proxy_map_stacked")
                and self.adaptive.get("proxy_map")):
            from repro_torch.core import calibration as calibration_lib
            stk = self.adaptive["proxy_map_stacked"]
            pm = calibration_lib.ProxyMap.from_jsonable(
                self.adaptive["proxy_map"])
            try:
                a, b = pm.stacked(stk.get("types", []))
            except KeyError as e:
                raise ValueError(
                    f"artifact's stacked proxy-map types {stk.get('types')} "
                    f"are not covered by its fitted coefficients: {e}")
            if (not np.allclose(a, np.asarray(stk.get("a"), np.float32))
                    or not np.allclose(b, np.asarray(stk.get("b"),
                                                     np.float32))):
                raise ValueError(
                    "artifact's stacked proxy-map coefficients do not "
                    "match its fitted proxy_map — the adaptive payload "
                    "was edited or mispaired")
        # the stored pool must be the one this schedule derives —
        # a mismatch means the payload was edited or mispaired
        if (self.adaptive and "pool" in self.adaptive
                and self.schedule is not None):
            derived = [list(sig.live_in) for sig in
                       plan_lib.mask_lattice(self.schedule)]
            if self.adaptive["pool"] != derived:
                raise ValueError(
                    f"artifact's adaptive pool "
                    f"{self.adaptive['pool']} does not match the "
                    f"stored schedule's mask lattice {derived}")

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> str:
        def enc(v):
            # NaN (lag k > step s entries) → null; ±Inf → explicit string
            # tags (strict JSON has no Infinity literal, and
            # ``allow_nan=False`` would otherwise die with an opaque
            # ValueError); finite floats round-trip exactly via
            # shortest-roundtrip repr
            if np.isnan(v):
                return None
            if np.isinf(v):
                return "Infinity" if v > 0 else "-Infinity"
            return v

        def rows(c):
            return [[enc(v) for v in row]
                    for row in np.asarray(c, np.float64).tolist()]
        payload = {
            "format_version": FORMAT_VERSION,
            "arch": self.arch,
            "solver": self.solver,
            "num_steps": self.num_steps,
            "policy": self.policy,
            "curves": {t: rows(c) for t, c in sorted(self.curves.items())},
            "schedule": (json.loads(self.schedule.to_json())
                         if self.schedule is not None else None),
            "plan": self.plan,
            "adaptive": self.adaptive,
            "meta": self.meta,
        }
        # content checksum over the canonical payload — from_json verifies
        # it, so every load/reload path detects on-disk corruption
        payload[CHECKSUM_KEY] = payload_checksum(payload)
        return json.dumps(payload, sort_keys=True, allow_nan=False)

    @staticmethod
    def from_json(s: str) -> "CacheArtifact":
        d = json.loads(s)
        ver = d.get("format_version", 0)
        if ver > FORMAT_VERSION:
            raise ValueError(f"artifact format v{ver} is newer than this "
                             f"code (v{FORMAT_VERSION})")
        # integrity first: a checksum-carrying payload that does not hash
        # to its own checksum is corrupt — refuse before interpreting any
        # field (pre-v3 payloads without a checksum pass through)
        verify_payload(d)
        sch = d.get("schedule")

        def val(v, t):
            if v is None:
                return np.nan
            if isinstance(v, str):
                if v == "Infinity":
                    return np.inf
                if v == "-Infinity":
                    return -np.inf
                raise ValueError(
                    f"artifact curve for layer type {t!r} contains "
                    f"unrecognized value {v!r} — expected a float, null "
                    "(NaN), or \"Infinity\"/\"-Infinity\"")
            return float(v)

        def arr(c, t):
            return np.asarray([[val(v, t) for v in row] for row in c],
                              np.float64)
        return CacheArtifact(
            arch=d["arch"], solver=d["solver"], num_steps=d["num_steps"],
            policy=d["policy"],
            curves={t: arr(c, t) for t, c in d.get("curves", {}).items()},
            schedule=(Schedule.from_json(json.dumps(sch))
                      if sch is not None else None),
            plan=d.get("plan"),
            adaptive=d.get("adaptive"),
            meta=d.get("meta", {}))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @staticmethod
    def load(path: str) -> "CacheArtifact":
        with open(path) as f:
            return CacheArtifact.from_json(f.read())

    # -- convenience ---------------------------------------------------------

    def summary(self) -> str:
        p = registry.from_config(self.policy)
        rows = [f"CacheArtifact(arch={self.arch}, solver={self.solver}, "
                f"steps={self.num_steps}, policy={p.spec()})"]
        if self.schedule is not None:
            rows.append(self.schedule.summary())
        return "\n".join(rows)

    def at_tau(self, tau: float) -> "CacheArtifact":
        """Copy of an adaptive artifact re-targeted at another τ rung.

        Everything that costs compilation or calibration is *shared* —
        curves, schedule, plan, proxy→error map, candidate pool — and only
        the runtime threshold changes (in both the stored policy config
        and the adaptive payload, so ``validate_for`` stays consistent).
        This is the τ-ladder seam: every rung built this way dispatches
        the same pool signatures."""
        if not self.adaptive:
            raise ValueError("at_tau needs an artifact with an adaptive "
                             "payload (calibrated under an adaptive "
                             "policy)")
        tau = float(tau)
        if tau < 0:
            raise ValueError(f"tau must be >= 0, got {tau}")
        pol = dict(self.policy)
        if pol.get("name") not in ("adaptive", "teacache"):
            raise ValueError(
                f"at_tau needs an adaptive stored policy, artifact has "
                f"{pol.get('name')!r}")
        pol["tau"] = tau
        return replace(
            self, policy=pol, adaptive={**self.adaptive, "tau": tau})

    def with_schedule(self, schedule: Schedule) -> "CacheArtifact":
        """Copy carrying ``schedule`` and its freshly analyzed plan."""
        return replace(self, schedule=schedule,
                       plan=plan_lib.analyze(schedule).to_jsonable())
