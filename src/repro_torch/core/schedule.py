"""SmoothCache schedule generation (Eq. 4 of the paper) + baselines.

A *schedule* maps each SmoothCache layer type to a boolean vector over
sampling steps: ``True`` = reuse the cache (skip computing every layer of
that type), ``False`` = compute (and refill the cache).  Step 0 is always
computed.  Schedules are static — decided offline from calibration error
curves — which keeps every sampler step graph-compilable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Schedule:
    """skip[t][s] == True → at step s reuse the cache for all layers of
    type t (filled at the most recent computed step)."""
    skip: Mapping[str, np.ndarray]
    num_steps: int
    alpha: Optional[float] = None
    name: str = "smoothcache"

    def compute_fraction(self, t: str) -> float:
        return 1.0 - float(np.mean(self.skip[t]))

    def mask_at(self, s: int) -> Dict[str, bool]:
        return {t: bool(v[s]) for t, v in self.skip.items()}

    def mask_key_at(self, s: int):
        """Canonical hashable form of the step-``s`` mask: sorted
        ``(type, skip)`` pairs — the compile-cache / plan-signature key."""
        return tuple(sorted(self.mask_at(s).items()))

    def distinct_masks(self):
        return sorted({self.mask_key_at(s) for s in range(self.num_steps)})

    def summary(self) -> str:
        rows = [f"{self.name} (alpha={self.alpha})"]
        for t, v in sorted(self.skip.items()):
            frac = 100.0 * np.mean(v)
            rows.append(f"  {t:10s} skip {int(v.sum()):3d}/{len(v)} steps ({frac:.0f}%)")
        return "\n".join(rows)

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "alpha": self.alpha, "num_steps": self.num_steps,
            "skip": {t: v.astype(int).tolist() for t, v in self.skip.items()}},
            sort_keys=True)

    def content_key(self) -> str:
        """Canonical string identifying the schedule *content* (sorted keys,
        deterministic float formatting) — safe to use as a compile-cache key,
        unlike ``hash()`` which is salted per process for strings."""
        return self.to_json()

    def fingerprint(self) -> str:
        """Short stable digest of :meth:`content_key`, memoized on the
        (frozen, content-immutable) instance — plan-provenance checks on
        the sampling hot path must not re-serialize the skip arrays."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            fp = hashlib.sha256(
                self.content_key().encode("utf-8")).hexdigest()[:16]
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    @staticmethod
    def from_json(s: str) -> "Schedule":
        d = json.loads(s)
        return Schedule(
            skip={t: np.asarray(v, bool) for t, v in d["skip"].items()},
            num_steps=d["num_steps"], alpha=d.get("alpha"),
            name=d.get("name", "schedule"))


def no_cache(types: Sequence[str], num_steps: int) -> Schedule:
    return Schedule({t: np.zeros(num_steps, bool) for t in types},
                    num_steps, name="no_cache")


def fora(types: Sequence[str], num_steps: int, n: int) -> Schedule:
    """FORA [arXiv:2407.01425] / 'Static Caching': compute every n-th step,
    reuse in between — uniform across all layer types."""
    s = np.arange(num_steps)
    skip = (s % n) != 0
    skip[0] = False
    return Schedule({t: skip.copy() for t in types}, num_steps,
                    name=f"fora_n{n}")


def smoothcache(error_curves: Mapping[str, np.ndarray], alpha: float,
                k_max: int = 3) -> Schedule:
    """Paper Eq. 4 — greedy thresholding of the calibration error curve.

    ``error_curves[t]`` has shape (S, K+1): entry [s, k] is the type-mean
    L1 relative error between layer outputs at step s and step s−k
    (NaN/inf where k > s).  A step is skipped iff the error vs. the step
    that currently fills the cache is below ``alpha`` and its lag ≤ k_max.
    """
    if not error_curves:
        raise ValueError(
            "smoothcache() needs at least one layer-type error curve; got an "
            "empty mapping (did calibration run on a model with no "
            "SmoothCache-eligible layers?)")
    skip = {}
    s_total = 0
    for t, err in error_curves.items():
        s_total = err.shape[0]
        k_lim = min(k_max, err.shape[1] - 1)
        v = np.zeros(s_total, bool)
        last_computed = 0
        for s in range(1, s_total):
            k = s - last_computed
            if k <= k_lim and np.isfinite(err[s, k]) and err[s, k] < alpha:
                v[s] = True
            else:
                last_computed = s
        skip[t] = v
    return Schedule(skip, s_total, alpha=alpha)


def alpha_for_budget(error_curves: Mapping[str, np.ndarray],
                     target_compute_fraction: float, k_max: int = 3,
                     tol: float = 1e-3) -> float:
    """Linear/bisection search for the α whose schedule computes ~the given
    fraction of layer evaluations (paper §2.2: 'a brief linear search')."""
    lo, hi = 0.0, float(max(np.nanmax(e) for e in error_curves.values())) + 1e-6
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        sch = smoothcache(error_curves, mid, k_max)
        frac = np.mean([sch.compute_fraction(t) for t in error_curves])
        if frac > target_compute_fraction:
            lo = mid          # computing too much → raise α
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)
