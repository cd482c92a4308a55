"""Servable artifact store: strict-validated load + hot-reload.

Serving **never recalibrates**: every schedule a server runs comes either
from a :class:`~repro_torch.cache.artifact.CacheArtifact`
produced by an offline calibration process, or from a calibration-free
policy (``none``, ``static:n=2``) resolved directly.  The store is the
serving side of that contract:

* :meth:`ArtifactStore.add_artifact` loads an artifact and runs the *same*
  strict validation as ``DiffusionPipeline.load_artifact``
  (``CacheArtifact.validate_for``: architecture, solver × step count,
  cfg_scale, adaptive tau/k_max/pool provenance) before the entry becomes
  visible to the batcher.
* :meth:`ArtifactStore.reload` hot-swaps an entry *atomically*: the
  replacement is fully loaded and validated first, and a bad file leaves
  the old entry serving (the swap raises instead of wedging traffic).
  Each swap bumps ``entry.version`` — in-flight batches keep the entry
  they launched with; new batches resolve the current one.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.cache import registry
from repro_torch.cache.artifact import CacheArtifact
from repro_torch.cache.policy import AdaptivePolicy, CachePolicy
from repro_torch.core import calibration as calibration_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core.schedule import Schedule
from repro_torch.obs import NULL_TRACER
from repro_torch.durable.snapshot import plan_hash
from repro_torch.resilience.integrity import (CHECKSUM_KEY, HealthRegistry,
                                              payload_checksum)

#: reserved entry-name prefix for store-materialized degradation targets
#: (fault-retry rungs) — not client-addressable policies
DEGRADED_PREFIX = "!degraded/"
FALLBACK_ENTRY = "!fallback/no_cache"


@dataclasses.dataclass
class ServableEntry:
    """Everything the engine needs to serve one policy: the resolved
    schedule, its pre-analyzed execution plan, and — for adaptive policies
    — the runtime decision parameters shipped in the artifact."""
    name: str
    policy: CachePolicy
    schedule: Schedule
    plan: plan_lib.ExecutionPlan
    artifact: Optional[CacheArtifact] = None
    proxy_map: Optional[calibration_lib.ProxyMap] = None
    version: int = 1
    path: Optional[str] = None
    #: the ``policy=`` override add_artifact() was called with, if any —
    #: reload() must re-apply it or a hot swap would silently fall back
    #: to the artifact's stored policy (e.g. flip a static-base entry
    #: back to adaptive serving)
    policy_override: Optional[CachePolicy] = None
    #: memoized candidate pool (adaptive entries) — derived once per
    #: entry, not per launched batch
    _pool: Optional[tuple] = dataclasses.field(default=None, repr=False)
    #: memoized provenance stamp (durable snapshots) — see provenance()
    _provenance: Optional[dict] = dataclasses.field(default=None,
                                                    repr=False)

    @property
    def adaptive(self) -> bool:
        return isinstance(self.policy, AdaptivePolicy)

    def pool(self) -> tuple:
        """Candidate signature pool of an adaptive entry (the
        schedule's mask lattice — already validated against the artifact's
        stored pool provenance by ``validate_for``), memoized so the
        engine derives it once per entry rather than once per batch."""
        if not self.adaptive:
            raise ValueError(f"entry {self.name!r} is not adaptive")
        if self._pool is None:
            self._pool = plan_lib.mask_lattice(self.schedule)
        return self._pool

    def pool_size(self) -> int:
        """Candidate-pool cardinality (2^|ever-skipped| for adaptive
        entries, the plan's unique signatures otherwise) — the per-entry
        factor in the host-dispatch program budget."""
        if self.adaptive:
            return len(self.pool())
        return self.plan.num_unique_signatures

    def program_cost(self, fused: bool) -> int:
        """Shape-specialized model programs (dispatched variants) this
        entry can need per batch bucket: a fused adaptive servable is ONE
        program (the whole pool's branches inside one on-device program)
        vs ``pool_size()`` per-signature variants under host dispatch;
        static entries need one per plan signature."""
        if self.adaptive and fused:
            return 1
        return self.pool_size()

    @property
    def tau(self) -> float:
        return self.policy.tau if self.adaptive else 0.0

    @property
    def k_max(self) -> int:
        return self.policy.k_max

    def fingerprint(self) -> str:
        """Schedule-content digest + version — an identifier for logs and
        batch records.  (Version isolation itself needs no key: the
        batcher snapshots the current entry atomically when it forms a
        batch, so one micro-batch always serves exactly one version.)"""
        return f"{self.schedule.fingerprint()}/v{self.version}"

    def provenance(self) -> dict:
        """JSON-safe identity stamp of everything a restored run's bits
        depend on: entry name + version, schedule fingerprint, execution
        plan hash, adaptive decision parameters, and the artifact's
        content checksum — the JAX package's stamp, field for field.
        Durable snapshots embed it at checkpoint time; recovery refuses
        any snapshot whose stamp disagrees with the entry now in the
        store — an entry that hot-reloaded across the restart must replay
        from the start, not continue on drifted parameters.  Memoized:
        entries are immutable once registered (reload builds a new
        entry)."""
        if self._provenance is None:
            art_ck = None
            if self.artifact is not None:
                payload = json.loads(self.artifact.to_json())
                art_ck = payload.get(CHECKSUM_KEY) \
                    or payload_checksum(payload)
            self._provenance = {
                "entry": self.name,
                "version": int(self.version),
                "schedule_fp": self.schedule.fingerprint(),
                "plan_hash": plan_hash(self.plan),
                "tau": float(self.tau),
                "k_max": int(self.k_max) if self.adaptive else None,
                "artifact_checksum": art_ck,
            }
        return dict(self._provenance)

    def compute_fraction(self) -> float:
        """Static compute fraction of the entry's schedule (adaptive runs
        report their *realized* fraction per batch instead)."""
        return float(np.mean([1.0 - np.mean(v)
                              for v in self.schedule.skip.values()]))

    def predicted_quality_cost(self, decisions=None) -> Optional[float]:
        """Predicted cumulative relative output error of one run served
        by this entry, from the artifact's fitted proxy→error map: the
        sum of ``est(type, proxy)`` over every (step, type) reuse —
        ``decisions`` when the run's realized per-step skip sets are
        known (adaptive runs), the static schedule's skips otherwise.
        The proxy is evaluated at the calibration-mean signal (0 when the
        artifact predates ``mean_proxy``).  None without a proxy map —
        entries that never calibrated one make no quality claim."""
        if self.proxy_map is None:
            return None
        p = self.proxy_map.mean_proxy
        if not np.isfinite(p):
            p = 0.0
        if decisions is None:
            decisions = [
                tuple(t for t, v in sorted(self.schedule.skip.items())
                      if v[s])
                for s in range(self.schedule.num_steps)]
        return float(sum(self.proxy_map.est(t, p)
                         for skips in decisions for t in skips))


@dataclasses.dataclass
class TauLadder:
    """Pre-registered τ rungs of one artifact: ``rung_names[i]`` is the
    store entry serving ``taus[i]`` (strictly ascending).  ``active`` is
    the rung uncapped traffic currently routes to (``set_rung``);
    requests with a ``max_tau`` quality floor are clamped to their highest
    admissible rung regardless of the active one."""
    name: str
    rung_names: Tuple[str, ...]
    taus: Tuple[float, ...]
    active: int = 0

    def rung_for_cap(self, max_tau: float) -> Optional[int]:
        """Highest rung index with ``tau <= max_tau`` (None when even the
        lowest rung exceeds the cap — the request must be shed)."""
        best = None
        for i, t in enumerate(self.taus):
            if t <= max_tau + 1e-12:
                best = i
        return best


class ArtifactStore:
    """Named servable entries validated against one deployment
    (architecture + solver + guidance scale)."""

    def __init__(self, cfg, solver, *, cfg_scale: Optional[float] = None,
                 health: Optional[HealthRegistry] = None):
        self.cfg = cfg
        self.solver = solver
        self.cfg_scale = cfg_scale
        self._entries: Dict[str, ServableEntry] = {}
        self._ladders: Dict[str, TauLadder] = {}
        #: per-entry serving-health ledger: failed hot-reloads are
        #: quarantined here (old entry keeps serving); reported faults can
        #: mark a group unhealthy, which resolve_entry_for honors — the
        #: registry the engine consults before formation
        self.health = health if health is not None else HealthRegistry()
        #: observability hook (repro_torch.obs.Tracer); the engine installs
        #: its tracer here so rung moves, hot reloads, and fault reports emit
        #: instant events no matter which component drives them
        self.tracer = NULL_TRACER

    # -- loading -------------------------------------------------------------

    def _build_entry(self, name: str,
                     src: Union[str, CacheArtifact],
                     policy: Optional[Union[str, dict, CachePolicy]],
                     strict: bool, version: int) -> ServableEntry:
        path = src if isinstance(src, str) else None
        art = CacheArtifact.load(src) if isinstance(src, str) else src
        override = registry.get(policy) if policy is not None else None
        pol = override if override is not None \
            else registry.from_config(art.policy)
        if strict:
            art.validate_for(
                arch=self.cfg.name, solver=self.solver.name,
                num_steps=self.solver.num_steps, cfg_scale=self.cfg_scale,
                policy=pol if isinstance(pol, AdaptivePolicy) else None)
        schedule = art.schedule if art.schedule is not None \
            else art.resolve(pol)
        plan = art.execution_plan()
        if plan is None:
            plan = plan_lib.analyze(schedule)
        proxy_map = None
        if art.adaptive and art.adaptive.get("proxy_map"):
            proxy_map = calibration_lib.ProxyMap.from_jsonable(
                art.adaptive["proxy_map"])
        if isinstance(pol, AdaptivePolicy) and pol.tau > 0 \
                and proxy_map is None:
            raise ValueError(
                f"entry {name!r}: adaptive policy with tau={pol.tau} needs "
                "an artifact carrying a fitted proxy_map — recalibrate "
                "(serving never calibrates)")
        return ServableEntry(name=name, policy=pol, schedule=schedule,
                             plan=plan, artifact=art, proxy_map=proxy_map,
                             version=version, path=path,
                             policy_override=override)

    def add_artifact(self, name: str, src: Union[str, CacheArtifact], *,
                     policy=None, strict: bool = True) -> ServableEntry:
        """Load + validate an artifact under ``name``.  ``policy``
        overrides the artifact's stored policy config (rare; e.g. serving
        a stored schedule under its non-adaptive base)."""
        if name in self._entries:
            raise ValueError(f"entry {name!r} exists; use reload() to "
                             "hot-swap it")
        entry = self._build_entry(name, src, policy, strict, version=1)
        self._entries[name] = entry
        return entry

    def add_policy(self, name: str,
                   policy: Union[str, dict, CachePolicy]) -> ServableEntry:
        """Register a calibration-free policy (``none``, ``static:n=2``)
        resolved directly against the deployment — no artifact involved.
        Calibration-based policies must arrive as artifacts."""
        if name in self._entries:
            raise ValueError(f"entry {name!r} exists; use reload() to "
                             "hot-swap it")
        pol = registry.get(policy)
        if pol.requires_calibration:
            raise ValueError(
                f"policy {pol.spec()!r} needs calibration curves; serving "
                "never calibrates — load its CacheArtifact via "
                "add_artifact() instead")
        schedule = pol.build(self.cfg.layer_types(), self.solver.num_steps)
        entry = ServableEntry(name=name, policy=pol, schedule=schedule,
                              plan=plan_lib.analyze(schedule))
        self._entries[name] = entry
        return entry

    def add_ladder(self, name: str, src: Union[str, CacheArtifact], *,
                   spec: Optional[str] = None,
                   taus: Optional[List[float]] = None,
                   strict: bool = True) -> TauLadder:
        """Register a τ **ladder**: several rungs of ONE adaptive artifact
        differing only in the runtime threshold τ — the degradation lever
        traffic moves across under load (``set_rung``).

        Rungs come either from a ladder spec
        (``"adaptive:base=smoothcache(alpha=0.18),tau=[0.0,0.05,0.2]"``,
        expanded by :func:`repro_torch.cache.registry.expand_ladder`) or from
        plain ``taus=[...]`` reusing the artifact's stored adaptive
        policy.  Each rung becomes a real store entry
        (``"<name>/tau=<v>"``) built from ``CacheArtifact.at_tau`` and
        strict-validated like any artifact; registration additionally
        validates that every rung shares the first rung's proxy→error map
        and candidate pool — the invariant that makes rung changes free
        (every rung dispatches the same pool signatures; τ is only a
        threshold).

        ``name`` itself resolves (``get``/``submit``) to the *active*
        rung; :meth:`set_rung` retargets it atomically.  Ladder rungs are
        artifact copies, so :meth:`reload` applies to individual rung
        entries, not the ladder name."""
        if name in self._entries or name in self._ladders:
            raise ValueError(f"entry {name!r} exists")
        if (spec is None) == (taus is None):
            raise ValueError("pass exactly one of spec= or taus=")
        art = CacheArtifact.load(src) if isinstance(src, str) else src
        if spec is not None:
            policies = registry.expand_ladder(spec)
        else:
            if dict(art.policy).get("name") not in ("adaptive", "teacache"):
                raise ValueError(
                    f"ladder {name!r}: taus= needs an artifact calibrated "
                    f"under an adaptive policy, got "
                    f"{dict(art.policy).get('name')!r}")
            tau_list = [float(t) for t in taus]
            if sorted(tau_list) != tau_list \
                    or len(set(tau_list)) != len(tau_list):
                raise ValueError(f"ladder taus must be strictly "
                                 f"ascending, got {tau_list}")
            policies = [registry.from_config({**dict(art.policy),
                                              "tau": t}) for t in tau_list]
        staged: Dict[str, ServableEntry] = {}
        rung_names: List[str] = []
        ref: Optional[ServableEntry] = None
        for pol in policies:
            ename = f"{name}/tau={pol.tau:g}"
            entry = self._build_entry(ename, art.at_tau(pol.tau), pol,
                                      strict, version=1)
            if ref is None:
                ref = entry
            else:
                pm = (entry.proxy_map.to_jsonable()
                      if entry.proxy_map else None)
                pm_ref = (ref.proxy_map.to_jsonable()
                          if ref.proxy_map else None)
                if pm != pm_ref:
                    raise ValueError(
                        f"ladder {name!r}: rung tau={pol.tau:g} has a "
                        "different proxy→error map than the first rung — "
                        "all rungs must share one map")
                if entry.pool() != ref.pool():
                    raise ValueError(
                        f"ladder {name!r}: rung tau={pol.tau:g} has a "
                        "different candidate pool than the first rung — "
                        "all rungs must share one pool")
            staged[ename] = entry
            rung_names.append(ename)
        # all-or-nothing: entries become visible only after every rung
        # validated, so a bad spec never leaves a partial ladder serving
        self._entries.update(staged)
        ladder = TauLadder(name=name, rung_names=tuple(rung_names),
                           taus=tuple(p.tau for p in policies))
        self._ladders[name] = ladder
        return ladder

    def reload(self, name: str,
               src: Optional[Union[str, CacheArtifact]] = None, *,
               strict: bool = True) -> ServableEntry:
        """Hot-swap ``name`` with a freshly validated artifact (default:
        re-read the entry's original path).  Validation happens *before*
        the swap: a bad replacement raises and the old entry keeps
        serving.  The new entry's ``version`` is bumped so the batcher's
        grouping key changes and records show which version served."""
        old = self.get(name)
        if src is None:
            if old.path is None:
                raise ValueError(f"entry {name!r} was not loaded from a "
                                 "path; pass the replacement explicitly")
            src = old.path
        try:
            entry = self._build_entry(name, src, old.policy_override,
                                      strict, version=old.version + 1)
        except Exception as e:
            # atomic failure: the old entry is still serving — record the
            # rejected replacement (with its reason) in the quarantine
            # ledger and re-raise for the operator
            self.health.quarantine(
                name, f"hot-reload rejected: {type(e).__name__}: {e}")
            self.tracer.instant("hot_reload_rejected", entry=name,
                                error=type(e).__name__)
            raise
        self._entries[name] = entry
        self.tracer.instant("hot_reload", entry=name,
                            version=entry.version)
        # a good swap is a fresh start: clear any quarantine record and
        # reset the entry's fault count / unhealthy flag
        self.health.clear_quarantine(name)
        self.health.mark_healthy(name)
        return entry

    # -- lookup --------------------------------------------------------------

    def get(self, name: str) -> ServableEntry:
        """Resolve an entry; a ladder name resolves to its *active* rung."""
        if name in self._ladders:
            lad = self._ladders[name]
            return self._entries[lad.rung_names[lad.active]]
        if name not in self._entries:
            raise KeyError(f"no servable entry {name!r}; have "
                           f"{sorted(self._entries)}")
        return self._entries[name]

    def ladder(self, name: str) -> TauLadder:
        if name not in self._ladders:
            raise KeyError(f"no τ ladder {name!r}; have "
                           f"{sorted(self._ladders)}")
        return self._ladders[name]

    def ladders(self) -> List[str]:
        return sorted(self._ladders)

    def set_rung(self, name: str, index: int) -> ServableEntry:
        """Retarget a ladder's active rung (clamped to the ladder).  Atomic
        from the batcher's view: in-flight batches keep the rung entry
        they snapshotted; new batches resolve the new rung."""
        lad = self.ladder(name)
        lad.active = max(0, min(int(index), len(lad.rung_names) - 1))
        # the one choke point every rung move goes through — instant-
        # event it here
        self.tracer.instant("set_rung", ladder=name, rung=lad.active,
                            tau=lad.taus[lad.active],
                            entry=lad.rung_names[lad.active])
        return self._entries[lad.rung_names[lad.active]]

    def resolve_entry_for(self, group: str, req) -> Optional[ServableEntry]:
        """The entry that should serve ``req`` under group ``group``,
        honoring the request's quality floor: for a ladder, the active
        rung clamped down to the request's ``max_tau`` cap; for a plain
        entry, the entry itself.  None means no registered rung/entry
        satisfies the floor — the engine sheds with ``quality_floor``."""
        if not self.health.is_servable(group):
            return None
        cap = getattr(req, "max_tau", None)
        if group in self._ladders:
            lad = self._ladders[group]
            idx = lad.active
            if cap is not None:
                c = lad.rung_for_cap(cap)
                if c is None:
                    return None
                idx = min(idx, c)
            name = lad.rung_names[idx]
            if not self.health.is_servable(name):
                return None
            return self._entries[name]
        entry = self.get(group)
        if cap is not None and entry.tau > cap + 1e-12:
            return None
        return entry

    # -- fault handling ------------------------------------------------------

    def report_fault(self, group: str, kind: str = "fault") -> bool:
        """Count a serving fault against ``group`` in the health
        registry.  Returns True when this report tripped the
        registry's threshold and the group is now unservable (the engine
        sheds its traffic with reason ``unhealthy_entry`` until a
        successful :meth:`reload` or ``health.mark_healthy``)."""
        tripped = self.health.report_fault(group, kind)
        if tripped:
            self.tracer.instant("entry_unhealthy", entry=group, kind=kind)
        return tripped

    def degraded_entry_name(self, group: str,
                            level: int) -> Optional[str]:
        """The entry a faulted ``group`` request should retry on, one
        ``level`` down the degradation ladder:

        * level 0 — ``group`` itself (retry in place),
        * level 1 — the τ=0 form: a ladder's τ=0 rung, or (plain adaptive
          entries) a store-materialized ``!degraded/<group>/tau0`` entry
          built from the artifact's ``at_tau(0.0)``; None when the group
          has no distinct τ=0 form (static entries — skip to level 2),
        * level ≥ 2 — the universal :data:`FALLBACK_ENTRY` (``no_cache``:
          full compute, no reuse — the rung that cannot be poisoned by a
          mis-calibrated schedule).
        """
        if level <= 0:
            return group
        if level == 1:
            if group in self._ladders:
                lad = self._ladders[group]
                i = lad.rung_for_cap(0.0)
                if i is not None and lad.taus[i] == 0.0:
                    return lad.rung_names[i]
                return None
            entry = self.get(group)
            if (entry.adaptive and entry.tau > 0
                    and entry.artifact is not None):
                dname = f"{DEGRADED_PREFIX}{group}/tau0"
                if dname not in self._entries:
                    pol = registry.from_config(
                        {**dict(entry.artifact.policy), "tau": 0.0})
                    self._entries[dname] = self._build_entry(
                        dname, entry.artifact.at_tau(0.0), pol,
                        strict=True, version=1)
                return dname
            return None
        return self.ensure_fallback_entry()

    def ensure_fallback_entry(self) -> str:
        """Materialize (once) and name the terminal degradation rung: a
        calibration-free ``no_cache`` entry — every layer computed every
        step, nothing reused, nothing a bad artifact can corrupt."""
        if FALLBACK_ENTRY not in self._entries:
            pol = registry.get("none")
            schedule = pol.build(self.cfg.layer_types(),
                                 self.solver.num_steps)
            self._entries[FALLBACK_ENTRY] = ServableEntry(
                name=FALLBACK_ENTRY, policy=pol, schedule=schedule,
                plan=plan_lib.analyze(schedule))
        return FALLBACK_ENTRY

    def names(self) -> List[str]:
        """Real entry names (ladder rungs included, ladder aliases not —
        the program-budget sum iterates this, and the alias resolves to a
        rung that is already counted)."""
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries or name in self._ladders

    def __len__(self) -> int:
        return len(self._entries)

    def summary(self) -> str:
        rows = [f"ArtifactStore({self.cfg.name}, {self.solver.name}"
                f"x{self.solver.num_steps}, {len(self._entries)} entries)"]
        for name in self.names():
            e = self._entries[name]
            kind = "adaptive" if e.adaptive else "static"
            src = e.path or ("artifact" if e.artifact else "policy")
            rows.append(f"  {name:16s} {e.policy.spec():40s} {kind:8s} "
                        f"v{e.version} [{src}] "
                        f"compute={e.compute_fraction():.2f} "
                        f"sigs={e.plan.num_unique_signatures}")
        return "\n".join(rows)
