"""Serving metrics: latency percentiles, throughput, compute, variants.

Queue wait and service time are tracked **separately**.  Realized compute
fraction is the fraction of layer evaluations actually executed — for
static entries that equals the schedule's compute fraction, for adaptive
entries it comes from the run's realized per-step decisions, weighted by
batch size.  Model-variant counts are injected by the engine from the
executor's variant table (``compiled_variant_count`` per kind, and their
total ``model_variants``) and reported against the program budget
``|buckets| × Σ per-entry signature pool``.

SLO accounting: deadline **attainment** over deadline-carrying requests,
**goodput** (deadline-met work) vs throughput over all *offered* traffic
— shed and deferred requests are explicit outcomes with reasons, counted
in the denominator, never silently dropped — plus the realized-τ
histogram and the predicted quality cost under the elastic τ controller.

:class:`ServerMetrics` is a **view over a**
:class:`~repro_torch.obs.MetricsRegistry`: every ``observe_*`` call writes
named registry instruments (counters with labels, histograms with raw
samples), and the attribute surface — ``metrics.rejects``,
``metrics.fault_kinds``, ``metrics.queue_waits`` — is reconstructed from
the registry on read.  ``report()`` keeps the JAX package's key names for
every section, faults, continuous batching and durability (checkpoints,
refused and stale snapshots, recoveries) included.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import MetricsRegistry
from repro_torch.serve.request import Request


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile (numpy-free).  ``p`` in [0, 100];
    NaN/inf samples are rejected — sorting them would silently corrupt
    every quantile (NaN compares unordered)."""
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if not 0 <= p <= 100:
        raise ValueError(f"percentile p must be in [0, 100], got {p}")
    for x in xs:
        if not math.isfinite(x):
            raise ValueError(f"percentile over non-finite sample {x!r}")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (rank - lo))


def _dist(xs: Sequence[float]) -> Dict[str, Optional[float]]:
    # empty-safe: a group whose every request was shed has no samples —
    # report null fields, never ZeroDivisionError/IndexError
    xs = list(xs)
    if not xs:
        return {"mean": None, "p50": None, "p95": None, "max": None,
                "n": 0}
    return {
        "mean": sum(xs) / len(xs),
        "p50": percentile(xs, 50),
        "p95": percentile(xs, 95),
        "max": max(xs),
        "n": len(xs),
    }


class ServerMetrics:
    """Accumulates per-request and per-batch observations; ``report()``
    renders one JSON-safe snapshot.  All state lives in the
    :class:`~repro_torch.obs.MetricsRegistry` (pass one to share it; one
    is created otherwise)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.first_arrival: Optional[float] = None
        self.last_finish: Optional[float] = None

    # -- observation ---------------------------------------------------------

    def observe_request(self, req: Request) -> None:
        if req.queue_wait is None or req.service_time is None:
            raise ValueError(f"request {req.rid} is missing timestamps")
        reg = self.registry
        reg.observe("serve.queue_wait_s", req.queue_wait)
        reg.observe("serve.service_s", req.service_time)
        if req.joined_at is not None:
            # a boundary join ends the queue wait at the chaser launch —
            # the distribution joining is meant to improve
            reg.observe("serve.queue_wait_joined_s", req.queue_wait)
        if self.first_arrival is None or req.arrival < self.first_arrival:
            self.first_arrival = req.arrival
        if self.last_finish is None or req.finished > self.last_finish:
            self.last_finish = req.finished
        deadline = req.deadline
        attained = deadline is None or req.finished <= deadline
        if deadline is not None:
            reg.inc("slo.with_deadline")
            if attained:
                reg.inc("slo.attained")
        if attained:
            reg.inc("slo.good")

    def observe_shed(self, req: Request, reason: str, now: float) -> None:
        """A rejected request: counted against attainment and goodput
        (its deadline — if any — is definitionally missed)."""
        self.registry.inc("serve.shed", reason=reason)
        if req.deadline is not None:
            self.registry.inc("slo.with_deadline")
        if req.arrival is not None and (
                self.first_arrival is None
                or req.arrival < self.first_arrival):
            self.first_arrival = req.arrival

    def observe_defer(self, req: Request, now: float) -> None:
        self.registry.inc("serve.deferrals")

    def observe_reject(self, reason: str) -> None:
        """A submission rejected at the door with a reasoned outcome
        (``no_entry``, ``duplicate_rid``) instead of an engine-killing
        exception."""
        self.registry.inc("serve.rejects", reason=reason)

    def observe_quality(self, tau: float, quality_cost: Optional[float],
                        n: int = 1) -> None:
        """Realized τ (and predicted quality cost, when the entry carries
        a proxy→error map) of ``n`` requests served by one batch."""
        t = round(float(tau), 6)
        self.registry.inc("serve.realized_tau", n, tau=repr(t))
        if quality_cost is not None:
            for _ in range(int(n)):
                self.registry.observe("serve.quality_cost",
                                      float(quality_cost))

    def observe_batch(self, group: str, bucket: int,
                      compute_fraction: float, num_steps: int,
                      num_types: int) -> None:
        reg = self.registry
        reg.inc("serve.batches")
        reg.inc("serve.bucket_counts", bucket=int(bucket))
        reg.inc("serve.group_requests", int(bucket), group=group)
        evals = float(num_steps * num_types * bucket)
        reg.inc("serve.evals_total", evals)
        reg.inc("serve.evals_done", compute_fraction * evals)

    # -- resilience ----------------------------------------------------------

    def observe_fault(self, group: str, kind: str) -> None:
        """One micro-batch fault (NaN latent, stuck advance, injected
        error, …) — counted per kind and per serving group."""
        self.registry.inc("resilience.faults", kind=kind)
        self.registry.inc("resilience.fault_groups", group=group)

    def observe_retry(self, req: Request) -> None:
        self.registry.inc("resilience.retries")

    def observe_requeue(self, n: int = 1) -> None:
        """Healthy survivors of an aborted batch put back in the queue at
        their original arrival."""
        self.registry.inc("resilience.requeued", int(n))

    def observe_degrade(self, req: Request) -> None:
        """A faulted request stepped down the degradation ladder for its
        retry (rung → τ=0 → no_cache)."""
        self.registry.inc("resilience.degraded")

    # -- durability ----------------------------------------------------------

    def observe_checkpoint(self, nbytes: int) -> None:
        """One boundary run-state snapshot written."""
        self.registry.inc("durable.checkpoints")
        self.registry.inc("durable.checkpoint_bytes", int(nbytes))

    def observe_checkpoint_error(self) -> None:
        """A checkpoint attempt failed and was swallowed (degrade, don't
        die: serving continues, the batch just loses restore coverage)."""
        self.registry.inc("durable.checkpoint_errors")

    def observe_snapshot_refused(self) -> None:
        """Recovery refused a snapshot (torn / tampered / provenance
        drift) and quarantined it — its requests replay from the start."""
        self.registry.inc("durable.snapshots_refused")

    def observe_recovery(self, restored_runs: int, restored_requests: int,
                         replayed: int, stale: int) -> None:
        reg = self.registry
        reg.inc("durable.recoveries")
        reg.inc("durable.restored_runs", int(restored_runs))
        reg.inc("durable.restored_requests", int(restored_requests))
        reg.inc("durable.replayed_requests", int(replayed))
        reg.inc("durable.snapshots_stale", int(stale))

    # -- continuous batching -------------------------------------------------

    def observe_join(self, n: int = 1) -> None:
        """``n`` waiting requests joined an in-flight run at a boundary —
        their queue wait ends at the join launch, not at batch finish."""
        self.registry.inc("continuous.joins")
        self.registry.inc("continuous.joined_requests", int(n))

    def observe_regroup(self, n_subruns: int) -> None:
        """One in-flight batch split into ``n_subruns`` by realized mask
        signature at a chunk boundary."""
        self.registry.inc("continuous.regroups")

    def observe_merge(self, n: int = 1, kind: str = "join") -> None:
        """``n`` run-state merges; ``kind`` tells a chaser catch-up
        (``join``) from an opportunistic ``coalesce``."""
        self.registry.inc("continuous.merges", int(n), kind=kind)

    def observe_row_retry(self, n: int = 1) -> None:
        """``n`` faulted rows split out of a continuing batch for retry
        while the survivors kept their run state."""
        self.registry.inc("continuous.row_retries", int(n))

    def observe_lineage(self, tag: str, n: int = 1) -> None:
        """``n`` run-state lineage events of one kind (``join`` /
        ``regroup`` / ``coalesce`` / ``split_retry``) — the counts
        ``BatchRecord.lineage`` tags encode."""
        self.registry.inc("continuous.lineage", int(n), event=tag)

    # -- registry-backed attribute view --------------------------------------

    @property
    def queue_waits(self) -> List[float]:
        return self.registry.samples("serve.queue_wait_s")

    @property
    def service_times(self) -> List[float]:
        return self.registry.samples("serve.service_s")

    @property
    def joined_queue_waits(self) -> List[float]:
        return self.registry.samples("serve.queue_wait_joined_s")

    @property
    def quality_costs(self) -> List[float]:
        return self.registry.samples("serve.quality_cost")

    @property
    def batches(self) -> int:
        return int(self.registry.counter("serve.batches"))

    @property
    def bucket_counts(self) -> Dict[int, int]:
        return {int(k): int(v) for k, v in
                self.registry.labeled("serve.bucket_counts",
                                      "bucket").items()}

    @property
    def group_requests(self) -> Dict[str, int]:
        return {k: int(v) for k, v in
                self.registry.labeled("serve.group_requests",
                                      "group").items()}

    @property
    def shed_total(self) -> int:
        return int(self.registry.counter_total("serve.shed"))

    @property
    def shed_reasons(self) -> Dict[str, int]:
        return {k: int(v) for k, v in
                self.registry.labeled("serve.shed", "reason").items()}

    @property
    def deferrals(self) -> int:
        return int(self.registry.counter("serve.deferrals"))

    @property
    def slo_total(self) -> int:
        return int(self.registry.counter("slo.with_deadline"))

    @property
    def slo_attained(self) -> int:
        return int(self.registry.counter("slo.attained"))

    @property
    def good(self) -> int:
        return int(self.registry.counter("slo.good"))

    @property
    def tau_counts(self) -> Dict[float, int]:
        return {float(k): int(v) for k, v in
                self.registry.labeled("serve.realized_tau", "tau").items()}

    @property
    def rejects(self) -> Dict[str, int]:
        return {k: int(v) for k, v in
                self.registry.labeled("serve.rejects", "reason").items()}

    @property
    def faults_total(self) -> int:
        return int(self.registry.counter_total("resilience.faults"))

    @property
    def fault_kinds(self) -> Dict[str, int]:
        return {k: int(v) for k, v in
                self.registry.labeled("resilience.faults", "kind").items()}

    @property
    def fault_groups(self) -> Dict[str, int]:
        return {k: int(v) for k, v in
                self.registry.labeled("resilience.fault_groups",
                                      "group").items()}

    @property
    def retries(self) -> int:
        return int(self.registry.counter("resilience.retries"))

    @property
    def requeued(self) -> int:
        return int(self.registry.counter("resilience.requeued"))

    @property
    def degraded(self) -> int:
        return int(self.registry.counter("resilience.degraded"))

    @property
    def checkpoints(self) -> int:
        return int(self.registry.counter("durable.checkpoints"))

    @property
    def checkpoint_bytes(self) -> int:
        return int(self.registry.counter("durable.checkpoint_bytes"))

    @property
    def checkpoint_errors(self) -> int:
        return int(self.registry.counter("durable.checkpoint_errors"))

    @property
    def snapshots_refused(self) -> int:
        return int(self.registry.counter("durable.snapshots_refused"))

    @property
    def recoveries(self) -> int:
        return int(self.registry.counter("durable.recoveries"))

    @property
    def restored_runs(self) -> int:
        return int(self.registry.counter("durable.restored_runs"))

    @property
    def restored_requests(self) -> int:
        return int(self.registry.counter("durable.restored_requests"))

    @property
    def replayed_requests(self) -> int:
        return int(self.registry.counter("durable.replayed_requests"))

    @property
    def joins(self) -> int:
        return int(self.registry.counter("continuous.joins"))

    @property
    def joined_requests(self) -> int:
        return int(self.registry.counter("continuous.joined_requests"))

    @property
    def regroups(self) -> int:
        return int(self.registry.counter("continuous.regroups"))

    @property
    def merges(self) -> int:
        return int(self.registry.counter_total("continuous.merges"))

    @property
    def row_retries(self) -> int:
        return int(self.registry.counter("continuous.row_retries"))

    @property
    def lineage_events(self) -> Dict[str, int]:
        return {k: int(v) for k, v in
                self.registry.labeled("continuous.lineage",
                                      "event").items()}

    # -- reporting -----------------------------------------------------------

    @property
    def requests(self) -> int:
        return len(self.queue_waits)

    def realized_compute_fraction(self) -> Optional[float]:
        total = self.registry.counter("serve.evals_total")
        if total == 0:
            return None
        return self.registry.counter("serve.evals_done") / total

    def report(self, compile_counts: Optional[Dict[str, int]] = None,
               program_budget: Optional[int] = None) -> Dict:
        """One JSON-safe snapshot.  Throughput is measured over the
        first-arrival → last-finish makespan (open-loop serving: arrival
        gaps count against the server, idle pre-warm time does not)."""
        requests = self.requests
        offered = requests + self.shed_total
        out: Dict = {
            "requests": requests,
            "batches": self.batches,
            "buckets": {str(b): c
                        for b, c in sorted(self.bucket_counts.items())},
            "per_group_requests": dict(sorted(self.group_requests.items())),
            "compute_fraction": self.realized_compute_fraction(),
            "shed": {"total": self.shed_total,
                     "reasons": dict(sorted(self.shed_reasons.items()))},
            "deferrals": self.deferrals,
        }
        # goodput over *offered* traffic — throughput counts everything
        # finished, goodput only deadline-met work, so shedding can never
        # dress up as service
        out["slo"] = {
            "with_deadline": self.slo_total,
            "attained": self.slo_attained,
            "attainment": (self.slo_attained / self.slo_total
                           if self.slo_total else None),
            "good_requests": self.good,
            "offered": offered,
            "goodput_fraction": (self.good / offered if offered else None),
        }
        out["faults"] = {
            "total": self.faults_total,
            "kinds": dict(sorted(self.fault_kinds.items())),
            "groups": dict(sorted(self.fault_groups.items())),
            "retries": self.retries,
            "requeued": self.requeued,
            "degraded": self.degraded,
            "rejected_submissions": dict(sorted(self.rejects.items())),
        }
        merges_by_kind = self.registry.labeled("continuous.merges", "kind")
        out["continuous"] = {
            "joins": self.joins,
            "joined_requests": self.joined_requests,
            "regroups": self.regroups,
            "merges": self.merges,
            "join_merges": int(merges_by_kind.get("join", 0)),
            "coalesces": int(merges_by_kind.get("coalesce", 0)),
            "row_retries": self.row_retries,
            "lineage_events": dict(sorted(self.lineage_events.items())),
            "joined_queue_wait_s": _dist(self.joined_queue_waits),
        }
        out["durable"] = {
            "checkpoints": self.checkpoints,
            "checkpoint_bytes": self.checkpoint_bytes,
            "checkpoint_errors": self.checkpoint_errors,
            "snapshots_refused": self.snapshots_refused,
            "recoveries": self.recoveries,
            "restored_runs": self.restored_runs,
            "restored_requests": self.restored_requests,
            "replayed_requests": self.replayed_requests,
            "snapshots_stale": int(
                self.registry.counter("durable.snapshots_stale")),
        }
        out["realized_tau"] = {f"{t:g}": c for t, c in
                               sorted(self.tau_counts.items())}
        out["predicted_quality_cost"] = _dist(self.quality_costs)
        if requests:
            makespan = self.last_finish - self.first_arrival
            out["makespan_s"] = makespan
            out["throughput_rps"] = (requests / makespan
                                     if makespan > 0 else float("inf"))
            out["slo"]["goodput_rps"] = (self.good / makespan
                                         if makespan > 0 else float("inf"))
            out["queue_wait_s"] = _dist(self.queue_waits)
            out["service_s"] = _dist(self.service_times)
        if compile_counts is not None:
            out["compiles"] = dict(compile_counts)
        if program_budget is not None:
            out["program_budget"] = program_budget
        return out
