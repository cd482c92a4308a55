"""Admission control: load estimation, shedding, deferral, aging.

The load signal is **queue depth × calibrated per-step service cost**: the
:class:`ServiceCostModel` learns seconds-per-sampling-step online from the
engine's finished batches (an EWMA, optionally per store entry — a heavily
cached rung's steps are cheaper than full compute), and the
:class:`LoadEstimator` turns the ready queue plus the in-flight runs'
remaining steps into an estimated backlog in seconds.  Admission then makes
one of three *explicit* decisions per queued request — requests are never
silently dropped:

* ``admit`` — proceed to batch formation;
* ``defer`` — push the request back with a retry time (``retry_at``), used
  for low-priority traffic during a transient; its arrival timestamp is
  untouched so queue-wait accounting stays honest;
* ``shed`` — reject with a reason (``deadline_infeasible`` when the
  backlog already implies a miss, ``overloaded`` when deferral cannot help
  either).  The engine records the reason in its metrics and its
  ``shed`` map.

Starvation freedom: a deferred request's *effective* priority grows with
its time in queue (``priority + aging_rate × wait``), so under sustained
overload every class eventually crosses the admit threshold — low-priority
work is delayed, not starved (``tests/test_slo.py`` asserts this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional


class ServiceCostModel:
    """Online EWMA of observed service seconds per sampling step.

    ``observe`` is fed per finished micro-batch (service time of the whole
    batch over its step count — batching amortizes, so this is a per-batch
    step cost, and under interleaving it includes contention from
    co-scheduled runs, which is exactly the pessimism an admission wait
    estimate wants).  EWMAs are keyed on ``(group, bucket)`` — the group
    is the *resolved* store entry, i.e. the ladder rung a batch actually
    ran, and the bucket its power-of-two batch size — so a ladder move or
    a continuous-batching regroup never transiently mis-prices the
    backlog with another rung's (or another batch shape's) step cost.
    ``per_step(group, bucket)`` falls back ``(rung, bucket)`` → rung →
    global → seed default, so coarse estimates remain available before
    a key has observations.
    """

    def __init__(self, default_step_cost: float = 0.1, alpha: float = 0.3):
        if default_step_cost <= 0:
            raise ValueError(f"default_step_cost must be > 0, got "
                             f"{default_step_cost}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.default_step_cost = float(default_step_cost)
        self.alpha = float(alpha)
        self._global: Optional[float] = None
        self._per_group: Dict[str, float] = {}
        self._per_key: Dict[tuple, float] = {}

    def _ewma(self, prev: Optional[float], c: float) -> float:
        return c if prev is None else \
            (1 - self.alpha) * prev + self.alpha * c

    def observe(self, group: str, service_s: float, num_steps: int,
                bucket: Optional[int] = None) -> None:
        if num_steps < 1 or service_s < 0:
            return
        c = service_s / float(num_steps)
        self._global = self._ewma(self._global, c)
        self._per_group[group] = self._ewma(self._per_group.get(group), c)
        if bucket is not None:
            key = (group, int(bucket))
            self._per_key[key] = self._ewma(self._per_key.get(key), c)

    def per_step(self, group: Optional[str] = None,
                 bucket: Optional[int] = None) -> float:
        if group is not None and bucket is not None:
            key = (group, int(bucket))
            if key in self._per_key:
                return self._per_key[key]
        if group is not None and group in self._per_group:
            return self._per_group[group]
        if self._global is not None:
            return self._global
        return self.default_step_cost

    def estimate(self, num_steps: int, group: Optional[str] = None,
                 bucket: Optional[int] = None) -> float:
        """Estimated service seconds for a run of ``num_steps`` steps."""
        return self.per_step(group, bucket) * max(int(num_steps), 0)

    def snapshot(self) -> Dict:
        """The calibrated state as one JSON-safe dict — what the engine
        exports into the metrics registry as ``slo.step_cost_s`` gauges
        (observability of the admission pricing, not just its
        decisions)."""
        return {
            "global": self._global,
            "per_group": dict(sorted(self._per_group.items())),
            "per_key": {f"{g}|b{b}": v for (g, b), v in
                        sorted(self._per_key.items())},
        }


class LoadEstimator:
    """Backlog in seconds from queue depth and in-flight remaining work.

    ``batch_factor`` amortizes queued requests over micro-batching (under
    load, batches fill up to ``max_batch``, so ``max_batch`` queued
    requests cost roughly one run).  In-flight step counts are already
    per batch and enter unamortized."""

    def __init__(self, cost_model: ServiceCostModel, *,
                 batch_factor: float = 1.0):
        if batch_factor < 1:
            raise ValueError(f"batch_factor must be >= 1, got "
                             f"{batch_factor}")
        self.cost_model = cost_model
        self.batch_factor = float(batch_factor)

    def backlog_seconds(self, queued_steps: Iterable[int],
                        inflight_steps: Iterable[int]) -> float:
        c = self.cost_model.per_step()
        queued = sum(max(int(s), 0) for s in queued_steps)
        inflight = sum(max(int(s), 0) for s in inflight_steps)
        return c * (queued / self.batch_factor + inflight)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str                               # "admit" | "defer" | "shed"
    reason: str = "admitted"
    retry_at: Optional[float] = None          # set for defer


ADMIT = AdmissionDecision("admit")


class AdmissionController:
    """Per-request admit / defer / shed decisions against a backlog
    estimate.

    ``max_backlog_s`` is the overload threshold: above it only requests
    whose *effective* priority (priority + ``aging_rate`` × time in queue)
    reaches ``admit_priority`` are admitted; the rest are deferred by
    ``defer_interval`` — or shed with reason ``overloaded`` when deferral
    provably cannot meet their deadline.  Independently of load, a request
    whose deadline is already infeasible given the backlog is shed
    immediately (``deadline_infeasible``) rather than served late.
    ``headroom`` scales the wait estimate (> 1 sheds earlier/safer, < 1 is
    lenient toward the estimator's pessimism under interleaving)."""

    def __init__(self, *, max_backlog_s: Optional[float] = None,
                 admit_priority: float = 1.0, aging_rate: float = 0.0,
                 defer_interval: float = 0.5, headroom: float = 1.0):
        if max_backlog_s is not None and max_backlog_s < 0:
            raise ValueError(f"max_backlog_s must be >= 0, got "
                             f"{max_backlog_s}")
        if aging_rate < 0:
            raise ValueError(f"aging_rate must be >= 0, got {aging_rate}")
        if defer_interval <= 0:
            raise ValueError(f"defer_interval must be > 0, got "
                             f"{defer_interval}")
        if headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {headroom}")
        self.max_backlog_s = max_backlog_s
        self.admit_priority = float(admit_priority)
        self.aging_rate = float(aging_rate)
        self.defer_interval = float(defer_interval)
        self.headroom = float(headroom)

    def effective_priority(self, req, now: float) -> float:
        wait = 0.0 if req.arrival is None else max(now - req.arrival, 0.0)
        return float(req.priority) + self.aging_rate * wait

    def decide(self, req, now: float, *, backlog_s: float,
               est_service_s: float = 0.0) -> AdmissionDecision:
        deadline = getattr(req, "deadline", None)
        wait_est = self.headroom * (backlog_s + est_service_s)
        if deadline is not None and now + wait_est > deadline:
            return AdmissionDecision("shed", "deadline_infeasible")
        if self.max_backlog_s is None or backlog_s <= self.max_backlog_s:
            return ADMIT
        if self.effective_priority(req, now) >= self.admit_priority:
            return ADMIT
        retry = now + self.defer_interval
        if deadline is not None \
                and retry + self.headroom * est_service_s > deadline:
            # a deferral would return past the point of feasibility — be
            # honest now instead of shedding the same request later
            return AdmissionDecision("shed", "overloaded")
        return AdmissionDecision("defer", "overloaded", retry_at=retry)
