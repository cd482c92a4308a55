"""repro_torch.slo — SLO-aware, quality-elastic admission control and
scheduling over :mod:`repro_torch.serve`.

Per-request service objectives (deadline, class label, quality floor as
max τ), pluggable scheduling over in-flight micro-batches (``interleave``,
``fcfs``, ``edf``, ``elastic``), admission control with explicit
admit / defer / shed decisions against the backlog that the online
per-step service-cost model prices, and the τ-elastic controller that
turns SmoothCache's error budget into a *load* control — under overload
traffic moves to a higher τ rung of the same artifact (more layer-output
reuse, cheaper steps, no new CUDA graph) instead of queueing into
deadline misses::

    from repro_torch import serve, slo

    store = serve.ArtifactStore(cfg, solver, cfg_scale=1.5)
    ladder = store.add_ladder(
        "gen", "dit.cache.json",
        spec="adaptive:base=smoothcache(alpha=0.18),tau=[0.0,0.05,0.2]")
    ctrl = slo.ElasticTauController(len(ladder.taus), target_p95_wait_s=2.0)
    eng = serve.ServeEngine(
        ex, params, store, scheduler=slo.ElasticPolicy(ctrl),
        admission=slo.AdmissionController(max_backlog_s=30.0,
                                          aging_rate=0.5))

Layering: this package never imports the engine — it talks to it through
the policy interface.
"""
from repro_torch.slo.admission import (  # noqa: F401
    ADMIT, AdmissionController, AdmissionDecision, LoadEstimator,
    ServiceCostModel)
from repro_torch.slo.controller import ElasticTauController  # noqa: F401
from repro_torch.slo.policy import (  # noqa: F401
    EDFPolicy, ElasticPolicy, FairnessPolicy, FcfsPolicy, SchedulingPolicy,
    resolve_policy)
from repro_torch.slo.slo import (  # noqa: F401
    SLO, batch_deadline, remaining_steps, slack)
from repro_torch.slo.trace import RequestClass, overload_trace  # noqa: F401
