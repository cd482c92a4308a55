"""repro_torch.slo — SLO-aware scheduling over :mod:`repro_torch.serve`.

Per-request service objectives (deadline, class label, quality floor as
max τ), pluggable scheduling over in-flight micro-batches (``interleave``,
``fcfs``, ``edf``) and the online per-step service-cost model the engine
prices its backlog with.  Admission control and the τ-elastic controller
are not ported yet (``ROADMAP.md`` queue 1, item 8).

Layering: this package never imports the engine — it talks to it through
the policy interface.
"""
from repro_torch.slo.admission import (  # noqa: F401
    LoadEstimator, ServiceCostModel)
from repro_torch.slo.policy import (  # noqa: F401
    EDFPolicy, FairnessPolicy, FcfsPolicy, SchedulingPolicy, resolve_policy)
from repro_torch.slo.slo import (  # noqa: F401
    SLO, batch_deadline, remaining_steps, slack)
