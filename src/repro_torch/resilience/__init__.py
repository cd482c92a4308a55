"""repro_torch.resilience — fault taxonomy, recovery policy, artifact
integrity, and deterministic fault injection for the serving stack.

Layering: this package sits *below* ``repro_torch.serve`` — nothing here
imports the engine, store, batcher, or slo layer.  The serving stack
imports from here (``serve.store`` uses
:mod:`~repro_torch.resilience.integrity`, ``serve.engine`` consumes
:class:`BatchFault` and :class:`ResiliencePolicy`); the chaos harness
wraps executors and clocks from the outside.
"""
from repro_torch.resilience.faults import (  # noqa: F401
    ARTIFACT, INJECTED, KINDS, NAN_LATENT, STUCK_BATCH, BatchFault)
from repro_torch.resilience.recovery import (  # noqa: F401
    ResiliencePolicy, RetryPolicy)
from repro_torch.resilience.integrity import (  # noqa: F401
    HealthRegistry, payload_checksum, verify_payload)
from repro_torch.resilience.chaos import (  # noqa: F401
    ChaosClock, ChaosExecutor, ChaosRun, FaultPlan, FaultSpec,
    corrupt_artifact)

__all__ = [
    "ARTIFACT", "INJECTED", "KINDS", "NAN_LATENT", "STUCK_BATCH",
    "BatchFault", "ResiliencePolicy", "RetryPolicy", "HealthRegistry",
    "payload_checksum", "verify_payload", "ChaosClock", "ChaosExecutor",
    "ChaosRun", "FaultPlan", "FaultSpec", "corrupt_artifact",
]
