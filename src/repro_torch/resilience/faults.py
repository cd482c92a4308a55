"""Typed fault taxonomy for the serving stack.

A :class:`BatchFault` is the one currency every fault source converts
into: the executor's numerical-health sentinels (NaN/Inf latents, runaway
accumulators — detected at chunk/segment boundaries, never per step), an
engine watchdog (an advance that blew its
:class:`~repro_torch.slo.admission.ServiceCostModel` deadline), and a
chaos harness (:mod:`repro_torch.resilience.chaos` raises them
deliberately).  The engine's recovery path (``ServeEngine(resilience=...)``)
consumes *only* this type — programming errors still propagate, faults
never do.

Fault kinds (the taxonomy the metrics report against):

========== =====================================================
kind        meaning
========== =====================================================
nan_latent  a sample's latent (or the decision accumulator) went
            NaN/Inf — per-sample ``sample_flags`` isolate the rows
stuck_batch an advance exceeded its watchdog deadline — the whole
            run is considered dead, no per-sample isolation
injected    a fault raised by the chaos harness (or any executor
            wrapper) as an exception mid-advance
artifact    a corrupt / checksum-mismatched artifact (surfaced by
            the store's integrity layer, recorded in its registry)
========== =====================================================
"""
from __future__ import annotations

from typing import Optional, Tuple

#: canonical fault kinds (free-form kinds are allowed; these are the ones
#: the built-in sources emit and the metrics report)
NAN_LATENT = "nan_latent"
STUCK_BATCH = "stuck_batch"
INJECTED = "injected"
ARTIFACT = "artifact"

KINDS = (NAN_LATENT, STUCK_BATCH, INJECTED, ARTIFACT)


class BatchFault(Exception):
    """A fault scoped to one in-flight micro-batch.

    ``sample_flags`` — per-row health (True = row is fine), aligned with
    the micro-batch's request order — isolates poisoned samples without
    bisection: flagged-healthy rows are *survivors* (their results are
    deliverable or they re-queue at their original arrival), flagged rows
    go down the degradation ladder.  ``None`` means the fault has no
    per-sample resolution (e.g. a stuck batch): every member survives the
    abort and re-queues.
    """

    def __init__(self, kind: str,
                 sample_flags: Optional[Tuple[bool, ...]] = None,
                 detail: str = ""):
        self.kind = str(kind)
        self.sample_flags = (tuple(bool(b) for b in sample_flags)
                             if sample_flags is not None else None)
        self.detail = detail
        msg = f"BatchFault({self.kind}"
        if self.sample_flags is not None:
            bad = [i for i, ok in enumerate(self.sample_flags) if not ok]
            msg += f", poisoned_rows={bad}"
        if detail:
            msg += f", {detail}"
        super().__init__(msg + ")")

    @property
    def poisoned_rows(self) -> Tuple[int, ...]:
        """Row indices flagged unhealthy (empty when the fault carries no
        per-sample resolution)."""
        if self.sample_flags is None:
            return ()
        return tuple(i for i, ok in enumerate(self.sample_flags) if not ok)
