"""repro_torch.durable — crash-safe serving: write-ahead request journal,
boundary run-state snapshots, and the kill–restart chaos harness.

Sits below ``repro_torch.serve`` (like ``repro_torch.resilience``):
nothing here imports the engine, the store, or the batcher.  ``ServeEngine`` wires
these pieces in when constructed with ``journal=``/``snapshot_dir=`` and
replays them in ``recover()``.  The PyTorch port of the JAX package's
``repro.durable``: the journal's bytes and the kill schedules are the
same; snapshots hold torch tensors under the port's own format tag.
"""
from repro_torch.durable.harness import (  # noqa: F401
    KillPlan, KillReport, crash, drain_with_kills)
from repro_torch.durable.journal import (  # noqa: F401
    JournalState, RequestJournal, replay)
from repro_torch.durable.snapshot import (  # noqa: F401
    FORMAT, SnapshotError, SnapshotStore, plan_hash)

__all__ = [
    "FORMAT",
    "JournalState",
    "KillPlan",
    "KillReport",
    "RequestJournal",
    "SnapshotError",
    "SnapshotStore",
    "crash",
    "drain_with_kills",
    "plan_hash",
    "replay",
]
