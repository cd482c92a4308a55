"""Artifact content checksums + the store-level health registry.

* **Content checksums** — :func:`payload_checksum` hashes the canonical
  JSON form of an artifact payload (sorted keys, checksum field
  excluded).  :meth:`CacheArtifact.to_json` embeds it and
  :meth:`CacheArtifact.from_json` verifies it, so a load detects on-disk
  corruption with a precise error instead of serving a silently mangled
  schedule.  Artifacts written before the checksum era (no ``checksum``
  key) load unchanged.  The hash is the JAX package's, so artifacts move
  between the two packages in both directions.

* **HealthRegistry** — the serving store's fault ledger.  ``quarantine``
  records a *failed hot-reload* (the bad file's reason; the old entry
  keeps serving).  ``report_fault`` counts serving faults per entry and —
  past an optional threshold — marks the entry **unhealthy**:
  ``ArtifactStore.resolve_entry_for`` then returns ``None`` for it, so no
  batch forms on it and the engine sheds its traffic with reason
  ``unhealthy_entry`` until ``mark_healthy`` clears it (e.g. after a
  successful reload).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional

#: payload key holding the content checksum (excluded from the hash)
CHECKSUM_KEY = "checksum"


def payload_checksum(payload: Dict) -> str:
    """sha256 over the canonical JSON form of ``payload`` with the
    ``checksum`` field excluded — stable across round-trips because both
    writer and verifier serialize with sorted keys."""
    d = {k: v for k, v in payload.items() if k != CHECKSUM_KEY}
    canon = json.dumps(d, sort_keys=True)
    return "sha256:" + hashlib.sha256(canon.encode("utf-8")).hexdigest()


def verify_payload(payload: Dict) -> None:
    """Raise ``ValueError`` when ``payload`` carries a checksum that does
    not match its content.  Payloads without one pass."""
    stored = payload.get(CHECKSUM_KEY)
    if stored is None:
        return
    computed = payload_checksum(payload)
    if stored != computed:
        raise ValueError(
            f"artifact checksum mismatch: file says {stored!r}, content "
            f"hashes to {computed!r} — the artifact was corrupted on disk "
            "or in transit; re-export it from calibration")


class HealthRegistry:
    """Per-entry serving-health ledger (owned by the ArtifactStore)."""

    def __init__(self, fault_threshold: Optional[int] = None):
        self.fault_threshold = fault_threshold
        self._faults: Dict[str, int] = {}
        self._unhealthy: Dict[str, str] = {}      # name → reason
        self._quarantined: Dict[str, str] = {}    # name → reload failure

    # -- serving health ------------------------------------------------------

    def report_fault(self, name: str, kind: str = "fault") -> bool:
        """Count one engine-observed fault against ``name``; returns True
        when this report crossed the threshold and marked the entry
        unhealthy."""
        n = self._faults.get(name, 0) + 1
        self._faults[name] = n
        if (self.fault_threshold is not None
                and n >= self.fault_threshold
                and name not in self._unhealthy):
            self.mark_unhealthy(
                name, f"{n} serving faults (last: {kind}) reached the "
                f"threshold of {self.fault_threshold}")
            return True
        return False

    def mark_unhealthy(self, name: str, reason: str) -> None:
        self._unhealthy[name] = reason

    def mark_healthy(self, name: str) -> None:
        """Clear unhealthy status and the fault count (a fresh start —
        e.g. after a successful hot-reload)."""
        self._unhealthy.pop(name, None)
        self._faults.pop(name, None)

    def is_servable(self, name: str) -> bool:
        return name not in self._unhealthy

    def fault_count(self, name: str) -> int:
        return self._faults.get(name, 0)

    # -- reload quarantine ---------------------------------------------------

    def quarantine(self, name: str, reason: str) -> None:
        """Record a failed hot-reload of ``name`` (the replacement file
        was rejected; the old entry keeps serving — this is a ledger
        entry, not a serving state)."""
        self._quarantined[name] = reason

    def quarantine_reason(self, name: str) -> Optional[str]:
        return self._quarantined.get(name)

    def clear_quarantine(self, name: str) -> None:
        self._quarantined.pop(name, None)

    # -- reporting -----------------------------------------------------------

    def status(self, name: str) -> Dict:
        """One entry's ledger: servability, fault count, unhealthy /
        quarantine reasons (JSON-safe)."""
        return {
            "servable": self.is_servable(name),
            "faults": self.fault_count(name),
            "unhealthy_reason": self._unhealthy.get(name),
            "quarantined_reason": self._quarantined.get(name),
        }

    def report(self) -> Dict:
        return {
            "fault_counts": dict(sorted(self._faults.items())),
            "unhealthy": dict(sorted(self._unhealthy.items())),
            "quarantined": dict(sorted(self._quarantined.items())),
        }
