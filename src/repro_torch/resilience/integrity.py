"""Artifact content checksums.

:func:`payload_checksum` hashes the canonical JSON form of an artifact
payload (sorted keys, checksum field excluded).
:meth:`CacheArtifact.to_json` embeds it and :meth:`CacheArtifact.from_json`
verifies it, so a load detects on-disk corruption with a precise error
instead of serving a silently mangled schedule.  Artifacts written before
the checksum era (no ``checksum`` key) load unchanged.  The hash is the JAX
package's, so artifacts move between the two packages in both directions.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict

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
