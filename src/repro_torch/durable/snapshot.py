"""Run-state snapshot store — boundary checkpoints of in-flight batches.

A :class:`SnapshotStore` owns a directory of ``run-<seq>.ckpt`` files,
each one in-flight batch serialized through
:mod:`repro_torch.checkpoint.io` (JSON header + raw tensor body, staged
``.tmp`` + ``os.replace`` so a crash never publishes a half-written
file).  ``seq`` is globally monotone — scanned from the directory on
open, so it keeps rising across restarts and "newest snapshot" is a
filename comparison.

The snapshot *meta* carries the full provenance stamp (entry
name/version, schedule fingerprint, plan hash, artifact checksum, step,
request ids/seeds, lineage) plus its own content checksum via
:func:`repro_torch.resilience.integrity.payload_checksum`; :meth:`load`
verifies format and checksum and raises :class:`SnapshotError` otherwise
— recovery treats any refusal as "quarantine this file and replay the
requests from the start", mirroring the store's artifact quarantine.
The format tag is the port's own (:data:`FORMAT`): a JAX snapshot is
refused here, and the checkpoint magic refuses it first.

Snapshots are best-effort by design: they are **not** fsynced (a torn
snapshot is detected and quarantined, and the per-row determinism
contract makes replay-from-start bitwise the same), and at most one live
file exists per batch serial (a new boundary checkpoint replaces the
previous one; a finished/faulted/regrouped batch drops its file).
``timings`` accumulates the checkpoint IO's seconds (device sync, copy,
sha256, write) over every save.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, Iterable, List, Tuple

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.resilience.integrity import (CHECKSUM_KEY, payload_checksum,
                                              verify_payload)

#: snapshot format tag — bumped when the meta schema changes shape
FORMAT = "repro_torch.durable/1"

_NAME_RE = re.compile(r"^run-(\d+)\.ckpt$")


class SnapshotError(ValueError):
    """A snapshot file was refused (bad format tag, meta checksum
    mismatch, or the underlying checkpoint refused to load)."""


def plan_hash(plan) -> str:
    """Short content hash of an execution plan's canonical JSON — part of
    the provenance stamp that guards restore against entry drift."""
    js = plan.to_json()
    return "sha256:" + hashlib.sha256(js.encode("utf-8")).hexdigest()[:16]


class SnapshotStore:
    def __init__(self, dirpath: str):
        self.dir = str(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        self._seq = 0
        for name in os.listdir(self.dir):
            m = _NAME_RE.match(name)
            if m:
                self._seq = max(self._seq, int(m.group(1)))
        self._files: Dict[int, str] = {}      # batch serial → live path
        self.timings: Dict[str, float] = {}

    # -- writing -------------------------------------------------------------

    def save(self, serial: int, arrays, meta: Dict) -> Tuple[str, int]:
        """Write a boundary checkpoint for batch ``serial``; returns
        ``(filename, nbytes)``.  The previous snapshot of the same serial
        (if any) is removed only after the new file is published, so a
        crash between the two leaves the older-but-valid file behind —
        recovery's newest-first scan with rid dedup handles both."""
        self._seq += 1
        name = f"run-{self._seq}.ckpt"
        path = os.path.join(self.dir, name)
        meta = dict(meta, seq=self._seq, format=FORMAT)
        meta[CHECKSUM_KEY] = payload_checksum(meta)
        ckpt_io.save(path, arrays, meta, timings=self.timings)
        old = self._files.get(int(serial))
        if old and old != path:
            self.discard(old)
        self._files[int(serial)] = path
        return name, os.path.getsize(path)

    def drop(self, serial: int) -> None:
        """The batch left flight (finished, faulted, merged away,
        regrouped, split for retry) — its snapshot is obsolete."""
        path = self._files.pop(int(serial), None)
        if path:
            self.discard(path)

    def adopt(self, serial: int, path: str) -> None:
        """Track a restored snapshot as ``serial``'s live file so the
        next boundary checkpoint (or finish) supersedes it."""
        self._files[int(serial)] = str(path)

    # -- reading -------------------------------------------------------------

    def scan(self) -> List[str]:
        """All snapshot paths on disk, newest sequence first."""
        found = []
        for name in os.listdir(self.dir):
            m = _NAME_RE.match(name)
            if m:
                found.append((int(m.group(1)), os.path.join(self.dir, name)))
        return [p for _, p in sorted(found, reverse=True)]

    def load(self, path: str):
        """Read + verify one snapshot → ``(arrays, meta)`` with CPU
        tensors.  Raises :class:`SnapshotError` for a wrong format tag or a
        meta whose checksum disagrees with its content; the underlying
        ``CheckpointError`` (torn body, bad magic …) propagates as
        itself."""
        arrays, meta = ckpt_io.restore(path)
        if meta.get("format") != FORMAT:
            raise SnapshotError(
                f"snapshot {os.path.basename(path)} has format "
                f"{meta.get('format')!r}, expected {FORMAT!r}")
        try:
            verify_payload(meta)
        except ValueError as e:
            raise SnapshotError(
                f"snapshot {os.path.basename(path)} meta checksum "
                f"mismatch: {e}") from e
        return arrays, meta

    # -- disposal ------------------------------------------------------------

    def discard(self, path: str) -> None:
        """Remove a superseded/stale snapshot (quietly — a racing unlink
        is fine, the file is garbage either way)."""
        try:
            os.unlink(path)
        except OSError:
            pass

    def quarantine(self, path: str) -> str:
        """Refused snapshot: move it aside (``.quarantined`` suffix) so
        the next recovery scan skips it but a human can inspect it.
        Returns the original basename (ledger key)."""
        name = os.path.basename(path)
        try:
            os.replace(path, path + ".quarantined")
        except OSError:
            self.discard(path)
        return name

    def live(self) -> Iterable[int]:
        return tuple(self._files)
