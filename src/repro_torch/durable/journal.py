"""Write-ahead request journal — the engine's crash-surviving memory.

An append-only JSONL file of serving lifecycle events.  Each line is

    ``<sha256(body)[:12]> <canonical-json-body>\\n``

so a torn tail (the crash interrupted a write mid-line) is detected by
its checksum and skipped, never parsed into a half-event.  Writes are
*fsync-on-ack*: events that acknowledge something to a client (submit,
finish, shed) hit the disk before the engine proceeds, while high-rate
progress events (launch, boundary checkpoints, retries) are flushed to
the OS but not synced — losing one of those in a crash only costs a
little replay work, never a request.

Replay is a pure function of the file: :class:`JournalState` folds the
event stream into "what was submitted, what finished, what was shed,
what was mid-flight" — everything :meth:`ServeEngine.recover` needs to
re-admit pending requests at their original arrival and to answer
``outcome(rid)`` for requests that completed before the crash.

Pure stdlib on purpose: the journal must be writable/readable even when
the array stack (torch, the device) is broken — that is exactly when you
need it.  A copy of the JAX package's ``repro.durable.journal``: the same
``_line`` format, so the same events give the same bytes and either
package replays the other's file.  ``sync_s`` adds the seconds spent in
``fsync``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

_CK_LEN = 12


def _line(body: Dict) -> bytes:
    js = json.dumps(body, sort_keys=True, separators=(",", ":"))
    ck = hashlib.sha256(js.encode("utf-8")).hexdigest()[:_CK_LEN]
    return f"{ck} {js}\n".encode("utf-8")


def _parse(raw: bytes) -> Optional[Dict]:
    """One journal line → event dict, or None when torn/corrupt."""
    try:
        text = raw.decode("utf-8")
        ck, js = text.rstrip("\n").split(" ", 1)
    except (UnicodeDecodeError, ValueError):
        return None
    if hashlib.sha256(js.encode("utf-8")).hexdigest()[:_CK_LEN] != ck:
        return None
    try:
        ev = json.loads(js)
    except json.JSONDecodeError:
        return None
    return ev if isinstance(ev, dict) and "ev" in ev else None


class RequestJournal:
    """Append-only, checksummed, fsync-on-ack event log.

    Reopening an existing file *seals* a torn tail first: if the last
    byte is not a newline, one is appended, so the interrupted line fails
    its checksum at replay instead of merging with the next append.
    """

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.sealed_tail = False
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                self.sealed_tail = f.read(1) != b"\n"
        self.appended = 0
        self.synced = 0
        self.sync_s = 0.0
        self._f = open(self.path, "ab")
        if self.sealed_tail:
            self._f.write(b"\n")
            self._flush(sync=True)

    def append(self, ev: str, *, sync: bool = True, **fields) -> None:
        body = dict(fields, ev=str(ev))
        self._f.write(_line(body))
        self.appended += 1
        self._flush(sync)

    def append_many(self, records: List[Dict], *, sync: bool = True) -> None:
        """Batch-append pre-built ``{"ev": ..., ...}`` records with a
        single flush/fsync at the end — one disk sync covers a whole
        submit burst."""
        if not records:
            return
        for body in records:
            if "ev" not in body:
                raise ValueError("journal record needs an 'ev' field")
            self._f.write(_line(body))
            self.appended += 1
        self._flush(sync)

    def _flush(self, sync: bool) -> None:
        self._f.flush()
        if sync:
            t0 = time.perf_counter()
            os.fsync(self._f.fileno())
            self.sync_s += time.perf_counter() - t0
            self.synced += 1

    @property
    def closed(self) -> bool:
        return self._f.closed

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()


def replay(path: str) -> Tuple[List[Dict], int]:
    """Read a journal file → ``(events, skipped)``.  Undecodable or
    checksum-failing lines (torn tail, bit-rot) are skipped and counted,
    never raised — a journal read is a recovery path."""
    events: List[Dict] = []
    skipped = 0
    if not os.path.exists(path):
        return events, skipped
    with open(path, "rb") as f:
        for raw in f:
            if not raw.strip():
                continue
            ev = _parse(raw)
            if ev is None:
                skipped += 1
            else:
                events.append(ev)
    return events, skipped


@dataclasses.dataclass
class JournalState:
    """The event stream folded into recovery-relevant state.  Request
    ids keep whatever (JSON-safe) type the submitter used — they are
    record *values*, so ints stay ints across the round-trip."""

    submitted: Dict = dataclasses.field(default_factory=dict)
    done: Dict = dataclasses.field(default_factory=dict)
    shed: Dict = dataclasses.field(default_factory=dict)
    started: Dict = dataclasses.field(default_factory=dict)
    attempts: Dict = dataclasses.field(default_factory=dict)
    levels: Dict = dataclasses.field(default_factory=dict)
    checkpoints: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    events: List[Dict] = dataclasses.field(default_factory=list)
    skipped: int = 0

    @classmethod
    def replay(cls, path: str) -> "JournalState":
        st = cls()
        st.events, st.skipped = replay(path)
        for ev in st.events:
            kind = ev.get("ev")
            if kind == "submit":
                st.submitted[ev["rid"]] = ev
            elif kind == "launch":
                for rid in ev.get("rids", ()):
                    st.started[rid] = float(ev.get("t", 0.0))
            elif kind == "checkpoint":
                st.checkpoints[int(ev["serial"])] = ev
            elif kind == "finish":
                for rid in ev.get("rids", ()):
                    st.done[rid] = float(ev.get("t", 0.0))
            elif kind == "shed":
                st.shed[ev["rid"]] = (str(ev.get("reason", "shed")),
                                      float(ev.get("t", 0.0)))
            elif kind == "retry":
                rid = ev["rid"]
                st.attempts[rid] = int(ev.get("attempt", 0))
                if rid in st.submitted and "policy" in ev:
                    st.submitted[rid] = dict(st.submitted[rid],
                                             policy=ev["policy"])
                if "level" in ev:
                    st.levels[rid] = int(ev["level"])
            # recover / restore / unknown events are informational
        return st

    def pending(self) -> Dict[str, Dict]:
        """Submit records with no terminal verdict — what a restarted
        engine must finish (from a snapshot or from the start)."""
        return {rid: rec for rid, rec in self.submitted.items()
                if rid not in self.done and rid not in self.shed}
