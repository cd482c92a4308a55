"""Span/event tracer → Chrome trace-event JSON (Perfetto-loadable).

The serving stack is a scheduler: the interesting questions ("why was
this batch slow?", "what did the engine do during the overload ramp?")
are about *intervals* and their nesting, not aggregates.  The tracer
records them as Chrome trace events — duration spans (``B``/``E``) on
one track (``tid``) per in-flight batch, instant events (``i``) for
point occurrences (rung moves, watchdog fires, retries, sheds) — so a
recorded serve session drops straight into Perfetto / ``chrome://tracing``.

Design constraints, in order:

* **~zero cost when disabled.**  Engine code holds a tracer
  unconditionally; the disabled case is :data:`NULL_TRACER`, whose
  methods are empty — no conditionals at call sites, no event storage.
* **Clock-agnostic.**  Anything with a ``now() -> float`` (seconds)
  works: the serving stack's ``WallClock``/``VirtualClock``, or the
  default ``time.monotonic`` wrapper.  Virtual-clock traces are exactly
  reproducible.
* **Cheap while enabled.**  Recording is one tuple append; all JSON
  shaping happens at export time.

Matched-pair discipline is enforced at record time (``end`` without an
open span raises) and re-checked structurally on the exported JSON by
:func:`validate_chrome_trace` — monotonic timestamps per track, every
``B`` closed by its ``E``.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple


class _MonotonicClock:
    """Fallback clock when the caller has no serving clock to share."""

    def now(self) -> float:
        return time.monotonic()


class NullTracer:
    """Disabled tracer: the full API as no-ops.

    Kept method-for-method identical to :class:`Tracer` so call sites
    never branch on "is tracing on" — they just call.  ``enabled`` lets
    the rare hot path that would *build* expensive args skip them."""

    enabled = False

    def new_track(self, label: str) -> int:
        return 0

    def begin(self, tid: int, name: str, **args) -> None:
        pass

    def end(self, tid: int, name: Optional[str] = None, **args) -> None:
        pass

    def instant(self, name: str, tid: int = 0, **args) -> None:
        pass

    @contextmanager
    def span(self, tid: int, name: str, **args):
        yield

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": []}

    def save(self, path: str) -> None:
        raise ValueError("cannot save a NullTracer trace — construct a "
                         "real Tracer to record one")


#: the shared disabled tracer — engine/store/batcher default to this
NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer.  One instance per serve session.

    Track 0 ("engine") always exists and carries scheduler-level instant
    events; :meth:`new_track` allocates one track per in-flight batch
    (the engine does this at launch).  Events store as flat tuples
    ``(ph, t_seconds, tid, name, args_or_None)`` — export converts to
    Chrome trace-event dicts with microsecond timestamps."""

    enabled = True

    def __init__(self, clock=None, *, process: str = "repro_torch.serve"):
        self.clock = clock if clock is not None else _MonotonicClock()
        self.process = process
        self._events: List[Tuple[str, float, int, str, Optional[dict]]] = []
        self._tracks: Dict[int, str] = {0: "engine"}
        self._open: Dict[int, List[str]] = {}
        self._next_tid = 1

    # -- recording -----------------------------------------------------------

    def new_track(self, label: str) -> int:
        tid = self._next_tid
        self._next_tid += 1
        self._tracks[tid] = str(label)
        return tid

    def begin(self, tid: int, name: str, **args) -> None:
        self._events.append(("B", self.clock.now(), tid, name,
                             args or None))
        self._open.setdefault(tid, []).append(name)

    def end(self, tid: int, name: Optional[str] = None, **args) -> None:
        stack = self._open.get(tid)
        if not stack:
            raise ValueError(f"end() on track {tid} with no open span")
        top = stack.pop()
        if name is not None and name != top:
            stack.append(top)
            raise ValueError(f"end({name!r}) on track {tid} but the open "
                             f"span is {top!r}")
        self._events.append(("E", self.clock.now(), tid, top, args or None))

    def instant(self, name: str, tid: int = 0, **args) -> None:
        self._events.append(("i", self.clock.now(), tid, name,
                             args or None))

    @contextmanager
    def span(self, tid: int, name: str, **args):
        self.begin(tid, name, **args)
        try:
            yield
        finally:
            self.end(tid, name)

    # -- export --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def open_spans(self) -> Dict[int, Tuple[str, ...]]:
        """Still-open spans per track — non-empty means an export now
        would fail pair validation (runs still in flight)."""
        return {tid: tuple(stack) for tid, stack in self._open.items()
                if stack}

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object: thread-name metadata per
        track, then the recorded events with ``ts`` in microseconds."""
        events: List[Dict[str, Any]] = []
        for tid, label in sorted(self._tracks.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": label}})
        for ph, t, tid, name, args in self._events:
            ev: Dict[str, Any] = {"ph": ph, "ts": t * 1e6, "pid": 1,
                                  "tid": tid, "name": name}
            if ph == "i":
                ev["s"] = "t"                 # thread-scoped instant
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"process": self.process}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path


def validate_chrome_trace(obj: Dict[str, Any]) -> int:
    """Structural validation of an exported trace: per track, timestamps
    must be monotonically non-decreasing and every ``B`` matched by an
    ``E`` (no dangling spans, no stray ends).  Returns the number of
    non-metadata events checked; raises ``ValueError`` on violation —
    check it on any exported trace before shipping it."""
    last_ts: Dict[int, float] = {}
    stacks: Dict[int, List[str]] = {}
    checked = 0
    for ev in obj.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph not in ("B", "E", "i"):
            raise ValueError(f"unsupported event phase {ph!r}")
        tid = ev.get("tid")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            raise ValueError(f"event {ev.get('name')!r} has no numeric ts")
        if tid in last_ts and ts < last_ts[tid]:
            raise ValueError(
                f"track {tid}: ts went backwards ({last_ts[tid]} -> {ts} "
                f"at {ev.get('name')!r})")
        last_ts[tid] = ts
        if ph == "B":
            stacks.setdefault(tid, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.get(tid)
            if not stack:
                raise ValueError(f"track {tid}: E {ev.get('name')!r} "
                                 "without an open B")
            top = stack.pop()
            if ev.get("name") not in (None, top):
                raise ValueError(f"track {tid}: E {ev.get('name')!r} "
                                 f"closes B {top!r}")
        checked += 1
    dangling = {tid: s for tid, s in stacks.items() if s}
    if dangling:
        raise ValueError(f"unclosed spans at end of trace: {dangling}")
    return checked
