"""Device time of a call on a CUDA card, two ways.

``device_ms`` is the one to report: it queues batches of calls behind a
sleep kernel, so that the host's time to check and enqueue a call stays out
of the reading once the call's device time is shorter than that.
``per_call_ms`` brackets each call alone with CUDA events; for a call that
short it also reads the host's enqueue time, and it is kept to compare
with readings taken that way.

``span`` names a part of a program (a profiler range); within ``spans``
it also brackets the part with CUDA events, so that a caller reads each
part's device time from the program as it ships.
"""
from __future__ import annotations

import contextlib
import statistics
import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


#: the open :func:`spans` collection: name → [(start, end) CUDA events]
_SPANS = None


@contextlib.contextmanager
def span(name: str):
    """A profiler range ``name`` (``torch.profiler.record_function``);
    within :func:`spans`, also a pair of CUDA events around it.  Usable as
    a decorator."""
    with torch.profiler.record_function(name):
        if _SPANS is None:
            yield
            return
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            yield
        finally:
            e.record()
            _SPANS.setdefault(name, []).append((s, e))


@contextlib.contextmanager
def spans():
    """Collect the CUDA events of every :func:`span` entered in the block
    (on a card).  Yields a dict that :func:`span_ms` reads after the
    block, once the device has finished."""
    global _SPANS
    outer, _SPANS = _SPANS, {}
    try:
        yield _SPANS
    finally:
        _SPANS = outer


def span_ms(collected) -> dict:
    """Device ms of each span name in a :func:`spans` dict, summed over
    its entries (synchronizes)."""
    torch.cuda.synchronize()
    return {n: sum(s.elapsed_time(e) for s, e in pairs)
            for n, pairs in collected.items()}


def device_ms(fn, iters: int = 50, reps: int = 5, warmup: int = 5) -> float:
    """Device ms per call: the median over ``reps`` batches of ``iters``
    calls, each batch timed with CUDA events and queued behind a ~50 ms
    sleep kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        per_call.append(s.elapsed_time(e) / iters)
    return statistics.median(per_call)


def per_call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """The median over ``iters`` calls, each timed alone with CUDA events
    recorded just before and just after it."""
    for _ in range(warmup):
        fn()
    marks = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)
