"""Device time of a call on a CUDA card, two ways.

``device_ms`` is the one to report: it queues batches of calls behind a
sleep kernel, so that the host's time to check and enqueue a call stays out
of the reading once the call's device time is shorter than that.
``per_call_ms`` brackets each call alone with CUDA events; for a call that
short it also reads the host's enqueue time, and it is kept to compare
with readings taken that way.
"""
from __future__ import annotations

import statistics
import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
