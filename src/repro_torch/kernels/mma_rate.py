"""Measure how fast one card retires ``mma.sync`` tensor-core products, the
instruction the flash-attention and SSD kernels are built on.

    PYTHONPATH=src python3 -m repro_torch.kernels.mma_rate

Builds ``mma_rate.cu`` and runs it with one block per SM and 4, 8 and 16
warps per SM, in TF32 (m16n8k8) and bf16 (m16n8k16).  Each reading is the
products per SM clock (from ``clock64`` in the kernel) and the TFLOP/s
(from CUDA events around one launch).  Prints the card's name and power
limit, then one JSON line.  A kernel's count of m16n8k8 products over this
rate is the least time ``mma.sync`` could take for it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import timing

SOURCE = Path(__file__).with_name("mma_rate.cu")
ITERS = 4096
WARPS = (4, 8, 16)
FLOP = {"tf32": 2 * 16 * 8 * 8, "bf16": 2 * 16 * 8 * 16}


def measure(lib, arith: str, warps: int) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads = 32 * warps
    out = torch.empty(sms * threads, device="cuda")
    cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(iters):
        rc = lib.mma_rate_launch(out.data_ptr(), cycles.data_ptr(), sms,
                                 threads, iters, int(arith == "bf16"),
                                 stream)
        if rc != 0:
            raise RuntimeError(f"mma_rate launch failed: cudaError {rc}")

    launch(16)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    launch(ITERS)
    e.record()
    torch.cuda.synchronize()
    ms = s.elapsed_time(e)
    per_sm = warps * ITERS * lib.mma_per_trip()
    clocks = float(cycles.double().mean())
    return {"arith": arith, "warps_per_sm": warps, "ms": ms,
            "mma_per_sm_clock": per_sm / clocks,
            "tflops": sms * per_sm * FLOP[arith] / ms / 1e9,
            "sm_ghz": clocks / ms / 1e6}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate needs a CUDA card")
    card = timing.card()
    print(card, flush=True)
    lib = ctypes.CDLL(_build.build("mma_rate", SOURCE)["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate_launch.argtypes = [p, p, i, i, i, i, p]
    lib.mma_rate_launch.restype = i
    lib.mma_per_trip.restype = i
    rows = [measure(lib, arith, w) for arith in FLOP for w in WARPS]
    print(json.dumps({"card": card, "iters": ITERS, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
