"""Time the flash-attention kernel against an earlier version of its source,
and both against SDPA, at the DiT-XL/2 shape, in one process on one card.

    git show <commit>:src/repro_torch/kernels/flash_attention.cu \\
        > build/ab/baseline.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.attention_ab \\
        build/ab/baseline.cu

The baseline's C entry point ``flash_attention_fwd`` is the one from before
the tensor-core design: the same arguments without ``vec``.  Both sources
are built in parallel.  In f32 and in bf16, each kernel is first held
against the plain version (5e-5 in f32, 5e-2 in bf16), then timed with both
methods of ``kernels.timing`` in the order baseline, current, current,
baseline; SDPA (PyTorch's ``scaled_dot_product_attention`` on head-major
copies) is timed beside them.  Prints the card's name and power limit, then
one JSON line with every reading and the ratios of the means.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, timing

SHAPE = (8, 256, 16, 72)  # DiT-XL/2 (B, L, H, D): 2 x 4 requests under CFG
METHODS = ("per_call_ms", "device_ms")
TOLS = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


def _baseline(path: str):
    """A non-causal call of the baseline library at path on (B, L, H, D)
    inputs with H = KV."""
    fwd = ctypes.CDLL(path).flash_attention_fwd
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    fwd.argtypes = [p, p, p, p, i] + [i] * 6 + [ll] * 12 + [f, i, i, f, p]
    fwd.restype = i
    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def call(q, k, v):
        b, l, h, d = q.shape
        out = torch.empty_like(q)
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dtypes[q.dtype], b, l, l, h, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], 1.0 / math.sqrt(d), 0, 0, 0.0,
                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: cudaError {rc}")
        return out

    return call


def compare(kernels: dict, dtype, gen: torch.Generator) -> dict:
    import torch.nn.functional as F
    q, k, v = (torch.randn(SHAPE, generator=gen).to("cuda", dtype)
               for _ in range(3))
    want = ref.flash_attention_ref(q, k, v, causal=False).float()
    row = {}
    for name, fn in kernels.items():
        out = fn(q, k, v).float()
        err = float((out - want).abs().max())
        tol = TOLS[dtype]
        if not torch.allclose(out, want, atol=tol, rtol=tol):
            raise RuntimeError(f"{name} kernel vs plain in {dtype}: max abs "
                               f"err {err}")
        row[name] = {"max_abs_err": err, **{m: [] for m in METHODS}}
    for name in ("baseline", "current", "current", "baseline"):
        for m in METHODS:
            row[name][m].append(getattr(timing, m)(
                lambda fn=kernels[name]: fn(q, k, v)))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    row["sdpa"] = {m: getattr(timing, m)(
        lambda: F.scaled_dot_product_attention(qt, kt, vt)) for m in METHODS}
    mean = {name: {m: statistics.mean(row[name][m]) for m in METHODS}
            for name in kernels}
    row["baseline_over_current"] = {
        m: mean["baseline"][m] / mean["current"][m] for m in METHODS}
    row["sdpa_over_current"] = {
        m: row["sdpa"][m] / mean["current"][m] for m in METHODS}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="the earlier flash_attention.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = timing.card()
    print(card, flush=True)
    with ThreadPoolExecutor(2) as pool:
        base = pool.submit(_build.build, "flash_attention_baseline",
                           Path(args.baseline).resolve())
        current = pool.submit(fa.build)
        base_path = base.result()["path"]
        current.result()
    kernels = {"baseline": _baseline(base_path),
               "current": lambda q, k, v: fa.flash_attention_cuda(
                   q, k, v, causal=False)}
    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "shape": list(SHAPE), "order":
              ["baseline", "current", "current", "baseline"]}
    for dtype in TOLS:
        result[str(dtype)[6:]] = compare(kernels, dtype, gen)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
