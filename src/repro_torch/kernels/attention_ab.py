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

    PYTHONPATH=src python3 -m repro_torch.kernels.attention_ab --wide

times the head-dim-256 instance (``attn_fwd_wide``) alone, in f32 and in
bf16, at Gemma-2-9B's prefill — q (2, 4352, 16, 256) over k = v (2, 4352,
8, 256), causal, softcap 50, with the local layers' window 4096 and
without — beside its bound (the band's operations at the dtype's tensor
rate: 3xTF32 in f32, bf16 as it is), its plain version, ``flex_attention``
(the one PyTorch call with a softcap, compiled: ~30 s of compile a case;
Inductor and Triton cache under ``build/``) and SDPA without the softcap
(another function).  Each kernel is held against its plain version first.
It also times DeepSeek-V3's MLA prefill — q and k (4, 1024, 128, 192), v
(4, 1024, 128, 128), f32, causal — on the instance with a value head dim
of its own (``attn_fwd_wide<float, 128>``: 16 output n-tiles) against the
design without one, the same inputs on V zero-padded to 192 through the
D 256 instance (32 output n-tiles, half of them on zeros), in the order
own, padded, padded, own, with both instances' registers and stack
(``cuobjdump -res-usage``).
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
# Gemma-2-9B's prefill in chip_smoke.py: (B, L, H, KV, D), the local
# layers' window and the attention softcap
WIDE_SHAPE, WIDE_WINDOW, WIDE_SOFTCAP = (2, 4352, 16, 8, 256), 4096, 50.0
# the H100 SXM's published dense tensor-core rates and HBM bandwidth
# (NVIDIA's data sheet): 3xTF32 runs at the TF32 rate, bf16 at its own
PEAK = {torch.float32: 495e12, torch.bfloat16: 989e12}
HBM = 3.35e12
# DeepSeek-V3's MLA prefill in chip_smoke.py: (B, L, H, D, Dv), causal
MLA_SHAPE = (4, 1024, 128, 192, 128)
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


def flex_library(qt, kt, vt, window, softcap):
    """``flex_attention``: the one PyTorch call that computes the kernel's
    function with a softcap (``score_mod``) under a causal or banded
    ``block_mask``, on (B, H, L, D) inputs with ``enable_gqa``.  Tried
    compiled (the library's fused Triton kernel), then compiled with 32-row
    blocks (f32 at D 256 may overflow the default's shared memory), then
    eager (the scores materialized).  Inductor and Triton cache under
    ``build/`` and compile in this process.  Returns (route, the call, the
    failed routes' errors)."""
    import os
    root = Path(__file__).resolve().parents[3]
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(root / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    inductor_config.compile_threads = 1

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi
        return keep if window is None else keep & (ki > qi - window)

    l = qt.shape[2]
    mask = create_block_mask(mask_mod, None, None, l, l, device=qt.device)
    routes = (("compiled", torch.compile(flex_attention), {}),
              ("compiled_block_32", torch.compile(flex_attention),
               {"kernel_options": {"BLOCK_M": 32, "BLOCK_N": 32}}),
              ("eager", flex_attention, {}))
    errors = {}
    for route, fn, kw in routes:
        def call(fn=fn, kw=kw):
            return fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      enable_gqa=True, **kw)
        try:
            call()
            torch.cuda.synchronize()
            return route, call, errors
        except Exception as e:   # the next route is timed instead
            errors[route] = f"{type(e).__name__}: {str(e)[:300]}"
    raise RuntimeError(f"flex_attention failed on every route: {errors}")


def wide(dtype, gen: torch.Generator) -> dict:
    """The head-dim-256 instance at ``WIDE_SHAPE`` in ``dtype``, with and
    without the window: kernel, bound, plain, ``flex_attention`` and SDPA
    without the softcap, in ms (``timing.device_ms``)."""
    import torch.nn.functional as F
    b, l, h, kv, d = WIDE_SHAPE
    q = torch.randn(b, l, h, d, generator=gen).to("cuda", dtype)
    k, v = (torch.randn(b, l, kv, d, generator=gen).to("cuda", dtype)
            for _ in range(2))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    i = torch.arange(l, device="cuda")
    out = {}
    for window in (WIDE_WINDOW, None):
        kw = dict(causal=True, window=window, softcap=WIDE_SOFTCAP)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        tol = TOLS[dtype]
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise RuntimeError(f"the wide instance vs plain in {dtype}, "
                               f"window {window}: max abs err {err}")
        del want
        w = window or l
        pairs = sum(min(r + 1, w) for r in range(l))
        flops = 4 * b * h * d * pairs
        nbytes = q.element_size() * b * l * d * 2 * (h + kv)
        t_ops = (3 if dtype == torch.float32 else 1) * flops / PEAK[dtype]
        t_bytes = nbytes / HBM
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
        route, flex, errors = flex_library(qt, kt, vt, window, WIDE_SOFTCAP)
        flex_diff = float((flex().transpose(1, 2).float() - got.float())
                          .abs().max())
        row = {"max_abs_err": err, "flops": flops, "bytes": nbytes,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ms": timing.device_ms(
                   lambda: fa.flash_attention_cuda(q, k, v, **kw), iters=10),
               "plain_ms": timing.device_ms(
                   lambda: ref.flash_attention_ref(q, k, v, **kw), iters=3,
                   reps=3),
               "library": f"flex_attention ({route})",
               "library_errors": errors,
               "library_max_abs_diff": flex_diff,
               "library_ms": timing.device_ms(flex, iters=5, reps=3),
               "sdpa_no_softcap_ms": timing.device_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=band, enable_gqa=True)
                   if window else F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                   iters=5, reps=3)}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out["window" if window else "global"] = row
        del got, flex
    return out


def _resources(path: str, fragment: str) -> dict:
    """Registers, stack and shared memory of each kernel in the library at
    ``path`` whose name holds ``fragment`` (``cuobjdump -res-usage``)."""
    import re
    import subprocess
    from torch.utils.cpp_extension import CUDA_HOME
    res = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                          "-res-usage", path], capture_output=True,
                         text=True, check=True).stdout
    return {name: {k.lower(): int(v) for k, v in re.findall(
        r"(REG|STACK|SHARED|LOCAL):(\d+)", usage)}
        for name, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                      res) if fragment in name}


def mla(gen: torch.Generator, path: str) -> dict:
    """The (192, 128) instance at ``MLA_SHAPE`` against the same inputs on
    V zero-padded to D (the D 256 instance), each held against the plain
    version, timed in turns (``timing.device_ms``) beside the bound."""
    import torch.nn.functional as F
    b, l, h, d, dv = MLA_SHAPE
    q, k = (torch.randn(b, l, h, d, generator=gen).cuda() for _ in range(2))
    v = torch.randn(b, l, h, dv, generator=gen).cuda()
    vp = F.pad(v, (0, d - dv))
    calls = {"own": lambda: fa.flash_attention_cuda(q, k, v),
             "padded_v": lambda: fa.flash_attention_cuda(q, k, vp)}
    want = ref.flash_attention_ref(q, k, v)
    row = {}
    for name, fn in calls.items():
        got = fn()[..., :dv]
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=5e-5, rtol=5e-5):
            raise RuntimeError(f"(192, 128) {name} vs plain: max abs err "
                               f"{err}")
        row[name] = {"max_abs_err": err, "ms": []}
    del want, got
    for name in ("own", "padded_v", "padded_v", "own"):
        row[name]["ms"].append(timing.device_ms(calls[name], iters=10))
    pairs = l * (l + 1) // 2
    flops = 2 * b * h * (d + dv) * pairs
    nbytes = 4 * b * l * h * (2 * d + 2 * dv)
    t_ops, t_bytes = 3 * flops / PEAK[torch.float32], nbytes / HBM
    row.update(shape=list(MLA_SHAPE), flops=flops, bytes=nbytes,
               bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               padded_over_own=statistics.mean(row["padded_v"]["ms"])
               / statistics.mean(row["own"]["ms"]),
               instances=_resources(path, "attn_fwd_wideIf"))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?",
                    help="the earlier flash_attention.cu")
    ap.add_argument("--wide", action="store_true",
                    help="time the head-dim-256 instance at Gemma-2's "
                         "prefill beside flex_attention, and the (192, 128) "
                         "instance against V padded to 192")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab needs a CUDA card")
    if not args.wide and args.baseline is None:
        ap.error("give the earlier flash_attention.cu or --wide")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = timing.card()
    print(card, flush=True)
    if args.wide:
        path = fa.build()["path"]
        gen = torch.Generator().manual_seed(0)
        result = {"card": card, "shape": list(WIDE_SHAPE),
                  "softcap": WIDE_SOFTCAP, "causal": True,
                  "mla": mla(gen, path)}
        print(json.dumps(result), flush=True)
        for dtype in TOLS:
            result[str(dtype)[6:]] = wide(dtype, gen)
            print(json.dumps(result), flush=True)
        return 0
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
