"""Build and launch of the Hopper flash-attention kernel
(``flash_attention.cu``), which replaces the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, shapes, strides and PyTorch's current stream.  A failed build or
launch raises; nothing here falls back to the plain version.

Both products run on the tensor cores: f32 inputs as three TF32 products
(the 3xTF32 split), bf16 inputs as bf16 products, f32 accumulation.  K/V
rows are staged into shared memory with 16-byte ``cp.async`` copies when
every row is 16-byte aligned, and with plain loads otherwise (``plan``).
Head dims up to 128 take ``attn_fwd`` (Q fragments in registers, 64 query
rows a block); 129..256 take ``attn_fwd_wide`` (Q in shared memory, 128
query rows a block).  V may have a head dim of its own, Dv ≤ D (MLA: q and
k at nope + rope, v narrower): MiniCPM3's (96, 64) and DeepSeek-V3's (192,
128) each have an f32 instance whose output n-tiles follow Dv; any other
pair takes the instance for D with V's columns past Dv zero.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("flash_attention.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARITH = {torch.float32: "3xtf32-mma.sync", torch.bfloat16: "bf16-mma.sync"}
_LIB = None


def _source_constant(name: str) -> int:
    """``flash_attention.cu``'s ``constexpr int name``: what the library is
    built with."""
    found = re.search(rf"^constexpr int {name} = (\d+);",
                      SOURCE.read_text(), re.M)
    if found is None:
        raise RuntimeError(f"{SOURCE.name} defines no constexpr int {name}")
    return int(found.group(1))


#: query rows per block of ``attn_fwd`` (``BQ``) and of ``attn_fwd_wide``
#: (``BQW``), which takes head dims above 128 up to its padded ``DKW``; the
#: grid is (batch·heads, query tiles)
QUERY_TILE, WIDE_QUERY_TILE, MAX_HEAD_DIM = (
    _source_constant(name) for name in ("BQ", "BQW", "DKW"))


def query_tile(d: int) -> int:
    """Query rows per block at head dim ``d``."""
    return QUERY_TILE if d <= 128 else WIDE_QUERY_TILE


@functools.lru_cache(maxsize=1024)
def pairs(lq: int, lk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the kernel scores: key j of query i when j ≤ i
    (causal) and j > i − window (a window), positions from 0 on both."""
    total = 0
    for i in range(lq):
        hi = min(lk - 1, i) if causal else lk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def work(b: int, lq: int, lk: int, h: int, kv: int, d: int,
         dv: Optional[int] = None, *, causal: bool = False,
         window: Optional[int] = None, dtype=torch.float32) -> tuple:
    """(FLOPs, bytes, unit) of one call on q (b, lq, h, d), k (b, lk, kv,
    d), v (b, lk, kv, dv): the two products over the pairs it scores (the
    causal triangle, the window's band), q, k, v read once and the output
    written once; f32 runs 3xTF32 on the tensor cores, bf16 as bf16."""
    dv = d if dv is None else dv
    esize = torch.empty((), dtype=dtype).element_size()
    flops = 2 * b * h * (d + dv) * pairs(lq, lk, causal, window)
    nbytes = esize * b * (lq * h * d + lk * kv * d + lk * kv * dv
                          + lq * h * dv)
    return flops, nbytes, "3xtf32" if dtype == torch.float32 else "bf16"


def build() -> dict:
    """Compile the kernel (a no-op when this source is already built).
    Returns ``{"path", "seconds"}``."""
    return _build.build("flash_attention", SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.flash_attention_fwd.argtypes = (
            [p, p, p, p, i] + [i] * 7 + [ll] * 12 + [f, i, i, f, i, p])
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def plan(q, k, v) -> dict:
    """How the kernel computes these inputs: ``arith`` names the tensor-core
    arithmetic of q's dtype, ``load`` how K/V rows reach shared memory —
    ``"cp.async"`` when both head dims, every pointer and every stride (of
    a dim longer than 1) are multiples of 16 bytes, else ``"scalar"``."""
    e = 16 // q.element_size()
    aligned = q.shape[-1] % e == 0 and v.shape[-1] % e == 0 and all(
        t.data_ptr() % 16 == 0
        and all(st % e == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1)
        for t in (q, k, v))
    return {"arith": _ARITH[q.dtype],
            "load": "cp.async" if aligned else "scalar"}


def _check(q, k, v, window, softcap, scale):
    """Raise ValueError on what the kernel does not take; the device last,
    so that every other check also runs on CPU tensors."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"expected q (B,Lq,H,D), k (B,Lk,KV,D) and v "
                         f"(B,Lk,KV,Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    kv, dv = k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the kernel's "
                         f"1..{MAX_HEAD_DIM}")
    if not 1 <= dv <= d:
        raise ValueError(f"value head dim {dv} outside 1..{d}, the key's")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV "
                         "heads")
    if b * h > 2 ** 31 - 1:
        raise ValueError(f"batch*heads = {b * h} exceeds the grid's "
                         "2^31 - 1 blocks along x")
    if -(-q.shape[1] // QUERY_TILE) > 65535:
        raise ValueError(f"Lq = {q.shape[1]} exceeds the grid's 65535 query "
                         f"tiles of {QUERY_TILE} along y")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if scale is not None and not math.isfinite(scale):
        raise ValueError(f"scale must be finite, got {scale}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             "q, k, v all float32 or all bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected q's CUDA "
                             f"device {q.device}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None):
    """q: (B, Lq, H, D), k: (B, Lk, KV, D), v: (B, Lk, KV, Dv) with Dv ≤ D
    CUDA tensors of one dtype (float32 or bfloat16), any
    strides with a unit last-dim stride → (B, Lq, H, Dv) in q's dtype,
    computed in f32; ``scale`` defaults to 1/√D."""
    _check(q, k, v, window, softcap, scale)
    b, lq, h, d = q.shape
    lk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, lq, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    how = plan(q, k, v)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, lq, lk, h, kv, d, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            int(how["load"] == "cp.async"), stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return out
