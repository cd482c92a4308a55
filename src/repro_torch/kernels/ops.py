"""Kernel dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version (``ref.py``).  There is no environment override and
no fallback: a kernel that fails to build or launch raises.

``LAUNCHES`` counts the calls that went to a kernel, so that a run can
show that it went through the kernels; callers reset it by assigning 0 to
an entry.  It counts calls of the function, not CUDA launches: one
``ssd`` call is three launches (``ssd.cu``'s passes), a ``linear`` or
``flash_attention`` call one.  A
call made while the stream captures a CUDA graph launches nothing: it
records the launch into the graph, and counts in ``CAPTURED`` instead.  A
graph's replays make no call at all.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as _ssd

LAUNCHES = {"flash_attention": 0, "ssd": 0, "linear": 0}
CAPTURED = {"flash_attention": 0, "ssd": 0, "linear": 0}


def _count(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def linear(x, w, b=None):
    """x: (..., K) @ w: (K, N) (+ b: (N,)) → (..., N).  On a CUDA tensor
    the batch-invariant kernel over the flattened leading dims (a row's
    bits do not depend on the other rows); on a CPU tensor ``x @ w (+ b)``
    as it stands."""
    if x.device.type == "cuda":
        out = _gemm.linear_cuda(x.reshape(-1, x.shape[-1]), w, b)
        _count("linear")
        return out.reshape(*x.shape[:-1], w.shape[1])
    if x.device.type == "cpu":
        return ref.linear_ref(x, w, b)
    raise ValueError(f"no linear for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, Lq, H, D); k, v: (B, Lk, KV, D) → (B, Lq, H, D)."""
    if q.device.type == "cuda":
        out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
        _count("flash_attention")
        return out
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    raise ValueError(f"no flash_attention for device {q.device}")


def ssd(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) →
    (y (B, L, H, P) in x's dtype, hT (B, H, P, N) f32)."""
    if x.device.type == "cuda":
        out = _ssd.ssd_cuda(x, dt, a, b, c, chunk=chunk)
        _count("ssd")
        return out
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, a, b, c, chunk=chunk)
    raise ValueError(f"no ssd for device {x.device}")
