"""Kernel dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version (``ref.py``).  There is no environment override and
no fallback: a kernel that fails to build or launch raises.

``LAUNCHES`` counts the calls that went to a kernel, so that a run can
show that it went through the kernels; callers reset it by assigning 0 to
an entry.  It counts calls of the function, not CUDA launches: one
``ssd`` call is three launches (``ssd.cu``'s passes), a ``linear``,
``flash_attention`` or ``rglru_scan`` call one.  ``linear_tokens`` and
``linear_requests`` count the ``linear`` calls by variant.  A call made
while the stream captures a CUDA graph launches nothing: it records the
launch into the graph, and counts in ``CAPTURED`` instead.  A graph's
replays make no call at all; those of the segmented path's step graphs
and of the LM decode graphs are counted in ``REPLAYED``.

On a CUDA tensor that requires a gradient (grad mode on), each op's forward
is still its kernel, with the same launch and count, and its backward the
gradient of its plain version (``autograd.py``).  A CPU tensor's plain
version is differentiable as it stands.

A meta tensor (``launch/op_analysis.py`` counts a program's work on the
meta device) takes the kernel's meta stand-in: empty meta outputs of the
kernel's shapes, and the kernel's ``work(...)`` — (FLOPs, bytes, unit) —
handed to every meter in ``METERS``.  It launches nothing and counts in
neither ``LAUNCHES`` nor ``CAPTURED``; with a gradient to record, its
backward is the plain version's gradient, on meta, as on a card.
"""
from __future__ import annotations

from typing import Optional

import functools

import torch

from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import ssd as _ssd

LAUNCHES = {"flash_attention": 0, "ssd": 0, "linear": 0, "linear_tokens": 0,
            "linear_requests": 0, "rglru_scan": 0}
CAPTURED = dict(LAUNCHES)
#: the kernel calls that replays of the segmented path's step graphs
#: (``core/segment_graph.py``) and of the LM decode graphs
#: (``launch/decode_graph.py``) launched: a replay launches the calls its
#: graph captured, with no Python call; the fused adaptive graphs' replays
#: take a branch only the device knows, and are not counted here
REPLAYED = dict(LAUNCHES)
#: callables ``meter(name, work, outputs)`` each meta stand-in reports to
METERS: list = []


def _call(name, kernel, plain, *inputs, vjp=None):
    """``kernel(*inputs)``; through ``autograd.differentiable`` when a
    backward must be recorded."""
    if _ag.needs_grad(*inputs):
        return _ag.differentiable(kernel, plain, *inputs, vjp=vjp, name=name)
    return kernel(*inputs)


def _on_meta(name, work, *outs):
    """A kernel's meta stand-in: ``outs`` (its empty meta outputs), with
    its ``work`` reported to every meter."""
    for meter in METERS:
        meter(name, work, outs)
    return outs[0] if len(outs) == 1 else outs


def _count(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def linear(x, w, b=None, *, rows: str = "tokens"):
    """x: (..., K) @ w: (K, N) (+ b: (N,)) → (..., N).  On a CUDA tensor
    the batch-invariant kernel over the flattened leading dims (a row's
    bits do not depend on the other rows): ``rows="tokens"`` for the
    token products, ``"requests"`` for the products over one row per
    request (``gemm.plan``).  On a CPU tensor ``x @ w (+ b)`` as it
    stands, whatever ``rows`` says."""
    if rows not in _gemm.ROWS:
        raise ValueError(f"rows must be one of {_gemm.ROWS}, got {rows!r}")
    if x.device.type == "cuda":
        out = _call("linear",
                    functools.partial(_gemm.linear_cuda, rows=rows),
                    ref.linear_ref, x.reshape(-1, x.shape[-1]), w, b,
                    vjp=_ag.linear_vjp)
        _count("linear")
        _count("linear_" + rows)
        return out.reshape(*x.shape[:-1], w.shape[1])
    if x.device.type == "cpu":
        return ref.linear_ref(x, w, b)
    if x.device.type == "meta":
        def kernel(x2, w, b):
            return _on_meta("linear", _gemm.work(
                x2.shape[0], x2.shape[1], w.shape[1], b is not None, rows),
                x2.new_empty((x2.shape[0], w.shape[1])))
        out = _call("linear", kernel, ref.linear_ref,
                    x.reshape(-1, x.shape[-1]), w, b, vjp=_ag.linear_vjp)
        return out.reshape(*x.shape[:-1], w.shape[1])
    raise ValueError(f"no linear for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, Lq, H, D); k: (B, Lk, KV, D); v: (B, Lk, KV, Dv), Dv ≤ D →
    (B, Lq, H, Dv)."""
    if q.device.type == "cuda":
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        out = _call("flash_attention",
                    functools.partial(_fa.flash_attention_cuda, **kw),
                    functools.partial(ref.flash_attention_ref, **kw),
                    q, k, v)
        _count("flash_attention")
        return out
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    if q.device.type == "meta":
        (b, lq, h, d), (lk, kv), dv = q.shape, k.shape[1:3], v.shape[-1]

        def kernel(q, k, v):
            return _on_meta("flash_attention", _fa.work(
                b, lq, lk, h, kv, d, dv, causal=causal, window=window,
                dtype=q.dtype), q.new_empty((b, lq, h, dv)))
        return _call("flash_attention", kernel, functools.partial(
            ref.flash_attention_ref, causal=causal, window=window,
            softcap=softcap, scale=scale), q, k, v)
    raise ValueError(f"no flash_attention for device {q.device}")


def ssd(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) →
    (y (B, L, H, P) in x's dtype, hT (B, H, P, N) f32)."""
    if x.device.type == "cuda":
        out = _call("ssd", functools.partial(_ssd.ssd_cuda, chunk=chunk),
                    functools.partial(ref.ssd_ref, chunk=chunk),
                    x, dt, a, b, c)
        _count("ssd")
        return out
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, a, b, c, chunk=chunk)
    if x.device.type == "meta":
        (bs, l, h, p), (g, n) = x.shape, b.shape[2:]

        def kernel(x, dt, a, b, c):
            return _on_meta("ssd", _ssd.work(bs, l, h, p, g, n, chunk),
                            x.new_empty(x.shape),
                            x.new_empty((bs, h, p, n), dtype=torch.float32))
        return _call("ssd", kernel, functools.partial(ref.ssd_ref,
                                                      chunk=chunk),
                     x, dt, a, b, c)
    raise ValueError(f"no ssd for device {x.device}")


def rglru_scan(xr, ga, gx, gate, a_param, c: float, h0=None):
    """xr, ga, gx, gate: (B, L, W); a_param: (W,); h0: optional (B, W) f32
    → (y (B, L, W) f32, hT (B, W) f32): the RG-LRU recurrence
    (``ref.rglru_scan_ref``)."""
    if xr.device.type == "cuda":
        # the constant c rides in the kernel and plain closures
        out = _call("rglru_scan",
                    lambda *t: _rglru.rglru_scan_cuda(*t[:5], c, t[5]),
                    lambda *t: ref.rglru_scan_ref(*t[:5], c, t[5]),
                    xr, ga, gx, gate, a_param, h0)
        _count("rglru_scan")
        return out
    if xr.device.type == "cpu":
        return ref.rglru_scan_ref(xr, ga, gx, gate, a_param, c, h0)
    if xr.device.type == "meta":
        bs, l, w = xr.shape

        def kernel(*t):
            return _on_meta("rglru_scan", _rglru.work(bs, l, w,
                                                      h0 is not None),
                            xr.new_empty(xr.shape, dtype=torch.float32),
                            xr.new_empty((bs, w), dtype=torch.float32))
        return _call("rglru_scan", kernel,
                     lambda *t: ref.rglru_scan_ref(*t[:5], c, t[5]),
                     xr, ga, gx, gate, a_param, h0)
    raise ValueError(f"no rglru_scan for device {xr.device}")
