"""GQA attention, full-sequence mode: self-attention (with RoPE),
factorized video attention (OpenSora's spatial / temporal layouts) and
cross-attention to a conditioning memory.

Every form runs through :func:`repro_torch.kernels.ops.flash_attention`
and its projections through :func:`repro_torch.kernels.ops.linear`: on a
CUDA tensor those are the hand-written Hopper kernels, on a CPU tensor
their plain PyTorch versions.  There is no ``use_flash`` switch.  The JAX
package sends cross-attention to its einsum ``_sdpa``; the port sends it
to the kernel too, whose rows do not depend on the batch shape (the row
contract).  ``_sdpa`` with ``_mask_bias`` is the port of that einsum
attention, kept as an independent reference for the kernel path.

Not ported yet: MLA, decode and qk-norm.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import AttentionSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -2.0e38


def init(gen: torch.Generator, spec: AttentionSpec, d_model: int,
         dtype=torch.float32, cond_dim: int = 0):
    """A cross layer's k/v projections take ``cond_dim`` inputs."""
    h, kv, dh = spec.num_heads, spec.num_kv_heads, spec.head_dim
    kv_in = cond_dim if (spec.cross and cond_dim) else d_model
    p = {"wq": L.dense_init(gen, d_model, h * dh, dtype),
         "wk": L.dense_init(gen, kv_in, kv * dh, dtype),
         "wv": L.dense_init(gen, kv_in, kv * dh, dtype),
         "wo": L.dense_init(gen, h * dh, d_model, dtype)}
    if spec.qkv_bias:
        p["bq"] = torch.zeros(h * dh, dtype=dtype)
        p["bk"] = torch.zeros(kv * dh, dtype=dtype)
        p["bv"] = torch.zeros(kv * dh, dtype=dtype)
    return p


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int],
               k_valid=None):
    """Additive bias (..., Lq, Lk) in fp32: NEG_INF where causality, the
    window or key validity is violated."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, bias, *, softcap: Optional[float], scale: float):
    """q: (B,Lq,H,dh) k/v: (B,Lk,KV,dh); GQA attention with an fp32
    softmax over scores plus ``bias`` ((B,Lq,Lk) or broadcastable)."""
    b, lq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, lq, kvh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if softcap is not None:
        scores = L.softcap(scores, softcap)
    scores = scores + (bias[:, None, None, :, :] if bias.dim() == 3
                       else bias)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, lq, h, dh)


def _gqa_qkv(spec: AttentionSpec, params, x, memory=None):
    b = x.shape[0]
    src = memory if spec.cross else x
    q = ops.linear(x, params["wq"], params["bq"] if spec.qkv_bias else None)
    k, v = (ops.linear(src, params["w" + n],
                       params["b" + n] if spec.qkv_bias else None)
            for n in "kv")
    q = q.reshape(b, x.shape[1], spec.num_heads, spec.head_dim)
    k = k.reshape(b, src.shape[1], spec.num_kv_heads, spec.head_dim)
    v = v.reshape(b, src.shape[1], spec.num_kv_heads, spec.head_dim)
    return q, k, v


def _gqa_full(spec: AttentionSpec, params, x, positions=None, memory=None):
    q, k, v = _gqa_qkv(spec, params, x, memory)
    if spec.pos_emb == "rope" and not spec.cross:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        angles = L.rope_angles(positions, spec.head_dim, spec.rope_theta)
        q = L.apply_rope(q, positions, angles=angles)
        k = L.apply_rope(k, positions, angles=angles)
    out = ops.flash_attention(q, k, v, causal=spec.causal and not spec.cross,
                              window=spec.window, softcap=spec.logit_softcap,
                              scale=1.0 / math.sqrt(spec.head_dim))
    return ops.linear(out.reshape(x.shape[0], x.shape[1], -1), params["wo"])


def apply(spec: AttentionSpec, params, x, *, memory=None, video_shape=None):
    """Full-sequence attention over x (B, L, D) → (B, L, D): self-attention,
    or, for a cross layer, attention of x over ``memory`` (B, Lm,
    cond_dim).  ``video_shape=(T, S)`` with ``spec.pattern`` factorizes
    self-attention as OpenSora's STDiT does: "spatial" attends within each
    frame, as (B·T, S) with positions ``arange(S)``; "temporal" within
    each spatial location, as (B·S, T) with positions ``arange(T)``."""
    unported = [name for name, on in (
        ("mla", spec.kind != "gqa"), ("qk_norm", spec.qk_norm)) if on]
    if unported:
        raise NotImplementedError(
            f"attention features not ported yet: {unported}")
    if spec.cross:
        if memory is None:
            raise ValueError("a cross-attention layer needs memory=")
        return _gqa_full(spec, params, x, memory=memory)
    if spec.pattern is None:
        return _gqa_full(spec, params, x)
    if spec.pattern not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention pattern {spec.pattern!r}")
    t, s = video_shape
    b, l, d = x.shape
    if l != t * s:
        raise ValueError(f"L={l} != T*S={t * s}")
    if spec.pattern == "spatial":
        out = _gqa_full(spec, params, x.reshape(b * t, s, d),
                        torch.arange(s, device=x.device)[None, :])
        return out.reshape(b, l, d)
    # the temporal rows come from a transpose: make them contiguous rows
    # for ops.linear
    xr = x.reshape(b, t, s, d).transpose(1, 2).contiguous().reshape(
        b * s, t, d)
    out = _gqa_full(spec, params, xr,
                    torch.arange(t, device=x.device)[None, :])
    return out.reshape(b, s, t, d).transpose(1, 2).reshape(b, l, d)
