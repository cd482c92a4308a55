"""GQA self-attention, full-sequence mode.

Self-attention always runs through :func:`repro_torch.kernels.ops.flash_attention`:
on a CUDA tensor that is the hand-written Hopper kernel, on a CPU tensor its
plain PyTorch version.  There is no ``use_flash`` switch.  ``_sdpa`` with
``_mask_bias`` is the port of the JAX package's einsum attention, kept as an
independent reference for the kernel path.

Not ported yet: MLA, decode, RoPE, qk-norm, factorized video attention and
cross-attention.
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
         dtype=torch.float32):
    h, kv, dh = spec.num_heads, spec.num_kv_heads, spec.head_dim
    p = {"wq": L.dense_init(gen, d_model, h * dh, dtype),
         "wk": L.dense_init(gen, d_model, kv * dh, dtype),
         "wv": L.dense_init(gen, d_model, kv * dh, dtype),
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


def _gqa_qkv(spec: AttentionSpec, params, x):
    b, l = x.shape[0], x.shape[1]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if spec.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, l, spec.num_heads, spec.head_dim)
    k = k.reshape(b, l, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(b, l, spec.num_kv_heads, spec.head_dim)
    return q, k, v


def _gqa_full(spec: AttentionSpec, params, x):
    q, k, v = _gqa_qkv(spec, params, x)
    out = ops.flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                              softcap=spec.logit_softcap,
                              scale=1.0 / math.sqrt(spec.head_dim))
    return out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]


def apply(spec: AttentionSpec, params, x):
    """Full-sequence self-attention over x (B, L, D) → (B, L, D)."""
    unported = [name for name, on in (
        ("mla", spec.kind != "gqa"), ("rope", spec.pos_emb == "rope"),
        ("qk_norm", spec.qk_norm), ("cross-attention", spec.cross),
        ("video pattern", spec.pattern is not None)) if on]
    if unported:
        raise NotImplementedError(
            f"attention features not ported yet: {unported}")
    return _gqa_full(spec, params, x)
