"""GQA attention (with RoPE, qk-norm, QKV bias): self-attention, factorized
video attention (OpenSora's spatial / temporal layouts) and cross-attention
to a conditioning memory over the whole sequence (``mode="full"``), and
one new token against a fixed-size KV cache (``mode="decode"``).

Every full-sequence form runs through
:func:`repro_torch.kernels.ops.flash_attention` and every projection
through :func:`repro_torch.kernels.ops.linear`: on a CUDA tensor those are
the hand-written Hopper kernels, on a CPU tensor their plain PyTorch
versions.  There is no ``use_flash`` switch.  The JAX package sends
cross-attention to its einsum ``_sdpa``; the port sends it to the kernel
too, whose rows do not depend on the batch shape (the row contract).
``_sdpa`` with ``_mask_bias`` is the port of that einsum attention, kept
as an independent reference for the kernel path.  Decode attention is the
JAX package's einsum ``_decode_sdpa`` over the cache layouts, in f32 plain
PyTorch on both devices (the JAX package computes it outside any kernel
too).  Caches are functional: a decode step returns a new cache.

Not ported yet: MLA.
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
    if spec.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dtype)
        p["k_norm"] = L.rmsnorm_init(dh, dtype)
    return p


def init_cache(spec: AttentionSpec, batch: int, cache_len: int,
               dtype=torch.float32, device=None):
    """Decode-time KV cache of one layer, zeroed, in the JAX package's
    decode layouts: k (B, KV, dh, S) and v (B, KV, S, dh); None for a
    cross layer, whose memory does not grow."""
    if spec.cross:
        return None
    kv, dh = spec.num_kv_heads, spec.head_dim
    return {"k": torch.zeros(batch, kv, dh, cache_len, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, kv, cache_len, dh, dtype=dtype,
                             device=device)}


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


def _decode_sdpa(spec: AttentionSpec, q, k, v, bias, *, scale: float):
    """One-token attention on the decode cache layouts.  q: (B, 1, H, dh);
    k: (B, KV, dh, S); v: (B, KV, S, dh); bias: (B, 1, S)."""
    b, _, h, dh = q.shape
    kvh = k.shape[1]
    qr = q.reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bkgd,bkds->bkgs", qr, k).float() * scale
    if spec.logit_softcap is not None:
        scores = L.softcap(scores, spec.logit_softcap)
    scores = scores + bias[:, :, None, :]
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", p, v)
    return out.reshape(b, 1, h, dh)


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
    if spec.qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    return q, k, v


def _rope(spec: AttentionSpec, q, k, positions):
    """q and k rotated at ``positions`` ((1, L) or (B, L)), one set of
    angles for both."""
    angles = L.rope_angles(positions, spec.head_dim, spec.rope_theta)
    return (L.apply_rope(q, positions, angles=angles),
            L.apply_rope(k, positions, angles=angles))


def _gqa_full(spec: AttentionSpec, params, x, positions=None, memory=None):
    """Returns ``(out, (k, v))``: k after qk-norm and RoPE, both (B, L, KV,
    dh), the prefill cache of a self-attention layer."""
    q, k, v = _gqa_qkv(spec, params, x, memory)
    if spec.pos_emb == "rope" and not spec.cross:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q, k = _rope(spec, q, k, positions)
    out = ops.flash_attention(q, k, v, causal=spec.causal and not spec.cross,
                              window=spec.window, softcap=spec.logit_softcap,
                              scale=1.0 / math.sqrt(spec.head_dim))
    out = ops.linear(out.reshape(x.shape[0], x.shape[1], -1), params["wo"])
    return out, (k, v)


def decode_slot(spec: AttentionSpec, pos: int, cache_len: int) -> int:
    """The cache slot that takes position ``pos``: a ring (``pos % S``) for a
    window that fits the cache, else ``min(pos, S - 1)``."""
    if spec.window is not None and spec.window <= cache_len:
        return pos % cache_len
    return min(pos, cache_len - 1)


def _gqa_decode(spec: AttentionSpec, params, x, pos: int, cache, slot_pos):
    """x: (B, 1, D) at position ``pos``; cache k (B, KV, dh, S), v (B, KV,
    S, dh); slot_pos (S,): the position each slot holds (-1 = empty).
    Returns ``(out, cache)``: the cache with ``slots``, its k, v and slot_pos
    updated in place (the JAX step returns new arrays; a copy here would
    move the whole cache every step)."""
    q, k_new, v_new = _gqa_qkv(spec, params, x)
    posb = torch.full((x.shape[0], 1), pos, device=x.device)
    if spec.pos_emb == "rope":
        q, k_new = _rope(spec, q, k_new, posb)
    k, v, slots = cache["k"], cache["v"], slot_pos
    slot = decode_slot(spec, pos, k.shape[-1])
    # (B, 1, KV, dh) → a column of k's layout and a row of v's
    k[..., slot] = k_new[:, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, 0].to(v.dtype)
    slots[slot] = pos
    bias = _mask_bias(posb, slots[None, :], causal=spec.causal,
                      window=spec.window, k_valid=(slots >= 0)[None, :])
    out = _decode_sdpa(spec, q, k, v, bias,
                       scale=1.0 / math.sqrt(spec.head_dim))
    out = ops.linear(out.reshape(x.shape[0], 1, -1), params["wo"])
    return out, {"k": k, "v": v, "slots": slots}


def apply(spec: AttentionSpec, params, x, *, positions=None, mode="full",
          pos=None, cache=None, slot_pos=None, memory=None,
          video_shape=None):
    """Returns ``(out, aux)``: aux is the (k, v) prefill cache in full mode
    and the updated cache in decode mode.

    Full mode: attention over x (B, L, D) → (B, L, D) at ``positions``
    ((1, L) or (B, L); default ``arange(L)``), or, for a cross layer, of x
    over ``memory`` (B, Lm, cond_dim).  ``video_shape=(T, S)`` with
    ``spec.pattern`` factorizes self-attention as OpenSora's STDiT does:
    "spatial" attends within each frame, as (B·T, S) with positions
    ``arange(S)``; "temporal" within each spatial location, as (B·S, T)
    with positions ``arange(T)``.  Decode mode: x (B, 1, D) at position
    ``pos`` (an int) against ``cache`` with ``slot_pos``."""
    if spec.kind != "gqa":
        raise NotImplementedError(
            f"attention kind {spec.kind!r} is not ported yet")
    if mode == "decode":
        if spec.cross:
            raise NotImplementedError("cross-attention decode is not "
                                      "ported")
        return _gqa_decode(spec, params, x, pos, cache, slot_pos)
    if mode != "full":
        raise ValueError(f"unknown attention mode {mode!r}")
    if spec.cross:
        if memory is None:
            raise ValueError("a cross-attention layer needs memory=")
        return _gqa_full(spec, params, x, memory=memory)
    if spec.pattern is None:
        return _gqa_full(spec, params, x, positions)
    if spec.pattern not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention pattern {spec.pattern!r}")
    t, s = video_shape
    b, l, d = x.shape
    if l != t * s:
        raise ValueError(f"L={l} != T*S={t * s}")
    if spec.pattern == "spatial":
        out, aux = _gqa_full(spec, params, x.reshape(b * t, s, d),
                             torch.arange(s, device=x.device)[None, :])
        return out.reshape(b, l, d), aux
    # the temporal rows come from a transpose: make them contiguous rows
    # for ops.linear
    xr = x.reshape(b, t, s, d).transpose(1, 2).contiguous().reshape(
        b * s, t, d)
    out, aux = _gqa_full(spec, params, xr,
                         torch.arange(t, device=x.device)[None, :])
    return out.reshape(b, s, t, d).transpose(1, 2).reshape(b, l, d), aux
