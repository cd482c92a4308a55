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
too).  A decode step writes its new key and value into the cache it was
given, at a slot computed on the device from the position, a ``(1,)``
int64 tensor (an int is taken to one), as the JAX package's jitted step
writes at a traced position: one captured CUDA graph serves every
position (``launch/decode_graph.py``).

MLA (DeepSeek-style latent-KV attention, MiniCPM3): the full mode expands
the latent into per-head keys and values and runs the same kernel, with
q and k each [nope | rope] (nope + rope wide) and a value head dim of its
own; the JAX package computes it as two score einsums.  The decode step
is the JAX package's absorbed einsum path over the (ckv, krope) latent
cache, in f32 plain PyTorch on both devices.
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
    """A cross layer's k/v projections take ``cond_dim`` inputs.  An MLA
    layer has a q-LoRA (``wq_a``, ``q_norm``, ``wq_b``) or a full-rank
    ``wq``, the kv latent's down projection ``wkv_a`` (to kv_lora + rope),
    ``kv_norm``, its up projection ``wkv_b`` (to H · (nope + v)) and
    ``wo``."""
    if spec.kind == "mla":
        h, qd = spec.num_heads, spec.q_dim
        p = {}
        if spec.q_lora_rank:
            p["wq_a"] = L.dense_init(gen, d_model, spec.q_lora_rank, dtype)
            p["q_norm"] = L.rmsnorm_init(spec.q_lora_rank, dtype)
            p["wq_b"] = L.dense_init(gen, spec.q_lora_rank, qd, dtype)
        else:
            p["wq"] = L.dense_init(gen, d_model, qd, dtype)
        p["wkv_a"] = L.dense_init(
            gen, d_model, spec.kv_lora_rank + spec.rope_head_dim, dtype)
        p["kv_norm"] = L.rmsnorm_init(spec.kv_lora_rank, dtype)
        p["wkv_b"] = L.dense_init(
            gen, spec.kv_lora_rank,
            h * (spec.nope_head_dim + spec.v_head_dim), dtype)
        p["wo"] = L.dense_init(gen, spec.o_in_dim, d_model, dtype)
        return p
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
    decode layouts: k (B, KV, dh, S) and v (B, KV, S, dh), or an MLA
    layer's latent ckv (B, S, kv_lora) and krope (B, S, rope); None for a
    cross layer, whose memory does not grow."""
    if spec.cross:
        return None
    if spec.kind == "mla":
        return {"ckv": torch.zeros(batch, cache_len, spec.kv_lora_rank,
                                   dtype=dtype, device=device),
                "krope": torch.zeros(batch, cache_len, spec.rope_head_dim,
                                     dtype=dtype, device=device)}
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


def as_position(pos, device) -> torch.Tensor:
    """A decode position as the ``(1,)`` int64 tensor on ``device`` that
    the decode step computes with; a tensor passes through as it is (a
    captured graph reads it from its buffer)."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((1,), pos, dtype=torch.int64, device=device)


def decode_slot(spec: AttentionSpec, pos, cache_len: int):
    """The cache slot that takes position ``pos``: a ring (``pos % S``) for a
    window that fits the cache, else ``min(pos, S - 1)``.  An int gives an
    int; a ``(1,)`` int64 tensor gives one, computed on its device (which
    of the two is a static test on the spec)."""
    ring = spec.window is not None and spec.window <= cache_len
    if isinstance(pos, torch.Tensor):
        return (torch.remainder(pos, cache_len) if ring
                else pos.clamp_max(cache_len - 1))
    return pos % cache_len if ring else min(pos, cache_len - 1)


def _gqa_decode(spec: AttentionSpec, params, x, pos, cache, slot_pos):
    """x: (B, 1, D) at position ``pos`` (a ``(1,)`` int64 tensor or an
    int); cache k (B, KV, dh, S), v (B, KV, S, dh); slot_pos (S,): the
    position each slot holds (-1 = empty).  Returns ``(out, cache)``: the
    cache with ``slots``, its k, v and slot_pos updated in place (the JAX
    step returns new arrays; a copy here would move the whole cache every
    step)."""
    pos = as_position(pos, x.device)
    q, k_new, v_new = _gqa_qkv(spec, params, x)
    posb = pos.expand(x.shape[0], 1)
    if spec.pos_emb == "rope":
        q, k_new = _rope(spec, q, k_new, posb)
    k, v, slots = cache["k"], cache["v"], slot_pos
    slot = decode_slot(spec, pos, k.shape[-1])
    # (B, 1, KV, dh) → a column of k's layout and a row of v's, written at
    # the device slot
    k.index_copy_(3, slot, k_new.permute(0, 2, 3, 1).to(k.dtype))
    v.index_copy_(2, slot, v_new.transpose(1, 2).to(v.dtype))
    slots.index_copy_(0, slot, pos.to(slots.dtype))
    bias = _mask_bias(posb, slots[None, :], causal=spec.causal,
                      window=spec.window, k_valid=(slots >= 0)[None, :])
    out = _decode_sdpa(spec, q, k, v, bias,
                       scale=1.0 / math.sqrt(spec.head_dim))
    out = ops.linear(out.reshape(x.shape[0], 1, -1), params["wo"])
    return out, {"k": k, "v": v, "slots": slots}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_q(spec: AttentionSpec, params, x):
    """x (B, L, D) → (q_nope (B, L, H, nope), q_rope (B, L, H, rope)), both
    views of one product."""
    b, l, _ = x.shape
    if spec.q_lora_rank:
        q = ops.linear(L.rmsnorm(params["q_norm"],
                                 ops.linear(x, params["wq_a"])),
                       params["wq_b"])
    else:
        q = ops.linear(x, params["wq"])
    q = q.reshape(b, l, spec.num_heads,
                  spec.nope_head_dim + spec.rope_head_dim)
    return q[..., :spec.nope_head_dim], q[..., spec.nope_head_dim:]


def _mla_latent(spec: AttentionSpec, params, x, angles):
    """x (B, L, D) → (ckv (B, L, kv_lora) after ``kv_norm``, krope (B, L,
    rope) rotated by ``angles``), both contiguous."""
    kv = ops.linear(x, params["wkv_a"])
    ckv = L.rmsnorm(params["kv_norm"], kv[..., :spec.kv_lora_rank])
    krope = L.apply_rope(kv[..., None, spec.kv_lora_rank:], None,
                         angles=angles)[..., 0, :]
    return ckv, krope


def _mla_full(spec: AttentionSpec, params, x, positions=None):
    """The latent expanded to per-head keys and values, attention through
    the kernel: q = [q_nope | q_rope] and k = [k_nope | krope] (the one
    rotated krope shared by every head), each (B, L, H, nope + rope), over
    v (B, L, H, v_head_dim), causal, at scale 1/√(nope + rope) — the JAX
    package's two score einsums summed, as one product.  Returns ``(out,
    (ckv, krope))``, the prefill cache."""
    b, l, _ = x.shape
    h, nope = spec.num_heads, spec.nope_head_dim
    if positions is None:
        positions = torch.arange(l, device=x.device)[None, :]
    angles = L.rope_angles(positions, spec.rope_head_dim, spec.rope_theta)
    qn, qr = _mla_q(spec, params, x)
    qr = L.apply_rope(qr, positions, angles=angles)
    ckv, krope = _mla_latent(spec, params, x, angles)
    kvb = ops.linear(ckv, params["wkv_b"]).reshape(
        b, l, h, nope + spec.v_head_dim)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kvb[..., :nope],
                   krope[:, :, None, :].expand(b, l, h, spec.rope_head_dim)],
                  dim=-1)
    out = ops.flash_attention(q, k, kvb[..., nope:], causal=True,
                              window=spec.window,
                              scale=1.0 / math.sqrt(nope
                                                    + spec.rope_head_dim))
    out = ops.linear(out.reshape(b, l, spec.o_in_dim), params["wo"])
    return out, (ckv, krope)


def _mla_decode(spec: AttentionSpec, params, x, pos, cache, slot_pos):
    """Absorbed decode: x (B, 1, D) at position ``pos`` (a ``(1,)`` int64
    tensor or an int) attends in the latent space against ckv (B, S,
    kv_lora) and krope (B, S, rope), with ``wkv_b``'s key half folded into
    the query and its value half into the output; slot ``min(pos, S -
    1)``, on the device.  Returns ``(out, cache)``: the cache with
    ``slots``, its leaves updated in place (as :func:`_gqa_decode`)."""
    b = x.shape[0]
    h, nope = spec.num_heads, spec.nope_head_dim
    pos = as_position(pos, x.device)
    posb = pos.expand(b, 1)
    angles = L.rope_angles(posb, spec.rope_head_dim, spec.rope_theta)
    qn, qr = _mla_q(spec, params, x)                 # (B, 1, H, *)
    qr = L.apply_rope(qr, posb, angles=angles)
    ckv_new, kr_new = _mla_latent(spec, params, x, angles)
    ckv, krope, slots = cache["ckv"], cache["krope"], slot_pos
    slot = pos.clamp_max(ckv.shape[1] - 1)
    ckv.index_copy_(1, slot, ckv_new.to(ckv.dtype))
    krope.index_copy_(1, slot, kr_new.to(krope.dtype))
    slots.index_copy_(0, slot, pos.to(slots.dtype))
    wkv_b = params["wkv_b"].reshape(spec.kv_lora_rank, h,
                                    nope + spec.v_head_dim)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
    q_eff = torch.einsum("bqhd,chd->bqhc", qn, wk_b)
    scores = (torch.einsum("bqhc,bsc->bhqs", q_eff, ckv.to(q_eff.dtype))
              + torch.einsum("bqhr,bsr->bhqs", qr, krope.to(qr.dtype))
              ).float()
    scores = scores / math.sqrt(nope + spec.rope_head_dim)
    bias = _mask_bias(posb, slots[None, :], causal=True, window=spec.window,
                      k_valid=(slots >= 0)[None, :])
    p = torch.softmax(scores + bias[:, None, :, :], dim=-1)
    ctx = torch.einsum("bhqs,bsc->bqhc", p.to(ckv.dtype), ckv)
    out = torch.einsum("bqhc,chv->bqhv", ctx.to(qn.dtype), wv_b)
    out = ops.linear(out.reshape(b, 1, spec.o_in_dim), params["wo"])
    return out, {"ckv": ckv, "krope": krope, "slots": slots}


def apply(spec: AttentionSpec, params, x, *, positions=None, mode="full",
          pos=None, cache=None, slot_pos=None, memory=None,
          video_shape=None):
    """Returns ``(out, aux)``: aux is the (k, v) prefill cache — (ckv,
    krope) for MLA — in full mode and the updated cache in decode mode.

    Full mode: attention over x (B, L, D) → (B, L, D) at ``positions``
    ((1, L) or (B, L); default ``arange(L)``), or, for a cross layer, of x
    over ``memory`` (B, Lm, cond_dim).  ``video_shape=(T, S)`` with
    ``spec.pattern`` factorizes self-attention as OpenSora's STDiT does:
    "spatial" attends within each frame, as (B·T, S) with positions
    ``arange(S)``; "temporal" within each spatial location, as (B·S, T)
    with positions ``arange(T)``.  Decode mode: x (B, 1, D) at position
    ``pos`` (a ``(1,)`` int64 tensor or an int) against ``cache`` with ``slot_pos``; a cross layer's
    one row over the whole ``memory``, its cache returned as given (the
    blocks run the cross branch in full mode, which computes the same)."""
    if spec.kind not in ("gqa", "mla"):
        raise ValueError(f"unknown attention kind {spec.kind!r}")
    if spec.kind == "mla":
        if mode == "decode":
            return _mla_decode(spec, params, x, pos, cache, slot_pos)
        if mode != "full":
            raise ValueError(f"unknown attention mode {mode!r}")
        if spec.cross or spec.pattern is not None:
            raise ValueError("MLA is causal self-attention over tokens")
        return _mla_full(spec, params, x, positions)
    if mode == "decode" and spec.cross:
        # the new token's query over the whole memory; nothing is cached
        if memory is None:
            raise ValueError("a cross-attention layer needs memory=")
        return _gqa_full(spec, params, x, memory=memory)[0], cache
    if mode == "decode":
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
