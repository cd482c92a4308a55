"""Residual blocks: norm → mixer [→ post-norm] → +res
[→ norm → cross → +res] [→ norm → ffn [→ post-norm] → +res], with
adaLN-zero (DiT) conditioning and the SmoothCache branch-caching contract.
The post-norms (Gemma-2) come before the branch output is recorded, so a
cached branch is the post-normed one.  The mixer is self-attention (DiT,
OpenSora's spatial / temporal attention, the attention LMs), a Mamba-2
SSD mixer or an RG-LRU (RecurrentGemma); an LM's mixer carries a cache
from a full-sequence pass into the one-token decode (a KV cache, the SSD
state, or the RG-LRU's conv tail and state).  The FFN is an MLP or a
mixture of experts (``moe_strategy``, ``moe_group_size``; its load-balance
loss comes back with ``with_aux=True``).
The cross branch (OpenSora) attends to a conditioning memory, with no
adaLN modulation and no gate.

The contract: every cacheable *branch* (mixer / cross / ffn) produces its
output **before** the residual add and before the adaLN gate, which is
recomputed cheaply on cache hits.  ``apply`` takes ``skip: dict[type →
bool]``: when a branch's type is skipped, its output comes from
``branch_cache`` and the branch is not computed.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import BlockSpec, MoESpec, RGLRUSpec, SSMSpec
from repro_torch.kernels import ops
from repro_torch.models import attention, layers as L, mlp, moe, rglru, ssm


def init(gen: torch.Generator, spec: BlockSpec, d_model: int,
         dtype=torch.float32, adaln_dim: int = 0, cond_dim: int = 0):
    p = {}
    if spec.mixer is not None:
        p["norm1"] = L.norm_init(spec.norm, d_model, dtype)
        if isinstance(spec.mixer, SSMSpec):
            p["mixer"] = ssm.init(gen, spec.mixer, d_model, dtype)
        elif isinstance(spec.mixer, RGLRUSpec):
            p["mixer"] = rglru.init(gen, spec.mixer, d_model, dtype)
        else:
            p["mixer"] = attention.init(gen, spec.mixer, d_model, dtype)
        if spec.post_norm:
            p["post_norm1"] = L.norm_init(spec.norm, d_model, dtype)
    if spec.cross is not None:
        p["norm_x"] = L.norm_init(spec.norm, d_model, dtype)
        p["cross"] = attention.init(gen, spec.cross, d_model, dtype,
                                    cond_dim=cond_dim)
    if spec.ffn is not None:
        p["norm2"] = L.norm_init(spec.norm, d_model, dtype)
        if isinstance(spec.ffn, MoESpec):
            p["ffn"] = moe.init(gen, spec.ffn, d_model, dtype)
        else:
            p["ffn"] = mlp.init(gen, spec.ffn, d_model, dtype)
        if spec.post_norm:
            p["post_norm2"] = L.norm_init(spec.norm, d_model, dtype)
    if spec.adaln:
        # adaLN-zero: cond → 6*d (shift/scale/gate for mixer and ffn)
        p["mod"] = {"w": torch.zeros(adaln_dim, 6 * d_model, dtype=dtype),
                    "b": torch.zeros(6 * d_model, dtype=dtype)}
    return p


def init_cache(spec: BlockSpec, d_model: int, batch: int,
               cache_len: Optional[int] = None, dtype=torch.float32,
               device=None):
    """Decode-time cache of this block (None for a block without a mixer):
    an SSD or RG-LRU state, or a KV cache of ``cache_len`` slots (at most
    the window) whose ``slots`` (S,) hold each slot's position, -1 when
    empty."""
    m = spec.mixer
    if m is None:
        return None
    if isinstance(m, SSMSpec):
        return ssm.init_cache(m, d_model, batch, torch.float32,
                              device=device)
    if isinstance(m, RGLRUSpec):
        return rglru.init_cache(m, d_model, batch, torch.float32,
                                device=device)
    if cache_len is None:
        raise ValueError("an attention block's cache needs cache_len")
    clen = min(cache_len, m.window) if m.window else cache_len
    c = attention.init_cache(m, batch, clen, dtype, device=device)
    if c is not None:
        c["slots"] = torch.full((clen,), -1, dtype=torch.int32,
                                device=device)
    return c


def _modulation(spec: BlockSpec, params, cond):
    if not spec.adaln:
        return None
    m = ops.linear(F.silu(cond), params["mod"]["w"], params["mod"]["b"],
                   rows="requests")
    return torch.chunk(m[:, None, :], 6, dim=-1)  # each (B, 1, d)


def _mod_norm(x_norm, shift, scale):
    return x_norm * (1.0 + scale) + shift


def apply(spec: BlockSpec, params, x, *, mode: str = "full", positions=None,
          pos=None, cache=None, cond=None, skip=None, branch_cache=None,
          memory=None, video_shape=None, moe_strategy: str = "gshard",
          moe_group_size: int = 2048, with_aux: bool = False):
    """Returns ``(x, branch_out, new_cache)``, and the MoE load-balance loss
    (an f32 scalar, 0 without a computed MoE FFN) as a fourth item when
    ``with_aux``.

    branch_out holds the pre-residual, pre-gate outputs of the computed
    branches (the SmoothCache cache content).  new_cache is the mixer's
    cache: built by a full-sequence pass (``mode="full"``; attention's
    (k, v) at ``positions``), advanced by one token at position ``pos`` in
    ``mode="decode"`` from ``cache``.  ``memory`` (B, Lm, cond_dim) feeds
    the cross branch; ``video_shape`` (T, S) the factorized attention.  A
    MoE FFN dispatches by ``moe_strategy`` over groups of
    ``moe_group_size`` tokens (``moe.apply``)."""
    skip = skip or {}
    branch_cache = branch_cache or {}
    mod = _modulation(spec, params, cond)
    branch_out = {}
    new_cache = None
    aux = None
    types = dict(zip(spec.branch_names(), spec.branch_types()))

    if spec.mixer is not None:
        if skip.get(types["mixer"], False):
            out = branch_cache["mixer"]
            new_cache = cache  # state caches only advance when computed
        else:
            h = L.apply_norm(spec.norm, params["norm1"], x)
            if mod is not None:
                h = _mod_norm(h, mod[0], mod[1])
            m, d_model = spec.mixer, x.shape[-1]
            if isinstance(m, SSMSpec) and mode == "full":
                out, new_cache = ssm.apply_full(m, params["mixer"], h, d_model)
            elif isinstance(m, SSMSpec):
                out, new_cache = ssm.apply_decode(m, params["mixer"], h,
                                                  cache, d_model)
            elif isinstance(m, RGLRUSpec) and mode == "full":
                out, new_cache = rglru.apply_full(m, params["mixer"], h,
                                                  d_model)
            elif isinstance(m, RGLRUSpec):
                out, new_cache = rglru.apply_decode(m, params["mixer"], h,
                                                    cache, d_model)
            elif mode == "full":
                out, new_cache = attention.apply(
                    m, params["mixer"], h, positions=positions,
                    video_shape=video_shape)
            else:
                out, new_cache = attention.apply(
                    m, params["mixer"], h, mode="decode", pos=pos,
                    cache={k: v for k, v in cache.items() if k != "slots"},
                    slot_pos=cache["slots"])
            if spec.post_norm:
                out = L.apply_norm(spec.norm, params["post_norm1"], out)
            branch_out["mixer"] = out
        if mod is not None:
            out = out * mod[2]
        x = x + out.to(x.dtype)

    if spec.cross is not None:
        if skip.get(types["cross"], False):
            out = branch_cache["cross"]
        else:
            h = L.apply_norm(spec.norm, params["norm_x"], x)
            out, _ = attention.apply(spec.cross, params["cross"], h,
                                     memory=memory)
            branch_out["cross"] = out
        x = x + out.to(x.dtype)

    if spec.ffn is not None:
        if skip.get(types["ffn"], False):
            out = branch_cache["ffn"]
        else:
            h = L.apply_norm(spec.norm, params["norm2"], x)
            if mod is not None:
                h = _mod_norm(h, mod[3], mod[4])
            if isinstance(spec.ffn, MoESpec):
                out, aux = moe.apply(spec.ffn, params["ffn"], h,
                                     strategy=moe_strategy,
                                     group_size=moe_group_size)
            else:
                out = mlp.apply(spec.ffn, params["ffn"], h)
            if spec.post_norm:
                out = L.apply_norm(spec.norm, params["post_norm2"], out)
            branch_out["ffn"] = out
        if mod is not None:
            out = out * mod[5]
        x = x + out.to(x.dtype)

    if with_aux:
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, branch_out, new_cache, aux
    return x, branch_out, new_cache
