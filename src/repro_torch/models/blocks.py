"""Residual blocks: norm → mixer → +res → norm → ffn → +res, with adaLN-zero
(DiT) conditioning and the SmoothCache branch-caching contract.

The contract: every cacheable *branch* (mixer / ffn) produces its output
**before** the residual add and before the adaLN gate, which is recomputed
cheaply on cache hits.  ``apply`` takes ``skip: dict[type → bool]``: when a
branch's type is skipped, its output comes from ``branch_cache`` and the
branch is not computed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import BlockSpec
from repro_torch.models import attention, layers as L, mlp


def init(gen: torch.Generator, spec: BlockSpec, d_model: int,
         dtype=torch.float32, adaln_dim: int = 0):
    p = {}
    if spec.mixer is not None:
        p["norm1"] = L.layernorm_init(d_model, dtype)
        p["mixer"] = attention.init(gen, spec.mixer, d_model, dtype)
    if spec.ffn is not None:
        p["norm2"] = L.layernorm_init(d_model, dtype)
        p["ffn"] = mlp.init(gen, spec.ffn, d_model, dtype)
    if spec.adaln:
        # adaLN-zero: cond → 6*d (shift/scale/gate for mixer and ffn)
        p["mod"] = {"w": torch.zeros(adaln_dim, 6 * d_model, dtype=dtype),
                    "b": torch.zeros(6 * d_model, dtype=dtype)}
    return p


def _modulation(spec: BlockSpec, params, cond):
    if not spec.adaln:
        return None
    m = F.silu(cond) @ params["mod"]["w"] + params["mod"]["b"]
    return torch.chunk(m[:, None, :], 6, dim=-1)  # each (B, 1, d)


def _mod_norm(x_norm, shift, scale):
    return x_norm * (1.0 + scale) + shift


def apply(spec: BlockSpec, params, x, *, cond=None, skip=None,
          branch_cache=None):
    """Returns ``(x, branch_out)``: branch_out holds the pre-residual,
    pre-gate outputs of the computed branches (the SmoothCache cache
    content)."""
    skip = skip or {}
    branch_cache = branch_cache or {}
    mod = _modulation(spec, params, cond)
    branch_out = {}
    types = dict(zip(spec.branch_names(), spec.branch_types()))

    if spec.mixer is not None:
        if skip.get(types["mixer"], False):
            out = branch_cache["mixer"]
        else:
            h = L.apply_norm(spec.norm, params["norm1"], x)
            if mod is not None:
                h = _mod_norm(h, mod[0], mod[1])
            out = attention.apply(spec.mixer, params["mixer"], h)
            branch_out["mixer"] = out
        if mod is not None:
            out = out * mod[2]
        x = x + out.to(x.dtype)

    if spec.ffn is not None:
        if skip.get(types["ffn"], False):
            out = branch_cache["ffn"]
        else:
            h = L.apply_norm(spec.norm, params["norm2"], x)
            if mod is not None:
                h = _mod_norm(h, mod[3], mod[4])
            out = mlp.apply(spec.ffn, params["ffn"], h)
            branch_out["ffn"] = out
        if mod is not None:
            out = out * mod[5]
        x = x + out.to(x.dtype)

    return x, branch_out
