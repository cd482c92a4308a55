"""Residual blocks: norm → mixer → +res [→ norm → ffn → +res], with adaLN-zero
(DiT) conditioning and the SmoothCache branch-caching contract.  The mixer
is self-attention (DiT) or a Mamba-2 SSD mixer, which carries a state cache
from a full-sequence pass into the one-token decode.

The contract: every cacheable *branch* (mixer / ffn) produces its output
**before** the residual add and before the adaLN gate, which is recomputed
cheaply on cache hits.  ``apply`` takes ``skip: dict[type → bool]``: when a
branch's type is skipped, its output comes from ``branch_cache`` and the
branch is not computed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import BlockSpec, SSMSpec
from repro_torch.kernels import ops
from repro_torch.models import attention, layers as L, mlp, ssm


def init(gen: torch.Generator, spec: BlockSpec, d_model: int,
         dtype=torch.float32, adaln_dim: int = 0):
    p = {}
    if spec.mixer is not None:
        p["norm1"] = L.norm_init(spec.norm, d_model, dtype)
        if isinstance(spec.mixer, SSMSpec):
            p["mixer"] = ssm.init(gen, spec.mixer, d_model, dtype)
        else:
            p["mixer"] = attention.init(gen, spec.mixer, d_model, dtype)
    if spec.ffn is not None:
        p["norm2"] = L.norm_init(spec.norm, d_model, dtype)
        p["ffn"] = mlp.init(gen, spec.ffn, d_model, dtype)
    if spec.adaln:
        # adaLN-zero: cond → 6*d (shift/scale/gate for mixer and ffn)
        p["mod"] = {"w": torch.zeros(adaln_dim, 6 * d_model, dtype=dtype),
                    "b": torch.zeros(6 * d_model, dtype=dtype)}
    return p


def init_cache(spec: BlockSpec, d_model: int, batch: int, device=None):
    """Decode-time state cache of this block (None for a block without a
    mixer)."""
    if spec.mixer is None:
        return None
    if isinstance(spec.mixer, SSMSpec):
        return ssm.init_cache(spec.mixer, d_model, batch, torch.float32,
                              device=device)
    raise NotImplementedError("attention decode caches are not ported yet")


def _modulation(spec: BlockSpec, params, cond):
    if not spec.adaln:
        return None
    m = ops.linear(F.silu(cond), params["mod"]["w"], params["mod"]["b"])
    return torch.chunk(m[:, None, :], 6, dim=-1)  # each (B, 1, d)


def _mod_norm(x_norm, shift, scale):
    return x_norm * (1.0 + scale) + shift


def apply(spec: BlockSpec, params, x, *, mode: str = "full", cache=None,
          cond=None, skip=None, branch_cache=None):
    """Returns ``(x, branch_out, new_cache)``.

    branch_out holds the pre-residual, pre-gate outputs of the computed
    branches (the SmoothCache cache content).  new_cache is the mixer's
    state cache: built by a full-sequence pass (``mode="full"``), advanced
    by one token in ``mode="decode"`` from ``cache``; None for attention,
    whose caches are not ported."""
    skip = skip or {}
    branch_cache = branch_cache or {}
    mod = _modulation(spec, params, cond)
    branch_out = {}
    new_cache = None
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
            elif mode == "full":
                out = attention.apply(m, params["mixer"], h)
            else:
                raise NotImplementedError("attention decode is not ported yet")
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

    return x, branch_out, new_cache
