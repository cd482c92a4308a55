"""Primitive layers: norms, activations, RoPE, embeddings, linear init.

Parameters are plain tensors in the JAX package's layout: a dense weight is
``(in, out)`` and applied as ``x @ w``."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Init (drawn from an explicit generator on its device; callers move the
# tree)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None):
    """Truncated-normal fan-in init (±2σ), σ = 1/√in_dim unless given."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.empty(in_dim, out_dim, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32):
    w = torch.randn(vocab, dim, generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.02
    return w.to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32):
    return {"scale": torch.zeros(d, dtype=dtype)}   # gemma-style (1+scale)


def layernorm_init(d: int, dtype=torch.float32):
    return {"scale": torch.ones(d, dtype=dtype),
            "bias": torch.zeros(d, dtype=dtype)}


def norm_init(kind: str, d: int, dtype=torch.float32):
    return rmsnorm_init(d, dtype) if kind == "rmsnorm" else layernorm_init(d, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x, eps: float = 1e-6):
    """``x · rsqrt(mean(x²) + eps) · (1 + scale)``: statistics in f32,
    scaling in the stream dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + params["scale"]).to(x.dtype)


def layernorm(params, x, eps: float = 1e-6):
    """Statistics in f32, normalization in the stream dtype (not plain
    ``F.layer_norm``, which would normalize in f32 too)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mu.to(x.dtype)) * inv
    return out * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def apply_norm(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    """The JAX package's activations: its ``"gelu"`` is ``jax.nn.gelu``,
    whose default is the tanh approximation, as ``"gelu_tanh"``."""
    return {"silu": F.silu, "gelu": gelu_tanh, "gelu_tanh": gelu_tanh,
            "relu": F.relu}[name]


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """Inverse frequencies ``θ^(−2i/head_dim)``, (head_dim/2,) float32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """(cos, sin) of the rotation angles, each (..., L, 1, head_dim/2)
    float32; positions: (..., L).  Built once and shared by q and k."""
    inv = rope_freqs(head_dim, theta, positions.device)  # (dh/2,)
    ang = positions[..., :, None].float() * inv         # (..., L, dh/2)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x, positions, theta: float = 10000.0, angles=None):
    """x: (..., L, H, Dh) rotated half-split style in float32; positions:
    (..., L).  ``angles`` is :func:`rope_angles`' result for these
    positions, if the caller has it already."""
    cos, sin = angles or rope_angles(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Positional / timestep embeddings
# ---------------------------------------------------------------------------

def sinusoidal_embedding(positions, dim: int, max_period: float = 10000.0):
    """positions: (...,) → (..., dim), cos half first then sin half.  Also
    used for diffusion timesteps."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = positions[..., None].float() * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
