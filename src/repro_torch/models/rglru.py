"""RG-LRU recurrent mixer from Griffin / RecurrentGemma [arXiv:2402.19427].

Recurrence:  h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)
  a_t = exp(−c · softplus(Λ) · r_t),  r_t = σ(W_a x_t),  i_t = σ(W_x x_t)

Both modes run the recurrence through :func:`repro_torch.kernels.ops.
rglru_scan`: on a CUDA tensor the hand-written Hopper kernel (gates, scan
and the product with the GELU branch in one launch), on a CPU tensor its
plain PyTorch version.  The decode step is the same scan at L = 1 from the
cached state.  Every product goes through :func:`ops.linear`; the gate
projections W_a / W_x are block-diagonal over ``num_heads`` blocks, one
product per head on that head's (hd, hd) block.  A state cache is a dict
``{"conv": (B, K-1, W), "h": (B, W) f32}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import RGLRUSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def width(spec: RGLRUSpec, d_model: int) -> int:
    return spec.expand * d_model


def init(gen: torch.Generator, spec: RGLRUSpec, d_model: int,
         dtype=torch.float32):
    w = width(spec, d_model)
    hd = w // spec.num_heads
    dev = gen.device
    in_x = L.dense_init(gen, d_model, w, dtype)
    in_gate = L.dense_init(gen, d_model, w, dtype)
    # Λ init so that a^c = exp(-c softplus Λ) is in [0.9, 0.999] at r=1
    u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * torch.rand(
        w, generator=gen, dtype=torch.float32, device=dev)
    a_param = torch.log(torch.expm1(-torch.log(u) / (2 * spec.c_constant)))
    blocks = []
    for _ in range(2):
        blk = torch.empty(spec.num_heads, hd, hd, dtype=torch.float32,
                          device=dev)
        torch.nn.init.trunc_normal_(blk, 0.0, 1.0, -2.0, 2.0, generator=gen)
        blocks.append((blk / math.sqrt(hd)).to(dtype))
    conv_w = (torch.randn(spec.conv_width, w, generator=gen,
                          dtype=torch.float32, device=dev)
              / math.sqrt(spec.conv_width)).to(dtype)
    return {
        "in_x": in_x,
        "in_gate": in_gate,
        "conv_w": conv_w,
        "conv_b": torch.zeros(w, dtype=dtype),
        "wa": blocks[0], "ba": torch.zeros(w, dtype=dtype),
        "wx": blocks[1], "bx": torch.zeros(w, dtype=dtype),
        "a_param": a_param,
        "out": L.dense_init(gen, w, d_model, dtype),
    }


def init_cache(spec: RGLRUSpec, d_model: int, batch: int,
               dtype=torch.float32, device=None):
    w = width(spec, d_model)
    return {
        "conv": torch.zeros(batch, spec.conv_width - 1, w, dtype=dtype,
                            device=device),
        "h": torch.zeros(batch, w, dtype=torch.float32, device=device),
    }


def _block_diag(spec: RGLRUSpec, params, xr):
    """The two gate products with their biases, xr (B, L, W) → (ga, gx),
    each (B, L, W): per head h, ``xr_h @ w[h] + b_h`` with w as (in, out),
    one :func:`ops.linear` on the view ``w[h]`` (its own prepared halves on
    a card).  The heads' columns are gathered once into a contiguous
    (heads, B·L, hd); ga and gx come back as views of one (B, L, 2W)."""
    nh = spec.num_heads
    b, l, w = xr.shape
    hd = w // nh
    xh = xr.reshape(b * l, nh, hd).transpose(0, 1).contiguous()
    outs = [ops.linear(xh[h], params[name][h],
                       params[bias][h * hd:(h + 1) * hd])
            for name, bias in (("wa", "ba"), ("wx", "bx"))
            for h in range(nh)]
    g = torch.cat(outs, dim=-1).reshape(b, l, 2 * w)
    return g[..., :w], g[..., w:]


def _conv(params, win, length: int):
    """Depthwise causal conv of the last ``length`` steps over ``win`` (B,
    length + K - 1, W), the K - 1 steps before them first; no
    activation."""
    w = params["conv_w"]
    return sum(win[:, i: i + length, :] * w[i]
               for i in range(w.shape[0])) + params["conv_b"]


def _causal_conv(params, x):
    """x: (B, L, W), zeros before the first step."""
    k = params["conv_w"].shape[0]
    return _conv(params, F.pad(x, (0, 0, k - 1, 0)), x.shape[1])


def _scan(spec: RGLRUSpec, params, xr, gate, h0=None):
    ga, gx = _block_diag(spec, params, xr)
    return ops.rglru_scan(xr, ga, gx, gate, params["a_param"],
                          spec.c_constant, h0)


def apply_full(spec: RGLRUSpec, params, x, d_model: int):
    """x: (B, L, D) → (B, L, D), and the final cache {"conv", "h"}.  The
    conv cache is the last K - 1 steps of the conv's input, zero-padded on
    the left when L < K - 1, as the causal conv pads: a 1- or 2-token
    prompt decodes as the full pass would (the JAX package keeps only L
    rows there, and its decode step then fails)."""
    gate = L.gelu_tanh(ops.linear(x, params["in_gate"]).float())
    xr = ops.linear(x, params["in_x"])
    k = spec.conv_width
    conv_tail = F.pad(xr[:, -(k - 1):, :],
                      (0, 0, max(0, k - 1 - xr.shape[1]), 0))
    xr = _causal_conv(params, xr)
    y, hT = _scan(spec, params, xr, gate)
    return (ops.linear(y.to(x.dtype), params["out"]),
            {"conv": conv_tail, "h": hT})


def apply_decode(spec: RGLRUSpec, params, x, cache, d_model: int):
    """x: (B, 1, D); cache {"conv": (B, K-1, W), "h": (B, W) f32}."""
    gate = L.gelu_tanh(ops.linear(x, params["in_gate"]).float())  # (B,1,W)
    xr = ops.linear(x, params["in_x"])
    win = torch.cat([cache["conv"], xr], dim=1)                  # (B,K,W)
    y, h = _scan(spec, params, _conv(params, win, 1), gate, cache["h"])
    return (ops.linear(y.to(x.dtype), params["out"]),
            {"conv": win[:, 1:, :], "h": h})
