"""Mamba-2 mixer (SSD — state-space duality) [arXiv:2405.21060].

Full-sequence mode runs the chunked SSD scan through
:func:`repro_torch.kernels.ops.ssd`: on a CUDA tensor that is the
hand-written Hopper kernel, on a CPU tensor its plain PyTorch version.
There is no ``use_kernel`` switch.  Decode mode is the O(1) recurrent state
update in plain PyTorch, as in the JAX package.  A state cache is a dict
``{"conv": (B, K-1, C), "ssm": (B, H, P, N) f32}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import SSMSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ref import softplus
from repro_torch.models import layers as L


def dims(spec: SSMSpec, d_model: int):
    d_inner = spec.expand * d_model
    n_heads = d_inner // spec.head_dim
    conv_ch = d_inner + 2 * spec.n_groups * spec.d_state
    return d_inner, n_heads, conv_ch


def init(gen: torch.Generator, spec: SSMSpec, d_model: int,
         dtype=torch.float32):
    d_inner, n_heads, conv_ch = dims(spec, d_model)
    in_dim = 2 * d_inner + 2 * spec.n_groups * spec.d_state + n_heads
    lo, hi = spec.a_init_range

    def log_uniform(n, a, b):
        u = torch.rand(n, generator=gen, dtype=torch.float32,
                       device=gen.device)
        return torch.exp(math.log(a) + u * (math.log(b) - math.log(a)))

    in_proj = L.dense_init(gen, d_model, in_dim, dtype)
    conv_w = (torch.randn(spec.d_conv, conv_ch, generator=gen,
                          dtype=torch.float32, device=gen.device)
              / math.sqrt(spec.d_conv)).to(dtype)
    a = log_uniform(n_heads, lo, hi)
    # dt bias ~ softplus^{-1}(dt) for dt in [1e-3, 1e-1]
    dt = log_uniform(n_heads, 1e-3, 1e-1)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=dtype),
        "a_log": torch.log(a),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "d_skip": torch.ones(n_heads, dtype=torch.float32),
        "out_norm": L.rmsnorm_init(d_inner, dtype),
        "out_proj": L.dense_init(gen, d_inner, d_model, dtype),
    }


def init_cache(spec: SSMSpec, d_model: int, batch: int, dtype=torch.float32,
               device=None):
    d_inner, n_heads, conv_ch = dims(spec, d_model)
    return {
        "conv": torch.zeros(batch, spec.d_conv - 1, conv_ch, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(batch, n_heads, spec.head_dim, spec.d_state,
                           dtype=torch.float32, device=device),
    }


def _split(spec: SSMSpec, d_model: int, zxbcdt):
    """(…, in_dim) → z (…, d_inner), xbc (…, conv_ch), dt (…, n_heads)."""
    d_inner, n_heads, conv_ch = dims(spec, d_model)
    return torch.split(zxbcdt, [d_inner, conv_ch, n_heads], dim=-1)


def _causal_conv(params, xbc):
    """Depthwise causal conv over time, then silu. xbc: (B, L, C)."""
    w = params["conv_w"]                                  # (K, C)
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + params["conv_b"])


def ssd_decode_step(xt, dtt, a, bt, ct, state):
    """One-token recurrence. xt: (B,H,P); dtt: (B,H); bt/ct: (B,G,N);
    state: (B,H,P,N) fp32. Returns (yt, new_state)."""
    h = xt.shape[1]
    rep = h // bt.shape[1]
    bth = bt.repeat_interleave(rep, dim=1)
    cth = ct.repeat_interleave(rep, dim=1)
    decay = torch.exp(-dtt * a[None, :])[..., None, None]  # (B,H,1,1)
    upd = torch.einsum("bhp,bhn,bh->bhpn", xt.float(), bth.float(), dtt)
    state = state * decay + upd
    yt = torch.einsum("bhpn,bhn->bhp", state, cth.float())
    return yt.to(xt.dtype), state


def apply_full(spec: SSMSpec, params, x, d_model: int):
    """x: (B, L, D) → (B, L, D), and the final cache {"conv", "ssm"}."""
    b, l, _ = x.shape
    d_inner, n_heads, _ = dims(spec, d_model)
    gn = spec.n_groups * spec.d_state
    z, xbc, dt = _split(spec, d_model, x @ params["in_proj"])
    # a copy, so that the cache does not keep the whole projection alive
    conv_tail = xbc[:, -(spec.d_conv - 1):, :].clone()
    xbc = _causal_conv(params, xbc)
    xs, bmat, cmat = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(b, l, n_heads, spec.head_dim)
    bmat = bmat.reshape(b, l, spec.n_groups, spec.d_state)
    cmat = cmat.reshape(b, l, spec.n_groups, spec.d_state)
    dt = softplus(dt.float() + params["dt_bias"])
    a = torch.exp(params["a_log"])
    y, hT = ops.ssd(xs, dt, a, bmat, cmat, chunk=spec.chunk)
    y = y + xs * params["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(b, l, d_inner)
    y = L.rmsnorm(params["out_norm"], y * F.silu(z))
    return y @ params["out_proj"], {"conv": conv_tail, "ssm": hT}


def apply_decode(spec: SSMSpec, params, x, cache, d_model: int):
    """x: (B, 1, D); cache {"conv": (B,K-1,C), "ssm": (B,H,P,N)}."""
    b = x.shape[0]
    d_inner, n_heads, _ = dims(spec, d_model)
    gn = spec.n_groups * spec.d_state
    z, xbc, dt = _split(spec, d_model, x @ params["in_proj"])   # (B,1,*)
    win = torch.cat([cache["conv"], xbc], dim=1)                # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", win, params["conv_w"])
    conv_out = F.silu(conv_out + params["conv_b"])
    xs, bmat, cmat = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(b, n_heads, spec.head_dim)
    bmat = bmat.reshape(b, spec.n_groups, spec.d_state)
    cmat = cmat.reshape(b, spec.n_groups, spec.d_state)
    dtt = softplus(dt[:, 0].float() + params["dt_bias"])
    a = torch.exp(params["a_log"])
    yt, state = ssd_decode_step(xs, dtt, a, bmat, cmat, cache["ssm"])
    yt = yt + xs * params["d_skip"][None, :, None].to(xs.dtype)
    y = yt.reshape(b, 1, d_inner)
    y = L.rmsnorm(params["out_norm"], y * F.silu(z))
    return y @ params["out_proj"], {"conv": win[:, 1:, :], "ssm": state}
