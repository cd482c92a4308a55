"""Plain PyTorch versions of the kernels: what the CPU runs, and what the
CUDA kernels are held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def wide(t):
    """t in f32, or in f64 when it is f64: the plain versions compute in at
    least f32, and an f64 input keeps f64 (a gradient check's)."""
    return t if t.dtype == torch.float64 else t.float()


def linear_ref(x, w, b=None):
    """``x @ w`` (+ ``b``), the bias added to the finished product."""
    y = x @ w
    return y if b is None else y + b


def tf32_round(v):
    """v (f32) rounded to TF32 (10 mantissa bits, the low 13 bits zero),
    to nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds any
    non-NaN: ``gemm.cu``'s ``split`` adds 0x1000 to the bits and masks.  A
    finite value past the largest TF32 one rounds to ±inf."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).reshape(v.shape)


def tf32_split(v):
    """v = big + small, both TF32: big = ``tf32_round(v)``, small =
    ``tf32_round(v - big)`` (the kernel's ``cvt.rna`` of the rest)."""
    big = tf32_round(v)
    return big, tf32_round(v - big)


def split_tf32_t(w):
    """The token kernel's prepared weight: w (K, N) split as
    ``tf32_split`` does, each half transposed to a contiguous (N, K), the
    K-major operand ``wgmma`` reads."""
    big, small = tf32_split(w)
    return big.t().contiguous(), small.t().contiguous()


def linear_3xtf32(x, w, b=None):
    """The token kernel's arithmetic in plain f32: per k8 slice of K, in
    ascending order, small_x @ big_w, big_x @ small_w, big_x @ big_w added
    to the sum in that order; the bias added to the finished sum.  Each
    8-term product of TF32 values is summed by the CPU's f32 matmul, not in
    the tensor core's order: the bits differ, the error budget does not."""
    xb, xs = tf32_split(x)
    wb, ws = tf32_split(w)
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], 8):
        s = slice(k0, k0 + 8)
        acc = acc + xs[:, s] @ wb[s]
        acc = acc + xb[:, s] @ ws[s]
        acc = acc + xb[:, s] @ wb[s]
    return acc if b is None else acc + b


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q: (B, Lq, H, D); k: (B, Lk, KV, D); v: (B, Lk, KV, Dv) with H % KV
    == 0 → (B, Lq, H, Dv).  Full-precision softmax attention: f32 scores
    and softmax, the probabilities cast to v's dtype for the value
    product."""
    b, lq, h, d = q.shape
    lk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = q.reshape(b, lq, kv, g, d)
    scores = wide(torch.einsum("bqkgd,bskd->bkgqs", qr, k)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(lk, device=q.device)[None, :]
    ok = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, lq, h, v.shape[-1])


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan
# ---------------------------------------------------------------------------

def segsum(x):
    """x: (..., L) → (..., L, L) segment sums: out[q, s] = Σ_{s<i≤q} x_i
    (−inf above the diagonal)."""
    l = x.shape[-1]
    # row i carries x_i; cumsum down rows gives Σ_{i≤q, i>s} x_i at [q, s]
    x = x[..., :, None].expand(*x.shape, l)
    keep = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device), -1)
    out = torch.cumsum(torch.where(keep, x, 0.0), dim=-2)
    keep = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
    return torch.where(keep, out, -math.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """SSD scan, chunked: quadratic within a chunk, a linear recurrence
    across chunks.

    x: (B, L, H, P) inputs; dt: (B, L, H) positive step sizes;
    a: (H,) positive decay rates (state decay = exp(-dt·a));
    b, c: (B, L, G, N) input/output projections (G groups broadcast to H);
    h0: optional (B, H, P, N) initial state.
    Returns (y (B, L, H, P), h_final (B, H, P, N) f32).  A ragged L is
    padded with dt = 0 steps (decay 1, zero input: state-neutral).
    """
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if l % chunk:
        pad = chunk - l % chunk
        x, b, c = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (x, b, c))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        y, hT = ssd_chunked(x, dt, a, b, c, chunk, h0)
        return y[:, :l], hT
    nc = l // chunk
    rep = h // g
    cdt = c.dtype

    da = -dt * a[None, None, :]                            # (B,L,H) log decay
    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    dac = da.reshape(bs, nc, chunk, h)
    bc = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    # 1. intra-chunk (quadratic) term
    decay = torch.exp(segsum(dac.permute(0, 1, 3, 2)))     # (B,nc,H,Q,Q)
    scores = torch.einsum("bzqhn,bzshn->bzhqs", cc, bc) * decay.to(cdt)
    y = torch.einsum("bzhqs,bzsh,bzshp->bzqhp", scores, dtc.to(cdt), xc)

    # 2. chunk-final states
    cum = torch.cumsum(dac, dim=2)                         # (B,nc,Q,H)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bzqhn,bzqh,bzqhp->bzhpn", bc,
                          (dtc * decay_end).to(cdt), xc)

    # 3. inter-chunk recurrence: h_z = exp(Σ da_z)·h_{z-1} + S_z
    chunk_decay = torch.exp(dac.sum(dim=2))                # (B,nc,H)
    hprev = (torch.zeros(bs, h, p, n, dtype=x.dtype, device=x.device)
             if h0 is None else h0)
    hprevs = []
    for z in range(nc):
        hprevs.append(hprev)
        hprev = (hprev * chunk_decay[:, z, :, None, None]
                 + wide(states[:, z]))
    hprevs = torch.stack(hprevs, dim=1)                    # (B,nc,H,P,N)

    # 4. inter-chunk output: y += C · h_prev · decay from the chunk start
    decay_in = torch.exp(cum)                              # (B,nc,Q,H)
    y = y + torch.einsum("bzqhn,bzhpn,bzqh->bzqhp", cc, hprevs.to(cdt),
                         decay_in.to(cdt))
    return y.reshape(bs, l, h, p), hprev


def ssd_ref(x, dt, a, b, c, chunk: int = 64, h0=None):
    """The SSD kernel's function in plain PyTorch: every input taken to f32
    (f64 kept), chunk = min(chunk, L), y returned in x's dtype and the
    final state in f32.  The CPU runs it, and the CUDA kernel is held
    against it."""
    l = x.shape[1]
    y, hT = ssd_chunked(wide(x), wide(dt), wide(a), wide(b), wide(c),
                        min(chunk, l), h0)
    return y.to(x.dtype), hT


def ssd_sequential_ref(x, dt, a, b, c):
    """O(L) sequential recurrence — an independent second oracle."""
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    bh = b.repeat_interleave(rep, dim=2).float()
    ch = c.repeat_interleave(rep, dim=2).float()
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(-dtf * a[None, None, :])             # (B,L,H)
    state = torch.zeros(bs, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def softplus(x):
    """``log(1 + exp(x))`` as ``jnp.logaddexp(x, 0)`` computes it (no
    linear branch)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def rglru_gates(xr, ga, gx, a_param, c: float):
    """The RG-LRU's per-step decay and input, in f32: ``log_a = −c ·
    softplus(Λ) · σ(ga)`` and ``gated = √max(1 − exp(2·log_a), 1e−12) ·
    σ(gx) · xr``, with ga and gx the gate products with their biases."""
    r = torch.sigmoid(wide(ga))
    i = torch.sigmoid(wide(gx))
    log_a = -c * softplus(wide(a_param)) * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * i * wide(xr)
    return log_a, gated


def rglru_scan_ref(xr, ga, gx, gate, a_param, c: float, h0=None):
    """The RG-LRU scan kernel's function in plain PyTorch.  xr, ga, gx,
    gate: (B, L, W) — the conv output, the two gate products with their
    biases, the GELU branch; a_param: (W,) Λ; h0: optional (B, W) f32
    state.  ``h_t = a_t·h_{t−1} + gated_t`` from ``h0`` (zero when None),
    ``a_t = exp(log_a_t)`` (:func:`rglru_gates`).  Returns (y = h ⊙ gate
    (B, L, W) f32, hT (B, W) f32).  The recurrence runs as a doubling scan
    (log₂ L passes of the combine ``(a₁a₂, b₁a₂ + b₂)``), so that L 3072
    takes 12 passes and not 3072 steps."""
    log_a, h = rglru_gates(xr, ga, gx, a_param, c)
    a = torch.exp(log_a)
    if h0 is not None:
        h = h.clone()
        h[:, 0] = a[:, 0] * wide(h0) + h[:, 0]
    d, l = 1, h.shape[1]
    while d < l:
        nh, na = h.clone(), a.clone()
        nh[:, d:] = h[:, :-d] * a[:, d:] + h[:, d:]
        na[:, d:] = a[:, :-d] * a[:, d:]
        h, a = nh, na
        d *= 2
    return h * wide(gate), h[:, -1]


def rglru_scan_chunked_ref(xr, ga, gx, gate, a_param, c: float, h0=None,
                           chunk: int = 32):
    """The RG-LRU scan as the kernel (``rglru.cu``) decomposes it, in plain
    PyTorch; the function of :func:`rglru_scan_ref`.  L is cut into chunks
    of ``chunk`` steps (the last padded with a = 1 and no input, which keep
    h): each chunk's product of a and its end state from h = 0; the
    carries in chunk order from ``h0`` (zero when None), carry₍c+1₎ =
    prod_c · carry_c + end_c; then each chunk's steps again from its
    carry.  Returns (y (B, L, W) f32, hT (B, W) f32)."""
    log_a, g = rglru_gates(xr, ga, gx, a_param, c)
    a = torch.exp(log_a)
    bs, l, w = a.shape
    n = -(-l // chunk)
    pad = n * chunk - l
    a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    g = torch.nn.functional.pad(g, (0, 0, 0, pad))
    a, g = a.view(bs, n, chunk, w), g.view(bs, n, chunk, w)
    prod = torch.ones(bs, n, w, device=a.device)
    end = torch.zeros(bs, n, w, device=a.device)
    for t in range(chunk):
        end = a[:, :, t] * end + g[:, :, t]
        prod = prod * a[:, :, t]
    carry = [torch.zeros(bs, w, device=a.device) if h0 is None
             else h0.float()]
    for k in range(n - 1):
        carry.append(prod[:, k] * carry[-1] + end[:, k])
    h, hs = torch.stack(carry, 1), []
    for t in range(chunk):
        h = a[:, :, t] * h + g[:, :, t]
        hs.append(h)
    h = torch.stack(hs, 2).reshape(bs, n * chunk, w)[:, :l]
    return h * gate.float(), h[:, -1]
