"""Plain PyTorch versions of the kernels: what the CPU runs, and what the
CUDA kernels are held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def linear_ref(x, w, b=None):
    """``x @ w`` (+ ``b``), the bias added to the finished product."""
    y = x @ w
    return y if b is None else y + b


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q: (B, Lq, H, D); k, v: (B, Lk, KV, D) with H % KV == 0.
    Full-precision softmax attention: f32 scores and softmax, the
    probabilities cast to v's dtype for the value product."""
    b, lq, h, d = q.shape
    lk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = q.reshape(b, lq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr, k).float() * scale
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
    return out.reshape(b, lq, h, d)


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
    hprev = (torch.zeros(bs, h, p, n, dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    hprevs = []
    for z in range(nc):
        hprevs.append(hprev)
        hprev = (hprev * chunk_decay[:, z, :, None, None]
                 + states[:, z].float())
    hprevs = torch.stack(hprevs, dim=1)                    # (B,nc,H,P,N)

    # 4. inter-chunk output: y += C · h_prev · decay from the chunk start
    decay_in = torch.exp(cum)                              # (B,nc,Q,H)
    y = y + torch.einsum("bzqhn,bzhpn,bzqh->bzqhp", cc, hprevs.to(cdt),
                         decay_in.to(cdt))
    return y.reshape(bs, l, h, p), hprev


def ssd_ref(x, dt, a, b, c, chunk: int = 64, h0=None):
    """The SSD kernel's function in plain PyTorch: every input taken to f32,
    chunk = min(chunk, L), y returned in x's dtype and the final state in
    f32.  The CPU runs it, and the CUDA kernel is held against it."""
    l = x.shape[1]
    y, hT = ssd_chunked(x.float(), dt.float(), a.float(), b.float(),
                        c.float(), min(chunk, l), h0)
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
