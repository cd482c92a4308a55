"""Plain PyTorch versions of the kernels: what the CPU runs, and what the
CUDA kernels are held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


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
