"""Analytic MACs / FLOPs of an architecture config.

A copy of the JAX package's ``repro.utils.flops`` over the port's own
config dataclasses, with its formulas and their order of summation, so
that each function returns the same float.  It gives the TMACs columns of
the paper's Tables 1–3 (``sampler_tmacs``) and the analytic side of the
counted-vs-analytic check of ``launch/op_analysis.py``.  MACs are
multiply-accumulates (the paper's unit); FLOPs = 2·MACs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.config import (AttentionSpec, BlockSpec, ModelConfig,
                                MoESpec, SSMSpec)


def attn_macs(spec: AttentionSpec, d_model: int, lq: int, lk: int,
              cond_dim: int = 0) -> float:
    """Per-sequence MACs of one attention layer (projections + scores)."""
    if spec.kind == "mla":
        h = spec.num_heads
        qd = h * (spec.nope_head_dim + spec.rope_head_dim)
        m = 0.0
        if spec.q_lora_rank:
            m += lq * d_model * spec.q_lora_rank + lq * spec.q_lora_rank * qd
        else:
            m += lq * d_model * qd
        m += lk * d_model * (spec.kv_lora_rank + spec.rope_head_dim)
        m += lk * spec.kv_lora_rank * h * (spec.nope_head_dim + spec.v_head_dim)
        eff_lk = min(lk, spec.window) if spec.window else lk
        m += h * lq * eff_lk * (spec.nope_head_dim + spec.rope_head_dim)  # scores
        m += h * lq * eff_lk * spec.v_head_dim                            # AV
        m += lq * h * spec.v_head_dim * d_model                           # out
        return m
    h, kv, dh = spec.num_heads, spec.num_kv_heads, spec.head_dim
    kv_in = cond_dim if (spec.cross and cond_dim) else d_model
    m = lq * d_model * h * dh                 # q proj
    m += 2 * lk * kv_in * kv * dh             # k, v proj
    eff_lk = min(lk, spec.window) if (spec.window and not spec.cross) else lk
    m += h * lq * eff_lk * dh * 2             # scores + AV
    m += lq * h * dh * d_model                # out proj
    return m


def ffn_macs(spec, d_model: int, l: int) -> float:
    """MACs of one FFN over ``l`` tokens (a MoE FFN: top-k routed experts,
    the router and the shared experts a token)."""
    if isinstance(spec, MoESpec):
        per_tok = d_model * spec.d_ff * (3 if spec.gated else 2) * spec.top_k
        per_tok += d_model * spec.num_experts     # router
        if spec.num_shared:
            fs = spec.d_ff_shared or spec.d_ff * spec.num_shared
            per_tok += d_model * fs * (3 if spec.gated else 2)
        return l * per_tok
    return l * d_model * spec.d_ff * (3 if spec.gated else 2)


def mixer_macs(spec, d_model: int, lq: int, lk: int) -> float:
    """MACs of one mixer: attention, Mamba-2's SSD or the RG-LRU."""
    if isinstance(spec, AttentionSpec):
        return attn_macs(spec, d_model, lq, lk)
    if isinstance(spec, SSMSpec):
        d_inner = spec.expand * d_model
        n_heads = d_inner // spec.head_dim
        gn = spec.n_groups * spec.d_state
        in_dim = 2 * d_inner + 2 * gn + n_heads
        m = lq * d_model * in_dim
        m += lq * (d_inner + 2 * gn) * spec.d_conv          # conv
        # SSD: intra-chunk (L·Q·(N+P)) + states (L·N·P)
        q = spec.chunk
        m += lq * q * n_heads * (spec.d_state + spec.head_dim)
        m += 2 * lq * n_heads * spec.head_dim * spec.d_state
        m += lq * d_inner * d_model                         # out proj
        return m
    # RG-LRU
    w = spec.expand * d_model
    hd = w // spec.num_heads
    m = 2 * lq * d_model * w                # in_x + gate
    m += lq * w * spec.conv_width
    m += 2 * lq * w * hd                    # block-diag gates
    m += lq * w * 4                         # recurrence elementwise
    m += lq * w * d_model                   # out
    return m


def block_macs_by_branch(b: BlockSpec, d_model: int, lq: int, lk: int,
                         cond_dim: int, cond_len: int) -> Dict[str, float]:
    """MACs of one block by SmoothCache layer type."""
    out = {}
    for name, t in zip(b.branch_names(), b.branch_types()):
        if name == "mixer":
            out[t] = out.get(t, 0.0) + mixer_macs(b.mixer, d_model, lq, lk)
        elif name == "cross":
            out[t] = out.get(t, 0.0) + attn_macs(b.cross, d_model, lq,
                                                 cond_len, cond_dim)
        else:
            out[t] = out.get(t, 0.0) + ffn_macs(b.ffn, d_model, lq)
    return out


def model_macs_by_type(cfg: ModelConfig, seq_len: int, *,
                       cond_len: int = 64,
                       video_shape=None) -> Dict[str, float]:
    """Per-forward-pass MACs per SmoothCache layer type (one sample).

    Factorized video attention (OpenSora): a "spatial" mixer runs T
    independent length-S sequences, a "temporal" one runs S of length T;
    all other branches see the full T·S tokens."""
    total: Dict[str, float] = {}
    for st in cfg.stages:
        for b in st.unit:
            macs = block_macs_by_branch(b, cfg.d_model, seq_len, seq_len,
                                        cfg.cond_dim, cond_len)
            if (isinstance(b.mixer, AttentionSpec) and b.mixer.pattern
                    and video_shape):
                t, s = video_shape
                mixer_t = b.branch_types()[0]
                if b.mixer.pattern == "spatial":
                    macs[mixer_t] = t * mixer_macs(b.mixer, cfg.d_model, s, s)
                else:
                    macs[mixer_t] = s * mixer_macs(b.mixer, cfg.d_model, t, t)
            for k, v in macs.items():
                total[k] = total.get(k, 0.0) + st.repeat * v
    return total


def non_block_macs(cfg: ModelConfig, seq_len: int) -> float:
    """Embedding / head / patch machinery (the non-cacheable remainder)."""
    m = 0.0
    if cfg.task == "lm":
        m += seq_len * cfg.d_model * cfg.vocab_size * max(1, cfg.num_codebooks)
    else:
        tok_dim = math.prod(cfg.latent_shape[-1:]) * cfg.patch ** 2
        m += 2 * seq_len * cfg.d_model * tok_dim
        m += cfg.d_model * cfg.d_model * 2          # t-embed MLP etc.
    return m


def sampler_tmacs(cfg: ModelConfig, schedule, seq_len: int, batch: int, *,
                  cfg_scale: Optional[float] = None, cond_len: int = 64,
                  video_shape=None) -> float:
    """Total TMACs (1e12 MACs, the unit of the paper's Tables 1–3) of a
    whole diffusion sampling run under a SmoothCache schedule (None: one
    forward)."""
    per_type = model_macs_by_type(cfg, seq_len, cond_len=cond_len,
                                  video_shape=video_shape)
    eff_batch = batch * (2 if cfg_scale is not None else 1)
    total = 0.0
    for t, macs in per_type.items():
        frac = schedule.compute_fraction(t) if schedule is not None else 1.0
        total += macs * frac * schedule.num_steps if schedule is not None \
            else macs
    other = non_block_macs(cfg, seq_len) * (schedule.num_steps if schedule else 1)
    return (total + other) * eff_batch / 1e12
