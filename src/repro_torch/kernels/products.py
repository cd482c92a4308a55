"""Every product a model's forward hands the linear kernels, from its
config: the shapes ``chip_smoke.py`` checks and times and the ones
``gemm_ab`` compares tile widths and builds over."""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig


def gemms(cfg: ModelConfig, batch: int, mem_len: int = 0) -> list:
    """Every product of one diffusion forward over ``batch`` rows
    (CFG-doubled requests) as ``(M, K, N, bias, calls, rows)``: the patch
    embedding, the time MLP, per block the adaLN modulation, self-attention
    q/k/v/o, cross-attention q/o over the tokens and k/v over a
    ``mem_len``-token memory where the block has ``cross``, the MLP (up,
    and gate where it is gated, then down), the final modulation and the
    output projection; ``rows`` is the linear kernel's variant
    (``"requests"``: one row per request)."""
    from repro_torch.core.diffusion import TIME_EMB_DIM, token_shape
    ffn = cfg.stages[0].unit[0].ffn
    d, ff, up = cfg.d_model, ffn.d_ff, 2 if ffn.gated else 1
    n_tok, tok_dim, _ = token_shape(cfg)
    rows, toks, blocks = batch, batch * n_tok, cfg.num_layers
    cross = sum(b.cross is not None for _, _, _, b in cfg.blocks())
    t, r = "tokens", "requests"
    memory = ([(batch * mem_len, cfg.cond_dim, d, False, 2 * cross, t)]
              if cross else [])
    return [(toks, tok_dim, d, True, 1, t),
            (rows, TIME_EMB_DIM, d, True, 1, r), (rows, d, d, True, 1, r),
            (rows, d, 6 * d, True, blocks, r),
            (toks, d, d, False, 4 * blocks + 2 * cross, t), *memory,
            (toks, d, ff, False, up * blocks, t),
            (toks, ff, d, False, blocks, t),
            (rows, d, 2 * d, True, 1, r), (toks, d, tok_dim, True, 1, t)]


def lm_cut(cfg: ModelConfig, blocks: int) -> ModelConfig:
    """``cfg`` at its published widths with its one stage cut to
    ``blocks`` blocks."""
    (st,) = cfg.stages
    return cfg.replace(stages=(dataclasses.replace(st, repeat=blocks),))


def lm_products(cfg: ModelConfig, rows: int) -> list:
    """A dense GQA attention LM's products over ``rows`` token rows as
    ``(name, M, K, N, calls per forward)``: q and o, k and v (N = KV · dh),
    the gated MLP's up and gate, and down."""
    spec, ffn = cfg.stages[0].unit[0].mixer, cfg.stages[0].unit[0].ffn
    d, blocks = cfg.d_model, cfg.num_layers
    kv = spec.num_kv_heads * spec.head_dim
    return [("q_o", rows, d, spec.num_heads * spec.head_dim, 2 * blocks),
            ("k_v", rows, d, kv, 2 * blocks),
            ("up_gate", rows, d, ffn.d_ff, 2 * blocks),
            ("down", rows, ffn.d_ff, d, blocks)]
