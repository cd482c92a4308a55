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
    ``blocks`` blocks, a whole number of its unit (Gemma-2's unit is a
    local and a global block)."""
    (st,) = cfg.stages
    if blocks < 1 or blocks % len(st.unit):
        raise ValueError(f"{blocks} blocks is not a whole number of "
                         f"{cfg.name}'s {len(st.unit)}-block unit")
    return cfg.replace(stages=(dataclasses.replace(
        st, repeat=blocks // len(st.unit)),))


def lm_products(cfg: ModelConfig, rows: int, *, decode: bool = False) -> list:
    """An attention LM's products over ``rows`` token rows as ``(name, M,
    K, N, calls per forward)``.  GQA: q (d → H · dh), k and v (N = KV ·
    dh), o (H · dh → d), the gated MLP's up and gate, and down; where H ·
    dh = d, q and o are one shape, ``"q_o"``.  MLA: the q-LoRA's q_a (d →
    q_lora) and q_b (q_lora → H · (nope + rope)), or a full-rank q, kv_a
    (d → kv_lora + rope), kv_b (kv_lora → H · (nope + v)) in a prefill
    only (a ``decode`` step folds it into the attention einsums), o (H · v
    → d) and the MLP.  Every block of the stage has the same widths
    (Gemma-2's differ only in the window)."""
    (st,) = cfg.stages
    widths = {(dataclasses.replace(b.mixer, window=None), b.ffn.d_ff)
              for b in st.unit}
    if len(widths) != 1:
        raise ValueError(f"{cfg.name}'s blocks differ in width: {widths}")
    ((m, ff),) = widths
    d, blocks = cfg.d_model, cfg.num_layers
    mlp = [("up_gate", rows, d, ff, 2 * blocks), ("down", rows, ff, d, blocks)]
    if m.kind == "mla":
        q = ([("q_a", rows, d, m.q_lora_rank, blocks),
              ("q_b", rows, m.q_lora_rank, m.q_dim, blocks)]
             if m.q_lora_rank else [("q", rows, d, m.q_dim, blocks)])
        kv_b = [] if decode else [
            ("kv_b", rows, m.kv_lora_rank,
             m.num_heads * (m.nope_head_dim + m.v_head_dim), blocks)]
        return [*q, ("kv_a", rows, d, m.kv_lora_rank + m.rope_head_dim,
                     blocks), *kv_b,
                ("o", rows, m.o_in_dim, d, blocks), *mlp]
    hd, kv = m.q_dim, m.num_kv_heads * m.head_dim
    q_o = ([("q_o", rows, d, hd, 2 * blocks)] if hd == d else
           [("q", rows, d, hd, blocks), ("o", rows, hd, d, blocks)])
    return [*q_o[:1], ("k_v", rows, d, kv, 2 * blocks), *q_o[1:], *mlp]
