"""Every product a model's forward hands the linear kernels, from its
config: the shapes ``chip_smoke.py`` checks and times and the ones
``gemm_ab`` compares tile widths and builds over."""
from __future__ import annotations

import dataclasses

from repro_torch.config import AttentionSpec, ModelConfig, MoESpec, RGLRUSpec
from repro_torch.models import moe


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


def lm_cut(cfg: ModelConfig, blocks) -> ModelConfig:
    """``cfg`` at its published widths with its stages cut to ``blocks``
    blocks: one count for a one-stage config, else a count per stage (for
    example ``(1, 2)``: DeepSeek-V3's first dense block and two MoE
    blocks), each a whole number of its stage's unit (Gemma-2's unit is a
    local and a global block)."""
    counts = (blocks,) if isinstance(blocks, int) else tuple(blocks)
    if len(counts) != len(cfg.stages):
        raise ValueError(f"{len(counts)} block counts for {cfg.name}'s "
                         f"{len(cfg.stages)} stages")
    stages = []
    for n, st in zip(counts, cfg.stages):
        if n < 1 or n % len(st.unit):
            raise ValueError(f"{n} blocks is not a whole number of "
                             f"{cfg.name}'s {len(st.unit)}-block unit")
        stages.append(dataclasses.replace(st, repeat=n // len(st.unit)))
    return cfg.replace(stages=tuple(stages))


def _one(cfg: ModelConfig, what: str, widths: set):
    if len(widths) != 1:
        raise ValueError(f"{cfg.name}'s blocks differ in width ({what}): "
                         f"{widths}")
    return next(iter(widths))


def lm_products(cfg: ModelConfig, rows: int, *, decode: bool = False,
                memory_rows: int = 0) -> list:
    """An LM's products over ``rows`` token rows as ``(name, M, K, N, calls
    per forward)``, the calls of each kind of block counted over the blocks
    of that kind.  GQA: q (d → H · dh), k and v (N = KV · dh), o (H · dh →
    d), the gated MLP's up and gate (an ungated one's up alone, ``"up"``),
    and down; where H · dh = d, q and o are one shape, ``"q_o"``.  A
    cross-attention branch (MusicGen) adds its q and o over the rows
    (``"cross_q_o"``, or ``"cross_q"`` and ``"cross_o"``) and its k and v
    over the memory's ``memory_rows`` rows (cond_dim → KV · dh,
    ``"cross_k_v"``), in a prefill and in every decode step alike.  MLA:
    the q-LoRA's q_a (d → q_lora) and q_b (q_lora → H · (nope + rope)), or
    a full-rank q, kv_a (d → kv_lora + rope), kv_b (kv_lora → H · (nope +
    v)) in a prefill only (a ``decode`` step folds it into the attention
    einsums), o (H · v → d) and the MLP.
    RG-LRU (RecurrentGemma's recurrent blocks): in_x and in_gate (d → W),
    the two gate products of every head (hd → hd, ``"gate_heads"``) and out
    (W → d).  The attention blocks have one set of mixer widths (Gemma-2's
    and Llama-4's differ only in the window and the position embedding),
    the cross branches one, the RG-LRU blocks one, and the MLP blocks one
    d_ff.  The MoE blocks (DeepSeek-V3) add the router (d → E), every
    routed expert's up and gate (d → f) and down over each expert's rows as
    ``generate`` hands them over — all ``rows`` in a prefill (``dense``
    dispatch), its gshard capacity rows in a ``decode`` step — and the
    shared expert's over ``rows``."""
    specs = [b for _, _, _, b in cfg.blocks()]
    attn = [b.mixer for b in specs if isinstance(b.mixer, AttentionSpec)]
    rec = [b.mixer for b in specs if isinstance(b.mixer, RGLRUSpec)]
    if len(attn) + len(rec) != len(specs):
        raise ValueError(f"{cfg.name} has blocks that are neither "
                         "attention nor RG-LRU")
    mlps = [b.ffn for b in specs if not isinstance(b.ffn, MoESpec)]
    moes = [b.ffn for b in specs if isinstance(b.ffn, MoESpec)]
    d = cfg.d_model
    mlp = []
    if mlps:
        ff, gated = _one(cfg, "d_ff", {(f.d_ff, f.gated) for f in mlps})
        mlp = [("up_gate", rows, d, ff, 2 * len(mlps)) if gated
               else ("up", rows, d, ff, len(mlps)),
               ("down", rows, ff, d, len(mlps))]
    if moes:
        e = _one(cfg, "experts", set(moes))
        group = min(2048, rows)
        expert_rows = (rows // group * moe.capacity(e, group) if decode
                       else rows)
        fs = e.d_ff_shared or e.d_ff * e.num_shared
        n = len(moes)
        mlp += [("router", rows, d, e.num_experts, n),
                ("expert_up_gate", expert_rows, d, e.d_ff,
                 2 * e.num_experts * n),
                ("expert_down", expert_rows, e.d_ff, d, e.num_experts * n)]
        if e.num_shared:
            mlp += [("shared_up_gate", rows, d, fs, 2 * n),
                    ("shared_down", rows, fs, d, n)]
    out = []
    if rec:
        r, n = _one(cfg, "RG-LRU mixer", set(rec)), len(rec)
        w = r.expand * d
        hd = w // r.num_heads
        out += [("in_x", rows, d, w, n), ("in_gate", rows, d, w, n),
                ("gate_heads", rows, hd, hd, 2 * r.num_heads * n),
                ("out", rows, w, d, n)]
    if attn:
        out += _attention_products(
            _one(cfg, "mixer", {dataclasses.replace(m, window=None,
                                                    pos_emb="none")
                                for m in attn}), d, rows, len(attn), decode)
    cross = [b.cross for b in specs if b.cross is not None]
    if cross:
        if not memory_rows:
            raise ValueError(f"{cfg.name}'s cross-attention needs "
                             "memory_rows")
        c, n = _one(cfg, "cross", set(cross)), len(cross)
        hd, kv = c.q_dim, c.num_kv_heads * c.head_dim
        q_o = ([("cross_q_o", rows, d, hd, 2 * n)] if hd == d else
               [("cross_q", rows, d, hd, n), ("cross_o", rows, hd, d, n)])
        out += [*q_o[:1], ("cross_k_v", memory_rows, cfg.cond_dim or d, kv,
                           2 * n), *q_o[1:]]
    return out + mlp


def _attention_products(m: AttentionSpec, d: int, rows: int, blocks: int,
                        decode: bool) -> list:
    if m.kind == "mla":
        q = ([("q_a", rows, d, m.q_lora_rank, blocks),
              ("q_b", rows, m.q_lora_rank, m.q_dim, blocks)]
             if m.q_lora_rank else [("q", rows, d, m.q_dim, blocks)])
        kv_b = [] if decode else [
            ("kv_b", rows, m.kv_lora_rank,
             m.num_heads * (m.nope_head_dim + m.v_head_dim), blocks)]
        return [*q, ("kv_a", rows, d, m.kv_lora_rank + m.rope_head_dim,
                     blocks), *kv_b,
                ("o", rows, m.o_in_dim, d, blocks)]
    hd, kv = m.q_dim, m.num_kv_heads * m.head_dim
    q_o = ([("q_o", rows, d, hd, 2 * blocks)] if hd == d else
           [("q", rows, d, hd, blocks), ("o", rows, hd, d, blocks)])
    return [*q_o[:1], ("k_v", rows, d, kv, 2 * blocks), *q_o[1:]]
