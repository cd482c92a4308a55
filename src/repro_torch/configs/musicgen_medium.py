"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens
with cross-attention to text conditioning [arXiv:2306.05284].

48 layers, d_model=1536, 24 heads (kv=24, MHA), d_ff=6144, vocab=2048 per
codebook, 4 codebooks (delay pattern handled by the data pipeline).
The EnCodec codec and T5 text encoder are stubs: the caller provides token
ids (B, L, 4) and a precomputed text memory (B, Lm, 1536).
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 1536


def _block():
    return BlockSpec(
        mixer=AttentionSpec(num_heads=24, num_kv_heads=24, head_dim=64,
                            causal=True, pos_emb="none"),
        cross=AttentionSpec(num_heads=24, num_kv_heads=24, head_dim=64,
                            cross=True, causal=False, pos_emb="none"),
        ffn=MLPSpec(d_ff=6144, activation="gelu", gated=False),
        norm="layernorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        d_model=D, vocab_size=2048, num_codebooks=4,
        stages=(Stage(unit=(_block(),), repeat=48),),
        norm="layernorm", pos_emb="sinusoidal",
        cond_dim=D,                      # T5 memory projected to d_model (stub)
        max_seq_len=4096, long_context="swa",
        citation="arXiv:2306.05284")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
