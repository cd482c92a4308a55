"""minicpm3-4b [dense] — MLA attention in a small dense model
[hf:openbmb/MiniCPM3-4B].

62 layers, d_model=2560, 40 heads (MLA: q_lora=768, kv_lora=256,
nope=64, rope=32, v=64), d_ff=6400, vocab=73448, tied embeddings.  The
published config's μP-style scales (embedding, residual depth, logits)
are not modelled, as in the JAX package's config.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 2560


def _block():
    return BlockSpec(
        mixer=AttentionSpec(kind="mla", num_heads=40, causal=True,
                            q_lora_rank=768, kv_lora_rank=256,
                            rope_head_dim=32, nope_head_dim=64,
                            v_head_dim=64),
        ffn=MLPSpec(d_ff=6400, activation="silu", gated=True),
        norm="rmsnorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        d_model=D, vocab_size=73_448,
        stages=(Stage(unit=(_block(),), repeat=62),),
        norm="rmsnorm", tie_embeddings=True,
        max_seq_len=32_768, long_context="swa",
        citation="hf:openbmb/MiniCPM3-4B")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
