"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 attn:recurrent
pattern [arXiv:2402.19427 Griffin / RecurrentGemma].

26 layers, d_model=2560, 10 heads (MQA kv=1), d_ff=7680, vocab=256000,
local attention window 2048.  Layer pattern: (rec, rec, attn) × 8 + (rec, rec).
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, RGLRUSpec, Stage)
from repro_torch.configs.common import smoke_variant

D = 2560


def _rec_block():
    return BlockSpec(
        mixer=RGLRUSpec(num_heads=10, conv_width=4, expand=1),
        ffn=MLPSpec(d_ff=7680, activation="gelu_tanh", gated=True),
        norm="rmsnorm")


def _attn_block():
    return BlockSpec(
        mixer=AttentionSpec(num_heads=10, num_kv_heads=1, head_dim=256,
                            window=2048, causal=True, rope_theta=10000.0),
        ffn=MLPSpec(d_ff=7680, activation="gelu_tanh", gated=True),
        norm="rmsnorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        d_model=D, vocab_size=256_000,
        stages=(Stage(unit=(_rec_block(), _rec_block(), _attn_block()),
                      repeat=8),
                Stage(unit=(_rec_block(), _rec_block()), repeat=1)),
        norm="rmsnorm", tie_embeddings=True, embed_scale=True,
        max_seq_len=8192, long_context="native",
        citation="arXiv:2402.19427")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128)
