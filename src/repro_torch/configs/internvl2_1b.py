"""internvl2-1b [vlm] — InternViT-300M + Qwen2-0.5B-style language backbone
[arXiv:2404.16821].

Language decoder: 24 layers, d_model=896, 14 heads (GQA kv=2, head_dim=64),
d_ff=4864, vocab=151655, QKV bias.  The InternViT vision encoder + MLP
projector are stubs: the caller provides 256 precomputed patch embeddings
per image, prepended to the token sequence.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 896


def _block():
    return BlockSpec(
        mixer=AttentionSpec(num_heads=14, num_kv_heads=2, head_dim=64,
                            causal=True, qkv_bias=True, rope_theta=1e6),
        ffn=MLPSpec(d_ff=4864, activation="silu", gated=True),
        norm="rmsnorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        d_model=D, vocab_size=151_655,
        stages=(Stage(unit=(_block(),), repeat=24),),
        norm="rmsnorm", tie_embeddings=True,
        num_prefix_embeds=256,           # ViT patch embeddings (stub)
        max_seq_len=8192, long_context="swa",
        citation="arXiv:2404.16821")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
