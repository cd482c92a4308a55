"""Stable-Audio-Open-like DiT — the paper's text-to-audio model
[arXiv:2407.14358; SmoothCache §3.1].

24 blocks, d_model=1536, 24 heads, each with self-attn + cross-attn
(T5 text memory, stubbed) + gated FFN — the paper's 3 SmoothCache types
{attn, xattn, ffn}.  Latents: (216, 64) ≈ 10 s at 21.5 Hz × 64 channels
from the (stubbed) audio VAE.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 1536


def _block():
    return BlockSpec(
        mixer=AttentionSpec(num_heads=24, num_kv_heads=24, head_dim=64,
                            causal=False, rope_theta=10000.0),
        cross=AttentionSpec(num_heads=24, num_kv_heads=24, head_dim=64,
                            cross=True, causal=False, pos_emb="none"),
        ffn=MLPSpec(d_ff=6144, activation="silu", gated=True),
        norm="layernorm", adaln=True)


def full() -> ModelConfig:
    return ModelConfig(
        name="stable-audio-open",
        d_model=D, vocab_size=0, task="diffusion",
        stages=(Stage(unit=(_block(),), repeat=24),),
        norm="layernorm",
        latent_shape=(216, 64), patch=1, cond_dim=768,
        citation="SmoothCache §3.1; arXiv:2407.14358")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
