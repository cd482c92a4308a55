"""OpenSora-v1.2-like STDiT — the paper's text-to-video model
[arXiv:2412.20404 Open-Sora; SmoothCache §3.1].

28 (spatial, temporal) block pairs, d_model=1152, 16 heads; every block has
self-attention (RoPE) + cross-attention (T5 text memory, stubbed) + FFN,
giving the paper's 6 SmoothCache layer types: {s_attn, s_xattn, s_ffn,
t_attn, t_xattn, t_ffn}.  Latents: (16, 32, 32, 4), patch (1, 2, 2) →
T=16 frames × S=256 spatial tokens.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 1152


def _block(pattern, tag):
    return BlockSpec(
        mixer=AttentionSpec(num_heads=16, num_kv_heads=16, head_dim=72,
                            causal=False, pattern=pattern, rope_theta=10000.0),
        cross=AttentionSpec(num_heads=16, num_kv_heads=16, head_dim=72,
                            cross=True, causal=False, pos_emb="none"),
        ffn=MLPSpec(d_ff=4608, activation="gelu_tanh", gated=False),
        norm="layernorm", adaln=True, type_tag=tag)


def full() -> ModelConfig:
    return ModelConfig(
        name="opensora-v12",
        d_model=D, vocab_size=0, task="diffusion",
        stages=(Stage(unit=(_block("spatial", "s_"), _block("temporal", "t_")),
                      repeat=28),),
        norm="layernorm",
        latent_shape=(16, 32, 32, 4), patch=2, cond_dim=D,
        citation="SmoothCache §3.1; Open-Sora v1.2")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128)
