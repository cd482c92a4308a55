"""DiT-XL/2 256×256 — the paper's primary image model
[Peebles & Xie, Scalable Diffusion Models with Transformers].

28 adaLN-zero blocks, d_model=1152, 16 heads, d_ff=4608, patch=2 over
32×32×4 SD-VAE latents (256 tokens), class-conditional (1000 ImageNet
classes) with classifier-free guidance.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 1152


def _block():
    return BlockSpec(
        mixer=AttentionSpec(num_heads=16, num_kv_heads=16, head_dim=72,
                            causal=False, pos_emb="none"),
        ffn=MLPSpec(d_ff=4608, activation="gelu_tanh", gated=False),
        norm="layernorm", adaln=True)


def full() -> ModelConfig:
    return ModelConfig(
        name="dit-xl-256",
        d_model=D, vocab_size=0, task="diffusion",
        stages=(Stage(unit=(_block(),), repeat=28),),
        norm="layernorm", pos_emb="sinusoidal",
        latent_shape=(32, 32, 4), patch=2, num_classes=1000,
        citation="arXiv:2212.09748 (DiT); SmoothCache §3.1")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
