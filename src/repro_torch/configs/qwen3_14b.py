"""qwen3-14b [dense] — GQA with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B].

40 layers, d_model=5120, 40 heads (GQA kv=8, head_dim=128), d_ff=17408,
vocab=151936, SwiGLU, RMSNorm, RoPE theta=1e6.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 5120


def _block():
    return BlockSpec(
        mixer=AttentionSpec(num_heads=40, num_kv_heads=8, head_dim=128,
                            causal=True, qk_norm=True, rope_theta=1e6),
        ffn=MLPSpec(d_ff=17408, activation="silu", gated=True),
        norm="rmsnorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        d_model=D, vocab_size=151_936,
        stages=(Stage(unit=(_block(),), repeat=40),),
        norm="rmsnorm", max_seq_len=32_768, long_context="swa",
        citation="hf:Qwen/Qwen3-8B")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
