"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, interleaved dense/MoE, chunked local attention with NoPE globals,
early-fusion multimodal [hf:meta-llama/Llama-4-Scout-17B-16E family].

48 layers, d_model=5120, 40 heads (GQA kv=8, head_dim=128), expert
d_ff=8192 (dense layers d_ff=16384), vocab=202048.  Unit of 4 layers:
3 × chunked-local (w=8192, RoPE) + 1 × global (NoPE); MoE on every 2nd
layer (interleave step 2).  Vision early fusion is a stub: precomputed
patch embeddings are prepended.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, MoESpec, Stage)
from repro_torch.configs.common import smoke_variant

D = 5120


def _attn(window, rope=True):
    return AttentionSpec(num_heads=40, num_kv_heads=8, head_dim=128,
                         window=window, causal=True,
                         pos_emb="rope" if rope else "none",
                         rope_theta=500_000.0)


def _moe():
    return MoESpec(num_experts=128, top_k=1, d_ff=8192, num_shared=1,
                   d_ff_shared=8192, router="sigmoid", norm_topk=False,
                   aux_loss_weight=1e-3)


def _dense():
    return MLPSpec(d_ff=16384, activation="silu", gated=True)


def full() -> ModelConfig:
    unit = (
        BlockSpec(mixer=_attn(8192), ffn=_dense(), norm="rmsnorm"),
        BlockSpec(mixer=_attn(8192), ffn=_moe(), norm="rmsnorm"),
        BlockSpec(mixer=_attn(8192), ffn=_dense(), norm="rmsnorm"),
        BlockSpec(mixer=_attn(None, rope=False), ffn=_moe(), norm="rmsnorm"),
    )
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        d_model=D, vocab_size=202_048,
        stages=(Stage(unit=unit, repeat=12),),
        norm="rmsnorm", num_prefix_embeds=256,
        max_seq_len=32_768, long_context="swa",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128)
