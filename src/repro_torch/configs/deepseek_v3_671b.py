"""deepseek-v3-671b [moe] — MLA + 1 shared / 256 routed top-8 experts + MTP
[arXiv:2412.19437].

61 layers, d_model=7168, 128 heads (MLA: q_lora=1536, kv_lora=512,
nope=128, rope=64, v=128), routed expert d_ff=2048, vocab=129280.  First 3
layers are dense (d_ff=18432); layers 4–61 are MoE (256 routed top-8 + 1
shared expert, sigmoid router with selection bias, routed scaling 2.5).
MTP depth 1 (one extra predict-ahead head, which serving never reads).
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, MoESpec, Stage)
from repro_torch.configs.common import smoke_variant

D = 7168


def _mla():
    return AttentionSpec(kind="mla", num_heads=128, causal=True,
                         q_lora_rank=1536, kv_lora_rank=512,
                         rope_head_dim=64, nope_head_dim=128, v_head_dim=128)


def _dense_block():
    return BlockSpec(mixer=_mla(),
                     ffn=MLPSpec(d_ff=18432, activation="silu", gated=True),
                     norm="rmsnorm")


def _moe_block():
    return BlockSpec(
        mixer=_mla(),
        ffn=MoESpec(num_experts=256, top_k=8, d_ff=2048, num_shared=1,
                    d_ff_shared=2048, router="sigmoid", router_scale=2.5,
                    norm_topk=True, aux_loss_weight=1e-4),
        norm="rmsnorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        d_model=D, vocab_size=129_280,
        stages=(Stage(unit=(_dense_block(),), repeat=3),
                Stage(unit=(_moe_block(),), repeat=58)),
        norm="rmsnorm", max_seq_len=32_768, mtp_depth=1,
        long_context="swa", citation="arXiv:2412.19437")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128)
