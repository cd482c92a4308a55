"""gemma2-9b [dense] — alternating local/global attention, logit softcaps,
pre+post norms [arXiv:2408.00118].

42 layers, d_model=3584, 16 heads (GQA kv=8, head_dim=256), d_ff=14336,
vocab=256000.  Unit = (local w=4096, global) × 21.
"""
from repro_torch.config import (AttentionSpec, BlockSpec, MLPSpec,
                                ModelConfig, Stage)
from repro_torch.configs.common import smoke_variant

D = 3584


def _block(window):
    return BlockSpec(
        mixer=AttentionSpec(num_heads=16, num_kv_heads=8, head_dim=256,
                            window=window, causal=True, logit_softcap=50.0,
                            rope_theta=10000.0),
        ffn=MLPSpec(d_ff=14336, activation="gelu_tanh", gated=True),
        norm="rmsnorm", post_norm=True)


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        d_model=D, vocab_size=256_000,
        stages=(Stage(unit=(_block(4096), _block(None)), repeat=21),),
        norm="rmsnorm", tie_embeddings=True, embed_scale=True,
        logit_softcap=30.0, max_seq_len=8192,
        long_context="swa",   # global layers become w=swa_window for long_500k
        citation="arXiv:2408.00118")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128)
