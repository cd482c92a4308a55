"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].

48 layers, d_model=2048, ssm_state=128, vocab=50280, expand=2 (d_inner=4096),
head_dim=64 (64 SSD heads), no separate FFN (folded into the mixer).
"""
from repro_torch.config import BlockSpec, ModelConfig, SSMSpec, Stage
from repro_torch.configs.common import smoke_variant

D = 2048


def _block():
    return BlockSpec(
        mixer=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=128),
        ffn=None, norm="rmsnorm")


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        d_model=D, vocab_size=50_280,
        stages=(Stage(unit=(_block(),), repeat=48),),
        norm="rmsnorm", tie_embeddings=True,
        max_seq_len=8192, long_context="native",
        citation="arXiv:2405.21060")


def smoke() -> ModelConfig:
    return smoke_variant(full(), d_model=128, unit_repeats=2)
