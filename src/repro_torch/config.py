"""Configuration schema: the spec dataclasses of the DiT, Mamba-2,
RG-LRU, attention-LM and mixture-of-experts families.

A copy of the JAX package's schema, cut to the specs the port runs: a
`ModelConfig` is a sequence of *stages*, each a repeated *unit* of block
specs.  Stage parameters carry a leading ``repeat`` axis, which the port
iterates over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class AttentionSpec:
    """Multi-head attention: GQA/MQA/MHA or MLA (DeepSeek-style latent
    KV)."""
    kind: str = "gqa"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    window: Optional[int] = None         # sliding-window size; None = full
    causal: bool = True
    cross: bool = False
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    pos_emb: str = "rope"                # "rope" | "none"
    rope_theta: float = 10000.0
    #: factorized video attention (OpenSora STDiT): None | "spatial" |
    #: "temporal"
    pattern: Optional[str] = None
    # --- MLA only ---
    q_lora_rank: Optional[int] = None    # None: full-rank q projection
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * (self.nope_head_dim + self.rope_head_dim)
        return self.num_heads * self.head_dim

    @property
    def o_in_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * self.v_head_dim
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 SSD mixer [arXiv:2405.21060]."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128                     # SSD chunk length
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class RGLRUSpec:
    """RG-LRU recurrent mixer from Griffin / RecurrentGemma
    [arXiv:2402.19427]."""
    num_heads: int = 8                   # block-diagonal gate projections
    conv_width: int = 4
    expand: int = 1                      # lru width = expand * d_model
    c_constant: float = 8.0


MixerSpec = Union[AttentionSpec, SSMSpec, RGLRUSpec]


@dataclass(frozen=True)
class MLPSpec:
    d_ff: int = 2048
    activation: str = "silu"             # "silu" | "gelu" | "gelu_tanh"
    gated: bool = True


@dataclass(frozen=True)
class MoESpec:
    """Routed mixture-of-experts FFN with optional shared experts."""
    num_experts: int = 8
    top_k: int = 2
    d_ff: int = 2048                     # per routed expert
    num_shared: int = 0
    d_ff_shared: int = 0
    activation: str = "silu"
    gated: bool = True
    router: str = "softmax"              # "softmax" | "sigmoid" (dsv3)
    router_scale: float = 1.0            # dsv3 routed_scaling_factor 2.5
    aux_loss_weight: float = 0.0
    norm_topk: bool = True               # renormalize top-k weights
    # expert capacity factor of gshard dispatch; 0 reads as 1.25
    # (``moe.capacity``).  The strategy is ``moe.apply``'s argument.
    capacity_factor: float = 0.0


FFNSpec = Union[MLPSpec, MoESpec]


@dataclass(frozen=True)
class BlockSpec:
    """One residual block: (norm → mixer → +res) [→ (norm → cross → +res)]
    [→ (norm → ffn → +res)].  ``ffn=None`` is used for Mamba-2 blocks,
    which fold the FFN into the mixer; ``cross`` is cross-attention to a
    conditioning memory (OpenSora's text)."""
    mixer: Optional[MixerSpec] = None
    cross: Optional[AttentionSpec] = None
    ffn: Optional[FFNSpec] = None
    norm: str = "rmsnorm"                # "rmsnorm" | "layernorm"
    post_norm: bool = False              # gemma2: extra norm after branch
    adaln: bool = False                  # DiT-style adaLN-zero conditioning
    type_tag: str = ""                   # SmoothCache type prefix

    def branch_names(self) -> Tuple[str, ...]:
        out = []
        if self.mixer is not None:
            out.append("mixer")
        if self.cross is not None:
            out.append("cross")
        if self.ffn is not None:
            out.append("ffn")
        return tuple(out)

    def branch_types(self) -> Tuple[str, ...]:
        """SmoothCache layer *types* for each branch (paper's set S)."""
        out = []
        if isinstance(self.mixer, AttentionSpec):
            out.append(self.type_tag + "attn")
        elif isinstance(self.mixer, SSMSpec):
            out.append(self.type_tag + "ssm")
        elif self.mixer is not None:
            out.append(self.type_tag + "rglru")
        if self.cross is not None:
            out.append(self.type_tag + "xattn")
        if self.ffn is not None:
            out.append(self.type_tag + "ffn")
        return tuple(out)


@dataclass(frozen=True)
class Stage:
    """`repeat` copies of `unit` (a tuple of BlockSpecs)."""
    unit: Tuple[BlockSpec, ...]
    repeat: int = 1

    @property
    def num_layers(self) -> int:
        return len(self.unit) * self.repeat


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab_size: int
    stages: Tuple[Stage, ...] = ()
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    pos_emb: str = "none"
    max_seq_len: int = 8192
    logit_softcap: Optional[float] = None   # final logit soft-capping
    embed_scale: bool = False            # scale embeddings by sqrt(d)
    # multi-codebook token IO (musicgen): K codebooks share the embedding sum
    num_codebooks: int = 1
    # prepended continuous embeddings (VLM patches / audio frames); 0 = none
    num_prefix_embeds: int = 0
    # DeepSeek-style multi-token prediction depth (an extra training head;
    # serving never reads it)
    mtp_depth: int = 0
    task: str = "lm"                     # "lm" | "diffusion"
    latent_shape: Tuple[int, ...] = ()   # diffusion: per-sample latent shape
    patch: int = 1                       # diffusion image patch size
    cond_dim: int = 0                    # cross-attention memory width
    num_classes: int = 0                 # label conditioning (DiT-XL)
    # long-context policy of the JAX package's long_500k preset: "native"
    # (SSM) | "swa" (a sliding window of swa_window) | None; the port's
    # paths do not read it
    long_context: Optional[str] = None
    swa_window: int = 8192
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    def blocks(self):
        """(stage index, repeat index, index in the unit, BlockSpec) of
        every block, in order."""
        for si, st in enumerate(self.stages):
            for r in range(st.repeat):
                for bi, b in enumerate(st.unit):
                    yield si, r, bi, b

    def layer_types(self) -> Tuple[str, ...]:
        """All SmoothCache-eligible layer types present in the model."""
        types = []
        for st in self.stages:
            for b in st.unit:
                for t in b.branch_types():
                    if t not in types:
                        types.append(t)
        return tuple(types)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape presets (the JAX package's, value for value)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapePreset:
    name: str
    seq_len: int
    global_batch: int
    program: str                         # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapePreset("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapePreset("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapePreset("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapePreset("long_500k",  524_288,    1, "decode"),
}
