"""Shared helpers for architecture configs: the smoke-test reducer."""
from __future__ import annotations

import dataclasses

from repro_torch.config import (AttentionSpec, ModelConfig, MoESpec,
                                RGLRUSpec, SSMSpec, Stage)


def _shrink_mixer(m, d_model: int):
    if m is None:
        return None
    if isinstance(m, SSMSpec):
        return dataclasses.replace(m, d_state=16, head_dim=16, chunk=8)
    if isinstance(m, RGLRUSpec):
        return dataclasses.replace(m, num_heads=2)
    if not isinstance(m, AttentionSpec):
        raise NotImplementedError(f"mixer {type(m).__name__} is not ported")
    heads = 4 if m.num_heads >= 4 else m.num_heads
    kv = max(1, heads * m.num_kv_heads // m.num_heads)
    kw = dict(num_heads=heads, num_kv_heads=kv, head_dim=d_model // heads)
    if m.kind == "mla":
        kw.update(q_lora_rank=(64 if m.q_lora_rank else None),
                  kv_lora_rank=64, rope_head_dim=16, nope_head_dim=32,
                  v_head_dim=32)
    if m.window is not None:
        kw["window"] = min(m.window, 16)
    return dataclasses.replace(m, **kw)


def _shrink_ffn(f, d_model: int):
    if f is None:
        return None
    if isinstance(f, MoESpec):
        return dataclasses.replace(
            f, num_experts=min(4, f.num_experts), top_k=min(2, f.top_k),
            d_ff=max(32, d_model), num_shared=min(1, f.num_shared),
            d_ff_shared=(max(32, d_model) if f.num_shared else 0))
    return dataclasses.replace(f, d_ff=2 * d_model)


def _shrink_latent(shape):
    if not shape:
        return ()
    if len(shape) == 3:         # (H, W, C) image latents
        return (8, 8, shape[-1])
    if len(shape) == 4:         # (T, H, W, C) video latents
        return (4, 8, 8, shape[-1])
    return (16, shape[-1])      # (L, C) audio latents


def smoke_variant(cfg: ModelConfig, d_model: int = 128,
                  unit_repeats: int = 1) -> ModelConfig:
    """Reduced same-family variant: one unit per stage repeated at most
    ``unit_repeats`` times, d_model ≤ 512, ≤ 4 experts with top-k ≤ 2, 8×8
    image latents, a memory of at most 64 wide, at most 8 prefix
    embeddings; the codebooks as they are."""
    if d_model > 512:
        raise ValueError(f"smoke d_model must be <= 512, got {d_model}")
    stages = []
    for st in cfg.stages:
        unit = tuple(
            dataclasses.replace(b, mixer=_shrink_mixer(b.mixer, d_model),
                                cross=_shrink_mixer(b.cross, d_model),
                                ffn=_shrink_ffn(b.ffn, d_model))
            for b in st.unit)
        stages.append(Stage(unit=unit, repeat=min(unit_repeats, st.repeat)))
    return cfg.replace(
        name=cfg.name + "-smoke", d_model=d_model,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else cfg.vocab_size,
        stages=tuple(stages), max_seq_len=min(cfg.max_seq_len, 256),
        cond_dim=min(cfg.cond_dim, 64) if cfg.cond_dim else 0,
        num_prefix_embeds=min(cfg.num_prefix_embeds, 8),
        latent_shape=_shrink_latent(cfg.latent_shape), swa_window=16,
        dtype="float32")
