"""The serving programs of an LM, as the JAX package's
``repro.launch.programs`` builds them:

  prefill_step — full forward that builds the decode caches
  serve_step   — ONE new token against a fixed KV/state cache

plus ``adapt_for_shape``, the long_500k sliding-window adaptation.  These
are the entry points that hand a prefix of precomputed embeddings
(InternVL2's and Llama-4's patches) to the prefill.  The training half
(``lm_loss``, ``make_train_step``, ``input_specs``, the optimizer's
structures) is not ported.

Two choices differ from the JAX package's.  The caches are f32
(``CACHE_DTYPE``), as every decode path of the port takes them; the JAX
package keeps them in bf16 for the TPU's memory.  ``make_prefill_step``'s
default ``cache_len`` counts the prefix: the JAX package's counts the
tokens alone, so that a prefix of P clamps the last P + 1 positions into
one slot (``ROADMAP.md``, queue 3, fault 6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config import AttentionSpec, ModelConfig, Stage
from repro_torch.models import transformer as T

CACHE_DTYPE = torch.float32


def adapt_for_shape(cfg: ModelConfig, shape) -> ModelConfig:
    """For the long_500k shape (``shape.name``), full-attention archs
    switch to the sliding-window variant (window ``cfg.swa_window``, a
    window already set kept if smaller); SSM / hybrid archs are native and
    every other shape keeps ``cfg``."""
    if shape.name != "long_500k" or cfg.long_context != "swa":
        return cfg

    def swa(m):
        if isinstance(m, AttentionSpec) and not m.cross and m.window is None:
            return dataclasses.replace(m, window=cfg.swa_window)
        if isinstance(m, AttentionSpec) and m.window is not None:
            return dataclasses.replace(m, window=min(m.window,
                                                     cfg.swa_window))
        return m
    stages = tuple(
        Stage(unit=tuple(dataclasses.replace(b, mixer=swa(b.mixer))
                         for b in st.unit), repeat=st.repeat)
        for st in cfg.stages)
    return cfg.replace(stages=stages, name=cfg.name + "+swa")


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None, *,
                      moe_strategy="gshard"):
    """``prefill_step(params, tokens, prefix_embeds=None, memory=None)`` →
    (the last position's logits (B, 1, V) or (B, 1, K, V), caches).  The
    caches hold ``cache_len`` slots, by default the prefill's P + L
    positions (give room for the decode steps that follow)."""
    def prefill_step(params, tokens, prefix_embeds=None, memory=None):
        plen = tokens.shape[1] + (0 if prefix_embeds is None
                                  else prefix_embeds.shape[1])
        logits, caches = T.prefill(
            cfg, params, tokens, cache_len=cache_len or plen,
            prefix_embeds=prefix_embeds, memory=memory,
            cache_dtype=CACHE_DTYPE, moe_strategy=moe_strategy)
        # a copy: a view would keep every position's logits alive
        return logits[:, -1:].clone(), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, pos: int):
    """``serve_step(params, token, caches, memory=None)`` → (logits,
    caches): one decode step at position ``pos``; a MoE FFN dispatches as
    ``decode_step`` does (gshard over the batch)."""
    def serve_step(params, token, caches, memory=None):
        return T.decode_step(cfg, params, token, caches, pos=pos,
                             memory=memory)

    return serve_step
