"""The programs of an LM, as the JAX package's ``repro.launch.programs``
builds them:

  train_step   — LM loss (+ MoE aux, + MTP for DeepSeek-V3) + AdamW update
  prefill_step — full forward that builds the decode caches
  serve_step   — ONE new token against a fixed KV/state cache

plus ``adapt_for_shape``, the long_500k sliding-window adaptation, and
``input_specs``, ``params_struct`` and ``opt_struct``: every program
input as a tensor on the meta device (the JAX package's
``ShapeDtypeStruct`` stand-ins), which ``launch/op_analysis.py`` and
``launch/dryrun.py`` run the programs on without allocating anything.
These are the entry points that hand a prefix of precomputed embeddings
(InternVL2's and Llama-4's patches) to the model.

Choices that differ from the JAX package's.  The weights, optimizer
moments, prefix and memory are f32 (the JAX package's structs are bf16,
its ν f32), the tokens int64 (int32) — the port's own dtypes; the shapes
are the same.  The caches are f32 (``CACHE_DTYPE``), as every decode path
of the port takes them; the JAX package keeps them in bf16 for the TPU's
memory.  ``make_prefill_step``'s default ``cache_len`` counts the prefix:
the JAX package's counts the tokens alone, so that a prefix of P clamps
the last P + 1 positions into one slot (``ROADMAP.md``, queue 3, fault
6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._device import _device_constructors

from repro_torch.config import AttentionSpec, ModelConfig, ShapePreset, Stage
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

CACHE_DTYPE = torch.float32
#: the MTP head's loss weight in :func:`lm_loss`, the JAX package's
MTP_WEIGHT = 0.3


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


class _OnMeta(TorchFunctionMode):
    """Every tensor a factory function makes lands on the meta device,
    whatever device the call names."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _device_constructors():
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


def on_meta() -> _OnMeta:
    """A context in which the port's own init code
    (``transformer.init_params``, ``diffusion.init_params(...,
    device="meta")``, ``init_caches``) makes every draw and every zero on
    the meta device: the same shapes and dtypes, nothing allocated.  A CPU
    generator draws nothing there."""
    return _OnMeta()


def token_struct(cfg: ModelConfig, batch: int, seq: int):
    """Tokens (batch, seq), or (batch, seq, K) for K codebooks, int64 on
    the meta device."""
    shape = (batch, seq, cfg.num_codebooks) if cfg.num_codebooks > 1 \
        else (batch, seq)
    return torch.empty(shape, dtype=torch.int64, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapePreset) -> Dict[str, Any]:
    """{name: meta tensor} of every input of the program of ``shape``: the
    JAX package's keys and shapes.  A decode's caches are
    ``init_caches``' at ``shape.seq_len`` slots."""
    b = shape.global_batch
    out: Dict[str, Any] = {}
    if shape.program == "train":
        out["tokens"] = token_struct(cfg, b, shape.seq_len)
        out["targets"] = token_struct(cfg, b, shape.seq_len)
    elif shape.program == "prefill":
        out["tokens"] = token_struct(cfg, b, shape.seq_len)
    else:  # decode
        out["token"] = token_struct(cfg, b, 1)
        with on_meta():
            out["caches"] = T.init_caches(cfg, b, shape.seq_len, CACHE_DTYPE,
                                          device="meta")
    if cfg.num_prefix_embeds and shape.program in ("train", "prefill"):
        out["prefix_embeds"] = torch.empty(
            (b, cfg.num_prefix_embeds, cfg.d_model), device="meta")
    if cfg.cond_dim:
        out["memory"] = torch.empty((b, 64, cfg.cond_dim), device="meta")
    return out


def params_struct(cfg: ModelConfig, dtype=torch.float32):
    """``transformer.init_params`` of ``cfg`` on the meta device."""
    with on_meta():
        return T.init_params(torch.Generator(), cfg, dtype)


def opt_struct(params_shape):
    """The AdamW state (``optim.adamw.init_state``) of meta params: the
    JAX package's leaves — ``step``, ``mu``, ``nu`` — with f32 moments."""
    return adamw.init_state(params_shape)


def _xent(logits, targets):
    """Mean cross entropy in f32: logsumexp minus the target's logit, over
    every position (and codebook)."""
    z = logits.float()
    tgt = torch.gather(z, -1, targets[..., None].long())[..., 0]
    return torch.mean(torch.logsumexp(z, dim=-1) - tgt)


def _moe_aux_weight(cfg: ModelConfig) -> float:
    """The first MoE FFN's load-balance loss weight (0 without one)."""
    for st in cfg.stages:
        for b in st.unit:
            w = getattr(b.ffn, "aux_loss_weight", 0.0) if b.ffn else 0.0
            if w:
                return w
    return 0.0


def lm_loss(cfg: ModelConfig, params, tokens, targets, *, prefix_embeds=None,
            memory=None, moe_strategy="gshard", remat=True):
    """The next-token cross entropy over the token positions (the prefix's
    are sliced off), plus ``MTP_WEIGHT`` × the MTP head's on the targets
    shifted once more (one codebook, ``mtp_depth`` > 0), plus the MoE
    load-balance loss at its weight."""
    logits, aux = T.forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                            memory=memory, moe_strategy=moe_strategy,
                            remat=remat)
    plen = prefix_embeds.shape[1] if (cfg.num_prefix_embeds
                                      and prefix_embeds is not None) else 0
    loss = _xent(logits[:, plen:], targets)
    if cfg.mtp_depth > 0 and cfg.num_codebooks == 1:
        mlogits = T.mtp_logits(cfg, params, aux["hidden"][:, plen:], tokens,
                               moe_strategy=moe_strategy)
        mtgt = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
        loss = loss + MTP_WEIGHT * _xent(mlogits, mtgt)
    aux_w = _moe_aux_weight(cfg)
    if aux_w:
        loss = loss + aux_w * aux["aux"].to(loss.device)
    return loss


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    moe_strategy="gshard", remat=True):
    """``train_step(params, opt_state, tokens, targets, prefix_embeds=None,
    memory=None)`` → ``(params, opt_state, loss, metrics)``: the loss's
    gradient (autograd, through the kernels' forwards on a card), rounded
    to bf16 as the JAX package rounds it before its optimizer, then one
    AdamW step in place (``optim.adamw``)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, tokens, targets, prefix_embeds=None,
                   memory=None):
        loss, grads = adamw.value_and_grad(
            lambda p: lm_loss(cfg, p, tokens, targets,
                              prefix_embeds=prefix_embeds, memory=memory,
                              moe_strategy=moe_strategy, remat=remat),
            params)
        grads = T.tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, loss, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None, *,
                      moe_strategy="gshard", moe_group_size=2048):
    """``prefill_step(params, tokens, prefix_embeds=None, memory=None)`` →
    (the last position's logits (B, 1, V) or (B, 1, K, V), caches).  The
    caches hold ``cache_len`` slots, by default the prefill's P + L
    positions (give room for the decode steps that follow).  A MoE FFN
    routes ``gshard`` groups of ``moe_group_size`` tokens, which must
    divide B·(P + L)."""
    def prefill_step(params, tokens, prefix_embeds=None, memory=None):
        plen = tokens.shape[1] + (0 if prefix_embeds is None
                                  else prefix_embeds.shape[1])
        logits, caches = T.prefill(
            cfg, params, tokens, cache_len=cache_len or plen,
            prefix_embeds=prefix_embeds, memory=memory,
            cache_dtype=CACHE_DTYPE, moe_strategy=moe_strategy,
            moe_group_size=moe_group_size)
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
