"""Stack assembly: init / forward / prefill / decode over a ModelConfig's
stages.

Stage parameters carry a leading ``repeat`` axis, as the JAX package stacks
them for ``lax.scan``; the port iterates over it.  Collected branch outputs
and state caches are stacked back to a leading ``repeat`` axis per leaf, the
JAX layout.

Entry points
  init_params(gen, cfg, dtype)                  # on the generator's device
  forward(cfg, params, tokens | embeds=...)     # LM logits / DiT hidden
  init_caches(cfg, batch[, cache_len])
  prefill(cfg, params, tokens[, cache_len=])    # forward + decode caches
  decode_step(cfg, params, token, caches[, pos=])  # one AR token

An LM's tokens are (B, L), or (B, L, K) for K codebooks (MusicGen: the
codebooks' embeddings summed, one head each, logits (B, L, K, V)).
``prefix_embeds`` (B, P, d) — precomputed patch embeddings (InternVL2,
Llama-4) — go in front of the embedded tokens in ``forward`` and
``prefill``; the prefill's length counts them.  ``memory`` (B, Lm,
cond_dim) feeds every cross-attention branch, in the full forward and in
each decode step.

A state-cache (SSM) model decodes without positions; an attention model's
KV caches need the cache length (``cache_len``) and each decode step its
position (``pos``).  A mixture-of-experts FFN dispatches by
``moe_strategy`` (``"gshard"`` over groups of ``moe_group_size`` tokens,
the default, or ``"dense"``); ``decode_step`` takes the default, as the
JAX package's does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import AttentionSpec, BlockSpec, ModelConfig, MoESpec
from repro_torch.kernels import gemm, ops
from repro_torch.models import attention, blocks, layers as L


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples
    (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, in ``tree_map``'s
    order (None is no leaf)."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [] if tree is None else [tree]


def _unstack(tree, n: int):
    """``[tree_map(lambda a: a[r], tree) for r in range(n)]`` through one
    ``unbind`` a leaf: the same views, and in a backward one stack of the
    slices' gradients a leaf, where ``a[r]``'s backward fills a zero
    tensor of the whole leaf for each r and adds the n of them."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in parts.items()} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [type(tree)(v[r] for v in parts) for r in range(n)]
    return list(tree.unbind(0))


def _stack(trees):
    """Stack same-structure trees leaf by leaf along a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                adaln_dim: int = 0) -> Dict[str, Any]:
    """Seeded parameters drawn from ``gen`` in a fixed order, on the
    generator's device (the zero and one leaves on the CPU)."""
    p: Dict[str, Any] = {}
    if cfg.task == "lm" and cfg.num_codebooks > 1:
        # one embedding table (K, V, d) and one head (K, d, V) a codebook
        k, v, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
        p["embed"] = torch.stack([L.embed_init(gen, v, d, dtype)
                                  for _ in range(k)])
        p["heads"] = torch.stack([L.dense_init(gen, d, v, dtype)
                                  for _ in range(k)])
    elif cfg.task == "lm":
        p["embed"] = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype)
    stages = []
    for st in cfg.stages:
        reps = [tuple(blocks.init(gen, b, cfg.d_model, dtype,
                                  adaln_dim=adaln_dim, cond_dim=cfg.cond_dim)
                      for b in st.unit)
                for _ in range(st.repeat)]
        stages.append(tuple(_stack([r[i] for r in reps])
                            for i in range(len(st.unit))))
    p["stages"] = stages
    p["final_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype)
    if cfg.mtp_depth > 0 and cfg.task == "lm":
        # DeepSeek-V3's multi-token prediction head, the JAX package's
        # leaves: norm(h_t) ⊕ norm(emb_{t+1}) → proj → one block of the
        # last spec.  Training reads it; serving never does.
        d = cfg.d_model
        p["mtp"] = {"h_norm": L.norm_init(cfg.norm, d, dtype),
                    "e_norm": L.norm_init(cfg.norm, d, dtype),
                    "proj": L.dense_init(gen, 2 * d, d, dtype),
                    "block": blocks.init(gen, cfg.stages[-1].unit[-1], d,
                                         dtype, cond_dim=cfg.cond_dim)}
    return p


def token_weights(params):
    """The weights of the stack's token products (q/k/v/o of self- and
    cross-attention, MLA's q-LoRA, kv latent and o, the RG-LRU's in_x,
    in_gate and out and every head of its gates wa and wx, the MLP; a MoE
    FFN's router, every routed expert's up, gate and down and the shared
    expert's), one per product as :func:`apply_stages` takes it: a block's
    weight as the view ``a[r]`` of its stacked leaf, a routed expert's or
    a gate head's as ``a[r][e]``.  The MTP head, which serving never reads,
    is not among them, nor the embedding and the LM head or the codebook
    heads, which the token kernel never takes."""
    out = []
    names = {"mixer": ("wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a",
                       "wkv_b", "in_x", "in_gate", "out", "wa", "wx"),
             "cross": ("wq", "wk", "wv", "wo"),
             "ffn": ("router", "w_up", "w_gate", "w_down"),
             "shared": ("w_up", "w_gate", "w_down")}
    for stage in params["stages"]:
        for unit in stage:
            groups = dict(unit)
            groups["shared"] = unit.get("ffn", {}).get("shared", {})
            for group, keys in names.items():
                for key in keys:
                    a = groups.get(group, {}).get(key)
                    if a is None:
                        continue
                    for r in range(a.shape[0]):
                        # routed experts, gate heads: a stacked (repeat,
                        # E, K, N) leaf
                        out.extend(a[r] if a.dim() == 4 else [a[r]])
    return out


def prepare_linear(params) -> int:
    """Make the token kernel's prepared weights (``gemm.prepare``) for every
    token product of the stack, before any timed window; a no-op for
    parameters on the CPU.  Returns the bytes the prepared copies hold."""
    if params["final_norm"]["scale"].device.type != "cuda":
        return 0
    return gemm.prepare_params(token_weights(params))


def init_caches(cfg: ModelConfig, batch: int,
                cache_len: Optional[int] = None, dtype=torch.float32,
                device=None):
    """Zeroed decode caches: per stage, a tuple per unit block of the
    block's cache stacked ``(repeat, ...)`` (a KV cache's ``slots`` -1,
    ``(repeat, S)``)."""
    out = []
    for st in cfg.stages:
        out.append(tuple(
            tree_map(lambda a, r=st.repeat: a.expand(r, *a.shape).clone(),
                     blocks.init_cache(b, cfg.d_model, batch, cache_len,
                                       dtype, device=device))
            for b in st.unit))
    return out


# ---------------------------------------------------------------------------
# Embedding IO
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens, prefix_embeds=None):
    """tokens (B, L) or (B, L, K) → (B, P + L, d): the embedding (the K
    codebooks' summed), scaled by √d where ``embed_scale``, the prefix
    (B, P, d) in front, then sinusoidal positions 0 … P + L − 1 where
    ``pos_emb`` says so."""
    if cfg.pos_emb not in ("none", "sinusoidal"):
        raise ValueError(f"unknown LM position embedding {cfg.pos_emb!r}")
    if cfg.num_codebooks > 1:
        x = _codebook_embed(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.pos_emb == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + L.sinusoidal_embedding(pos, cfg.d_model)[None].to(x.dtype)
    return x


def _codebook_embed(embed, tokens):
    """embed (K, V, d), tokens (B, L, K) → (B, L, d): the codebooks'
    embeddings summed in codebook order, ((e0 + e1) + e2) + e3."""
    out = embed[0][tokens[..., 0]]
    for i in range(1, embed.shape[0]):
        out = out + embed[i][tokens[..., i]]
    return out


def logits_from_hidden(cfg: ModelConfig, params, x):
    """x (B, L, d) → logits (B, L, V), or (B, L, K, V) for K codebooks;
    the head's products are cuBLAS's, as the JAX package computes them
    outside any kernel."""
    if cfg.num_codebooks > 1:
        out = torch.einsum("bld,kdv->blkv", x, params["heads"])
    elif cfg.tie_embeddings:
        out = x @ params["embed"].T
    else:
        out = x @ params["lm_head"]
    if cfg.logit_softcap:
        out = L.softcap(out.float(), cfg.logit_softcap)
    return out


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def _normalize_collect(collect_branches):
    """``True`` → None ("collect every branch"); falsy → empty set; a
    collection of layer types → that frozenset."""
    if collect_branches is True:
        return None
    if not collect_branches:
        return frozenset()
    return frozenset(collect_branches)


def apply_stages(cfg: ModelConfig, params, x, *, mode="full", positions=None,
                 pos=None, caches=None, cond=None, skip=None,
                 branch_caches=None, collect_branches=False,
                 collect_caches=False, memory=None, video_shape=None,
                 moe_strategy="gshard", moe_group_size=2048, remat=False):
    """Run all stages.  Returns ``(x, branch, new_caches, aux)``.
    ``positions`` (full mode) and ``pos`` (decode mode) reach every
    attention mixer, ``moe_strategy`` and ``moe_group_size`` every MoE FFN;
    aux is the sum of their load-balance losses (a CPU zero without
    one).

    branch: per stage, a tuple per unit block of ``{branch_name: (repeat,
    B, N, d)}`` (None for a block that collected nothing), or None when
    nothing is collected.  new_caches: per stage, a tuple per unit block of
    the block's state cache stacked ``(repeat, ...)``, when
    ``collect_caches`` or ``mode == "decode"``; else None per stage.  A
    decode step's KV caches are the given ones, updated in place.
    ``remat`` recomputes each unit's activations in the backward
    (``torch.utils.checkpoint``), with the same numbers."""
    collect = _normalize_collect(collect_branches)
    collect_any = collect is None or len(collect) > 0
    keep_caches = collect_caches or mode == "decode"
    all_branch, all_caches = [], []
    aux_total = None
    for si, st in enumerate(cfg.stages):
        sp = params["stages"][si]
        sbc = branch_caches[si] if branch_caches is not None else None
        scache = caches[si] if caches is not None else None
        per_rep, per_rep_caches = [], []
        sp_reps = [_unstack(u, st.repeat) for u in sp]
        for r in range(st.repeat):
            # the stage's values bound now: a remat recompute runs later
            def unit(x, r=r, st=st, sps=sp_reps, sbc=sbc, scache=scache):
                outs, new_caches, auxes = [], [], []
                for i, b in enumerate(st.unit):
                    bc = (tree_map(lambda a: a[r], sbc[i])
                          if sbc is not None and sbc[i] else None)
                    cache = (tree_map(lambda a: a[r], scache[i])
                             if scache is not None else None)
                    is_moe = isinstance(b.ffn, MoESpec)
                    x, bo, nc, *aux = blocks.apply(
                        b, sps[i][r], x, mode=mode,
                        positions=positions, pos=pos, cache=cache,
                        cond=cond, skip=skip, branch_cache=bc,
                        memory=memory, video_shape=video_shape,
                        moe_strategy=moe_strategy,
                        moe_group_size=moe_group_size, with_aux=is_moe)
                    auxes.extend(aux)
                    if collect is not None:
                        types = dict(zip(b.branch_names(), b.branch_types()))
                        bo = {n: v for n, v in bo.items()
                              if types[n] in collect}
                    outs.append(bo or None)
                    new_caches.append(nc if keep_caches else None)
                return x, outs, new_caches, auxes

            # remat: the unit's activations are recomputed in the backward
            # (its kernels launch again), as jax.checkpoint of the unit
            x, outs, new_caches, auxes = (
                checkpoint(unit, x, use_reentrant=False) if remat
                else unit(x))
            for a in auxes:
                aux_total = a if aux_total is None else aux_total + a
            per_rep.append(outs)
            per_rep_caches.append(new_caches)
        # a decode step updates a KV cache in place: its stacked leaves
        # already hold every repeat's new column
        all_caches.append(tuple(
            scache[i] if mode == "decode" and isinstance(b.mixer,
                                                         AttentionSpec)
            else _stack([c[i] for c in per_rep_caches])
            for i, b in enumerate(st.unit)) if keep_caches else None)
        if not collect_any:
            all_branch.append(None)
            continue
        all_branch.append(tuple(
            None if per_rep[0][i] is None
            else _stack([outs[i] for outs in per_rep])
            for i in range(len(st.unit))))
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32)
    return x, all_branch, all_caches, aux_total


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            prefix_embeds=None, cond=None, skip=None, branch_caches=None,
            collect_branches=False, collect_caches=False, memory=None,
            video_shape=None, positions=None, moe_strategy="gshard",
            moe_group_size=2048, remat=False):
    """Full-sequence forward.  For an LM: tokens (B, L[, K]) with
    ``prefix_embeds`` (B, P, d) in front → logits over all P + L
    positions.  For a diffusion backbone: embeddings ``embeds`` (B, L, d)
    → hidden states after ``final_norm`` (the diffusion wrapper owns
    patchify and head).  ``memory`` (B, Lm, cond_dim), ``video_shape`` (T,
    S) and ``positions`` ((1, L) or (B, L); attention takes ``arange(L)``
    when None), ``moe_strategy`` and ``moe_group_size`` reach every block;
    ``remat`` recomputes each unit in the backward.
    Returns ``(out, {"branch", "caches", "aux", "hidden"})`` (see
    :func:`apply_stages`)."""
    x = (embed_tokens(cfg, params, tokens, prefix_embeds) if embeds is None
         else embeds)
    x, branch, caches, aux = apply_stages(
        cfg, params, x, mode="full", positions=positions, cond=cond,
        skip=skip, branch_caches=branch_caches,
        collect_branches=collect_branches, collect_caches=collect_caches,
        memory=memory, video_shape=video_shape, moe_strategy=moe_strategy,
        moe_group_size=moe_group_size, remat=remat)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    out = logits_from_hidden(cfg, params, x) if cfg.task == "lm" else x
    return out, {"branch": branch, "caches": caches, "aux": aux, "hidden": x}


def mtp_logits(cfg: ModelConfig, params, hidden, tokens, *,
               moe_strategy="gshard"):
    """DeepSeek-V3's multi-token prediction head: predict token t + 2 from
    hidden_t (B, L, d), the final-normed hidden states, and the embedding
    of token t + 1, tokens (B, L).  The next tokens keep all L positions
    (the last id repeated, so that a MoE group still divides them; the
    last position is padding): norm(h) ⊕ norm(emb) → proj → one block of
    the last unit's spec → the shared final norm and head.  Returns logits
    (B, L, V)."""
    mtp = params["mtp"]
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    h = torch.cat([L.apply_norm(cfg.norm, mtp["h_norm"], hidden),
                   L.apply_norm(cfg.norm, mtp["e_norm"],
                                params["embed"][nxt])], dim=-1)
    h = ops.linear(h, mtp["proj"])
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, *_ = blocks.apply(cfg.stages[-1].unit[-1], mtp["block"], h,
                         mode="full", positions=positions,
                         moe_strategy=moe_strategy)
    h = L.apply_norm(cfg.norm, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h)


def _to_decode_cache(block_spec: BlockSpec, prefill_cache, cache_len,
                     prefill_len: int, cache_dtype):
    """One block's stacked prefill cache → its decode cache.  A state cache
    (SSM, RG-LRU) already has the decode layout, with the leading
    ``(repeat,)`` axis on each leaf.  An attention layer's (k, v), each
    (repeat, B, L, KV, dh), keeps the positions the decode step can still
    see (the last ``window`` of them) in the slots that step's ring
    indexing gives them (``pos % S`` under a window, else ``pos``), in the
    decode layouts k (repeat, B, KV, dh, S) and v (repeat, B, KV, S, dh),
    with ``slots`` (repeat, S) holding each slot's position (-1 empty).  An
    MLA layer's (ckv, krope), (repeat, B, L, kv_lora) and (repeat, B, L,
    rope), keep their layout, (repeat, B, S, ·)."""
    m = block_spec.mixer
    if m is None:
        return None
    if not isinstance(m, AttentionSpec):
        return prefill_cache
    if cache_len is None:
        raise ValueError("an attention model's prefill needs cache_len")
    clen = min(cache_len, m.window) if m.window else cache_len
    dev = prefill_cache[0].device
    positions = torch.arange(prefill_len, device=dev)
    if m.window and prefill_len > m.window:
        positions = positions[-m.window:]
    slots = (positions % clen if m.window
             else torch.clamp(positions, max=clen - 1))
    names = ("ckv", "krope") if m.kind == "mla" else ("k", "v")
    out = {}
    for name, arr in zip(names, prefill_cache):
        buf = torch.zeros(arr.shape[:2] + (clen,) + arr.shape[3:],
                          dtype=cache_dtype, device=dev)
        buf[:, :, slots] = arr[:, :, positions].to(cache_dtype)
        out[name] = buf
    if m.kind != "mla":
        out["k"] = out["k"].permute(0, 1, 3, 4, 2).contiguous()
        out["v"] = out["v"].permute(0, 1, 3, 2, 4).contiguous()
    slot_pos = torch.full((clen,), -1, dtype=torch.int32, device=dev)
    slot_pos[slots] = positions.to(torch.int32)
    out["slots"] = slot_pos.expand(arr.shape[0], clen).clone()
    return out


def prefill(cfg: ModelConfig, params, tokens, *,
            cache_len: Optional[int] = None, prefix_embeds=None, memory=None,
            cache_dtype=torch.float32, moe_strategy="gshard",
            moe_group_size=2048):
    """Full forward that also builds the decode caches.  Returns (logits,
    caches).  State caches keep the dtypes the forward made them in; KV
    caches hold ``cache_len`` slots (an attention model needs it) in
    ``cache_dtype``, for the P + L positions of ``prefix_embeds`` and the
    tokens.  A MoE FFN dispatches by ``moe_strategy`` (``generate``
    prefills with ``"dense"``)."""
    out, aux = forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                       memory=memory, collect_caches=True,
                       moe_strategy=moe_strategy,
                       moe_group_size=moe_group_size)
    plen = tokens.shape[1]
    if prefix_embeds is not None:
        plen += prefix_embeds.shape[1]
    caches = [tuple(_to_decode_cache(b, aux["caches"][si][bi], cache_len,
                                     plen, cache_dtype)
                    for bi, b in enumerate(st.unit))
              for si, st in enumerate(cfg.stages)]
    return out, caches


def decode_step(cfg: ModelConfig, params, token, caches, *,
                pos=None, memory=None):
    """One AR decode step.  token: (B, 1) or (B, 1, K) at position ``pos``
    (an attention model, or sinusoidal positions, need it): an int, or a
    ``(1,)`` int64 tensor on the parameters' device, which the step reads
    only on the device (the JAX package's traced position: a captured
    graph of the step serves every position); ``memory`` feeds the
    cross-attention branches over the whole memory.  Returns (logits (B,
    1, V) or (B, 1, K, V), caches); an attention model's KV caches are the
    given ones, updated in place, a state cache's leaves new tensors."""
    attn = any(isinstance(b.mixer, AttentionSpec)
               for _, _, _, b in cfg.blocks())
    if pos is None and (attn or cfg.pos_emb == "sinusoidal"):
        raise ValueError("an attention model's decode step needs pos=")
    x = embed_tokens(cfg, params, token)
    if pos is not None:
        pos = attention.as_position(pos, x.device)
    if cfg.pos_emb == "sinusoidal":
        # embed_tokens added position 0's sinusoid: swap in pos's, in the
        # JAX package's order (subtract, then add)
        d, dev = cfg.d_model, x.device
        x = x - L.sinusoidal_embedding(torch.arange(1, device=dev),
                                       d)[None].to(x.dtype)
        x = x + L.sinusoidal_embedding(pos, d)[None].to(x.dtype)
    x, _, new_caches, _ = apply_stages(cfg, params, x, mode="decode",
                                       pos=pos, caches=caches, memory=memory)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), new_caches
