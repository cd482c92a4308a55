"""Stack assembly: init / forward over a ModelConfig's stages.

Stage parameters carry a leading ``repeat`` axis, as the JAX package stacks
them for ``lax.scan``; the port iterates over it.  Collected branch outputs
are stacked back to ``(repeat, B, N, d)`` per leaf, the JAX layout.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import blocks, layers as L


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees):
    """Stack same-structure trees leaf by leaf along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                adaln_dim: int = 0) -> Dict[str, Any]:
    stages = []
    for st in cfg.stages:
        reps = [tuple(blocks.init(gen, b, cfg.d_model, dtype,
                                  adaln_dim=adaln_dim) for b in st.unit)
                for _ in range(st.repeat)]
        stages.append(tuple(_stack([r[i] for r in reps])
                            for i in range(len(st.unit))))
    return {"stages": stages,
            "final_norm": L.layernorm_init(cfg.d_model, dtype)}


def _normalize_collect(collect_branches):
    """``True`` → None ("collect every branch"); falsy → empty set; a
    collection of layer types → that frozenset."""
    if collect_branches is True:
        return None
    if not collect_branches:
        return frozenset()
    return frozenset(collect_branches)


def apply_stages(cfg: ModelConfig, params, x, *, cond=None, skip=None,
                 branch_caches=None, collect_branches=False):
    """Run all stages.  Returns ``(x, branch)``: per stage, a tuple per
    unit block of ``{branch_name: (repeat, B, N, d)}`` (None for a block
    that collected nothing), or None when nothing is collected."""
    collect = _normalize_collect(collect_branches)
    collect_any = collect is None or len(collect) > 0
    all_branch = []
    for si, st in enumerate(cfg.stages):
        sp = params["stages"][si]
        sbc = branch_caches[si] if branch_caches is not None else None
        per_rep = []
        for r in range(st.repeat):
            outs = []
            for i, b in enumerate(st.unit):
                bc = (tree_map(lambda a: a[r], sbc[i])
                      if sbc is not None and sbc[i] else None)
                x, bo = blocks.apply(b, tree_map(lambda a: a[r], sp[i]), x,
                                     cond=cond, skip=skip, branch_cache=bc)
                if collect is not None:
                    types = dict(zip(b.branch_names(), b.branch_types()))
                    bo = {n: v for n, v in bo.items() if types[n] in collect}
                outs.append(bo or None)
            per_rep.append(outs)
        if not collect_any:
            all_branch.append(None)
            continue
        all_branch.append(tuple(
            None if per_rep[0][i] is None
            else _stack([outs[i] for outs in per_rep])
            for i in range(len(st.unit))))
    return x, all_branch


def forward(cfg: ModelConfig, params, embeds, *, cond=None, skip=None,
            branch_caches=None, collect_branches=False):
    """Full-sequence forward of embeddings (B, L, d) → hidden states after
    ``final_norm``, plus ``{"branch": ...}`` (see :func:`apply_stages`)."""
    x, branch = apply_stages(cfg, params, embeds, cond=cond, skip=skip,
                             branch_caches=branch_caches,
                             collect_branches=collect_branches)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return x, {"branch": branch}
