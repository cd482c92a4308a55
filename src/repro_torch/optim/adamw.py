"""AdamW with decoupled weight decay and global-norm clipping, value for
value the JAX package's ``repro.optim.adamw``: b1 0.9, b2 0.95, eps 1e-8,
weight decay 0.1 on every leaf, clip 1.0, f32 moments, bias corrections
``1 − b ** step`` in f32.

The state is ``{"step": 0-d int32, "mu", "nu"}`` with moment trees shaped
like the params.  :func:`apply_updates` changes the params and the state
in place (under ``torch.no_grad()``), so that every tensor keeps its
address and the token kernel's prepared copies, keyed on it, are remade
in place of the old ones (``kernels/gemm.py``).  No hand-written kernel:
the JAX package computes the update in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels.timing import span
from repro_torch.models.transformer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    schedule: Optional[Callable] = None      # step → lr multiplier


def init_state(params):
    """Zero moments like the params (f32) and step 0, on the params'
    device."""
    dev = tree_leaves(params)[0].device
    zeros = lambda a: torch.zeros_like(a, dtype=torch.float32)  # noqa: E731
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def _sq_norms(tree):
    """Σ x² of each leaf, in f32."""
    return [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]


def global_norm(tree):
    """√(Σ over leaves of Σ x²), in f32."""
    return torch.sqrt(sum(_sq_norms(tree)))


@torch.no_grad()
@span("train.optimizer")
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step on ``grads`` (any float dtype; taken to f32), in
    place, under the span ``train.optimizer``.  Returns ``(params, state,
    {"grad_norm", "lr", "grad_sq_norms"})``: the global norm and the lr as
    0-d f32 tensors, and each leaf's Σ g² in ``tree_leaves`` order (a
    gradient that is missing, zero or not finite shows there), all on the
    device: nothing here waits for it."""
    state["step"].add_(1)
    step = state["step"]
    sq = _sq_norms(grads)
    gnorm = torch.sqrt(sum(sq))
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip is not None else None)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None
                   else torch.ones((), device=step.device))
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        g32 = g.float() if scale is None else g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta += cfg.weight_decay * p.float()
        p.sub_((lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr,
                           "grad_sq_norms": torch.stack(sq)}


@contextlib.contextmanager
def tracking(params):
    """Within the block the params' leaves (yielded, in ``tree_leaves``
    order) require a gradient; outside it they are as they were, so that
    the ops take their inference route (``kernels/autograd.py``)."""
    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        yield leaves
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)


def grad_tree(params, grads):
    """The gradients of ``params``' leaves (``tree_leaves`` order; None
    where the loss does not reach) as a tree like the params, a zero leaf
    for None, as ``jax.grad`` gives."""
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(tree_leaves(params), grads))
    return tree_map(lambda _: next(it), params)


def value_and_grad(loss_fn, params):
    """``(loss, grads)`` of ``loss_fn(params)``, the gradients a tree like
    the params (:func:`grad_tree`); the forward and the backward under the
    spans ``train.forward`` and ``train.backward``."""
    with tracking(params) as leaves, torch.enable_grad():
        with span("train.forward"):
            loss = loss_fn(params)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grad_tree(params, grads)


# ---------------------------------------------------------------------------
# LR schedules (step → multiplier)
# ---------------------------------------------------------------------------

def cosine_schedule(warmup: int, total: int, final_frac: float = 0.1):
    """Linear warmup to 1 over ``warmup`` steps, then a cosine down to
    ``final_frac`` at ``total``."""
    def f(step):
        s = torch.as_tensor(step).float()
        warm = s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def constant_schedule():
    return lambda step: torch.ones((), device=torch.as_tensor(step).device)
