"""Gradients through the hand-written kernels.

The kernels are called through ``ctypes`` (``ops.py``), so their outputs
carry no ``grad_fn``.  :func:`differentiable` pairs a kernel with its plain
PyTorch version (``ref.py``) in one ``torch.autograd.Function``: the
forward is the kernel, exactly as an inference call launches it; the
backward is the plain version's gradient, recomputed on the saved inputs
under ``torch.enable_grad()`` and taken with ``torch.autograd.grad``.  An op
may pass its plain gradient in closed form instead (``vjp``): the linear
layer's dx = dy·wᵀ, dw = xᵀ·dy, db = Σ dy, which needs no recomputed
product.

Why the backward is plain PyTorch: the JAX package trains without its
Pallas kernels (``use_flash=False`` on its training path; its attention
gradient is XLA's autodiff of the einsum attention, its products XLA's
``dot``), so there is no backward kernel to port.  What it costs: every
attention, SSD and RG-LRU forward runs twice, once as the kernel and once
as the plain version inside the backward, and the plain attention holds the
(B, H, Lq, Lk) scores in f32; the backward products run as f32 cuBLAS
GEMMs (TF32 stays off), at a lower rate than the token kernel's 3xTF32.

The ops take this route only when grad mode is on and an input requires a
gradient (:func:`needs_grad`); otherwise they call the kernel directly,
save nothing and build no graph, so serving and graph capture are as
before.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def needs_grad(*tensors) -> bool:
    """Whether a call on these inputs must record a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _KernelFunction(torch.autograd.Function):
    """forward: ``kernel(*inputs)``; backward: the gradient of
    ``plain(*inputs)``, or ``vjp(inputs, grads)`` when given."""

    @staticmethod
    def forward(ctx, name, kernel, plain, vjp, *inputs):
        ctx.name, ctx.plain, ctx.vjp = name, plain, vjp
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        want = ctx.needs_input_grad[4:]
        if all(g is None for g in grads):
            return (None,) * (4 + len(inputs))
        # a profiler range a trace reads the backward's device time from
        with torch.profiler.record_function("plain_backward." + ctx.name):
            return (None,) * 4 + tuple(_plain_grads(ctx, inputs, want,
                                                    grads))


def _plain_grads(ctx, inputs, want, grads):
    """The plain version's gradient of each input ``want`` flags."""
    if ctx.vjp is not None:
        return ctx.vjp(inputs, grads, want)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(w)
                  for t, w in zip(inputs, want)]
        outs = ctx.plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t, w in zip(leaves, want) if w]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True))
    return [next(got) if w else None for w in want]


def differentiable(kernel: Callable, plain: Callable, *inputs,
                   vjp: Optional[Callable] = None, name: str = "op"):
    """``kernel(*inputs)`` with the gradient of ``plain(*inputs)``, its
    backward under the profiler range ``plain_backward.<name>``.
    inputs are tensors or None, in the positions both functions take;
    ``vjp(inputs, grads, want)``, when given, returns one gradient (or
    None) per input from the outputs' gradients (None for an output not
    used) for the inputs ``want`` flags."""
    return _KernelFunction.apply(name, kernel, plain, vjp, *inputs)


def linear_vjp(inputs, grads, want):
    """The plain product's gradient in closed form, for x (M, K), w (K, N),
    b (N,) or None: dx = dy·wᵀ, dw = xᵀ·dy, db = Σ_rows dy."""
    x, w, _ = inputs
    (dy,) = grads
    return (dy @ w.t() if want[0] else None,
            x.t() @ dy if want[1] else None,
            dy.sum(0) if want[2] else None)
