"""Diffusion samplers.  Ported: DDIM (η = 0) on the VP schedule — the
paper's DiT-XL protocol — and rectified-flow Euler, its OpenSora protocol.

A solver is ``model_times`` (the per-step times fed to the model),
``init_state()`` and ``step(x, model_out, s, state, noise=None) →
(x_next, state)``, so the executor owns the model-call loop and can
substitute cached layer outputs at any step.  ``state`` is a dict of
tensors the executor threads from step to step (``{}`` for both solvers
here).  ``noise`` is where a stochastic solver takes its per-step noise,
a tensor the executor draws (torch cannot reproduce the JAX package's
``fold_in`` bits); no solver here is stochastic, so the executor draws
none and no step reads it.

``s`` is a Python int or a ``(1,)`` int64 tensor on ``x``'s device (the
step counter a captured CUDA graph advances).  Either way the per-step
coefficients are read as ``(1,)`` tensors from a table on ``x``'s device,
so every path runs one arithmetic form: on CUDA a division by a Python
float is a multiplication by its reciprocal, a division by a tensor a
true division, and the two can differ in the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import diffusion


@dataclasses.dataclass
class Solver:
    name: str
    num_steps: int
    model_times: torch.Tensor                # (S,) float32, on the CPU
    init_state: Callable[[], dict]
    #: (x, model_out, s, state, noise=None) -> (x, state)
    step: Callable
    #: the step draws noise (its rows then depend on the batch shape);
    #: ``ddim`` keeps both defaults, the JAX ``dpmpp_3m_sde`` sets both
    stochastic: bool = False
    #: ``step`` takes a device step index and reads no host state, so it
    #: runs inside a captured CUDA graph (the fused adaptive path)
    scannable: bool = True


class StepTable:
    """Per-step float32 rows (``(R, S)``) with one copy per device, read at
    step ``s`` as R ``(1,)`` tensors — a slice for an int, a gather for a
    device index.  A device's copy is made on its first read, so a graph
    capture must follow one read on that device."""

    def __init__(self, rows: np.ndarray):
        self._cpu = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            t = self._cpu if device.type == "cpu" else self._cpu.to(device)
            self._on[device] = t
        return t

    def at(self, s, device):
        t = self.on(device)
        if isinstance(s, torch.Tensor):
            return t.index_select(1, s).unbind(0)
        return t[:, s:s + 1].unbind(0)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` as XLA on the CPU computes it in
    float32: ``start·(1 − s) + stop·s`` with ``s = i·(1/div)`` (the
    division by ``div`` becomes a product with its float32 reciprocal),
    endpoint appended exactly.  Bit for bit for ``num`` up to 352; longer
    grids take another vectorized form there."""
    if num == 1:
        return np.asarray([start], np.float32)
    div = num - 1
    step = (np.arange(div, dtype=np.float32)
            * (np.float32(1) / np.float32(div)))
    out = (np.float32(start) * (np.float32(1) - step)
           + np.float32(stop) * step)
    return np.concatenate([out, np.asarray([stop], np.float32)])


def ddim(num_steps: int, sched=None, num_train_steps: int = 1000) -> Solver:
    sched = sched or diffusion.vp_schedule(num_train_steps)
    # f32 linspace rounded half to even, as the reference computes it
    ts = np.round(linspace_f32(num_train_steps - 1, 0, num_steps)).astype(
        np.int64)
    ab = sched["alpha_bar"].numpy()[ts]
    ab_next = np.concatenate([ab[1:], np.ones(1, np.float32)])
    one = np.float32(1)
    coeffs = StepTable(np.stack([np.sqrt(one - ab), np.sqrt(ab),
                                 np.sqrt(ab_next), np.sqrt(one - ab_next)]))

    def step(x, eps, s, state, noise=None):
        c_eps, c_x, c_x0n, c_epsn = coeffs.at(s, x.device)
        x0 = (x - c_eps * eps) / c_x
        return c_x0n * x0 + c_epsn * eps, state

    return Solver("ddim", num_steps, torch.from_numpy(ts.astype(np.float32)),
                  dict, step)


def rectified_flow(num_steps: int, num_train_steps: int = 1000) -> Solver:
    """Rectified-flow Euler: the model predicts the velocity v = ε − x₀,
    and x is integrated from t = 1 (noise) to t = 0 as ``x + dt·v``.  The
    model times are ``tgrid[:-1]·1000`` over ``tgrid = linspace(1, 0,
    S+1)`` in float32, as the reference computes them."""
    del num_train_steps                      # the reference's signature
    tgrid = linspace_f32(1.0, 0.0, num_steps + 1)
    dts = StepTable((tgrid[1:] - tgrid[:-1])[None])      # negative

    def step(x, v, s, state, noise=None):
        (dt,) = dts.at(s, x.device)
        return x + dt * v, state

    return Solver("rectified_flow", num_steps,
                  torch.from_numpy(tgrid[:-1] * np.float32(1000.0)),
                  dict, step)


#: the ported solvers by name (the JAX package's ``dpmpp_3m_sde`` is not
#: ported yet)
SOLVERS: Dict[str, Callable[..., Solver]] = {
    "ddim": ddim,
    "rectified_flow": rectified_flow,
}
