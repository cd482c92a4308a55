"""Diffusion samplers.  Ported: DDIM (η = 0) on the VP schedule — the
paper's DiT-XL protocol.

A solver is ``model_times`` (the per-step times fed to the model) plus
``step(x, model_out, s) → x_next``, so the executor owns the model-call
loop and can substitute cached layer outputs at any step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import diffusion


@dataclasses.dataclass
class Solver:
    name: str
    num_steps: int
    model_times: torch.Tensor                # (S,) float32, on the CPU
    step: Callable                           # (x, model_out, s) -> x


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` bit for bit in float32:
    ``start·(1 − i/div) + stop·(i/div)``, endpoint appended exactly."""
    if num == 1:
        return np.asarray([start], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
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
    # per-step coefficients as f32 values (exact as Python floats)
    c_eps = [float(v) for v in np.sqrt(one - ab)]
    c_x = [float(v) for v in np.sqrt(ab)]
    c_x0n = [float(v) for v in np.sqrt(ab_next)]
    c_epsn = [float(v) for v in np.sqrt(one - ab_next)]

    def step(x, eps, s: int):
        x0 = (x - c_eps[s] * eps) / c_x[s]
        return c_x0n[s] * x0 + c_epsn[s] * eps

    return Solver("ddim", num_steps, torch.from_numpy(ts.astype(np.float32)),
                  step)
