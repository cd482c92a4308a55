"""Diffusion samplers: DDIM (η = 0) on the VP schedule — the paper's
DiT-XL protocol —, DPM-Solver++(3M) SDE — its Stable Audio Open protocol —
and rectified-flow Euler, its OpenSora protocol.

A solver is ``model_times`` (the per-step times fed to the model),
``init_state()`` and ``step(x, model_out, s, state, noise=None) →
(x_next, state)``, so the executor owns the model-call loop and can
substitute cached layer outputs at any step.  ``state`` is a dict the
executor threads from step to step: ``{}`` for DDIM and rectified flow,
DPM++(3M)'s multistep history for it.  ``noise`` is where a stochastic
solver takes its per-step noise, a tensor of x's shape the executor draws
(``SmoothCacheExecutor.step_noise``; torch cannot reproduce the JAX
package's ``fold_in`` bits) for ``stochastic`` solvers only.

``s`` is a Python int or, for a ``scannable`` solver, a ``(1,)`` int64
tensor on ``x``'s device (the step counter a captured CUDA graph
advances).  Either way the per-step
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
    #: the step reads noise (its rows then depend on the batch shape);
    #: ``ddim`` and ``rectified_flow`` keep both defaults,
    #: ``dpmpp_3m_sde`` sets both
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


def dpmpp_3m_sde(num_steps: int, sched=None, num_train_steps: int = 1000,
                 eta: float = 1.0) -> Solver:
    """DPM-Solver++(3M) SDE, k-diffusion's formulation on σ = √((1 − ᾱ)/ᾱ)
    (the VE view of the VP schedule).  The model stays ε-prediction: each
    step moves x to VE coordinates, takes x̂₀ = x − σ·ε, runs the
    third-order multistep update over the last three x̂₀ with noise scaled
    by ``eta``, and moves back to VP coordinates at the next level.  The
    last step (σ → 0) returns x̂₀.

    The per-step coefficients are float32, computed once in the
    reference's order (``t = −log σ``, ``h``, ``h·(η+1)``, the φ₂ / φ₃
    ``expm1`` forms) into a :class:`StepTable`.  The state is
    ``{"d1", "d2", "h1", "h2"}``: the last two x̂₀ and step sizes, each
    None until the steps that make it (d2 and h2 from the third step on),
    then a tensor — d1 / d2 of x's shape, h1 / h2 of shape (1,).

    Not scannable: the step branches in Python on the step index (the
    final step) and on the state's structure, which changes over the
    first three steps."""
    sched = sched or diffusion.vp_schedule(num_train_steps)
    ts = np.round(linspace_f32(num_train_steps - 1, 1, num_steps)).astype(
        np.int64)
    one = np.float32(1)
    ab = sched["alpha_bar"].numpy()[ts]
    sig = np.concatenate([np.sqrt((one - ab) / ab),
                          np.zeros(1, np.float32)])
    sig_next = sig[1:]
    eta32 = np.float32(eta)
    with np.errstate(divide="ignore", invalid="ignore"):
        # the last step's σ_next is 0: its h and what follows from it are
        # never read there (the final step returns x̂₀)
        h = -np.log(sig_next) - -np.log(sig[:-1])
        h_eta = h * (eta32 + one)
        phi2 = np.expm1(-h_eta) / h_eta + one
        coeffs = np.stack([
            np.sqrt(ab), sig[:-1], np.exp(-h_eta), -np.expm1(-h_eta),
            phi2, phi2 / h_eta - np.float32(0.5),
            sig_next * np.sqrt(-np.expm1(np.float32(-2.0) * h * eta32)),
            np.sqrt(one / (one + sig_next ** 2)), h])
    coeffs[:, -1] = np.where(np.isfinite(coeffs[:, -1]), coeffs[:, -1], 0)
    table = StepTable(coeffs)
    last = num_steps - 1
    noisy = eta > 0

    def init_state():
        return {"d1": None, "d2": None, "h1": None, "h2": None}

    def step(x_vp, eps, s, state, noise=None):
        (c_in, sig_s, decay, gain, phi2_s, phi3_s, c_noise, c_out,
         h_s) = table.at(s, x_vp.device)
        x = x_vp / c_in
        denoised = x - sig_s * eps
        if s == last:
            return denoised * c_out, state
        x_new = decay * x + gain * denoised
        if state["d2"] is not None:
            r0, r1 = state["h1"] / h_s, state["h2"] / h_s
            d1_0 = (denoised - state["d1"]) / r0
            d1_1 = (state["d1"] - state["d2"]) / r1
            d1 = d1_0 + (d1_0 - d1_1) * r0 / (r0 + r1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            x_new = x_new + phi2_s * d1 - phi3_s * d2
        elif state["d1"] is not None:
            r = state["h1"] / h_s
            x_new = x_new + phi2_s * ((denoised - state["d1"]) / r)
        if noisy and noise is not None:
            x_new = x_new + noise * c_noise
        state = {"d1": denoised, "d2": state["d1"], "h1": h_s,
                 "h2": state["h1"]}
        return x_new * c_out, state

    return Solver("dpmpp_3m_sde", num_steps,
                  torch.from_numpy(ts.astype(np.float32)), init_state, step,
                  stochastic=True, scannable=False)


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


#: the solvers by name, as the JAX package registers them
SOLVERS: Dict[str, Callable[..., Solver]] = {
    "ddim": ddim,
    "dpmpp_3m_sde": dpmpp_3m_sde,
    "rectified_flow": rectified_flow,
}
