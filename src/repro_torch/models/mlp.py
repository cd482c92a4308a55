"""Feed-forward layers: (gated) MLPs, their products through
:func:`repro_torch.kernels.ops.linear`."""
from __future__ import annotations

import torch

from repro_torch.config import MLPSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init(gen: torch.Generator, spec: MLPSpec, d_model: int,
         dtype=torch.float32):
    p = {"w_up": L.dense_init(gen, d_model, spec.d_ff, dtype),
         "w_down": L.dense_init(gen, spec.d_ff, d_model, dtype)}
    if spec.gated:
        p["w_gate"] = L.dense_init(gen, d_model, spec.d_ff, dtype)
    return p


def apply(spec: MLPSpec, params, x):
    act = L.activation(spec.activation)
    up = ops.linear(x, params["w_up"])
    if spec.gated:
        up = act(ops.linear(x, params["w_gate"])) * up
    else:
        up = act(up)
    return ops.linear(up, params["w_down"])
