"""Parameter bridge from the JAX package.

``params_from_numpy`` turns the JAX parameter pytree — dicts, lists and
tuples with numpy arrays as leaves (``jax.tree.map(np.asarray, params)``) —
into the port's tensors, leaf for leaf and in the same layout: dense
weights stay ``(in, out)`` and stage parameters keep their leading
``repeat`` axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import tree_map


def params_from_numpy(tree, *, device=None):
    """Numpy-leaved parameter tree → the same tree of tensors on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
