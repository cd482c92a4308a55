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


def flatten_params(tree, prefix: str = ""):
    """Numpy-leaved parameter tree → ``{"a/b/0/c": array}``, the layout
    :func:`params_from_npz` reads (``np.savez(path, **flatten_params(t))``
    writes it).  List and tuple positions become integer path parts."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat):
    root = {}
    for path, a in flat.items():
        node, parts = root, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def params_from_npz(path: str, *, device=None):
    """A parameter tree saved as ``flatten_params`` paths in an ``.npz``
    (e.g. the JAX package's trained weights) → tensors on ``device``."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return params_from_numpy(_unflatten(flat), device=device)


def opt_state_from_numpy(state, *, device=None):
    """The JAX package's AdamW state ``{"step", "mu", "nu"}`` with numpy
    leaves → the port's (``optim.adamw``): step a 0-d int32 tensor, the
    moments leaf for leaf in f32, on ``device``."""
    dev = resolve_device(device)
    moments = lambda t: tree_map(  # noqa: E731
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), t)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "mu": moments(state["mu"]), "nu": moments(state["nu"])}
