"""Architecture config registry: ``get(name)`` → module with full()/smoke().

Only the model on the port's main path is registered."""
from __future__ import annotations

import importlib

REGISTRY = {
    "dit-xl-256": "repro_torch.configs.dit_xl",
}


def get_module(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return importlib.import_module(REGISTRY[name])


def get(name: str, variant: str = "full"):
    return getattr(get_module(name), variant)()
