"""Architecture config registry: ``get(name)`` → module with full()/smoke().

Only the models on the port's paths are registered."""
from __future__ import annotations

import importlib

REGISTRY = {
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "dit-xl-256": "repro_torch.configs.dit_xl",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "opensora-v12": "repro_torch.configs.opensora_v12",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "stable-audio-open": "repro_torch.configs.stable_audio_open",
}


def get_module(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return importlib.import_module(REGISTRY[name])


def get(name: str, variant: str = "full"):
    return getattr(get_module(name), variant)()
