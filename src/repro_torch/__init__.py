"""repro_torch — SmoothCache for diffusion transformers in PyTorch and CUDA.

The PyTorch port of the JAX package ``repro``: DiT-XL/2 calibration →
:class:`~repro_torch.cache.artifact.CacheArtifact` → cached DDIM
generation → serving (:mod:`repro_torch.serve`), with attention on the GPU
in a hand-written Hopper kernel (``kernels/flash_attention.cu``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no ``device`` they raise.

    from repro_torch import configs
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import diffusion, solvers

    cfg = configs.get("dit-xl-256")
    params = diffusion.init_params(torch.Generator().manual_seed(0), cfg)
    pipe = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                             cfg_scale=1.5)
    art = pipe.calibrate(params, torch.Generator().manual_seed(1), 10,
                         cond_args={"label": labels})
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    absent — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
