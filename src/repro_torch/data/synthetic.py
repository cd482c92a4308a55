"""Synthetic conditioning: a stub of a T5-style text memory (drawn from a
generator, or per prompt for a serving engine's ``text_encoder``), and
text-conditioned latents whose low-frequency content is a linear readout
of that memory (the JAX package's ``repro.data.synthetic``).

Drawn on the CPU from a ``torch.Generator``, so a seed gives the same bits
on every device, then moved to the device (``cuda`` unless the caller
passes ``device="cpu"``).  The bits differ from JAX's: parity tests feed
numpy memory to both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def text_memory(generator: torch.Generator, batch: int, length: int,
                dim: int, *, device=None):
    """Precomputed T5-style text-encoder memory: N(0, 0.02²) of shape
    (batch, length, dim)."""
    mem = torch.randn((batch, length, dim), generator=generator) * 0.02
    return mem.to(resolve_device(device))


def prompt_memory(prompts: Sequence[str], length: int, dim: int, *,
                  device=None):
    """The memory stub of a batch of prompts, (len(prompts), length, dim):
    row i is :func:`text_memory` of a generator seeded by the sha256 of
    ``prompts[i]``, so a prompt's rows depend on that prompt alone,
    whatever batch it rides in.  ``functools.partial(prompt_memory,
    length=..., dim=...)`` is a serving engine's ``text_encoder``."""
    rows = []
    for prompt in prompts:
        digest = hashlib.sha256(str(prompt).encode("utf-8")).digest()
        seed = int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
        rows.append(text_memory(torch.Generator().manual_seed(seed), 1,
                                length, dim, device="cpu"))
    return torch.cat(rows).to(resolve_device(device))


@dataclasses.dataclass(frozen=True)
class CondLatents:
    """Text-conditioned latents: a memory stub and a latent whose
    low-frequency content is a linear readout of the memory."""
    latent_shape: Tuple[int, ...]
    cond_dim: int
    cond_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, *, device=None):
        """(x0 (batch, *latent_shape), memory (batch, cond_len,
        cond_dim)), float32, the same for the same (seed, step)."""
        dev = resolve_device(device)
        seed = int(np.random.SeedSequence([self.seed, step])
                   .generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        memory = torch.randn((self.batch, self.cond_len, self.cond_dim),
                             generator=gen)
        n = math.prod(self.latent_shape)
        # a fixed readout for every step
        wgen = torch.Generator().manual_seed(self.seed + 1)
        w = torch.randn((self.cond_dim, n), generator=wgen) / math.sqrt(
            self.cond_dim)
        x0 = (memory.mean(dim=1) @ w).reshape((self.batch,)
                                              + tuple(self.latent_shape))
        x0 = torch.tanh(x0) + 0.05 * torch.randn(x0.shape, generator=gen)
        return x0.to(dev), memory.to(dev)
