"""Synthetic data (the JAX package's ``repro.data.synthetic``): token
streams for the LMs, with a planted bigram and, for MusicGen, a token per
codebook; a stub of a T5-style text memory (drawn from a generator, or per
prompt for a serving engine's ``text_encoder``); a stub of a ViT's patch
embeddings, the prefix of InternVL2 and Llama-4; text-conditioned latents
whose low-frequency content is a linear readout of that memory; and
class-conditional latents, a Gaussian blob at a class-dependent position
with a class-dependent channel signature (DiT's training data).

Drawn on the CPU from a ``torch.Generator``, so a seed gives the same bits
on every device, then moved to the device (``cuda`` unless the caller
passes ``device="cpu"``).  The bits differ from JAX's: parity tests feed
numpy memory, prompts and prefixes to both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for (seed, step), the same on every host."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """LM token batches with planted structure: with probability 0.5 a
    token is (previous * 31 + 7) mod V, else uniform (the previous of
    position 0 is the last, as the JAX package's ``roll`` gives)."""
    vocab_size: int
    seq_len: int
    batch: int
    num_codebooks: int = 1
    seed: int = 0

    def batch_at(self, step: int, *, device=None):
        """(tokens, targets), each (batch, seq_len) or (batch, seq_len, K)
        int64, targets the tokens shifted by one; the same for the same
        (seed, step)."""
        dev = resolve_device(device)
        gen = step_generator(self.seed, step)
        shape = (self.batch, self.seq_len + 1)
        if self.num_codebooks > 1:
            shape = shape + (self.num_codebooks,)
        v = self.vocab_size
        base = torch.randint(0, v, shape, generator=gen)
        copy = (torch.roll(base, 1, dims=1) * 31 + 7) % v
        mask = torch.rand(shape, generator=gen) < 0.5
        toks = torch.where(mask, copy, base).to(dev)
        return toks[:, :-1], toks[:, 1:]


def vit_patch_embeds(generator: torch.Generator, batch: int,
                     num_patches: int, dim: int, *, device=None):
    """Precomputed ViT patch embeddings (InternViT, Llama-4's early
    fusion): N(0, 0.02²) of shape (batch, num_patches, dim)."""
    emb = torch.randn((batch, num_patches, dim), generator=generator) * 0.02
    return emb.to(resolve_device(device))


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


def render_blobs(latent_shape, num_classes: int, label, noise):
    """The deterministic half of :class:`BlobLatents`: labels (B,) int and
    noise (B, H, W, C) → x0 (B, H, W, C) f32 on their device.  Class c puts
    a blob of width H/8 at angle 2πc / num_classes on a circle of radius
    (H/4, W/4) about the centre, times the channel signature cos(angle ·
    (i + 1)) for channel i, plus 0.05 · noise."""
    h, w, c = latent_shape
    dev = label.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    ang = 2 * math.pi * label.float() / max(num_classes, 1)
    cy = h / 2 + (h / 4) * torch.sin(ang)
    cx = w / 2 + (w / 4) * torch.cos(ang)
    d2 = ((yy[None] - cy[:, None, None]) ** 2
          + (xx[None] - cx[:, None, None]) ** 2)
    blob = torch.exp(-d2 / (2.0 * (h / 8) ** 2))              # (B, H, W)
    sig = torch.stack([torch.cos(ang * (i + 1)) for i in range(c)], -1)
    x0 = blob[..., None] * sig[:, None, None, :]
    return (x0 + 0.05 * noise).float()


@dataclasses.dataclass(frozen=True)
class BlobLatents:
    """Class-conditional latents, learnable by a small DiT: a Gaussian blob
    whose position and channel signature follow the class
    (:func:`render_blobs`)."""
    latent_shape: Tuple[int, ...]        # (H, W, C)
    num_classes: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, *, device=None):
        """(x0 (batch, H, W, C) f32, label (batch,) int64) on ``device``:
        the labels and noise drawn on the CPU for (seed, step), the blobs
        rendered on the device."""
        dev = resolve_device(device)
        gen = step_generator(self.seed, step)
        label = torch.randint(0, self.num_classes, (self.batch,),
                              generator=gen)
        noise = torch.randn((self.batch,) + tuple(self.latent_shape),
                            generator=gen)
        label = label.to(dev)
        return (render_blobs(self.latent_shape, self.num_classes, label,
                             noise.to(dev)), label)


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
        gen = step_generator(self.seed, step)
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
