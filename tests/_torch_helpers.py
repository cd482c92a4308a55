"""Shared inputs for the parity tests of the PyTorch port (``repro_torch``)
against the JAX package: the dit-xl-256, mamba2-1.3b, opensora-v12 and
stable-audio-open smoke configs of both packages and one seeded parameter
set of each,
handed to each side from numpy; and a numpy emulation of the kernels'
TF32 tensor-core products."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core import diffusion as jdiffusion
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy

F32 = dict(atol=5e-5, rtol=5e-5)


def smoke_cfgs():
    return (jconfigs.get("dit-xl-256", "smoke"),
            tconfigs.get("dit-xl-256", "smoke"))


@functools.lru_cache(maxsize=1)
def _numpy_params():
    """Reference init plus a seeded +0.05·N(0,1) on every leaf, so that the
    adaLN-zero leaves are not zero and every branch matters."""
    cfg, _ = smoke_cfgs()
    p = jdiffusion.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def smoke_params():
    """(jax params, torch params on the CPU) with identical values."""
    pn = _numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def lm_smoke_cfgs():
    return (jconfigs.get("mamba2-1.3b", "smoke"),
            tconfigs.get("mamba2-1.3b", "smoke"))


@functools.lru_cache(maxsize=1)
def _lm_numpy_params():
    """Reference init plus a seeded +0.05·N(0,1) on every leaf, so that the
    zero-initialized conv bias and norm scales matter."""
    cfg, _ = lm_smoke_cfgs()
    p = jT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def lm_smoke_params():
    """(jax params, torch params on the CPU) of the mamba2-1.3b smoke config
    with identical values."""
    pn = _lm_numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def video_cfgs():
    return (jconfigs.get("opensora-v12", "smoke"),
            tconfigs.get("opensora-v12", "smoke"))


@functools.lru_cache(maxsize=1)
def _video_numpy_params():
    """Reference init plus a seeded +0.05·N(0,1) on every leaf, so that the
    adaLN-zero leaves are not zero and every branch matters."""
    cfg, _ = video_cfgs()
    p = jdiffusion.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(13)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def video_params():
    """(jax params, torch params on the CPU) of the opensora-v12 smoke
    config with identical values."""
    pn = _video_numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def audio_cfgs():
    return (jconfigs.get("stable-audio-open", "smoke"),
            tconfigs.get("stable-audio-open", "smoke"))


@functools.lru_cache(maxsize=1)
def _audio_numpy_params():
    """Reference init plus a seeded +0.05·N(0,1) on every leaf, so that the
    adaLN-zero leaves are not zero and every branch matters."""
    cfg, _ = audio_cfgs()
    p = jdiffusion.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(17)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def audio_params():
    """(jax params, torch params on the CPU) of the stable-audio-open smoke
    config with identical values."""
    pn = _audio_numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def to_np(a):
    """A jax array or a CPU tensor (any float dtype) → float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest with ties
    away from zero, keeping 10 mantissa bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_rz(x):
    """Round f32 to TF32 toward zero: clear the 13 bits past TF32's, as the
    tensor cores read an f32 register given to a TF32 product."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_matmul(a, b, split, rnd=tf32):
    """a @ b as the kernels' tensor cores compute it in f32: one TF32
    product, or the 3xTF32 split small·big + big·small + big·big (each
    product of two TF32 values is exact in f32); ``rnd`` rounds each part
    to TF32 (``tf32``: to nearest, as the flash-attention kernel rounds;
    ``tf32_rz``: toward zero, as the SSD kernel does)."""
    ab, bb = rnd(a), rnd(b)
    if not split:
        return ab @ bb
    asm, bsm = rnd(a - ab), rnd(b - bb)
    return asm @ bb + ab @ bsm + ab @ bb


def close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or F32))
