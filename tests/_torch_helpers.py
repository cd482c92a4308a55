"""Shared inputs for the parity tests of the PyTorch port (``repro_torch``)
against the JAX package: the dit-xl-256 and mamba2-1.3b smoke configs of
both packages and one seeded parameter set of each, handed to each side
from numpy."""
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


def to_np(a):
    """A jax array or a CPU tensor (any float dtype) → float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or F32))
