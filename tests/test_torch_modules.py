"""The port's model layers against the JAX package's, on the same numpy
inputs (dit-xl-256 smoke widths, f32, tolerance 5e-5)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, smoke_cfgs, smoke_params
from repro.models import attention as jattn, blocks as jblocks
from repro.models import layers as jL, mlp as jmlp
from repro_torch.models import attention as tattn, blocks as tblocks
from repro_torch.models import layers as tL, mlp as tmlp


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _block_params(r=0):
    pj, pt = smoke_params()
    sj = {k: {n: v[r] for n, v in d.items()}
          for k, d in pj["backbone"]["stages"][0][0].items()}
    st = {k: {n: v[r] for n, v in d.items()}
          for k, d in pt["backbone"]["stages"][0][0].items()}
    return sj, st


def test_layernorm_matches():
    x = _rand(2, 16, 128, scale=3.0) + 1.5
    p = {"scale": _rand(128, seed=1), "bias": _rand(128, seed=2)}
    close(jL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x)),
          tL.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x)))


def test_gelu_tanh_matches():
    x = _rand(4, 256, scale=4.0)
    close(jL.activation("gelu_tanh")(jnp.asarray(x)),
          tL.gelu_tanh(torch.from_numpy(x)))


@pytest.mark.parametrize("dim", [128, 256, 9])
def test_sinusoidal_embedding_matches(dim):
    pos = np.asarray([0.0, 1.0, 17.0, 500.0, 999.0], np.float32)
    close(jL.sinusoidal_embedding(jnp.asarray(pos), dim),
          tL.sinusoidal_embedding(torch.from_numpy(pos), dim))


def test_mlp_matches():
    cfg, tcfg = smoke_cfgs()
    sj, st = _block_params()
    x = _rand(2, 16, 128, seed=3)
    close(jmlp.apply(cfg.stages[0].unit[0].ffn, sj["ffn"], jnp.asarray(x)),
          tmlp.apply(tcfg.stages[0].unit[0].ffn, st["ffn"],
                     torch.from_numpy(x)))


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)])
def test_sdpa_matches(causal, window):
    q, k, v = (_rand(2, 16, 4, 32, seed=s) for s in (4, 5, 6))
    kk, vv = k[:, :, :2], v[:, :, :2]             # GQA 2:1
    pos = np.arange(16)[None]
    bj = jattn._mask_bias(jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                          window=window)
    bt = tattn._mask_bias(torch.from_numpy(pos), torch.from_numpy(pos),
                          causal=causal, window=window)
    close(bj, bt)
    scale = 1.0 / math.sqrt(32)
    close(jattn._sdpa(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), bj,
                      softcap=None, scale=scale),
          tattn._sdpa(torch.from_numpy(q), torch.from_numpy(kk),
                      torch.from_numpy(vv), bt, softcap=None, scale=scale))


def test_gqa_full_matches():
    """The port's self-attention (the kernel path; its plain version on the
    CPU) against the JAX package's default einsum path."""
    cfg, tcfg = smoke_cfgs()
    sj, st = _block_params(1)
    x = _rand(2, 16, 128, seed=8)
    oj, _ = jattn._gqa_full(cfg.stages[0].unit[0].mixer, sj["mixer"],
                            jnp.asarray(x), jnp.arange(16)[None])
    ot, _ = tattn._gqa_full(tcfg.stages[0].unit[0].mixer, st["mixer"],
                            torch.from_numpy(x))
    close(oj, ot)


@pytest.mark.parametrize("skip", [None, {"attn": True}, {"ffn": True},
                                  {"attn": True, "ffn": True}])
def test_block_apply_matches(skip):
    cfg, tcfg = smoke_cfgs()
    sj, st = _block_params()
    spec_j, spec_t = cfg.stages[0].unit[0], tcfg.stages[0].unit[0]
    x = _rand(2, 16, 128, seed=9)
    cond = _rand(2, 128, seed=10)
    cache = {"mixer": _rand(2, 16, 128, seed=11),
             "ffn": _rand(2, 16, 128, seed=12)}
    xj, boj, _, _ = jblocks.apply(
        spec_j, sj, jnp.asarray(x), d_model=128, cond=jnp.asarray(cond),
        skip=skip, branch_cache={k: jnp.asarray(v) for k, v in cache.items()},
        positions=jnp.arange(16)[None])
    xt, bot, _ = tblocks.apply(
        spec_t, st, torch.from_numpy(x), cond=torch.from_numpy(cond),
        skip=skip,
        branch_cache={k: torch.from_numpy(v) for k, v in cache.items()})
    close(xj, xt)
    assert sorted(boj) == sorted(bot)
    for name in boj:
        close(boj[name], bot[name])
