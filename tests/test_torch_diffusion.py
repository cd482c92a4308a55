"""The port's DiT denoiser against the JAX package's: after
``params_from_numpy`` the prediction and every collected branch leaf match,
with no skip and with a type skipped against a branch cache taken from the
reference (dit-xl-256 smoke, f32, tolerance 5e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, smoke_cfgs, smoke_params
from repro.core import diffusion as jd
from repro_torch.core import diffusion as td


def _inputs(seed, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return x, np.asarray(t, np.float32), np.asarray([3, 1000])  # 1000: null


def _branch_leaves(tree):
    """[(path, array)] over stages → blocks → branch names."""
    out = []
    for si, stage in enumerate(tree):
        for bi, d in enumerate(stage):
            for name in sorted(d or {}):
                out.append(((si, bi, name), d[name]))
    return out


def test_patchify_roundtrip_matches():
    cfg, tcfg = smoke_cfgs()
    x, _, _ = _inputs(0, [0, 0])
    tok = td.patchify(tcfg, torch.from_numpy(x))
    close(jd.patchify(cfg, jnp.asarray(x)), tok)
    assert torch.equal(td.unpatchify(tcfg, tok), torch.from_numpy(x))


def test_vp_schedule_close():
    close(jd.vp_schedule()["alpha_bar"], td.vp_schedule()["alpha_bar"],
          atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("skip", [None, {"attn": True, "ffn": False},
                                  {"attn": False, "ffn": True}])
def test_denoiser_and_branches_match(skip):
    cfg, tcfg = smoke_cfgs()
    pj, pt = smoke_params()
    # the branch cache comes from a reference call at an earlier step
    x0, t0, lab = _inputs(1, [981.0, 981.0])
    _, aux0 = jd.apply(cfg, pj, jnp.asarray(x0), jnp.asarray(t0),
                       label=jnp.asarray(lab), collect_branches=True)
    cache_j = aux0["branch"]
    cache_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), cache_j)
    x, t, lab = _inputs(2, [900.0, 900.0])
    kw_j = dict(label=jnp.asarray(lab), collect_branches=True, skip=skip,
                branch_caches=cache_j if skip else None)
    kw_t = dict(label=torch.from_numpy(lab), collect_branches=True,
                skip=skip, branch_caches=cache_t if skip else None)
    yj, auxj = jd.apply(cfg, pj, jnp.asarray(x), jnp.asarray(t), **kw_j)
    yt, auxt = td.apply(tcfg, pt, torch.from_numpy(x), torch.from_numpy(t),
                        **kw_t)
    assert float(jnp.abs(yj).max()) > 0.1, "parity must not be vacuous"
    close(yj, yt)
    lj, lt = _branch_leaves(auxj["branch"]), _branch_leaves(auxt["branch"])
    assert [p for p, _ in lj] == [p for p, _ in lt] and lj
    for (_, a), (_, b) in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape)      # (repeat, B, N, d)
        close(a, b)


def test_collect_subset_matches():
    """A collection of types keeps only those branches, as in JAX."""
    cfg, tcfg = smoke_cfgs()
    pj, pt = smoke_params()
    x, t, lab = _inputs(3, [500.0, 20.0])
    _, auxj = jd.apply(cfg, pj, jnp.asarray(x), jnp.asarray(t),
                       label=jnp.asarray(lab), collect_branches=("attn",))
    _, auxt = td.apply(tcfg, pt, torch.from_numpy(x), torch.from_numpy(t),
                       label=torch.from_numpy(lab), collect_branches=("attn",))
    assert [p for p, _ in _branch_leaves(auxt["branch"])] == [
        p for p, _ in _branch_leaves(auxj["branch"])] == [(0, 0, "mixer")]
