"""The port's calibration, policies, artifacts and pipeline against the JAX
package's (dit-xl-256 smoke, DDIM 6, cfg_scale 1.5)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, smoke_cfgs, smoke_params
from repro import cache as jcache
from repro.core import calibration as jcal, executor as jex
from repro.core import solvers as jsolvers
from repro_torch import cache as tcache
from repro_torch.core import calibration as tcal, executor as tex
from repro_torch.core import solvers as tsolvers

CURVE_TOL = dict(rtol=1e-4, atol=1e-7)
SPECS = ["none", "static:n=3", "smoothcache:alpha=0.18",
         "smoothcache:alpha=0.6,k_max=2", "budget:target=0.6",
         "per_type(attn=smoothcache(alpha=0.3),ffn=static(n=2))"]
LABELS = [3, 7]


def _x0(key=1, batch=2):
    cfg, _ = smoke_cfgs()
    ex = jex.SmoothCacheExecutor(cfg, jsolvers.ddim(6), cfg_scale=1.5)
    return np.array(ex.initial_latent(jax.random.PRNGKey(key), batch)[0])


def _feed(executor, x0):
    """Torch cannot draw JAX's noise: hand the reference's latent over."""
    executor.initial_latent = lambda generator, batch: torch.from_numpy(
        x0.copy())


@pytest.fixture(scope="module")
def reference_record():
    cfg, _ = smoke_cfgs()
    pj, _ = smoke_params()
    ex = jex.SmoothCacheExecutor(cfg, jsolvers.ddim(6), cfg_scale=1.5)
    return jcal.calibrate_record(ex, pj, jax.random.PRNGKey(1), 2,
                                 cond_args={"label": jnp.asarray(LABELS)},
                                 k_max=3)


def test_calibration_matches_reference(reference_record):
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(6), cfg_scale=1.5,
                                 device="cpu")
    _feed(ex, _x0())
    rec = tcal.calibrate_record(ex, pt, torch.Generator(), 2,
                                cond_args={"label": torch.tensor(LABELS)},
                                k_max=3)
    ref = reference_record
    assert rec.cfg_halved and sorted(rec.curves) == sorted(ref.curves)
    for t in ref.curves:
        assert rec.curves[t].shape == (6, 4)
        assert rec.per_sample[t].shape == (2, 6, 4)
        np.testing.assert_allclose(rec.curves[t], ref.curves[t], **CURVE_TOL)
        np.testing.assert_allclose(rec.per_sample[t], ref.per_sample[t],
                                   **CURVE_TOL)
    np.testing.assert_allclose(rec.proxies, ref.proxies, **CURVE_TOL)
    close(ref.x0, rec.x0, atol=2e-4, rtol=2e-4)
    for t, (a, b) in ref.proxy_map.coeffs.items():
        np.testing.assert_allclose(rec.proxy_map.coeffs[t], (a, b),
                                   rtol=1e-3, atol=1e-6)


def test_error_curves_from_trajectory_match():
    """The streaming curve arithmetic against the reference's on the same
    per-step branch outputs, lags longer than the trajectory included."""
    cfg, tcfg = smoke_cfgs()
    rng = np.random.default_rng(4)
    per_step = [{t: [rng.standard_normal((3, 16, 8)).astype(np.float32)
                     for _ in range(2)] for t in ("attn", "ffn")}
                for _ in range(5)]
    mj, sj = jcal.error_curves_from_trajectory(cfg, per_step, k_max=3)
    mt, st = tcal.error_curves_from_trajectory(
        tcfg, [{t: [torch.from_numpy(a) for a in arrs]
                for t, arrs in by.items()} for by in per_step], k_max=3)
    for t in ("attn", "ffn"):
        np.testing.assert_allclose(mt[t], mj[t], **CURVE_TOL)
        np.testing.assert_allclose(st[t], sj[t], **CURVE_TOL)


@pytest.mark.parametrize("spec", SPECS)
def test_policies_build_identical_masks(reference_record, spec):
    curves = reference_record.curves
    types = sorted(curves)
    pj_, pt_ = jcache.get(spec), tcache.get(spec)
    assert pj_.to_config() == pt_.to_config() and pj_.spec() == pt_.spec()
    cj = curves if pj_.requires_calibration else None
    sj, st = pj_.build(types, 6, cj), pt_.build(types, 6, cj)
    assert st.to_json() == sj.to_json()


def test_reference_artifact_drives_port(tmp_path, reference_record):
    cfg, tcfg = smoke_cfgs()
    pj, pt = smoke_params()
    jpipe = jcache.DiffusionPipeline(cfg, jsolvers.ddim(6),
                                     "smoothcache:alpha=0.6", cfg_scale=1.5)
    jpipe.calibrate(pj, jax.random.PRNGKey(1), 2,
                    cond_args={"label": jnp.asarray(LABELS)})
    assert any(v.any() for v in jpipe.schedule.skip.values())
    path = jpipe.save_artifact(str(tmp_path / "ref.cache.json"))
    tpipe = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(6),
                                     "smoothcache:alpha=0.6", cfg_scale=1.5,
                                     device="cpu")
    art = tpipe.load_artifact(path, strict=True)
    assert tpipe.schedule.to_json() == jpipe.schedule.to_json()
    assert tpipe.plan.to_json() == jpipe.plan.to_json()
    assert art.to_json() == jpipe.artifact.to_json()
    # the port serves the same plan: latents agree with the reference's
    _feed(tpipe.executor, _x0(key=5))
    xj = jpipe.generate(pj, jax.random.PRNGKey(5), 2,
                        label=jnp.asarray(LABELS))
    xt = tpipe.generate(pt, None, 2, label=torch.tensor(LABELS))
    close(xj, xt, atol=2e-4, rtol=2e-4)
    # a strict load refuses another deployment
    other = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(6), cfg_scale=2.0,
                                     device="cpu")
    with pytest.raises(ValueError, match="cfg_scale"):
        other.load_artifact(path, strict=True)


def test_port_artifact_roundtrip_keeps_checksum(tmp_path):
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(6),
                                    "smoothcache:alpha=0.18", cfg_scale=1.5,
                                    device="cpu")
    art = pipe.calibrate(pt, torch.Generator().manual_seed(0), 2,
                         cond_args={"label": torch.tensor(LABELS)})
    path = pipe.save_artifact(str(tmp_path / "port.cache.json"))
    raw = json.loads(open(path).read())
    loaded = tcache.CacheArtifact.load(path)
    assert json.loads(loaded.to_json())["checksum"] == raw["checksum"]
    assert loaded.to_json() == art.to_json()
    # the JAX package accepts the port's artifact too
    assert jcache.CacheArtifact.load(path).to_json() == art.to_json()
    raw["num_steps"] = 7
    bad = tmp_path / "bad.cache.json"
    bad.write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="checksum"):
        tcache.CacheArtifact.load(str(bad))


def test_adaptive_host_loop_and_uncompiled_base():
    """The host-dispatched loop (the non-fused route): finite latents, one
    decision per step, step 0 computing everything, one decision sync per
    step after the first, and the decisions and latents of ``generate``'s
    fused route; ``compiled=False`` runs the static base schedule."""
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(6),
                                    "adaptive:base=static(n=2),tau=0.1",
                                    cfg_scale=1.5, device="cpu")
    pipe.calibrate(pt, torch.Generator().manual_seed(0), 2,
                   cond_args={"label": torch.tensor(LABELS)})
    ex = pipe.executor
    x, dec = ex.sample_adaptive(
        pt, torch.Generator().manual_seed(1), 2, schedule=pipe.schedule,
        tau=pipe.policy.tau, proxy_map=pipe.proxy_map,
        k_max=pipe.policy.k_max, label=torch.tensor(LABELS),
        return_decisions=True)
    assert bool(torch.isfinite(x).all()) and len(dec) == 6
    assert dec[0] == () and ex.host_sync_count == 5
    x_gen, dec_gen = pipe.generate(pt, torch.Generator().manual_seed(1), 2,
                                   label=torch.tensor(LABELS),
                                   return_decisions=True)
    assert ex.host_sync_count == 5              # generate took the fused route
    assert dec_gen == dec and torch.equal(x_gen, x)
    x_base = pipe.generate(pt, torch.Generator().manual_seed(1), 2,
                           label=torch.tensor(LABELS), compiled=False)
    assert torch.equal(x_base, pipe.executor.sample(
        pt, torch.Generator().manual_seed(1), 2, schedule=pipe.schedule,
        label=torch.tensor(LABELS)))
