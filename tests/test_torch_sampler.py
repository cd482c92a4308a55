"""The port's DDIM solver and SmoothCache executor against the JAX
package's: identical model times, latents within 2e-4 over 10 DDIM steps
at cfg_scale 1.5 for the uncached and a mixed schedule, and, inside the
port, eager ≡ segmented bitwise with the liveness check on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, smoke_cfgs, smoke_params
from repro.core import executor as jex, schedule as jS, solvers as jsolvers
from repro_torch.core import executor as tex, plan as tplan
from repro_torch.core import schedule as tS, solvers as tsolvers

SAMPLE_TOL = dict(atol=2e-4, rtol=2e-4)
MIXED = {"attn": [0, 1, 1, 0, 1, 1, 0, 1, 0, 0],
         "ffn": [0, 1, 0, 1, 1, 0, 1, 1, 1, 0]}


@pytest.mark.parametrize("n", [6, 10, 20, 50])
def test_model_times_identical(n):
    ref = np.asarray(jsolvers.ddim(n).model_times)
    got = tsolvers.ddim(n).model_times.numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_ddim_step_close():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    eps = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    js, ts = jsolvers.ddim(10), tsolvers.ddim(10)
    for s in (0, 4, 9):
        xj, _ = js.step(jnp.asarray(x), jnp.asarray(eps), s, {})
        xt, state = ts.step(torch.from_numpy(x), torch.from_numpy(eps), s,
                            ts.init_state())
        assert state == {}
        close(xj, xt, atol=1e-5, rtol=1e-5)


def _executors():
    cfg, tcfg = smoke_cfgs()
    ej = jex.SmoothCacheExecutor(cfg, jsolvers.ddim(10), cfg_scale=1.5)
    et = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(10), cfg_scale=1.5,
                                 device="cpu")
    # torch cannot draw JAX's noise: hand the reference's latent to the port
    x0, _ = ej.initial_latent(jax.random.PRNGKey(2), 2)
    x0 = np.array(x0)
    et.initial_latent = lambda generator, batch: torch.from_numpy(x0.copy())
    return ej, et


def _schedules(kind):
    if kind == "no_cache":
        return None, None
    return (jS.Schedule({t: np.asarray(v, bool) for t, v in MIXED.items()},
                        10),
            tS.Schedule({t: np.asarray(v, bool) for t, v in MIXED.items()},
                        10))


@pytest.mark.parametrize("kind", ["no_cache", "mixed"])
def test_latents_match_reference(kind):
    ej, et = _executors()
    pj, pt = smoke_params()
    sj, st = _schedules(kind)
    label_j, label_t = jnp.asarray([3, 7]), torch.tensor([3, 7])
    ref = ej.sample(pj, jax.random.PRNGKey(2), 2, schedule=sj, label=label_j)
    ref_seg = ej.sample_compiled(pj, jax.random.PRNGKey(2), 2, schedule=sj,
                                 label=label_j)
    eager = et.sample(pt, None, 2, schedule=st, label=label_t)
    seg = et.sample_compiled(pt, None, 2, schedule=st, label=label_t,
                             check=True)
    assert np.isfinite(np.asarray(ref)).all()
    close(ref, eager, **SAMPLE_TOL)
    close(ref_seg, seg, **SAMPLE_TOL)
    assert torch.equal(eager, seg), "eager and segmented must be bitwise equal"


def test_cache_changes_the_result():
    """The mixed schedule really reads the cache (not vacuous parity)."""
    _, et = _executors()
    _, pt = smoke_params()
    _, st = _schedules("mixed")
    lab = torch.tensor([3, 7])
    assert not torch.equal(et.sample(pt, None, 2, label=lab),
                           et.sample(pt, None, 2, schedule=st, label=lab))


def test_run_state_liveness_and_boundaries():
    """check=True holds after every segment; a never-skipped type is never
    resident; incremental advance equals the one-shot sampler bitwise."""
    _, et = _executors()
    _, pt = smoke_params()
    sch = tS.Schedule({"attn": np.asarray([0, 1, 0, 1, 0, 1, 0, 1, 0, 0],
                                          bool),
                       "ffn": np.zeros(10, bool)}, 10)
    plan = tplan.analyze(sch)
    assert "ffn" not in plan.live_types()
    lab = torch.tensor([3, 7])
    rs = et.start_run(pt, None, 2, plan=plan, schedule=sch, label=lab)
    steps = []
    while not rs.done:
        steps.append(rs.step)
        rs = et.advance_run(pt, rs, check=True)
        names = {n for stage in rs.cache for d in stage for n in d}
        assert "ffn" not in names
    assert steps == [r.start for r in plan.runs]
    assert bool(rs.healthy.all())
    assert torch.equal(rs.x, et.sample_compiled(pt, None, 2, schedule=sch,
                                                label=lab))
    assert torch.equal(rs.x, et.sample(pt, None, 2, schedule=sch, label=lab))


def test_plan_mismatch_rejected():
    _, et = _executors()
    _, pt = smoke_params()
    sch = tS.fora(["attn", "ffn"], 10, 2)
    other = tplan.analyze(tS.fora(["attn", "ffn"], 10, 3))
    with pytest.raises(ValueError, match="fingerprint"):
        et.start_run(pt, None, 2, plan=other, schedule=sch)
