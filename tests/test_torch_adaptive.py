"""The port's input-adaptive path (host-dispatched ``sample_adaptive``)
against the JAX package's, and its contracts torch against torch.

Parity: ``rel_l1_change_rows``, ``runtime_rule`` and ``batch_rule`` on
seeded numpy inputs (decisions exact, accumulators within 5e-5); and
``sample_adaptive`` on the dit-xl-256 smoke DiT (DDIM 8, cfg_scale 1.5)
fed the reference's initial latent and artifact — per-step accumulators
within 5e-5, decisions equal on every step whose decision margin
``|acc + delta − τ|`` exceeds 1e-4 (torch and JAX f32 reductions may
differ in the last bit), final latents within 5e-5 of the latents' scale.

Inside the port: τ = 0 ≡ ``sample_compiled`` bitwise; decisions obey
k_max; validation of τ, k_max and the proxy map; the artifact round-trip
and a τ mismatch refused; an explicit schedule stays static; generate
runs the host loop when the fused path is off; the health fold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from repro import cache as jcache
from repro.core import calibration as jcal
from repro.core import solvers as jsolvers
from repro_torch import cache as tcache
from repro_torch.core import calibration as tcal, executor as tex
from repro_torch.core import plan as tplan, schedule as tS
from repro_torch.core import solvers as tsolvers

ACC_TOL = 5e-5
MARGIN = 1e-4
STEPS = 8
TAU = 0.3
SPEC = f"adaptive:base=smoothcache(alpha=0.5),tau={TAU}"
LABELS = [3, 7]


# ---------------------------------------------------------------------------
# The decision rule (pure)
# ---------------------------------------------------------------------------

def _rule_inputs(seed, b=5, t=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cur, prev = f(b, 4, 6, 2), f(b, 4, 6, 2)
    proxy = np.abs(f(b)) * 0.3
    acc = np.abs(f(b, t)) * 0.1
    lag = rng.integers(0, 4, (b, t)).astype(np.int32)
    a, bb = f(t) * 0.2, f(t) * 0.05
    return cur, prev, proxy, acc, lag, a, bb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rel_l1_change_rows_matches_reference(seed):
    cur, prev, *_ = _rule_inputs(seed)
    ref = np.asarray(jcal.rel_l1_change_rows(jnp.asarray(cur),
                                             jnp.asarray(prev)))
    got = tcal.rel_l1_change_rows(torch.from_numpy(cur),
                                  torch.from_numpy(prev)).numpy()
    assert got.dtype == np.float32 and got.shape == (cur.shape[0],)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed,tau,k_max,force", [
    (0, 0.15, 3, False), (1, 0.3, 2, False), (2, 0.05, 1, False),
    (3, 0.3, 3, True)])
def test_runtime_rule_matches_reference(seed, tau, k_max, force):
    _, _, proxy, acc, lag, a, b = _rule_inputs(seed)
    for row in range(proxy.shape[0]):
        ref = jcal.runtime_rule(jnp.float32(proxy[row]), jnp.asarray(acc[row]),
                                jnp.asarray(lag[row]), jnp.asarray(a),
                                jnp.asarray(b), tau, k_max, force)
        got = tcal.runtime_rule(torch.tensor(proxy[row]),
                                torch.from_numpy(acc[row]),
                                torch.from_numpy(lag[row]),
                                torch.from_numpy(a), torch.from_numpy(b),
                                tau, k_max, force)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=ACC_TOL, rtol=0)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert got[2].dtype == torch.int32


@pytest.mark.parametrize("seed,tau,k_max", [(0, 0.15, 3), (1, 0.3, 2),
                                            (4, 0.2, 3), (5, 1.0, 1)])
def test_batch_rule_matches_reference(seed, tau, k_max):
    _, _, proxy, acc, lag, a, b = _rule_inputs(seed)
    ref = jcal.batch_rule(*(jnp.asarray(v) for v in (proxy, acc, lag, a, b)),
                          tau, k_max)
    got = tcal.batch_rule(*(torch.from_numpy(v)
                            for v in (proxy, acc, lag, a, b)), tau, k_max)
    for i in (0, 1, 3):                       # want, realized, lag: exact
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               atol=ACC_TOL, rtol=0)
    # the realized bits are the AND of the rows' wants
    assert torch.equal(got[1], got[0].all(dim=0))


def test_rule_clamps_negative_estimates():
    """``max(a·proxy + b, 0)``: a negative fit never shrinks the
    accumulator while skipping."""
    acc = torch.tensor([[0.1, 0.1]])
    _, realized, acc2, _ = tcal.batch_rule(
        torch.tensor([1.0]), acc, torch.zeros((1, 2), dtype=torch.int32),
        torch.tensor([-5.0, 0.0]), torch.tensor([0.0, 0.01]), 0.5, 3)
    assert realized.tolist() == [True, True]
    np.testing.assert_allclose(acc2.numpy(), [[0.1, 0.11]], rtol=1e-6)


# ---------------------------------------------------------------------------
# sample_adaptive against the reference (smoke DiT)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX pipeline calibrated under the adaptive policy, its saved
    artifact, and the port's pipeline loaded from it."""
    cfg, tcfg = smoke_cfgs()
    pj, _ = smoke_params()
    jp = jcache.DiffusionPipeline(cfg, jsolvers.ddim(STEPS), SPEC,
                                  cfg_scale=1.5)
    jp.calibrate(pj, jax.random.PRNGKey(1), 2,
                 cond_args={"label": jnp.asarray(LABELS)})
    path = str(tmp_path_factory.mktemp("adaptive") / "ref.cache.json")
    jp.save_artifact(path)
    tp = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(STEPS), SPEC,
                                  cfg_scale=1.5, device="cpu")
    tp.load_artifact(path)
    return jp, tp, path


def _margin(rs):
    """Smallest ``|acc + delta − τ|`` over rows and types at the step
    ``rs`` is about to decide."""
    proxy = tcal.rel_l1_change_rows(rs.x, rs.x_prev)
    delta = torch.clamp_min(rs.coeff_a * proxy[:, None]
                            + rs.coeff_b[None, :], 0.0)
    return float((rs.acc + delta - rs.tau).abs().min())


@pytest.mark.parametrize("seed", [2, 5, 11])
def test_sample_adaptive_matches_reference(reference, seed):
    jp, tp, _ = reference
    pj, pt = smoke_params()
    lab = [seed % 10, (3 * seed) % 10]
    ej, et = jp.executor, tp.executor
    x0 = np.array(ej.initial_latent(jax.random.PRNGKey(seed), 2)[0])
    et.initial_latent = lambda generator, batch: torch.from_numpy(x0.copy())
    kw = dict(tau=TAU, k_max=jp.policy.k_max)
    rj = ej.start_adaptive_run(pj, jax.random.PRNGKey(seed), 2,
                               schedule=jp.schedule, proxy_map=jp.proxy_map,
                               label=jnp.asarray(lab), **kw)
    rt = et.start_adaptive_run(pt, None, 2, schedule=tp.schedule,
                               proxy_map=tp.proxy_map,
                               label=torch.tensor(lab), **kw)
    syncs, clear_skips = et.host_sync_count, 0
    while not rt.done:
        margin = _margin(rt) if rt.step > 0 else None
        rj = ej.advance_adaptive_run(pj, rj)
        rt = et.advance_adaptive_run(pt, rt)
        np.testing.assert_allclose(rt.acc.numpy(), np.asarray(rj.acc),
                                   atol=ACC_TOL, rtol=0)
        if margin is not None and margin > MARGIN:
            assert rt.decisions[-1] == rj.decisions[-1], rt.step
            clear_skips += bool(rt.decisions[-1])
    assert clear_skips >= 1, "no step skipped with a clear margin"
    assert rt.decisions[0] == ()                # step 0 computes all
    assert et.host_sync_count - syncs == STEPS - 1
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    assert np.isfinite(xt).all() and bool(rt.healthy.all())
    scale = float(np.abs(xj).max())
    assert float(np.abs(xt - xj).max()) <= ACC_TOL * scale


# ---------------------------------------------------------------------------
# Contracts inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_pipe():
    """A port pipeline calibrated (in the port) under the adaptive
    policy."""
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(STEPS), SPEC,
                                    cfg_scale=1.5, device="cpu")
    pipe.calibrate(pt, torch.Generator().manual_seed(1), 2,
                   cond_args={"label": torch.tensor(LABELS)})
    return pipe


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_tau0_bitwise_equals_sample_compiled(port_pipe):
    _, pt = smoke_params()
    _, tcfg = smoke_cfgs()
    sch = port_pipe.schedule
    assert any(v.any() for v in sch.skip.values())
    lab = torch.tensor(LABELS)
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(STEPS), cfg_scale=1.5,
                                 device="cpu")
    x_ad, dec = ex.sample_adaptive(pt, _gen(2), 2, schedule=sch, tau=0.0,
                                   label=lab, return_decisions=True)
    x_st = ex.sample_compiled(pt, _gen(2), 2, schedule=sch, label=lab)
    assert torch.equal(x_ad, x_st)
    assert ex.host_sync_count == 0              # τ = 0 never reads bits
    assert dec == tuple(tuple(t for t, sk in sch.mask_key_at(s) if sk)
                        for s in range(STEPS))
    pool = tplan.mask_lattice(sch)
    assert 0 < ex.compiled_variant_count("sigstep") <= len(pool)


def test_decisions_respect_k_max():
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(
        tcfg, tsolvers.ddim(STEPS),
        "adaptive:base=smoothcache(alpha=0.5),tau=100.0", cfg_scale=1.5,
        device="cpu")
    pipe.calibrate(pt, _gen(1), 2, cond_args={"label": torch.tensor(LABELS)})
    _, dec = pipe.generate(pt, _gen(5), 2, label=torch.tensor(LABELS),
                           return_decisions=True)
    # an absurdly large τ reuses as hard as allowed: the cache age caps
    # at k_max, so every k_max+1-long window recomputes
    k_max = pipe.policy.k_max
    assert len(dec) == STEPS and dec[0] == ()
    assert any(dec)
    age = {t: 0 for t in tcfg.layer_types()}
    for step in dec:
        for t in tcfg.layer_types():
            age[t] = age[t] + 1 if t in step else 0
            assert age[t] <= k_max


def test_tau_without_proxy_map_raises():
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(6), cfg_scale=1.5,
                                 device="cpu")
    sch = tS.fora(tcfg.layer_types(), 6, 2)
    lab = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="proxy_map"):
        ex.sample_adaptive(pt, _gen(0), 1, schedule=sch, tau=0.1, label=lab)
    partial = tcal.ProxyMap({"attn": (0.1, 0.0)})
    with pytest.raises(ValueError, match="lacks coefficients"):
        ex.start_adaptive_run(pt, _gen(0), 1, schedule=sch, tau=0.1,
                              proxy_map=partial, label=lab)
    with pytest.raises(ValueError, match="tau must be >= 0"):
        ex.start_adaptive_run(pt, _gen(0), 1, schedule=sch, tau=-0.1,
                              label=lab)
    with pytest.raises(ValueError, match="steps"):
        ex.start_adaptive_run(pt, _gen(0), 1,
                              schedule=tS.fora(tcfg.layer_types(), 5, 2),
                              tau=0.0, label=lab)


def test_k_max_validated_everywhere():
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    for bad in ("adaptive:base=static(n=2),k_max=0", "adaptive:base=none"):
        with pytest.raises(ValueError, match="k_max must be >= 1"):
            tcache.get(bad)
    with pytest.raises(ValueError, match="k_max must be >= 1"):
        tcache.AdaptivePolicy(base="static:n=2", k_max=-3)
    p = tcache.get("adaptive:base=static(n=2),tau=0.1,k_max=5")
    assert p.k_max == 5 and tcache.get(p.spec()) == p
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(6), cfg_scale=1.5,
                                 device="cpu")
    with pytest.raises(ValueError, match="k_max must be >= 1"):
        ex.start_adaptive_run(pt, _gen(0), 1,
                              schedule=tS.fora(tcfg.layer_types(), 6, 2),
                              tau=0.0, k_max=0,
                              label=torch.zeros(1, dtype=torch.int64))


def test_artifact_roundtrip_and_tau_mismatch(port_pipe, tmp_path):
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    path = port_pipe.save_artifact(str(tmp_path / "adaptive.cache.json"))
    serve = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(STEPS), SPEC,
                                     cfg_scale=1.5, device="cpu")
    art = serve.load_artifact(path)
    assert art.adaptive == port_pipe.artifact.adaptive
    assert serve.proxy_map == port_pipe.proxy_map
    lab = torch.tensor(LABELS)
    x1, d1 = port_pipe.generate(pt, _gen(9), 2, label=lab,
                                return_decisions=True)
    x2, d2 = serve.generate(pt, _gen(9), 2, label=lab,
                            return_decisions=True)
    assert d1 == d2 and torch.equal(x1, x2)
    other = tcache.DiffusionPipeline(
        tcfg, tsolvers.ddim(STEPS),
        "adaptive:base=smoothcache(alpha=0.5),tau=0.05", cfg_scale=1.5,
        device="cpu")
    with pytest.raises(ValueError, match="tau"):
        other.load_artifact(path)
    other.load_artifact(path, strict=False)     # explicit override works


def test_explicit_schedule_override_is_static(port_pipe):
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    sch = tS.fora(tcfg.layer_types(), STEPS, 2)
    lab = torch.tensor(LABELS)
    x = port_pipe.generate(pt, _gen(2), 2, label=lab, schedule=sch)
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(STEPS), cfg_scale=1.5,
                                 device="cpu")
    assert torch.equal(x, ex.sample_compiled(pt, _gen(2), 2, schedule=sch,
                                             label=lab))
    with pytest.raises(ValueError, match="return_decisions"):
        port_pipe.generate(pt, _gen(2), 2, label=lab, schedule=sch,
                           return_decisions=True)


def test_generate_runs_the_host_loop(port_pipe, monkeypatch):
    """The DDIM executor has the fused path and divisible run states
    (``supports_*`` follow the solver, as in the JAX package); an executor
    whose solver cannot run inside a captured step takes the
    host-dispatched loop from generate(), one decision sync per τ > 0
    step after the first, with the fused path's decisions and latents."""
    _, pt = smoke_params()
    ex = port_pipe.executor
    assert ex.supports_fused_adaptive and ex.supports_split
    fused_x, fused_dec = port_pipe.generate(pt, _gen(2), 2,
                                            label=torch.tensor(LABELS),
                                            return_decisions=True)
    monkeypatch.setattr(tex.SmoothCacheExecutor, "supports_fused_adaptive",
                        False)
    called = {}
    orig = tex.SmoothCacheExecutor.sample_adaptive

    def spy(self, *a, **kw):
        called["host"] = True
        return orig(self, *a, **kw)

    monkeypatch.setattr(tex.SmoothCacheExecutor, "sample_adaptive", spy)
    before = ex.host_sync_count
    x, dec = port_pipe.generate(pt, _gen(2), 2, label=torch.tensor(LABELS),
                                return_decisions=True)
    assert called.get("host") and len(dec) == STEPS
    assert ex.host_sync_count - before == STEPS - 1
    assert bool(torch.isfinite(x).all())
    assert dec == fused_dec and torch.equal(x, fused_x)


def test_health_folds_latent_and_accumulator_finiteness():
    """Per-row health folds the latent's and the accumulator's
    finiteness on the device; a poisoned row stays flagged."""
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(6), cfg_scale=1.5,
                                 device="cpu")
    sch = tS.fora(tcfg.layer_types(), 6, 2)
    rs = ex.start_adaptive_run(pt, _gen(0), 3, schedule=sch, tau=0.0,
                               label=torch.zeros(3, dtype=torch.int64))
    rs = ex.advance_adaptive_run(pt, rs)
    assert rs.healthy.tolist() == [True, True, True]
    rs.acc[1, 0] = float("nan")               # τ = 0 carries acc as is
    rs.x[2].fill_(float("inf"))
    rs = ex.advance_adaptive_run(pt, rs)
    assert rs.healthy.tolist() == [True, False, False]
    while not rs.done:
        rs = ex.advance_adaptive_run(pt, rs)
    assert rs.healthy.tolist() == [True, False, False]
    with pytest.raises(ValueError, match="complete"):
        ex.advance_adaptive_run(pt, rs)
