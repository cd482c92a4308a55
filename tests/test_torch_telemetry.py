"""The port's per-request cache telemetry (``repro_torch.obs.report`` and
the fused step's ``proxy_trace``) against the JAX package's
``repro.obs.report``.

* The report functions give the reference's reports on the same decision
  and schedule inputs (static schedules, realized decisions, fused
  traces with and without proxies, nothing to report).
* On the smoke DiT (CPU): a telemetry run fed the reference's initial
  latent records proxies within 1e-4 relative of the JAX fused run's for
  every step from 1 on (step 0 is masked in both: ``x_prev`` is zeros
  there), with the same decisions; telemetry on ≡ off bitwise with no
  decision sync; a split and a merge carry the proxy rows; an engine
  with a tracer and telemetry ≡ one with both off bitwise, each served
  request's report realizing its batch's decisions.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from repro import cache as jcache, obs as jobs
from repro.core import schedule as jS, solvers as jsolvers
from repro_torch import cache as tcache, obs, serve
from repro_torch.core import executor as tex, schedule as tS, solvers
from repro_torch.obs import (CacheReport, Tracer, fused_cache_reports,
                             run_cache_reports, schedule_cache_report,
                             validate_chrome_trace)

#: proxies from step 1 on, port against the JAX fused run: relative
PROXY_RTOL = 1e-4
STEPS = 8
TAU = 0.3
SPEC = f"adaptive:base=smoothcache(alpha=0.5),tau={TAU}"
LABELS = [3, 7]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fields(rep):
    return (rep.tau, rep.types, rep.desired, rep.realized, rep.proxy,
            rep.to_jsonable())


# ---------------------------------------------------------------------------
# Report functions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tau", [0.0, 0.2])
def test_schedule_reports_match_the_reference(n, tau):
    types = ("attn", "ffn")
    got = schedule_cache_report(tS.fora(types, 6, n), tau=tau)
    want = jobs.schedule_cache_report(jS.fora(types, 6, n), tau=tau)
    assert _fields(got) == _fields(want)
    assert got.proxy_vs_threshold()[0]["proxy"] is None


@dataclasses.dataclass
class _Decided:
    decisions: tuple
    tau: float = 0.1


@dataclasses.dataclass
class _Fused:
    """A fused run state's report surface: the (S, B, T) trace, the step,
    the pool types, τ and optionally the (S, B) proxy trace."""
    trace: object
    step: int
    pool_types: tuple
    tau: float
    proxy_trace: object = None


def _fused_inputs(seed, proxy):
    rng = np.random.default_rng(seed)
    trace = rng.random((6, 3, 2)) < 0.6
    pt = (rng.random((6, 3)).astype(np.float32) * 0.3) if proxy else None
    return trace, pt


@pytest.mark.parametrize("proxy", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_reports_match_the_reference(seed, proxy):
    trace, pt = _fused_inputs(seed, proxy)
    got = fused_cache_reports(_Fused(
        torch.from_numpy(trace), 5, ("attn", "ffn"), 0.2,
        None if pt is None else torch.from_numpy(pt)))
    want = jobs.fused_cache_reports(_Fused(jnp.asarray(trace), 5,
                                           ("attn", "ffn"), 0.2,
                                           None if pt is None
                                           else jnp.asarray(pt)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _fields(g) == _fields(w)
        assert g.num_steps == 5
        if proxy:
            assert g.proxy[0] is None and None not in g.proxy[1:]
    # run_cache_reports routes a fused state to the exact per-row path
    assert [_fields(r) for r in run_cache_reports(_Fused(
        torch.from_numpy(trace), 5, ("attn", "ffn"), 0.2), 3)] == \
        [_fields(r) for r in jobs.run_cache_reports(_Fused(
            jnp.asarray(trace), 5, ("attn", "ffn"), 0.2), 3)]


@pytest.mark.parametrize("case", ["decisions", "schedule", "empty"])
def test_run_reports_fall_back_as_the_reference(case):
    types = ("attn", "ffn")
    if case == "decisions":
        rs = _Decided(((), ("attn",), ("attn", "ffn")))
        args = dict(schedule=tS.fora(types, 3, 2)), \
            dict(schedule=jS.fora(types, 3, 2))
    elif case == "schedule":
        rs = object()
        args = dict(schedule=tS.fora(types, 4, 2), tau=0.2), \
            dict(schedule=jS.fora(types, 4, 2), tau=0.2)
    else:
        rs, args = object(), ({}, {})
    got = run_cache_reports(rs, 2, **args[0])
    want = jobs.run_cache_reports(rs, 2, **args[1])
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert len(got) == (0 if case == "empty" else 2)
    empty = CacheReport(tau=0.0, types=(), desired=(), realized=())
    assert empty.realized_compute_fraction() == 1.0


# ---------------------------------------------------------------------------
# The fused step's proxy trace on the smoke DiT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX pipeline calibrated under the adaptive policy and the
    port's pipeline loaded from its saved artifact."""
    cfg, tcfg = smoke_cfgs()
    pj, _ = smoke_params()
    jp = jcache.DiffusionPipeline(cfg, jsolvers.ddim(STEPS), SPEC,
                                  cfg_scale=1.5)
    jp.calibrate(pj, jax.random.PRNGKey(1), 2,
                 cond_args={"label": jnp.asarray(LABELS)})
    path = str(tmp_path_factory.mktemp("telemetry") / "ref.cache.json")
    jp.save_artifact(path)
    tp = tcache.DiffusionPipeline(tcfg, solvers.ddim(STEPS), SPEC,
                                  cfg_scale=1.5, device="cpu")
    tp.load_artifact(path)
    return jp, tp, path


@pytest.mark.parametrize("tau", [TAU, 0.0])
@pytest.mark.parametrize("seed", [2, 5])
def test_proxy_trace_matches_the_reference(reference, seed, tau):
    jp, tp, _ = reference
    pj, pt = smoke_params()
    ej, et = jp.executor, tp.executor
    x0 = np.array(ej.initial_latent(jax.random.PRNGKey(seed), 2)[0])
    et.initial_latent = lambda generator, batch: torch.from_numpy(x0.copy())
    try:
        rj = ej.start_adaptive_fused_run(
            pj, jax.random.PRNGKey(seed), 2, schedule=jp.schedule, tau=tau,
            proxy_map=jp.proxy_map, k_max=jp.policy.k_max,
            label=jnp.asarray(LABELS), telemetry=True)
        rt = et.start_adaptive_fused_run(
            pt, None, 2, schedule=tp.schedule, tau=tau,
            proxy_map=tp.proxy_map, k_max=tp.policy.k_max,
            label=torch.tensor(LABELS), telemetry=True)
        while not rj.done:
            rj = ej.advance_adaptive_fused(pj, rj, n_steps=3)
        while not rt.done:
            rt = et.advance_adaptive_fused(pt, rt, n_steps=3)
    finally:
        del et.initial_latent
    assert rt.decisions == rj.decisions
    got, want = rt.proxy_trace.numpy(), np.asarray(rj.proxy_trace)
    assert got.shape == want.shape == (STEPS, 2)
    assert np.isfinite(got[1:]).all() and (got[1:] > 0).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=PROXY_RTOL, atol=0)
    for g, w in zip(run_cache_reports(rt, 2), jobs.run_cache_reports(rj, 2)):
        assert (g.desired, g.realized) == (w.desired, w.realized)
        assert g.proxy[0] is w.proxy[0] is None
    assert et.host_sync_count == 0


@pytest.fixture(scope="module")
def port_pipe():
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(tcfg, solvers.ddim(STEPS), SPEC,
                                    cfg_scale=1.5, device="cpu")
    pipe.calibrate(pt, _gen(1), 2, cond_args={"label": torch.tensor(LABELS)})
    return pipe


@pytest.mark.parametrize("tau", [TAU, 0.0])
def test_telemetry_on_equals_off_bitwise(port_pipe, tau):
    """Telemetry builds its own step (a second ``fused`` variant) that
    writes the proxies; the latents, traces and flags are the run
    without it, bit for bit, with no decision sync; host loop decisions
    are the reports' realized ones."""
    _, pt = smoke_params()
    _, tcfg = smoke_cfgs()
    ex = tex.SmoothCacheExecutor(tcfg, solvers.ddim(STEPS), cfg_scale=1.5,
                                 device="cpu")
    kw = dict(schedule=port_pipe.schedule, tau=tau,
              proxy_map=port_pipe.proxy_map, k_max=port_pipe.policy.k_max,
              label=torch.tensor(LABELS))
    runs = {}
    for on in (True, False):
        rs = ex.start_adaptive_fused_run(pt, _gen(4), 2, telemetry=on, **kw)
        while not rs.done:
            rs = ex.advance_adaptive_fused(pt, rs, n_steps=3)
        runs[on] = rs
    on, off = runs[True], runs[False]
    assert off.proxy_trace is None and on.proxy_trace is not None
    for name in ("x", "trace", "healthy", "acc", "lag"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    assert ex.host_sync_count == 0
    assert ex.compiled_variant_count("fused") == 2
    _, dh = ex.sample_adaptive(pt, _gen(4), 2, return_decisions=True, **kw)
    reps = run_cache_reports(on, 2)
    for rep in reps:
        assert rep.realized == dh == on.decisions
        assert rep.proxy[0] is None
        assert all(math.isfinite(p) for p in rep.proxy[1:])
        for s in range(STEPS):
            assert all(t in r.desired[s] for r in reps
                       for t in rep.realized[s])


def test_split_and_merge_carry_the_proxy_rows(port_pipe):
    _, pt = smoke_params()
    ex = port_pipe.executor
    kw = dict(schedule=port_pipe.schedule, tau=TAU,
              proxy_map=port_pipe.proxy_map, k_max=port_pipe.policy.k_max,
              label=torch.tensor(LABELS))
    rs = ex.start_adaptive_fused_run(pt, _gen(3), 2, telemetry=True, **kw)
    rs = ex.advance_adaptive_fused(pt, rs, n_steps=4)
    a, b = ex.split_run(rs, [[0], [1]])
    assert torch.equal(a.proxy_trace[:, 0], rs.proxy_trace[:, 0])
    assert torch.equal(b.proxy_trace[:, 0], rs.proxy_trace[:, 1])
    assert torch.equal(ex.merge_runs([a, b]).proxy_trace, rs.proxy_trace)
    plain = ex.start_adaptive_fused_run(
        pt, _gen(3), 1, **dict(kw, label=torch.tensor(LABELS[1:])))
    plain = ex.advance_adaptive_fused(pt, plain, n_steps=4)
    assert ex.merge_runs([a, plain]).proxy_trace is None


def test_engine_telemetry_and_tracing_bit_identical(reference):
    _, _, path = reference
    _, pt = smoke_params()
    _, tcfg = smoke_cfgs()

    def serve_once(on):
        clock = serve.VirtualClock()
        ex = tex.SmoothCacheExecutor(tcfg, solvers.ddim(STEPS),
                                     cfg_scale=1.5, device="cpu")
        store = serve.ArtifactStore(tcfg, ex.solver, cfg_scale=1.5)
        store.add_artifact("gen", path)
        store.add_policy("static2", "static:n=2")
        kw = {"tracer": Tracer(clock), "telemetry": True} if on else {}
        eng = serve.ServeEngine(ex, pt, store, clock=clock, max_batch=2,
                                adaptive_chunk=3, **kw)
        eng.submit(*[serve.Request(rid=i, seed=100 + i,
                                   policy="gen" if i < 2 else "static2",
                                   label=i % tcfg.num_classes, arrival=0.0)
                     for i in range(4)])
        return eng, eng.run_until_drained(), ex

    eng_on, res_on, ex_on = serve_once(True)
    eng_off, res_off, _ = serve_once(False)
    assert sorted(res_on) == sorted(res_off) == [0, 1, 2, 3]
    for rid in res_on:
        np.testing.assert_array_equal(res_on[rid], res_off[rid])
    assert ex_on.host_sync_count == 0
    assert not eng_off.cache_reports
    assert sorted(eng_on.cache_reports) == [0, 1, 2, 3]
    for rec in eng_on.records:
        for rid in rec.rids:
            rep = eng_on.cache_reports[rid]
            if rec.group == "gen":
                assert rep.realized == rec.decisions
                assert rep.tau == TAU and rep.proxy is not None
            else:
                assert rep.proxy is None and rep.tau == 0.0
                assert rep.realized_compute_fraction() == pytest.approx(
                    rec.compute_fraction)
    assert not eng_on.tracer.open_spans()
    assert validate_chrome_trace(eng_on.tracer.to_chrome_trace()) > 0
    assert obs.CacheReport is CacheReport
