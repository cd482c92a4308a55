"""The port's fused adaptive path (``sample_adaptive_fused``: decision and
dispatch on the device, one captured CUDA graph per pool on a card) and
``plan.switch_branch_table``, against the host loop and the JAX package.

Torch against torch, bitwise, on the dit-xl-256 smoke DiT (DDIM 8,
cfg_scale 1.5): fused ≡ host loop (decisions and latents) with
``host_sync_count == 0``; τ = 0 fused ≡ ``sample_compiled``; a run in
chunks ≡ one call; ``generate`` routes adaptive policies to the fused
path.  Against JAX ``sample_adaptive_fused`` fed the same initial latent
and artifact: per-step accumulators and final latents within 5e-5 of
their scale, decisions equal on every step whose margin
``|acc + delta − τ|`` exceeds 1e-4 (as ``tests/test_torch_adaptive.py``).
The card test captures the graph and holds its replays against the host
loop; it skips without a CUDA device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from repro import cache as jcache
from repro.core import plan as jplan, schedule as jS
from repro.core import solvers as jsolvers
from repro_torch import cache as tcache
from repro_torch.core import calibration as tcal, executor as tex
from repro_torch.core import plan as tplan, schedule as tS
from repro_torch.core import solvers as tsolvers

TOL = 5e-5
MARGIN = 1e-4
STEPS = 8
TAU = 0.3
SPEC = f"adaptive:base=smoothcache(alpha=0.5),tau={TAU}"
LABELS = [3, 7]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _executor(steps=STEPS, device="cpu"):
    _, tcfg = smoke_cfgs()
    return tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(steps),
                                   cfg_scale=1.5, device=device)


@pytest.fixture(scope="module")
def port_pipe():
    """A port pipeline calibrated under the adaptive policy."""
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(STEPS), SPEC,
                                    cfg_scale=1.5, device="cpu")
    pipe.calibrate(pt, _gen(1), 2, cond_args={"label": torch.tensor(LABELS)})
    return pipe


def _kw(pipe, tau=TAU):
    return dict(schedule=pipe.schedule, tau=tau, proxy_map=pipe.proxy_map,
                k_max=pipe.policy.k_max, label=torch.tensor(LABELS))


# ---------------------------------------------------------------------------
# Torch against torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau,seed", [(TAU, 2), (TAU, 9), (100.0, 5)])
def test_fused_equals_host_loop_bitwise(port_pipe, tau, seed):
    _, pt = smoke_params()
    ex = _executor()
    xh, dh = ex.sample_adaptive(pt, _gen(seed), 2, return_decisions=True,
                                **_kw(port_pipe, tau))
    syncs = ex.host_sync_count
    assert syncs == STEPS - 1
    xf, df = ex.sample_adaptive_fused(pt, _gen(seed), 2,
                                      return_decisions=True,
                                      **_kw(port_pipe, tau))
    assert ex.host_sync_count == syncs          # the fused path never reads
    assert df == dh and any(df)
    assert torch.equal(xf, xh)
    assert ex.compiled_variant_count("fused") == 1


def test_tau0_fused_equals_sample_compiled(port_pipe):
    _, pt = smoke_params()
    ex = _executor()
    sch = port_pipe.schedule
    x_f, dec = ex.sample_adaptive_fused(pt, _gen(3), 2, return_decisions=True,
                                        **_kw(port_pipe, 0.0))
    x_c = ex.sample_compiled(pt, _gen(3), 2, schedule=sch,
                             label=torch.tensor(LABELS))
    assert torch.equal(x_f, x_c)
    assert dec == tuple(tuple(t for t, sk in sch.mask_key_at(s) if sk)
                        for s in range(STEPS))
    assert ex.host_sync_count == 0


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_chunked_run_equals_one_call(port_pipe, chunk):
    _, pt = smoke_params()
    ex = _executor()
    whole, dec = ex.sample_adaptive_fused(pt, _gen(4), 2,
                                          return_decisions=True,
                                          **_kw(port_pipe))
    rs = ex.start_adaptive_fused_run(pt, _gen(4), 2, **_kw(port_pipe))
    steps = []
    while not rs.done:
        rs = ex.advance_adaptive_fused(pt, rs, n_steps=chunk)
        steps.append(rs.step)
    assert steps[-1] == STEPS and steps[0] == min(chunk, STEPS)
    assert torch.equal(rs.x, whole) and rs.decisions == dec
    assert rs.row_signatures() is not None and len(rs.row_signatures()) == 2
    assert ex.host_sync_count == 0
    # one step per (batch, pool, τ): chunking adds no variant
    assert ex.compiled_variant_count("fused") == 1


@pytest.mark.parametrize("tau", [TAU, 0.0])
def test_warm_up_of_a_graph_built_at_a_late_step(port_pipe, tau):
    """A split at the last chunk boundary builds a new step there; the
    warm-up that precedes its capture runs every branch, and must stay
    inside the step tables (it starts each branch at step 0) and leave
    nothing behind that the next chunk reads."""
    _, pt = smoke_params()
    ex = _executor()
    rs = ex.start_adaptive_fused_run(pt, _gen(8), 2, **_kw(port_pipe, tau))
    rs = ex.advance_adaptive_fused(pt, rs, n_steps=STEPS - 2)
    sub = ex.split_run(rs, [[1]])[0]
    step = ex.fused_step_for(pt, sub)           # bucket 1: a new step
    assert len(step.table.branches) >= 3        # past the last step if
    want = ex.advance_adaptive_fused(pt, sub)   # counted on from step 6
    step._warm_up(ex)
    got = ex.advance_adaptive_fused(pt, sub)
    assert got.done and torch.equal(got.x, want.x)
    assert torch.equal(got.trace, want.trace)
    assert torch.equal(got.acc, want.acc) and torch.equal(got.lag, want.lag)
    assert ex.compiled_variant_count("fused") == 2


def test_generate_routes_adaptive_policies_to_the_fused_path(port_pipe,
                                                             monkeypatch):
    _, pt = smoke_params()
    ex = port_pipe.executor
    called = {}
    orig = tex.SmoothCacheExecutor.sample_adaptive_fused

    def spy(self, *a, **kw):
        called["fused"] = True
        return orig(self, *a, **kw)

    monkeypatch.setattr(tex.SmoothCacheExecutor, "sample_adaptive_fused",
                        spy)
    before = ex.host_sync_count
    x, dec = port_pipe.generate(pt, _gen(6), 2, label=torch.tensor(LABELS),
                                return_decisions=True)
    assert called.get("fused") and len(dec) == STEPS and dec[0] == ()
    assert ex.host_sync_count == before
    xh = ex.sample_adaptive(pt, _gen(6), 2, **_kw(port_pipe))
    assert torch.equal(x, xh)


def test_fused_health_flags_a_poisoned_row(port_pipe):
    _, pt = smoke_params()
    ex = _executor()
    rs = ex.start_adaptive_fused_run(pt, _gen(0), 2, **_kw(port_pipe))
    rs = ex.advance_adaptive_fused(pt, rs, n_steps=2)
    assert rs.healthy.tolist() == [True, True]
    x = rs.x.clone()
    x[1].fill_(float("nan"))
    rs = ex.advance_adaptive_fused(pt, dataclasses.replace(rs, x=x))
    assert rs.healthy.tolist() == [True, False]
    assert bool(torch.isfinite(rs.x[0]).all())


def test_fused_path_validates_and_refuses_what_is_not_ported(port_pipe):
    _, pt = smoke_params()
    ex = _executor()
    with pytest.raises(ValueError, match="proxy_map"):
        ex.start_adaptive_fused_run(pt, _gen(0), 2, schedule=port_pipe.schedule,
                                    tau=0.1, label=torch.tensor(LABELS))
    rs = ex.start_adaptive_fused_run(pt, _gen(0), 2, **_kw(port_pipe))
    rs = ex.advance_adaptive_fused(pt, rs)
    with pytest.raises(ValueError, match="already complete"):
        ex.advance_adaptive_fused(pt, rs)
    # a solver whose step cannot take a device index has no fused path
    _, tcfg = smoke_cfgs()
    solver = dataclasses.replace(tsolvers.ddim(STEPS), scannable=False)
    host_only = tex.SmoothCacheExecutor(tcfg, solver, cfg_scale=1.5,
                                        device="cpu")
    assert not host_only.supports_fused_adaptive
    with pytest.raises(ValueError, match="not scannable"):
        host_only.sample_adaptive_fused(pt, _gen(0), 2, **_kw(port_pipe))


# ---------------------------------------------------------------------------
# Against the JAX package
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
    path = str(tmp_path_factory.mktemp("fused") / "ref.cache.json")
    jp.save_artifact(path)
    tp = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(STEPS), SPEC,
                                  cfg_scale=1.5, device="cpu")
    tp.load_artifact(path)
    return jp, tp


def _margin(rs):
    """Smallest ``|acc + delta − τ|`` at the step ``rs`` is about to
    decide."""
    proxy = tcal.rel_l1_change_rows(rs.x, rs.x_prev)
    delta = torch.clamp_min(rs.coeff_a * proxy[:, None]
                            + rs.coeff_b[None, :], 0.0)
    return float((rs.acc + delta - rs.tau).abs().min())


@pytest.mark.parametrize("seed", [2, 5, 11])
def test_fused_matches_reference_fused(reference, seed):
    jp, tp = reference
    pj, pt = smoke_params()
    lab = [seed % 10, (3 * seed) % 10]
    ej, et = jp.executor, tp.executor
    x0 = np.array(ej.initial_latent(jax.random.PRNGKey(seed), 2)[0])
    et.initial_latent = lambda generator, batch: torch.from_numpy(x0.copy())
    kw = dict(tau=TAU, k_max=jp.policy.k_max)
    rj = ej.start_adaptive_fused_run(pj, jax.random.PRNGKey(seed), 2,
                                     schedule=jp.schedule,
                                     proxy_map=jp.proxy_map,
                                     label=jnp.asarray(lab), **kw)
    rt = et.start_adaptive_fused_run(pt, None, 2, schedule=tp.schedule,
                                     proxy_map=tp.proxy_map,
                                     label=torch.tensor(lab), **kw)
    assert rt.table.types == rj.table.types
    clear_skips = 0
    while not rt.done:
        margin = _margin(rt) if rt.step > 0 else None
        rj = ej.advance_adaptive_fused(pj, rj, n_steps=1)
        rt = et.advance_adaptive_fused(pt, rt, n_steps=1)
        np.testing.assert_allclose(rt.acc.numpy(), np.asarray(rj.acc),
                                   atol=TOL, rtol=0)
        if margin is not None and margin > MARGIN:
            assert rt.decisions[-1] == rj.decisions[-1], rt.step
            clear_skips += bool(rt.decisions[-1])
    assert clear_skips >= 1, "no step skipped with a clear margin"
    assert rt.decisions[0] == ()
    assert et.host_sync_count == 0
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    assert np.isfinite(xt).all() and bool(rt.healthy.all())
    assert float(np.abs(xt - xj).max()) <= TOL * float(np.abs(xj).max())


def _pools():
    cfg, tcfg = smoke_cfgs()
    out = []
    attn_only = {"attn": np.arange(8) % 3 != 0, "ffn": np.zeros(8, bool)}
    for make in (lambda S, ty: S.fora(ty, 8, 2),
                 lambda S, ty: S.Schedule(dict(attn_only), 8),
                 lambda S, ty: S.no_cache(ty, 8)):
        out.append((make(jS, cfg.layer_types()),
                    make(tS, tcfg.layer_types())))
    return out


@pytest.mark.parametrize("i", range(3))
def test_switch_branch_table_matches_reference(i):
    js, ts = _pools()[i]
    jt = jplan.switch_branch_table(jplan.mask_lattice(js))
    tt = tplan.switch_branch_table(tplan.mask_lattice(ts))
    assert tt.types == jt.types
    assert [(b.mask, b.collect) for b in tt.branches] == \
        [(b.mask, b.collect) for b in jt.branches]
    for code, sig in enumerate(tt.branches):
        assert tt.code_of(sig.live_in) == jt.code_of(sig.live_in) == code
    with pytest.raises(KeyError):
        tt.code_of(["nope"])
    if len(tt.branches) > 2:
        # a pool that is not the full lattice names no branch for a code
        partial = tplan.mask_lattice(ts)[:-1]
        with pytest.raises(ValueError, match="full mask lattice"):
            tplan.switch_branch_table(partial)
        with pytest.raises(ValueError, match="full mask lattice"):
            jplan.switch_branch_table(jplan.mask_lattice(js)[:-1])


def test_mask_signature_matches_reference():
    types = ("attn", "ffn")
    for bits in ([0, 0], [1, 0], [0, 1], [1, 1]):
        assert tplan.mask_signature(types, bits) == \
            jplan.mask_signature(types, bits)


def test_if_nodes_refuse_an_old_cuda_or_torch(monkeypatch):
    """No fallback: where IF nodes cannot be built the capture raises."""
    from repro_torch.core import cuda_graphs
    monkeypatch.setattr(torch.version, "cuda", "12.1")
    with pytest.raises(RuntimeError, match="12.4"):
        cuda_graphs.require()
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.delattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool",
                        raising=False)
    with pytest.raises(RuntimeError, match="memory pool"):
        cuda_graphs.require()


# ---------------------------------------------------------------------------
# On a card: the captured graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused step is a captured CUDA "
                    "graph there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_graph_replays_equal_the_host_loop(cuda, port_pipe):
    from repro_torch.convert import params_from_numpy
    from _torch_helpers import _numpy_params
    pt = params_from_numpy(_numpy_params(), device="cuda")
    ex = _executor(device="cuda")
    kw = dict(_kw(port_pipe), label=torch.tensor(LABELS, device=cuda))
    xh, dh = ex.sample_adaptive(pt, _gen(2), 2, return_decisions=True, **kw)
    syncs = ex.host_sync_count
    rs = ex.start_adaptive_fused_run(pt, _gen(2), 2, **kw)
    stats = ex.fused_step_for(pt, rs).stats
    assert stats["captured"]["flash_attention"] > 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        rs = ex.advance_adaptive_fused(pt, rs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ex.host_sync_count == syncs
    assert rs.decisions == dh
    assert torch.equal(rs.x, xh)


def test_cuda_graph_captured_at_the_last_chunk_boundary(cuda, port_pipe):
    """A graph first captured for a run split at step num_steps − 2 (its
    warm-up must stay inside the step tables) replays as a second split of
    the same state on the graph it built."""
    from repro_torch.convert import params_from_numpy
    from _torch_helpers import _numpy_params
    pt = params_from_numpy(_numpy_params(), device="cuda")
    ex = _executor(device="cuda")
    kw = dict(_kw(port_pipe), label=torch.tensor(LABELS, device=cuda))
    rs = ex.start_adaptive_fused_run(pt, _gen(8), 2, **kw)
    rs = ex.advance_adaptive_fused(pt, rs, n_steps=STEPS - 2)
    first = ex.advance_adaptive_fused(pt, ex.split_run(rs, [[1]])[0])
    again = ex.advance_adaptive_fused(pt, ex.split_run(rs, [[1]])[0])
    torch.cuda.synchronize()
    assert len(ex.fused_graphs()) == 2
    assert first.done and bool(torch.isfinite(first.x).all())
    assert torch.equal(first.x, again.x)
    assert torch.equal(first.trace, again.trace)
