"""The segmented path's step graphs (``core/segment_graph.py``: one step
graph per plan signature behind ``advance_run`` / ``sample_compiled``)
on the dit-xl-256 smoke DiT (2 blocks, d_model 128, 4 × 32 heads, 16
tokens), 8 steps, cfg_scale 1.5, for DDIM, rectified flow and DPM++(3M)
SDE under ``no_cache``, a SmoothCache schedule calibrated here and
``static:n=2``.

On the CPU the step a card captures runs eagerly on the graph's buffers,
so these tests hold that body: ≡ ``graphs=False`` (the same step, never
captured) ≡ eager ``sample``, bitwise; against the JAX package's jitted
``sample_compiled`` on the same initial latent (and step noise) within
5e-5 of the latent's scale (f32, ``jax_default_matmul_precision`` at
"highest"); one graph per (signature, batch), reused by segments of
other lengths and positions and by a second run; exact liveness at every
boundary; ``split_run`` / ``merge_runs`` per row and ``export_run`` →
``import_run`` mid-plan bitwise; a graph rebuilt once a weight changed in
place or a prepared copy it holds was dropped.  The card tests capture
the graphs and hold their replays against ``graphs=False``, and against
a run after ``gemm.release`` and a fresh ``prepare_linear``; they skip
without a CUDA device."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from repro.core import executor as jex, schedule as jS, solvers as jsolvers
from repro_torch import cache as tcache
from repro_torch.core import diffusion as tdiffusion
from repro_torch.core import executor as tex, solvers as tsolvers
from repro_torch.kernels import gemm

STEPS = 8
LABELS = [3, 7]
TOL = 5e-5
SOLVERS = ["ddim", "rectified_flow", "dpmpp_3m_sde"]
POLICIES = ["no_cache", "smoothcache:alpha=0.5", "static:n=2"]
CASES = [(s, p) for s in SOLVERS for p in POLICIES]


@functools.lru_cache(maxsize=None)
def _schedule(solver, policy):
    """The policy's schedule for this solver (None for ``no_cache``),
    SmoothCache's from a port calibration on 2 samples."""
    if policy == "no_cache":
        return None
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    pipe = tcache.DiffusionPipeline(tcfg, getattr(tsolvers, solver)(STEPS),
                                    "smoothcache:alpha=0.5", cfg_scale=1.5,
                                    device="cpu")
    pipe.calibrate(pt, torch.Generator().manual_seed(1), 2,
                   cond_args={"label": torch.tensor(LABELS)})
    return (pipe.schedule if policy.startswith("smoothcache")
            else pipe.schedule_for(policy))


@functools.lru_cache(maxsize=None)
def _reference_draws(solver, key=2):
    """The JAX executor's initial latent and per-step noise of a run from
    ``PRNGKey(key)``."""
    cfg, _ = smoke_cfgs()
    ex = jex.SmoothCacheExecutor(cfg, getattr(jsolvers, solver)(STEPS),
                                 cfg_scale=1.5)
    x0, kloop = ex.initial_latent(jax.random.PRNGKey(key), len(LABELS))
    noise = [np.asarray(jax.random.normal(jax.random.fold_in(kloop, s),
                                          x0.shape, jnp.float32))
             for s in range(STEPS)]
    return np.array(x0), noise


def _executor(solver, graphs=True, fed=True):
    """A port executor; ``fed`` hands it the reference's draws (its
    ``initial_latent`` and ``step_noise``)."""
    _, tcfg = smoke_cfgs()
    ex = tex.SmoothCacheExecutor(tcfg, getattr(tsolvers, solver)(STEPS),
                                 cfg_scale=1.5, device="cpu", graphs=graphs)
    if fed:
        x0, noise = _reference_draws(solver)
        ex.initial_latent = lambda generator, batch: torch.from_numpy(
            x0[:batch].copy())
        ex.step_noise = lambda seed, s, shape: torch.from_numpy(
            noise[s][:shape[0]].copy())
    return ex


def _label(n=len(LABELS)):
    return torch.tensor(LABELS[:n])


def _plan(ex, solver, policy):
    from repro_torch.core import schedule as tS
    sch = _schedule(solver, policy)
    if sch is None:
        sch = tS.no_cache(ex.cfg.layer_types(), STEPS)
    return sch, ex.plan_for(sch)


def _entries(cache):
    return {(si, bi, n) for si, stage in enumerate(cache)
            for bi, d in enumerate(stage) for n in d}


def _leaves(cache):
    return [d[k] for stage in cache for d in stage for k in sorted(d)]


@pytest.mark.parametrize("solver,policy", CASES)
def test_segmented_bit_identical_to_eager(solver, policy):
    """The graph body ≡ the Python loop ≡ the eager sampler, bitwise."""
    _, pt = smoke_params()
    sch = _schedule(solver, policy)
    graphed = _executor(solver)
    x = graphed.sample_compiled(pt, None, 2, schedule=sch, label=_label(),
                                check=True)
    loop = _executor(solver, graphs=False).sample_compiled(
        pt, None, 2, schedule=sch, label=_label(), check=True)
    eager = graphed.sample(pt, None, 2, schedule=sch, label=_label())
    assert bool(torch.isfinite(x).all())
    assert torch.equal(x, loop)
    assert torch.equal(x, eager)
    assert graphed.graph_count("seg") > 0
    assert _executor(solver, graphs=False).graph_count() == 0


@pytest.mark.parametrize("solver,policy", CASES)
def test_matches_jax_sample_compiled(solver, policy):
    """Against the JAX package's jitted segment programs on the same
    initial latent and step noise: within 5e-5 of the latent's scale."""
    cfg, _ = smoke_cfgs()
    pj, pt = smoke_params()
    sch = _schedule(solver, policy)
    sj = None if sch is None else jS.Schedule.from_json(sch.to_json())
    ej = jex.SmoothCacheExecutor(cfg, getattr(jsolvers, solver)(STEPS),
                                 cfg_scale=1.5)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(ej.sample_compiled(
            pj, jax.random.PRNGKey(2), 2, schedule=sj,
            label=jnp.asarray(LABELS)))
    got = _executor(solver).sample_compiled(pt, None, 2, schedule=sch,
                                            label=_label()).numpy()
    scale = float(np.abs(ref).max())
    assert np.isfinite(ref).all() and scale > 0
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("solver,policy", CASES)
def test_graph_count_equals_unique_signatures(solver, policy):
    """One graph per (signature, batch), the ``seg`` variants' count: each
    runs every segment of its signature, whatever its length and
    position; a second run builds nothing, another batch its own."""
    _, pt = smoke_params()
    ex = _executor(solver, fed=False)
    sch, plan = _plan(ex, solver, policy)
    assert ex.graph_count() == 0
    ex.sample_compiled(pt, torch.Generator().manual_seed(0), 2,
                       schedule=sch, label=_label())
    n = plan.num_unique_signatures
    assert ex.graph_count("seg") == ex.graph_count() == n
    assert ex.compiled_variant_count("seg") == n
    recs = ex.segment_graphs()
    by_skip = {}
    for r in plan.runs:
        skip = tuple(sorted(t for t, sk in r.sig.skip.items() if sk))
        by_skip[skip] = by_skip.get(skip, 0) + r.length
    assert {tuple(r["skip"]): r["replays"] for r in recs} == by_skip
    assert all(r["batch"] == 2 and r["scannable"] == (solver != "dpmpp_3m_sde")
               for r in recs)
    if policy != "no_cache":
        # a graph ran segments of more than one start
        starts = {}
        for r in plan.runs:
            starts.setdefault(r.sig, set()).add(r.start)
        assert max(len(v) for v in starts.values()) > 1
    ex.sample_compiled(pt, torch.Generator().manual_seed(1), 2,
                       schedule=sch, label=_label())
    assert ex.graph_count() == n
    assert sum(r["replays"] for r in ex.segment_graphs()) == 2 * STEPS
    ex.sample_compiled(pt, torch.Generator().manual_seed(1), 1,
                       schedule=sch, label=_label(1))
    assert ex.graph_count() == ex.compiled_variant_count("seg") == 2 * n


@pytest.mark.parametrize("solver,policy", CASES)
def test_liveness_at_every_boundary(solver, policy):
    """``check=True`` at every boundary (each segment reads only what the
    last boundary kept; the next one's entries are exactly those it read
    or wrote): the resident cache is exactly the next segment's reads,
    and an entry the segment only read passes through as the run state's
    own tensor; a run state missing an entry its segment reads is
    refused."""
    _, pt = smoke_params()
    ex = _executor(solver)
    sch, plan = _plan(ex, solver, policy)
    rs = ex.start_run(pt, None, 2, plan=plan, schedule=sch, label=_label())
    while not rs.done:
        run = plan.runs[rs.run_index]
        before = rs.cache
        rs = ex.advance_run(pt, rs, check=True)
        assert _entries(rs.cache) == set(
            tex.cache_entry_names(ex.cfg, run.live_out))
        for si, bi, name in _entries(rs.cache):
            kept = dict(zip(ex.cfg.stages[si].unit[bi].branch_names(),
                            ex.cfg.stages[si].unit[bi].branch_types()))
            if kept[name] in run.sig.live_in:
                assert rs.cache[si][bi][name] is before[si][bi][name]
    assert bool(rs.healthy.all())
    reading = [i for i, r in enumerate(plan.runs) if r.sig.live_in]
    if reading:
        rs = ex.start_run(pt, None, 2, plan=plan, schedule=sch,
                          label=_label())
        while rs.run_index < reading[0]:
            rs = ex.advance_run(pt, rs)
        rs = dataclasses.replace(rs, cache=tex.empty_branch_cache(ex.cfg))
        with pytest.raises(AssertionError, match="read, not resident"):
            ex.advance_run(pt, rs, check=True)


@pytest.mark.parametrize("solver,policy", CASES)
def test_split_merge_bitwise(solver, policy):
    """split → advance → merge is the unsplit run's rows bitwise, and a
    row's sub-run finishes as its solo run; a stochastic solver's run
    refuses to split."""
    from repro_torch import serve
    _, pt = smoke_params()
    ex = _executor(solver, fed=False)
    sch, plan = _plan(ex, solver, policy)

    def start(rows=(0, 1)):
        return ex.start_run(pt, None, len(rows), plan=plan, schedule=sch,
                            label=torch.tensor([LABELS[i] for i in rows]),
                            row_keys=[serve.batch_generator([100 + i])
                                      for i in rows])

    def drain(rs):
        while not rs.done:
            rs = ex.advance_run(pt, rs, check=True)
        return rs

    if solver == "dpmpp_3m_sde":
        with pytest.raises(ValueError, match="stochastic"):
            start()
        return
    whole = drain(start())
    rs = ex.advance_run(pt, start())
    subs = [drain(s) for s in ex.split_run(rs, [[0], [1]])]
    merged = ex.merge_runs(subs)
    assert torch.equal(merged.x, whole.x)
    assert torch.equal(subs[1].x, drain(start((1,))).x)
    if len(plan.runs) > 2:
        # split, one segment apart, merge, and finish together
        halves = [ex.advance_run(pt, s) for s in ex.split_run(rs, [[0], [1]])]
        assert torch.equal(drain(ex.merge_runs(halves)).x, whole.x)
    rt = ex.merge_runs(ex.split_run(rs, [[0], [1]]))
    assert torch.equal(rt.x, rs.x)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(rt.cache),
                                                 _leaves(rs.cache)))


@pytest.mark.parametrize("solver,policy", CASES)
def test_export_import_mid_plan_bitwise(solver, policy):
    """A run exported mid-plan and imported on a fresh executor (which
    builds its graphs on the first advance) finishes bitwise as the
    uninterrupted run."""
    _, pt = smoke_params()
    ex = _executor(solver)
    sch, plan = _plan(ex, solver, policy)
    whole = ex.sample_compiled(pt, None, 2, schedule=sch, label=_label())
    rs = ex.start_run(pt, None, 2, plan=plan, schedule=sch, label=_label())
    for _ in range(len(plan.runs) // 2):
        rs = ex.advance_run(pt, rs)
    kind, arrays, static = ex.export_run(rs)
    arrays = tex._map_leaves(lambda a: a.clone() if isinstance(
        a, torch.Tensor) else a, arrays)
    fresh = _executor(solver)
    back = fresh.import_run(pt, kind, arrays, static, plan=plan)
    assert fresh.graph_count() == 0
    while not back.done:
        back = fresh.advance_run(pt, back, check=True)
    assert torch.equal(back.x, whole)
    assert 0 < fresh.graph_count() <= plan.num_unique_signatures


def test_pipeline_passes_the_switch_through():
    _, tcfg = smoke_cfgs()
    for graphs in (True, False):
        pipe = tcache.DiffusionPipeline(tcfg, tsolvers.ddim(STEPS),
                                        cfg_scale=1.5, device="cpu",
                                        graphs=graphs)
        assert pipe.executor.graphs is graphs


# ---------------------------------------------------------------------------
# On a card: the captured graphs
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment step is a captured "
                    "CUDA graph there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("solver", SOLVERS)
def test_cuda_graph_replays_equal_the_loop(cuda, solver):
    from _torch_helpers import _numpy_params
    from repro_torch.convert import params_from_numpy
    pt = params_from_numpy(_numpy_params(), device="cuda")
    sch = _schedule(solver, "static:n=2")
    _, tcfg = smoke_cfgs()
    exs = [tex.SmoothCacheExecutor(tcfg, getattr(tsolvers, solver)(STEPS),
                                   cfg_scale=1.5, device="cuda",
                                   graphs=graphs) for graphs in (True, False)]
    label = torch.tensor(LABELS, device=cuda)
    xs = [ex.sample_compiled(pt, torch.Generator().manual_seed(2), 2,
                             schedule=sch, label=label) for ex in exs]
    assert torch.equal(xs[0], xs[1])
    recs = exs[0].segment_graphs()
    assert len(recs) == exs[0].plan_for(sch).num_unique_signatures
    assert all(r["captured"]["flash_attention"] > 0 for r in recs
               if "attn" not in r["skip"])


def test_an_in_place_weight_update_rebuilds_the_graph():
    """A weight changed in place (a training step, a restore into the
    same tensors) leaves a graph's captured prepared halves behind: the
    graph is built anew, and the run samples the updated weights."""
    from _torch_helpers import _numpy_params
    from repro_torch.convert import params_from_numpy
    pt = params_from_numpy(_numpy_params(), device="cpu")
    ex = _executor("ddim", fed=False)
    sch = _schedule("ddim", "static:n=2")
    ex.sample_compiled(pt, torch.Generator().manual_seed(0), 2, schedule=sch,
                       label=_label())
    old = list(ex._segments.values())
    with torch.no_grad():
        pt["out"]["b"].add_(0.5)
    x = ex.sample_compiled(pt, torch.Generator().manual_seed(0), 2,
                           schedule=sch, label=_label())
    assert ex.graph_count() == len(old)
    assert not any(g in old for g in ex._segments.values())
    loop = _executor("ddim", graphs=False, fed=False)
    assert torch.equal(x, loop.sample_compiled(
        pt, torch.Generator().manual_seed(0), 2, schedule=sch,
        label=_label()))


def test_a_dropped_prepared_copy_makes_the_graph_stale():
    """A graph holds the prepared halves its capture read: ``gemm.release``
    leaves them alive but no longer current, so the graph is built anew
    (on the next copies) and the run matches the first.  On the CPU no
    capture prepares a copy: the test hands the graphs the copies a
    capture would hold."""
    _, pt = smoke_params()
    ex = _executor("ddim", fed=False)
    sch = _schedule("ddim", "static:n=2")

    def run():
        return ex.sample_compiled(pt, torch.Generator().manual_seed(0), 2,
                                  schedule=sch, label=_label())

    x = run()
    old = list(ex._segments.values())
    try:
        for g in old:
            g._halves = [gemm.prepare(w) for w in tdiffusion.token_weights(pt)]
            g._dropped = gemm.dropped()
        held = old[0]._halves
        assert not any(g.stale() for g in old)
        gemm.release()
        assert all(g.stale() for g in old)
        assert all(p.big_t.numel() for p in held)
        assert torch.equal(run(), x)
        assert ex.graph_count() == len(old)
        assert not any(g in old for g in ex._segments.values())
    finally:
        gemm.release()


@pytest.mark.parametrize("solver", SOLVERS)
def test_cuda_release_and_prepare_between_runs(cuda, solver):
    """``gemm.release`` and a fresh ``prepare_linear`` between two runs on
    one executor: the second run rebuilds the graphs on the new copies and
    matches the first bitwise."""
    from _torch_helpers import _numpy_params
    from repro_torch.convert import params_from_numpy
    pt = params_from_numpy(_numpy_params(), device="cuda")
    sch = _schedule(solver, "static:n=2")
    _, tcfg = smoke_cfgs()
    ex = tex.SmoothCacheExecutor(tcfg, getattr(tsolvers, solver)(STEPS),
                                 cfg_scale=1.5, device="cuda")
    label = torch.tensor(LABELS, device=cuda)

    def run():
        return ex.sample_compiled(pt, torch.Generator().manual_seed(2), 2,
                                  schedule=sch, label=label)

    x = run()
    old = list(ex._segments.values())
    gemm.release()
    tdiffusion.prepare_linear(pt)
    assert torch.equal(run(), x)
    assert not any(g in old for g in ex._segments.values())
