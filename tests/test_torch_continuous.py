"""The port's continuous batching (``ServeEngine(continuous=True)``,
``MicroBatcher.take_join``, the executor's ``split_run`` / ``merge_runs``)
— the counterpart of ``tests/test_continuous.py``.

* The executor on the smoke DiT (CPU): split → advance → merge is bitwise
  the unsplit run for all three run kinds (segmented, host-adaptive,
  fused-adaptive); a split row finishes bitwise as its solo run; a
  stochastic solver refuses to split.
* The engine on ``tests/test_continuous.py``'s virtual-clock fakes (their
  rows identify their own generator, their fused rows diverge by seed
  parity on steps [2, 4)): joins at boundaries, ``take_join``'s p2 shapes
  and entry-version rule, regroup and coalesce — and one trace through
  the JAX engine and the port's with equal ``BatchRecord``s, lineage and
  ``continuous`` report section.
* End to end on the smoke DiT: late requests join in-flight static and
  fused τ = 0 runs, and every served latent equals its request's solo
  ``generate`` from ``batch_generator([seed])``, bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_continuous as jc                 # the JAX engine's fakes
import test_serve as jt
from _torch_helpers import smoke_cfgs, smoke_params
from repro import serve as jserve
from repro_torch import serve
from repro_torch.cache import DiffusionPipeline
from repro_torch.core import calibration as tcal, executor as tex
from repro_torch.core import plan as tplan, schedule as tS, solvers
from repro_torch.serve.batcher import bucket_sizes
from test_torch_serve import FakeExecutor, make_store, port_artifact, req

# ---------------------------------------------------------------------------
# Fakes: test_continuous.py's split/merge surface, rows keyed by generators
# ---------------------------------------------------------------------------

#: seed parity as the JAX fakes compute it (last word of batch_key([s])),
#: indexed by the port's row generator seed, so both engines' fused rows
#: diverge alike
_PARITY = {serve.batch_seed([s]): jc._parity(s) for s in range(64)}


def _payload(keys, batch):
    """Row j's 'latent' identifies its generator — the same function of
    the same generator whatever batch the row rode in."""
    if keys:
        return np.asarray([[float(k.initial_seed() & 0xFFFFFFFF)]
                           for k in keys])
    return np.arange(batch, dtype=np.float64)[:, None]


def _expected_row(seed):
    return _payload([serve.batch_generator([seed])], 1)[0]


class SplitFakeExecutor(FakeExecutor):
    supports_split = True

    def start_run(self, params, key, batch, *, plan, schedule=None,
                  label=None, row_keys=None):
        return jc.SplitRunState(plan=plan, batch=batch,
                                keys=tuple(row_keys or ()))

    def advance_run(self, params, rs, *, check=False):
        run = rs.plan.runs[rs.run_index]
        self._programs.add(("seg", run.sig, rs.batch))
        self._charge(run.sig.skip, run.length)
        rs = dataclasses.replace(rs, run_index=rs.run_index + 1)
        if rs.done:
            rs.x = _payload(rs.keys, rs.batch)
        return rs

    split_run = jc.SplitFakeExecutor.split_run

    def merge_runs(self, runs):
        r0 = runs[0]
        if isinstance(r0, jc.SplitFusedState):
            assert all(r.schedule is r0.schedule and r.step == r0.step
                       for r in runs)
        else:
            assert all(r.plan is r0.plan and r.run_index == r0.run_index
                       for r in runs)
        return dataclasses.replace(
            r0, batch=sum(r.batch for r in runs),
            keys=tuple(k for r in runs for k in r.keys))


@dataclasses.dataclass
class SplitFusedState(jc.SplitFusedState):
    def row_signatures(self):
        if 2 <= self.step < 4:
            return tuple((_PARITY[k.initial_seed()],) for k in self.keys)
        return tuple((9,) for _ in self.keys)


class SplitFusedExecutor(SplitFakeExecutor):
    supports_fused_adaptive = True

    def start_adaptive_fused_run(self, params, key, batch, *, schedule,
                                 tau, proxy_map=None, pool=None, k_max=3,
                                 label=None, row_keys=None):
        self._programs.add(("fused", tuple(sorted(
            tuple(s.live_in) for s in pool)), batch))
        return SplitFusedState(schedule=schedule, batch=batch,
                               keys=tuple(row_keys or ()))

    def advance_adaptive_fused(self, params, rs, n_steps=None):
        remaining = rs.schedule.num_steps - rs.step
        length = remaining if n_steps is None else min(n_steps, remaining)
        for s in range(rs.step, rs.step + length):
            self._charge({t: bool(v[s])
                          for t, v in rs.schedule.skip.items()}, 1)
        rs = dataclasses.replace(rs, step=rs.step + length)
        if rs.done:
            rs.x = _payload(rs.keys, rs.batch)
        return rs


def make_continuous_engine(store=None, executor=SplitFakeExecutor, **kw):
    clock = serve.VirtualClock()
    store = store if store is not None else make_store(
        8, static2="static:n=2")
    ex = executor(clock)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_inflight", 1)
    kw.setdefault("continuous", True)
    eng = serve.ServeEngine(ex, params=None, store=store, clock=clock, **kw)
    return eng, clock, ex


def _run_join_scenario(continuous):
    """Two requests form a batch; two more become ready while it is in
    flight.  With one in-flight slot the late pair runs by joining at a
    boundary (continuous) or by waiting for the slot."""
    eng, clock, ex = make_continuous_engine(continuous=continuous)
    eng.submit(req(0, "static2"), req(1, "static2"))
    assert eng.step()
    eng.submit(req(2, "static2"), req(3, "static2"))
    return eng, eng.run_until_drained()


# ---------------------------------------------------------------------------
# The engine on fakes
# ---------------------------------------------------------------------------

def test_join_at_boundary_routes_and_is_deterministic():
    eng, res = _run_join_scenario(True)
    assert sorted(res) == [0, 1, 2, 3]
    for rid in range(4):
        np.testing.assert_array_equal(res[rid], _expected_row(rid))
    m = eng.metrics
    assert m.joins == 1 and m.joined_requests == 2 and m.merges == 1
    assert any("join@" in t for r in eng.records for t in r.lineage)
    assert len(m.joined_queue_waits) == 2
    eng2, res2 = _run_join_scenario(True)
    assert [r.lineage for r in eng2.records] == \
        [r.lineage for r in eng.records]
    assert eng2.metrics.queue_waits == eng.metrics.queue_waits
    for rid in res:
        np.testing.assert_array_equal(res2[rid], res[rid])


def test_join_beats_join_disabled_on_p95_wait():
    eng_c, _ = _run_join_scenario(True)
    eng_b, _ = _run_join_scenario(False)
    assert eng_b.metrics.joins == 0
    p95 = lambda e: serve.percentile(e.metrics.queue_waits, 95)  # noqa
    assert p95(eng_c) < p95(eng_b)


def test_join_respects_program_budget():
    eng, _ = _run_join_scenario(True)
    rep = eng.report()
    assert rep["compiles"]["model_variants"] <= rep["program_budget"]
    sizes = set(bucket_sizes(eng.batcher.max_batch))
    assert {p[2] for p in eng.executor._programs} <= sizes


def test_join_horizon_validated_and_bounds_late_joins():
    with pytest.raises(ValueError, match="join_horizon"):
        make_continuous_engine(join_horizon=1.5)
    eng, clock, _ = make_continuous_engine(join_horizon=0.0)
    eng.submit(req(0, "static2"), req(1, "static2"))
    assert eng.step()                    # past step 0: beyond the horizon
    eng.submit(req(2, "static2"), req(3, "static2"))
    eng.run_until_drained()
    assert eng.metrics.joins == 0


def test_take_join_only_lands_on_p2_shapes():
    eng, clock, ex = make_continuous_engine()
    entry = eng.store.get("static2")
    eng.queue.submit_many([req(i, "static2") for i in range(3)])
    taken = eng.batcher.take_join(0.0, entry, 2)
    assert [r.rid for r in taken] == [0, 1]
    assert eng.batcher.take_join(0.0, entry, 4) == []
    assert eng.batcher.take_join(0.0, entry, 2) == []
    taken = eng.batcher.take_join(0.0, entry, 1)
    assert [r.rid for r in taken] == [2]


def test_join_requires_matching_entry_version():
    eng, clock, ex = make_continuous_engine(
        store=make_store(8, static2="static:n=2", other="none"))
    entry = eng.store.get("static2")
    eng.queue.submit_many([req(0, "other")])
    assert eng.batcher.take_join(0.0, entry, 1) == []
    # a hot swap between formation and the boundary: the queued request
    # resolves to version 2, the run's entry is version 1
    store = _fused_store()
    eng, clock, ex = make_continuous_engine(store=store)
    entry = store.get("adaptive")
    eng.queue.submit_many([req(1, "adaptive")])
    assert [r.rid for r in eng.batcher.take_join(0.0, entry, 1)] == [1]
    eng.queue.submit_many([req(2, "adaptive")])
    store.reload("adaptive", port_artifact(jt._adaptive_artifact(8)))
    assert store.get("adaptive").version == entry.version + 1
    assert eng.batcher.take_join(0.0, entry, 1) == []


def _fused_store():
    store = make_store(8, static2="static:n=2")
    store.add_artifact("adaptive", port_artifact(
        jt._adaptive_artifact(num_steps=8)))
    return store


def test_regroup_and_coalesce_on_diverging_masks():
    """A τ > 0 fused batch whose rows want different masks splits into
    per-signature sub-runs at the boundary, and the sub-runs merge back
    once their signatures reconverge — every row's bits untouched."""
    evens = [s for s in range(64) if jc._parity(s) == 0][:2]
    odds = [s for s in range(64) if jc._parity(s) == 1][:2]
    seeds = evens + odds
    eng, clock, ex = make_continuous_engine(
        store=_fused_store(), executor=SplitFusedExecutor, max_inflight=2,
        adaptive_chunk=1)
    eng.submit(*[serve.Request(rid=i, seed=s, policy="adaptive")
                 for i, s in enumerate(seeds)])
    res = eng.run_until_drained()
    assert sorted(res) == [0, 1, 2, 3]
    m = eng.metrics
    assert m.regroups == 1 and m.merges == 1 and m.joins == 0
    tags = [t for r in eng.records for t in r.lineage]
    assert any(t.startswith("regroup@2:") for t in tags)
    assert any(t.startswith("coalesce@4:") for t in tags)
    assert m.lineage_events == {"coalesce": 1, "regroup": 2}
    for i, s in enumerate(seeds):
        np.testing.assert_array_equal(res[i], _expected_row(s))


# (rid, policy, arrival, seed) — fused rows of both parities, static
# requests that join in flight
TRACE = ([(i, "adaptive", 0.0, s) for i, s in
          enumerate([s for s in range(64) if jc._parity(s) == 0][:2]
                    + [s for s in range(64) if jc._parity(s) == 1][:2])]
         + [(4, "static2", 0.0, 40), (5, "static2", 0.0, 41),
            (6, "static2", 3.0, 42), (7, "static2", 3.0, 43),
            (8, "adaptive", 6.0, 44), (9, "static2", 30.0, 45)])
RECORD_FIELDS = ("group", "version", "bucket", "rids", "seeds", "labels",
                 "num_steps", "compute_fraction", "formed_at", "finished_at",
                 "decisions", "tau", "quality_cost", "lineage")


def _drain_trace(pkg, fake, artifact):
    clock = pkg.VirtualClock()
    store = pkg.ArtifactStore(jt.FakeCfg(), jt.FakeSolver(8))
    store.add_policy("static2", "static:n=2")
    store.add_artifact("adaptive", artifact)
    eng = pkg.ServeEngine(fake(clock), params=None, store=store, clock=clock,
                          max_batch=4, max_inflight=2, adaptive_chunk=1,
                          continuous=True)
    eng.submit(*[pkg.Request(rid=rid, seed=seed, policy=pol, arrival=arr)
                 for rid, pol, arr, seed in TRACE])
    eng.run_until_drained()
    return eng


def test_engine_matches_reference_on_one_continuous_trace():
    art = jt._adaptive_artifact(num_steps=8)
    ref = _drain_trace(jserve, jc.SplitFusedExecutor, art)
    got = _drain_trace(serve, SplitFusedExecutor, port_artifact(art))
    assert len(got.records) == len(ref.records) > 0
    for r, g in zip(ref.records, got.records):
        for f in RECORD_FIELDS:
            assert getattr(g, f) == getattr(r, f), f
    assert sorted(got.results) == sorted(ref.results) == list(range(10))
    for rid, _, _, seed in TRACE:
        np.testing.assert_array_equal(got.results[rid], _expected_row(seed))
        np.testing.assert_array_equal(ref.results[rid],
                                      jc._expected_row(seed))
    rj, rt = ref.report(), got.report()
    cj, ct = dict(rj["continuous"]), dict(rt["continuous"])
    assert ct == cj and ct["row_retries"] == 0  # no fault path on this trace
    assert ct["joins"] >= 1 and ct["regroups"] >= 1 and ct["coalesces"] >= 1
    for k in ("requests", "batches", "buckets", "queue_wait_s", "service_s",
              "makespan_s", "program_budget"):
        assert rt[k] == rj[k], k
    assert rt["compiles"]["model_variants"] == rj["compiles"]["xla_programs"]
    assert rt["compiles"]["model_variants"] <= rt["program_budget"]


# ---------------------------------------------------------------------------
# The executor on the smoke DiT
# ---------------------------------------------------------------------------

STEPS = 6


def _row_keys(n, base=100):
    return [serve.batch_generator([base + i]) for i in range(n)]


def _drain(advance, rs):
    while not rs.done:
        rs = advance(rs)
    return rs


@pytest.fixture(scope="module")
def dit():
    _, cfg = smoke_cfgs()
    _, params = smoke_params()
    ex = tex.SmoothCacheExecutor(cfg, solvers.ddim(STEPS), cfg_scale=1.5,
                                 device="cpu")
    sch = tS.fora(cfg.layer_types(), STEPS, 2)
    pm = tcal.ProxyMap({t: (0.5, 0.01) for t in cfg.layer_types()})
    return cfg, params, ex, sch, pm


def _starts(dit, n=2, base=100):
    """Start and advance of each run kind; every start draws from fresh
    generators (a generator's state moves as it draws)."""
    cfg, params, ex, sch, pm = dit
    label = torch.zeros(n, dtype=torch.int64)
    pool = tplan.mask_lattice(sch)
    return {
        "plan": (lambda: ex.start_run(params, None, n, plan=ex.plan_for(sch),
                                      schedule=sch, label=label,
                                      row_keys=_row_keys(n, base)),
                 lambda rs: ex.advance_run(params, rs)),
        "adaptive": (lambda: ex.start_adaptive_run(
            params, None, n, schedule=sch, tau=0.0, proxy_map=pm, pool=pool,
            k_max=2, label=label, row_keys=_row_keys(n, base)),
            lambda rs: ex.advance_adaptive_run(params, rs)),
        "fused": (lambda: ex.start_adaptive_fused_run(
            params, None, n, schedule=sch, tau=0.0, proxy_map=pm, pool=pool,
            k_max=2, label=label, row_keys=_row_keys(n, base)),
            lambda rs: ex.advance_adaptive_fused(params, rs, n_steps=2)),
    }


@pytest.mark.parametrize("kind", ["plan", "adaptive", "fused"])
def test_split_merge_bitwise(dit, kind):
    """split → advance → merge gives the unsplit run's rows bitwise, and a
    plain split + merge round trip mid-run is the identity."""
    start, advance = _starts(dit)[kind]
    whole = _drain(advance, start())
    rs = advance(start())                    # one boundary in
    subs = [_drain(advance, s) for s in dit[2].split_run(rs, [[0], [1]])]
    merged = dit[2].merge_runs(subs)
    assert torch.equal(merged.x, whole.x)
    assert bool(merged.healthy.all())
    rs2 = advance(start())
    rt = dit[2].merge_runs(dit[2].split_run(rs2, [[0], [1]]))
    assert torch.equal(rt.x, rs2.x)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(rt.cache), _leaves(rs2.cache)))


def _leaves(cache):
    return [d[k] for stage in cache for d in stage for k in sorted(d)]


@pytest.mark.parametrize("kind", ["plan", "adaptive", "fused"])
def test_split_rows_match_solo_runs(dit, kind):
    """Row 1 of a split sub-run finishes bitwise as a B = 1 run of row 1's
    own generator — the per-request replay contract joins rely on."""
    start, advance = _starts(dit)[kind]
    rs = advance(start())
    sub = _drain(advance, dit[2].split_run(rs, [[1]])[0])
    solo_start, _ = _starts(dit, 1, base=101)[kind]
    solo = _drain(advance, solo_start())
    assert torch.equal(sub.x, solo.x)


def test_split_and_merge_validate(dit):
    cfg, params, ex, sch, pm = dit
    start, advance = _starts(dit)["fused"]
    rs = advance(start())
    with pytest.raises(ValueError, match="two groups"):
        ex.split_run(rs, [[0], [0]])
    with pytest.raises(ValueError, match="out of range"):
        ex.split_run(rs, [[2]])
    other = _starts(dit)["plan"][0]()
    with pytest.raises(ValueError, match="different kinds"):
        ex.merge_runs([rs, other])
    with pytest.raises(ValueError, match="different steps"):
        ex.merge_runs([rs, advance(rs)])
    with pytest.raises(ValueError, match="batch 3"):
        ex.initial_latent_rows(_row_keys(2), 3)


def test_stochastic_solver_rejects_split(dit):
    cfg, params, _, sch, _ = dit
    solver = dataclasses.replace(solvers.ddim(4), stochastic=True)
    ex = tex.SmoothCacheExecutor(cfg, solver, cfg_scale=1.5, device="cpu")
    assert not ex.supports_split
    sch4 = tS.fora(cfg.layer_types(), 4, 2)
    label = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="stochastic"):
        ex.start_run(params, None, 1, plan=ex.plan_for(sch4), schedule=sch4,
                     label=label, row_keys=_row_keys(1))
    rs = ex.start_run(params, torch.Generator().manual_seed(0), 1,
                      plan=ex.plan_for(sch4), schedule=sch4, label=label)
    with pytest.raises(ValueError, match="stochastic"):
        ex.split_run(rs, [[0]])


def test_fused_row_signatures_and_decisions_follow_the_trace(dit):
    """A τ > 0 fused run's per-row desires and realized masks are read from
    its trace at boundaries; splitting keeps each row's trace."""
    cfg, params, ex, sch, pm = dit
    label = torch.zeros(2, dtype=torch.int64)
    rs = ex.start_adaptive_fused_run(params, None, 2, schedule=sch, tau=5.0,
                                     proxy_map=pm, k_max=2, label=label,
                                     row_keys=_row_keys(2))
    assert rs.row_signatures() is None
    rs = ex.advance_adaptive_fused(params, rs, n_steps=3)
    sigs = rs.row_signatures()
    assert len(sigs) == 2 and rs.decisions[0] == ()
    a, b = ex.split_run(rs, [[0], [1]])
    assert a.row_signatures() == sigs[:1] and b.row_signatures() == sigs[1:]
    assert ex.merge_runs([a, b]).decisions == rs.decisions


# ---------------------------------------------------------------------------
# End to end on the smoke DiT
# ---------------------------------------------------------------------------

def test_continuous_serving_real_dit_bit_identical(tmp_path):
    """Late arrivals join in-flight static and fused (τ = 0) adaptive
    batches at boundaries; every served latent equals its request's solo
    ``generate`` bitwise; variants stay within budget; the fused path
    makes no decision sync."""
    _, cfg = smoke_cfgs()
    _, params = smoke_params()
    spec = "adaptive:base=smoothcache(alpha=0.5),tau=0"
    calib = DiffusionPipeline(cfg, solvers.ddim(STEPS), spec, cfg_scale=1.5,
                              device="cpu")
    calib.calibrate(params, torch.Generator().manual_seed(1), 2,
                    cond_args={"label": torch.zeros(2, dtype=torch.int64)})
    path = calib.save_artifact(str(tmp_path / "adaptive0.cache.json"))
    ex = tex.SmoothCacheExecutor(cfg, solvers.ddim(STEPS), cfg_scale=1.5,
                                 device="cpu")
    store = serve.ArtifactStore(cfg, ex.solver, cfg_scale=1.5)
    store.add_policy("static2", "static:n=2")
    store.add_artifact("adaptive", path)
    eng = serve.ServeEngine(ex, params, store, max_batch=4, max_inflight=2,
                            clock=serve.VirtualClock(), check=True,
                            adaptive_chunk=2, continuous=True)

    def rq(i, policy):
        return serve.Request(rid=i, seed=100 + i, policy=policy,
                             label=i % cfg.num_classes)

    eng.submit(rq(0, "static2"), rq(1, "static2"), rq(2, "adaptive"),
               rq(3, "adaptive"))
    assert eng.step() and eng.step()        # both in flight at a boundary
    eng.submit(rq(4, "static2"), rq(5, "static2"), rq(6, "adaptive"),
               rq(7, "adaptive"))
    res = eng.run_until_drained()
    assert sorted(res) == list(range(8))
    m = eng.metrics
    assert m.joins == 2 and m.joined_requests == 4 and m.merges >= 2
    assert ex.host_sync_count == 0
    rep = eng.report()
    assert 0 < rep["compiles"]["model_variants"] <= rep["program_budget"]
    assert ex.compiled_variant_count("fused") > 0
    pipes = {"static2": DiffusionPipeline(cfg, solvers.ddim(STEPS),
                                          "static:n=2", cfg_scale=1.5,
                                          device="cpu"),
             "adaptive": DiffusionPipeline(cfg, solvers.ddim(STEPS), spec,
                                           cfg_scale=1.5, device="cpu")}
    pipes["adaptive"].load_artifact(path)
    for rec in eng.records:
        for rid, seed, lab in zip(rec.rids, rec.seeds, rec.labels):
            x = pipes[rec.group].generate(
                params, serve.batch_generator([seed]), 1,
                label=torch.tensor([lab]))
            assert torch.equal(x[0], torch.from_numpy(res[rid])), rid
