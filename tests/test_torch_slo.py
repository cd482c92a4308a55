"""The port's SLO layer (``repro_torch.slo``: admission control, the
τ-elastic controller and policy, overload traces) and the engine's
admission sweep, against the JAX package's ``repro.slo`` / ``repro.serve``.

* Admission decisions, controller histories (with their registry series)
  and overload traces: the same inputs through both packages, equal.
* One elastic + admission drain through both engines on a virtual clock,
  on ``tests/test_slo.py``'s fake executor (adaptive cost shrinks with τ):
  records, sheds with reasons and times, deferrals, controller history,
  rung per batch and the report's SLO sections equal.
* τ as a buffer of the fused step: ``batch_rule`` compares a (1,) tensor
  τ bit for bit as it compares a Python float, and on the smoke DiT two
  τ > 0 rungs served at one bucket share one fused graph, each rung's
  batches bitwise equal to ``generate`` at that τ.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_slo as js                        # the JAX SLO tests' fakes
from _torch_helpers import smoke_cfgs, smoke_params
from repro import serve as jserve, slo as jslo
from repro.obs import MetricsRegistry as JRegistry
from repro_torch import serve, slo
from repro_torch.cache.artifact import CacheArtifact
from repro_torch.core import calibration
from repro_torch.obs import MetricsRegistry


class FakeExecutor(js.FakeExecutor):
    """``tests/test_slo.py``'s fake, placed on the CPU device."""
    device = torch.device("cpu")


def port_artifact(art):
    return CacheArtifact.from_json(art.to_json())


def req(rid, policy, slo_mod, serve_mod, arrival=0.0, priority=0,
        deadline=None, max_tau=None):
    s = None
    if deadline is not None or max_tau is not None:
        s = slo_mod.SLO(deadline=deadline, max_tau=max_tau)
    return serve_mod.Request(rid=rid, seed=rid, policy=policy,
                             priority=priority, arrival=arrival, slo=s)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

CONTROLLERS = [
    dict(max_backlog_s=2.0, admit_priority=1.0, aging_rate=0.0,
         defer_interval=1.0),
    dict(max_backlog_s=1.0, admit_priority=1.0, aging_rate=0.5,
         defer_interval=1.0, headroom=1.5),
    dict(max_backlog_s=None),
    dict(max_backlog_s=0.0, admit_priority=2.0, aging_rate=2.0,
         defer_interval=0.25, headroom=0.5)]


@pytest.mark.parametrize("kw", CONTROLLERS)
def test_admission_decisions_match_reference(kw):
    ours, ref = slo.AdmissionController(**kw), jslo.AdmissionController(**kw)
    n = 0
    for prio in (0, 1, 3):
        for arrival in (None, 0.0, 1.5):
            for deadline in (None, 0.8, 3.0, 6.5, 50.0):
                for now in (0.0, 1.0, 2.5):
                    for backlog in (0.0, 0.5, 1.0, 5.0, 9.0):
                        for est in (0.0, 1.0, 4.0):
                            args = dict(arrival=arrival, priority=prio,
                                        deadline=deadline)
                            mine = req(0, "p", slo, serve, **args)
                            theirs = req(0, "p", jslo, jserve, **args)
                            got = ours.decide(mine, now, backlog_s=backlog,
                                              est_service_s=est)
                            want = ref.decide(theirs, now,
                                              backlog_s=backlog,
                                              est_service_s=est)
                            assert dataclasses.astuple(got) == \
                                dataclasses.astuple(want)
                            assert ours.effective_priority(mine, now) == \
                                ref.effective_priority(theirs, now)
                            n += 1
    assert n == 3 * 3 * 5 * 3 * 5 * 3
    assert slo.ADMIT == slo.AdmissionDecision("admit")


@pytest.mark.parametrize("kw", [dict(max_backlog_s=-1.0),
                                dict(aging_rate=-0.1),
                                dict(defer_interval=0.0),
                                dict(headroom=0.0)])
def test_admission_controller_validates_like_reference(kw):
    with pytest.raises(ValueError) as want:
        jslo.AdmissionController(**kw)
    with pytest.raises(ValueError) as got:
        slo.AdmissionController(**kw)
    assert str(got.value) == str(want.value)


def test_aging_lifts_effective_priority():
    ctl = slo.AdmissionController(max_backlog_s=1.0, admit_priority=1.0,
                                  aging_rate=0.5, defer_interval=1.0)
    r = req(0, "p", slo, serve)
    assert ctl.decide(r, 0.0, backlog_s=9.0).action == "defer"
    assert ctl.decide(r, 1.0, backlog_s=9.0).action == "defer"
    assert ctl.effective_priority(r, 2.0) == pytest.approx(1.0)
    assert ctl.decide(r, 2.0, backlog_s=9.0).action == "admit"
    frozen = slo.AdmissionController(max_backlog_s=1.0, admit_priority=1.0,
                                     aging_rate=0.0)
    assert frozen.decide(r, 1000.0, backlog_s=9.0).action == "defer"


# ---------------------------------------------------------------------------
# The τ-elastic controller
# ---------------------------------------------------------------------------

def _steady(c):
    t = 0.0
    for _ in range(50):                       # waits ≈ target
        c.observe_wait(1.0, t)
        c.update(t)
        t += 0.5


def _ramp(c):
    t = 0.0
    while c.rung < 2:                         # overload: ramp to the top
        c.observe_wait(5.0, t)
        c.update(t)
        t += 0.5
        assert t < 30.0
    while c.rung > 0:                         # calm: settle back down
        c.observe_wait(0.1, t)
        c.update(t)
        t += 0.5
        assert t < 120.0


def _noisy(c):
    rng = np.random.RandomState(4)
    t = 0.0
    for i in range(200):
        c.observe_wait(float(rng.gamma(2.0, 1.0 + (i // 40) % 3)), t)
        c.update(t)
        t += float(rng.uniform(0.1, 0.9))


@pytest.mark.parametrize("drive,rungs", [(_steady, []), (_ramp, [1, 2, 1, 0]),
                                         (_noisy, None)],
                         ids=["steady", "ramp", "noisy"])
def test_controller_history_matches_reference(drive, rungs):
    kw = dict(window=8, min_samples=2, interval_s=1.0, band=0.3,
              cooldown_s=2.0, settle=2)
    if drive is _steady:
        kw["window"] = 16
    mine_reg, their_reg = MetricsRegistry(), JRegistry()
    ours = slo.ElasticTauController(3, target_p95_wait_s=1.0,
                                    registry=mine_reg, **kw)
    ref = jslo.ElasticTauController(3, target_p95_wait_s=1.0,
                                    registry=their_reg, **kw)
    drive(ours)
    drive(ref)
    assert ours.history == ref.history
    assert ours.rung == ref.rung
    if rungs is not None:
        assert [r for _, r, _ in ours.history] == rungs
    else:
        assert len(ours.history) >= 2
    for name in ("slo.rung", "slo.p95_wait_s"):
        assert mine_reg.series(name).items() == their_reg.series(name).items()


def test_controller_validates_like_reference():
    for args, kw in (((0, 1.0), {}), ((2, 0.0), {}), ((2, 1.0), {"band": 1}),
                     ((2, 1.0), {"start_rung": 2})):
        with pytest.raises(ValueError) as want:
            jslo.ElasticTauController(*args, **kw)
        with pytest.raises(ValueError) as got:
            slo.ElasticTauController(*args, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Overload traces
# ---------------------------------------------------------------------------

def _classes(mod):
    return [mod.RequestClass("strict", "gen", weight=1.0, priority=1,
                             deadline_budget=6.0, max_tau=0.05),
            mod.RequestClass("bulk", "gen", weight=7.0,
                             deadline_budget=(8.0, 16.0)),
            mod.RequestClass("batch", "full", weight=2.0)]


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_overload_trace_matches_reference(seed):
    phases = [(1.0, 6), (4.0, 18), (0.5, 3)]
    got = slo.overload_trace(_classes(slo), phases,
                             np.random.RandomState(seed), start=2.0,
                             rid_start=100)
    want = jslo.overload_trace(_classes(jslo), phases,
                               np.random.RandomState(seed), start=2.0,
                               rid_start=100)
    assert len(got) == len(want) == 27
    for g, w in zip(got, want):
        assert (g.rid, g.seed, g.policy, g.priority, g.arrival) == \
            (w.rid, w.seed, w.policy, w.priority, w.arrival)
        assert (g.slo.deadline, g.slo.max_tau, g.slo.cls) == \
            (w.slo.deadline, w.slo.max_tau, w.slo.cls)
    assert len({r.slo.cls for r in got}) >= 2
    with pytest.raises(ValueError, match="weight"):
        slo.RequestClass("x", "p", weight=0.0)
    with pytest.raises(ValueError, match="RequestClass"):
        slo.overload_trace([], phases, np.random.RandomState(0))


# ---------------------------------------------------------------------------
# Elastic + admission drain: both engines on one trace
# ---------------------------------------------------------------------------

def _elastic_drain(serve_mod, slo_mod, artifact, fake, trace_seed, kw):
    """A warm → surge → cool ramp on the fake's clock (1 s per computed
    step, 8 steps a run): the surge outruns the service rate, so waits
    cross the controller's target and the backlog the admission
    threshold."""
    clock = serve_mod.VirtualClock()
    store = serve_mod.ArtifactStore(js.FakeCfg(), js.FakeSolver(8))
    store.add_policy("full", "none")
    store.add_ladder("gen", artifact, spec=js.LADDER3)
    ctrl = slo_mod.ElasticTauController(
        3, target_p95_wait_s=8.0, window=16, min_samples=2, interval_s=0.5,
        band=0.25, cooldown_s=1.0, settle=2)
    adm = slo_mod.AdmissionController(max_backlog_s=12.0,
                                      admit_priority=1.0, aging_rate=0.5,
                                      defer_interval=0.5)
    ex = fake(clock)
    eng = serve_mod.ServeEngine(ex, params=None, store=store, clock=clock,
                                scheduler=slo_mod.ElasticPolicy(ctrl),
                                admission=adm, **kw)
    classes = [
        slo_mod.RequestClass("strict", "gen", weight=1.0, priority=1,
                             deadline_budget=30.0, max_tau=0.05),
        slo_mod.RequestClass("bulk", "gen", weight=7.0,
                             deadline_budget=(40.0, 100.0)),
        slo_mod.RequestClass("batch", "full", weight=2.0)]
    reqs = slo_mod.overload_trace(
        classes, [(0.1, 6), (0.8, 24), (0.1, 4)],
        np.random.RandomState(trace_seed))
    eng.submit(*reqs)
    eng.run_until_drained()
    return eng, ctrl, ex, reqs


RECORD_FIELDS = ("group", "version", "bucket", "rids", "seeds", "labels",
                 "num_steps", "compute_fraction", "formed_at", "finished_at",
                 "decisions", "tau", "quality_cost")


@pytest.mark.parametrize("trace_seed,kw", [
    (1, dict(max_batch=2, max_inflight=2)),
    (5, dict(max_batch=4, max_inflight=1, adaptive_chunk=2))])
def test_elastic_admission_drain_matches_reference(trace_seed, kw):
    art = js._adaptive_artifact(8)
    ref, rctl, rex, rreqs = _elastic_drain(jserve, jslo, art, js.FakeExecutor,
                                           trace_seed, kw)
    got, gctl, gex, greqs = _elastic_drain(serve, slo, port_artifact(art),
                                           FakeExecutor, trace_seed, kw)
    assert len(got.records) == len(ref.records) > 0
    for r, g in zip(ref.records, got.records):
        for f in RECORD_FIELDS:
            assert getattr(g, f) == getattr(r, f), f
    assert got.shed == ref.shed
    assert sorted(got.results) == sorted(ref.results)
    assert gctl.history == rctl.history
    assert got.metrics.deferrals == ref.metrics.deferrals
    rj, rt = ref.report(), got.report()
    for k in ("requests", "batches", "buckets", "shed", "deferrals", "slo",
              "realized_tau", "predicted_quality_cost", "makespan_s",
              "queue_wait_s", "service_s", "program_budget"):
        assert rt.get(k) == rj.get(k), k
    assert got.registry.series("slo.backlog_s").items() == \
        ref.registry.series("slo.backlog_s").items()
    assert got.registry.snapshot()["gauges"] == \
        ref.registry.snapshot()["gauges"]
    assert [r.started for r in greqs] == [r.started for r in rreqs]
    # the scenario exercises every lever: rung moves, deferrals, sheds,
    # and every request has an outcome
    assert gctl.history and got.metrics.deferrals > 0 and got.shed
    assert all(got.outcome(r.rid)[0] in ("done", "shed") for r in greqs)
    assert len(rt["realized_tau"]) >= 2
    # τ > 0 rungs share one fused variant per bucket (+ τ = 0's own)
    buckets = {p[3] for p in gex._programs if p[0] == "fused"}
    assert gex.compiled_variant_count("fused") <= 2 * len(buckets)
    assert rt["compiles"]["model_variants"] <= rt["program_budget"]


def test_aging_prevents_starvation_end_to_end():
    clock = serve.VirtualClock()
    store = serve.ArtifactStore(js.FakeCfg(), js.FakeSolver(8))
    store.add_policy("full", "none")
    eng = serve.ServeEngine(
        FakeExecutor(clock), params=None, store=store, clock=clock,
        max_batch=1, max_inflight=1,
        admission=slo.AdmissionController(max_backlog_s=2.0,
                                          admit_priority=1.0,
                                          aging_rate=1.0,
                                          defer_interval=0.5))
    eng.submit(*[req(i, "full", slo, serve, priority=1) for i in range(6)],
               req(99, "full", slo, serve, priority=0))
    res = eng.run_until_drained()
    assert len(res) == 7 and 99 in res        # aged in, not starved
    assert eng.metrics.deferrals >= 1
    assert [rec.rids[0] for rec in eng.records][-1] == 99


def test_queue_resubmit_keeps_arrival():
    clock = serve.VirtualClock()
    q = serve.RequestQueue(clock)
    rs = [req(i, "p", slo, serve) for i in range(4)]
    for r in rs:
        q.submit(r)
    taken = q.take_rids("p", [2, 0], now=0.0)
    q.resubmit(taken[0], not_before=5.0)
    assert [r.rid for r in q.peek("p", 4.9)] == [1, 3]
    assert [r.rid for r in q.peek("p", 5.0)] == [0, 1, 3]
    assert taken[0].arrival == 0.0


# ---------------------------------------------------------------------------
# τ as a buffer of the fused step
# ---------------------------------------------------------------------------

def test_batch_rule_tensor_tau_compares_as_float_tau():
    """The rule's comparison rounds τ to f32 either way: a (1,) tensor τ
    and k_max give the bits a Python float and int give, including at
    values one ulp around τ."""
    rng = np.random.default_rng(0)
    for tau in (0.05, 0.1, 0.3, 1.0 / 3.0):
        t32 = np.float32(tau)
        near = np.array([np.nextafter(t32, -1, dtype=np.float32), t32,
                         np.nextafter(t32, 1, dtype=np.float32)], np.float32)
        acc = torch.from_numpy(np.concatenate(
            [near, rng.uniform(0, 2 * tau, 61).astype(np.float32)]
        ).reshape(16, 4))
        lag = torch.from_numpy(rng.integers(0, 4, (16, 4)).astype(np.int32))
        proxy = torch.zeros(16)
        a, b = torch.zeros(4), torch.zeros(4)
        for force in (False, torch.tensor(False), torch.tensor(True)):
            want = calibration.batch_rule(proxy, acc, lag, a, b, tau, 3,
                                          force_compute=force)
            got = calibration.batch_rule(
                proxy, acc, lag, a, b,
                *calibration.rule_limits(tau, 3, "cpu"), force_compute=force)
            for w, g in zip(want, got):
                assert torch.equal(w, g)


def test_tau_rungs_share_one_fused_graph_and_equal_generate(tmp_path):
    """Two τ > 0 rungs served at one bucket replay one fused step (the
    reference's one program per bucket), and each rung's batches are
    bitwise ``generate`` at that τ — the port of the JAX package's
    ``test_ladder_rung_bit_identical_to_generate``."""
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    _, cfg = smoke_cfgs()
    _, params = smoke_params()
    steps, spec = 6, "adaptive:base=smoothcache(alpha=0.5),tau=0.3"
    calib = DiffusionPipeline(cfg, solvers.ddim(steps), spec, cfg_scale=1.5,
                              device="cpu")
    calib.calibrate(params, torch.Generator().manual_seed(1), 2,
                    cond_args={"label": torch.zeros(2, dtype=torch.int64)})
    path = calib.save_artifact(str(tmp_path / "adaptive.cache.json"))

    ex = SmoothCacheExecutor(cfg, solvers.ddim(steps), cfg_scale=1.5,
                             device="cpu")
    store = serve.ArtifactStore(cfg, ex.solver, cfg_scale=1.5)
    ladder = store.add_ladder("gen", path, taus=[0.0, 0.1, 0.3])
    assert ladder.taus == (0.0, 0.1, 0.3)
    # a pinned controller (unreachable sample count): the test moves the
    # rung itself, between two τ > 0 rungs
    ctrl = slo.ElasticTauController(3, target_p95_wait_s=1e9,
                                    min_samples=10**6, start_rung=1)
    eng = serve.ServeEngine(ex, params, store, max_batch=2, max_inflight=1,
                            clock=serve.VirtualClock(),
                            scheduler=slo.ElasticPolicy(ctrl), check=True)
    graphs = []
    for rung, rids in ((1, (0, 1)), (2, (2, 3)), (1, (4, 5))):
        store.set_rung("gen", rung)
        eng.submit(*[serve.Request(rid=i, seed=100 + i, policy="gen",
                                   label=i % cfg.num_classes, arrival=0.0,
                                   slo=slo.SLO(deadline=1e9))
                     for i in rids])
        eng.run_until_drained()
        graphs.append(len(ex.fused_graphs()))
    assert graphs == [1, 1, 1]                # the rung moves capture none
    assert ex.compiled_variant_count("fused") == 1
    assert [(r.group, r.tau) for r in eng.records] == [
        ("gen/tau=0.1", 0.1), ("gen/tau=0.3", 0.3), ("gen/tau=0.1", 0.1)]
    rep = eng.report()
    assert rep["compiles"]["model_variants"] <= rep["program_budget"]
    assert rep["realized_tau"] == {"0.1": 4, "0.3": 2}

    art = CacheArtifact.load(path)
    for rec in eng.records:
        pipe = DiffusionPipeline(
            cfg, solvers.ddim(steps),
            f"adaptive:base=smoothcache(alpha=0.5),tau={rec.tau:g}",
            cfg_scale=1.5, device="cpu")
        pipe.load_artifact(art.at_tau(rec.tau))
        x, dec = pipe.generate(params, serve.batch_generator(rec.seeds),
                               rec.bucket,
                               label=torch.tensor(rec.labels),
                               return_decisions=True)
        assert dec == rec.decisions
        for j, rid in enumerate(rec.rids):
            np.testing.assert_array_equal(x[j].numpy(), eng.results[rid])
