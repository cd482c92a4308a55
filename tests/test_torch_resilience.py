"""The port's fault recovery (``repro_torch.resilience`` and the engine's
fault path) against the JAX package's ``repro.resilience``.

* Pure policy and harness parity: ``RetryPolicy.delay`` float for float,
  every validation error, ``FaultPlan.for_batch`` over serials 0–200,
  ``ChaosClock``'s taxed advances, the store's degradation ladder, the
  ``ChaosExecutor`` snapshot seams (on ``tests/test_durable.py``'s
  export-capable fake: imported, keep it importable).
* Engine parity: the chaos ramp of ``tests/test_resilience.py`` (24
  requests, three seeds) through the JAX engine and the port's over the
  JAX package's fakes — the plain fakes of ``tests/test_serve.py``, and
  with ``continuous=True`` the split/merge fakes of
  ``tests/test_continuous.py`` (whose rows identify their own
  generator): the same outcome and shed reason per rid, the same fault
  counters, the same (group, rids, lineage, finished_at) records, equal
  results.
* The reference's resilience tests that apply to the port, on the same
  fakes (NaN isolation, the ladder, watchdog, thresholds, terminal
  outcomes, artifact integrity, the chaos lane).
* On the smoke DiT (CPU): the executor's sentinels flag exactly the
  poisoned row and stay monotone; a served healthy row is bitwise its
  uninjected run; the fused path detects a NaN with no decision sync,
  and equals the host loop bitwise with one row poisoned; with
  ``continuous=True`` split-retry survivors on a static entry equal their
  solo ``generate`` bitwise.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import test_continuous as jc                 # the JAX engine's split fakes
import test_durable as jd                    # the JAX snapshot-seam fake
import test_serve as jt                      # the JAX engine's fakes
from _torch_helpers import smoke_cfgs, smoke_params
from repro import resilience as jres, serve as jserve
from repro.serve import store as jstore
from repro.slo import admission as jadmission
from repro_torch import resilience as tres, serve
from repro_torch.cache.artifact import CacheArtifact
from repro_torch.resilience import (BatchFault, ChaosClock, ChaosExecutor,
                                    FaultPlan, FaultSpec, ResiliencePolicy,
                                    RetryPolicy, corrupt_artifact,
                                    payload_checksum, verify_payload)
from repro_torch.resilience import faults
from repro_torch.serve.store import DEGRADED_PREFIX, FALLBACK_ENTRY, TauLadder
from repro_torch.slo import admission as tadmission
from test_torch_continuous import (SplitFakeExecutor, SplitFusedExecutor,
                                   _expected_row)
from test_torch_serve import FakeExecutor, make_store, port_artifact, req


class FakeFusedExecutor(jt.FakeFusedExecutor):
    device = torch.device("cpu")


def adaptive_store(num_steps=8):
    store = make_store(num_steps, static2="static:n=2")
    store.add_artifact("adaptive",
                       port_artifact(jt._adaptive_artifact(num_steps)))
    return store


def chaos_engine(plan, *, store=None, num_steps=8, resilience=None,
                 fused=False, **kw):
    """Engine over a ChaosExecutor-wrapped fake on a virtual clock."""
    clock = serve.VirtualClock()
    store = store if store is not None else make_store(
        num_steps, no_cache="none", static2="static:n=2")
    inner = (FakeFusedExecutor if fused else FakeExecutor)(clock)
    kw.setdefault("max_batch", 4)
    eng = serve.ServeEngine(
        ChaosExecutor(inner, plan, clock), params=None, store=store,
        clock=clock, resilience=resilience if resilience is not None
        else ResiliencePolicy(), **kw)
    return eng, clock


def plain_engine(*, store=None, num_steps=8, **kw):
    clock = serve.VirtualClock()
    store = store if store is not None else make_store(
        num_steps, no_cache="none", static2="static:n=2")
    kw.setdefault("max_batch", 4)
    return serve.ServeEngine(FakeExecutor(clock), params=None, store=store,
                             clock=clock, **kw), clock


# ---------------------------------------------------------------------------
# Policy and harness against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(max_retries=3, backoff_base=0.1, backoff_factor=2.0,
                 jitter=0.2, seed=42),
    dict(backoff_base=0.5, jitter=0.0), dict(seed=1234, jitter=0.9)])
def test_retry_delays_equal_the_reference(kw):
    t, j = RetryPolicy(**kw), jres.RetryPolicy(**kw)
    for rid in range(51):
        for attempt in range(1, 5):
            assert t.delay(attempt, rid) == j.delay(attempt, rid)


def _raised(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", [
    ("RetryPolicy", dict(max_retries=-1)), ("RetryPolicy", dict(jitter=1.0)),
    ("RetryPolicy", dict(jitter=-0.1)),
    ("RetryPolicy", dict(backoff_factor=0.5)),
    ("RetryPolicy", dict(backoff_base=-1.0)),
    ("ResiliencePolicy", dict(watchdog_factor=0.0)),
    ("ResiliencePolicy", dict(watchdog_floor_s=-1.0)),
    ("ResiliencePolicy", dict(entry_fault_threshold=0)),
    ("FaultPlan", dict(nan_rate=0.7, stuck_rate=0.7)),
    ("FaultPlan", dict(nan_rate=1.5)), ("FaultPlan", dict(error_rate=-0.1)),
    ("FaultPlan", dict(max_chunk=0)),
    ("FaultSpec", dict(kind=faults.NAN_LATENT, chunk=0)),
    ("delay", dict(attempt=0)), ("deadline", dict(est_s=1.0))])
def test_validation_errors_match_the_reference(case):
    name, kw = case
    makers = []
    for mod in (tres, jres):
        if name == "delay":
            makers.append(lambda m=mod: m.RetryPolicy().delay(**kw))
        elif name == "deadline":
            makers.append(lambda m=mod: m.ResiliencePolicy().deadline(**kw))
        else:
            makers.append(lambda m=mod: getattr(m, name)(**kw))
    got, want = (_raised(m) for m in makers)
    assert want is not None and got == want
    with pytest.raises(ValueError, match="slow_rate"):
        ChaosClock(serve.VirtualClock(), slow_rate=2.0)


@pytest.mark.parametrize("seed", [0, 3, 1234])
def test_fault_plans_equal_the_reference(seed):
    kw = dict(seed=seed, nan_rate=0.3, stuck_rate=0.2, error_rate=0.1,
              stall_s=7.0, max_chunk=3)
    t, j = FaultPlan(**kw), jres.FaultPlan(**kw)
    struck = 0
    for bucket in (1, 2, 4):
        for serial in range(201):
            a, b = t.for_batch(serial, bucket), j.for_batch(serial, bucket)
            assert (a is None) == (b is None), (serial, bucket)
            if a is not None:
                struck += 1
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert t.for_batch(serial, bucket) is a       # memoized
    assert 0.5 * 603 < struck < 0.7 * 603
    # explicit entries override the draw — how a test aims at one batch
    spec = FaultSpec(faults.INJECTED, chunk=2)
    aimed = FaultPlan(faults={3: spec}, **kw)
    assert aimed.for_batch(3, 4) is spec
    assert aimed.for_batch(4, 4) == t.for_batch(4, 4)


def test_chaos_clock_taxes_the_reference_advances():
    t = ChaosClock(serve.VirtualClock(), seed=11, slow_rate=0.3, slow_s=2.0)
    j = jres.ChaosClock(jserve.VirtualClock(), seed=11, slow_rate=0.3,
                        slow_s=2.0)
    for n in range(300):
        assert t.advance(0.5 + n % 3) == j.advance(0.5 + n % 3)
    assert t.slowed == j.slowed and 60 <= t.slowed <= 120


@pytest.mark.parametrize("kind", ["ladder", "adaptive", "static"])
def test_degraded_entry_names_match_the_reference(kind):
    art = jt._adaptive_artifact(8, tau=0.2)
    stores = (jt.make_store(8, static2="static:n=2"),
              make_store(8, static2="static:n=2"))
    for st, a in zip(stores, (art, port_artifact(art))):
        if kind == "ladder":
            st.add_ladder("gen", a, taus=[0.0, 0.1, 0.2])
        else:
            st.add_artifact("gen", a)
    group = "static2" if kind == "static" else "gen"
    names = [[st.degraded_entry_name(group, level) for level in range(4)]
             for st in stores]
    assert names[0] == names[1]
    assert names[1][0] == group and names[1][3] == FALLBACK_ENTRY
    assert jstore.FALLBACK_ENTRY == FALLBACK_ENTRY
    assert jstore.DEGRADED_PREFIX == DEGRADED_PREFIX
    if kind == "adaptive":
        dname = names[1][1]
        assert dname == f"{DEGRADED_PREFIX}gen/tau0"
        assert stores[0].get(dname).schedule.to_json() == \
            stores[1].get(dname).schedule.to_json()
        assert stores[1].get(dname).tau == 0.0
    if kind == "static":
        assert names[1][1] is None
    fb = [st.get(FALLBACK_ENTRY) for st in stores]
    assert fb[0].schedule.to_json() == fb[1].schedule.to_json()
    assert fb[1].compute_fraction() == 1.0


# ---------------------------------------------------------------------------
# Engine parity: the chaos ramp through both engines
# ---------------------------------------------------------------------------

def _ramp(pkg, res, adm, fake, seed, continuous):
    """``tests/test_resilience.py``'s chaos ramp: a mixed static/adaptive
    trace of 24 requests under seeded NaN rows, stalls, injected errors
    and slow-device weather, a watchdog, and bounded retries."""
    clock = pkg.VirtualClock()
    weather = res.ChaosClock(clock, seed=seed, slow_rate=0.2, slow_s=0.5)
    store = pkg.ArtifactStore(jt.FakeCfg(), jt.FakeSolver(8))
    store.add_policy("static2", "static:n=2")
    art = jt._adaptive_artifact()
    store.add_artifact("adaptive", art if pkg is jserve
                       else port_artifact(art))
    plan = res.FaultPlan(seed=seed, nan_rate=0.15, stuck_rate=0.1,
                         error_rate=0.05, stall_s=30.0, max_chunk=2)
    pol = res.ResiliencePolicy(
        retry=res.RetryPolicy(max_retries=2, backoff_base=0.05, seed=seed),
        watchdog_factor=4.0, watchdog_floor_s=1.0)
    eng = pkg.ServeEngine(
        res.ChaosExecutor(fake(weather), plan, clock), params=None,
        store=store, clock=clock, max_batch=4, resilience=pol,
        cost_model=adm.ServiceCostModel(default_step_cost=1.0),
        continuous=continuous)
    eng.submit(*[pkg.Request(rid=i, seed=i, arrival=0.3 * i,
                             policy="adaptive" if i % 2 else "static2")
                 for i in range(24)])
    eng.run_until_drained()
    return eng


@pytest.mark.chaos
@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_chaos_ramp_matches_the_reference(seed, continuous):
    fakes = ((jc.SplitFusedExecutor, SplitFusedExecutor) if continuous
             else (jt.FakeExecutor, FakeExecutor))
    ref = _ramp(jserve, jres, jadmission, fakes[0], seed, continuous)
    got = _ramp(serve, tres, tadmission, fakes[1], seed, continuous)
    for rid in range(24):
        (gk, gv), (rk, rv) = got.outcome(rid), ref.outcome(rid)
        assert gk == rk and gk in ("done", "shed"), rid
        if gk == "shed":
            assert gv == rv
        elif continuous:
            np.testing.assert_array_equal(gv, _expected_row(rid))
            np.testing.assert_array_equal(rv, jc._expected_row(rid))
        else:
            np.testing.assert_array_equal(gv, rv)
    assert got.shed == ref.shed
    gm, rm = got.metrics, ref.metrics
    for name in ("fault_kinds", "fault_groups", "faults_total", "retries",
                 "requeued", "degraded", "row_retries", "shed_reasons"):
        assert getattr(gm, name) == getattr(rm, name), name
    assert gm.faults_total == sum(gm.fault_kinds.values())
    assert [(r.group, r.rids, r.lineage, r.finished_at)
            for r in got.records] == [(r.group, r.rids, r.lineage,
                                       r.finished_at) for r in ref.records]
    rt, rj = got.report(), ref.report()
    assert rt["faults"] == rj["faults"]
    assert rt["continuous"] == rj["continuous"]
    assert len(got.results) > 0 and gm.faults_total > 0
    if continuous:
        # seed 0 strikes no NaN row; the others split one out mid-run
        split = any("split_retry@" in t for r in got.records
                    for t in r.lineage)
        assert split == (gm.row_retries > 0) == (seed != 0)


# ---------------------------------------------------------------------------
# The reference's engine tests on the fakes
# ---------------------------------------------------------------------------

def test_nan_row_isolated_survivors_identical_faulted_degrades():
    plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=1,
                                          chunk=1)})
    eng, _ = chaos_engine(plan, store=adaptive_store())
    eng.submit(*[req(i, "adaptive") for i in range(4)])
    res = eng.run_until_drained()
    assert sorted(res) == [0, 1, 2, 3]
    ref, _ = plain_engine(store=adaptive_store())
    ref.submit(*[req(i, "adaptive") for i in range(4)])
    ref_res = ref.run_until_drained()
    for rid in (0, 2, 3):
        np.testing.assert_array_equal(res[rid], ref_res[rid])
    groups = [r.group for r in eng.records]
    assert groups[0] == "adaptive"
    assert f"{DEGRADED_PREFIX}adaptive/tau0" in groups
    assert eng.metrics.fault_kinds == {faults.NAN_LATENT: 1}
    assert (eng.metrics.retries, eng.metrics.degraded,
            eng.metrics.requeued) == (1, 1, 0)
    assert eng.outcome(1)[0] == "done"


def test_fused_path_nan_row_isolated():
    plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=0,
                                          chunk=1)})
    eng, _ = chaos_engine(plan, store=adaptive_store(), fused=True,
                          adaptive_chunk=3)
    eng.submit(req(0, "adaptive"), req(1, "adaptive"))
    assert sorted(eng.run_until_drained()) == [0, 1]
    assert eng.metrics.fault_kinds == {faults.NAN_LATENT: 1}
    assert eng.metrics.retries == 1
    assert eng.records[0].group == "adaptive" and 1 in eng.records[0].rids


def test_all_rows_poisoned_aborts_once_and_falls_back_to_no_cache():
    plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=0,
                                          chunk=1)})
    eng, _ = chaos_engine(plan)
    eng.submit(req(0, "static2"))
    assert sorted(eng.run_until_drained()) == [0]
    assert eng.metrics.faults_total == 1 and eng.metrics.degraded == 1
    assert eng.records[-1].group == FALLBACK_ENTRY
    assert FALLBACK_ENTRY in eng.store


def test_persistent_faults_end_as_reasoned_terminal_outcome():
    plan = FaultPlan(seed=5, nan_rate=1.0, max_chunk=1)
    pol = ResiliencePolicy(retry=RetryPolicy(max_retries=1,
                                             backoff_base=0.01))
    eng, _ = chaos_engine(plan, resilience=pol)
    eng.submit(req(0, "static2"))
    eng.run_until_drained()
    assert eng.outcome(0) == ("shed", f"fault:{faults.NAN_LATENT}")
    assert eng.metrics.shed_reasons == {f"fault:{faults.NAN_LATENT}": 1}
    assert not eng.results


def test_injected_fault_requeues_all_rows_at_original_arrival():
    plan = FaultPlan(faults={0: FaultSpec(faults.INJECTED, chunk=1)})
    eng, _ = chaos_engine(plan)
    r0, r1 = req(0, "static2"), req(1, "static2")
    eng.submit(r0, r1)
    assert sorted(eng.run_until_drained()) == [0, 1]
    assert eng.metrics.fault_kinds == {faults.INJECTED: 1}
    assert eng.metrics.requeued == 2 and eng.metrics.retries == 0
    assert len(eng.records) == 1 and eng.records[0].rids == (0, 1)
    assert r0.arrival == 0.0 and r0.started > 0.0
    assert r0.queue_wait == pytest.approx(r0.started)


def test_watchdog_aborts_stuck_batch_and_excludes_it_from_cost_model():
    plan = FaultPlan(faults={0: FaultSpec(faults.STUCK_BATCH, chunk=1,
                                          stall_s=50.0)})
    pol = ResiliencePolicy(watchdog_factor=3.0, watchdog_floor_s=0.5)
    eng, _ = chaos_engine(
        plan, resilience=pol,
        cost_model=tadmission.ServiceCostModel(default_step_cost=1.0))
    eng.submit(req(0, "static2"), req(1, "static2"))
    assert sorted(eng.run_until_drained()) == [0, 1]
    assert eng.metrics.fault_kinds == {faults.STUCK_BATCH: 1}
    assert eng.metrics.requeued == 2
    assert eng.cost_model.per_step("static2") < 2.0


def test_watchdog_disabled_by_default_stall_just_serves_late():
    plan = FaultPlan(faults={0: FaultSpec(faults.STUCK_BATCH, chunk=1,
                                          stall_s=50.0)})
    eng, _ = chaos_engine(plan)
    eng.submit(req(0, "static2"))
    assert sorted(eng.run_until_drained()) == [0]
    assert eng.metrics.faults_total == 0


def test_fault_threshold_marks_entry_unhealthy_and_sheds_its_traffic():
    plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=0,
                                          chunk=1)})
    eng, _ = chaos_engine(plan,
                          resilience=ResiliencePolicy(entry_fault_threshold=1))
    eng.submit(req(0, "static2", arrival=0.0),
               req(1, "static2", arrival=100.0))
    eng.run_until_drained()
    assert eng.outcome(0)[0] == "done"
    assert eng.outcome(1) == ("shed", "unhealthy_entry")
    assert "threshold" in eng.store.health.status("static2")[
        "unhealthy_reason"]
    eng.store.health.mark_healthy("static2")
    eng.submit(req(2, "static2"))
    eng.run_until_drained()
    assert eng.outcome(2)[0] == "done"


def test_stall_shed_gives_every_queued_request_an_outcome():
    """The stall guard's degrade-don't-die path: every queued request,
    ready or not yet arrived, ends as an explicit ``stalled`` shed."""
    eng, _ = chaos_engine(FaultPlan())
    eng.submit(req(0, "static2"), req(1, "static2", arrival=5.0))
    eng._stall_shed("stalled", 0.0)
    assert eng.outcome(0) == eng.outcome(1) == ("shed", "stalled")
    assert len(eng.queue) == 0
    assert eng.metrics.shed_reasons == {"stalled": 2}


def test_batch_fault_carries_typed_rows():
    bf = BatchFault(faults.NAN_LATENT, sample_flags=[True, False, True],
                    detail="why")
    assert bf.poisoned_rows == (1,)
    assert "poisoned_rows=[1]" in str(bf) and "why" in str(bf)
    assert BatchFault(faults.STUCK_BATCH).poisoned_rows == ()
    assert str(bf) == str(jres.BatchFault(
        faults.NAN_LATENT, sample_flags=[True, False, True], detail="why"))


def test_rung_for_cap_boundaries():
    lad = TauLadder(name="l", rung_names=("a", "b", "c"),
                    taus=(0.05, 0.1, 0.2))
    assert lad.rung_for_cap(0.01) is None
    assert lad.rung_for_cap(0.05) == 0
    assert lad.rung_for_cap(0.05 - 1e-13) == 0
    assert [lad.rung_for_cap(c) for c in (0.1, 0.15, 1.0, 0.0)] == \
        [1, 1, 2, None]


def test_chaos_seams_round_trip_a_run():
    """``export_run`` unwraps the proxy; ``import_run`` re-wraps the
    restored run with no pending fault — as the JAX package's seams do,
    on ``tests/test_durable.py``'s export-capable fake."""
    from repro.resilience import chaos as jchaos
    from repro_torch.resilience.chaos import ChaosRun
    store = make_store(8, static2="static:n=2")
    entry = store.get("static2")
    out = []
    for mod, run_cls in ((tres, ChaosRun), (jres, jchaos.ChaosRun)):
        ex = mod.ChaosExecutor(
            jd.DurableFakeExecutor(serve.VirtualClock()),
            mod.FaultPlan(faults={0: mod.FaultSpec(faults.INJECTED,
                                                   chunk=3)}))
        rs = ex.start_run(None, None, 2, plan=entry.plan)
        assert isinstance(rs, run_cls) and rs._spec is not None
        rs = ex.advance_run(None, rs)
        kind, arrays, static = ex.export_run(rs)
        assert (kind, arrays, static) == ex.export_run(rs._inner)
        back = ex.import_run(None, kind, arrays, static, plan=entry.plan)
        assert isinstance(back, run_cls) and back._spec is None
        assert back._batch == 2 and back.run_index == rs.run_index
        while not back.done:                   # no fault left to strike
            back = ex.advance_run(None, back)
        out.append((kind, static, ex.injected))
    assert out[0] == out[1] == ("plan", {"batch": 2, "run_index": 1}, {})


def test_chaos_proxy_unwraps_the_fused_step():
    """``fused_step_for`` takes a run state, so the wrapper hands the
    wrapped executor the real one — and has no such method where the
    wrapped executor has none (an engine probes for it)."""
    seen = []

    class Inner(FakeFusedExecutor):
        def fused_step_for(self, params, rs):
            seen.append(rs)
            return "step"

    store = adaptive_store()
    entry = store.get("adaptive")
    ex = ChaosExecutor(Inner(serve.VirtualClock()), FaultPlan())
    rs = ex.start_adaptive_fused_run(None, None, 2, schedule=entry.schedule,
                                     tau=entry.tau, pool=entry.pool())
    assert ex.fused_step_for(None, rs) == "step"
    assert seen == [rs._inner]
    plain = ChaosExecutor(FakeFusedExecutor(serve.VirtualClock()),
                          FaultPlan())
    assert getattr(plain, "fused_step_for", None) is None


# ---------------------------------------------------------------------------
# Artifact integrity
# ---------------------------------------------------------------------------

def _curvy_artifact(**vals):
    curves = {"attn": np.asarray([[1.0, np.nan], [0.5, 2.0]], np.float64)}
    curves.update({t: np.asarray(c, np.float64) for t, c in vals.items()})
    return dataclasses.replace(port_artifact(jt._static_artifact()),
                               curves=curves)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corrupt_artifact_matches_the_reference_and_is_refused(tmp_path,
                                                               seed):
    art = _curvy_artifact()
    paths = [str(tmp_path / f"{n}.cache.json") for n in ("t", "j")]
    for p in paths:
        art.save(p)
    corrupt_artifact(paths[0], seed=seed)
    jres.corrupt_artifact(paths[1], seed=seed)
    with open(paths[0]) as f, open(paths[1]) as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match="checksum mismatch"):
        CacheArtifact.load(paths[0])
    with pytest.raises(ValueError, match="checksum"):
        make_store().add_artifact("entry", paths[0])


def test_checksums_and_pre_checksum_payloads():
    payload = json.loads(_curvy_artifact().to_json())
    assert payload["checksum"] == payload_checksum(payload)
    del payload["checksum"]
    payload["format_version"] = 2
    verify_payload(payload)
    assert CacheArtifact.from_json(json.dumps(payload)).arch == "fake-arch"


def test_inf_curves_roundtrip_but_never_serve():
    art = _curvy_artifact(ffn=[[np.inf, 1.0], [-np.inf, np.nan]])
    back = CacheArtifact.from_json(art.to_json())
    np.testing.assert_array_equal(back.curves["ffn"], art.curves["ffn"])
    with pytest.raises(ValueError, match="calibration diverged"):
        back.validate_for(arch="fake-arch")
    with pytest.raises(ValueError, match="calibration diverged"):
        make_store().add_artifact("bad", back)


def test_unrecognized_curve_string_raises_clear_error():
    payload = json.loads(_curvy_artifact().to_json())
    del payload["checksum"]
    payload["curves"]["attn"][0][0] = "bogus"
    with pytest.raises(ValueError, match="unrecognized value 'bogus'"):
        CacheArtifact.from_json(json.dumps(payload))


def test_add_ladder_rejects_non_monotone_taus_both_paths():
    art = port_artifact(jt._adaptive_artifact())
    store = make_store()
    for kw in (dict(taus=[0.2, 0.1]), dict(taus=[0.1, 0.1]),
               dict(spec="adaptive:base=static(n=2),tau=[0.2,0.1]")):
        with pytest.raises(ValueError, match="ascending"):
            store.add_ladder("lad", art, **kw)
    assert "lad" not in store and len(store) == 0


def test_reload_failure_is_atomic_and_quarantined(tmp_path):
    path = str(tmp_path / "entry.cache.json")
    port_artifact(jt._static_artifact()).save(path)
    store = make_store()
    old = store.add_artifact("entry", path)
    eng, _ = plain_engine(store=store, max_batch=2)
    eng.submit(req(0, "entry"), req(1, "entry"))
    eng.run_until_drained()
    variants = eng.executor.compiled_variant_count()
    corrupt_artifact(path, seed=2)
    with pytest.raises(ValueError, match="checksum"):
        store.reload("entry")
    assert store.get("entry") is old
    reason = store.health.quarantine_reason("entry")
    assert "hot-reload rejected" in reason and "checksum" in reason
    eng.submit(req(2, "entry"), req(3, "entry"))
    eng.run_until_drained()
    assert eng.executor.compiled_variant_count() == variants
    assert sorted(eng.results) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# The chaos lane
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_chaos_clean_plan_changes_nothing():
    eng, _ = chaos_engine(FaultPlan())
    eng.submit(*[req(i, "static2", arrival=0.1 * i) for i in range(6)])
    res = eng.run_until_drained()
    ref, _ = plain_engine()
    ref.submit(*[req(i, "static2", arrival=0.1 * i) for i in range(6)])
    ref_res = ref.run_until_drained()
    assert sorted(res) == sorted(ref_res) == list(range(6))
    assert all(np.array_equal(res[i], ref_res[i]) for i in range(6))
    assert [r.rids for r in eng.records] == [r.rids for r in ref.records]
    assert eng.metrics.faults_total == 0
    assert eng.records[-1].finished_at == ref.records[-1].finished_at


@pytest.mark.chaos
def test_split_retry_keeps_survivor_run_state():
    """A row poisoned mid-run splits out and retries while the surviving
    row keeps its run state; with ``split_retry=False`` it rides to the
    finish instead."""
    for split in (True, False):
        clock = serve.VirtualClock()
        plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=1,
                                              chunk=1)})
        pol = ResiliencePolicy(
            retry=RetryPolicy(max_retries=2, backoff_base=0.0, jitter=0.0),
            degrade=False, split_retry=split)
        eng = serve.ServeEngine(
            ChaosExecutor(SplitFakeExecutor(clock), plan, clock), None,
            make_store(8, static2="static:n=2"), clock=clock, max_batch=4,
            continuous=True, resilience=pol)
        eng.submit(req(0, "static2"), req(1, "static2"))
        res = eng.run_until_drained()
        assert sorted(res) == [0, 1]
        np.testing.assert_array_equal(res[0], _expected_row(0))
        m = eng.metrics
        assert (m.row_retries, m.retries, m.requeued) == (int(split), 1, 0)
        survivor = [r for r in eng.records if 0 in r.rids][0]
        assert any("split_retry@" in t
                   for t in survivor.lineage) == split


# ---------------------------------------------------------------------------
# The real executor on the smoke DiT (CPU)
# ---------------------------------------------------------------------------

STEPS = 6


def _executor():
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    _, cfg = smoke_cfgs()
    return SmoothCacheExecutor(cfg, solvers.ddim(STEPS), cfg_scale=1.5,
                               device="cpu")


def _poison(rs, row):
    x = rs.x.clone()
    x[row] = float("nan")
    return dataclasses.replace(rs, x=x)


def test_executor_sentinels_flag_poisoned_row():
    from repro_torch.cache import registry
    from repro_torch.core import plan as plan_lib
    _, params = smoke_params()
    ex = _executor()
    sch = registry.get("static:n=2").build(ex.cfg.layer_types(), STEPS)
    rs = ex.start_run(params, torch.Generator().manual_seed(0), 2,
                      plan=plan_lib.analyze(sch), schedule=sch,
                      label=torch.zeros(2, dtype=torch.int64))
    rs = ex.advance_run(params, rs)
    assert rs.healthy.tolist() == [True, True]
    rs = _poison(rs, 1)
    flags = []
    while not rs.done:
        rs = ex.advance_run(params, rs)
        flags.append(rs.healthy.tolist())
    assert all(f == [True, False] for f in flags)       # exact, monotone
    assert bool(torch.isfinite(rs.x[0]).all())


def test_poisoning_never_writes_into_a_shared_latent():
    """The harness writes the NaN into a copy: whoever else holds the
    run's latent (a split sibling, a fused graph's unloaded copy) sees
    its rows untouched."""
    from repro_torch.cache import registry
    from repro_torch.core import plan as plan_lib
    _, params = smoke_params()
    ex = _executor()
    held = []

    class Keep:
        def __getattr__(self, name):
            return getattr(ex, name)

        def advance_run(self, params, rs, **kw):
            out = ex.advance_run(params, rs, **kw)
            held.append((out.x, out.x.clone()))
            return out

    sch = registry.get("static:n=2").build(ex.cfg.layer_types(), STEPS)
    chaos = ChaosExecutor(Keep(), FaultPlan(faults={0: FaultSpec(
        faults.NAN_LATENT, row=0, chunk=1)}), mark_flags=False)
    rs = chaos.start_run(params, torch.Generator().manual_seed(0), 2,
                         plan=plan_lib.analyze(sch), schedule=sch)
    rs = chaos.advance_run(params, rs)
    shared, before = held[0]
    assert torch.equal(shared, before)
    assert bool(torch.isnan(rs.x[0]).all())
    assert torch.equal(rs.x[1], before[1])
    assert chaos.injected == {faults.NAN_LATENT: 1}


def test_poisoned_latent_reaches_the_segment_graph():
    """A NaN the harness writes into a run's latent between segments is
    copied into the segment graph's buffers, and the graph's health fold
    flips that row only: the other row stays healthy and bitwise its
    clean run's."""
    from repro_torch.cache import registry
    from repro_torch.core import plan as plan_lib
    _, params = smoke_params()
    sch = registry.get("static:n=2").build(_executor().cfg.layer_types(),
                                           STEPS)
    plan = plan_lib.analyze(sch)

    def run(poison):
        ex = _executor()
        chaos = ChaosExecutor(ex, FaultPlan(faults={0: FaultSpec(
            faults.NAN_LATENT, row=0, chunk=1)} if poison else {}),
            mark_flags=False)
        rs = chaos.start_run(params, torch.Generator().manual_seed(0), 2,
                             plan=plan, schedule=sch)
        rs = chaos.advance_run(params, rs)
        assert bool(rs._inner.healthy.all())     # struck after the advance
        rs = chaos.advance_run(params, rs)
        assert ex.graph_count("seg") == 2
        return rs._inner

    hit, clean = run(True), run(False)
    assert hit.healthy.tolist() == [False, True]
    assert bool(torch.isnan(hit.x[0]).all())
    assert torch.equal(hit.x[1], clean.x[1])
    assert bool(clean.healthy.all())


def _static_engine(chaos, continuous=False, n=2, split=True):
    from repro_torch.core import solvers
    _, params = smoke_params()
    inner = _executor()
    store = serve.ArtifactStore(inner.cfg, solvers.ddim(STEPS),
                                cfg_scale=1.5)
    store.add_policy("static2", "static:n=2")
    ex = inner
    if chaos:
        plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=1,
                                              chunk=1)})
        ex = ChaosExecutor(inner, plan, mutate_latent=True, mark_flags=False)
    eng = serve.ServeEngine(
        ex, params, store, max_batch=n, clock=serve.VirtualClock(),
        continuous=continuous,
        resilience=ResiliencePolicy(split_retry=split) if chaos else None)
    eng.submit(*[serve.Request(rid=i, seed=100 + i, policy="static2",
                               label=i, arrival=0.0) for i in range(n)])
    eng.run_until_drained()
    return eng


@pytest.mark.parametrize("split", [True, False])
def test_real_nan_row_served_healthy_row_bit_identical(split):
    eng, ref = _static_engine(True, split=split), _static_engine(False)
    assert eng.outcome(0)[0] == "done" and eng.outcome(1)[0] == "done"
    assert eng.metrics.fault_kinds == {faults.NAN_LATENT: 1}
    assert eng.metrics.row_retries == int(split)
    np.testing.assert_array_equal(eng.results[0], ref.results[0])
    assert eng.records[-1].group == FALLBACK_ENTRY
    assert np.isfinite(eng.results[1]).all()
    assert eng.health_reads > 0 and eng.executor.host_sync_count == 0


def test_continuous_split_retry_survivors_equal_their_solo_generate():
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    eng = _static_engine(True, continuous=True, n=4)
    assert sorted(eng.results) == [0, 1, 2, 3]
    assert eng.metrics.row_retries == 1
    split = [r for r in eng.records
             if any("split_retry@" in t for t in r.lineage)]
    assert {rid for r in split for rid in r.rids} == {0, 2, 3}
    _, params = smoke_params()
    _, cfg = smoke_cfgs()
    pipe = DiffusionPipeline(cfg, solvers.ddim(STEPS), "static:n=2",
                             cfg_scale=1.5, device="cpu")
    for rid in (0, 2, 3):
        x = pipe.generate(params, serve.batch_generator([100 + rid]), 1,
                          label=torch.tensor([rid]))
        np.testing.assert_array_equal(eng.results[rid], x[0].numpy())


@pytest.fixture(scope="module")
def adaptive_artifact(tmp_path_factory):
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    _, cfg = smoke_cfgs()
    _, params = smoke_params()
    calib = DiffusionPipeline(
        cfg, solvers.ddim(STEPS),
        "adaptive:base=smoothcache(alpha=0.5),tau=0.3", cfg_scale=1.5,
        device="cpu")
    calib.calibrate(params, torch.Generator().manual_seed(1), 2,
                    cond_args={"label": torch.zeros(2, dtype=torch.int64)})
    return calib.save_artifact(
        str(tmp_path_factory.mktemp("res") / "adaptive.cache.json"))


def test_real_fused_sentinels_detect_with_zero_host_syncs(adaptive_artifact):
    from repro_torch.core import solvers
    _, params = smoke_params()
    inner = _executor()
    store = serve.ArtifactStore(inner.cfg, solvers.ddim(STEPS),
                                cfg_scale=1.5)
    store.add_artifact("adaptive", adaptive_artifact)
    plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=0,
                                          chunk=1)})
    ex = ChaosExecutor(inner, plan, mutate_latent=True, mark_flags=False)
    eng = serve.ServeEngine(ex, params, store, max_batch=2, adaptive_chunk=2,
                            clock=serve.VirtualClock(),
                            resilience=ResiliencePolicy())
    eng.submit(serve.Request(rid=0, seed=100, policy="adaptive", label=0))
    eng.run_until_drained()
    assert eng.outcome(0)[0] == "done"
    assert eng.metrics.fault_kinds.get(faults.NAN_LATENT, 0) >= 1
    assert eng.metrics.degraded == 1
    assert eng.records[-1].group == f"{DEGRADED_PREFIX}adaptive/tau0"
    assert inner.host_sync_count == 0
    assert inner.compiled_variant_count("fused") >= 2     # τ > 0 and τ = 0
    assert inner.compiled_variant_count("sigstep") == 0


def test_fused_equals_host_loop_with_a_poisoned_row(adaptive_artifact):
    """One row poisoned after step 2 in both adaptive paths: the same
    decisions (the AND over rows), the same health flags, the healthy
    row bitwise, the poisoned row NaN in the same places."""
    _, params = smoke_params()
    ex = _executor()
    art = CacheArtifact.load(adaptive_artifact)
    from repro_torch.cache import registry
    from repro_torch.core import calibration
    pol = registry.from_config(art.policy)
    kw = dict(schedule=art.schedule, tau=pol.tau, k_max=pol.k_max,
              proxy_map=calibration.ProxyMap.from_jsonable(
                  art.adaptive["proxy_map"]),
              label=torch.tensor([3, 7]))
    gen = lambda: torch.Generator().manual_seed(5)     # noqa: E731
    rf = ex.start_adaptive_fused_run(params, gen(), 2, **kw)
    rh = ex.start_adaptive_run(params, gen(), 2, **kw)
    rf = ex.advance_adaptive_fused(params, rf, n_steps=2)
    for _ in range(2):
        rh = ex.advance_adaptive_run(params, rh)
    syncs = ex.host_sync_count
    rf = ex.advance_adaptive_fused(params, _poison(rf, 1))
    assert ex.host_sync_count == syncs
    rh = _poison(rh, 1)
    while not rh.done:
        rh = ex.advance_adaptive_run(params, rh)
    assert rf.decisions == rh.decisions
    assert rf.healthy.tolist() == rh.healthy.tolist() == [True, False]
    assert torch.equal(rf.x[0], rh.x[0])
    assert torch.equal(torch.isnan(rf.x), torch.isnan(rh.x))
    fin = torch.isfinite(rf.x[1])
    assert torch.equal(rf.x[1][fin], rh.x[1][fin])
