"""The port's serving stack (``repro_torch.serve``) against the JAX
package's ``repro.serve``.

* The engine-level tests of ``tests/test_serve.py`` that apply to the
  port, on the same numpy fake executor (it charges a virtual clock per
  computed layer evaluation, so scheduling becomes exact assertions):
  buckets, batching window, priority, arrivals, policy separation,
  round-robin, interleave vs fcfs, adaptive routing, eager escape hatch,
  rejects, store validation and hot swap, metrics, budget.
* Parity: one request trace on a virtual clock through the JAX engine and
  the port's engine gives equal ``BatchRecord``s and report counters.
* End to end on the smoke DiT (CPU): a mixed static + adaptive queue
  drains within the program budget (adaptive entries through the fused
  path, with no decision sync), and every served latent equals a
  ``DiffusionPipeline.generate`` replay of its batch, bitwise.
* An admission controller, a resilience policy, telemetry and the
  durability arguments (``journal=``, ``snapshot_dir=``) are accepted and
  serve the plain engine's records; ``recover()`` without a journal
  returns the JAX engine's empty summary; a traced drain exports a valid
  Chrome trace.
"""
import json
import os

import numpy as np
import pytest
import torch

import test_durable as jd                    # the JAX snapshot seam
import test_serve as jt                      # the JAX engine's fakes
from _torch_helpers import _numpy_params, smoke_cfgs, smoke_params
from repro import serve as jserve, slo as jslo
from repro_torch import serve, slo
from repro_torch.cache import registry
from repro_torch.cache.artifact import CacheArtifact
from repro_torch.durable import JournalState
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.resilience import ResiliencePolicy, faults
from repro_torch.serve.batcher import bucket_for, bucket_sizes
from repro_torch.serve.metrics import percentile


class FakeExecutor(jt.FakeExecutor):
    """``tests/test_serve.py``'s fake, placed on the CPU device (the port's
    engine builds label tensors on the executor's device)."""
    device = torch.device("cpu")


def port_artifact(art):
    """The JAX fakes' artifact, read by the port (the JSON is shared)."""
    return CacheArtifact.from_json(art.to_json())


def make_store(num_steps=8, **entries):
    store = serve.ArtifactStore(jt.FakeCfg(), jt.FakeSolver(num_steps))
    for name, spec in entries.items():
        store.add_policy(name, spec)
    return store


def make_engine(num_steps=8, store=None, **kw):
    clock = serve.VirtualClock()
    store = store if store is not None else make_store(
        num_steps, no_cache="none", static2="static:n=2")
    kw.setdefault("max_batch", 4)
    eng = serve.ServeEngine(FakeExecutor(clock), params=None, store=store,
                            clock=clock, **kw)
    return eng, clock


def req(rid, policy, arrival=0.0, priority=0, seed=None, label=None,
        deadline=None, max_tau=None, slo_mod=slo, serve_mod=serve):
    s = None
    if deadline is not None or max_tau is not None:
        s = slo_mod.SLO(deadline=deadline, max_tau=max_tau)
    return serve_mod.Request(rid=rid, seed=rid if seed is None else seed,
                             policy=policy, label=label, priority=priority,
                             arrival=arrival, slo=s)


# ---------------------------------------------------------------------------
# Buckets, batch formation
# ---------------------------------------------------------------------------

def test_bucket_for_largest_power_of_two():
    assert [bucket_for(n, 8) for n in (1, 2, 3, 4, 5, 7, 8, 9, 100)] \
        == [1, 2, 2, 4, 4, 4, 8, 8, 8]
    with pytest.raises(ValueError):
        bucket_for(0, 8)


def test_bucket_sizes_and_power_of_two_max_batch():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(1) == (1,)
    with pytest.raises(ValueError, match="power of two"):
        make_engine(max_batch=6)


def test_tail_splits_into_power_of_two_buckets():
    eng, _ = make_engine(max_batch=4)
    eng.submit(*[req(i, "static2") for i in range(7)])
    eng.run_until_drained()
    assert sorted(r.bucket for r in eng.records) == [1, 2, 4]
    assert sum(r.bucket for r in eng.records) == 7
    assert sorted(eng.results) == list(range(7))


def test_result_rows_route_to_the_right_request():
    eng, _ = make_engine(max_batch=4)
    eng.submit(*[req(i, "static2") for i in range(6)])
    res = eng.run_until_drained()
    for rec in eng.records:
        for j, rid in enumerate(rec.rids):
            assert res[rid][0] == j        # the fake writes the row index


def test_batching_window_holds_partial_buckets():
    eng, _ = make_engine(max_batch=4, max_wait=5.0)
    eng.submit(req(0, "static2", arrival=0.0),
               req(1, "static2", arrival=1.0),
               req(2, "static2", arrival=2.0))
    eng.run_until_drained()
    assert [r.bucket for r in eng.records] == [2, 1]
    assert eng.records[0].formed_at == pytest.approx(5.0)
    assert eng.records[0].rids == (0, 1)


def test_batching_window_expiry_is_roundoff_safe():
    a, w = 9.3665445913662, 0.2
    assert (a + w) - a < w          # the roundoff premise
    eng, _ = make_engine(max_batch=4, max_wait=w)
    eng.submit(req(0, "static2", arrival=a))
    eng.run_until_drained()
    assert sorted(eng.results) == [0]
    assert eng.records[0].formed_at == pytest.approx(a + w)


def test_full_bucket_forms_immediately_despite_window():
    eng, _ = make_engine(max_batch=4, max_wait=100.0)
    eng.submit(*[req(i, "static2", arrival=0.0) for i in range(4)])
    eng.run_until_drained()
    assert [r.bucket for r in eng.records] == [4]
    assert eng.records[0].formed_at == pytest.approx(0.0)


def test_priority_beats_arrival_within_group():
    eng, _ = make_engine(max_batch=2, max_wait=0.0, max_inflight=1)
    eng.submit(req(0, "static2"), req(1, "static2"),
               req(2, "static2", priority=5))
    eng.run_until_drained()
    assert 2 in eng.records[0].rids


def test_arrivals_gate_admission():
    eng, _ = make_engine(max_batch=4)
    eng.submit(req(0, "static2", arrival=0.0),
               req(1, "static2", arrival=50.0))
    eng.run_until_drained()
    assert [r.bucket for r in eng.records] == [1, 1]
    assert eng.records[1].formed_at >= 50.0


# ---------------------------------------------------------------------------
# Grouping, scheduling
# ---------------------------------------------------------------------------

def test_policies_never_share_a_batch():
    eng, _ = make_engine(max_batch=4)
    eng.submit(*[req(i, "static2" if i % 2 else "no_cache")
                 for i in range(8)])
    eng.run_until_drained()
    for rec in eng.records:
        assert all(rid % 2 == (rec.group == "static2") for rid in rec.rids)
    by_group = {}
    for rec in eng.records:
        by_group[rec.group] = by_group.get(rec.group, 0) + rec.bucket
    assert by_group == {"no_cache": 4, "static2": 4}


def test_round_robin_across_groups():
    eng, _ = make_engine(max_batch=2, max_inflight=1)
    eng.submit(*[req(i, "no_cache") for i in range(4)],
               *[req(10 + i, "static2") for i in range(4)])
    eng.run_until_drained()
    assert [r.group for r in eng.records] == [
        "no_cache", "static2", "no_cache", "static2"]


def test_interleave_avoids_convoy_fcfs_does_not():
    done = {}
    for name in ("interleave", "fcfs"):
        store = make_store(16, longjob="static:n=2", cached="static:n=8")
        eng, _ = make_engine(num_steps=16, store=store, max_batch=2,
                             max_inflight=2, scheduler=name)
        eng.submit(req(0, "longjob", arrival=0.0),
                   req(1, "cached", arrival=0.5))
        eng.run_until_drained()
        done[name] = {rec.group: rec.finished_at for rec in eng.records}
    assert done["fcfs"]["cached"] > done["fcfs"]["longjob"]
    assert done["interleave"]["cached"] < done["interleave"]["longjob"]
    assert done["interleave"]["cached"] < done["fcfs"]["cached"]


def _drain_two(scheduler):
    store = make_store(16, full="static:n=2")
    eng, _ = make_engine(num_steps=16, store=store, max_batch=1,
                         max_inflight=2, scheduler=scheduler)
    eng.submit(req(0, "full"), req(1, "full", deadline=10.0))
    eng.run_until_drained()
    return {rec.rids[0]: rec.finished_at for rec in eng.records}


def test_edf_prioritizes_deadline_batch_over_round_robin():
    edf, fair = _drain_two("edf"), _drain_two("interleave")
    assert max(edf.values()) == pytest.approx(max(fair.values()))
    assert edf[1] < edf[0] and edf[1] <= fair[1] - 1.0


def test_unknown_and_unported_schedulers():
    with pytest.raises(ValueError, match="scheduler"):
        make_engine(scheduler="bogus")
    # as in the JAX package: the elastic policy needs a constructed
    # controller, so its bare string is refused
    with pytest.raises(ValueError, match="controller"):
        make_engine(scheduler="elastic")
    with pytest.raises(ValueError, match="controller"):
        jt.make_engine(scheduler="elastic")
    eng, _ = make_engine(scheduler=slo.EDFPolicy())
    assert eng.scheduler == "edf"
    eng, _ = make_engine(scheduler=slo.ElasticPolicy(
        slo.ElasticTauController(2, target_p95_wait_s=1.0)))
    assert eng.scheduler == "elastic"


def test_adaptive_entries_route_through_adaptive_runs():
    store = make_store(8, static2="static:n=2")
    store.add_artifact("adaptive", port_artifact(jt._adaptive_artifact(8)))
    eng, _ = make_engine(store=store, max_batch=2)
    eng.submit(req(0, "adaptive"), req(1, "adaptive"), req(2, "static2"))
    eng.run_until_drained()
    rec = {r.group: r for r in eng.records}
    assert len(rec["adaptive"].decisions) == 8
    assert rec["static2"].decisions is None
    sch = store.get("adaptive").schedule
    skipped = sum(int(v[s]) for v in sch.skip.values()
                  for s in range(sch.num_steps))
    assert rec["adaptive"].compute_fraction == pytest.approx(
        1.0 - skipped / (8 * 2))
    # per-step "sigstep" variants, never more than the pool per bucket
    n = eng.executor.compiled_variant_count("sigstep")
    assert 0 < n <= len(store.get("adaptive").pool())
    rep = eng.report()
    assert rep["compiles"]["model_variants"] <= rep["program_budget"]


def test_program_budget_prices_adaptive_at_its_pool():
    store = make_store(8, static2="static:n=2")
    store.add_artifact("adaptive", port_artifact(jt._adaptive_artifact(8)))
    eng, _ = make_engine(store=store, max_batch=4)
    static_sigs = store.get("static2").plan.num_unique_signatures
    ever = [t for t, v in store.get("adaptive").schedule.skip.items()
            if v.any()]
    assert eng.program_budget() == len(bucket_sizes(4)) * (
        static_sigs + 2 ** len(ever))


def test_eager_escape_hatch():
    eng, _ = make_engine(max_batch=2, eager=True)
    eng.submit(req(0, "static2"), req(1, "static2"))
    eng.run_until_drained()
    assert eng.executor.compiled_variant_count("eager") == 1
    assert eng.executor.compiled_variant_count("seg") == 0
    assert sorted(eng.results) == [0, 1]


def test_unknown_policy_rejected_at_submit():
    eng, _ = make_engine()
    eng.submit(req(0, "typo"))
    assert eng.outcome(0) == ("shed", "no_entry")
    assert eng.metrics.rejects == {"no_entry": 1}
    assert eng.metrics.shed_reasons.get("no_entry") == 1
    assert len(eng.queue) == 0
    eng.run_until_drained()
    with pytest.raises(KeyError):
        eng.outcome(99)


def test_duplicate_rid_rejected_even_while_pending():
    eng, _ = make_engine()
    eng.submit(req(0, "static2", arrival=100.0))
    eng.submit(req(0, "static2"))
    eng.submit(req(1, "static2"), req(1, "static2"))
    assert eng.metrics.rejects == {"duplicate_rid": 2}
    assert eng.outcome(0) == ("pending", None)
    assert len(eng.queue) == 2
    eng.run_until_drained()
    assert sorted(eng.results) == [0, 1]


def test_batch_generator_distinguishes_high_bit_seeds():
    draw = lambda seeds: torch.randn(  # noqa: E731
        8, generator=serve.batch_generator(seeds))
    assert serve.batch_seed([5]) != serve.batch_seed([2 ** 31 + 5])
    assert not torch.equal(draw([5]), draw([2 ** 31 + 5]))
    # order-sensitive (row order is part of the batch identity), and
    # the length enters the fold
    assert not torch.equal(draw([1, 2]), draw([2, 1]))
    assert serve.batch_seed([0]) != serve.batch_seed([0, 0])
    # deterministic: a fresh generator replays the same bits
    assert torch.equal(draw([7, 9]), draw([7, 9]))
    assert serve.batch_seed([2 ** 32 + 3]) == serve.batch_seed([3])


def test_quality_floor_shed_and_ladder_rung_clamp():
    ladder = "adaptive:base=static(n=2),tau=[0.0,0.05,0.2],k_max=1"
    store = make_store(8)
    store.add_ladder("gen", port_artifact(jt._adaptive_artifact(8)),
                     spec=ladder)
    store.set_rung("gen", 2)
    eng, _ = make_engine(store=store, max_batch=1)
    eng.submit(req(0, "gen"), req(1, "gen", max_tau=0.05),
               req(2, "gen", max_tau=0.0))
    eng.run_until_drained()
    assert {r.rids[0]: r.tau for r in eng.records} == {0: 0.2, 1: 0.05,
                                                       2: 0.0}
    store2 = make_store(8)
    store2.add_ladder("gen", port_artifact(jt._adaptive_artifact(8)),
                      spec=ladder.replace("0.0,", ""))
    eng2, _ = make_engine(store=store2, max_batch=1)
    eng2.submit(req(0, "gen", max_tau=0.01), req(1, "gen"))
    assert sorted(eng2.run_until_drained()) == [1]
    assert eng2.outcome(0) == ("shed", "quality_floor")
    rep = eng2.report()
    assert rep["shed"] == {"total": 1, "reasons": {"quality_floor": 1}}
    assert rep["slo"]["goodput_fraction"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# Store: validation, ladders, hot swap
# ---------------------------------------------------------------------------

def test_store_rejects_calibration_needing_policy():
    with pytest.raises(ValueError, match="never calibrates"):
        make_store().add_policy("smooth", "smoothcache:alpha=0.18")


def test_store_validates_artifact_against_deployment():
    store = make_store()
    with pytest.raises(ValueError, match="calibrated on"):
        store.add_artifact(
            "bad", port_artifact(jt._static_artifact(arch="other-arch")))
    with pytest.raises(ValueError, match="solver"):
        store.add_artifact("bad",
                           port_artifact(jt._static_artifact(num_steps=99)))
    store.add_artifact("forced",
                       port_artifact(jt._static_artifact(arch="other-arch")),
                       strict=False)
    art = jt._adaptive_artifact()
    art.adaptive.pop("proxy_map")
    with pytest.raises(ValueError, match="proxy_map"):
        store.add_artifact("adaptive", port_artifact(art))


def test_store_ladders_and_at_tau():
    art = port_artifact(jt._adaptive_artifact(8, tau=0.1))
    re = art.at_tau(0.3)
    assert re.adaptive["tau"] == 0.3 and art.adaptive["tau"] == 0.1
    with pytest.raises(ValueError, match="ascending"):
        registry.expand_ladder("adaptive:tau=[0.2,0.05]")
    with pytest.raises(ValueError, match="expand_ladder"):
        registry.get("adaptive:tau=[0.0,0.1]")
    store = make_store(8)
    lad = store.add_ladder("gen", art, taus=[0.0, 0.1, 0.3])
    assert lad.taus == (0.0, 0.1, 0.3) and store.ladders() == ["gen"]
    assert set(store.names()) == {"gen/tau=0", "gen/tau=0.1", "gen/tau=0.3"}
    assert store.get("gen").tau == 0.0
    assert store.set_rung("gen", 99).tau == 0.3          # clamped
    assert lad.rung_for_cap(0.2) == 1 and lad.rung_for_cap(-1.0) is None
    with pytest.raises(ValueError, match="exists"):
        store.add_ladder("gen", art, taus=[0.0])


def test_hot_swap_bumps_version_and_serves_new_schedule(tmp_path):
    path = str(tmp_path / "entry.cache.json")
    with open(path, "w") as f:
        f.write(jt._static_artifact(n=2).to_json())
    store = make_store()
    e1 = store.add_artifact("entry", path)
    eng, _ = make_engine(store=store, max_batch=2)
    eng.submit(req(0, "entry"), req(1, "entry"))
    eng.run_until_drained()
    assert eng.records[-1].version == 1
    with open(path, "w") as f:
        f.write(jt._static_artifact(n=4).to_json())
    e2 = store.reload("entry")
    assert e2.version == 2
    assert e2.schedule.fingerprint() != e1.schedule.fingerprint()
    eng.submit(req(2, "entry"), req(3, "entry"))
    eng.run_until_drained()
    assert eng.records[-1].version == 2 and len(eng.results) == 4


def test_hot_swap_of_invalid_artifact_keeps_old_entry(tmp_path):
    path = str(tmp_path / "entry.cache.json")
    with open(path, "w") as f:
        f.write(jt._static_artifact(n=2).to_json())
    store = make_store()
    store.add_artifact("entry", path)
    with open(path, "w") as f:
        f.write(jt._static_artifact(num_steps=13).to_json())
    with pytest.raises(ValueError, match="solver"):
        store.reload("entry")
    assert store.get("entry").version == 1
    assert store.get("entry").schedule.num_steps == 8
    assert "hot-reload rejected" in store.health.quarantine_reason("entry")


def test_reload_keeps_policy_override(tmp_path):
    path = str(tmp_path / "entry.cache.json")
    with open(path, "w") as f:
        f.write(jt._adaptive_artifact().to_json())
    store = make_store()
    e1 = store.add_artifact("entry", path, policy="static:n=2")
    e2 = store.reload("entry")
    assert not e1.adaptive and not e2.adaptive and e2.version == 2
    assert e2.policy.spec() == e1.policy.spec()
    with pytest.raises(ValueError, match="path"):
        make_store(static2="static:n=2").reload("static2")


def test_unhealthy_entry_is_shed():
    store = make_store(static2="static:n=2")
    store.health.fault_threshold = 1
    assert store.report_fault("static2", faults.NAN_LATENT)
    eng, _ = make_engine(store=store)
    eng.submit(req(0, "static2", max_tau=1.0))
    eng.run_until_drained()
    assert eng.outcome(0) == ("shed", "unhealthy_entry")
    fault = faults.BatchFault(faults.NAN_LATENT, (True, False))
    assert fault.poisoned_rows == (1,)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_percentile_interpolates():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0 and percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == pytest.approx(2.5)
    assert percentile([7.0], 95) == 7.0
    for bad in ([], [1.0, float("nan")]):
        with pytest.raises(ValueError):
            percentile(bad, 50)


def test_queue_wait_and_service_reported_separately():
    eng, _ = make_engine(max_batch=1, max_inflight=1)
    eng.submit(req(0, "no_cache"), req(1, "no_cache"))
    eng.run_until_drained()
    rep = eng.report()
    assert rep["requests"] == 2
    assert rep["service_s"]["p50"] == pytest.approx(8.0)
    assert rep["queue_wait_s"]["max"] == pytest.approx(8.0)
    assert rep["queue_wait_s"]["p50"] == pytest.approx(4.0)
    assert rep["makespan_s"] == pytest.approx(16.0)
    assert rep["throughput_rps"] == pytest.approx(2 / 16.0)
    json.dumps(rep)


def test_report_includes_variant_counts_and_budget():
    eng, _ = make_engine(max_batch=4)
    eng.submit(*[req(i, "static2") for i in range(6)])
    eng.run_until_drained()
    rep = eng.report()
    assert 0 < rep["compiles"]["model_variants"] <= rep["program_budget"]
    assert "xla_programs" not in rep["compiles"]
    assert rep["buckets"] == {"2": 1, "4": 1}
    # the per-step cost model is exported as registry gauges
    assert eng.registry.gauge("slo.step_cost_s") is not None


def test_realized_compute_fraction_static():
    eng, _ = make_engine(max_batch=2)
    eng.submit(req(0, "static2"), req(1, "static2"))
    eng.run_until_drained()
    sch = eng.store.get("static2").schedule
    expect = float(np.mean([1.0 - np.mean(v) for v in sch.skip.values()]))
    assert eng.report()["compute_fraction"] == pytest.approx(expect)


def test_backlog_estimate_prices_queued_and_inflight_steps():
    eng, _ = make_engine(max_batch=2, max_inflight=1)
    eng.submit(*[req(i, "static2") for i in range(4)])
    # 4 queued requests × 8 steps, amortized over batches of 2, at the
    # cost model's seed step cost (0.1 s) before any batch finished
    assert eng._backlog_seconds(0.0) == pytest.approx(0.1 * 4 * 8 / 2)
    eng.step()                                 # one segment advanced
    left = slo.remaining_steps(eng._inflight[0].rs)
    assert 0 < left < 8
    assert eng._backlog_seconds(eng.clock.now()) == pytest.approx(
        0.1 * (2 * 8 / 2 + left))
    eng.run_until_drained()
    assert eng._backlog_seconds(eng.clock.now()) == 0.0


def test_poisson_arrivals_reproducible_and_increasing():
    a = serve.poisson_arrivals(2.0, 50, np.random.RandomState(3), start=1.0)
    b = serve.poisson_arrivals(2.0, 50, np.random.RandomState(3), start=1.0)
    assert a == b and all(x < y for x, y in zip(a, a[1:])) and a[0] > 1.0
    assert 0.2 < float(np.mean(np.diff([1.0] + a))) < 1.0
    assert a == jserve.poisson_arrivals(2.0, 50, np.random.RandomState(3),
                                        start=1.0)
    with pytest.raises(ValueError):
        serve.poisson_arrivals(0.0, 5, np.random.RandomState(3))


# ---------------------------------------------------------------------------
# Parity: the same trace through the JAX engine and the port's
# ---------------------------------------------------------------------------

# (rid, policy, arrival, priority, label, deadline, max_tau)
TRACE = [(0, "no_cache", 0.0, 0, 1, None, None),
         (1, "static2", 0.0, 0, None, None, None),
         (2, "adaptive", 0.0, 0, 3, None, None),
         (3, "static2", 0.5, 2, 4, 30.0, None),
         (4, "adaptive", 1.0, 0, 5, None, None),
         (5, "no_cache", 1.5, 0, None, 12.0, None),
         (6, "typo", 2.0, 0, 0, None, None),
         (7, "static2", 2.0, 0, 6, None, 0.0),
         (8, "adaptive", 2.5, 1, 7, None, 0.05),
         (9, "static2", 3.0, 0, 8, None, None),
         (10, "adaptive", 9.0, 0, 9, 40.0, None),
         (11, "no_cache", 9.0, 0, 2, None, None),
         (3, "static2", 9.5, 0, 1, None, None)]          # duplicate rid


def _drain(pkg, slo_mod, artifact, fake, scheduler, **kw):
    clock = pkg.VirtualClock()
    store = pkg.ArtifactStore(jt.FakeCfg(), jt.FakeSolver(8))
    store.add_policy("no_cache", "none")
    store.add_policy("static2", "static:n=2")
    store.add_artifact("adaptive", artifact)
    eng = pkg.ServeEngine(fake(clock), params=None, store=store, clock=clock,
                          scheduler=scheduler, **kw)
    for rid, pol, arr, prio, lab, dl, cap in TRACE:
        eng.submit(req(rid, pol, arr, prio, seed=1000 + rid, label=lab,
                       deadline=dl, max_tau=cap, slo_mod=slo_mod,
                       serve_mod=pkg))
    eng.run_until_drained()
    return eng


RECORD_FIELDS = ("group", "version", "bucket", "rids", "seeds", "labels",
                 "num_steps", "compute_fraction", "formed_at", "finished_at",
                 "decisions", "tau", "quality_cost")
REPORT_KEYS = ("requests", "batches", "buckets", "per_group_requests",
               "compute_fraction", "shed", "slo", "realized_tau",
               "predicted_quality_cost", "makespan_s", "throughput_rps",
               "queue_wait_s", "service_s", "program_budget")


@pytest.mark.parametrize("scheduler,kw", [
    ("interleave", dict(max_batch=4)),
    ("fcfs", dict(max_batch=2, max_wait=1.0)),
    ("edf", dict(max_batch=4, max_inflight=3, adaptive_chunk=3)),
    ("interleave", dict(max_batch=2, eager=True))])
def test_engine_matches_reference_on_one_trace(scheduler, kw):
    art = jt._adaptive_artifact(8)
    ref = _drain(jserve, jslo, art, jt.FakeExecutor, scheduler, **kw)
    got = _drain(serve, slo, port_artifact(art), FakeExecutor, scheduler,
                 **kw)
    assert len(got.records) == len(ref.records) > 0
    for r, g in zip(ref.records, got.records):
        for f in RECORD_FIELDS:
            assert getattr(g, f) == getattr(r, f), f
    assert got.shed == ref.shed
    assert sorted(got.results) == sorted(ref.results)
    for rid, row in ref.results.items():
        np.testing.assert_array_equal(got.results[rid], row)
    rj, rt = ref.report(), got.report()
    for k in REPORT_KEYS:
        assert rt.get(k) == rj.get(k), k
    assert rt["faults"] == rj["faults"]
    cj, ct = dict(rj["compiles"]), dict(rt["compiles"])
    assert ct.pop("model_variants") == cj.pop("xla_programs")
    assert ct == cj
    assert got.registry.snapshot()["gauges"] == \
        ref.registry.snapshot()["gauges"]


# ---------------------------------------------------------------------------
# Durability, resilience and telemetry arguments; tracing
# ---------------------------------------------------------------------------

class ExportFakeExecutor(jd.DurableFakeExecutor):
    """``tests/test_durable.py``'s fake with the snapshot seam, on the
    CPU device."""
    device = torch.device("cpu")


@pytest.mark.parametrize("kw", [
    dict(journal="journal.jsonl"),
    dict(journal="journal.jsonl", snapshot_dir="snaps")])
def test_durable_arguments_serve_like_a_plain_engine(kw, tmp_path):
    """An engine with a journal (and snapshots) serves a drain with the
    same records as a plain engine, journals every submission and finish,
    and leaves no snapshot behind."""
    kw = {k: str(tmp_path / v) for k, v in kw.items()}
    clock = serve.VirtualClock()
    eng = serve.ServeEngine(
        ExportFakeExecutor(clock), None,
        make_store(8, no_cache="none", static2="static:n=2"), clock=clock,
        max_batch=4, **kw)
    eng.submit(*[req(i, "static2") for i in range(3)])
    assert sorted(eng.run_until_drained()) == [0, 1, 2]
    plain, _ = make_engine()
    plain.submit(*[req(i, "static2") for i in range(3)])
    plain.run_until_drained()
    assert [(r.group, r.rids, r.finished_at) for r in eng.records] \
        == [(r.group, r.rids, r.finished_at) for r in plain.records]
    st = JournalState.replay(kw["journal"])
    assert sorted(st.submitted) == sorted(st.done) == [0, 1, 2]
    if "snapshot_dir" in kw:
        assert eng.metrics.checkpoints > 0
        assert eng.metrics.checkpoint_errors == 0
        assert os.listdir(kw["snapshot_dir"]) == []


@pytest.mark.parametrize("kw", [
    dict(resilience=ResiliencePolicy()),
    dict(resilience=ResiliencePolicy(entry_fault_threshold=3),
         admission=slo.AdmissionController(max_backlog_s=100.0)),
    dict(telemetry=True)])
def test_resilience_and_telemetry_arguments_accepted(kw):
    """Both serve a drain, with the same records as a plain engine; a
    threshold lands in the store's health registry; telemetry gives every
    served request a report."""
    eng, _ = make_engine(**kw)
    assert eng.resilience is kw.get("resilience")
    assert eng.telemetry is bool(kw.get("telemetry"))
    pol = kw.get("resilience")
    if pol is not None and pol.entry_fault_threshold is not None:
        assert eng.store.health.fault_threshold == 3
    eng.submit(*[req(i, "static2") for i in range(3)])
    assert sorted(eng.run_until_drained()) == [0, 1, 2]
    plain, _ = make_engine()
    plain.submit(*[req(i, "static2") for i in range(3)])
    plain.run_until_drained()
    assert [r.rids for r in eng.records] == [r.rids for r in plain.records]
    assert eng.metrics.faults_total == 0
    assert sorted(eng.cache_reports) == ([0, 1, 2] if eng.telemetry
                                         else [])


def test_admission_controller_accepted():
    adm = slo.AdmissionController(max_backlog_s=1.0)
    eng, _ = make_engine(admission=adm)
    assert eng.admission is adm
    eng.submit(*[req(i, "static2") for i in range(3)])
    assert sorted(eng.run_until_drained()) == [0, 1, 2]
    assert eng.report()["deferrals"] == eng.metrics.deferrals


def test_recover_without_a_journal_returns_the_empty_summary():
    eng, _ = make_engine()
    jeng = jt.make_engine()[0]
    assert eng.recover() == jeng.recover() == {
        "done": 0, "shed": 0, "restored_runs": 0, "restored_requests": 0,
        "replayed": 0, "refused": [], "stale": 0, "journal_skipped": 0}
    assert eng.report()["durable"] == jeng.report()["durable"]


def test_traced_drain_exports_a_valid_chrome_trace(tmp_path):
    store = make_store(8, static2="static:n=2")
    store.add_artifact("adaptive", port_artifact(jt._adaptive_artifact(8)))
    clock = serve.VirtualClock()
    tracer = Tracer(clock)
    eng = serve.ServeEngine(FakeExecutor(clock), None, store, clock=clock,
                            max_batch=2, tracer=tracer)
    eng.submit(req(0, "adaptive"), req(1, "static2"), req(2, "static2"),
               req(3, "typo"), req(4, "adaptive", max_tau=0.0))
    eng.run_until_drained()
    assert not tracer.open_spans()
    path = tracer.save(str(tmp_path / "serve.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    n = validate_chrome_trace(trace)
    assert n == len(tracer)
    names = {ev["name"] for ev in trace["traceEvents"]}
    assert {"run", "advance", "form", "submit", "reject",
            "shed"} <= names
    # tracing changes nothing the engine decides
    plain, _ = make_engine(store=store, max_batch=2)
    plain.submit(req(0, "adaptive"), req(1, "static2"), req(2, "static2"),
                 req(3, "typo"), req(4, "adaptive", max_tau=0.0))
    plain.run_until_drained()
    assert [r.rids for r in plain.records] == [r.rids for r in eng.records]


# ---------------------------------------------------------------------------
# End to end on the smoke DiT: served ≡ generate, bitwise
# ---------------------------------------------------------------------------

def test_served_latents_bit_identical_to_generate(tmp_path):
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
    store.add_policy("static2", "static:n=2")
    store.add_artifact("adaptive", path)
    eng = serve.ServeEngine(ex, params, store, max_batch=2, max_inflight=2,
                            clock=serve.VirtualClock(), check=True,
                            adaptive_chunk=2)
    eng.submit(*[serve.Request(
        rid=i, seed=100 + i, policy="adaptive" if i % 2 else "static2",
        label=i % cfg.num_classes, arrival=0.0) for i in range(5)])
    res = eng.run_until_drained()
    assert sorted(res) == list(range(5))
    assert {r.group for r in eng.records} == {"static2", "adaptive"}
    rep = eng.report()
    assert 0 < rep["compiles"]["model_variants"] <= rep["program_budget"]
    # adaptive entries ride the fused path: no decision sync at all
    assert ex.compiled_variant_count("fused") > 0
    assert ex.compiled_variant_count("sigstep") == 0
    assert ex.host_sync_count == 0
    # the static entry rides the segment graphs: one per (signature,
    # batch) variant, reported by kind against the budget
    graphs = rep["compiles"]["graphs"]
    assert graphs["seg"] == ex.compiled_variant_count("seg") > 0
    assert graphs["fused"] == ex.compiled_variant_count("fused")
    assert 0 < graphs["total"] == ex.graph_count() <= rep["program_budget"]
    assert sum(g["replays"] for g in ex.segment_graphs()) == sum(
        r.num_steps for r in eng.records if r.group == "static2")

    static_pipe = DiffusionPipeline(cfg, solvers.ddim(steps), "static:n=2",
                                    cfg_scale=1.5, device="cpu")
    loop_pipe = DiffusionPipeline(cfg, solvers.ddim(steps), "static:n=2",
                                  cfg_scale=1.5, device="cpu", graphs=False)
    adaptive_pipe = DiffusionPipeline(cfg, solvers.ddim(steps), spec,
                                      cfg_scale=1.5, device="cpu")
    adaptive_pipe.load_artifact(path)
    for rec in eng.records:
        gen = serve.batch_generator(rec.seeds)
        lab = torch.tensor(rec.labels, dtype=torch.int64)
        if rec.group == "adaptive":
            x, dec = adaptive_pipe.generate(params, gen, rec.bucket,
                                            label=lab, return_decisions=True)
            assert dec == rec.decisions
        else:
            x = static_pipe.generate(params, gen, rec.bucket, label=lab)
            assert torch.equal(x, loop_pipe.generate(
                params, serve.batch_generator(rec.seeds), rec.bucket,
                label=lab))
        for j, rid in enumerate(rec.rids):
            np.testing.assert_array_equal(x[j].numpy(), res[rid])


def test_jax_and_port_stores_agree_on_entries(tmp_path):
    """The port's store reads the JAX package's artifact file and derives
    the same schedules, plans, pools and budgets."""
    art = jt._adaptive_artifact(8)
    path = str(tmp_path / "a.cache.json")
    with open(path, "w") as f:
        f.write(art.to_json())
    js = jserve.ArtifactStore(jt.FakeCfg(), jt.FakeSolver(8))
    ts = serve.ArtifactStore(jt.FakeCfg(), jt.FakeSolver(8))
    for st in (js, ts):
        st.add_artifact("adaptive", path)
        st.add_policy("static2", "static:n=2")
    for name in ("adaptive", "static2"):
        je, te = js.get(name), ts.get(name)
        assert te.schedule.to_json() == je.schedule.to_json()
        assert te.plan.to_json() == je.plan.to_json()
        assert te.pool_size() == je.pool_size()
        assert te.program_cost(fused=False) == je.program_cost(fused=False)
        assert te.predicted_quality_cost() == je.predicted_quality_cost()
    assert [s.live_in for s in ts.get("adaptive").pool()] == \
        [s.live_in for s in js.get("adaptive").pool()]


def test_serve_diffusion_cli_on_cpu(tmp_path, capsys):
    """The launcher's three scenarios at the smoke variant, on weights
    carried across from the JAX package's tree through an ``.npz``."""
    from repro_torch.convert import flatten_params, params_from_npz
    from repro_torch.launch import serve_diffusion
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(_numpy_params()))
    _, want = smoke_params()
    got = params_from_npz(npz, device="cpu")
    assert flatten_params(serve_diffusion.tree_map(
        lambda a: a.numpy(), got)).keys() == flatten_params(
        serve_diffusion.tree_map(lambda a: a.numpy(), want)).keys()
    assert torch.equal(got["backbone"]["stages"][0][0]["mixer"]["wq"],
                       want["backbone"]["stages"][0][0]["mixer"]["wq"])
    serve_diffusion.main(["--device", "cpu", "--requests", "4", "--batch",
                          "2", "--steps", "6", "--rate", "50",
                          "--max-wait", "0.01", "--params", npz,
                          "--artifact-dir", str(tmp_path / "art")])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "req/s" in ln]
    assert len(lines) == 3 and "mixed+adaptive" in lines[2]
    assert all("model variants" in ln for ln in lines)
