"""The port's durable serving (``repro_torch.durable``, the checkpoint IO
and the engine's journal / snapshot / recovery path) against the JAX
package's ``repro.durable``.

* Checkpoint IO: round trips with ``None`` leaves and bool / int32 / int64
  / f32 / bf16 tensors, the refusals of ``tests/test_durable.py`` (bad
  magic, truncated header, torn body, flipped body bits, a corrupt
  header), an atomic publish, and each package refusing the other's file.
* Journal: the same events give byte-identical files in both packages,
  each package replays the other's file to the same fold, torn tails are
  sealed, the fsync counts match.
* ``KillPlan``: the same schedule as ``repro.durable.KillPlan`` for seeds
  {0, 7, 1234} × rates {0.1, 0.3} over ticks 1–300, with overrides and
  ``max_kills``.
* ``SnapshotStore``: monotone ``seq`` across reopenings, the format and
  meta-checksum guards, one live file per serial; ``plan_hash`` and
  ``ServableEntry.provenance`` equal the JAX package's field by field.
* Engines on ``tests/test_durable.py``'s ``DurableFakeExecutor``
  (imported: keep that module importable): the reference's engine tests,
  and the seeded kill matrix through both engines — the same delivered
  rids, restarts, ticks, journal events and ``durable`` report section.
* The smoke DiT (CPU), torch against torch, bitwise: export → save →
  restore → import → finish equals the uninterrupted run for all three
  run kinds (τ / k_max drift refused); an engine restore with a static
  and a fused batch in flight on a fresh executor; a mid-join restore
  under ``continuous=True``; replay from the start after every snapshot
  is refused; the ``ChaosExecutor`` seams.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import test_durable as jd                    # the JAX durable fakes
from _torch_helpers import smoke_cfgs, smoke_params
from repro import durable as jdur, serve as jserve
from repro.checkpoint import io as jio
from repro.core import plan as jplan
from repro_torch import durable as tdur, serve
from repro_torch.checkpoint import CheckpointError, io as ckpt_io
from repro_torch.core import plan as plan_lib
from repro_torch.durable import (FORMAT, JournalState, KillPlan,
                                 RequestJournal, SnapshotError,
                                 SnapshotStore, crash, plan_hash, replay)
from repro_torch.resilience import ChaosExecutor, FaultPlan, FaultSpec, faults
from repro_torch.resilience.integrity import CHECKSUM_KEY
from test_torch_serve import port_artifact

# ---------------------------------------------------------------------------
# Checkpoint IO: refusals, not garbage
# ---------------------------------------------------------------------------


def _tree():
    return {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"a": torch.ones((1,), dtype=torch.int32),
                       "flags": torch.tensor([True, False, True]),
                       "gap": None},
            "pair": (torch.linspace(-2, 2, 5).to(torch.bfloat16), None),
            "ids": [torch.tensor(7, dtype=torch.int64),
                    torch.zeros((0, 4))]}


def test_checkpoint_roundtrip_with_nones_dtypes_and_meta(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.ckpt")
    ckpt_io.save(path, tree, {"kind": "unit", "step": 3})
    out, meta = ckpt_io.restore(path)
    assert meta == {"kind": "unit", "step": 3}
    for got, want in ((out["x"], tree["x"]),
                      (out["nested"]["a"], tree["nested"]["a"]),
                      (out["nested"]["flags"], tree["nested"]["flags"]),
                      (out["pair"][0], tree["pair"][0]),
                      (out["ids"][0], tree["ids"][0]),
                      (out["ids"][1], tree["ids"][1])):
        assert got.dtype == want.dtype and got.device.type == "cpu"
        assert got.shape == want.shape and torch.equal(got, want)
    assert out["nested"]["gap"] is None
    assert isinstance(out["pair"], tuple) and out["pair"][1] is None
    assert isinstance(out["ids"], list)
    # header-only read never touches the body
    assert ckpt_io.read_meta(path)["kind"] == "unit"


@pytest.mark.parametrize("mutilate,match", [
    (lambda b: b"NOTACKPT!!" + b[10:], "magic"),
    (lambda b: b[:12], "truncated"),
    (lambda b: b[:-5], "torn|truncated|declares"),
    (lambda b: b[:-1] + bytes([b[-1] ^ 0xFF]), "sha256|checksum"),
    (lambda b: b[:19] + b"\x00" + b[20:], "corrupt|malformed"),
])
def test_checkpoint_refuses_torn_and_tampered(tmp_path, mutilate, match):
    """Bad magic, truncated header, torn body, flipped body bits and a
    corrupt header all raise CheckpointError — never a short tensor."""
    path = str(tmp_path / "t.ckpt")
    ckpt_io.save(path, {"x": torch.arange(32, dtype=torch.float32)}, {})
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(mutilate(raw))
    with pytest.raises(CheckpointError, match=match):
        ckpt_io.restore(path)


def test_checkpoint_atomic_publish_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "t.ckpt")
    ckpt_io.save(path, {"x": torch.ones(4)}, {})
    assert os.listdir(tmp_path) == ["t.ckpt"]


def test_checkpoint_files_are_refused_across_packages(tmp_path):
    """Each package has its own magic: a file of one is refused by the
    other, never misread."""
    ours, theirs = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    ckpt_io.save(ours, {"x": torch.ones(4)}, {"k": 1})
    jio.save(theirs, {"x": np.ones(4, np.float32)}, {"k": 1})
    with pytest.raises(CheckpointError, match="magic"):
        ckpt_io.restore(theirs)
    with pytest.raises(jio.CheckpointError, match="magic"):
        jio.restore(ours)


def test_checkpoint_timings_and_invalid_dtype(tmp_path):
    path = str(tmp_path / "t.ckpt")
    timings = {}
    ckpt_io.save(path, {"x": torch.ones(4)}, {}, timings=timings)
    assert set(timings) == {"sync_s", "copy_s", "hash_s", "write_s"}
    assert all(v >= 0 for v in timings.values())
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw.replace(b'"float32"', b'"flo@t32"'))
    with pytest.raises(CheckpointError, match="dtype"):
        ckpt_io.restore(path)
    with pytest.raises(TypeError, match="not a tensor"):
        ckpt_io.save(path, {"x": np.ones(2)}, {})


# ---------------------------------------------------------------------------
# Write-ahead journal: the reference's bytes
# ---------------------------------------------------------------------------

def _write_events(mod, path):
    j = mod.RequestJournal(path)
    j.append_many([
        {"ev": "submit", "rid": 1, "seed": 1, "policy": "a",
         "arrival": 0.0},
        {"ev": "submit", "rid": "r2", "seed": 2, "policy": "a",
         "arrival": 0.5, "slo": {"deadline": 3.25, "max_tau": None,
                                 "cls": "strict"}},
        {"ev": "submit", "rid": 3, "seed": 3, "policy": "b",
         "arrival": 0.75, "label": 9}])
    j.append("launch", sync=False, serial=1, kind="plan", rids=[1, "r2"],
             t=1.0)
    j.append("checkpoint", sync=False, serial=1, snapshot="run-1.ckpt",
             step=2, rids=[1, "r2"], t=1.5)
    j.append("retry", sync=False, rid="r2", attempt=1, policy="fallback",
             level=1, t=2.0)
    j.append("finish", rids=[1], t=3.0)
    j.append("shed", rid=3, reason="quality_floor", t=3.5)
    j.close()
    return j


def test_journal_bytes_and_sync_counts_equal_the_reference(tmp_path):
    ours, theirs = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    jt, jj = _write_events(tdur, ours), _write_events(jdur, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert (jt.appended, jt.synced) == (jj.appended, jj.synced) == (8, 3)
    assert jt.sync_s >= 0.0


def _fold(st):
    return (st.submitted, st.done, st.shed, st.started, st.attempts,
            st.levels, st.checkpoints, st.events, st.skipped, st.pending())


def test_journal_replays_the_other_packages_file(tmp_path):
    ours, theirs = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    _write_events(tdur, ours)
    _write_events(jdur, theirs)
    assert replay(theirs) == jdur.replay(ours)
    assert _fold(JournalState.replay(theirs)) \
        == _fold(jdur.JournalState.replay(ours))
    st = JournalState.replay(theirs)
    assert st.pending() == {"r2": dict(st.submitted["r2"])}
    assert st.submitted["r2"]["policy"] == "fallback"
    assert st.done == {1: 3.0} and st.shed == {3: ("quality_floor", 3.5)}


def _torn_then_sealed(path, writer, sealer):
    j = writer.RequestJournal(path)
    j.append("submit", rid=1, seed=1, policy="p", arrival=0.0)
    j.close()
    with open(path, "ab") as f:                # the torn write
        f.write(b'deadbeef0000 {"ev": "fini')
    j2 = sealer.RequestJournal(path)
    assert j2.sealed_tail and j2.synced == 1
    j2.append("shed", rid=1, reason="late", t=2.0)
    j2.close()
    return open(path, "rb").read()


@pytest.mark.parametrize("sealer", ["torch", "jax"])
def test_journal_seals_torn_tail(tmp_path, sealer):
    """A crash mid-write leaves a half line; reopening (in either
    package) seals it so it fails its checksum at replay instead of
    merging with the next append — the same bytes as the JAX package
    writing and sealing alone."""
    path = str(tmp_path / "t.jsonl")
    raw = _torn_then_sealed(path, tdur, tdur if sealer == "torch" else jdur)
    assert raw == _torn_then_sealed(str(tmp_path / "j.jsonl"), jdur, jdur)
    events, skipped = replay(path)
    assert (events, skipped) == jdur.replay(path) and skipped == 1
    assert [e["ev"] for e in events] == ["submit", "shed"]
    st = JournalState.replay(path)
    assert st.skipped == 1 and st.shed[1] == ("late", 2.0)


def test_journal_append_many_validates_ev(tmp_path):
    j = RequestJournal(str(tmp_path / "j.jsonl"))
    with pytest.raises(ValueError, match="'ev'"):
        j.append_many([{"rid": 1}])
    j.append_many([])
    assert j.appended == 0 and j.synced == 0
    j.close()
    assert j.closed


# ---------------------------------------------------------------------------
# KillPlan: the reference's schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_kill_plan_equals_the_reference(seed, rate):
    a, b = KillPlan(seed=seed, kill_rate=rate), \
        jdur.KillPlan(seed=seed, kill_rate=rate)
    got = [a.should_kill(t) for t in range(1, 301)]
    assert got == [b.should_kill(t) for t in range(1, 301)]
    assert any(got) and a.killed == b.killed
    # memoized: asking again agrees
    assert [a.should_kill(t) for t in range(1, 301)] == got


def test_kill_plan_overrides_and_bounds_equal_the_reference():
    def run(mod):
        p = mod.KillPlan(seed=7, kill_rate=0.2, kills={4, 9}, max_kills=3)
        return [p.should_kill(t) for t in range(1, 60)], p.killed

    assert run(jdur) == run(tdur)
    seq, killed = run(jdur)
    assert seq[3] and seq[8] and killed == 3
    p = KillPlan(seed=0, kill_rate=0.0, kills={4}, max_kills=1)
    assert not p.should_kill(3)
    assert p.should_kill(4)
    assert not p.should_kill(4)                # max_kills exhausted
    with pytest.raises(ValueError, match="kill_rate"):
        KillPlan(kill_rate=1.5)


# ---------------------------------------------------------------------------
# SnapshotStore, plan hash, provenance
# ---------------------------------------------------------------------------

def test_snapshot_store_seq_survives_restart_and_format_guard(tmp_path):
    store = SnapshotStore(str(tmp_path))
    name, nbytes = store.save(0, {"x": torch.ones(2)}, {"rids": [1, 2]})
    assert name == "run-1.ckpt" and nbytes > 0
    arrays, meta = store.load(os.path.join(str(tmp_path), name))
    assert meta["format"] == FORMAT == "repro_torch.durable/1"
    assert meta["rids"] == [1, 2] and torch.equal(arrays["x"], torch.ones(2))
    assert set(store.timings) >= {"copy_s", "hash_s", "write_s"}
    store2 = SnapshotStore(str(tmp_path))
    name2, _ = store2.save(0, {}, {})
    assert name2 == "run-2.ckpt"
    for tag in ("something/else", jdur.FORMAT):
        alien = os.path.join(str(tmp_path), "run-9.ckpt")
        ckpt_io.save(alien, {}, {"format": tag})
        with pytest.raises(SnapshotError, match="format"):
            store2.load(alien)


def test_snapshot_meta_checksum_guard(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.save(0, {}, {"rids": [1], "entry": "e"})
    path = store.scan()[0]
    _, meta = ckpt_io.restore(path)
    meta["rids"] = [999]                       # forge the request list
    ckpt_io.save(path, {}, meta)               # checksum now stale
    assert meta[CHECKSUM_KEY]
    with pytest.raises(SnapshotError, match="checksum"):
        store.load(path)


def test_snapshot_one_live_file_per_serial(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.save(5, {}, {})
    store.save(5, {}, {})                      # supersedes
    assert [os.path.basename(p) for p in store.scan()] == ["run-2.ckpt"]
    assert store.live() == (5,)
    store.drop(5)
    assert store.scan() == [] and store.live() == ()
    qpath = os.path.join(str(tmp_path), "run-3.ckpt")
    ckpt_io.save(qpath, {}, {})
    assert store.quarantine(qpath) == "run-3.ckpt"
    assert os.listdir(tmp_path) == ["run-3.ckpt.quarantined"]
    assert store.scan() == []


def test_plan_hash_equals_the_reference():
    from repro.core import schedule as JS
    for n in (2, 3):
        sch = JS.fora(("attn", "ffn"), 8, n)
        jp = jplan.analyze(sch)
        tp = plan_lib.ExecutionPlan.from_jsonable(
            json.loads(jp.to_json()))
        assert plan_hash(tp) == jdur.plan_hash(jp)


def _provenance_stores():
    _, tcfg = smoke_cfgs()
    jcfg, _ = smoke_cfgs()
    from repro.core import solvers as jsol
    from repro_torch.core import solvers as tsol
    art = jd._real_artifact(jcfg, 6)
    stores = []
    for mod, cfg, sol, conv in ((jserve, jcfg, jsol, lambda a: a),
                                (serve, tcfg, tsol, port_artifact)):
        store = mod.ArtifactStore(cfg, sol.ddim(6), cfg_scale=1.5)
        store.add_policy("static2", "static:n=2")
        store.add_policy("none", "none")
        store.add_artifact("adaptive", conv(art))
        store.add_artifact("static_art", conv(art),
                           policy={"name": "static", "n": 2})
        stores.append(store)
    return stores


@pytest.mark.parametrize("name", ["static2", "none", "adaptive",
                                  "static_art"])
def test_provenance_equals_the_reference(name):
    js, ts = _provenance_stores()
    jp, tp = js.get(name).provenance(), ts.get(name).provenance()
    assert tp == jp
    assert set(tp) == {"entry", "version", "schedule_fp", "plan_hash",
                       "tau", "k_max", "artifact_checksum"}
    entry = ts.get(name)
    assert entry.provenance() is not entry.provenance()   # a copy
    assert entry._provenance == tp                         # memoized


# ---------------------------------------------------------------------------
# Engines on the reference's virtual fakes
# ---------------------------------------------------------------------------

class DurableFakeExecutor(jd.DurableFakeExecutor):
    """``tests/test_durable.py``'s fake with the snapshot seam, placed on
    the CPU device (the port's engine builds labels on it)."""
    device = torch.device("cpu")


def make_store(num_steps=8, mod=serve, conv=port_artifact):
    store = mod.ArtifactStore(jd._Cfg(), jd._Solver(num_steps))
    store.add_policy("static2", "static:n=2")
    store.add_policy("no_cache", "none")
    store.add_artifact("adaptive", conv(jd._fake_artifact(num_steps)))
    return store


def durable_factory(tmp_path, *, num_steps=8, mod=serve, **kw):
    """Fresh-engine factory over one shared journal path + snapshot dir
    (``mod``: the port's serve package, or the JAX package's)."""
    jpath = str(tmp_path / "journal.jsonl")
    sdir = str(tmp_path / "snapshots")
    port = mod is serve
    kw.setdefault("max_batch", 4)

    def make():
        clock = mod.VirtualClock()
        ex = (DurableFakeExecutor if port else jd.DurableFakeExecutor)(
            clock)
        store = (make_store(num_steps) if port else
                 make_store(num_steps, jserve, lambda a: a))
        return mod.ServeEngine(ex, params=None, store=store, clock=clock,
                               journal=jpath, snapshot_dir=sdir, **kw)
    return make, jpath, sdir


def vreq(rid, policy, arrival=0.0, mod=serve):
    return mod.Request(rid=rid, seed=rid, policy=policy, arrival=arrival)


def test_submit_is_write_ahead(tmp_path):
    make, jpath, _ = durable_factory(tmp_path)
    eng = make()
    eng.submit(vreq(0, "static2"), vreq(1, "missing_policy"))
    st = JournalState.replay(jpath)
    assert set(st.submitted) == {0, 1}
    assert st.shed[1][0] == "no_entry"
    assert st.pending() == {0: st.submitted[0]}
    assert eng.journal.synced == 1             # one fsync per burst


def test_outcome_answers_from_journal_after_restart(tmp_path):
    make, _, _ = durable_factory(tmp_path)
    eng = make()
    eng.submit(vreq(0, "static2"), vreq(1, "static2"),
               vreq(2, "missing_policy"))
    assert sorted(eng.run_until_drained()) == [0, 1]
    crash(eng)
    assert eng.journal.closed
    eng2 = make()
    summary = eng2.recover()
    assert summary["done"] == 2 and summary["shed"] == 1
    assert summary["replayed"] == 0
    assert eng2.outcome(0) == ("done", None)
    assert eng2.outcome(2) == ("shed", "no_entry")
    with pytest.raises(KeyError):
        eng2.outcome(99)
    eng2.submit(vreq(0, "static2"))
    assert eng2.metrics.rejects.get("duplicate_rid") == 1


@pytest.mark.parametrize("policy,kind", [("static2", "plan"),
                                         ("adaptive", "adaptive")])
def test_kill_midflight_restores_run(tmp_path, policy, kind):
    make, _, sdir = durable_factory(tmp_path)
    eng = make()
    eng.submit(*[vreq(i, policy) for i in range(4)])
    jd._step_until(eng, lambda: bool(os.listdir(sdir))
                   and eng._inflight and not eng._inflight[0].rs.done)
    pre = (eng._inflight[0].rs.run_index if kind == "plan"
           else eng._inflight[0].rs.step)
    assert pre >= 1
    crash(eng)
    eng2 = make()
    summary = eng2.recover()
    assert summary["restored_runs"] == 1
    assert summary["restored_requests"] == 4
    assert summary["replayed"] == 0 and summary["refused"] == []
    assert sorted(eng2.run_until_drained()) == [0, 1, 2, 3]
    rec = eng2.records[0]
    assert any(t.startswith("restore@") for t in rec.lineage)
    assert eng2.metrics.restored_runs == 1
    if kind == "adaptive":
        clean = serve.ServeEngine(
            DurableFakeExecutor(serve.VirtualClock()), params=None,
            store=make_store(), clock=serve.VirtualClock(), max_batch=4)
        clean.submit(*[vreq(i, policy) for i in range(4)])
        clean.run_until_drained()
        assert rec.decisions == clean.records[0].decisions
        assert len(rec.decisions) == 8


def test_checkpoint_cadence_and_cleanup(tmp_path):
    counts = []
    for sub, every in (("a", 1), ("b", 2)):
        make, _, sdir = durable_factory(tmp_path / sub,
                                        checkpoint_every=every)
        eng = make()
        eng.submit(*[vreq(i, "static2") for i in range(4)])
        eng.run_until_drained()
        assert os.listdir(sdir) == []          # finish dropped the file
        counts.append(eng.metrics.checkpoints)
        crash(eng)
    assert counts[0] > counts[1] >= 1
    with pytest.raises(ValueError, match="checkpoint_every"):
        durable_factory(tmp_path / "c", checkpoint_every=0)[0]()


def test_eager_runs_are_not_checkpointed(tmp_path):
    make, _, sdir = durable_factory(tmp_path, eager=True)
    eng = make()
    eng.executor.sample = lambda params, gen, batch, **kw: \
        np.zeros((batch, 1))
    eng.submit(*[vreq(i, "static2") for i in range(2)])
    assert sorted(eng.run_until_drained()) == [0, 1]
    assert eng.metrics.checkpoints == 0 and os.listdir(sdir) == []


def test_checkpoint_error_is_counted_not_raised(tmp_path):
    make, jpath, sdir = durable_factory(tmp_path)
    eng = make()

    def broken(rs):
        raise OSError("disk full")
    eng.executor.export_run = broken
    eng.submit(*[vreq(i, "static2") for i in range(2)])
    assert sorted(eng.run_until_drained()) == [0, 1]
    assert eng.metrics.checkpoint_errors > 0
    assert eng.metrics.checkpoints == 0
    assert eng.report()["durable"]["checkpoint_errors"] \
        == eng.metrics.checkpoint_errors


def _kill_with_snapshot(make, sdir, policy="static2"):
    eng = make()
    eng.submit(*[vreq(i, policy) for i in range(4)])
    jd._step_until(eng, lambda: bool(os.listdir(sdir))
                   and eng._inflight and not eng._inflight[0].rs.done)
    crash(eng)
    return [os.path.join(sdir, n) for n in os.listdir(sdir)]


@pytest.mark.parametrize("mutilate,reason_match", [
    (lambda raw: raw[:-1] + bytes([raw[-1] ^ 0xFF]), "CheckpointError"),
    (lambda raw: raw[: len(raw) // 2], "CheckpointError"),
])
def test_bad_snapshot_quarantined_with_reason_then_replayed(
        tmp_path, mutilate, reason_match):
    make, _, sdir = durable_factory(tmp_path)
    paths = _kill_with_snapshot(make, sdir)
    for p in paths:
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(mutilate(raw))
    eng = make()
    summary = eng.recover()
    assert summary["restored_runs"] == 0 and summary["replayed"] == 4
    assert len(summary["refused"]) == len(paths)
    qname, reason = summary["refused"][0]
    assert reason_match in reason
    assert os.path.exists(os.path.join(sdir, qname + ".quarantined"))
    assert eng.store.health.quarantine_reason(f"snapshot:{qname}") \
        == reason
    assert eng.metrics.snapshots_refused == len(paths)
    assert sorted(eng.run_until_drained()) == [0, 1, 2, 3]


def test_provenance_drift_refused(tmp_path):
    make, jpath, sdir = durable_factory(tmp_path)
    _kill_with_snapshot(make, sdir, policy="adaptive")
    clock = serve.VirtualClock()
    store = make_store()
    store.reload("adaptive", port_artifact(jd._fake_artifact(8)))
    eng = serve.ServeEngine(DurableFakeExecutor(clock), params=None,
                            store=store, clock=clock, max_batch=4,
                            journal=jpath, snapshot_dir=sdir)
    summary = eng.recover()
    assert summary["restored_runs"] == 0 and summary["replayed"] == 4
    assert any("provenance drift on version" in r
               for _, r in summary["refused"])
    assert sorted(eng.run_until_drained()) == [0, 1, 2, 3]


def test_stale_snapshot_discarded_silently(tmp_path):
    make, _, sdir = durable_factory(tmp_path)
    paths = _kill_with_snapshot(make, sdir)
    keep = str(tmp_path / "keep.ckpt")
    shutil.copy(paths[0], keep)
    eng = make()
    eng.recover()
    eng.run_until_drained()
    crash(eng)
    shutil.copy(keep, paths[0])
    eng2 = make()
    summary = eng2.recover()
    assert summary["stale"] >= 1 and summary["refused"] == []
    assert not os.path.exists(paths[0])
    assert eng2.metrics.report()["durable"]["snapshots_stale"] >= 1


def test_snapshot_dir_needs_the_export_seam(tmp_path):
    import test_serve as jt

    class NoSeam(jt.FakeExecutor):
        device = torch.device("cpu")

    clock = serve.VirtualClock()
    with pytest.raises(ValueError, match="supports_export"):
        serve.ServeEngine(NoSeam(clock), None, make_store(), clock=clock,
                          snapshot_dir=str(tmp_path / "s"))


@pytest.mark.durability
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_kill_matrix_matches_the_reference(tmp_path, seed):
    """The reference's kill matrix (18 requests, a kill at tick 2 and a
    seeded rate of 0.2) through the JAX engine and the port's: the same
    delivered rids, restarts, ticks, journal events (snapshot names and
    virtual times included) and ``durable`` report section — but for
    ``checkpoint_bytes``: the files' headers differ (JSON here, msgpack
    there); every rid resolves in a probe engine recovered from the
    journal alone."""
    out = {}
    policies = ("static2", "adaptive", "no_cache")
    for name, mod, dur in (("jax", jserve, jdur), ("torch", serve, tdur)):
        make, jpath, _ = durable_factory(tmp_path / name, mod=mod)
        trace = [vreq(i, policies[i % 3], arrival=0.25 * i, mod=mod)
                 for i in range(18)]
        eng0 = make()
        eng0.submit(*trace)
        dur.crash(eng0)
        plan = dur.KillPlan(seed=seed, kill_rate=0.2, kills={2},
                            max_kills=10)
        rep = dur.drain_with_kills(make, plan)
        resolved = set(rep.delivered) | set(rep.engine.shed)
        assert resolved == {r.rid for r in trace}
        probe = make()
        probe.recover()
        assert all(probe.outcome(r.rid)[0] in ("done", "shed")
                   for r in trace)
        events, skipped = dur.replay(jpath)
        section = rep.engine.report()["durable"]
        assert (section.pop("checkpoint_bytes") > 0) \
            == (section["checkpoints"] > 0)
        out[name] = dict(
            delivered=sorted(rep.delivered), restarts=rep.restarts,
            ticks=rep.ticks, events=events, skipped=skipped,
            durable=section,
            pending=dur.JournalState.replay(jpath).pending())
    assert out["torch"] == out["jax"]
    assert out["torch"]["restarts"] >= 1 and out["torch"]["pending"] == {}


def test_recover_without_a_journal_returns_the_reference_summary():
    clock = serve.VirtualClock()
    eng = serve.ServeEngine(DurableFakeExecutor(clock), None, make_store(),
                            clock=clock)
    jclock = jserve.VirtualClock()
    jeng = jserve.ServeEngine(jd.DurableFakeExecutor(jclock), None,
                              make_store(8, jserve, lambda a: a),
                              clock=jclock)
    assert eng.recover() == jeng.recover()
    assert eng.metrics.recoveries == 0


# ---------------------------------------------------------------------------
# The smoke DiT: resume ≡ never crashed, bitwise
# ---------------------------------------------------------------------------

STEPS = 6


def _executor():
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    _, cfg = smoke_cfgs()
    return SmoothCacheExecutor(cfg, solvers.ddim(STEPS), cfg_scale=1.5,
                               device="cpu")


def _adaptive_kw(cfg):
    from repro_torch.cache import registry
    from repro_torch.core import calibration
    sch = registry.get("static:n=2").build(cfg.layer_types(), STEPS)
    pm = calibration.ProxyMap({t: (0.5, 0.01) for t in cfg.layer_types()})
    return dict(schedule=sch, tau=0.1, proxy_map=pm,
                pool=plan_lib.mask_lattice(sch), k_max=2)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    return a == b


def test_real_export_import_bitwise_all_three_kinds(tmp_path):
    """Export at a boundary → save → restore → import on a fresh
    executor → advance to done equals the uninterrupted run bitwise, for
    segmented, host-adaptive and fused-adaptive states; τ / k_max drift
    and out-of-range positions are refused; the fused round trip adds no
    host sync and keeps its graph key."""
    from repro_torch.core import fused
    _, params = smoke_params()
    ex = _executor()
    assert ex.supports_export
    kw = _adaptive_kw(ex.cfg)
    sch = kw["schedule"]
    label = torch.tensor([3, 5])

    def gen():
        return serve.batch_generator([100, 101])

    cases = [
        ("plan",
         lambda e: e.start_run(params, gen(), 2, plan=e.plan_for(sch),
                               schedule=sch, label=label),
         lambda e, rs: e.advance_run(params, rs),
         dict(plan=ex.plan_for(sch))),
        ("adaptive",
         lambda e: e.start_adaptive_run(params, gen(), 2, label=label, **kw),
         lambda e, rs: e.advance_adaptive_run(params, rs), kw),
        ("adaptive_fused",
         lambda e: e.start_adaptive_fused_run(params, gen(), 2,
                                              label=label, telemetry=True,
                                              **kw),
         lambda e, rs: e.advance_adaptive_fused(params, rs, n_steps=2), kw),
    ]
    for name, start, advance, import_kw in cases:
        ref = start(ex)
        while not ref.done:
            ref = advance(ex, ref)
        rs = advance(ex, start(ex))
        kind, arrays, static = ex.export_run(rs)
        assert kind == name and static["batch"] == 2
        path = str(tmp_path / f"{name}.ckpt")
        ckpt_io.save(path, arrays, {"static": static})
        restored, meta = ckpt_io.restore(path)
        assert _same(restored, arrays)          # every dtype, every bit
        ex2 = _executor()                       # the restarted process
        rs2 = ex2.import_run(params, kind, restored, meta["static"],
                             **import_kw)
        assert type(rs2) is type(rs)
        if name == "adaptive_fused":
            assert fused.graph_key(rs2, params) \
                == fused.graph_key(rs, params)
        while not rs2.done:
            rs2 = advance(ex2, rs2)
        assert torch.equal(rs2.x, ref.x)
        assert torch.equal(rs2.healthy, ref.healthy)
        if name != "plan":
            assert rs2.decisions == ref.decisions
        if name == "adaptive_fused":
            assert torch.equal(rs2.proxy_trace, ref.proxy_trace)
            assert ex2.host_sync_count == 0
            # in the executor it came from, the restored run reuses the
            # fused step already built for its key
            steps = len(ex.fused_graphs())
            rs3 = ex.import_run(params, kind, restored, meta["static"],
                                **import_kw)
            while not rs3.done:
                rs3 = advance(ex, rs3)
            assert torch.equal(rs3.x, ref.x)
            assert len(ex.fused_graphs()) == steps
    rs = ex.advance_adaptive_run(params, cases[1][1](ex))
    kind, arrays, static = ex.export_run(rs)
    for drift in (dict(tau=0.3), dict(k_max=3)):
        with pytest.raises(ValueError, match="tau/k_max"):
            ex.import_run(params, kind, arrays, static, **dict(kw, **drift))
    with pytest.raises(ValueError, match="step"):
        ex.import_run(params, kind, arrays, dict(static, step=STEPS + 1),
                      **kw)
    kind, arrays, static = ex.export_run(cases[0][1](ex))
    with pytest.raises(ValueError, match="run_index"):
        ex.import_run(params, kind, arrays, dict(static, run_index=99),
                      plan=ex.plan_for(sch))
    with pytest.raises(ValueError, match="plan="):
        ex.import_run(params, kind, arrays, static)
    with pytest.raises(ValueError, match="unknown run kind"):
        ex.import_run(params, "bogus", arrays, static)
    with pytest.raises(ValueError, match="exportable"):
        ex.export_run(object())


def _real_store(cfg):
    from repro_torch.core import solvers
    jcfg, _ = smoke_cfgs()
    store = serve.ArtifactStore(cfg, solvers.ddim(STEPS), cfg_scale=1.5)
    store.add_policy("static2", "static:n=2")
    store.add_artifact("adaptive",
                       port_artifact(jd._real_artifact(jcfg, STEPS)))
    return store


def test_real_engine_restore_bit_identical(tmp_path):
    """Kill a real engine with a static and a fused adaptive batch in
    flight; a fresh engine on a fresh executor restores both from
    snapshots and finishes them, every latent bitwise the uninterrupted
    engine's, with no decision sync."""
    _, params = smoke_params()
    _, cfg = smoke_cfgs()
    reqs = [serve.Request(rid=i, seed=100 + i,
                          policy="adaptive" if i >= 2 else "static2",
                          label=i % cfg.num_classes, arrival=0.0)
            for i in range(4)]

    def build(journal=None, snapshot_dir=None):
        ex = _executor()
        eng = serve.ServeEngine(
            ex, params, _real_store(cfg), max_batch=2, max_inflight=2,
            clock=serve.VirtualClock(), check=True, adaptive_chunk=2,
            journal=journal, snapshot_dir=snapshot_dir)
        return eng, ex

    base_eng, _ = build()
    base_eng.submit(*[dataclasses.replace(r) for r in reqs])
    base = base_eng.run_until_drained()

    jpath = str(tmp_path / "journal.jsonl")
    sdir = str(tmp_path / "snapshots")
    eng, _ = build(jpath, sdir)
    eng.submit(*[dataclasses.replace(r) for r in reqs])
    jd._step_until(eng, lambda: len(eng._snapshots.live()) == 2
                   and all(not fl.rs.done for fl in eng._inflight), limit=6)
    assert {fl.kind for fl in eng._inflight} == {"plan", "adaptive_fused"}
    crash(eng)

    eng2, ex2 = build(jpath, sdir)
    summary = eng2.recover()
    assert summary["restored_runs"] == 2
    assert summary["restored_requests"] == 4
    assert summary["replayed"] == 0 and summary["refused"] == []
    res = eng2.run_until_drained()
    assert sorted(res) == [0, 1, 2, 3]
    assert ex2.host_sync_count == 0
    for rid in base:
        np.testing.assert_array_equal(res[rid], base[rid])
    assert all(any(t.startswith("restore@") for t in rec.lineage)
               for rec in eng2.records)
    assert os.listdir(sdir) == []
    rep = eng2.report()["durable"]
    assert rep["restored_runs"] == 2 and rep["recoveries"] == 1


def _static_build(jpath, sdir, max_batch):
    from repro_torch.core import solvers
    _, params = smoke_params()
    ex = _executor()
    store = serve.ArtifactStore(ex.cfg, solvers.ddim(STEPS), cfg_scale=1.5)
    store.add_policy("static2", "static:n=2")
    return serve.ServeEngine(
        ex, params, store, max_batch=max_batch, max_inflight=1,
        clock=serve.VirtualClock(), check=True, continuous=True,
        journal=jpath, snapshot_dir=sdir)


def _solo(rids):
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    _, params = smoke_params()
    _, cfg = smoke_cfgs()
    pipe = DiffusionPipeline(cfg, solvers.ddim(STEPS), "static:n=2",
                             cfg_scale=1.5, device="cpu")
    return {i: pipe.generate(params, serve.batch_generator([100 + i]), 1,
                             label=torch.tensor([i % cfg.num_classes]))[0]
            .numpy() for i in rids}


def test_real_join_then_restore_bit_identical(tmp_path):
    """Continuous mode: late arrivals join an in-flight batch, the merged
    run checkpoints, the process dies, and the restart restores the
    merged run (join lineage intact) — every latent still equals a solo
    ``generate`` of its own seed."""
    _, cfg = smoke_cfgs()
    jpath = str(tmp_path / "journal.jsonl")
    sdir = str(tmp_path / "snapshots")

    def rq(i):
        return serve.Request(rid=i, seed=100 + i, policy="static2",
                             label=i % cfg.num_classes)

    eng = _static_build(jpath, sdir, 4)
    eng.submit(rq(0), rq(1))
    assert eng.step()
    eng.submit(rq(2), rq(3))

    def merged_and_snapshotted():
        if eng.metrics.joins != 1 or len(eng._inflight) != 1:
            return False
        fl = eng._inflight[0]
        if fl.rs.done or fl.mb.bucket != 4:
            return False
        ck = JournalState.replay(jpath).checkpoints.get(int(fl.serial))
        return ck is not None and len(ck.get("rids", ())) == 4

    jd._step_until(eng, merged_and_snapshotted, limit=12)
    crash(eng)

    eng2 = _static_build(jpath, sdir, 4)
    summary = eng2.recover()
    assert summary["restored_runs"] == 1
    assert summary["restored_requests"] == 4
    res = eng2.run_until_drained()
    assert sorted(res) == [0, 1, 2, 3]
    rec = eng2.records[0]
    assert any("join@" in t for t in rec.lineage)
    assert any(t.startswith("restore@") for t in rec.lineage)
    for i, x in _solo(range(4)).items():
        np.testing.assert_array_equal(x, res[i])


def test_real_replay_from_start_bit_identical(tmp_path):
    """Every snapshot tampered → every one quarantined with a reason →
    the pending requests replay from the start, each latent bitwise a
    solo ``generate`` of its own seed."""
    _, cfg = smoke_cfgs()
    jpath = str(tmp_path / "journal.jsonl")
    sdir = str(tmp_path / "snapshots")
    eng = _static_build(jpath, sdir, 2)
    eng.submit(*[serve.Request(rid=i, seed=100 + i, policy="static2",
                               label=i % cfg.num_classes, arrival=0.0)
                 for i in range(2)])
    jd._step_until(eng, lambda: bool(os.listdir(sdir))
                   and eng._inflight and not eng._inflight[0].rs.done,
                   limit=6)
    crash(eng)
    for name in os.listdir(sdir):
        p = os.path.join(sdir, name)
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    eng2 = _static_build(jpath, sdir, 2)
    summary = eng2.recover()
    assert summary["restored_runs"] == 0 and summary["replayed"] == 2
    assert len(summary["refused"]) >= 1
    for qname, reason in summary["refused"]:
        assert eng2.store.health.quarantine_reason(
            f"snapshot:{qname}") == reason
    res = eng2.run_until_drained()
    assert sorted(res) == [0, 1]
    for i, x in _solo(range(2)).items():
        np.testing.assert_array_equal(x, res[i])


def test_chaos_seams_round_trip_a_real_run(tmp_path):
    """``ChaosExecutor.export_run`` unwraps the proxy (its fault
    bookkeeping is not saved); ``import_run`` re-wraps the restored state
    with no pending fault, and it finishes bitwise the unwrapped run."""
    from repro_torch.resilience.chaos import ChaosRun
    _, params = smoke_params()
    inner = _executor()
    kw = _adaptive_kw(inner.cfg)
    plan = FaultPlan(faults={0: FaultSpec(faults.NAN_LATENT, row=0,
                                          chunk=5)})
    ex = ChaosExecutor(inner, plan)
    assert ex.supports_export
    gen = lambda: serve.batch_generator([7, 8])       # noqa: E731
    rs = ex.start_adaptive_fused_run(params, gen(), 2, **kw)
    assert isinstance(rs, ChaosRun) and rs._spec is not None
    rs = ex.advance_adaptive_fused(params, rs, n_steps=2)
    kind, arrays, static = ex.export_run(rs)
    assert kind == "adaptive_fused"
    assert _same(ex.export_run(rs._inner), (kind, arrays, static))
    rs2 = ex.import_run(params, kind, arrays, static, **kw)
    assert isinstance(rs2, ChaosRun) and rs2._spec is None
    assert rs2._batch == 2 and not rs2._poisoned
    while not rs2.done:
        rs2 = ex.advance_adaptive_fused(params, rs2, n_steps=2)
    ref = inner.start_adaptive_fused_run(params, gen(), 2, **kw)
    ref = inner.advance_adaptive_fused(params, ref)
    assert torch.equal(rs2.x, ref.x) and ex.injected == {}
