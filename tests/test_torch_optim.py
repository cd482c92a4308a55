"""The port's AdamW (``repro_torch.optim``) against the JAX package's
``repro.optim.adamw`` on the same numpy parameters, gradients and state:
five steps of ``apply_updates`` with clipping that binds, weight decay and
the cosine schedule (every parameter, moment and metric within 1e-6
relative), the schedules at every step, ``global_norm``, and
``convert.opt_state_from_numpy`` leaf for leaf.  The port's update is in
place: every tensor keeps its address."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adamw as tadamw

TOL = dict(atol=1e-6, rtol=1e-6)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return {"a": mk(3, 4), "stages": [(mk(2, 5, 5), {"b": mk(7)})],
            "z": {"w": mk(6, 2)}}


def _close(want, got, **tol):
    want = jax.tree.leaves(want)
    got = tree_leaves(got)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **(tol or TOL))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (None, 0.0), (50.0, 0.1)])
def test_apply_updates_matches_reference_for_five_steps(clip, wd):
    params = _tree(0)
    sched = dict(warmup=2, total=5)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip,
                              schedule=jadamw.cosine_schedule(**sched))
    tcfg = tadamw.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip,
                              schedule=tadamw.cosine_schedule(**sched))
    pj = _jax(params)
    sj = jadamw.init_state(pj)
    pt = params_from_numpy(params, device="cpu")
    st = tadamw.init_state(pt)
    ptrs = [a.data_ptr() for a in tree_leaves(pt) + tree_leaves(st)]
    for step in range(5):
        # a scale of 3 puts the global norm near 10: a clip of 1 binds
        grads = _tree(100 + step, scale=3.0)
        pj, sj, mj = jadamw.apply_updates(jcfg, pj, _jax(grads), sj)
        gt = params_from_numpy(grads, device="cpu")
        pt2, st2, mt = tadamw.apply_updates(tcfg, pt, gt, st)
        assert pt2 is pt and st2 is st
        _close(pj, pt)
        _close(sj["mu"], st["mu"])
        _close(sj["nu"], st["nu"])
        assert int(st["step"]) == int(sj["step"]) == step + 1
        assert st["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL)
    assert [a.data_ptr() for a in tree_leaves(pt) + tree_leaves(st)] == ptrs


def test_clip_binds_in_the_update_test():
    grads = _tree(100, scale=3.0)
    norm = float(jadamw.global_norm(_jax(grads)))
    assert norm > 1.0


@pytest.mark.parametrize("warmup,total,final", [(10, 150, 0.1), (3, 7, 0.1),
                                                (0, 5, 0.2), (10, 10, 0.1)])
def test_cosine_schedule_every_step(warmup, total, final):
    fj = jadamw.cosine_schedule(warmup, total, final)
    ft = tadamw.cosine_schedule(warmup, total, final)
    for s in range(total + 3):
        want = float(fj(jnp.asarray(s, jnp.int32)))
        got = float(ft(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s


def test_constant_schedule():
    for s in range(4):
        assert float(tadamw.constant_schedule()(torch.tensor(s))) == float(
            jadamw.constant_schedule()(jnp.asarray(s)))


def test_global_norm():
    tree = _tree(3, scale=2.0)
    want = float(jadamw.global_norm(_jax(tree)))
    got = float(tadamw.global_norm(params_from_numpy(tree, device="cpu")))
    assert got == pytest.approx(want, rel=1e-6)
    bf16 = params_from_numpy(tree, device="cpu")
    bf16 = {"a": bf16["a"].to(torch.bfloat16)}
    assert tadamw.global_norm(bf16).dtype == torch.float32


def test_opt_state_from_numpy_leaf_for_leaf():
    params = _jax(_tree(0))
    cfg = jadamw.AdamWConfig(lr=1e-2)
    state = jadamw.init_state(params)
    for step in range(3):
        params, state, _ = jadamw.apply_updates(cfg, params,
                                                _jax(_tree(9 + step)), state)
    got = opt_state_from_numpy(jax.tree.map(np.asarray, state), device="cpu")
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    assert int(got["step"]) == 3
    for k in ("mu", "nu"):
        want = jax.tree.leaves(state[k])
        leaves = tree_leaves(got[k])
        assert len(leaves) == len(want)
        for a, b in zip(want, leaves):
            assert b.dtype == torch.float32
            assert np.array_equal(b.numpy(), np.asarray(a))


def test_grad_sq_norms_flag_each_leaf():
    """The update's ``grad_sq_norms``: each leaf's Σ g² in ``tree_leaves``
    order, whose sum is the global norm squared; a zero leaf shows 0 and a
    non-finite one a non-finite entry."""
    grads = params_from_numpy(_tree(4), device="cpu")
    params = params_from_numpy(_tree(5), device="cpu")
    _, _, m = tadamw.apply_updates(tadamw.AdamWConfig(), params, grads,
                                   tadamw.init_state(params))
    want = [float((g.double() ** 2).sum()) for g in tree_leaves(grads)]
    np.testing.assert_allclose(m["grad_sq_norms"].numpy(), want, rtol=1e-6)
    assert float(m["grad_norm"]) ** 2 == pytest.approx(sum(want), rel=1e-6)
    grads["z"]["w"].zero_()
    grads["a"][0, 0] = float("nan")
    _, _, m = tadamw.apply_updates(tadamw.AdamWConfig(), params, grads,
                                   tadamw.init_state(params))
    sq = m["grad_sq_norms"]
    leaves = tree_leaves(grads)
    za = [i for i, g in enumerate(leaves) if g is grads["z"]["w"]][0]
    assert float(sq[za]) == 0.0
    assert not bool(torch.isfinite(sq[0])) and leaves[0] is grads["a"]


def test_spans_are_profiler_ranges_and_record_nothing_outside_spans():
    """A span is a profiler range; with no ``spans`` open it records no
    CUDA event (the training entry points run on the CPU unchanged)."""
    from repro_torch.kernels import timing
    from torch.profiler import ProfilerActivity, profile
    grads = params_from_numpy(_tree(6), device="cpu")
    params = params_from_numpy(_tree(7), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("train.forward"):
            torch.ones(3).sum()
        tadamw.apply_updates(tadamw.AdamWConfig(), params, grads,
                             tadamw.init_state(params))
    names = {e.key for e in prof.key_averages()}
    assert {"train.forward", "train.optimizer"} <= names
    assert timing._SPANS is None
