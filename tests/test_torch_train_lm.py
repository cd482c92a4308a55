"""The port's LM training half (``launch.programs``: ``_xent``, ``lm_loss``,
``make_train_step``; ``models.transformer``: ``mtp_logits``, ``remat``;
``convert.opt_state_from_numpy``; the ``launch.train`` CLI) against the
JAX package's, on the same numpy weights and tokens.

Smoke variants: qwen3-14b (dense GQA), internvl2-1b (a prefix of patch
embeddings), musicgen-medium (4 codebooks and a text memory) and
deepseek-v3-671b (the MTP head and the MoE load-balance loss, ``dense``
dispatch).  The weights are the JAX package's init plus a seeded
0.05·N(0, 1) on every leaf.  The loss and every leaf's gradient match
``jax.value_and_grad`` within 5e-5 (the loss relative, a gradient relative
to its leaf's largest |g|); ``remat`` is bitwise neutral; a resumed CLI
run equals the uninterrupted one bitwise.

The composed step is held looser, on purpose: Adam's first step divides by
|g|, and the step rounds the gradients to bf16, so a parameter whose |g| is
near eps, or sits on a bf16 rounding boundary, can move by an lr-sized
amount on one side only.  The pieces are held tightly above and in
``test_torch_optim.py``; over 3 composed steps the losses agree within
5e-4 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import programs as jprog
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.launch import programs as tprog, train as ttrain
from repro_torch.models import transformer as tT
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adamw as tadamw

ARCHS = ["qwen3-14b", "internvl2-1b", "musicgen-medium", "deepseek-v3-671b"]
B, L = 2, 12


def _cfgs(arch):
    return jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    cfg, _ = _cfgs(arch)
    p = jax.jit(jT.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(41)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _params(arch):
    pn = _numpy_params(arch)
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _batch(arch, seed=0):
    """(tokens, targets, extras) as numpy: tokens (B, L[, K]), a prefix or
    a memory where the config takes one."""
    cfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    shape = (B, L + 1) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                          else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    extra = {}
    if cfg.num_prefix_embeds:
        extra["prefix_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    if cfg.cond_dim:
        extra["memory"] = (0.02 * rng.standard_normal(
            (B, 8, cfg.cond_dim))).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], extra


def _torch_batch(toks, tgts, extra):
    return (torch.from_numpy(toks).long(), torch.from_numpy(tgts).long(),
            {k: torch.from_numpy(v) for k, v in extra.items()})


def _jax_batch(toks, tgts, extra):
    return (jnp.asarray(toks), jnp.asarray(tgts),
            {k: jnp.asarray(v) for k, v in extra.items()})


def _close_grads(want, got, tol=5e-5):
    """Leaf for leaf: |Δ| ≤ tol × the leaf's largest |g|."""
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, want),
                                         device="cpu"))
    got = tree_leaves(got)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        assert err <= tol * max(scale, 1e-30), (tuple(a.shape), err, scale)


def _moe_kw(arch):
    return {"moe_strategy": "dense"} if arch.startswith("deepseek") else {}


@pytest.mark.parametrize("shape", [(3, 5, 17), (2, 4, 3, 11)])
def test_xent_matches(shape):
    rng = np.random.default_rng(1)
    z = (3 * rng.standard_normal(shape)).astype(np.float32)
    t = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(jprog._xent(jnp.asarray(z), jnp.asarray(t)))
    got = float(tprog._xent(torch.from_numpy(z), torch.from_numpy(t)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_weight_matches(arch):
    cfg, tc = _cfgs(arch)
    assert tprog._moe_aux_weight(tc) == jprog._moe_aux_weight(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match(arch):
    cfg, tc = _cfgs(arch)
    pj, pt = _params(arch)
    toks, tgts, extra = _batch(arch, seed=2)
    jt, jg, jx = _jax_batch(toks, tgts, extra)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jprog.lm_loss(cfg, p, jt, jg, remat=False, **jx,
                                **_moe_kw(arch))))(pj)
    tt, tg, tx = _torch_batch(toks, tgts, extra)
    lt, gt = tadamw.value_and_grad(
        lambda p: tprog.lm_loss(tc, p, tt, tg, remat=False, **tx,
                                **_moe_kw(arch)), pt)
    assert float(lt) == pytest.approx(float(lj), rel=5e-5)
    _close_grads(gj, gt)
    if arch.startswith("deepseek"):
        # the MTP head and the aux loss are in the loss: their leaves move
        assert float(gt["mtp"]["proj"].abs().max()) > 0
        assert tprog._moe_aux_weight(tc) > 0


def test_mtp_logits_match():
    arch = "deepseek-v3-671b"
    cfg, tc = _cfgs(arch)
    pj, pt = _params(arch)
    toks, _, _ = _batch(arch, seed=3)
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    want = jT.mtp_logits(cfg, pj, jnp.asarray(hidden), jnp.asarray(toks),
                         moe_strategy="dense")
    got = tT.mtp_logits(tc, pt, torch.from_numpy(hidden),
                        torch.from_numpy(toks).long(), moe_strategy="dense")
    assert tuple(got.shape) == (B, L, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-5)


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_remat_is_bitwise_neutral(arch):
    _, tc = _cfgs(arch)
    _, pt = _params(arch)
    tt, tg, tx = _torch_batch(*_batch(arch, seed=5))
    out = [tadamw.value_and_grad(
        lambda p: tprog.lm_loss(tc, p, tt, tg, remat=remat, **tx,
                                **_moe_kw(arch)), pt)
        for remat in (False, True)]
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_recomputes_each_unit_in_the_backward(monkeypatch):
    """With remat the backward runs each unit's forward again: the blocks
    are called twice as often."""
    from repro_torch.models import blocks
    _, tc = _cfgs("qwen3-14b")
    _, pt = _params("qwen3-14b")
    tt, tg, _ = _torch_batch(*_batch("qwen3-14b", seed=6))
    calls = []
    real = blocks.apply
    monkeypatch.setattr(blocks, "apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    counts = []
    for remat in (False, True):
        calls.clear()
        tadamw.value_and_grad(
            lambda p: tprog.lm_loss(tc, p, tt, tg, remat=remat), pt)
        counts.append(len(calls))
    assert counts == [tc.num_layers, 2 * tc.num_layers]


@pytest.mark.parametrize("arch", ["qwen3-14b", "internvl2-1b"])
def test_composed_train_step_losses_match(arch):
    """3 steps of ``make_train_step`` on both sides (gradients rounded to
    bf16, AdamW with the reference CLI's cosine): the losses within 5e-4
    relative, the step counter and the optimizer's leaves in step."""
    cfg, tc = _cfgs(arch)
    pj, pt = _params(arch)
    sched = dict(warmup=10, total=30)
    jstep = jax.jit(jprog.make_train_step(
        cfg, jadamw.AdamWConfig(lr=3e-4,
                                schedule=jadamw.cosine_schedule(**sched)),
        remat=False))
    tstep = tprog.make_train_step(
        tc, tadamw.AdamWConfig(lr=3e-4,
                               schedule=tadamw.cosine_schedule(**sched)),
        remat=False)
    sj, st = jadamw.init_state(pj), tadamw.init_state(pt)
    for i in range(3):
        toks, tgts, extra = _batch(arch, seed=10 + i)
        jt, jg, jx = _jax_batch(toks, tgts, extra)
        pj, sj, lj, _ = jstep(pj, sj, jt, jg, **jx)
        tt, tg, tx = _torch_batch(toks, tgts, extra)
        pt2, st, lt, mt = tstep(pt, st, tt, tg, **tx)
        assert pt2 is pt
        assert float(lt) == pytest.approx(float(lj), rel=5e-4)
    assert int(st["step"]) == int(sj["step"]) == 3
    assert not any(p.requires_grad for p in tree_leaves(pt))


def test_opt_state_from_numpy_resumes_the_reference_run():
    """Both sides start from the same state after 2 JAX steps: one more
    step each gives the same parameters within 1e-5 of their scale (f32
    gradients: the bf16 rounding is the composed step's)."""
    arch = "qwen3-14b"
    cfg, tc = _cfgs(arch)
    pj, _ = _params(arch)
    ocfg = dict(lr=1e-3, schedule=None)
    jgrad = jax.jit(jax.grad(lambda p, t, g: jprog.lm_loss(
        cfg, p, t, g, remat=False)))
    jupdate = jax.jit(functools.partial(jadamw.apply_updates,
                                        jadamw.AdamWConfig(**ocfg)))
    sj = jadamw.init_state(pj)
    for i in range(2):
        toks, tgts, _ = _batch(arch, seed=20 + i)
        g = jgrad(pj, jnp.asarray(toks), jnp.asarray(tgts))
        pj, sj, _ = jupdate(pj, g, sj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    st = opt_state_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    toks, tgts, _ = _batch(arch, seed=22)
    g = jgrad(pj, jnp.asarray(toks), jnp.asarray(tgts))
    pj, sj, _ = jupdate(pj, g, sj)
    _, gt = tadamw.value_and_grad(
        lambda p: tprog.lm_loss(tc, p, torch.from_numpy(toks).long(),
                                torch.from_numpy(tgts).long(), remat=False),
        pt)
    tadamw.apply_updates(tadamw.AdamWConfig(**ocfg), pt, gt, st)
    assert int(st["step"]) == 3
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, pj),
                                         device="cpu"))
    for a, b in zip(want, tree_leaves(pt)):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(a.abs().max()), 1.0)


def test_train_cli_checkpoint_and_resume_bitwise(tmp_path, capsys):
    """3 steps with --ckpt, then 2 with --resume, against 5 at once (all
    inside the cosine's 10-step warmup, where the multiplier is step / 10
    whatever the total)."""
    arch = ["--arch", "internvl2-1b", "--batch", "2", "--seq", "8",
            "--device", "cpu"]
    a, b, c = (str(tmp_path / n) for n in ("a.ckpt", "b.ckpt", "c.ckpt"))
    _, _, first = ttrain.main(arch + ["--steps", "3", "--ckpt", a])
    _, _, rest = ttrain.main(arch + ["--steps", "2", "--resume", a,
                                     "--ckpt", b])
    _, _, whole = ttrain.main(arch + ["--steps", "5", "--ckpt", c])
    assert first + rest == whole
    out = capsys.readouterr().out
    assert "resumed from" in out and "step 5:" in out
    tb, mb = ckpt_io.restore(b)
    tc_, mc = ckpt_io.restore(c)
    assert mb == mc == {"step": 5, "arch": "internvl2-1b"}
    for x, y in zip(tree_leaves(tb), tree_leaves(tc_)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert tb["opt"]["step"].dtype == torch.int32
