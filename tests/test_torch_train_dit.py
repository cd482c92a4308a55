"""The port's DiT training (``data.synthetic.BlobLatents``,
``core.diffusion``'s ``q_sample`` / ``eps_loss`` / ``rf_loss``,
``launch.train_dit``, ``launch.quickstart``) against the JAX package's, on
the dit-xl-256 smoke variant.

``BlobLatents``' rendering from the JAX package's own labels and noise
(1e-6); ``q_sample``; both losses with the reference's t and noise passed
in (5e-5 relative), and every leaf's gradient against ``jax.grad`` (5e-5
of the leaf's largest |g|); ``train_dit`` lowering the loss over 30 steps;
a save → restore → step run bitwise equal to the uninterrupted run; the
CLI; the quickstart's protocol at a small size, and its Fréchet distance
against the reference's.  JAX's random bits cannot be reproduced, so the
draws are passed across, as the executor tests pass latents."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from benchmarks import common as jcommon
from repro.core import diffusion as jd
from repro.data import synthetic as jsyn
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.core import diffusion as td
from repro_torch.data import synthetic as tsyn
from repro_torch.data.synthetic import step_generator
from repro_torch.launch import quickstart, train_dit as ttd
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import adamw as tadamw

B = 4


def _jax_blob_draws(latent_shape, num_classes, batch, seed, step):
    """The labels and noise ``repro.data.BlobLatents.batch_at`` draws."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    kl, kx, _ = jax.random.split(key, 3)
    label = jax.random.randint(kl, (batch,), 0, num_classes)
    noise = jax.random.normal(kx, (batch,) + tuple(latent_shape))
    return np.array(label), np.array(noise)


@pytest.mark.parametrize("shape,classes", [((8, 8, 4), 10),
                                           ((32, 32, 4), 1000),
                                           ((16, 12, 3), 1)])
def test_blob_rendering_matches_reference(shape, classes):
    want, want_label = jsyn.BlobLatents(shape, classes, 6, seed=3).batch_at(2)
    label, noise = _jax_blob_draws(shape, classes, 6, 3, 2)
    assert np.array_equal(label, np.asarray(want_label))
    got = tsyn.render_blobs(shape, classes, torch.from_numpy(label),
                            torch.from_numpy(noise))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_blob_latents_are_a_function_of_seed_and_step():
    data = tsyn.BlobLatents((8, 8, 4), 10, 5, seed=1)
    x0, label = data.batch_at(3, device="cpu")
    assert tuple(x0.shape) == (5, 8, 8, 4) and x0.dtype == torch.float32
    assert label.dtype == torch.int64 and int(label.max()) < 10
    again = data.batch_at(3, device="cpu")
    assert torch.equal(x0, again[0]) and torch.equal(label, again[1])
    assert not torch.equal(x0, data.batch_at(4, device="cpu")[0])
    # the noise is 0.05·N(0, 1) about the rendering
    clean = tsyn.render_blobs((8, 8, 4), 10, label, torch.zeros_like(x0))
    assert 0.03 < float((x0 - clean).std()) < 0.07


def _draws(kind, seed=5):
    """(x0, label, t, noise) as numpy, t and noise as the JAX loss draws
    them from its key."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    label = rng.integers(0, 10, B)
    kt, kn = jax.random.split(jax.random.PRNGKey(seed))
    t = (jax.random.randint(kt, (B,), 0, 1000) if kind == "eps"
         else jax.random.uniform(kt, (B,)))
    noise = jax.random.normal(kn, x0.shape, x0.dtype)
    return x0, label, np.array(t), np.array(noise), jax.random.PRNGKey(seed)


def test_q_sample_matches():
    x0, _, t, noise, _ = _draws("eps")
    want = jd.q_sample(jd.vp_schedule(), jnp.asarray(x0), jnp.asarray(t),
                       jnp.asarray(noise))
    got = td.q_sample(td.vp_schedule(), torch.from_numpy(x0),
                      torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def _losses(kind):
    cfg, tcfg = smoke_cfgs()
    pj, pt = smoke_params()
    x0, label, t, noise, key = _draws(kind)
    if kind == "eps":
        jfn = lambda p: jd.eps_loss(cfg, p, key, jnp.asarray(x0),  # noqa: E731
                                    sched=jd.vp_schedule(),
                                    label=jnp.asarray(label))
        tfn = lambda p: td.eps_loss(  # noqa: E731
            tcfg, p, None, torch.from_numpy(x0), sched=td.vp_schedule(),
            label=torch.from_numpy(label), t=torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise))
    else:
        jfn = lambda p: jd.rf_loss(cfg, p, key, jnp.asarray(x0),  # noqa: E731
                                   label=jnp.asarray(label))
        tfn = lambda p: td.rf_loss(  # noqa: E731
            tcfg, p, None, torch.from_numpy(x0),
            label=torch.from_numpy(label), t=torch.from_numpy(t),
            noise=torch.from_numpy(noise))
    lj, gj = jax.jit(jax.value_and_grad(jfn))(pj)
    lt, gt = tadamw.value_and_grad(tfn, pt)
    return lj, gj, lt, gt


@pytest.mark.parametrize("kind", ["eps", "rf"])
def test_loss_and_every_leaf_gradient_match_reference(kind):
    lj, gj, lt, gt = _losses(kind)
    assert float(lt) == pytest.approx(float(lj), rel=5e-5)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, gj),
                                         device="cpu"))
    got = tree_leaves(gt)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        scale = float(a.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 5e-5 * scale, tuple(a.shape)


def test_losses_draw_from_the_generator():
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    x0 = torch.randn(B, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    sched = td.vp_schedule()
    for fn in (lambda g: td.eps_loss(tcfg, pt, g, x0, sched=sched),
               lambda g: td.rf_loss(tcfg, pt, g, x0)):
        a, b = (fn(torch.Generator().manual_seed(s)) for s in (1, 1))
        assert torch.equal(a, b) and torch.isfinite(a)
        assert not torch.equal(a, fn(torch.Generator().manual_seed(2)))


def test_train_dit_lowers_the_loss():
    _, tcfg = smoke_cfgs()
    params, sched, losses = ttd.train_dit(
        tcfg, torch.Generator().manual_seed(0), steps=30, batch=8,
        device="cpu")
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < 0.5 * losses[0]
    assert "alpha_bar" in sched
    assert not any(p.requires_grad for p in tree_leaves(params))


def test_adaln_zero_gradients_reach_every_leaf_by_step_3():
    """From the adaLN-zero init (``out`` and every ``mod`` zero) only
    ``out`` has a nonzero gradient at step 1; by step 3 every leaf has."""
    _, tcfg = smoke_cfgs()
    params = td.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    state = tadamw.init_state(params)
    opt_cfg = tadamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    data = tsyn.BlobLatents(tcfg.latent_shape, tcfg.num_classes, 8)
    sched = td.vp_schedule()
    moved = []
    for i in range(3):
        x0, cond = ttd.batch_at(data, i, "cpu")
        _, grads = tadamw.value_and_grad(
            lambda p: td.eps_loss(tcfg, p, step_generator(0, i), x0,
                                  sched=sched, **cond), params)
        flat = flatten_params(tree_map(lambda g: float(g.abs().max()),
                                       grads))
        moved.append({k for k, v in flat.items() if v > 0})
        tadamw.apply_updates(opt_cfg, params, grads, state)
    assert moved[0] == {"out/w", "out/b"}
    assert moved[2] == set(flat)


def test_save_restore_step_equals_the_uninterrupted_run(tmp_path):
    """4 steps at once against 2 steps, a checkpoint of params and the
    optimizer, a restore into fresh tensors and 2 more: bitwise."""
    _, tcfg = smoke_cfgs()
    data = tsyn.BlobLatents(tcfg.latent_shape, tcfg.num_classes, 8)
    opt_cfg = tadamw.AdamWConfig(lr=2e-3, weight_decay=0.0,
                                 schedule=tadamw.cosine_schedule(10, 4))
    step = ttd.make_dit_step(tcfg, opt_cfg)

    def fresh():
        params = td.init_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
        return params, tadamw.init_state(params)

    def call(params, state, i):
        x0, cond = ttd.batch_at(data, i, "cpu")
        return float(step(params, state, x0, step_generator(9, i),
                          **cond)[0])

    whole, wstate = fresh()
    w_losses = [call(whole, wstate, i) for i in range(4)]
    part, pstate = fresh()
    p_losses = [call(part, pstate, i) for i in range(2)]
    path = str(tmp_path / "dit.ckpt")
    ckpt_io.save(path, {"params": part, "opt": pstate}, {"step": 2})
    tree, meta = ckpt_io.restore(path)
    params, state = tree["params"], tree["opt"]
    assert meta["step"] == 2 and int(state["step"]) == 2
    p_losses += [call(params, state, i) for i in range(2, 4)]
    assert p_losses == w_losses
    for a, b in zip(tree_leaves((whole, wstate)), tree_leaves((params,
                                                               state))):
        assert torch.equal(a, b)


def test_train_dit_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "dit.ckpt")
    params, losses = ttd.main(["--steps", "12", "--batch", "4", "--ckpt",
                               ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored ≡ trained: True" in out and "finite=True" in out
    tree, meta = ckpt_io.restore(ckpt)
    assert meta == {"arch": "dit-xl-256", "steps": 12, "kind": "eps"}
    for a, b in zip(tree_leaves(params), tree_leaves(tree["params"])):
        assert torch.equal(a, b)


def test_train_dit_rf_on_text_conditioned_latents():
    """OpenSora's route: rectified flow over ``CondLatents``."""
    from repro_torch import configs
    cfg = configs.get("opensora-v12", "smoke")
    data = tsyn.CondLatents(cfg.latent_shape, cfg.cond_dim, ttd.COND_LEN, 2)
    params, _, losses = ttd.train_dit(cfg, torch.Generator().manual_seed(0),
                                      steps=3, batch=2, data=data,
                                      loss_kind="rf", device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    x, finite = ttd.sample_check(cfg, params, data, "rf", "cpu", n=2)
    assert finite and tuple(x.shape) == (2,) + tuple(cfg.latent_shape)


def test_frechet_distance_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 8, 8, 4))
    b = 0.5 + 2 * rng.standard_normal((12, 8, 8, 4))
    assert quickstart.frechet_distance(a, b) == pytest.approx(
        jcommon.frechet_distance(a, b), rel=1e-12)


def test_quickstart_protocol_at_a_small_size():
    lines = []
    out = quickstart.run("cpu", steps=20, samples=4, iters=1,
                         log=lines.append)
    rows = out["rows"]
    assert [r["policy"] for r in rows] == ["no_cache",
                                           *quickstart.POLICIES]
    assert all(r["finite"] and r["ms"] > 0 for r in rows)
    assert rows[0]["compute_fraction"] == 1.0
    assert all(0 < r["compute_fraction"] < 1 for r in rows[1:])
    assert np.mean(out["losses"][-5:]) < out["losses"][0]
    assert any(line.startswith("no_cache") for line in lines)
    assert quickstart.time_call(lambda: None, iters=2) >= 0
    assert set(out["curves"]) == {"attn", "ffn"}
