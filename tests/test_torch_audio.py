"""The port's Stable-Audio-Open text-to-audio path against the JAX package's
(stable-audio-open smoke: 2 blocks, d 128, 4 heads × 32, a gated SiLU MLP,
latents (16, 64), cond_dim 64, a memory of 8 tokens; DPM-Solver++(3M)
SDE).  Inputs come from a numpy seed; weights go across through
``convert.params_from_numpy``.  Torch cannot draw JAX's noise, so the
tests that run a whole sample feed the reference's initial latent and its
per-step ``jax.random.normal(fold_in(kloop, s), x.shape)`` into the port
(``initial_latent`` and ``step_noise`` patched on the executor).

Tolerances, in f32: one solver step within 1e-5 of the step's scale; a
module or a forward within 5e-5 of the output's scale; a whole 8-step
sample within 1e-4 of its scale (error compounds over the steps, and
σ_max ≈ 157 makes the VE latent large); curves at the calibration tests'
1e-4.

Also, torch against torch and bitwise: eager ≡ segmented, the host loop
at τ = 0 ≡ ``sample_compiled``, served ≡ ``generate`` with prompts,
export → save → restore → import after steps 0–3 (across the solver
state's None → tensor transitions) ≡ uninterrupted, an engine restore and
a replay from the journal; the step noise is a function of (seed, step)
alone and deterministic solvers draw none."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import audio_cfgs, audio_params, to_np
from repro import cache as jcache
from repro.core import diffusion as jd, executor as jex
from repro.core import solvers as jsolvers
from repro.models import attention as jattn, blocks as jblocks
from repro_torch import cache as tcache, serve
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import calibration as tcal, diffusion as td
from repro_torch.core import executor as tex, schedule as tS
from repro_torch.core import solvers as tsolvers
from repro_torch.data import synthetic
from repro_torch.durable import crash
from repro_torch.models import attention as tattn, blocks as tblocks
from repro_torch.models.transformer import tree_map

STEPS = 8
CFG_SCALE = 7.0
MEM_LEN = 8
SMOOTH = "smoothcache:alpha=0.15"
ADAPTIVE = "adaptive:base=smoothcache(alpha=0.15),tau=0.3"
CURVE_TOL = dict(rtol=1e-4, atol=1e-7)


def _rel_close(a, b, tol=5e-5):
    """Max abs difference within ``tol`` of the reference's scale."""
    a, b = to_np(a), to_np(b)
    scale = float(np.abs(a).max())
    assert scale > 1e-3, "parity must not be vacuous"
    np.testing.assert_allclose(b, a, atol=tol * scale, rtol=0)


def _memory(seed=5, batch=2, length=MEM_LEN):
    _, tcfg = audio_cfgs()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, length, tcfg.cond_dim)).astype(
        np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def _state_kind(state):
    return tuple(k for k in ("d1", "d2", "h1", "h2")
                 if state[k] is not None)


@pytest.mark.parametrize("eta", [1.0, 0.0])
@pytest.mark.parametrize("n", [4, 10, 100])
def test_dpmpp_steps_match_reference(n, eta):
    """Step by step on the same x, ε and noise and the same ᾱ table (the
    reference's: the two packages' ``vp_schedule`` differ in the last bits
    of ᾱ, which 1 − ᾱ amplifies near t = 1): model times bitwise, each
    step's latent within 1e-5 of its scale, the state's structure
    (None → d1, h1 → all four) and values, the last step returning x̂₀."""
    ab = np.asarray(jd.vp_schedule()["alpha_bar"])
    js = jsolvers.dpmpp_3m_sde(n, sched={"alpha_bar": jnp.asarray(ab)},
                               eta=eta)
    ts = tsolvers.dpmpp_3m_sde(n, sched={"alpha_bar": torch.from_numpy(ab.copy())},
                               eta=eta)
    assert ts.stochastic and not ts.scannable and ts.name == "dpmpp_3m_sde"
    assert torch.equal(ts.model_times,
                       tsolvers.dpmpp_3m_sde(n, eta=eta).model_times)
    ref_times = np.asarray(js.model_times)
    assert ts.model_times.dtype == torch.float32
    assert np.array_equal(ts.model_times.numpy(), ref_times)
    assert ref_times[0] == 999 and ref_times[-1] == 1
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    xj, sj = jnp.asarray(x), js.init_state()
    xt, st = torch.from_numpy(x), ts.init_state()
    assert _state_kind(st) == ()
    kinds = []
    for s in range(n):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        key = jax.random.PRNGKey(1000 + s)
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        xj, sj = js.step(xj, jnp.asarray(eps), s, sj, key)
        xt, st = ts.step(xt, torch.from_numpy(eps), s, st,
                         torch.from_numpy(noise.copy()))
        _rel_close(xj, xt, tol=1e-5)
        kinds.append(_state_kind(st))
        for k in _state_kind(st):
            assert sj[k] is not None
            _rel_close(sj[k], st[k], tol=1e-5)
            if k.startswith("h"):
                assert tuple(st[k].shape) == (1,)
    want = [("d1", "h1"), ("d1", "d2", "h1", "h2")]
    assert kinds[0] == want[0]
    assert all(k == want[1] for k in kinds[1:-1])
    assert kinds[-1] == kinds[-2]          # the last step keeps the state


def test_dpmpp_last_step_returns_x0_hat():
    ts = tsolvers.dpmpp_3m_sde(5)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((1, 4)).astype(np.float32))
    ab = td.vp_schedule()["alpha_bar"][1]
    sig = torch.sqrt((1 - ab) / ab)
    state = ts.init_state()
    out, st = ts.step(x, eps, 4, state, torch.ones(1, 4))
    assert st is state
    np.testing.assert_allclose(out.numpy(),
                               (x / torch.sqrt(ab) - sig * eps).numpy(),
                               rtol=1e-6)


def test_dpmpp_noise_only_when_eta_and_noise():
    """Noise enters only with η > 0 and a tensor given, never at the last
    step."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    noise = torch.ones(1, 8)
    for eta, differs in ((1.0, True), (0.0, False)):
        ts = tsolvers.dpmpp_3m_sde(6, eta=eta)
        a, _ = ts.step(x, eps, 0, ts.init_state(), noise)
        b, _ = ts.step(x, eps, 0, ts.init_state(), None)
        assert (not torch.equal(a, b)) == differs, eta
        a, _ = ts.step(x, eps, 5, ts.init_state(), noise)
        b, _ = ts.step(x, eps, 5, ts.init_state(), None)
        assert torch.equal(a, b)


def test_dpmpp_reduces_to_x0_at_end():
    """Twin of ``tests/test_substrate.py``'s test: the exact-ε oracle at
    η = 0 lands on x₀."""
    solver = tsolvers.dpmpp_3m_sde(10, eta=0.0)
    x0 = torch.ones((1, 4)) * 0.3
    ab = td.vp_schedule()["alpha_bar"][solver.model_times.long()]
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4)).astype(np.float32))
    x = torch.sqrt(ab[0]) * x0 + torch.sqrt(1 - ab[0]) * eps
    state = solver.init_state()
    for s in range(10):
        x, state = solver.step(x, eps, s, state,
                               torch.from_numpy(np.random.default_rng(s)
                                                .standard_normal((1, 4))
                                                .astype(np.float32)))
    np.testing.assert_allclose(x.numpy(), 0.3, atol=5e-2)


def test_solver_registry():
    assert set(tsolvers.SOLVERS) == set(jsolvers.SOLVERS)
    assert tsolvers.SOLVERS["dpmpp_3m_sde"] is tsolvers.dpmpp_3m_sde


# ---------------------------------------------------------------------------
# Config, params, patchify
# ---------------------------------------------------------------------------

def _spec_fields(spec):
    if spec is None:
        return None
    return {f.name: getattr(spec, f.name)
            for f in dataclasses.fields(spec)
            if f.name not in ("q_lora_rank", "kv_lora_rank", "rope_head_dim",
                              "nope_head_dim", "v_head_dim")}


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_reference(variant):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    jc = jconfigs.get("stable-audio-open", variant)
    tc = tconfigs.get("stable-audio-open", variant)
    assert tc.layer_types() == jc.layer_types() == ("attn", "xattn", "ffn")
    for f in ("name", "d_model", "task", "latent_shape", "patch", "cond_dim",
              "norm", "num_classes", "dtype", "num_layers", "citation"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [b[:3] for b in tc.blocks()] == [b[:3] for b in jc.blocks()]
    for (_, _, _, tb), (_, _, _, jb) in zip(tc.blocks(), jc.blocks()):
        for part in ("mixer", "cross", "ffn"):
            assert _spec_fields(getattr(tb, part)) == _spec_fields(
                getattr(jb, part)), part
        assert (tb.norm, tb.adaln, tb.type_tag) == (jb.norm, jb.adaln,
                                                    jb.type_tag)
    assert td.token_shape(tc) == jd.token_shape(jc)
    if variant == "smoke":
        m = tc.stages[0].unit[0].mixer
        assert (tc.latent_shape, tc.cond_dim, m.num_heads, m.head_dim,
                tc.num_layers) == ((16, 64), 64, 4, 32, 2)
    else:
        assert (tc.d_model, tc.cond_dim, tc.latent_shape, tc.num_layers) == (
            1536, 768, (216, 64), 24)


def test_param_tree_and_conversion_match_reference():
    """The port's own init makes the reference's tree — the gated MLP's
    ``w_gate`` and the cross k/v reading ``cond_dim`` rows — and
    ``convert`` carries the reference's weights across leaf by leaf."""
    from repro_torch.convert import flatten_params
    _, tcfg = audio_cfgs()
    pj, pt = audio_params()
    mine = td.init_params(_gen(0), tcfg, device="cpu")
    ref = {k: v.shape for k, v in flatten_params(
        jax.tree.map(np.asarray, pj)).items()}
    got = {k: tuple(v.shape) for k, v in flatten_params(
        tree_map(lambda a: a.numpy(), mine)).items()}
    assert got == ref
    d, ff = tcfg.d_model, tcfg.stages[0].unit[0].ffn.d_ff
    assert ref["backbone/stages/0/0/ffn/w_gate"] == (2, d, ff)
    for n in ("wk", "wv"):
        assert ref[f"backbone/stages/0/0/cross/{n}"] == (2, tcfg.cond_dim, d)
    assert ref["patch_in/w"] == (64, d) and ref["out/w"] == (d, 64)
    flat_t = flatten_params(tree_map(lambda a: a.numpy(), pt))
    flat_j = flatten_params(jax.tree.map(np.asarray, pj))
    assert flat_t.keys() == flat_j.keys()
    assert all(np.array_equal(flat_t[k], flat_j[k]) for k in flat_j)
    # the token weights the linear kernel prepares include the gate
    names = len(td.token_weights(pt))
    assert names == 2 + tcfg.num_layers * (4 + 4 + 3)


def test_audio_latents_are_their_own_tokens():
    cfg, tcfg = audio_cfgs()
    x = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(
        np.float32)
    tok = td.patchify(tcfg, torch.from_numpy(x))
    assert tuple(tok.shape) == (2, 16, 64)
    np.testing.assert_array_equal(np.asarray(jd.patchify(cfg, jnp.asarray(x))),
                                  tok.numpy())
    assert torch.equal(td.unpatchify(tcfg, tok), torch.from_numpy(x))
    with pytest.raises(ValueError, match="patch 1"):
        td.token_shape(tcfg.replace(patch=2))


# ---------------------------------------------------------------------------
# Modules and the forward
# ---------------------------------------------------------------------------

def _block_params(params, part, side):
    p = params["backbone"]["stages"][0][0][part]
    if side == "jax":
        return jax.tree.map(lambda a: a[0], p)
    return tree_map(lambda a: a[0], p)


@pytest.mark.parametrize("route", ["einsum", "pallas"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_attention_matches_reference(kind, route):
    """Self-attention with 1-D RoPE over the 16 latent rows, and
    cross-attention whose k/v read the ``cond_dim``-wide memory; the JAX
    side runs its einsum attention or its Pallas kernel in interpret mode
    (cross-attention takes the einsum there), the port its plain kernel
    route."""
    cfg, tcfg = audio_cfgs()
    pj, pt = audio_params()
    part = "cross" if kind == "cross" else "mixer"
    jspec = getattr(cfg.stages[0].unit[0], part)
    tspec = getattr(tcfg.stages[0].unit[0], part)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    mem = _memory()
    jkw = dict(memory=jnp.asarray(mem)) if kind == "cross" else dict(
        positions=jnp.arange(16)[None, :])
    yj, _ = jattn.apply(jspec, _block_params(pj, part, "jax"),
                        jnp.asarray(x), mode="full",
                        use_flash=route == "pallas", **jkw)
    tkw = dict(memory=torch.from_numpy(mem)) if kind == "cross" else {}
    yt, _ = tattn.apply(tspec, _block_params(pt, part, "torch"),
                        torch.from_numpy(x), **tkw)
    _rel_close(yj, yt)


def test_block_matches_reference():
    """One block (self-attention, cross-attention, gated MLP under adaLN)
    in full, then with its cross and MLP branches read from a cache the
    reference made at another input."""
    cfg, tcfg = audio_cfgs()
    pj, pt = audio_params()
    jspec, tspec = cfg.stages[0].unit[0], tcfg.stages[0].unit[0]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    cond = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    mem = _memory()
    jp = jax.tree.map(lambda a: a[0], pj["backbone"]["stages"][0][0])
    tp = tree_map(lambda a: a[0], pt["backbone"]["stages"][0][0])
    jkw = dict(mode="full", d_model=cfg.d_model, memory=jnp.asarray(mem),
               cond=jnp.asarray(cond), positions=jnp.arange(16)[None, :])
    tkw = dict(memory=torch.from_numpy(mem), cond=torch.from_numpy(cond))
    yj, bj, _, _ = jblocks.apply(jspec, jp, jnp.asarray(x), **jkw)
    yt, bt, _ = tblocks.apply(tspec, tp, torch.from_numpy(x), **tkw)
    _rel_close(yj, yt)
    assert sorted(bj) == sorted(bt) == ["cross", "ffn", "mixer"]
    for name in bj:
        _rel_close(bj[name], bt[name])
    x2 = rng.standard_normal(x.shape).astype(np.float32)
    skip = {"xattn": True, "ffn": True}
    yj, bj, _, _ = jblocks.apply(jspec, jp, jnp.asarray(x2), skip=skip,
                                 branch_cache=bj, **jkw)
    yt, bt, _ = tblocks.apply(tspec, tp, torch.from_numpy(x2), skip=skip,
                              branch_cache=bt, **tkw)
    assert sorted(bt) == sorted(bj) == ["mixer"]
    _rel_close(yj, yt)


@pytest.mark.parametrize("guidance", [None, CFG_SCALE], ids=["no_cfg", "cfg"])
def test_denoiser_matches_reference(guidance):
    """The smoke forward through each executor's model call, every branch
    collected; under CFG the unconditioned half reads a zero memory."""
    cfg, tcfg = audio_cfgs()
    pj, pt = audio_params()
    ej = jex.SmoothCacheExecutor(cfg, jsolvers.dpmpp_3m_sde(STEPS),
                                 cfg_scale=guidance)
    et = tex.SmoothCacheExecutor(tcfg, tsolvers.dpmpp_3m_sde(STEPS),
                                 cfg_scale=guidance, device="cpu")
    x = np.random.default_rng(6).standard_normal((2, 16, 64)).astype(
        np.float32)
    mem = _memory()
    t = np.asarray([999.0, 999.0], np.float32)
    yj, bj = ej._model_call(pj, jnp.asarray(x), jnp.asarray(t), None,
                            jnp.asarray(mem), None, skip=None, collect=True)
    yt, bt = et._model_call(pt, torch.from_numpy(x), torch.from_numpy(t),
                            None, torch.from_numpy(mem), None, skip=None,
                            collect=True)
    _rel_close(yj, yt)
    for name in ("mixer", "cross", "ffn"):
        _rel_close(bj[0][0][name], bt[0][0][name])


# ---------------------------------------------------------------------------
# Whole samples with the reference's noise fed in
# ---------------------------------------------------------------------------

def _reference_noise(key, batch, guidance=CFG_SCALE, steps=STEPS):
    """The reference executor's initial latent and per-step noise for a
    run from ``PRNGKey(key)``."""
    cfg, _ = audio_cfgs()
    ex = jex.SmoothCacheExecutor(cfg, jsolvers.dpmpp_3m_sde(steps),
                                 cfg_scale=guidance)
    x0, kloop = ex.initial_latent(jax.random.PRNGKey(key), batch)
    noise = [np.asarray(jax.random.normal(jax.random.fold_in(kloop, s),
                                          x0.shape, jnp.float32))
             for s in range(steps)]
    return np.array(x0), noise


def _feed(executor, x0, noise):
    """Hand the reference's latent and step noise to the port's executor
    (its two draws, ``initial_latent`` and ``step_noise``)."""
    executor.initial_latent = lambda generator, batch: torch.from_numpy(
        x0.copy())
    executor.step_noise = lambda seed, s, shape: torch.from_numpy(
        noise[s].copy())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX pipeline calibrated under the adaptive policy (its base is
    ``smoothcache:alpha=0.15``) on 2 samples with a memory, and its
    artifact's path."""
    cfg, _ = audio_cfgs()
    pj, _ = audio_params()
    jp = jcache.DiffusionPipeline(cfg, jsolvers.dpmpp_3m_sde(STEPS),
                                  ADAPTIVE, cfg_scale=CFG_SCALE)
    jp.calibrate(pj, jax.random.PRNGKey(1), 2,
                 cond_args={"memory": jnp.asarray(_memory())})
    path = str(tmp_path_factory.mktemp("audio") / "ref.cache.json")
    jp.save_artifact(path)
    return jp, path


def _port_pipe(path=None, policy=ADAPTIVE):
    _, tcfg = audio_cfgs()
    tp = tcache.DiffusionPipeline(tcfg, tsolvers.dpmpp_3m_sde(STEPS),
                                  policy, cfg_scale=CFG_SCALE, device="cpu")
    if path is not None:
        tp.load_artifact(path)
    return tp


def _schedules(jp):
    sj = {"none": None, SMOOTH: jp.schedule_for(SMOOTH),
          "static:n=2": jp.schedule_for("static:n=2")}
    st = {k: None if v is None else tS.Schedule.from_json(v.to_json())
          for k, v in sj.items()}
    return sj, st


def test_calibration_curves_match(reference):
    jp, _ = reference
    _, pt = audio_params()
    tp = _port_pipe()
    _feed(tp.executor, *_reference_noise(1, 2))
    art = tp.calibrate(pt, _gen(0), 2,
                       cond_args={"memory": torch.from_numpy(_memory())})
    ref = jp.artifact
    assert sorted(art.curves) == sorted(ref.curves) == ["attn", "ffn",
                                                        "xattn"]
    for t in ref.curves:
        assert art.curves[t].shape == (STEPS, 4)
        np.testing.assert_allclose(art.curves[t], ref.curves[t], **CURVE_TOL)
        assert np.nanmax(art.curves[t][:, 1]) > 1e-3, t
    assert art.solver == "dpmpp_3m_sde"


def test_smoothcache_schedule_skips(reference):
    jp, _ = reference
    sj, _ = _schedules(jp)
    assert sum(int(v.sum()) for v in sj[SMOOTH].skip.values()) > 0


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["sample_compiled", "sample"])
@pytest.mark.parametrize("spec", ["none", SMOOTH, "static:n=2"])
def test_generate_matches_reference(reference, spec, compiled):
    """A whole 8-step DPM++(3M) SDE sample under CFG 7.0 with a memory,
    the reference's latent and step noise fed in: within 1e-4 of the
    reference's scale, on the eager and the segmented paths."""
    jp, _ = reference
    cfg, _ = audio_cfgs()
    pj, pt = audio_params()
    sj, st = _schedules(jp)
    jpipe = jcache.DiffusionPipeline(cfg, jsolvers.dpmpp_3m_sde(STEPS),
                                     cfg_scale=CFG_SCALE)
    tpipe = _port_pipe(policy="none")
    mem = _memory(7)
    _feed(tpipe.executor, *_reference_noise(9, 2))
    xj = jpipe.generate(pj, jax.random.PRNGKey(9), 2, memory=jnp.asarray(mem),
                        schedule=sj[spec], compiled=compiled)
    xt = tpipe.generate(pt, None, 2, memory=torch.from_numpy(mem),
                        schedule=st[spec], compiled=compiled)
    assert np.isfinite(np.asarray(xj)).all()
    _rel_close(xj, xt, tol=1e-4)


def test_adaptive_generate_takes_the_host_loop(reference):
    """``generate`` under the adaptive policy runs ``sample_adaptive``
    (the solver is not scannable): one decision sync per step past the
    first, the same decisions and latents as the host loop, and the
    reference's decisions on the fed noise."""
    jp, path = reference
    pj, pt = audio_params()
    tp = _port_pipe(path)
    ex = tp.executor
    assert not ex.supports_fused_adaptive and not ex.supports_split
    mem = torch.from_numpy(_memory(8))
    syncs = ex.host_sync_count
    xg, dg = tp.generate(pt, _gen(4), 2, memory=mem, return_decisions=True)
    assert ex.host_sync_count - syncs == STEPS - 1
    xh, dh = ex.sample_adaptive(pt, _gen(4), 2, schedule=tp.schedule,
                                tau=tp.policy.tau, proxy_map=tp.proxy_map,
                                k_max=tp.policy.k_max, memory=mem,
                                return_decisions=True)
    assert torch.equal(xg, xh) and dg == dh
    _feed(ex, *_reference_noise(4, 2))
    xt, dt = tp.generate(pt, None, 2, memory=mem, return_decisions=True)
    xj, djs = jp.generate(pj, jax.random.PRNGKey(4), 2,
                          memory=jnp.asarray(mem.numpy()),
                          return_decisions=True)
    assert dt == tuple(tuple(d) for d in djs)
    _rel_close(xj, xt, tol=1e-4)


def test_refusals_match_reference_messages(reference):
    """The fused path ("not scannable"), ``split_run`` and ``row_keys``
    ("stochastic") refuse a DPM++(3M) run, as in the reference."""
    _, path = reference
    _, pt = audio_params()
    tp = _port_pipe(path)
    ex = tp.executor
    mem = torch.from_numpy(_memory())
    kw = dict(schedule=tp.schedule, tau=tp.policy.tau,
              proxy_map=tp.proxy_map, k_max=tp.policy.k_max, memory=mem)
    with pytest.raises(ValueError, match="not scannable"):
        ex.sample_adaptive_fused(pt, _gen(0), 2, **kw)
    with pytest.raises(ValueError, match="stochastic"):
        ex.start_run(pt, None, 2, plan=ex.plan_for(tp.schedule),
                     memory=mem, row_keys=[_gen(0), _gen(1)])
    rs = ex.start_run(pt, _gen(0), 2, plan=ex.plan_for(tp.schedule),
                      memory=mem)
    with pytest.raises(ValueError, match="stochastic"):
        ex.split_run(rs, [[0], [1]])
    with pytest.raises(ValueError, match="stochastic"):
        ex.merge_runs([rs])


# ---------------------------------------------------------------------------
# The step noise
# ---------------------------------------------------------------------------

def test_step_noise_is_a_function_of_seed_and_step():
    _, tcfg = audio_cfgs()
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.dpmpp_3m_sde(STEPS),
                                 device="cpu")
    a = ex.step_noise(123, 3, (2, 16, 64))
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, 16, 64)
    ex.step_noise(123, 4, (2, 16, 64))
    assert torch.equal(a, ex.step_noise(123, 3, (2, 16, 64)))
    assert not torch.equal(a, ex.step_noise(123, 4, (2, 16, 64)))
    assert not torch.equal(a, ex.step_noise(124, 3, (2, 16, 64)))
    assert 0.9 < float(a.std()) < 1.1
    g = _gen(7)
    seed = ex.noise_seed(g)
    assert 0 <= seed < 1 << 63 and seed == ex.noise_seed(_gen(7))
    assert ex.noise_seed(g) != seed          # the generator moved


@pytest.mark.parametrize("solver", ["ddim", "rectified_flow"])
def test_deterministic_solvers_draw_no_noise(solver):
    """DDIM and rectified flow draw no seed (the generator moves only by
    the latent) and never call ``step_noise``."""
    _, tcfg = audio_cfgs()
    _, pt = audio_params()
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.SOLVERS[solver](3),
                                 device="cpu")

    def refuse(*a):
        raise AssertionError("a deterministic solver drew step noise")

    ex.step_noise = refuse
    g, g_ref = _gen(3), _gen(3)
    ex.initial_latent(g_ref, 1)
    assert ex.noise_seed(g) is None
    mem = torch.from_numpy(_memory(batch=1))
    rs = ex.start_run(pt, g, 1, plan=ex.plan_for(
        tS.no_cache(tcfg.layer_types(), 3)), memory=mem)
    assert rs.noise_seed is None
    assert torch.equal(g.get_state(), g_ref.get_state())
    while not rs.done:
        rs = ex.advance_run(pt, rs)
    ex.sample(pt, _gen(3), 1, memory=mem)


# ---------------------------------------------------------------------------
# Contracts inside the port, bitwise
# ---------------------------------------------------------------------------

def _tmem(seed=11, batch=2):
    return synthetic.text_memory(_gen(seed), batch, MEM_LEN,
                                 audio_cfgs()[1].cond_dim, device="cpu")


def test_segmented_equals_eager(reference):
    jp, _ = reference
    _, pt = audio_params()
    _, st = _schedules(jp)
    tp = _port_pipe()
    mem = _tmem()
    for spec in ("none", SMOOTH, "static:n=2"):
        seg = tp.generate(pt, _gen(3), 2, memory=mem, schedule=st[spec])
        eager = tp.generate(pt, _gen(3), 2, memory=mem, schedule=st[spec],
                            compiled=False)
        assert torch.isfinite(seg).all()
        assert torch.equal(seg, eager), spec
    # the noise matters: another generator, another sample
    other = tp.generate(pt, _gen(4), 2, memory=mem, schedule=st[SMOOTH])
    assert not torch.equal(other, seg)


def test_host_loop_at_tau_0_equals_sample_compiled(reference):
    _, path = reference
    _, pt = audio_params()
    tp = _port_pipe(path)
    ex = tp.executor
    mem = _tmem(12)
    syncs = ex.host_sync_count
    xh, dh = ex.sample_adaptive(pt, _gen(5), 2, schedule=tp.schedule,
                                tau=0.0, memory=mem, return_decisions=True)
    assert ex.host_sync_count == syncs
    xc = ex.sample_compiled(pt, _gen(5), 2, schedule=tp.schedule, memory=mem)
    assert torch.equal(xh, xc)
    assert any(dh), "the schedule skipped nothing"


def _kinds(tp, pt, mem):
    """(start, advance) of the static plan (``static:n=2``: one step per
    segment) and the host loop (one step per advance)."""
    ex = tp.executor
    sch = tp.schedule_for("static:n=2")
    return {
        "plan": (lambda g: ex.start_run(pt, g, 2, plan=ex.plan_for(sch),
                                        schedule=sch, memory=mem),
                 lambda rs: ex.advance_run(pt, rs),
                 lambda ex2: dict(plan=ex2.plan_for(sch))),
        "adaptive": (
            lambda g: ex.start_adaptive_run(
                pt, g, 2, schedule=tp.schedule, tau=tp.policy.tau,
                proxy_map=tp.proxy_map, k_max=tp.policy.k_max, memory=mem),
            lambda rs: ex.advance_adaptive_run(pt, rs),
            lambda ex2: dict(schedule=tp.schedule, tau=tp.policy.tau,
                             proxy_map=tp.proxy_map, k_max=tp.policy.k_max)),
    }


def _drain(advance, rs):
    while not rs.done:
        rs = advance(rs)
    return rs


@pytest.mark.parametrize("kind", ["plan", "adaptive"])
def test_export_import_equals_uninterrupted(reference, tmp_path, kind):
    """Export after 0, 1, 2 and 3 steps → save → restore → import on a
    fresh executor → finish: bitwise the uninterrupted run.  The snapshot
    holds the noise seed and a solver state whose entries go from None to
    tensors over the first three steps."""
    _, path = reference
    _, pt = audio_params()
    tp = _port_pipe(path)
    mem = _tmem(15)
    start, advance, import_kw = _kinds(tp, pt, mem)[kind]
    ref = _drain(advance, start(_gen(30)))
    assert ref.noise_seed is not None
    states = []
    for n in range(4):
        rs = start(_gen(30))
        for _ in range(n):
            rs = advance(rs)
        assert rs.step == n
        k, arrays, static = tp.executor.export_run(rs)
        assert k == kind and static["noise_seed"] == ref.noise_seed
        states.append(tuple(v is not None for v in arrays["state"].values()))
        f = str(tmp_path / f"run{n}.ckpt")
        ckpt_io.save(f, arrays, {"static": static})
        restored, meta = ckpt_io.restore(f)
        assert restored["state"].keys() == rs.state.keys()
        fresh = _port_pipe(path)
        rs2 = fresh.executor.import_run(pt, k, restored, meta["static"],
                                        **import_kw(fresh.executor))
        assert rs2.noise_seed == ref.noise_seed
        for key, v in rs.state.items():
            assert (v is None) == (rs2.state[key] is None), (n, key)
            assert v is None or torch.equal(v, rs2.state[key])
        adv2 = _kinds(fresh, pt, mem)[kind][1]
        assert torch.equal(_drain(adv2, rs2).x, ref.x), n
    assert states == [(False, False, False, False), (True, False, True, False),
                      (True, True, True, True), (True, True, True, True)]


def test_import_refuses_a_snapshot_without_its_noise_seed(reference):
    _, path = reference
    _, pt = audio_params()
    tp = _port_pipe(path)
    ex = tp.executor
    rs = ex.advance_run(pt, ex.start_run(pt, _gen(1), 2,
                                         plan=ex.plan_for(tp.schedule),
                                         memory=_tmem()))
    kind, arrays, static = ex.export_run(rs)
    static = {k: v for k, v in static.items() if k != "noise_seed"}
    with pytest.raises(ValueError, match="noise_seed"):
        ex.import_run(pt, kind, arrays, static, plan=ex.plan_for(tp.schedule))


# ---------------------------------------------------------------------------
# Serving with prompts over a stochastic solver
# ---------------------------------------------------------------------------

ENCODER = functools.partial(synthetic.prompt_memory, length=MEM_LEN,
                            dim=64, device="cpu")


def test_prompt_memory_rows_follow_their_prompt():
    a = ENCODER(["a dog barks", "rain on a roof"])
    b = ENCODER(["rain on a roof"])
    assert tuple(a.shape) == (2, MEM_LEN, 64)
    assert torch.equal(a[1:], b)
    assert not torch.equal(a[0], a[1])
    assert 0.015 < float(a.std()) < 0.025


def test_cond_latents_and_memory_for_audio_latents():
    """``CondLatents`` and ``text_memory`` at (L, C) latents and the
    slice's 128-token memory: shapes, determinism per (seed, step)."""
    _, tcfg = audio_cfgs()
    m = synthetic.text_memory(_gen(0), 2, 128, tcfg.cond_dim, device="cpu")
    assert tuple(m.shape) == (2, 128, tcfg.cond_dim)
    data = synthetic.CondLatents(tcfg.latent_shape, tcfg.cond_dim, 128,
                                 batch=2, seed=4)
    x0, mem = data.batch_at(0, device="cpu")
    assert tuple(x0.shape) == (2, 16, 64)
    assert tuple(mem.shape) == (2, 128, tcfg.cond_dim)
    again, _ = data.batch_at(0, device="cpu")
    other, _ = data.batch_at(1, device="cpu")
    assert torch.equal(x0, again) and not torch.equal(x0, other)
    assert bool(torch.isfinite(x0).all())


def _store(path):
    _, tcfg = audio_cfgs()
    store = serve.ArtifactStore(tcfg, tsolvers.dpmpp_3m_sde(STEPS),
                                cfg_scale=CFG_SCALE)
    store.add_policy("static2", "static:n=2")
    store.add_artifact("adaptive", path)
    return store


def _requests(n=4):
    return [serve.Request(rid=i, seed=100 + i,
                          policy="adaptive" if i % 2 else "static2",
                          prompt=f"prompt {i}", arrival=0.0)
            for i in range(n)]


def _engine(path, **kw):
    _, tcfg = audio_cfgs()
    _, pt = audio_params()
    ex = tex.SmoothCacheExecutor(tcfg, tsolvers.dpmpp_3m_sde(STEPS),
                                 cfg_scale=CFG_SCALE, device="cpu")
    eng = serve.ServeEngine(ex, pt, _store(path), max_batch=2,
                            max_inflight=2, clock=serve.VirtualClock(),
                            check=True, adaptive_chunk=2,
                            text_encoder=ENCODER, **kw)
    return eng, ex


def _replay(path, rec):
    _, pt = audio_params()
    entry_policy = ADAPTIVE if rec.group == "adaptive" else "static:n=2"
    tp = _port_pipe(path if rec.group == "adaptive" else None, entry_policy)
    return tp.generate(pt, serve.batch_generator(rec.seeds), rec.bucket,
                       memory=ENCODER(list(rec.prompts)))


@pytest.mark.parametrize("continuous", [False, True])
def test_served_equals_generate(reference, continuous):
    """4 requests with prompts over a static and an adaptive entry: every
    served batch replays bitwise through ``generate`` with
    ``batch_generator(seeds)`` and the prompts' memory; the adaptive entry
    runs on the host loop; ``continuous=True`` joins nothing (the solver
    is stochastic)."""
    _, path = reference
    eng, ex = _engine(path, continuous=continuous)
    eng.submit(*_requests())
    res = eng.run_until_drained()
    assert sorted(res) == [0, 1, 2, 3]
    assert {r.group for r in eng.records} == {"static2", "adaptive"}
    assert ex.host_sync_count > 0
    assert eng.metrics.joins == 0
    for rec in eng.records:
        assert rec.prompts == tuple(f"prompt {i}" for i in rec.rids)
        want = _replay(path, rec).numpy()
        for j, rid in enumerate(rec.rids):
            np.testing.assert_array_equal(res[rid], want[j])


def test_engine_refuses_prompts_without_an_encoder(reference):
    _, path = reference
    eng, _ = _engine(path)
    eng.text_encoder = None
    eng.submit(*_requests(2))
    with pytest.raises(ValueError, match="text_encoder"):
        eng.run_until_drained()


def test_engine_restore_and_replay_bitwise(reference, tmp_path):
    """Kill an engine with a static and a host-loop batch in flight: a
    fresh engine restores both from snapshots (noise seed and solver
    state included); then, every snapshot tampered, a third engine
    replays the requests from the journal (prompts included).  Every
    latent bitwise the uninterrupted engine's."""
    import test_durable as jdurable
    _, path = reference
    base_eng, _ = _engine(path)
    base_eng.submit(*_requests())
    base = base_eng.run_until_drained()

    jpath = str(tmp_path / "journal.jsonl")
    sdir = str(tmp_path / "snapshots")
    eng, _ = _engine(path, journal=jpath, snapshot_dir=sdir)
    eng.submit(*_requests())
    jdurable._step_until(eng, lambda: len(eng._snapshots.live()) == 2
                         and all(not fl.rs.done and fl.rs.step >= 2
                                 for fl in eng._inflight), limit=12)
    assert {fl.kind for fl in eng._inflight} == {"plan", "adaptive"}
    crash(eng)
    eng2, _ = _engine(path, journal=jpath, snapshot_dir=sdir)
    summary = eng2.recover()
    assert summary["restored_runs"] == 2 and summary["replayed"] == 0
    res = eng2.run_until_drained()
    for rid in base:
        np.testing.assert_array_equal(res[rid], base[rid])

    jpath = str(tmp_path / "journal2.jsonl")
    sdir = str(tmp_path / "snapshots2")
    eng, _ = _engine(path, journal=jpath, snapshot_dir=sdir)
    eng.submit(*_requests())
    jdurable._step_until(eng, lambda: len(eng._snapshots.live()) == 2,
                         limit=12)
    crash(eng)
    for name in os.listdir(sdir):
        p = os.path.join(sdir, name)
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    eng3, _ = _engine(path, journal=jpath, snapshot_dir=sdir)
    summary = eng3.recover()
    assert summary["restored_runs"] == 0 and summary["replayed"] == 4
    res = eng3.run_until_drained()
    for rid in base:
        np.testing.assert_array_equal(res[rid], base[rid])


def test_calibration_wrapper_on_a_stochastic_solver(reference):
    """``calibration.calibrate`` (curves, per-sample curves, x₀) on the
    fed noise against the reference's, at 4 steps."""
    from repro.core import calibration as jcal
    cfg, tcfg = audio_cfgs()
    pj, pt = audio_params()
    ej = jex.SmoothCacheExecutor(cfg, jsolvers.dpmpp_3m_sde(4),
                                 cfg_scale=CFG_SCALE)
    et = tex.SmoothCacheExecutor(tcfg, tsolvers.dpmpp_3m_sde(4),
                                 cfg_scale=CFG_SCALE, device="cpu")
    _feed(et, *_reference_noise(2, 2, steps=4))
    mem = _memory(3)
    cj, sj, xj = jcal.calibrate(ej, pj, jax.random.PRNGKey(2), 2,
                                cond_args={"memory": jnp.asarray(mem)},
                                k_max=2)
    ct, st, xt = tcal.calibrate(et, pt, _gen(0), 2,
                                cond_args={"memory": torch.from_numpy(mem)},
                                k_max=2)
    for t in cj:
        np.testing.assert_allclose(ct[t], cj[t], **CURVE_TOL)
        np.testing.assert_allclose(st[t], sj[t], **CURVE_TOL)
    _rel_close(xj, xt, tol=1e-4)
