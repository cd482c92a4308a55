"""The port's OpenSora-v1.2 text-to-video path against the JAX package's
(opensora-v12 smoke: one spatial/temporal block pair, d 128, 4 heads × 32,
latents (4, 8, 8, 4) = T 4 × S 16 tokens, cond_dim 64, a memory of 8
tokens; rectified flow).  Inputs come from a numpy seed; weights go across
through ``convert.params_from_numpy``.  Tolerance: 5e-5 of the output's
scale in f32; curves at the calibration tests' 1e-4.

Also, torch against torch and bitwise: segmented ≡ eager, fused ≡ host
loop, split/merge rows ≡ solo rows and export → import ≡ an uninterrupted
run, all with a memory; and the pipeline's ``prepare`` / ``summary``,
``CacheArtifact.with_schedule`` and ``calibration.calibrate`` against the
reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, to_np, video_cfgs, video_params
from repro import cache as jcache
from repro.core import calibration as jcal, diffusion as jd
from repro.core import solvers as jsolvers
from repro.models import attention as jattn, blocks as jblocks
from repro.models import layers as jL
from repro_torch import cache as tcache
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import calibration as tcal, diffusion as td
from repro_torch.core import plan as tplan, schedule as tS
from repro_torch.core import solvers as tsolvers
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn, blocks as tblocks
from repro_torch.models import layers as tL
from repro_torch.models.transformer import tree_map

STEPS = 8
CFG_SCALE = 7.0
ADAPTIVE = "adaptive:base=smoothcache(alpha=0.1),tau=0.3"
SMOOTH = "smoothcache:alpha=0.1"
CURVE_TOL = dict(rtol=1e-4, atol=1e-7)
MARGIN = 1e-4          # decisions may differ inside |acc + delta − τ| ≤ 1e-4
MEM_LEN = 8


def _rel_close(a, b, tol=5e-5):
    """Max abs difference within ``tol`` of the reference's scale."""
    a, b = to_np(a), to_np(b)
    scale = float(np.abs(a).max())
    assert scale > 1e-3, "parity must not be vacuous"
    np.testing.assert_allclose(b, a, atol=tol * scale, rtol=0)


def _memory(seed=5, batch=2, length=MEM_LEN):
    cfg, _ = video_cfgs()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, length, cfg.cond_dim)).astype(
        np.float32)


def _latent(seed, batch=2):
    cfg, _ = video_cfgs()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch,) + tuple(cfg.latent_shape)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Config
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
    jc = jconfigs.get("opensora-v12", variant)
    tc = tconfigs.get("opensora-v12", variant)
    assert tc.layer_types() == jc.layer_types() == (
        "s_attn", "s_xattn", "s_ffn", "t_attn", "t_xattn", "t_ffn")
    for f in ("name", "d_model", "task", "latent_shape", "patch", "cond_dim",
              "norm", "num_classes", "dtype", "num_layers"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [b[:3] for b in tc.blocks()] == [b[:3] for b in jc.blocks()]
    for (_, _, _, tb), (_, _, _, jb) in zip(tc.blocks(), jc.blocks()):
        assert tb.branch_names() == jb.branch_names() == (
            "mixer", "cross", "ffn")
        assert tb.branch_types() == jb.branch_types()
        for part in ("mixer", "cross", "ffn"):
            assert _spec_fields(getattr(tb, part)) == _spec_fields(
                getattr(jb, part)), part
        assert (tb.norm, tb.adaln, tb.type_tag) == (jb.norm, jb.adaln,
                                                    jb.type_tag)
    assert td.token_shape(tc) == jd.token_shape(jc)


def test_param_tree_matches_reference():
    """The port's own init makes the reference's tree (``norm_x``,
    ``cross`` with ``cond_dim``-wide k/v, stage units of two blocks), so
    ``convert`` carries the reference's weights across leaf by leaf."""
    from repro_torch.convert import flatten_params
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    mine = td.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    ref = {k: v.shape for k, v in flatten_params(
        jax.tree.map(np.asarray, pj)).items()}
    got = {k: tuple(v.shape) for k, v in flatten_params(
        tree_map(lambda a: a.numpy(), mine)).items()}
    assert got == ref
    assert ref["backbone/stages/0/0/cross/wk"] == (1, tcfg.cond_dim,
                                                   tcfg.d_model)
    flat_t = flatten_params(tree_map(lambda a: a.numpy(), pt))
    flat_j = flatten_params(jax.tree.map(np.asarray, pj))
    assert flat_t.keys() == flat_j.keys()
    assert all(np.array_equal(flat_t[k], flat_j[k]) for k in flat_j)


def test_patchify_roundtrip_matches():
    cfg, tcfg = video_cfgs()
    x = _latent(0)
    tok = td.patchify(tcfg, torch.from_numpy(x))
    close(jd.patchify(cfg, jnp.asarray(x)), tok, atol=0, rtol=0)
    assert torch.equal(td.unpatchify(tcfg, tok), torch.from_numpy(x))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_apply_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16)[None, :]
    close(jL.rope_freqs(32), tL.rope_freqs(32), atol=0, rtol=1e-7)
    for theta in (10000.0, 500.0):
        _rel_close(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
                   tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta))


def _block_params(params, bi, part, side):
    p = params["backbone"]["stages"][0][bi][part]
    if side == "jax":
        return jax.tree.map(lambda a: a[0], p)
    return tree_map(lambda a: a[0], p)


@pytest.mark.parametrize("route", ["einsum", "pallas"])
@pytest.mark.parametrize("kind", ["spatial", "temporal", "cross"])
def test_attention_matches_reference(kind, route):
    """The JAX side runs its einsum attention (``use_flash=False``) or its
    Pallas kernel in interpret mode (cross-attention takes the einsum on
    both routes there); the port's runs its plain kernel route."""
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    bi = 0 if kind == "spatial" else 1
    part = "cross" if kind == "cross" else "mixer"
    jspec = getattr(cfg.stages[0].unit[bi], part)
    tspec = getattr(tcfg.stages[0].unit[bi], part)
    _, _, video_shape = jd.token_shape(cfg)
    x = np.random.default_rng(2).standard_normal(
        (2, video_shape[0] * video_shape[1], cfg.d_model)).astype(np.float32)
    mem = _memory()
    kw = dict(memory=jnp.asarray(mem)) if kind == "cross" else dict(
        video_shape=video_shape)
    yj, _ = jattn.apply(jspec, _block_params(pj, bi, part, "jax"),
                        jnp.asarray(x), mode="full",
                        use_flash=route == "pallas", **kw)
    tkw = dict(memory=torch.from_numpy(mem)) if kind == "cross" else dict(
        video_shape=video_shape)
    yt, _ = tattn.apply(tspec, _block_params(pt, bi, part, "torch"),
                        torch.from_numpy(x), **tkw)
    _rel_close(yj, yt)


@pytest.mark.parametrize("lq,lk,h", [(16, 16, 4), (4, 4, 4), (16, 8, 4),
                                     (33, 11, 2)])
def test_sdpa_oracle_matches_plain_kernel_route(lq, lk, h):
    """The port's einsum ``_sdpa`` (the reference's cross-attention route)
    against ``ops.flash_attention``'s plain version at the video shapes,
    non-causal, with a key count unlike the query count (cross)."""
    rng = np.random.default_rng(lq * lk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, lq, h, 32), (3, lk, h, 32), (3, lk, h, 32)))
    bias = torch.zeros(3, lq, lk)
    want = tattn._sdpa(q, k, v, bias, softcap=None, scale=32 ** -0.5)
    got = ops.flash_attention(q, k, v, causal=False, scale=32 ** -0.5)
    _rel_close(want, got)


def _cond(seed=3):
    cfg, _ = video_cfgs()
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("bi", [0, 1], ids=["spatial", "temporal"])
def test_block_matches_reference(bi):
    """One block, computed in full and then with its cross branch read
    from a cache the reference made at another input."""
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    jspec, tspec = cfg.stages[0].unit[bi], tcfg.stages[0].unit[bi]
    _, _, vs = jd.token_shape(cfg)
    rng = np.random.default_rng(4 + bi)
    x = rng.standard_normal((2, vs[0] * vs[1], cfg.d_model)).astype(
        np.float32)
    mem, cond = _memory(), _cond()
    jp = jax.tree.map(lambda a: a[0], pj["backbone"]["stages"][0][bi])
    tp = tree_map(lambda a: a[0], pt["backbone"]["stages"][0][bi])
    jkw = dict(mode="full", d_model=cfg.d_model, memory=jnp.asarray(mem),
               cond=jnp.asarray(cond), video_shape=vs)
    tkw = dict(memory=torch.from_numpy(mem), cond=torch.from_numpy(cond),
               video_shape=vs)
    yj, bj, _, _ = jblocks.apply(jspec, jp, jnp.asarray(x), **jkw)
    yt, bt, _ = tblocks.apply(tspec, tp, torch.from_numpy(x), **tkw)
    _rel_close(yj, yt)
    assert sorted(bj) == sorted(bt) == ["cross", "ffn", "mixer"]
    for name in bj:
        _rel_close(bj[name], bt[name])
    x2 = rng.standard_normal(x.shape).astype(np.float32)
    skip = {jspec.type_tag + "xattn": True}
    yj, bj, _, _ = jblocks.apply(jspec, jp, jnp.asarray(x2), skip=skip,
                                 branch_cache=bj, **jkw)
    yt, bt, _ = tblocks.apply(tspec, tp, torch.from_numpy(x2), skip=skip,
                              branch_cache=bt, **tkw)
    assert "cross" not in bt and "cross" not in bj
    _rel_close(yj, yt)


@pytest.mark.parametrize("guidance", [None, CFG_SCALE], ids=["no_cfg", "cfg"])
def test_denoiser_with_memory_matches(guidance):
    """``diffusion.apply`` with a memory, through each executor's model
    call (under CFG the unconditioned half reads a zero memory), with
    every branch collected."""
    from repro.core import executor as jex
    from repro_torch.core import executor as tex
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    ej = jex.SmoothCacheExecutor(cfg, jsolvers.rectified_flow(STEPS),
                                 cfg_scale=guidance)
    et = tex.SmoothCacheExecutor(tcfg, tsolvers.rectified_flow(STEPS),
                                 cfg_scale=guidance, device="cpu")
    x, mem = _latent(6), _memory()
    t = np.asarray([875.0, 875.0], np.float32)
    yj, bj = ej._model_call(pj, jnp.asarray(x), jnp.asarray(t), None,
                            jnp.asarray(mem), None, skip=None, collect=True)
    yt, bt = et._model_call(pt, torch.from_numpy(x), torch.from_numpy(t),
                            None, torch.from_numpy(mem), None, skip=None,
                            collect=True)
    _rel_close(yj, yt)
    for bi in range(2):
        for name in ("mixer", "cross", "ffn"):
            _rel_close(bj[0][bi][name], bt[0][bi][name])
    # the memory matters
    y0, _ = et._model_call(pt, torch.from_numpy(x), torch.from_numpy(t),
                           None, torch.zeros(2, MEM_LEN, tcfg.cond_dim),
                           None, skip=None, collect=False)
    assert not torch.allclose(y0, yt)


# ---------------------------------------------------------------------------
# Pipeline against the reference
# ---------------------------------------------------------------------------

def _x0(key, batch=2, guidance=CFG_SCALE):
    from repro.core import executor as jex
    cfg, _ = video_cfgs()
    ex = jex.SmoothCacheExecutor(cfg, jsolvers.rectified_flow(STEPS),
                                 cfg_scale=guidance)
    return np.array(ex.initial_latent(jax.random.PRNGKey(key), batch)[0])


def _feed(executor, x0):
    """Torch cannot draw JAX's noise: hand the reference's latent over."""
    executor.initial_latent = lambda generator, batch: torch.from_numpy(
        x0.copy())


def _port_pipe(path):
    """A fresh port pipeline under the adaptive policy, loaded from the
    reference's artifact."""
    _, tcfg = video_cfgs()
    tp = tcache.DiffusionPipeline(tcfg, tsolvers.rectified_flow(STEPS),
                                  ADAPTIVE, cfg_scale=CFG_SCALE,
                                  device="cpu")
    tp.load_artifact(path)
    return tp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX pipeline calibrated under the adaptive policy (its base is
    the SmoothCache schedule) on 2 samples with a memory, its artifact,
    and the port's pipeline loaded from it (tests that feed it the
    reference's latents take a fresh one, ``_port_pipe``)."""
    cfg, tcfg = video_cfgs()
    pj, _ = video_params()
    jp = jcache.DiffusionPipeline(cfg, jsolvers.rectified_flow(STEPS),
                                  ADAPTIVE, cfg_scale=CFG_SCALE)
    jp.calibrate(pj, jax.random.PRNGKey(1), 2,
                 cond_args={"memory": jnp.asarray(_memory())})
    path = str(tmp_path_factory.mktemp("video") / "ref.cache.json")
    jp.save_artifact(path)
    return jp, _port_pipe(path), path


def test_calibration_curves_match(reference):
    jp, _, _ = reference
    _, tcfg = video_cfgs()
    _, pt = video_params()
    tp = tcache.DiffusionPipeline(tcfg, tsolvers.rectified_flow(STEPS),
                                  ADAPTIVE, cfg_scale=CFG_SCALE,
                                  device="cpu")
    _feed(tp.executor, _x0(1))
    art = tp.calibrate(pt, torch.Generator(), 2,
                       cond_args={"memory": torch.from_numpy(_memory())})
    ref = jp.artifact
    assert sorted(art.curves) == sorted(ref.curves) == sorted(
        tcfg.layer_types())
    for t in ref.curves:
        assert art.curves[t].shape == (STEPS, 4)
        np.testing.assert_allclose(art.curves[t], ref.curves[t], **CURVE_TOL)
        assert np.nanmax(art.curves[t][:, 1]) > 1e-3, t
    assert art.meta["calib_cfg_half"] == "cond"


def _schedules(jp):
    sj = {"none": None, SMOOTH: jp.schedule_for(SMOOTH),
          "static:n=2": jp.schedule_for("static:n=2")}
    st = {k: None if v is None else tS.Schedule.from_json(v.to_json())
          for k, v in sj.items()}
    return sj, st


def test_smoothcache_schedule_skips(reference):
    jp, _, _ = reference
    sj, _ = _schedules(jp)
    sch = sj[SMOOTH]
    skipped = {t: int(v.sum()) for t, v in sch.skip.items()}
    assert sum(skipped.values()) > 0, skipped


@pytest.mark.parametrize("guidance", [CFG_SCALE, None], ids=["cfg", "no_cfg"])
@pytest.mark.parametrize("spec", ["none", SMOOTH, "static:n=2"])
def test_generate_matches_reference(reference, spec, guidance):
    jp, _, _ = reference
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    sj, st = _schedules(jp)
    jpipe = jcache.DiffusionPipeline(cfg, jsolvers.rectified_flow(STEPS),
                                     cfg_scale=guidance)
    tpipe = tcache.DiffusionPipeline(tcfg, tsolvers.rectified_flow(STEPS),
                                     cfg_scale=guidance, device="cpu")
    mem = _memory(7)
    _feed(tpipe.executor, _x0(9, guidance=guidance))
    xj = jpipe.generate(pj, jax.random.PRNGKey(9), 2, memory=jnp.asarray(mem),
                        schedule=sj[spec])
    xt = tpipe.generate(pt, None, 2, memory=torch.from_numpy(mem),
                        schedule=st[spec])
    assert np.isfinite(np.asarray(xj)).all()
    _rel_close(xj, xt)


def _margin(rs):
    proxy = tcal.rel_l1_change_rows(rs.x, rs.x_prev)
    delta = torch.clamp_min(rs.coeff_a * proxy[:, None]
                            + rs.coeff_b[None, :], 0.0)
    return float((rs.acc + delta - rs.tau).abs().min())


def test_adaptive_host_loop_matches_reference(reference):
    """Step by step: the accumulators within 5e-5, the decisions equal on
    every step whose margin exceeds 1e-4, and at least one clear skip."""
    jp, _, path = reference
    tp = _port_pipe(path)
    pj, pt = video_params()
    ej, et = jp.executor, tp.executor
    _feed(et, _x0(4))
    mem = _memory(8)
    kw = dict(tau=jp.policy.tau, k_max=jp.policy.k_max)
    rj = ej.start_adaptive_run(pj, jax.random.PRNGKey(4), 2,
                               schedule=jp.schedule, proxy_map=jp.proxy_map,
                               memory=jnp.asarray(mem), **kw)
    rt = et.start_adaptive_run(pt, None, 2, schedule=tp.schedule,
                               proxy_map=tp.proxy_map,
                               memory=torch.from_numpy(mem), **kw)
    clear_skips = 0
    while not rt.done:
        margin = _margin(rt) if rt.step > 0 else None
        rj = ej.advance_adaptive_run(pj, rj)
        rt = et.advance_adaptive_run(pt, rt)
        np.testing.assert_allclose(rt.acc.numpy(), np.asarray(rj.acc),
                                   atol=5e-5, rtol=0)
        if margin is not None and margin > MARGIN:
            assert rt.decisions[-1] == rj.decisions[-1], rt.step
            clear_skips += bool(rt.decisions[-1])
    assert clear_skips >= 1, "no step skipped with a clear margin"
    assert rt.decisions == rj.decisions
    _rel_close(rj.x, rt.x)


# ---------------------------------------------------------------------------
# Contracts inside the port, bitwise
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tmem(seed=11, batch=2):
    return synthetic.text_memory(_gen(seed), batch, MEM_LEN,
                                 video_cfgs()[1].cond_dim, device="cpu")


def test_segmented_equals_eager(reference):
    jp, tp, _ = reference
    _, pt = video_params()
    _, st = _schedules(jp)
    mem = _tmem()
    for spec in (SMOOTH, "static:n=2"):
        seg = tp.generate(pt, _gen(3), 2, memory=mem, schedule=st[spec])
        eager = tp.generate(pt, _gen(3), 2, memory=mem, schedule=st[spec],
                            compiled=False)
        assert torch.isfinite(seg).all()
        assert torch.equal(seg, eager), spec


def test_fused_equals_host_loop(reference):
    """The adaptive pipeline's fused route against the host loop: latents
    and decisions bitwise, the memory a buffer of the fused step."""
    _, tp, _ = reference
    _, pt = video_params()
    ex = tp.executor
    mem = _tmem(12)
    kw = dict(schedule=tp.schedule, tau=tp.policy.tau,
              proxy_map=tp.proxy_map, k_max=tp.policy.k_max, memory=mem,
              return_decisions=True)
    xf, df = ex.sample_adaptive_fused(pt, _gen(5), 2, **kw)
    syncs = ex.host_sync_count
    xh, dh = ex.sample_adaptive(pt, _gen(5), 2, **kw)
    assert ex.host_sync_count - syncs == STEPS - 1
    assert torch.equal(xf, xh) and df == dh
    assert any(df), "the adaptive run skipped nothing"
    xg, dg = tp.generate(pt, _gen(5), 2, memory=mem, return_decisions=True)
    assert torch.equal(xg, xf) and dg == df
    # another memory, same graph: the step reads the buffer
    graphs = len(ex.fused_graphs())
    xm = ex.sample_adaptive_fused(pt, _gen(5), 2, **dict(kw, memory=_tmem(13),
                                  return_decisions=False))
    assert len(ex.fused_graphs()) == graphs and not torch.equal(xm, xf)


def _run_kinds(tp, pt, mem, n, base):
    """Start and advance of each run kind; every start draws from fresh
    generators (a generator's state moves as it draws)."""
    ex = tp.executor
    sch = tp.schedule

    def kw():
        return dict(schedule=sch, tau=tp.policy.tau, proxy_map=tp.proxy_map,
                    k_max=tp.policy.k_max, memory=mem,
                    row_keys=[_gen(base + i) for i in range(n)])

    return {
        "plan": (lambda: ex.start_run(
            pt, None, n, plan=ex.plan_for(sch), schedule=sch, memory=mem,
            row_keys=[_gen(base + i) for i in range(n)]),
            lambda rs: ex.advance_run(pt, rs)),
        "adaptive": (lambda: ex.start_adaptive_run(pt, None, n, **kw()),
                     lambda rs: ex.advance_adaptive_run(pt, rs)),
        "adaptive_fused": (
            lambda: ex.start_adaptive_fused_run(pt, None, n, **kw()),
            lambda rs: ex.advance_adaptive_fused(pt, rs, n_steps=3)),
    }


def _drain(advance, rs):
    while not rs.done:
        rs = advance(rs)
    return rs


@pytest.mark.parametrize("kind", ["plan", "adaptive", "adaptive_fused"])
def test_split_merge_rows_equal_solo_rows(reference, kind):
    """A run split one boundary in: each row finishes bitwise as its solo
    run (its own generator, its own memory row), and split → advance →
    merge gives the unsplit run's rows."""
    _, tp, _ = reference
    _, pt = video_params()
    ex = tp.executor
    mem = _tmem(14)
    start, advance = _run_kinds(tp, pt, mem, 2, 200)[kind]
    whole = _drain(advance, start())
    rs = advance(start())
    subs = [_drain(advance, s) for s in ex.split_run(rs, [[0], [1]])]
    assert torch.equal(ex.merge_runs(subs).x, whole.x)
    for i in range(2):
        solo_start, _ = _run_kinds(tp, pt, mem[i:i + 1], 1, 200 + i)[kind]
        solo = _drain(advance, solo_start())
        assert torch.equal(subs[i].x, solo.x), i
        assert torch.equal(subs[i].memory, mem[i:i + 1])


@pytest.mark.parametrize("kind", ["plan", "adaptive", "adaptive_fused"])
def test_export_import_equals_uninterrupted(reference, tmp_path, kind):
    """Export one boundary in → save → restore → import on a fresh
    executor → finish: bitwise the uninterrupted run; the memory and the
    solver state ride in the snapshot."""
    _, tp, path = reference
    _, pt = video_params()
    mem = _tmem(15)
    start, advance = _run_kinds(tp, pt, mem, 2, 300)[kind]
    ref = _drain(advance, start())
    rs = advance(start())
    k, arrays, static = tp.executor.export_run(rs)
    assert k == kind and arrays["state"] == {}
    assert torch.equal(arrays["memory"], mem)
    ckpt_io.save(str(tmp_path / "run.ckpt"), arrays, {"static": static})
    restored, meta = ckpt_io.restore(str(tmp_path / "run.ckpt"))
    fresh = _port_pipe(path)
    ex2 = fresh.executor
    import_kw = (dict(plan=ex2.plan_for(fresh.schedule)) if kind == "plan"
                 else dict(schedule=fresh.schedule, tau=fresh.policy.tau,
                           proxy_map=fresh.proxy_map,
                           k_max=fresh.policy.k_max))
    rs2 = ex2.import_run(pt, k, restored, meta["static"], **import_kw)
    assert torch.equal(rs2.memory, mem) and rs2.state == {}
    adv2 = _run_kinds(fresh, pt, mem, 2, 300)[kind][1]
    rs2 = _drain(adv2, rs2)
    assert torch.equal(rs2.x, ref.x)


# ---------------------------------------------------------------------------
# The cache API's leftovers against the reference
# ---------------------------------------------------------------------------

def test_prepare_and_summary_match(reference):
    jp, _, path = reference
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    # calibration-free: prepare resolves without calibrating
    jpipe = jcache.DiffusionPipeline(cfg, jsolvers.rectified_flow(STEPS),
                                     "static:n=3")
    tpipe = tcache.DiffusionPipeline(tcfg, tsolvers.rectified_flow(STEPS),
                                     "static:n=3", device="cpu")
    assert tpipe.summary() == jpipe.summary()
    assert tpipe.prepare().to_json() == jpipe.prepare().to_json()
    assert tpipe.summary() == jpipe.summary()
    assert tpipe.plan.to_json() == jpipe.plan.to_json()
    # a loaded artifact: prepare re-resolves from its curves
    jpipe = jcache.DiffusionPipeline(cfg, jsolvers.rectified_flow(STEPS),
                                     SMOOTH, cfg_scale=CFG_SCALE)
    tpipe = tcache.DiffusionPipeline(tcfg, tsolvers.rectified_flow(STEPS),
                                     SMOOTH, cfg_scale=CFG_SCALE,
                                     device="cpu")
    with pytest.raises(ValueError, match="calibration"):
        tpipe.prepare()
    jpipe.artifact = jp.artifact
    tpipe.artifact = tcache.CacheArtifact.load(path)
    assert tpipe.prepare().to_json() == jpipe.prepare().to_json()
    assert tpipe.summary() == jpipe.summary()


def test_prepare_calibrates_when_needed(reference):
    """No artifact and a calibrating policy: prepare runs calibrate."""
    jp, _, _ = reference
    _, tcfg = video_cfgs()
    _, pt = video_params()
    tpipe = tcache.DiffusionPipeline(tcfg, tsolvers.rectified_flow(STEPS),
                                     SMOOTH, cfg_scale=CFG_SCALE,
                                     device="cpu")
    _feed(tpipe.executor, _x0(1))
    sch = tpipe.prepare(pt, torch.Generator(), calib_batch=2,
                        cond_args={"memory": torch.from_numpy(_memory())})
    assert tpipe.artifact is not None and sch is tpipe.schedule
    for t, c in jp.artifact.curves.items():
        np.testing.assert_allclose(tpipe.artifact.curves[t], c, **CURVE_TOL)


def test_with_schedule_matches(reference):
    jp, _, path = reference
    art = tcache.CacheArtifact.load(path)
    sj, st = _schedules(jp)
    got = art.with_schedule(st["static:n=2"])
    want = jp.artifact.with_schedule(sj["static:n=2"])
    assert got.to_json() == want.to_json()
    assert got.schedule.to_json() == st["static:n=2"].to_json()
    assert art.schedule.to_json() != got.schedule.to_json()


def test_calibration_calibrate_wrapper_matches(reference):
    from repro.core import executor as jex
    from repro_torch.core import executor as tex
    cfg, tcfg = video_cfgs()
    pj, pt = video_params()
    ej = jex.SmoothCacheExecutor(cfg, jsolvers.rectified_flow(4),
                                 cfg_scale=CFG_SCALE)
    et = tex.SmoothCacheExecutor(tcfg, tsolvers.rectified_flow(4),
                                 cfg_scale=CFG_SCALE, device="cpu")
    x0 = np.array(ej.initial_latent(jax.random.PRNGKey(2), 2)[0])
    _feed(et, x0)
    mem = _memory(3)
    cj, sj, xj = jcal.calibrate(ej, pj, jax.random.PRNGKey(2), 2,
                                cond_args={"memory": jnp.asarray(mem)},
                                k_max=2)
    ct, st, xt = tcal.calibrate(et, pt, torch.Generator(), 2,
                                cond_args={"memory": torch.from_numpy(mem)},
                                k_max=2)
    for t in cj:
        np.testing.assert_allclose(ct[t], cj[t], **CURVE_TOL)
        np.testing.assert_allclose(st[t], sj[t], **CURVE_TOL)
    _rel_close(xj, xt)


# ---------------------------------------------------------------------------
# Synthetic conditioning
# ---------------------------------------------------------------------------

def test_text_memory_and_cond_latents():
    m = synthetic.text_memory(_gen(0), 2, 300, 64, device="cpu")
    assert m.shape == (2, 300, 64) and m.dtype == torch.float32
    assert torch.equal(m, synthetic.text_memory(_gen(0), 2, 300, 64,
                                                device="cpu"))
    assert 0.015 < float(m.std()) < 0.025
    _, tcfg = video_cfgs()
    data = synthetic.CondLatents(tcfg.latent_shape, tcfg.cond_dim, MEM_LEN,
                                 batch=2, seed=4)
    x0, mem = data.batch_at(0, device="cpu")
    assert x0.shape == (2,) + tuple(tcfg.latent_shape)
    assert mem.shape == (2, MEM_LEN, tcfg.cond_dim)
    x1, _ = data.batch_at(1, device="cpu")
    again, _ = data.batch_at(0, device="cpu")
    assert torch.equal(x0, again) and not torch.equal(x0, x1)
    assert bool(torch.isfinite(x0).all())


def test_plan_sees_the_six_types(reference):
    """Liveness and signatures over the six video types: the SmoothCache
    plan's live types are exactly the types the schedule ever skips."""
    jp, _, _ = reference
    _, st = _schedules(jp)
    sch = st[SMOOTH]
    plan = tplan.analyze(sch)
    skipped = {t for t, v in sch.skip.items() if v.any()}
    assert set(plan.live_types()) == skipped
