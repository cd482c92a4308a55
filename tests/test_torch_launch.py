"""The port's launch half against the JAX package's: ``SHAPES``, the
programs' meta-device input structs (``input_specs``, ``params_struct``,
``opt_struct``), ``count_params`` / ``active_params`` /
``meta_params_bytes``, ``plan.branch_cache_type_bytes``,
``SmoothCacheExecutor.build_sampler_fn`` (its samples against the
reference's and the port's own ``sample``), ``Roofline`` and
``model_flops_estimate``; and ``dryrun.run_combo`` on every smoke config
at every shape.  Full configs go through ``jax.eval_shape`` on the JAX
side and the meta device on the port's: nothing full-size is allocated.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from repro import configs as jconfigs
from repro.config import SHAPES as JSHAPES
from repro.core import executor as jex, plan as jplan, schedule as jS
from repro.core import solvers as jsolvers
from repro.launch import programs as jprograms, roofline as jroofline
from repro_torch import configs as tconfigs
from repro_torch.config import SHAPES as TSHAPES
from repro_torch.core import executor as tex, plan as tplan
from repro_torch.core import schedule as tS, solvers as tsolvers
from repro_torch.launch import dryrun, programs as tprograms
from repro_torch.launch import roofline as troofline
from repro_torch.models import transformer as T

ARCHS = sorted(jconfigs.ASSIGNED)
DIFFUSION = [a for a in jconfigs.PAPER_MODELS]


def _reference_dryrun():
    """The JAX package's ``launch/dryrun.py``.  Importing it prepends a
    512-device flag to ``XLA_FLAGS``; bring the CPU backend up first (its
    device count is fixed then) and restore the variable afterwards."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def _shapes(tree):
    """Leaf shapes of a tree, dict keys sorted as JAX orders them."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _shapes(v)]
    return [] if tree is None else [tuple(tree.shape)]


def test_shapes_match_field_for_field():
    assert list(TSHAPES) == list(JSHAPES)
    for name, want in JSHAPES.items():
        assert dataclasses.asdict(TSHAPES[name]) == dataclasses.asdict(want)


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    """Every input's shape (the caches' leaves in JAX's key order: the
    port's KV cache dicts hold k, v, slots in that order, JAX sorts them);
    every tensor on the meta device; tokens int64 (JAX int32), floats
    f32 (JAX bf16)."""
    jcfg = jprograms.adapt_for_shape(jconfigs.get(arch), JSHAPES[shape])
    tcfg = tprograms.adapt_for_shape(tconfigs.get(arch), TSHAPES[shape])
    want = jprograms.input_specs(jcfg, JSHAPES[shape])
    got = tprograms.input_specs(tcfg, TSHAPES[shape])
    assert list(got) == list(want)
    for k in want:
        assert _shapes(got[k]) == [tuple(a.shape)
                                   for a in jax.tree.leaves(want[k])], k
        for a in T.tree_leaves(got[k]):
            assert a.device.type == "meta"
    for k in ("tokens", "targets", "token"):
        if k in got:
            assert got[k].dtype == torch.int64
    for k in ("prefix_embeds", "memory"):
        if k in got:
            assert got[k].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    jdryrun = _reference_dryrun()
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jps, tps = jprograms.params_struct(jcfg), tprograms.params_struct(tcfg)
    assert _shapes(tps) == [tuple(a.shape) for a in jax.tree.leaves(jps)]
    assert all(a.device.type == "meta" and a.dtype == torch.float32
               for a in T.tree_leaves(tps))
    assert dryrun.count_params(tcfg, tps) == jdryrun.count_params(jcfg, jps)
    assert dryrun.active_params(tcfg) == jdryrun.active_params(jcfg)
    # f32 weights: twice the JAX package's bf16 figure
    assert dryrun.meta_params_bytes(tps) == 2 * jdryrun.meta_params_bytes(jps)


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b",
                                  "musicgen-medium"])
def test_opt_struct_has_the_references_leaves(arch):
    jcfg, tcfg = jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")
    want = jprograms.opt_struct(jprograms.params_struct(jcfg))
    got = tprograms.opt_struct(tprograms.params_struct(tcfg))
    assert sorted(got) == sorted(want) == ["mu", "nu", "step"]
    assert tuple(got["step"].shape) == tuple(want["step"].shape) == ()
    for k in ("mu", "nu"):
        assert _shapes(got[k]) == [tuple(a.shape)
                                   for a in jax.tree.leaves(want[k])]
        assert all(a.device.type == "meta" and a.dtype == torch.float32
                   for a in T.tree_leaves(got[k]))


@pytest.mark.parametrize("cfg_doubled", [False, True])
@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", DIFFUSION)
def test_branch_cache_type_bytes_equal_the_reference(arch, variant,
                                                     cfg_doubled):
    for batch in (1, 4):
        assert (tplan.branch_cache_type_bytes(
                    tconfigs.get(arch, variant), batch, dtype_bytes=4,
                    cfg_doubled=cfg_doubled)
                == jplan.branch_cache_type_bytes(
                    jconfigs.get(arch, variant), batch, dtype_bytes=4,
                    cfg_doubled=cfg_doubled))


STEPS = 4


def _schedules(kind, types):
    if kind == "no_cache":
        return jS.no_cache(types, STEPS), tS.no_cache(types, STEPS)
    rng = np.random.default_rng(5)
    curves = {t: rng.uniform(0.0, 0.4, (STEPS, 4)) for t in types}
    return (jS.smoothcache(curves, alpha=0.2, k_max=3),
            tS.smoothcache(curves, alpha=0.2, k_max=3))


@pytest.mark.parametrize("kind", ["no_cache", "smoothcache"])
def test_build_sampler_fn_matches_the_reference(kind):
    """The unrolled sampler on the smoke DiT, converted weights and the
    reference's initial latents, 4 DDIM steps: within 5e-5 of the latent's
    scale (max |x|) of the reference's jitted ``build_sampler_fn``, and
    bitwise the port's own ``sample`` on the same latent (the same ops on
    the same values: a computed branch's output is the same whether the
    step keeps it or not).  The scale, not each element: the smoke DiT's
    latents grow to |x| ~ 340 in 4 steps, and an element near 1 then
    differs by up to 7.3e-5 (``test_torch_sampler.py`` holds 10 steps at
    2e-4 for the same reason)."""
    jcfg, tcfg = smoke_cfgs()
    pj, pt = smoke_params()
    js, ts = _schedules(kind, tcfg.layer_types())
    if kind == "smoothcache":
        assert 0.3 < np.mean([ts.compute_fraction(t) for t in ts.skip]) < 0.9
    ej = jex.SmoothCacheExecutor(jcfg, jsolvers.ddim(STEPS), cfg_scale=1.5)
    et = tex.SmoothCacheExecutor(tcfg, tsolvers.ddim(STEPS), cfg_scale=1.5,
                                 device="cpu")
    x0, _ = ej.initial_latent(jax.random.PRNGKey(2), 2)
    x0 = np.array(x0)
    want = jax.jit(ej.build_sampler_fn(js))(pj, jnp.asarray(x0),
                                            jnp.asarray([3, 7]), None, None)
    lab = torch.tensor([3, 7])
    got = et.build_sampler_fn(ts)(pt, torch.from_numpy(x0.copy()), lab)
    assert np.isfinite(got.numpy()).all()
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 5e-5 * np.abs(want).max()
    et.initial_latent = lambda generator, batch: torch.from_numpy(x0.copy())
    assert torch.equal(got, et.sample(pt, None, 2, schedule=ts, label=lab))


def test_roofline_keys_and_model_flops_equal_the_reference():
    args = ("qwen3-14b", "prefill_32k", "1", 1, 3.0e15, 2.0e11, 0.0, {},
            None, 1.0e15)
    got = troofline.Roofline(*args, flops_by_unit={"3xtf32": 2.0e15,
                                                   "fp32": 1.0e15})
    want = jroofline.Roofline(*args)
    assert sorted(got.to_dict()) == sorted(want.to_dict())
    # one unit's FLOPs over its own peak, summed (H100 SXM: TF32 495,
    # FP32 67 TFLOP/s); bytes over 3.35 TB/s; nothing collective
    assert got.t_compute == pytest.approx(2.0e15 * 3 / 495e12
                                          + 1.0e15 / 67e12, rel=1e-12)
    assert got.t_memory == pytest.approx(2.0e11 / 3.35e12, rel=1e-12)
    assert got.t_collective == 0.0 and got.bottleneck == "compute"
    assert got.useful_flops_ratio == want.useful_flops_ratio
    for n, tok, train in ((14.8e9, 4096 * 256, True), (37e9, 128, False)):
        assert (troofline.model_flops_estimate(n, tok, train)
                == jroofline.model_flops_estimate(n, tok, train))
    for s in (2.5, 0.0123, 4.2e-5):
        assert troofline.fmt_seconds(s) == jroofline.fmt_seconds(s)


@pytest.mark.parametrize("shape", list(TSHAPES))
@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_run_combo_on_every_smoke_config(arch, shape):
    """Each program of each smoke config at each shape's full batch and
    length, on meta.  MoE groups of 256 tokens: 2048 does not divide the
    smoke Llama-4's 32 × (8 + 32768) prefill tokens (the full config's
    256-patch prefix makes 32 × 33024, which it does)."""
    rec = dryrun.run_combo(arch, shape, variant="smoke")
    assert rec["ok"] and rec["chips"] == 1
    for k in ("flops_per_chip", "bytes_per_chip", "model_flops", "params",
              "active_params"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["flops_per_chip"] == pytest.approx(
        sum(rec["flops_by_unit"].values()), rel=1e-12)
    rf = rec["roofline"]
    assert rf["t_compute"] > 0 and rf["t_memory"] > 0
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["peak_bytes"] is None
    assert mem["weights"] == 4 * rec["params"]
    assert mem["fits_one_card"] == (mem["total"] <= 80e9)
    program = TSHAPES[shape].program
    assert (mem["optimizer"] > 0) == (program == "train")
    assert (mem["caches"] > 0) == (program != "train")


def test_dryrun_cli_writes_a_record(tmp_path):
    dryrun.main(["--arch", "internvl2-1b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    import json
    rec = json.loads((tmp_path / "internvl2-1b__long_500k__1.json")
                     .read_text())
    assert rec["ok"] and rec["program"] == "decode" and rec["tokens"] == 1
    assert rec["memory"]["weights"] == 4 * rec["params"]
