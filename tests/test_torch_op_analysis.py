"""``repro_torch.launch.op_analysis`` — FLOPs and bytes of a program
counted on the meta device — against the JAX package's compiled-HLO
counts and the analytic MACs; the kernels' meta stand-ins
(``kernels/ops.py``) and their ``work(...)``, which every bound of the
card script and of ``PERF.md`` §6 reads."""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.core import diffusion, schedule as tS, solvers
from repro_torch.core.executor import SmoothCacheExecutor
from repro_torch.kernels import flash_attention as fa, gemm, ops
from repro_torch.kernels import rglru, ssd
from repro_torch.launch import mesh, op_analysis, programs
from repro_torch.launch.roofline import kernel_bound
from repro_torch.models import transformer as T
from repro_torch.utils import flops as tflops


def test_a_loop_of_seven_products_counts_exactly():
    """The counterpart of ``test_hlo_analyzer_counts_scan_trips``: a
    Python loop unrolls, so each of the 7 products is counted."""
    def f(a, ws):
        for w in ws:
            a = a @ w
        return a
    x = torch.empty(64, 64, device="meta")
    ws = torch.empty(7, 64, 64, device="meta")
    t = op_analysis.analyze(f, x, ws)
    assert t.flops == 7 * 2 * 64 ** 3
    assert t.by_unit == {"fp32": 7 * 2 * 64 ** 3}
    # entry arguments once, each product's result once; the views of ws
    # move nothing
    assert t.bytes == 4 * (64 * 64 + 7 * 64 * 64 + 7 * 64 * 64)
    assert t.coll == {} and t.kernels == {}


def _qwen3_smoke_forward():
    cfg = tconfigs.get("qwen3-14b", "smoke")
    p = programs.params_struct(cfg)
    toks = programs.token_struct(cfg, 2, 64)
    return cfg, (lambda p, t: T.forward(cfg, p, t)[0]), p, toks


def test_a_smoke_forward_counts_near_the_analytic_macs():
    """The counterpart of ``test_analytic_macs_matches_compiled_hlo``:
    the smoke Qwen3 forward over 2 × 64 tokens, counted on meta, against
    ``utils.flops``' analytic count (±20%, the reference's band)."""
    cfg, fn, p, toks = _qwen3_smoke_forward()
    counted = op_analysis.analyze(fn, p, toks)
    per = tflops.model_macs_by_type(cfg, 64)
    analytic = 2 * 2 * (sum(per.values()) + tflops.non_block_macs(cfg, 64))
    assert 0.8 < counted.flops / analytic < 1.25, (counted.flops, analytic)
    # the token products and the attention in kernels (3xTF32), the LM
    # head in cuBLAS f32 (on the FP32 units)
    assert set(counted.by_unit) == {"3xtf32", "fp32"}
    head = 2 * 2 * 64 * cfg.d_model * cfg.vocab_size
    assert counted.by_unit["fp32"] == head
    assert counted.kernels["flash_attention"][0] == cfg.num_layers


def test_the_count_against_the_references_compiled_hlo():
    """The same smoke forward, compiled by XLA from the JAX package
    (smoke size only) and counted by its ``hlo_analysis``.  The port
    counts 0.957 of XLA's: the attention kernel's work is the causal
    triangle it scores (64·65/2 pairs a head), where the JAX forward's
    einsum multiplies the whole 64 × 64 square and masks it.  With the
    square put back the counts are equal."""
    cfg, fn, p, toks = _qwen3_smoke_forward()
    t = op_analysis.analyze(fn, p, toks)
    m = cfg.stages[0].unit[0].mixer
    square = 2 * 2 * m.num_heads * 2 * m.head_dim * 64 * 64 * cfg.num_layers
    counted = t.flops - t.kernels["flash_attention"][1] + square
    jcfg = jconfigs.get("qwen3-14b", "smoke")
    ps = jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0), jcfg))
    txt = jax.jit(lambda p, t: jT.forward(jcfg, p, t)[0]).lower(
        ps, jax.ShapeDtypeStruct((2, 64), jnp.int32)).compile().as_text()
    xla = hlo_analysis.analyze(txt).flops
    assert 0.95 < t.flops / xla < 0.96, t.flops / xla
    assert counted == pytest.approx(xla, rel=1e-12)


def _dit_sampler_flops(schedule, steps):
    cfg = tconfigs.get("dit-xl-256", "smoke")
    with programs.on_meta():
        p = diffusion.init_params(torch.Generator(), cfg, device="meta")
    ex = SmoothCacheExecutor(cfg, solvers.ddim(steps), cfg_scale=1.5,
                             device="meta")
    x = torch.empty((2,) + tuple(cfg.latent_shape), device="meta")
    lab = torch.empty((2,), dtype=torch.int64, device="meta")
    return op_analysis.analyze(ex.build_sampler_fn(schedule), p, x, lab)


def test_cached_over_plain_flops_follow_the_compute_fraction():
    """The counterpart of ``tests/test_system.py:60-72``: the unrolled
    sampler's counted FLOPs under a SmoothCache schedule over the uncached
    one's, within 0.15 of the schedule's mean compute fraction."""
    cfg = tconfigs.get("dit-xl-256", "smoke")
    curves = {t: torch.linspace(0.0, 0.4, 40).reshape(10, 4).numpy()
              for t in cfg.layer_types()}
    sch = tS.smoothcache(curves, alpha=0.3, k_max=3)
    frac = sum(sch.compute_fraction(t) for t in sch.skip) / len(sch.skip)
    assert frac < 0.9
    cached = _dit_sampler_flops(sch, 10)
    plain = _dit_sampler_flops(tS.no_cache(cfg.layer_types(), 10), 10)
    assert cached.flops < plain.flops
    assert abs(cached.flops / plain.flops - frac) <= 0.15
    # and the uncached count is the analytic one's
    want = 2 * 1e12 * tflops.sampler_tmacs(
        cfg, tS.no_cache(cfg.layer_types(), 10), 16, 2, cfg_scale=1.5)
    assert 0.8 < plain.flops / want < 1.25


def test_a_meta_run_launches_nothing():
    before, captured = dict(ops.LAUNCHES), dict(ops.CAPTURED)
    cfg, fn, p, toks = _qwen3_smoke_forward()
    t = op_analysis.analyze(fn, p, toks)
    assert t.kernels["linear"][0] > 0
    assert ops.LAUNCHES == before and ops.CAPTURED == captured
    assert not torch.cuda.is_initialized()
    assert ops.METERS == []


def test_a_meta_train_step_counts_its_backward():
    """The train program on meta: autograd runs there, the kernels'
    backward being their plain versions' gradients (cuBLAS f32 products
    on the card), and AdamW updates the meta weights in place."""
    cfg = tconfigs.get("qwen3-14b", "smoke")
    p = programs.params_struct(cfg)
    toks = programs.token_struct(cfg, 2, 64)
    fwd = op_analysis.analyze(lambda p, t: T.forward(cfg, p, t)[0], p, toks)
    step = programs.make_train_step(cfg, remat=False)
    t = op_analysis.analyze(step, p, programs.opt_struct(p), toks, toks)
    # forward + two products of the same size a product in the backward
    assert 2.8 < t.flops / fwd.flops < 3.2, t.flops / fwd.flops
    assert t.kernels["linear"][0] == fwd.kernels["linear"][0]
    assert t.by_unit["fp32"] > 2 * fwd.by_unit["fp32"]


def test_top_contributors():
    cfg, fn, p, toks = _qwen3_smoke_forward()
    rows = op_analysis.top_contributors(fn, p, toks, n=5, kind="flops")
    assert len(rows) == 5
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    # a token product in the linear kernel first; the LM head, one
    # cuBLAS product, among the five
    assert rows[0][1:] == ("kernel:linear", "(128, 128)", 6)
    assert [r[1:] for r in rows if r[1] == "aten:mm"] == [
        ("aten:mm", "(128, 512)", 1)]
    total = op_analysis.analyze(fn, p, toks)
    every = op_analysis.top_contributors(fn, p, toks, n=10 ** 6,
                                         kind="flops")
    assert math.isclose(sum(r[0] for r in every), total.flops, rel_tol=1e-12)
    assert op_analysis.top_contributors(fn, p, toks, kind="coll") == []
    with pytest.raises(ValueError):
        op_analysis.top_contributors(fn, p, toks, kind="time")


PEAK = mesh.peaks("NVIDIA H100 80GB HBM3")
# each row's work and its bound as PERF.md §6 prints it (ms, NVIDIA H100
# 80GB HBM3 peaks): the kernels' work() keeps every bound there
BOUNDS = [
    ("dit", fa.work(8, 256, 256, 16, 16, 72), "0.0146", "operations"),
    ("dit_bf16", fa.work(8, 256, 256, 16, 16, 72, dtype=torch.bfloat16),
     "0.0056", "bytes"),
    ("video_spatial", fa.work(32, 256, 256, 16, 16, 72), "0.0586",
     "operations"),
    ("video_temporal", fa.work(512, 16, 16, 16, 16, 72), "0.0451", "bytes"),
    ("video_cross", fa.work(2, 4096, 300, 16, 16, 72), "0.0686",
     "operations"),
    ("audio_self", fa.work(2, 216, 216, 24, 24, 64), "0.0035",
     "operations"),
    ("audio_cross", fa.work(2, 216, 128, 24, 24, 64), "0.0025", "bytes"),
    ("qwen3", fa.work(4, 1024, 1024, 40, 8, 128, causal=True), "0.2606",
     "operations"),
    ("gemma2_local", fa.work(2, 4352, 4352, 16, 8, 256, causal=True,
                             window=4096), "1.875", "operations"),
    ("gemma2_global", fa.work(2, 4352, 4352, 16, 8, 256, causal=True),
     "1.881", "operations"),
    ("minicpm3", fa.work(4, 1024, 1024, 40, 40, 96, 64, causal=True),
     "0.1628", "operations"),
    ("deepseek3", fa.work(4, 1024, 1024, 128, 128, 192, 128, causal=True),
     "1.042", "operations"),
    ("recurrentgemma", fa.work(2, 3072, 3072, 10, 1, 256, causal=True,
                               window=2048), "0.5207", "operations"),
    ("musicgen", fa.work(4, 1024, 1024, 24, 24, 64, causal=True), "0.0782",
     "operations"),
    ("musicgen_cross", fa.work(4, 1024, 64, 24, 24, 64), "0.0160", "bytes"),
    ("musicgen_row", fa.work(4, 1, 64, 24, 24, 64), "0.00095", "bytes"),
    ("internvl2", fa.work(4, 1024, 1024, 14, 2, 64, causal=True), "0.0456",
     "operations"),
    ("llama4", fa.work(4, 1280, 1280, 40, 8, 128, causal=True,
                       window=8192), "0.4070", "operations"),
    ("train_dit", fa.work(16, 256, 256, 16, 16, 72), "0.0293",
     "operations"),
    ("train_internvl2", fa.work(4, 768, 768, 14, 2, 64, causal=True),
     "0.0257", "operations"),
    ("ssd", ssd.work(4, 1024, 64, 64, 1, 128, 128), "0.0623", "operations"),
    ("rglru_prefill", rglru.work(2, 3072, 2560), "0.0939", "bytes"),
    ("rglru_decode", rglru.work(2, 1, 2560, h0=True), "0.0000459", "bytes"),
]


@pytest.mark.parametrize("name,work,printed,by", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_kernel_work_keeps_the_bounds_of_perf_md(name, work, printed, by):
    bound, got_by = kernel_bound(PEAK, work)
    decimals = len(printed.split(".")[1])
    assert abs(bound - float(printed)) <= 0.5 * 10 ** -decimals, bound
    assert got_by == by


def test_gemm_work():
    assert gemm.work(4096, 5120, 17408) == (
        2 * 4096 * 5120 * 17408, 4 * (4096 * 5120 + 5120 * 17408
                                      + 4096 * 17408), "3xtf32")
    assert gemm.work(8, 1152, 2304, True, "requests") == (
        2 * 8 * 1152 * 2304, 4 * (8 * 1152 + 1152 * 2304 + 8 * 2304 + 2304),
        "fp32")
    with pytest.raises(ValueError):
        gemm.work(1, 1, 1, rows="rows")
    # the causal triangle, the band of a window, a window past the length
    assert fa.pairs(5, 5, True, None) == 15
    assert fa.pairs(5, 5, True, 2) == 9
    assert fa.pairs(5, 5, True, 8) == 15
    assert fa.pairs(3, 7, False, None) == 21


def test_meta_stand_ins_give_the_kernels_output_shapes():
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    seen = []
    ops.METERS.append(lambda name, work, outs: seen.append((name, work)))
    try:
        y = ops.linear(m(2, 3, 16), m(16, 8), m(8), rows="requests")
        o = ops.flash_attention(m(2, 5, 4, 16), m(2, 7, 2, 16),
                                m(2, 7, 2, 8), causal=False)
        ys, hs = ops.ssd(m(1, 16, 2, 4), m(1, 16, 2), m(2), m(1, 16, 1, 8),
                         m(1, 16, 1, 8), chunk=8)
        yr, hr = ops.rglru_scan(m(2, 6, 8), m(2, 6, 8), m(2, 6, 8),
                                m(2, 6, 8), m(8), 8.0)
    finally:
        ops.METERS.pop()
    assert tuple(y.shape) == (2, 3, 8) and tuple(o.shape) == (2, 5, 4, 8)
    assert tuple(ys.shape) == (1, 16, 2, 4) and tuple(hs.shape) == (1, 2, 4, 8)
    assert hs.dtype == torch.float32
    assert tuple(yr.shape) == (2, 6, 8) and tuple(hr.shape) == (2, 8)
    assert [n for n, _ in seen] == ["linear", "flash_attention", "ssd",
                                    "rglru_scan"]
    assert seen[0][1] == gemm.work(6, 16, 8, True, "requests")
    assert seen[1][1] == fa.work(2, 5, 7, 4, 2, 16, 8)
    assert seen[2][1] == ssd.work(1, 16, 2, 4, 1, 8, 8)
    assert seen[3][1] == rglru.work(2, 6, 8)
