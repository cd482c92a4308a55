"""The port's analytic MACs (``repro_torch.utils.flops``) against the JAX
package's ``repro.utils.flops``: every function on every config both
registries hold, full and smoke, relative 1e-12 (the same formulas in
the same order of summation give the same floats) — OpenSora's
factorized video attention, MusicGen's codebook heads and the MoE FFNs
among them — and the paper's Table 1 TMACs on the full DiT-XL/2."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import diffusion as jdiffusion, schedule as jS
from repro.utils import flops as jflops
from repro_torch import configs as tconfigs
from repro_torch.core import diffusion as tdiffusion, schedule as tS
from repro_torch.utils import flops as tflops

ARCHS = sorted(set(tconfigs.REGISTRY) & set(jconfigs.REGISTRY))
CASES = [(a, v) for a in ARCHS for v in ("full", "smoke")]
LENGTHS = [(1, 1), (64, 64), (200, 77), (4096, 4096)]


def _same(got, want):
    assert got == pytest.approx(want, rel=1e-12), (got, want)


def _pairs(arch, variant):
    """Each block of the two packages' configs, side by side."""
    jc, tc = jconfigs.get(arch, variant), tconfigs.get(arch, variant)
    blocks = [(jb, tb) for js, ts in zip(jc.stages, tc.stages)
              for jb, tb in zip(js.unit, ts.unit)]
    assert len(blocks) == sum(len(s.unit) for s in jc.stages)
    return jc, tc, blocks


@pytest.mark.parametrize("arch,variant", CASES)
def test_layer_macs_equal_the_reference(arch, variant):
    jc, tc, blocks = _pairs(arch, variant)
    d, cond = jc.d_model, jc.cond_dim
    for jb, tb in blocks:
        for lq, lk in LENGTHS:
            if jb.mixer is not None:
                _same(tflops.mixer_macs(tb.mixer, d, lq, lk),
                      jflops.mixer_macs(jb.mixer, d, lq, lk))
                if hasattr(jb.mixer, "num_heads") and hasattr(
                        jb.mixer, "kind"):
                    _same(tflops.attn_macs(tb.mixer, d, lq, lk, cond),
                          jflops.attn_macs(jb.mixer, d, lq, lk, cond))
            if jb.cross is not None:
                _same(tflops.attn_macs(tb.cross, d, lq, lk, cond),
                      jflops.attn_macs(jb.cross, d, lq, lk, cond))
            if jb.ffn is not None:
                _same(tflops.ffn_macs(tb.ffn, d, lq),
                      jflops.ffn_macs(jb.ffn, d, lq))
            got = tflops.block_macs_by_branch(tb, d, lq, lk, cond, 64)
            want = jflops.block_macs_by_branch(jb, d, lq, lk, cond, 64)
            assert list(got) == list(want)
            for t in want:
                _same(got[t], want[t])


@pytest.mark.parametrize("arch,variant", CASES)
def test_model_macs_equal_the_reference(arch, variant):
    jc, tc = jconfigs.get(arch, variant), tconfigs.get(arch, variant)
    video = None
    if tc.task == "diffusion":
        n_tok, _, video = tdiffusion.token_shape(tc)
        assert (n_tok, video) == (jdiffusion.token_shape(jc)[0],
                                  jdiffusion.token_shape(jc)[2])
        lengths = [n_tok, 64]
    else:
        lengths = [1, 64, 4096]
    for seq in lengths:
        for cond_len in (64, 300):
            got = tflops.model_macs_by_type(tc, seq, cond_len=cond_len,
                                            video_shape=video)
            want = jflops.model_macs_by_type(jc, seq, cond_len=cond_len,
                                             video_shape=video)
            assert list(got) == list(want)
            for t in want:
                _same(got[t], want[t])
        _same(tflops.non_block_macs(tc, seq), jflops.non_block_macs(jc, seq))


def _schedules(types, steps, name):
    if name == "no_cache":
        return jS.no_cache(types, steps), tS.no_cache(types, steps)
    n = int(name.split("=")[1])
    return jS.fora(types, steps, n), tS.fora(types, steps, n)


@pytest.mark.parametrize("name", ["no_cache", "static:n=2", "static:n=3"])
@pytest.mark.parametrize("arch", ["dit-xl-256", "opensora-v12",
                                  "stable-audio-open"])
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_sampler_tmacs_equal_the_reference(arch, variant, name):
    jc, tc = jconfigs.get(arch, variant), tconfigs.get(arch, variant)
    n_tok, _, video = tdiffusion.token_shape(tc)
    js, ts = _schedules(tc.layer_types(), 50, name)
    for batch, scale in ((1, 1.5), (4, None)):
        _same(tflops.sampler_tmacs(tc, ts, n_tok, batch, cfg_scale=scale,
                                   video_shape=video),
              jflops.sampler_tmacs(jc, js, n_tok, batch, cfg_scale=scale,
                                   video_shape=video))
    _same(tflops.sampler_tmacs(tc, None, n_tok, 2),
          jflops.sampler_tmacs(jc, None, n_tok, 2))


def test_dit_xl_no_cache_tmacs_and_the_papers_table_1():
    """DiT-XL/2 at 256×256, DDIM 50, CFG 1.5, one image: 118.4 GMACs a
    forward (the DiT paper's 118.6 within 0.5) × 2 under CFG × 50 steps
    = 11.839 TMACs, in both packages.  The paper's Table 1 No-Cache row,
    365.59 TMACs (``benchmarks/table1_dit.py:33``), is 30.88 times that:
    neither package's accounting reproduces the absolute figure, and the
    Table 1 benchmark compares only ratios to No-Cache against the
    paper's."""
    cfg, jcfg = tconfigs.get("dit-xl-256"), jconfigs.get("dit-xl-256")
    sch = tS.no_cache(cfg.layer_types(), 50)
    got = tflops.sampler_tmacs(cfg, sch, 256, 1, cfg_scale=1.5)
    want = jflops.sampler_tmacs(jcfg, jS.no_cache(jcfg.layer_types(), 50),
                                256, 1, cfg_scale=1.5)
    _same(got, want)
    assert abs(got - 11.8392127488) < 1e-9, got
    assert abs(365.59 / got - 30.88) < 0.01
    per = tflops.model_macs_by_type(cfg, 256)
    fwd = sum(per.values()) + tflops.non_block_macs(cfg, 256)
    assert abs(fwd / 1e9 - 118.6) < 0.5, fwd
    assert np.isclose(got, fwd * 2 * 50 / 1e12, rtol=1e-12)
