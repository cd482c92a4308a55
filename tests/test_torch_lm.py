"""The port's Mamba-2 language model against the JAX package's, on the same
numpy weights and prompts (mamba2-1.3b smoke: 2 blocks, d_model 128, 16
SSD heads × 16, d_state 16, chunk 8, vocab 512, f32).

Tolerance: 5e-5 (atol and rtol) in f32 throughout, logits and states
through the whole stack included; the largest error seen is about 3% of it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, lm_smoke_cfgs, lm_smoke_params
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as jL, ssm as jssm, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tL, ssm as tssm
from repro_torch.models import transformer as tT


def _tokens(b, l, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


def _same(t, j, path="cfg"):
    """Every field of the port's dataclass ``t`` equals ``j``'s field."""
    if dataclasses.is_dataclass(t):
        assert type(t).__name__ == type(j).__name__, path
        for f in dataclasses.fields(t):
            _same(getattr(t, f.name), getattr(j, f.name), f"{path}.{f.name}")
    elif isinstance(t, (tuple, list)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _same(a, b, f"{path}[{i}]")
    else:
        assert t == j, f"{path}: {t!r} != {j!r}"


@pytest.mark.parametrize("arch", ["dit-xl-256", "mamba2-1.3b",
                                  "qwen3-14b", "qwen2.5-14b"])
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_configs_match_jax(arch, variant):
    _same(tconfigs.get(arch, variant), jconfigs.get(arch, variant))


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 16, 128)) + 1.5).astype(np.float32)
    scale = rng.standard_normal(128).astype(np.float32)
    close(jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
          tL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)))
    assert torch.equal(tL.apply_norm("rmsnorm", {"scale": torch.from_numpy(
        scale)}, torch.from_numpy(x)), tL.rmsnorm(
        {"scale": torch.from_numpy(scale)}, torch.from_numpy(x)))


def test_softplus_matches():
    v = np.linspace(-40, 40, 801, dtype=np.float32)
    close(jax.nn.softplus(jnp.asarray(v)), tssm.softplus(torch.from_numpy(v)),
          atol=0, rtol=1e-6)


def test_init_params_tree_matches_jax():
    """The port's init draws other numbers (torch generator) into the same
    tree: same keys, shapes and dtypes; the zero / one leaves equal."""
    cfg, tcfg = lm_smoke_cfgs()
    pj = jT.init_params(jax.random.PRNGKey(0), cfg)
    pt = tT.init_params(torch.Generator().manual_seed(0), tcfg)
    lj, _ = jax.tree_util.tree_flatten_with_path(pj)
    lt, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), pt))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lj, lt):
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype, path
    for name in ("conv_b", "d_skip"):
        m = pt["stages"][0][0]["mixer"][name]
        assert torch.equal(m, torch.from_numpy(np.array(
            pj["stages"][0][0]["mixer"][name])))
    a = torch.exp(pt["stages"][0][0]["mixer"]["a_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())


def _mixer(r=0):
    pj, pt = lm_smoke_params()
    return (jax.tree.map(lambda a: a[r], pj["stages"][0][0]["mixer"]),
            tT.tree_map(lambda a: a[r], pt["stages"][0][0]["mixer"]))


@pytest.mark.parametrize("length", [16, 21])
def test_ssm_mixer_full_then_decode_matches(length):
    cfg, tcfg = lm_smoke_cfgs()
    sj, st = cfg.stages[0].unit[0].mixer, tcfg.stages[0].unit[0].mixer
    mj, mt = _mixer(1)
    x = np.random.default_rng(4).standard_normal((2, length + 1, 128)).astype(
        np.float32)
    oj, cj = jssm.apply_full(sj, mj, jnp.asarray(x[:, :length]), 128)
    ot, ct = tssm.apply_full(st, mt, torch.from_numpy(x[:, :length]), 128)
    close(oj, ot)
    close(cj["conv"], ct["conv"])
    close(cj["ssm"], ct["ssm"])
    dj, nj = jssm.apply_decode(sj, mj, jnp.asarray(x[:, length:]), cj, 128)
    dt_, nt = tssm.apply_decode(st, mt, torch.from_numpy(x[:, length:]), ct,
                                128)
    close(dj, dt_)
    close(nj["conv"], nt["conv"])
    close(nj["ssm"], nt["ssm"])


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_logits_match(use_flash):
    """The port (kernel path; its plain version on the CPU) against the JAX
    forward through ``ssd_chunked`` and through the Pallas kernel
    (interpret mode)."""
    cfg, tcfg = lm_smoke_cfgs()
    pj, pt = lm_smoke_params()
    toks = _tokens(2, 21)
    lj, _ = jT.forward(cfg, pj, jnp.asarray(toks), use_flash=use_flash)
    lt, aux = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    assert lt.shape == (2, 21, 512)
    close(lj, lt)
    close(lj, tT.logits_from_hidden(tcfg, pt, aux["hidden"]))


def _close_caches(cj, ct):
    assert len(cj) == len(ct)
    for sj, st in zip(cj, ct):
        for bj, bt in zip(sj, st):
            assert sorted(bj) == sorted(bt)
            for name in bj:
                assert tuple(bj[name].shape) == tuple(bt[name].shape), name
                close(bj[name], bt[name])


@pytest.mark.parametrize("length", [16, 21])
def test_prefill_logits_and_caches_match(length):
    cfg, tcfg = lm_smoke_cfgs()
    pj, pt = lm_smoke_params()
    toks = _tokens(2, length, seed=1)
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks), cache_len=length + 8,
                        cache_dtype=jnp.float32)
    lt, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks).long())
    close(lj, lt)
    _close_caches(cj, ct)
    # the zeroed caches have the same layout as the prefilled ones
    zj = jT.init_caches(cfg, 2, length + 8, jnp.float32)
    zt = tT.init_caches(tcfg, 2, device="cpu")
    _close_caches(zj, zt)


def test_decode_teacher_forced_matches():
    cfg, tcfg = lm_smoke_cfgs()
    pj, pt = lm_smoke_params()
    toks = _tokens(2, 29, seed=2)
    plen = 21
    _, cj = jT.prefill(cfg, pj, jnp.asarray(toks[:, :plen]), cache_len=29,
                       cache_dtype=jnp.float32)
    _, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks[:, :plen]).long())
    full, _ = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    for i in range(8):
        tj = jnp.asarray(toks[:, plen + i: plen + i + 1])
        tt = torch.from_numpy(toks[:, plen + i: plen + i + 1]).long()
        lj, cj = jT.decode_step(cfg, pj, tj, plen + i, cj)
        lt, ct = tT.decode_step(tcfg, pt, tt, ct)
        assert lt.shape == (2, 1, 512)
        close(lj, lt)
        # the recurrent step continues the full-sequence pass
        close(full[:, plen + i: plen + i + 1], lt)
    _close_caches(cj, ct)


def test_generate_greedy_matches():
    cfg, tcfg = lm_smoke_cfgs()
    pj, pt = lm_smoke_params()
    toks = _tokens(3, 21, seed=3)
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 10)
    got = tserve.generate(tcfg, pt, torch.from_numpy(toks).long(), 10,
                          device="cpu")
    assert got.shape == (3, 10) and got.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_generate_samples_from_an_explicit_generator():
    _, tcfg = lm_smoke_cfgs()
    _, pt = lm_smoke_params()
    toks = torch.from_numpy(_tokens(2, 12, seed=4)).long()
    runs = [tserve.generate(tcfg, pt, toks, 6, temperature=1.0,
                            generator=torch.Generator().manual_seed(s),
                            device="cpu") for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert bool(((runs[0] >= 0) & (runs[0] < tcfg.vocab_size)).all())
    with pytest.raises(ValueError, match="generator"):
        tserve.generate(tcfg, pt, toks, 6, temperature=1.0, device="cpu")


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "mamba2-1.3b", "--variant", "smoke", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "tok/s" in out
