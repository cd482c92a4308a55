"""The port's attention language models against the JAX package's, on the
same numpy weights and prompts: qwen3-14b (qk-norm, RoPE at LM positions,
GQA) and qwen2.5-14b (GQA with a QKV bias), smoke variants — 2 blocks,
d_model 128, 4 query heads × 32 over 1 KV head, d_ff 256, vocab 512, f32.
The weights are the JAX package's init plus a seeded 0.05·N(0,1) on every
leaf (so the zero-initialized norm scales and biases matter), handed to
both packages through numpy; the prompts come from numpy.

Tolerance: 5e-5 (atol and rtol) in f32 throughout, as in
``tests/test_torch_lm.py``; greedy ``generate`` token for token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn, transformer as tT

ARCHS = ["qwen3-14b", "qwen2.5-14b"]


def _cfgs(arch="qwen3-14b"):
    return jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    cfg, _ = _cfgs(arch)
    p = jT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(13)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _params(arch="qwen3-14b"):
    """(jax params, torch params on the CPU) with identical values."""
    pn = _numpy_params(arch)
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _mixer(arch="qwen3-14b", r=1):
    pj, pt = _params(arch)
    return (jax.tree.map(lambda a: a[r], pj["stages"][0][0]["mixer"]),
            tT.tree_map(lambda a: a[r], pt["stages"][0][0]["mixer"]))


def _tokens(b, l, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close_caches(cj, ct):
    assert len(cj) == len(ct)
    for sj, st in zip(cj, ct):
        for bj, bt in zip(sj, st):
            assert sorted(bj) == sorted(bt)
            for name in bj:
                assert tuple(bj[name].shape) == tuple(bt[name].shape), name
                if name == "slots":
                    np.testing.assert_array_equal(np.asarray(bj[name]),
                                                  bt[name].numpy())
                else:
                    close(bj[name], bt[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's init draws other numbers (torch generator) into the JAX
    tree — q_norm / k_norm (qwen3) and bq / bk / bv (qwen2.5) included —
    with the same shapes and dtypes; the zero leaves are zero on both."""
    cfg, tcfg = _cfgs(arch)
    pj = jT.init_params(jax.random.PRNGKey(0), cfg)
    pt = tT.init_params(torch.Generator().manual_seed(0), tcfg)
    lj, _ = jax.tree_util.tree_flatten_with_path(pj)
    lt, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), pt))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lj, lt):
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype, path
    mixer = pt["stages"][0][0]["mixer"]
    extra = ("q_norm", "k_norm") if arch == "qwen3-14b" else ("bq", "bk",
                                                              "bv")
    assert set(mixer) == {"wq", "wk", "wv", "wo", *extra}
    for name in extra:
        leaf = mixer[name]["scale"] if "norm" in name else mixer[name]
        assert not leaf.any(), name


@pytest.mark.parametrize("offset", [0, 5])
def test_attention_full_with_qk_norm_and_rope_matches(offset):
    """Full mode at positions ``offset + arange(L)``: the output and the
    (k, v) prefill cache, k after qk-norm and RoPE."""
    cfg, tcfg = _cfgs()
    sj, st = cfg.stages[0].unit[0].mixer, tcfg.stages[0].unit[0].mixer
    assert st.qk_norm and st.num_kv_heads == 1 and st.num_heads == 4
    mj, mt = _mixer()
    x = _rand(2, 21, 128, seed=3)
    pos = np.arange(offset, offset + 21)[None, :]
    oj, (kj, vj) = jattn.apply(sj, mj, jnp.asarray(x),
                               positions=jnp.asarray(pos), mode="full")
    ot, (kt, vt) = tattn.apply(st, mt, torch.from_numpy(x),
                               positions=torch.from_numpy(pos))
    assert tuple(kt.shape) == (2, 21, 1, 32)
    close(oj, ot)
    close(kj, kt)
    close(vj, vt)


@pytest.mark.parametrize("window,slots,pos", [(None, 12, 7), (None, 8, 10),
                                              (4, 6, 9)])
def test_attention_decode_matches(window, slots, pos):
    """One decode step against a cache in the decode layouts (k (B, KV, dh,
    S), v (B, KV, S, dh)): the output and every cache leaf.  Without a
    window the slot is ``min(pos, S - 1)``; under a window ≤ S the slots
    are a ring (``pos % S``) and the mask drops positions that left it.
    The port's step writes the new column into the cache it was given (the
    JAX step returns new arrays); no other slot changes."""
    cfg, tcfg = _cfgs()
    sj = dataclasses.replace(cfg.stages[0].unit[0].mixer, window=window)
    st = dataclasses.replace(tcfg.stages[0].unit[0].mixer, window=window)
    mj, mt = _mixer(r=0)
    k = _rand(2, 1, 32, slots, seed=4)
    v = _rand(2, 1, slots, 32, seed=5)
    # the positions the slots hold before this step, as a run of decode
    # steps would have left them
    held = np.full(slots, -1, np.int32)
    for p in range(pos):
        held[tattn.decode_slot(st, p, slots)] = p
    x = _rand(2, 1, 128, seed=6)
    oj, cj = jattn.apply(sj, mj, jnp.asarray(x), mode="decode", pos=pos,
                         cache={"k": jnp.asarray(k), "v": jnp.asarray(v)},
                         slot_pos=jnp.asarray(held))
    # copies: the step writes into them
    cache = {"k": torch.tensor(k), "v": torch.tensor(v)}
    held_t = torch.tensor(held)
    ot, ct = tattn.apply(st, mt, torch.from_numpy(x), mode="decode", pos=pos,
                         cache=cache, slot_pos=held_t)
    close(oj, ot)
    assert sorted(cj) == sorted(ct) == ["k", "slots", "v"]
    close(cj["k"], ct["k"])
    close(cj["v"], ct["v"])
    np.testing.assert_array_equal(np.asarray(cj["slots"]), ct["slots"].numpy())
    assert ct["k"] is cache["k"] and ct["v"] is cache["v"]
    assert ct["slots"] is held_t
    slot = tattn.decode_slot(st, pos, slots)
    others = [i for i in range(slots) if i != slot]
    assert np.array_equal(ct["k"].numpy()[..., others], k[..., others])
    assert np.array_equal(ct["v"].numpy()[:, :, others], v[:, :, others])
    assert np.array_equal(held_t.numpy()[others], held[others])


@pytest.mark.parametrize("window,plen,cache_len", [(None, 10, 14),
                                                   (4, 10, 14), (4, 3, 14)])
def test_to_decode_cache_and_init_caches_match(window, plen, cache_len):
    """A stacked prefill (k, v) scattered into the decode layouts and
    slots (under a window only its last positions, in ring slots), and the
    zeroed caches, against the JAX package's."""
    cfg, tcfg = _cfgs()
    bj = dataclasses.replace(cfg.stages[0].unit[0], mixer=dataclasses.replace(
        cfg.stages[0].unit[0].mixer, window=window))
    bt = dataclasses.replace(tcfg.stages[0].unit[0],
                             mixer=dataclasses.replace(
                                 tcfg.stages[0].unit[0].mixer, window=window))
    k, v = _rand(2, 3, plen, 1, 32, seed=7), _rand(2, 3, plen, 1, 32, seed=8)
    want = jT._to_decode_cache(bj, (jnp.asarray(k), jnp.asarray(v)),
                               cache_len, plen, jnp.float32)
    got = tT._to_decode_cache(bt, (torch.from_numpy(k), torch.from_numpy(v)),
                              cache_len, plen, torch.float32)
    _close_caches([(want,)], [(got,)])
    zj = jT.init_caches(cfg, 3, cache_len, jnp.float32)
    zt = tT.init_caches(tcfg, 3, cache_len, device="cpu")
    _close_caches(zj, zt)


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_logits_match(use_flash):
    """The port (kernel path; its plain version on the CPU) against the JAX
    forward through its einsum attention and through the Pallas kernel
    (interpret mode), at a length that is no multiple of a block."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 21)
    lj, _ = jT.forward(cfg, pj, jnp.asarray(toks), use_flash=use_flash)
    lt, aux = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    assert lt.shape == (2, 21, 512)
    close(lj, lt)
    close(lj, tT.logits_from_hidden(tcfg, pt, aux["hidden"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match(arch):
    cfg, tcfg = _cfgs(arch)
    pj, pt = _params(arch)
    toks = _tokens(2, 21, seed=1)
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks), cache_len=29,
                        cache_dtype=jnp.float32)
    lt, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks).long(),
                        cache_len=29)
    close(lj, lt)
    _close_caches(cj, ct)
    assert ct[0][0]["slots"].tolist() == [list(range(21)) + [-1] * 8] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_teacher_forced_matches(arch):
    """8 decode steps at positions 21 … 28 against the JAX package's, and
    against the port's own forward over the whole sequence: the KV cache
    and the RoPE positions carry the prefill into the decode."""
    cfg, tcfg = _cfgs(arch)
    pj, pt = _params(arch)
    toks = _tokens(2, 29, seed=2)
    plen = 21
    _, cj = jT.prefill(cfg, pj, jnp.asarray(toks[:, :plen]), cache_len=29,
                       cache_dtype=jnp.float32)
    _, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks[:, :plen]).long(),
                       cache_len=29)
    full, _ = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    for i in range(8):
        tj = jnp.asarray(toks[:, plen + i: plen + i + 1])
        tt = torch.from_numpy(toks[:, plen + i: plen + i + 1]).long()
        lj, cj = jT.decode_step(cfg, pj, tj, plen + i, cj)
        lt, ct = tT.decode_step(tcfg, pt, tt, ct, pos=plen + i)
        assert lt.shape == (2, 1, 512)
        close(lj, lt)
        close(full[:, plen + i: plen + i + 1], lt)
    _close_caches(cj, ct)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches(arch):
    cfg, tcfg = _cfgs(arch)
    pj, pt = _params(arch)
    toks = _tokens(3, 21, seed=3)
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 10)
    got = tserve.generate(tcfg, pt, torch.from_numpy(toks).long(), 10,
                          device="cpu")
    assert got.shape == (3, 10) and got.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_positions_and_cache_length_are_required():
    _, tcfg = _cfgs()
    _, pt = _params()
    toks = torch.from_numpy(_tokens(1, 6)).long()
    with pytest.raises(ValueError, match="cache_len"):
        tT.prefill(tcfg, pt, toks)
    _, caches = tT.prefill(tcfg, pt, toks, cache_len=8)
    with pytest.raises(ValueError, match="pos="):
        tT.decode_step(tcfg, pt, toks[:, :1], caches)


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen3-14b", "--variant", "smoke", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    out = capsys.readouterr().out
    assert "qwen3-14b-smoke on cpu: generated (2, 4)" in out
    assert "tok/s" in out
