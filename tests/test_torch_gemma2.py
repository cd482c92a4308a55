"""The port's Gemma-2 against the JAX package's, on the same numpy weights
and prompts: gemma2-9b smoke — one unit of a local (window 16) and a global
block, d_model 128, 4 query heads × 32 over 2 KV heads, attention softcap
50, final softcap 30, pre- and post-norms, gated GELU-tanh MLP d_ff 256,
tied embeddings scaled by √d, vocab 512, f32.  The weights are the JAX
package's init plus a seeded 0.05·N(0,1) on every leaf (so the
zero-initialized norm scales, the post-norms' among them, matter), handed
to both packages through numpy; the prompts (24 tokens, past the window)
come from numpy.  Also the plain attention at Gemma-2's head dim 256 with
a window and a softcap against the Pallas kernel (interpret mode), and the
products helpers on Gemma-2's two-block unit.

Tolerance: 5e-5 (atol and rtol) in f32 throughout; greedy ``generate``
token for token.
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
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro.launch import serve as jserve
from repro.models import blocks as jblocks, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import products, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks, transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "gemma2-9b"
PROMPT = 24          # past the smoke window of 16


def _cfgs():
    return jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params():
    cfg, _ = _cfgs()
    p = jT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(17)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _params():
    """(jax params, torch params on the CPU) with identical values."""
    pn = _numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _tokens(b, l, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


def test_smoke_config_is_one_local_global_unit():
    _, tcfg = _cfgs()
    (st,) = tcfg.stages
    assert st.repeat == 1 and [b.mixer.window for b in st.unit] == [16, None]
    for b in st.unit:
        m = b.mixer
        assert (m.num_heads, m.num_kv_heads, m.head_dim) == (4, 2, 32)
        assert m.logit_softcap == 50.0 and b.post_norm
        assert (b.ffn.d_ff, b.ffn.activation) == (256, "gelu_tanh")
    assert (tcfg.vocab_size, tcfg.logit_softcap) == (512, 30.0)
    assert tcfg.tie_embeddings and tcfg.embed_scale


def test_init_params_tree_matches_jax():
    """The port's init makes the JAX tree, ``post_norm1`` after the mixer
    and ``post_norm2`` after the MLP, zero-initialized as the JAX package's;
    ``params_from_numpy`` carries the JAX tree over leaf for leaf."""
    cfg, tcfg = _cfgs()
    pj = jT.init_params(jax.random.PRNGKey(0), cfg)
    pt = tT.init_params(torch.Generator().manual_seed(0), tcfg)
    lj, _ = jax.tree_util.tree_flatten_with_path(pj)
    lt, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), pt))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lj, lt):
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype, path
    for unit in pt["stages"][0]:
        assert list(unit) == ["norm1", "mixer", "post_norm1", "norm2", "ffn",
                              "post_norm2"]
        assert not unit["post_norm1"]["scale"].any()
        assert not unit["post_norm2"]["scale"].any()
    pn = _numpy_params()
    conv = params_from_numpy(pn, device="cpu")
    lc, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), conv))
    ln, _ = jax.tree_util.tree_flatten_with_path(pn)
    assert [p for p, _ in lc] == [p for p, _ in ln]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(lc, ln))


@pytest.mark.parametrize("which", [0, 1], ids=["local", "global"])
def test_block_matches_jax(which):
    """A local (window 16) and a global block in full mode over 24 tokens:
    the block output, both branch outputs (post-normed, as the reference
    records them) and the (k, v) prefill cache.  A SmoothCache skip of the
    mixer fed its recorded output gives the same block output bitwise."""
    cfg, tcfg = _cfgs()
    sj, st = cfg.stages[0].unit[which], tcfg.stages[0].unit[which]
    pj, pt = _params()
    bj = jax.tree.map(lambda a: a[0], pj["stages"][0][which])
    bt = tT.tree_map(lambda a: a[0], pt["stages"][0][which])
    x = _rand(2, PROMPT, 128, seed=3)
    pos = np.arange(PROMPT)[None, :]
    xj, oj, (kj, vj), _ = jblocks.apply(sj, bj, jnp.asarray(x), mode="full",
                                        d_model=128,
                                        positions=jnp.asarray(pos))
    xt, ot, (kt, vt) = tblocks.apply(st, bt, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos))
    close(xj, xt)
    assert sorted(oj) == sorted(ot) == ["ffn", "mixer"]
    for name in oj:
        close(oj[name], ot[name])
    close(kj, kt)
    close(vj, vt)
    skipped, bo, _ = tblocks.apply(
        st, bt, torch.from_numpy(x), positions=torch.from_numpy(pos),
        skip={"attn": True}, branch_cache={"mixer": ot["mixer"]})
    assert torch.equal(skipped, xt) and list(bo) == ["ffn"]


def test_plain_attention_at_head_dim_256_matches_pallas():
    """The kernel's plain version at Gemma-2's head dim 256 — causal,
    window 16, softcap 50, 4 query heads over 2 KV heads, L 80 — against
    the Pallas kernel in interpret mode and the JAX oracle."""
    b, l, h, kv, d = 1, 80, 4, 2, 256
    q, k, v = _rand(b, l, h, d, seed=5), _rand(b, l, kv, d, seed=6), _rand(
        b, l, kv, d, seed=7)
    kw = dict(causal=True, window=16, softcap=50.0)
    out = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  **kw)
    assert out.shape == (b, l, h, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    close(pallas_fa(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw),
          out)
    close(jax_ref(jq, jk, jv, **kw), out)


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_logits_match(use_flash):
    """The port against the JAX forward through its einsum attention and
    through the Pallas kernel (interpret mode), at 24 tokens: the window
    binds on the local block's last 8 query rows."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, PROMPT)
    lj, _ = jT.forward(cfg, pj, jnp.asarray(toks), use_flash=use_flash)
    lt, _ = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    assert lt.shape == (2, PROMPT, 512)
    assert float(lt.abs().max()) <= 30.0      # the final softcap
    close(lj, lt)


def test_prefill_caches_match():
    """The local block's ring of 16 slots keeps positions 8 … 23 in slots
    ``pos % 16``; the global block's cache holds all 24 of its 32 slots."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, PROMPT, seed=1)
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks), cache_len=32,
                        cache_dtype=jnp.float32)
    lt, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks).long(),
                        cache_len=32)
    close(lj, lt)
    _close_caches(cj, ct)
    local, glob = ct[0]
    ring = [8 + (s - 8) % 16 for s in range(16)]
    assert local["slots"].tolist() == [ring]
    assert tuple(local["k"].shape) == (1, 2, 2, 32, 16)
    assert glob["slots"].tolist() == [list(range(24)) + [-1] * 8]


def test_decode_teacher_forced_matches():
    """12 decode steps at positions 24 … 35 — each one overwrites a slot of
    the local ring — against the JAX package's (logits and caches) and
    against the port's own forward over the whole sequence."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    steps = 12
    toks = _tokens(2, PROMPT + steps, seed=2)
    clen = PROMPT + steps
    _, cj = jT.prefill(cfg, pj, jnp.asarray(toks[:, :PROMPT]),
                       cache_len=clen, cache_dtype=jnp.float32)
    _, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks[:, :PROMPT]).long(),
                       cache_len=clen)
    full, _ = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    jstep = jax.jit(lambda tok, p, c: jT.decode_step(cfg, pj, tok, p, c))
    for i in range(steps):
        p = PROMPT + i
        lj, cj = jstep(jnp.asarray(toks[:, p:p + 1]), p, cj)
        lt, ct = tT.decode_step(tcfg, pt,
                                torch.from_numpy(toks[:, p:p + 1]).long(),
                                ct, pos=p)
        close(lj, lt)
        close(full[:, p:p + 1], lt)
    _close_caches(cj, ct)
    assert sorted(ct[0][0]["slots"][0].tolist()) == list(range(20, 36))


def test_generate_greedy_matches():
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(3, PROMPT, seed=3)
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 10)
    got = tserve.generate(tcfg, pt, torch.from_numpy(toks).long(), 10,
                          device="cpu")
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--variant", "smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert "gemma2-9b-smoke on cpu: generated (2, 4)" in out


def test_lm_cut_counts_blocks_of_a_two_block_unit():
    cfg = tconfigs.get(ARCH)
    cut = products.lm_cut(cfg, 12)
    assert cut.num_layers == 12 and cut.stages[0].repeat == 6
    assert [b.mixer.window for _, _, _, b in cut.blocks()][:4] == [
        4096, None, 4096, None]
    assert products.lm_cut(tconfigs.get("qwen3-14b"), 8).num_layers == 8
    for bad in (0, 13):
        with pytest.raises(ValueError, match="2-block unit"):
            products.lm_cut(cfg, bad)


def test_lm_products_book_q_and_o_apart_where_they_differ():
    """Gemma-2: q 3584 → 4096 and o 4096 → 3584, one call a block each;
    Qwen3-14B (40 × 128 = 5120 = d) keeps one ``q_o`` shape."""
    g = products.lm_products(products.lm_cut(tconfigs.get(ARCH), 12), 8704)
    assert g == [("q", 8704, 3584, 4096, 12), ("k_v", 8704, 3584, 2048, 24),
                 ("o", 8704, 4096, 3584, 12),
                 ("up_gate", 8704, 3584, 14336, 24),
                 ("down", 8704, 14336, 3584, 12)]
    q = products.lm_products(products.lm_cut(tconfigs.get("qwen3-14b"), 8), 4)
    assert q == [("q_o", 4, 5120, 5120, 16), ("k_v", 4, 5120, 1024, 16),
                 ("up_gate", 4, 5120, 17408, 16), ("down", 4, 17408, 5120, 8)]
    wide = dataclasses.replace(
        tconfigs.get(ARCH).stages[0],
        unit=(tconfigs.get(ARCH).stages[0].unit[0],
              tconfigs.get("qwen3-14b").stages[0].unit[0]))
    with pytest.raises(ValueError, match="differ in width"):
        products.lm_products(tconfigs.get(ARCH).replace(stages=(wide,)), 4)
