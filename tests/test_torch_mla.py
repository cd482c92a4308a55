"""The port's MLA (latent-KV attention) language model against the JAX
package's, on the same numpy weights and prompts: minicpm3-4b smoke — 2
blocks, d_model 128, 4 heads, q_lora 64, kv_lora 64, nope 32, rope 16,
v 32, gated SiLU MLP d_ff 256, tied embeddings, vocab 512, f32.  The
weights are the JAX package's init plus a seeded 0.05·N(0,1) on every leaf
(so the zero-initialized norm scales matter), handed to both packages
through numpy; inputs and prompts come from numpy.  The full-rank q branch
(``q_lora_rank=None``) is held too.  The port's full mode runs attention
through ``ops.flash_attention`` with a value head dim below the key's
(here its plain version); so the plain attention with Dv < D is also held
against the JAX Pallas kernel in interpret mode, on V zero-padded to D.

Tolerance: 5e-5 (atol and rtol) in f32 throughout, as in
``tests/test_torch_attn_lm.py``; greedy ``generate`` token for token.
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
from repro.launch import serve as jserve
from repro.models import attention as jattn, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import (attention_ab, flash_attention as tfa,
                                 gemm_ab, ops, products, ref)
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn, transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "minicpm3-4b"


def _full_rank_q(cfg):
    """``cfg`` with every MLA mixer's q projection full rank."""
    (st,) = cfg.stages
    unit = tuple(dataclasses.replace(b, mixer=dataclasses.replace(
        b.mixer, q_lora_rank=None)) for b in st.unit)
    return cfg.replace(stages=(dataclasses.replace(st, unit=unit),))


def _cfgs(q_lora=True):
    cfgs = jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")
    return cfgs if q_lora else tuple(_full_rank_q(c) for c in cfgs)


@functools.lru_cache(maxsize=None)
def _numpy_params(q_lora=True):
    cfg, _ = _cfgs(q_lora)
    p = jT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(19)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _params(q_lora=True):
    """(jax params, torch params on the CPU) with identical values."""
    pn = _numpy_params(q_lora)
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _mixer(q_lora=True, r=1):
    pj, pt = _params(q_lora)
    return (jax.tree.map(lambda a: a[r], pj["stages"][0][0]["mixer"]),
            tT.tree_map(lambda a: a[r], pt["stages"][0][0]["mixer"]))


def _specs(q_lora=True):
    cfg, tcfg = _cfgs(q_lora)
    return cfg.stages[0].unit[0].mixer, tcfg.stages[0].unit[0].mixer


def _tokens(b, l, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


def test_configs_are_minicpm3_widths():
    full = tconfigs.get(ARCH)
    m = full.stages[0].unit[0].mixer
    assert (full.num_layers, full.d_model, full.vocab_size) == (62, 2560,
                                                                73448)
    assert (m.kind, m.num_heads, m.q_lora_rank, m.kv_lora_rank) == (
        "mla", 40, 768, 256)
    assert (m.nope_head_dim, m.rope_head_dim, m.v_head_dim) == (64, 32, 64)
    assert (m.q_dim, m.o_in_dim) == (3840, 2560)
    _, s = _specs()
    assert (s.num_heads, s.q_lora_rank, s.kv_lora_rank, s.nope_head_dim,
            s.rope_head_dim, s.v_head_dim) == (4, 64, 64, 32, 16, 32)
    assert _specs(q_lora=False)[1].q_lora_rank is None


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
def test_init_params_tree_matches_jax_and_converts(q_lora):
    """The port's init draws other numbers (torch generator) into the JAX
    tree — the q-LoRA's ``wq_a`` / ``q_norm`` / ``wq_b`` or a full-rank
    ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo`` — with the same shapes
    and dtypes, the norm scales zero on both; ``params_from_numpy`` carries
    the JAX tree over leaf for leaf."""
    cfg, tcfg = _cfgs(q_lora)
    pj = jT.init_params(jax.random.PRNGKey(0), cfg)
    pt = tT.init_params(torch.Generator().manual_seed(0), tcfg)
    lj, _ = jax.tree_util.tree_flatten_with_path(pj)
    lt, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), pt))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lj, lt):
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype, path
    mixer = pt["stages"][0][0]["mixer"]
    q = {"wq_a", "q_norm", "wq_b"} if q_lora else {"wq"}
    assert set(mixer) == q | {"wkv_a", "kv_norm", "wkv_b", "wo"}
    for name in {"q_norm", "kv_norm"} & set(mixer):
        assert not mixer[name]["scale"].any(), name
    pn = _numpy_params(q_lora)
    conv = params_from_numpy(pn, device="cpu")
    ln, _ = jax.tree_util.tree_flatten_with_path(pn)
    lc, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), conv))
    assert [p for p, _ in ln] == [p for p, _ in lc]
    for (path, a), (_, b) in zip(ln, lc):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_token_weights_take_every_mla_product():
    """``prepare_linear`` prepares what ``token_weights`` lists: per block
    wq_a, wq_b, wkv_a, wkv_b, wo and the MLP's three (wq for a full-rank
    q)."""
    for q_lora in (True, False):
        _, pt = _params(q_lora)
        per_block = 8 if q_lora else 7
        assert len(tT.token_weights(pt)) == per_block * 2


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
@pytest.mark.parametrize("offset", [0, 5])
def test_mla_full_matches(q_lora, offset):
    """Full mode at positions ``offset + arange(L)``: the output and the
    (ckv, krope) prefill cache, ckv after ``kv_norm`` and krope rotated at
    the rope head dim.  The JAX package sums two score einsums; the port
    runs one attention over q and k each [nope | rope], v 32 wide."""
    sj, st = _specs(q_lora)
    mj, mt = _mixer(q_lora)
    x = _rand(2, 21, 128, seed=3)
    pos = np.arange(offset, offset + 21)[None, :]
    oj, (cj, rj) = jattn.apply(sj, mj, jnp.asarray(x),
                               positions=jnp.asarray(pos), mode="full")
    ot, (ct, rt) = tattn.apply(st, mt, torch.from_numpy(x),
                               positions=torch.from_numpy(pos))
    assert tuple(ct.shape) == (2, 21, 64) and tuple(rt.shape) == (2, 21, 16)
    close(oj, ot)
    close(cj, ct)
    close(rj, rt)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
@pytest.mark.parametrize("slots,pos", [(12, 7), (8, 10), (6, 6)])
def test_mla_decode_matches(q_lora, slots, pos):
    """One absorbed decode step against a latent cache (ckv (B, S, 64),
    krope (B, S, 16)): the output and every cache leaf.  The slot is
    ``min(pos, S - 1)``: at pos ≥ S the last slot is overwritten.  The
    port's step writes into the cache it was given (the JAX step returns
    new arrays); no other slot changes."""
    sj, st = _specs(q_lora)
    mj, mt = _mixer(q_lora, r=0)
    ckv = _rand(2, slots, 64, seed=4)
    krope = _rand(2, slots, 16, seed=5)
    held = np.full(slots, -1, np.int32)
    for p in range(pos):
        held[min(p, slots - 1)] = p
    x = _rand(2, 1, 128, seed=6)
    oj, cj = jattn.apply(sj, mj, jnp.asarray(x), mode="decode", pos=pos,
                         cache={"ckv": jnp.asarray(ckv),
                                "krope": jnp.asarray(krope)},
                         slot_pos=jnp.asarray(held))
    cache = {"ckv": torch.tensor(ckv), "krope": torch.tensor(krope)}
    held_t = torch.tensor(held)
    ot, ct = tattn.apply(st, mt, torch.from_numpy(x), mode="decode",
                         pos=pos, cache=cache, slot_pos=held_t)
    close(oj, ot)
    assert sorted(cj) == sorted(ct) == ["ckv", "krope", "slots"]
    close(cj["ckv"], ct["ckv"])
    close(cj["krope"], ct["krope"])
    np.testing.assert_array_equal(np.asarray(cj["slots"]),
                                  ct["slots"].numpy())
    assert ct["ckv"] is cache["ckv"] and ct["krope"] is cache["krope"]
    assert ct["slots"] is held_t
    others = [i for i in range(slots) if i != min(pos, slots - 1)]
    assert np.array_equal(ct["ckv"].numpy()[:, others], ckv[:, others])
    assert np.array_equal(ct["krope"].numpy()[:, others], krope[:, others])


@pytest.mark.parametrize("plen,cache_len", [(10, 14), (3, 14), (14, 14)])
def test_to_decode_cache_and_init_caches_match(plen, cache_len):
    """A stacked prefill (ckv, krope) scattered into its slots, in the same
    (repeat, B, S, ·) layout with ``slots``, and the zeroed caches, against
    the JAX package's."""
    cfg, tcfg = _cfgs()
    bj, bt = cfg.stages[0].unit[0], tcfg.stages[0].unit[0]
    c, r = _rand(2, 3, plen, 64, seed=7), _rand(2, 3, plen, 16, seed=8)
    want = jT._to_decode_cache(bj, (jnp.asarray(c), jnp.asarray(r)),
                               cache_len, plen, jnp.float32)
    got = tT._to_decode_cache(bt, (torch.from_numpy(c), torch.from_numpy(r)),
                              cache_len, plen, torch.float32)
    assert tuple(got["ckv"].shape) == (2, 3, cache_len, 64)
    _close_caches([(want,)], [(got,)])
    zj = jT.init_caches(cfg, 3, cache_len, jnp.float32)
    zt = tT.init_caches(tcfg, 3, cache_len, device="cpu")
    _close_caches(zj, zt)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
def test_prefill_logits_and_caches_match(q_lora):
    cfg, tcfg = _cfgs(q_lora)
    pj, pt = _params(q_lora)
    toks = _tokens(2, 21, seed=1)
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks), cache_len=29,
                        cache_dtype=jnp.float32)
    lt, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks).long(),
                        cache_len=29)
    assert lt.shape == (2, 21, 512)
    close(lj, lt)
    _close_caches(cj, ct)
    assert ct[0][0]["slots"].tolist() == [list(range(21)) + [-1] * 8] * 2


def test_decode_teacher_forced_matches():
    """8 decode steps at positions 21 … 28 against the JAX package's, and
    against the port's own forward over the whole sequence: the latent
    cache and the RoPE positions carry the prefill into the absorbed
    decode."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
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


def test_generate_greedy_matches():
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(3, 21, seed=3)
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 10)
    got = tserve.generate(tcfg, pt, torch.from_numpy(toks).long(), 10,
                          device="cpu")
    assert got.shape == (3, 10) and got.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--variant", "smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    out = capsys.readouterr().out
    assert "minicpm3-4b-smoke on cpu: generated (2, 4)" in out


def test_lm_products_book_mla_products():
    """MiniCPM3-4B's products at full depth: q_a, q_b, kv_a, kv_b (in a
    prefill only: a decode step folds it into the attention einsums), o
    and the MLP — 8 calls a block in a prefill, 7 in a decode step."""
    cfg = products.lm_cut(tconfigs.get(ARCH), 62)
    pre = products.lm_products(cfg, 4096)
    assert pre == [("q_a", 4096, 2560, 768, 62), ("q_b", 4096, 768, 3840, 62),
                   ("kv_a", 4096, 2560, 288, 62),
                   ("kv_b", 4096, 256, 5120, 62),
                   ("o", 4096, 2560, 2560, 62),
                   ("up_gate", 4096, 2560, 6400, 124),
                   ("down", 4096, 6400, 2560, 62)]
    dec = products.lm_products(cfg, 4, decode=True)
    assert [r[0] for r in dec] == ["q_a", "q_b", "kv_a", "o", "up_gate",
                                   "down"]
    assert sum(r[-1] for r in pre) == 496 and sum(r[-1] for r in dec) == 434
    q = products.lm_products(_full_rank_q(cfg), 4)
    assert q[0] == ("q", 4, 2560, 3840, 62) and q[1][0] == "kv_a"
    # a GQA model's decode books the same products as its prefill
    qwen = products.lm_cut(tconfigs.get("qwen3-14b"), 8)
    assert products.lm_products(qwen, 4, decode=True) == \
        products.lm_products(qwen, 4)


@pytest.mark.parametrize("d,dv", [(96, 64), (48, 32), (128, 64), (96, 96),
                                  (256, 256), (1, 1), (192, 128), (256, 128),
                                  (160, 96)])
def test_kernel_wrapper_takes_a_value_head_dim_up_to_the_keys(d, dv):
    """1 ≤ Dv ≤ D, in the wide instance too (D 129..256), passes every check
    but the device's (so these CPU tensors are refused for their device
    alone)."""
    q = torch.zeros(2, 16, 4, d)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_cuda(q, q[:, :, :2], torch.zeros(2, 16, 2, dv))


@pytest.mark.parametrize("d,dv,match", [
    (64, 96, "value head dim 96 outside 1..64"),
    (96, 97, "value head dim 97"),
    (256, 257, "value head dim 257 outside 1..256"),
    (192, 0, "value head dim 0 outside 1..192"),
    (64, 0, "value head dim 0")])
def test_kernel_wrapper_refuses_other_value_head_dims(d, dv, match):
    q = torch.zeros(2, 16, 4, d)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_cuda(q, q[:, :, :2], torch.zeros(2, 16, 2, dv))


def test_kernel_wrapper_refuses_v_of_other_rows():
    q = torch.zeros(2, 16, 4, 96)
    with pytest.raises(ValueError, match="expected q"):
        tfa.flash_attention_cuda(q, q, torch.zeros(2, 15, 4, 64))


@pytest.mark.parametrize("d,dv", [(48, 32), (96, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2], ids=["groups1", "groups2"])
def test_plain_value_head_dim_matches_pallas_on_padded_v(d, dv, causal, kv):
    """``flash_attention_ref`` (and ``ops.flash_attention`` on the CPU)
    with Dv < D against the JAX Pallas kernel (interpret mode), which takes
    one head dim: V zero-padded to D, its output sliced to Dv.  4 query
    heads over 4 or 2 KV heads, a length that is no multiple of a block."""
    rng = np.random.default_rng(d + dv + kv)
    q = rng.standard_normal((2, 40, 4, d)).astype(np.float32)
    k = rng.standard_normal((2, 40, kv, d)).astype(np.float32)
    v = rng.standard_normal((2, 40, kv, dv)).astype(np.float32)
    vp = np.pad(v, ((0, 0),) * 3 + ((0, d - dv),))
    want = pallas_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp),
                     causal=causal, block_q=32, block_k=32,
                     interpret=True)[..., :dv]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, 40, 4, dv)
    close(want, got)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=causal), got)


def test_attention_ab_wide_needs_a_card(monkeypatch):
    """``attention_ab --wide`` (the head-dim-256 instance in f32 and bf16
    beside ``flex_attention``) refuses to run without a card, and wants a
    baseline or ``--wide``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        attention_ab.main(["--wide"])


@pytest.mark.parametrize("model", sorted(gemm_ab.LM_TILES))
def test_gemm_ab_lm_tiles_are_the_lm_products(model):
    """``gemm_ab --tiles --model`` times each attention LM's products as
    ``chip_smoke.py`` runs the model: its config cut to the same depth,
    the same prefill and decode rows and the same decode steps."""
    import chip_smoke as cs
    runs = {"qwen3": (cs.QWEN3_BLOCKS, cs.LM_BATCH, cs.LM_PROMPT, cs.LM_GEN),
            "gemma2": (cs.GEMMA2_BLOCKS, cs.GEMMA2_BATCH, cs.GEMMA2_PROMPT,
                       cs.GEMMA2_GEN),
            "minicpm3": (cs.MINICPM3_BLOCKS, cs.LM_BATCH, cs.LM_PROMPT,
                         cs.LM_GEN)}
    name, blocks, prefill, decode = gemm_ab.LM_TILES[model]
    run_blocks, batch, prompt, new = runs[model]
    assert (blocks, prefill, decode, gemm_ab.Q_STEPS) == (
        run_blocks, batch * prompt, batch, new - 1)
    cfg = products.lm_cut(tconfigs.get(name), blocks)
    assert cfg.num_layers == blocks and prefill > decode > 0
    shapes = products.lm_products(cfg, prefill)
    assert len({(k, n) for _, _, k, n, _ in shapes}) == len(shapes)
