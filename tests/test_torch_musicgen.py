"""The port's codebook LM (MusicGen-medium) against the JAX package's, on
the same numpy weights, prompts and memory: musicgen-medium smoke — 2
blocks of causal MHA (4 heads × 32, no RoPE) with cross-attention to a
64-wide text memory, a gelu MLP of 256, layernorm, sinusoidal positions,
4 codebooks of 512 (one embedding table and one head each), d 128, f32.
The weights are the JAX package's init plus a seeded 0.05·N(0,1) on every
leaf, handed to both packages through numpy.

Covers the codebook embedding (its sum in codebook order, bitwise) and
heads, sinusoidal positions over a prefix and in a decode step (the JAX
package's subtract-then-add), the forward, prefill → decode with a memory,
the cross-attention branch on a decode step's one row (the plain
attention at Lq 1 against the Pallas kernel in interpret mode), greedy
``generate`` token for token, the CLI and the products ``lm_products``
books.

Tolerance: 5e-5 (atol and rtol) in f32; greedy tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import attention as jattn, layers as jL, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, products, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn, layers as tL
from repro_torch.models import transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "musicgen-medium"
K, V, D, MEM = 4, 512, 128, 64


def _cfgs():
    return jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params():
    cfg, _ = _cfgs()
    p = jax.jit(jT.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(29)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _params():
    pn = _numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _tokens(b, l, seed=0):
    return np.random.default_rng(seed).integers(0, V, (b, l, K)).astype(
        np.int32)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _memory(b, seed=0, length=8):
    return _rand(b, length, MEM, seed=seed)


def _both(a):
    """numpy → (jax array, CPU tensor; int64 for token ids)."""
    t = torch.from_numpy(a)
    return jnp.asarray(a), t.long() if a.dtype == np.int32 else t


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


def test_config_is_musicgen_medium():
    cfg = tconfigs.get(ARCH)
    b = cfg.stages[0].unit[0]
    assert (cfg.d_model, cfg.vocab_size, cfg.num_codebooks, cfg.pos_emb,
            cfg.cond_dim, cfg.num_layers) == (1536, 2048, 4, "sinusoidal",
                                              1536, 48)
    assert (b.mixer.num_heads, b.mixer.num_kv_heads, b.mixer.head_dim,
            b.mixer.pos_emb, b.cross.cross, b.ffn.d_ff, b.ffn.gated) == (
        24, 24, 64, "none", True, 6144, False)
    assert b.branch_types() == ("attn", "xattn", "ffn")


def test_init_tree_and_conversion_keep_the_codebook_leaves():
    """The port's init draws an embedding of (K, V, d) and heads of (K, d,
    V) — the JAX tree, shapes and dtypes — and no ``lm_head``;
    ``params_from_numpy`` carries both leaves over unchanged, and neither
    is a token-kernel weight."""
    cfg, tc = _cfgs()
    pj = jax.eval_shape(lambda k: jT.init_params(k, cfg),
                        jax.random.PRNGKey(0))
    pt = tT.init_params(torch.Generator().manual_seed(0), tc)
    lj, _ = jax.tree_util.tree_flatten_with_path(pj)
    lt, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), pt))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lj, lt):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert tuple(pt["embed"].shape) == (K, V, D) and "lm_head" not in pt
    assert tuple(pt["heads"].shape) == (K, D, V)
    pn = _numpy_params()
    conv = params_from_numpy(pn, device="cpu")
    for name in ("embed", "heads"):
        assert np.array_equal(conv[name].numpy(), pn[name])
    ws = {w.data_ptr() for w in tT.token_weights(conv)}
    assert conv["embed"].data_ptr() not in ws
    assert all(not (conv["heads"].data_ptr() <= p < conv["heads"].data_ptr()
                    + conv["heads"].numel() * 4) for p in ws)


def test_codebook_embedding_sums_in_codebook_order_bitwise():
    pj, pt = _params()
    tj, tt = _both(_tokens(3, 7, seed=1))
    want = jT._codebook_embed(pj["embed"], tj)
    got = tT._codebook_embed(pt["embed"], tt)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    e = pt["embed"]
    by_hand = ((e[0][tt[..., 0]] + e[1][tt[..., 1]]) + e[2][tt[..., 2]]) \
        + e[3][tt[..., 3]]
    assert torch.equal(got, by_hand)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh", "relu"])
def test_activations_match_jax(name):
    """MusicGen's MLP is the first on the port's paths to take ``"gelu"``:
    the JAX package's is ``jax.nn.gelu``, the tanh approximation by
    default, not PyTorch's exact ``F.gelu`` (fault 7 of ``ROADMAP.md``'s
    queue 3)."""
    x = 4.0 * _rand(3, 257, seed=30)
    close(jL.activation(name)(jnp.asarray(x)),
          tL.activation(name)(torch.from_numpy(x)))


@pytest.mark.parametrize("prefix", [0, 5], ids=["tokens", "prefix"])
def test_embed_tokens_matches(prefix):
    """Codebooks, then the prefix in front, then sinusoidal positions over
    the whole P + L."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    tj, tt = _both(_tokens(2, 9, seed=2))
    pre = _rand(2, prefix, D, seed=3) if prefix else None
    xj = jT.embed_tokens(cfg, pj, tj,
                         None if pre is None else jnp.asarray(pre))
    xt = tT.embed_tokens(tc, pt, tt,
                         None if pre is None else torch.from_numpy(pre))
    assert tuple(xt.shape) == (2, 9 + prefix, D)
    close(xj, xt)
    close(jL.sinusoidal_embedding(jnp.arange(40), D),
          tL.sinusoidal_embedding(torch.arange(40), D))


def test_codebook_heads_match():
    cfg, tc = _cfgs()
    pj, pt = _params()
    x = _rand(2, 6, D, seed=4)
    lj = jT.logits_from_hidden(cfg, pj, jnp.asarray(x))
    lt = tT.logits_from_hidden(tc, pt, torch.from_numpy(x))
    assert tuple(lt.shape) == (2, 6, K, V)
    close(lj, lt)


def test_forward_with_memory_matches():
    cfg, tc = _cfgs()
    pj, pt = _params()
    tj, tt = _both(_tokens(2, 19, seed=5))
    mj, mt = _both(_memory(2, seed=6))
    lj, _ = jax.jit(lambda p, t, m: jT.forward(cfg, p, t, memory=m))(
        pj, tj, mj)
    lt, _ = tT.forward(tc, pt, tt, memory=mt)
    assert tuple(lt.shape) == (2, 19, K, V)
    close(lj, lt)
    # the memory matters
    other, _ = tT.forward(tc, pt, tt, memory=mt * 2.0)
    assert not torch.allclose(other, lt, atol=1e-3)


def test_prefill_caches_and_decode_with_memory_match():
    """A prefill of 13 frames with a memory, then 8 teacher-forced decode
    steps at positions 13 … 20 (each replacing position 0's sinusoid with
    its own), against the JAX package's and against the port's own
    forward over the whole sequence."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 21, seed=7)
    mj, mt = _both(_memory(2, seed=8))
    plen = 13
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks[:, :plen]), cache_len=21,
                        memory=mj, cache_dtype=jnp.float32)
    lt, ct = tT.prefill(tc, pt, torch.from_numpy(toks[:, :plen]).long(),
                        cache_len=21, memory=mt)
    close(lj, lt)
    _close_caches(cj, ct)
    full, _ = tT.forward(tc, pt, torch.from_numpy(toks).long(), memory=mt)
    step = jax.jit(lambda t, p, c: jT.decode_step(cfg, pj, t, p, c,
                                                  memory=mj))
    for i in range(8):
        sl = slice(plen + i, plen + i + 1)
        lj, cj = step(jnp.asarray(toks[:, sl]), plen + i, cj)
        lt, ct = tT.decode_step(tc, pt, torch.from_numpy(toks[:, sl]).long(),
                                ct, pos=plen + i, memory=mt)
        assert tuple(lt.shape) == (2, 1, K, V)
        close(lj, lt)
        close(full[:, sl], lt)
    _close_caches(cj, ct)


def test_decode_needs_a_position():
    _, tc = _cfgs()
    _, pt = _params()
    _, ct = tT.prefill(tc, pt, torch.from_numpy(_tokens(1, 4)).long(),
                       cache_len=6, memory=torch.zeros(1, 8, MEM))
    with pytest.raises(ValueError, match="pos="):
        tT.decode_step(tc, pt, torch.zeros(1, 1, K, dtype=torch.long), ct,
                       memory=torch.zeros(1, 8, MEM))


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_cross_attention_of_one_row_matches(mode):
    """A decode step's cross branch: one query row over the whole memory,
    in the attention layer's ``mode="full"`` (what the blocks call) and
    ``mode="decode"`` (which returns the cache it was given)."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    spec_j, spec_t = cfg.stages[0].unit[0].cross, tc.stages[0].unit[0].cross
    cj = jax.tree.map(lambda a: a[1], pj["stages"][0][0]["cross"])
    ct = tT.tree_map(lambda a: a[1], pt["stages"][0][0]["cross"])
    x = _rand(3, 1, D, seed=9)
    mj, mt = _both(_memory(3, seed=10))
    oj, _ = jattn.apply(spec_j, cj, jnp.asarray(x), mode=mode, pos=7,
                        memory=mj, positions=jnp.zeros((3, 1), jnp.int32),
                        cache=None, slot_pos=None)
    ot, cache = tattn.apply(spec_t, ct, torch.from_numpy(x), mode=mode,
                            pos=7, memory=mt)
    assert tuple(ot.shape) == (3, 1, D)
    close(oj, ot)
    if mode == "decode":
        assert cache is None


@pytest.mark.parametrize("lk", [64, 8, 77])
def test_plain_attention_at_one_query_row_matches_pallas(lk):
    """The plain version of the attention kernel at a decode step's cross
    shape — one query row (B·H 96 at full width) over the memory, not
    causal — against the JAX Pallas kernel in interpret mode, which pads
    the query rows."""
    q, k, v = (_rand(*s, seed=11 + i) for i, s in enumerate(
        [(2, 1, 4, 32), (2, lk, 4, 32), (2, lk, 4, 32)]))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False)
    close(want, got)


def test_generate_greedy_with_memory_matches():
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(3, 11, seed=12)
    mj, mt = _both(_memory(3, seed=13))
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 8, memory=mj)
    got = tserve.generate(tc, pt, torch.from_numpy(toks).long(), 8,
                          memory=mt, device="cpu")
    assert tuple(got.shape) == (3, 8, K)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--variant", "smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "musicgen-medium-smoke on cpu: generated (2, 3, 4)" in out


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_forward_calls_linear_as_lm_products_books(decode, monkeypatch):
    """Per block: self-attention q, k, v, o over the rows, cross-attention
    q and o over the rows and k, v over the memory's rows (every decode
    step recomputes them, as the JAX package does), the ungated MLP's up
    and down — 10 ``ops.linear`` calls a block, in a prefill and in a
    decode step; the codebook heads are not among them."""
    _, tc = _cfgs()
    _, pt = _params()
    mem = torch.from_numpy(_memory(2, seed=14))
    toks = torch.from_numpy(_tokens(2, 6, seed=15)).long()
    _, caches = tT.prefill(tc, pt, toks[:, :5], cache_len=6, memory=mem)
    seen = []
    real = ops.linear
    monkeypatch.setattr(ops, "linear", lambda x, w, *a, **k: seen.append(
        (x.reshape(-1, x.shape[-1]).shape[0], *w.shape)) or real(x, w, *a,
                                                                 **k))
    if decode:
        tT.decode_step(tc, pt, toks[:, 5:], caches, pos=5, memory=mem)
    else:
        tT.forward(tc, pt, toks, memory=mem)
    rows = 2 if decode else 12
    booked = products.lm_products(tc, rows, decode=decode, memory_rows=16)
    assert len(seen) == 20 == sum(r[-1] for r in booked)
    assert sorted(set(seen)) == sorted({r[1:4] for r in booked})
    assert [r[0] for r in booked] == ["q_o", "k_v", "cross_q_o",
                                      "cross_k_v", "up", "down"]
    assert booked[3] == ("cross_k_v", 16, MEM, D, 4)
