"""The port's prefix-embedding LM (InternVL2-1B) and its serving programs
against the JAX package's, on the same numpy weights, prompts and patch
embeddings: internvl2-1b smoke — 2 blocks of causal GQA (4 query heads ×
32 over 1 KV head, QKV bias, RoPE θ 1e6), a gated SiLU MLP of 256,
rmsnorm, embeddings of 512 tied to the head, 8 prefix embeddings, d 128,
f32.  The weights are the JAX package's init plus a seeded 0.05·N(0,1) on
every leaf, handed to both packages through numpy.

Covers ``launch.programs``: ``make_prefill_step`` with the prefix (the
logits of the last position and the caches of all P + L positions) and
``make_serve_step`` at positions P + L + i, against the JAX package's
factories, the port's own forward and greedy decoding; the JAX package's
prefill step without ``cache_len`` under a prefix (fault 6 of
``ROADMAP.md``'s queue 3) against the port's default; and
``adapt_for_shape``.

Tolerance: 5e-5 (atol and rtol) in f32; greedy tokens equal.  The JAX
package's programs keep their caches in bf16 (``CACHE_DTYPE``); the tests
set it to f32 there, the port's dtype.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import config as jconfig, configs as jconfigs
from repro.launch import programs as jprog
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import programs as tprog
from repro_torch.models import transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "internvl2-1b"
V, D, P = 512, 128, 8


@pytest.fixture(autouse=True)
def _f32_reference_caches(monkeypatch):
    monkeypatch.setattr(jprog, "CACHE_DTYPE", jnp.float32)


def _cfgs():
    return jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params():
    cfg, _ = _cfgs()
    p = jax.jit(jT.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(31)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _params():
    pn = _numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _tokens(b, l, seed=0):
    return np.random.default_rng(seed).integers(0, V, (b, l)).astype(
        np.int32)


def _prefix(b, seed=0, n=P):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (b, n, D))).astype(np.float32)


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


def test_config_is_internvl2_1b():
    cfg = tconfigs.get(ARCH)
    m = cfg.stages[0].unit[0].mixer
    assert (cfg.d_model, cfg.vocab_size, cfg.tie_embeddings,
            cfg.num_prefix_embeds, cfg.num_layers) == (896, 151655, True,
                                                       256, 24)
    assert (m.num_heads, m.num_kv_heads, m.head_dim, m.qkv_bias,
            m.rope_theta) == (14, 2, 64, True, 1e6)
    assert tconfigs.get(ARCH, "smoke").num_prefix_embeds == P


@pytest.mark.parametrize("prefix", [0, P], ids=["tokens", "prefix"])
def test_forward_with_a_prefix_matches(prefix):
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 13, seed=1)
    pre = _prefix(2, seed=2, n=prefix) if prefix else None
    lj, _ = jT.forward(cfg, pj, jnp.asarray(toks), prefix_embeds=(
        None if pre is None else jnp.asarray(pre)))
    lt, _ = tT.forward(tc, pt, torch.from_numpy(toks).long(),
                       prefix_embeds=(None if pre is None
                                      else torch.from_numpy(pre)))
    assert tuple(lt.shape) == (2, 13 + prefix, V)
    close(lj, lt)


def test_prefill_step_and_serve_steps_match():
    """The prefill step over 8 prefix embeddings and 13 tokens (caches of
    29 slots), then 8 teacher-forced serve steps at positions 21 … 28:
    against the JAX package's factories, and each step against the port's
    own forward over prefix + all the tokens."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 21, seed=3)
    pre = _prefix(2, seed=4)
    plen, clen = 13, P + 21
    lj, cj = jprog.make_prefill_step(cfg, clen)(
        pj, jnp.asarray(toks[:, :plen]), jnp.asarray(pre))
    lt, ct = tprog.make_prefill_step(tc, clen)(
        pt, torch.from_numpy(toks[:, :plen]).long(), torch.from_numpy(pre))
    assert tuple(lt.shape) == (2, 1, V) and lt.is_contiguous()
    close(lj, lt)
    _close_caches(cj, ct)
    assert ct[0][0]["slots"][0, :P + plen].tolist() == list(range(P + plen))
    full, _ = tT.forward(tc, pt, torch.from_numpy(toks).long(),
                         prefix_embeds=torch.from_numpy(pre))
    close(full[:, P + plen - 1:P + plen], lt)
    for i in range(8):
        pos = P + plen + i
        tok = toks[:, plen + i:plen + i + 1]
        lj, cj = jax.jit(jprog.make_serve_step(cfg, pos))(
            pj, jnp.asarray(tok), cj)
        lt, ct = tprog.make_serve_step(tc, pos)(
            pt, torch.from_numpy(tok).long(), ct)
        close(lj, lt)
        close(full[:, pos:pos + 1], lt)
    _close_caches(cj, ct)


def test_programs_decode_greedily_as_the_reference():
    """Greedy decoding of 6 tokens after a prefix through both packages'
    programs: the same tokens."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks, pre = _tokens(3, 10, seed=5), _prefix(3, seed=6)
    clen = P + 10 + 6
    lj, cj = jprog.make_prefill_step(cfg, clen)(pj, jnp.asarray(toks),
                                                jnp.asarray(pre))
    lt, ct = tprog.make_prefill_step(tc, clen)(
        pt, torch.from_numpy(toks).long(), torch.from_numpy(pre))
    got, want = [], []
    for i in range(6):
        tj, tt = jnp.argmax(lj, -1), torch.argmax(lt, -1)
        want.append(np.asarray(tj))
        got.append(tt.numpy())
        if i == 5:
            break
        lj, cj = jprog.make_serve_step(cfg, P + 10 + i)(pj, tj, cj)
        lt, ct = tprog.make_serve_step(tc, P + 10 + i)(pt, tt, ct)
    np.testing.assert_array_equal(np.concatenate(want, 1),
                                  np.concatenate(got, 1))


def test_reference_prefill_step_default_cache_len_drops_the_prefix():
    """Fault 6 (the JAX package is wrong; the port differs on purpose):
    without ``cache_len`` the JAX package's prefill step sizes the caches
    by the tokens alone, L slots for P + L positions, so the last P + 1
    positions land in slot L − 1 and the serve step that follows attends
    to L of the P + L + 1 positions.  The port's default counts the
    prefix: every position keeps its slot.  With ``cache_len`` given, the
    JAX package's agrees with its own forward."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    plen = 13
    toks, pre = _tokens(2, plen + 1, seed=7), _prefix(2, seed=8)
    full, _ = jT.forward(cfg, pj, jnp.asarray(toks),
                         prefix_embeds=jnp.asarray(pre))
    want = np.asarray(full[:, P + plen:P + plen + 1])
    tok = jnp.asarray(toks[:, plen:])

    def reference(cache_len):
        _, c = jprog.make_prefill_step(cfg, cache_len)(
            pj, jnp.asarray(toks[:, :plen]), jnp.asarray(pre))
        lg, c = jprog.make_serve_step(cfg, P + plen)(pj, tok, c)
        return np.array(lg), np.array(c[0][0]["slots"][0])

    lg, slots = reference(None)
    assert slots.shape == (plen,)
    assert slots.tolist() == list(range(plen - 1)) + [P + plen]
    assert np.abs(lg - want).max() > 1e-2
    lg, _ = reference(P + plen + 1)
    close(want, torch.from_numpy(lg))
    _, ct = tprog.make_prefill_step(tc)(
        pt, torch.from_numpy(toks[:, :plen]).long(), torch.from_numpy(pre))
    assert ct[0][0]["slots"][0].tolist() == list(range(P + plen))


@pytest.mark.parametrize("arch", ["internvl2-1b", "qwen3-14b",
                                  "mamba2-1.3b", "gemma2-9b",
                                  "llama4-maverick-400b-a17b",
                                  "musicgen-medium"])
@pytest.mark.parametrize("shape", ["long_500k", "decode_32k"])
def test_adapt_for_shape_matches(arch, shape):
    """long_500k gives a full-attention arch a window of ``swa_window`` (a
    smaller window kept, cross-attention untouched); every other shape,
    and an SSM, keep the config."""
    cfg = jconfigs.get(arch)
    _same(tprog.adapt_for_shape(tconfigs.get(arch), jconfig.SHAPES[shape]),
          jprog.adapt_for_shape(cfg, jconfig.SHAPES[shape]))
