"""The port's RG-LRU and RecurrentGemma against the JAX package's, on the
same numpy weights and inputs: the scan's plain version against the JAX
gates and ``associative_scan``, the mixer in full and decode mode, a block,
and the recurrentgemma-2b smoke — (rec, rec, attn) + (rec, rec), d_model
128, 2 gate heads of 64, MQA 4 × 32 over 1 KV head with a window of 16,
gated GELU-tanh MLP d_ff 256, tied embeddings scaled by √d, vocab 512,
f32.  The weights are the JAX package's init plus a seeded 0.05·N(0,1) on
every leaf (so the zero-initialized biases and norm scales matter), handed
to both packages through numpy; the prompts (24 tokens, past the window)
come from numpy.  Also the reference's fault on prompts shorter than the
conv (its decode step fails; the port's pads the conv tail), and the
products helpers on the hybrid stack.

Tolerance: 5e-5 (atol and rtol) in f32 throughout; greedy ``generate``
token for token.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import configs as jconfigs
from repro.config import RGLRUSpec as JRGLRUSpec
from repro.configs.common import smoke_variant as jsmoke_variant
from repro.launch import serve as jserve
from repro.models import blocks as jblocks, rglru as jrglru
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.config import RGLRUSpec
from repro_torch.configs.common import smoke_variant as tsmoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import products, ref
from repro_torch.kernels import rglru as krglru
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks, rglru as trglru
from repro_torch.models import transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "recurrentgemma-2b"
PROMPT = 24          # past the smoke window of 16
D = 128


def _cfgs(repeats=1):
    full_j, full_t = jconfigs.get(ARCH), tconfigs.get(ARCH)
    if repeats == 1:
        return jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")
    return (jsmoke_variant(full_j, d_model=D, unit_repeats=repeats),
            tsmoke_variant(full_t, d_model=D, unit_repeats=repeats))


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@functools.lru_cache(maxsize=None)
def _numpy_params(repeats=1):
    cfg, _ = _cfgs(repeats)
    return _perturbed(jT.init_params(jax.random.PRNGKey(0), cfg), 19)


def _params(repeats=1):
    """(jax params, torch params on the CPU) with identical values."""
    pn = _numpy_params(repeats)
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


@functools.lru_cache(maxsize=None)
def _numpy_mixer(heads, w, spread=False):
    """One RG-LRU mixer's leaves (d_model = W); ``spread``: Λ set so that
    a at r = 1 spans 0.5 … 0.999."""
    spec = JRGLRUSpec(num_heads=heads)
    p = _perturbed(jrglru.init(jax.random.PRNGKey(3), spec, w), 23)
    if spread:
        a = np.linspace(0.5, 0.999, w)
        p["a_param"] = np.log(np.expm1(-np.log(a) / spec.c_constant)).astype(
            np.float32)
    return spec, p


def _tokens(b, l, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tspec(spec):
    return RGLRUSpec(**dataclasses.asdict(spec))


# ---------------------------------------------------------------------------
# The scan's plain version
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=0)
def _jax_scan(spec, p, xr, gate, h0=None):
    """The JAX package's gates and associative scan from h0 (folded into
    the first step): (y = h ⊙ gate, h at the last step)."""
    log_a, gated = jrglru._gates(spec, p, xr)
    a = jnp.exp(log_a)
    if h0 is not None:
        gated = gated.at[:, 0].add(a[:, 0] * h0)

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    _, h = jax.lax.associative_scan(combine, (a, gated), axis=1)
    return h * gate, h[:, -1]


def _gate_products(spec, p, xr):
    """ga, gx: the JAX package's block-diagonal products with biases."""
    nh = spec.num_heads
    return (jrglru._block_diag(p["wa"], xr, nh) + p["ba"],
            jrglru._block_diag(p["wx"], xr, nh) + p["bx"])


@functools.lru_cache(maxsize=None)
def _scan_case(b, l, w, heads, with_h0):
    """One scan case's numpy inputs, the JAX gate products and the JAX
    package's (y, hT), computed once for every ``impl``."""
    spec, p = _numpy_mixer(heads, w, spread=True)
    pj = jax.tree.map(jnp.asarray, p)
    xr = _rand(b, l, w, seed=l)
    gate = _rand(b, l, w, seed=l + 1)
    h0 = _rand(b, w, seed=l + 2) if with_h0 else None
    ga, gx = _gate_products(spec, pj, jnp.asarray(xr))
    yj, hj = _jax_scan(spec, pj, jnp.asarray(xr), jnp.asarray(gate),
                       None if h0 is None else jnp.asarray(h0))
    return spec, p, xr, gate, h0, np.asarray(ga), np.asarray(gx), yj, hj


T = krglru.CHUNK
# the plain scans: the doubling scan, and the kernel's chunked decomposition
# at chunk lengths 1, 7, the kernel's, 64 and one past L
SCAN_IMPLS = ["doubling", "chunk1", "chunk7", f"chunk{T}", "chunk64",
              "chunk_past_l"]


def _scan_impl(impl, l):
    if impl == "doubling":
        return ref.rglru_scan_ref
    chunk = l + 1 if impl == "chunk_past_l" else int(impl[5:])
    return functools.partial(ref.rglru_scan_chunked_ref, chunk=chunk)


@pytest.mark.parametrize("b,l,w,heads", [
    (2, 1, 16, 2), (2, 7, 32, 4), (1, 40, 24, 3), (3, 64, 64, 2),
    (2, 300, 40, 5),
    # either side of the kernel's chunk boundaries
    (2, T - 1, 32, 2), (1, T, 24, 3), (2, T + 1, 16, 2),
    (2, 3 * T + 5, 40, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("impl", SCAN_IMPLS)
def test_scan_ref_matches_jax_gates_and_associative_scan(b, l, w, heads,
                                                          with_h0, impl):
    spec, p, xr, gate, h0, ga, gx, yj, hj = _scan_case(b, l, w, heads,
                                                       with_h0)
    yt, ht = _scan_impl(impl, l)(_t(xr), _t(ga), _t(gx), _t(gate),
                                 _t(p["a_param"]), spec.c_constant,
                                 None if h0 is None else _t(h0))
    assert yt.dtype == ht.dtype == torch.float32
    assert yt.shape == (b, l, w) and ht.shape == (b, w)
    close(yj, yt)
    close(hj, ht)
    a = torch.exp(ref.rglru_gates(_t(xr), _t(ga), _t(gx), _t(p["a_param"]),
                                  spec.c_constant)[0])
    # the decays span the slow and the fast channels
    assert float(a.min()) < 0.8 and float(a.max()) > 0.99


def test_scan_ref_is_the_jax_decode_step_at_one_token():
    """At L = 1 from the cached state, the plain scan is the JAX
    ``apply_decode``'s step: its new state, and its output after ``out``."""
    spec, p = _numpy_mixer(2, 32)
    pj = jax.tree.map(jnp.asarray, p)
    x = jnp.asarray(_rand(2, 1, 32, seed=5))
    cache = {"conv": jnp.asarray(_rand(2, 3, 32, seed=6)),
             "h": jnp.asarray(_rand(2, 32, seed=7))}
    out_j, new_j = jrglru.apply_decode(spec, pj, x, cache, 32)
    gate = jax.nn.gelu(x @ pj["in_gate"])
    win = jnp.concatenate([cache["conv"], x @ pj["in_x"]], axis=1)
    xr = (jnp.einsum("bkw,kw->bw", win, pj["conv_w"]) + pj["conv_b"])[:, None]
    ga, gx = _gate_products(spec, pj, xr)
    y, h = ref.rglru_scan_ref(_t(xr), _t(ga), _t(gx), _t(gate),
                              _t(p["a_param"]), spec.c_constant,
                              _t(cache["h"]))
    close(new_j["h"], h)
    close(out_j, y @ _t(p["out"]))


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l", [3, 24])
def test_mixer_full_matches_jax(l):
    spec, p = _numpy_mixer(2, 32)
    x = _rand(2, l, 32, seed=8)
    out_j, cache_j = jrglru.apply_full(spec, jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), 32)
    out_t, cache_t = trglru.apply_full(_tspec(spec),
                                       params_from_numpy(p, device="cpu"),
                                       _t(x), 32)
    close(out_j, out_t)
    assert sorted(cache_t) == ["conv", "h"]
    close(cache_j["conv"], cache_t["conv"])
    close(cache_j["h"], cache_t["h"])
    assert cache_t["h"].dtype == torch.float32


def test_mixer_decode_matches_jax_and_the_full_pass():
    """12 decode steps from a zero cache against the JAX package's steps
    (output and both cache leaves) and against the port's full pass over
    the same 12 tokens, as ``tests/test_models.py::
    test_rglru_scan_matches_stepwise`` holds the reference."""
    spec, p = _numpy_mixer(2, 32)
    pj, pt, ts = (jax.tree.map(jnp.asarray, p),
                  params_from_numpy(p, device="cpu"), _tspec(spec))
    x = _rand(2, 12, 32, seed=9)
    full, full_cache = trglru.apply_full(ts, pt, _t(x), 32)
    cj = jrglru.init_cache(spec, 32, 2)
    ct = trglru.init_cache(ts, 32, 2)
    for t in range(12):
        oj, cj = jrglru.apply_decode(spec, pj, jnp.asarray(x[:, t:t + 1]),
                                     cj, 32)
        ot, ct = trglru.apply_decode(ts, pt, _t(x[:, t:t + 1]), ct, 32)
        close(oj, ot)
        close(full[:, t:t + 1], ot)
        close(cj["conv"], ct["conv"])
        close(cj["h"], ct["h"])
    close(full_cache["h"], ct["h"])
    close(full_cache["conv"], ct["conv"])


@pytest.mark.parametrize("l", [1, 2])
def test_short_prompt_reference_fault_and_the_ports_padded_tail(l):
    """The JAX ``apply_full`` keeps only L < K - 1 = 3 rows of the conv
    tail, and its decode step then fails in its einsum.  The port pads the
    tail with the zeros the causal conv sees, so a prefill of L tokens and
    a decode step give the port's full pass over L + 1 tokens."""
    spec, p = _numpy_mixer(2, 32)
    pj, pt, ts = (jax.tree.map(jnp.asarray, p),
                  params_from_numpy(p, device="cpu"), _tspec(spec))
    x = _rand(2, l + 1, 32, seed=10)
    _, cj = jrglru.apply_full(spec, pj, jnp.asarray(x[:, :l]), 32)
    assert cj["conv"].shape[1] == l
    with pytest.raises(ValueError, match="does not match"):
        jrglru.apply_decode(spec, pj, jnp.asarray(x[:, l:]), cj, 32)
    _, ct = trglru.apply_full(ts, pt, _t(x[:, :l]), 32)
    assert tuple(ct["conv"].shape) == (2, 3, 32)
    assert not ct["conv"][:, :3 - l].any()
    step, _ = trglru.apply_decode(ts, pt, _t(x[:, l:]), ct, 32)
    full, _ = trglru.apply_full(ts, pt, _t(x), 32)
    close(full[:, l:], step)


# ---------------------------------------------------------------------------
# Blocks and the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_branch_types_match_jax(variant):
    """Every block's SmoothCache types, ``rglru`` for the recurrent ones."""
    tcfg, jcfg = tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant)
    tb = [b.branch_types() for _, _, _, b in tcfg.blocks()]
    jb = [b.branch_types() for st in jcfg.stages for _ in range(st.repeat)
          for b in st.unit]
    assert tb == jb and len(tb) == tcfg.num_layers
    assert tb[:3] == [("rglru", "ffn"), ("rglru", "ffn"), ("attn", "ffn")]
    assert tcfg.layer_types() == jcfg.layer_types() == ("rglru", "ffn",
                                                        "attn")


def test_smoke_config_is_the_hybrid_cut():
    _, tcfg = _cfgs()
    assert [st.repeat for st in tcfg.stages] == [1, 1]
    assert [len(st.unit) for st in tcfg.stages] == [3, 2]
    rec, attn = tcfg.stages[0].unit[0].mixer, tcfg.stages[0].unit[2].mixer
    assert (rec.num_heads, rec.conv_width, rec.expand) == (2, 4, 1)
    assert (attn.num_heads, attn.num_kv_heads, attn.head_dim,
            attn.window) == (4, 1, 32, 16)
    assert tcfg.tie_embeddings and tcfg.embed_scale
    assert tcfg.vocab_size == 512


def test_init_params_tree_matches_jax():
    """The port's init makes the JAX tree, leaf for leaf in shape and
    dtype (the gates stacked (repeat, heads, hd, hd)); ``params_from_numpy``
    carries the JAX tree over."""
    _, tcfg = _cfgs()
    pj = _numpy_params()      # the JAX init's tree, perturbed in f32
    pt = tT.init_params(torch.Generator().manual_seed(0), tcfg)
    lj, _ = jax.tree_util.tree_flatten_with_path(pj)
    lt, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), pt))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lj, lt):
        assert a.shape == b.shape and np.asarray(a).dtype == b.dtype, path
    mixer = pt["stages"][0][0]["mixer"]
    assert tuple(mixer["wa"].shape) == (1, 2, 64, 64)
    # a at r = 1 in [0.9, 0.999], as the reference draws Λ
    a = torch.exp(-8.0 * ref.softplus(mixer["a_param"]))
    assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    pn = pj
    conv = params_from_numpy(pn, device="cpu")
    lc, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), conv))
    ln, _ = jax.tree_util.tree_flatten_with_path(pn)
    assert [p for p, _ in lc] == [p for p, _ in ln]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(lc, ln))


def test_token_weights_list_every_gate_head():
    """in_x, in_gate and out, and one view ``wa[r][h]`` / ``wx[r][h]`` per
    head: 3 + 2 · 2 products per RG-LRU block at the smoke's 2 heads, q, k,
    v and o per attention block, the MLP's 3 per block."""
    _, tcfg = _cfgs()
    _, pt = _params()
    ws = tT.token_weights(pt)
    rec = sum(isinstance(b.mixer, RGLRUSpec) for _, _, _, b in tcfg.blocks())
    attn = tcfg.num_layers - rec
    assert len(ws) == rec * (3 + 2 * 2) + attn * 4 + tcfg.num_layers * 3
    wa = pt["stages"][0][0]["mixer"]["wa"]
    assert any(w.data_ptr() == wa[0][1].data_ptr()
               and w.shape == wa[0][1].shape for w in ws)


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_block_matches_jax(mode):
    """An RG-LRU block: the block output, its mixer and FFN branch outputs
    and the state cache, in full mode over 24 tokens and in decode mode
    from a random cache.  A SmoothCache skip of the mixer fed its recorded
    output gives the same block output bitwise and keeps the cache."""
    cfg, tcfg = _cfgs()
    sj, st = cfg.stages[0].unit[0], tcfg.stages[0].unit[0]
    pj, pt = _params()
    bj = jax.tree.map(lambda a: a[0], pj["stages"][0][0])
    bt = tT.tree_map(lambda a: a[0], pt["stages"][0][0])
    l = PROMPT if mode == "full" else 1
    x = _rand(2, l, D, seed=3)
    kw_j, kw_t = {}, {}
    if mode == "decode":
        cache = {"conv": _rand(2, 3, D, seed=4), "h": _rand(2, D, seed=5)}
        kw_j = {"cache": jax.tree.map(jnp.asarray, cache)}
        kw_t = {"cache": tT.tree_map(_t, cache)}
    xj, oj, cj, _ = jblocks.apply(sj, bj, jnp.asarray(x), mode=mode,
                                  d_model=D, **kw_j)
    xt, ot, ct = tblocks.apply(st, bt, _t(x), mode=mode, **kw_t)
    close(xj, xt)
    assert sorted(oj) == sorted(ot) == ["ffn", "mixer"]
    for name in oj:
        close(oj[name], ot[name])
    assert sorted(cj) == sorted(ct) == ["conv", "h"]
    for name in cj:
        close(cj[name], ct[name])
    skipped, bo, kept = tblocks.apply(
        st, bt, _t(x), mode=mode, skip={"rglru": True},
        branch_cache={"mixer": ot["mixer"]}, **kw_t)
    assert torch.equal(skipped, xt) and list(bo) == ["ffn"]
    assert kept is kw_t.get("cache")


def test_block_init_cache_is_the_state():
    _, tcfg = _cfgs()
    c = tblocks.init_cache(tcfg.stages[0].unit[0], D, 3)
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "conv": (3, 3, D), "h": (3, D)}
    assert all(v.dtype == torch.float32 and not v.any() for v in c.values())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_forward_logits_match():
    """24 tokens: the window binds on the attention block's last 8 query
    rows."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, PROMPT)
    lj, _ = jT.forward(cfg, pj, jnp.asarray(toks))
    lt, _ = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    assert lt.shape == (2, PROMPT, 512)
    close(lj, lt)


def test_prefill_caches_match():
    """The RG-LRU blocks' conv tails and states and the attention block's
    ring of 16 slots (positions 8 … 23 in slots ``pos % 16``)."""
    cfg, tcfg = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, PROMPT, seed=1)
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks), cache_len=32,
                        cache_dtype=jnp.float32)
    lt, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks).long(),
                        cache_len=32)
    close(lj, lt)
    _close_caches(cj, ct)
    (r0, r1, attn), (r2, r3) = ct
    for c in (r0, r1, r2, r3):
        assert tuple(c["conv"].shape) == (1, 2, 3, D)
        assert tuple(c["h"].shape) == (1, 2, D)
    assert attn["slots"].tolist() == [[8 + (s - 8) % 16 for s in range(16)]]
    assert tuple(attn["k"].shape) == (1, 2, 1, 32, 16)


def _teacher_forced(repeats, steps):
    """Prefill 24 tokens, then ``steps`` decode steps against the JAX
    package's (logits and caches) and against the port's own forward;
    returns the port's caches before and after the last step."""
    cfg, tcfg = _cfgs(repeats)
    pj, pt = _params(repeats)
    toks = _tokens(2, PROMPT + steps, seed=2)
    clen = PROMPT + steps
    _, cj = jT.prefill(cfg, pj, jnp.asarray(toks[:, :PROMPT]),
                       cache_len=clen, cache_dtype=jnp.float32)
    _, ct = tT.prefill(tcfg, pt, torch.from_numpy(toks[:, :PROMPT]).long(),
                       cache_len=clen)
    full, _ = tT.forward(tcfg, pt, torch.from_numpy(toks).long())
    jstep = jax.jit(lambda tok, p, c: jT.decode_step(cfg, pj, tok, p, c))
    before = ct
    for i in range(steps):
        p = PROMPT + i
        lj, cj = jstep(jnp.asarray(toks[:, p:p + 1]), p, cj)
        before = ct
        lt, ct = tT.decode_step(tcfg, pt,
                                torch.from_numpy(toks[:, p:p + 1]).long(),
                                ct, pos=p)
        close(lj, lt)
        close(full[:, p:p + 1], lt)
    _close_caches(cj, ct)
    return before, ct


def test_decode_teacher_forced_matches():
    """8 decode steps at positions 24 … 31, each overwriting a slot of the
    attention block's ring."""
    _, ct = _teacher_forced(1, 8)
    assert sorted(ct[0][2]["slots"][0].tolist()) == list(range(16, 32))


def test_hybrid_unit_keeps_state_caches_stacked():
    """A unit repeated twice: a decode step updates the attention block's
    KV cache in place and restacks the RG-LRU blocks' states (repeat, ...),
    the JAX package's layout, step for step against it."""
    before, after = _teacher_forced(2, 3)
    r0, r1, attn = after[0]
    assert tuple(r0["h"].shape) == (2, 2, D)
    assert tuple(r1["conv"].shape) == (2, 2, 3, D)
    assert attn["k"] is before[0][2]["k"] and attn["v"] is before[0][2]["v"]
    assert r0["h"] is not before[0][0]["h"]


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
    assert "recurrentgemma-2b-smoke on cpu: generated (2, 4)" in out


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def test_lm_products_on_the_hybrid_stack():
    """18 RG-LRU blocks — in_x, in_gate, 10 heads × 2 gate products, out —
    and 8 attention blocks (q and o one shape: 10 × 256 = d), 26 MLPs: 524
    calls in the prefill and in a decode step."""
    cfg = tconfigs.get(ARCH)
    for rows, decode in ((6144, False), (2, True)):
        got = products.lm_products(cfg, rows, decode=decode)
        assert got == [("in_x", rows, 2560, 2560, 18),
                       ("in_gate", rows, 2560, 2560, 18),
                       ("gate_heads", rows, 256, 256, 360),
                       ("out", rows, 2560, 2560, 18),
                       ("q_o", rows, 2560, 2560, 16),
                       ("k_v", rows, 2560, 256, 16),
                       ("up_gate", rows, 2560, 7680, 52),
                       ("down", rows, 7680, 2560, 26)]
        assert sum(r[-1] for r in got) == 524
    mamba = tconfigs.get("mamba2-1.3b")
    with pytest.raises(ValueError, match="neither attention nor RG-LRU"):
        products.lm_products(mamba, 4)


# the output for the configs lm_products served before the hybrid came,
# at a prefill's 4096 rows and a decode step's 4
SERVED = {
    "qwen3-14b": (80, 40, 5120, 5120, 1024, 17408),
    "qwen2.5-14b": (96, 48, 5120, 5120, 1024, 13824),
}


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2.5-14b", "gemma2-9b",
                                  "minicpm3-4b", "deepseek-v3-671b"])
def test_lm_products_unchanged_for_the_attention_lms(arch):
    cfg = tconfigs.get(arch)
    pre = products.lm_products(cfg, 4096)
    dec = products.lm_products(cfg, 4, decode=True)
    if arch in SERVED:
        c2, c1, d, hd, kv, ff = SERVED[arch]
        for rows, got in ((4096, pre), (4, dec)):
            assert got == [("q_o", rows, d, hd, c2), ("k_v", rows, d, kv, c2),
                           ("up_gate", rows, d, ff, c2),
                           ("down", rows, ff, d, c1)]
    elif arch == "gemma2-9b":
        for rows, got in ((4096, pre), (4, dec)):
            assert got == [("q", rows, 3584, 4096, 42),
                           ("k_v", rows, 3584, 2048, 84),
                           ("o", rows, 4096, 3584, 42),
                           ("up_gate", rows, 3584, 14336, 84),
                           ("down", rows, 14336, 3584, 42)]
    elif arch == "minicpm3-4b":
        assert pre == [("q_a", 4096, 2560, 768, 62),
                       ("q_b", 4096, 768, 3840, 62),
                       ("kv_a", 4096, 2560, 288, 62),
                       ("kv_b", 4096, 256, 5120, 62),
                       ("o", 4096, 2560, 2560, 62),
                       ("up_gate", 4096, 2560, 6400, 124),
                       ("down", 4096, 6400, 2560, 62)]
        assert dec == [r[:1] + (4,) + r[2:] for r in pre if r[0] != "kv_b"]
    else:
        assert pre == [("q_a", 4096, 7168, 1536, 61),
                       ("q_b", 4096, 1536, 24576, 61),
                       ("kv_a", 4096, 7168, 576, 61),
                       ("kv_b", 4096, 512, 32768, 61),
                       ("o", 4096, 16384, 7168, 61),
                       ("up_gate", 4096, 7168, 18432, 6),
                       ("down", 4096, 18432, 7168, 3),
                       ("router", 4096, 7168, 256, 58),
                       ("expert_up_gate", 4096, 7168, 2048, 29696),
                       ("expert_down", 4096, 2048, 7168, 14848),
                       ("shared_up_gate", 4096, 7168, 2048, 116),
                       ("shared_down", 4096, 2048, 7168, 58)]
        assert dec == [r[:1] + ((8,) if r[0].startswith("expert") else (4,))
                       + r[2:] for r in pre if r[0] != "kv_b"]


def test_ops_rglru_scan_takes_the_plain_version_on_the_cpu():
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    xr, ga, gx, gate = (_t(_rand(2, 5, 8, seed=s)) for s in range(4))
    a = _t(_rand(8, seed=4))
    y, h = ops.rglru_scan(xr, ga, gx, gate, a, 8.0)
    want = ref.rglru_scan_ref(xr, ga, gx, gate, a, 8.0)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "stride", "shape", "h0",
                                 "a_param", "grid"])
def test_kernel_wrapper_refuses_what_it_does_not_take(bad):
    """Every refusal but the device's shows on CPU tensors; a strided W
    axis is refused, never copied; past the grid's 2^31 - 1 blocks (stride-0
    views, so nothing that large is allocated)."""
    t = [_t(_rand(2, 5, 8, seed=s)) for s in range(4)]
    a, h0 = _t(_rand(8, seed=4)), None
    match = "CUDA"
    if bad == "dtype":
        t[1], match = t[1].double(), "float32"
    elif bad == "stride":
        t[2], match = _t(_rand(2, 5, 16, seed=9))[..., ::2], "unit stride"
    elif bad == "shape":
        t[3], match = t[3][:, :4], "gate"
    elif bad == "h0":
        h0, match = _t(_rand(3, 8, seed=5)), "h0"
    elif bad == "a_param":
        a, match = a[:7], "a_param"
    elif bad == "grid":
        # 2^16 rows × 2^16 chunks × one tile of channels = 2^32 blocks
        big = torch.zeros(1, 1, 8).expand(2 ** 16, 2 ** 16 * T, 8)
        t, match = [big] * 4, "grid"
        assert krglru.blocks(*big.shape) > krglru.MAX_GRID_X
    with pytest.raises(ValueError, match=match):
        krglru.rglru_scan_cuda(*t, a, 8.0, h0)


@pytest.mark.parametrize("b,l,w", [(65536, 1, 8), (2, 2 ** 20, 2560),
                                   (1, 2 ** 31 - 1, 1)])
def test_kernel_wrapper_takes_what_its_grid_holds(b, l, w):
    """Shapes under the grid's limit reach the device check, a batch past
    65535 among them (stride-0 views on the CPU)."""
    assert krglru.blocks(b, l, w) <= krglru.MAX_GRID_X
    big = torch.zeros(1, 1, w).expand(b, l, w)
    with pytest.raises(ValueError, match="CUDA"):
        krglru.rglru_scan_cuda(big, big, big, big, torch.zeros(w), 8.0)


def test_kernel_constants_match_the_source():
    """The wrapper's chunk and block width are the ones ``rglru.cu`` is
    compiled with (the built library's chunk is checked again on load)."""
    src = krglru.SOURCE.read_text()
    for name in ("CHUNK", "THREADS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(krglru, name), name


@pytest.mark.parametrize("l,launches,chunks", [
    (1, 1, 1), (T - 1, 1, 1), (T, 1, 1), (T + 1, 3, 2), (3 * T + 5, 3, 4),
    (3072, 3, -(-3072 // T))])
def test_kernel_plan_by_length(l, launches, chunks):
    """One launch and no scratch up to a chunk (a decode step); past it
    three, with summaries for every chunk but the last."""
    assert len(krglru.plan(l)) == launches
    assert krglru.plan(l)[-1] == "rglru_output"
    assert krglru.scratch_shape(2, l, 2560) == (2, chunks - 1, 2560)
    assert krglru.blocks(2, l, 2560) == 2 * chunks * 20


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_rglru_ab_variant_is_the_source_at_another_chunk(chunk):
    """``rglru_ab --chunks`` builds the current source with only its chunk
    length changed."""
    from repro_torch.kernels import rglru_ab
    src = krglru.SOURCE.read_text()
    var = rglru_ab.variant_source(chunk)
    assert f"constexpr int CHUNK = {chunk};" in var
    assert var.replace(f"CHUNK = {chunk};", f"CHUNK = {T};") == src


def test_rglru_ab_needs_a_card(monkeypatch, tmp_path):
    from repro_torch.kernels import rglru_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        rglru_ab.main([str(tmp_path / "rglru.cu")])


def test_pass_totals_sum_a_trace_by_pass():
    """A trace's device time and launches are summed by the scan's three
    passes; other kernels are left out."""
    kern = {"(anonymous namespace)::rglru_summary(Args)": [30.0, 10],
            "(anonymous namespace)::rglru_carry(Args)": [4.0, 10],
            "(anonymous namespace)::rglru_output(Args)": [50.0, 9],
            "rglru_output(Args)": [5.0, 1],
            "void at::native::elementwise_kernel<128, 2>": [7.0, 3]}
    assert krglru.pass_totals(kern) == {"rglru_summary": [30.0, 10],
                                        "rglru_carry": [4.0, 10],
                                        "rglru_output": [55.0, 10]}
    assert krglru.pass_totals({}) == {}


def test_passes_are_the_sources_kernels_in_launch_order():
    """``PASSES`` names ``rglru.cu``'s kernels in the order the entry point
    launches them, and the library exports its count of each."""
    src = krglru.SOURCE.read_text()
    assert re.findall(r"__global__ void.*?\b(rglru_\w+)\(", src) == list(
        krglru.PASSES)
    entry = src[src.index('extern "C" int rglru_scan_f32'):]
    order = [entry.index(f"{k}<<<") for k in krglru.PASSES]
    assert order == sorted(order)
    for i, k in enumerate(krglru.PASSES):
        launch = entry.index(f"{k}<<<")
        assert entry.index(f"++launched[{i}]", launch) < min(
            [entry.index(f"{n}<<<") for n in krglru.PASSES[i + 1:]]
            or [len(entry)])
    assert 'extern "C" void rglru_launched(long long* out)' in src


def test_chip_smoke_names_the_scan_passes():
    """``chip_smoke.py`` reads the SASS of the scan's three passes and
    holds each to f32 FMAs."""
    import chip_smoke as cs
    assert cs.SASS_KERNELS["rglru"] == krglru.PASSES
    assert set(cs.SASS_KERNELS["rglru"]) <= set(cs.FFMA_KERNELS)
