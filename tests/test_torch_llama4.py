"""The port's Llama-4 (Maverick) against the JAX package's, on the same
numpy weights, prompts and patch embeddings: llama4-maverick-400b-a17b
smoke — one unit of 4 blocks (local RoPE dense, local RoPE MoE, local
RoPE dense, global NoPE MoE), 4 query heads × 32 over 1 KV head, the local
window 16, dense MLPs of 256, MoE FFNs of 4 experts at top-1 (a sigmoid
router without renormalization, one shared expert), 8 prefix embeddings,
d 128, an untied head of 512, f32.  The weights are the JAX package's init
plus a seeded 0.05·N(0,1) on every leaf, handed to both packages through
numpy.

Covers ``moe.route`` at top-1 without ``norm_topk`` (selections bitwise,
ties to the lower index), both dispatches at top-1, the NoPE global block
(no rotation: positions do not move its output), the forward with a
prefix, the prefill step and gshard serve steps past the local window
with each MoE block's selections bitwise, greedy ``generate`` and
``lm_products``.

Tolerance: 5e-5 (atol and rtol) in f32; selections bitwise; greedy tokens
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import configs as jconfigs
from repro.launch import programs as jprog, serve as jserve
from repro.models import blocks as jblocks, moe as jmoe, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, products
from repro_torch.launch import programs as tprog, serve as tserve
from repro_torch.models import blocks as tblocks, moe as tmoe
from repro_torch.models import transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "llama4-maverick-400b-a17b"
V, D, P = 512, 128, 8


@pytest.fixture(autouse=True)
def _f32_reference_caches(monkeypatch):
    monkeypatch.setattr(jprog, "CACHE_DTYPE", jnp.float32)


def _cfgs():
    return jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@functools.lru_cache(maxsize=None)
def _numpy_params():
    cfg, _ = _cfgs()
    init = jax.jit(jT.init_params, static_argnums=1)
    return _noisy(init(jax.random.PRNGKey(0), cfg), 37)


def _params():
    pn = _numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


def _tokens(b, l, seed=0):
    return np.random.default_rng(seed).integers(0, V, (b, l)).astype(
        np.int32)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def _recorded(module, fn):
    """Run ``fn`` with ``module.route`` recording each call's selected
    experts as numpy."""
    seen, real = [], module.route

    def route(spec, params, x):
        out = real(spec, params, x)
        seen.append(np.array(out[1]))
        return out
    module.route = route
    try:
        return fn(), seen
    finally:
        module.route = real


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


def test_config_is_llama4_maverick():
    cfg = tconfigs.get(ARCH)
    unit = cfg.stages[0].unit
    assert (cfg.d_model, cfg.vocab_size, cfg.tie_embeddings,
            cfg.num_prefix_embeds, cfg.num_layers) == (5120, 202048, False,
                                                       256, 48)
    assert [(b.mixer.window, b.mixer.pos_emb) for b in unit] == [
        (8192, "rope"), (8192, "rope"), (8192, "rope"), (None, "none")]
    assert [b.mixer.rope_theta for b in unit] == [500000.0] * 4
    moe = unit[1].ffn
    assert (moe.num_experts, moe.top_k, moe.d_ff, moe.num_shared,
            moe.d_ff_shared, moe.router, moe.norm_topk) == (
        128, 1, 8192, 1, 8192, "sigmoid", False)
    assert unit[0].ffn.d_ff == 16384 and unit[3].ffn == moe
    smoke = tconfigs.get(ARCH, "smoke")
    assert smoke.stages[0].unit[1].ffn.top_k == 1
    assert smoke.num_prefix_embeds == P


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_at_top1_without_renormalization(ties):
    """The smoke's router at top-1, ``norm_topk`` off: the selected expert
    bitwise, the weight the bias-free probability itself.  ``ties``:
    router columns 2 and 0 the same (and their biases), so every token
    ties them; the lower index wins on both sides."""
    cfg, tc = _cfgs()
    sj, st = cfg.stages[0].unit[1].ffn, tc.stages[0].unit[1].ffn
    pn = jax.tree.map(np.array, jax.tree.map(
        lambda a: a[0], _numpy_params()["stages"][0][1]["ffn"]))
    if ties:
        pn["router"][:, 2] = pn["router"][:, 0]
        pn["router_bias"][:] = 0.0
        pn["router_bias"][2] = pn["router_bias"][0] = 1.0
    x = _rand(3, 11, D, seed=1)
    wj, ij, probj = jmoe.route(sj, jax.tree.map(jnp.asarray, pn),
                               jnp.asarray(x))
    pt = params_from_numpy(pn, device="cpu")
    wt, it, probt = tmoe.route(st, pt, torch.from_numpy(x))
    assert tuple(it.shape) == (3, 11, 1)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    if ties:
        assert (it == 0).all()
    close(wj, wt)
    close(probj, probt)
    assert torch.equal(wt, torch.gather(probt, -1, it))


@pytest.mark.parametrize("strategy", ["dense", "gshard"])
@pytest.mark.parametrize("group", [32, 8], ids=["one_group", "4_groups"])
def test_moe_ffn_at_top1_matches(strategy, group):
    """Llama-4's MoE FFN (top-1, the shared expert) in both dispatches;
    under gshard an expert takes 16 rows of a group of 32 and 8 (the
    floor) of a group of 8."""
    cfg, tc = _cfgs()
    sj, st = cfg.stages[0].unit[1].ffn, tc.stages[0].unit[1].ffn
    pj, pt = _params()
    fj = jax.tree.map(lambda a: a[0], pj["stages"][0][1]["ffn"])
    ft = tT.tree_map(lambda a: a[0], pt["stages"][0][1]["ffn"])
    x = _rand(2, 16, D, seed=2)
    oj, aj = jmoe.apply(sj, fj, jnp.asarray(x), strategy=strategy,
                        group_size=group)
    ot, at = tmoe.apply(st, ft, torch.from_numpy(x), strategy=strategy,
                        group_size=group)
    close(oj, ot)
    close(aj, at)
    assert tmoe.capacity(st, group) == jmoe.capacity(sj, group) == (
        16 if group == 32 else 8)


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_nope_global_block_matches(mode):
    """The global block (no window, no RoPE, MoE FFN) against the JAX
    package's, in full mode at two offsets (the same output: nothing
    rotates) and as one decode step over a cache of 24 slots."""
    cfg, tc = _cfgs()
    sj, st = cfg.stages[0].unit[3], tc.stages[0].unit[3]
    assert st.mixer.pos_emb == "none" and st.mixer.window is None
    pj, pt = _params()
    bj = jax.tree.map(lambda a: a[0], pj["stages"][0][3])
    bt = tT.tree_map(lambda a: a[0], pt["stages"][0][3])
    x = _rand(2, 12, D, seed=3)
    if mode == "full":
        outs = []
        for off in (0, 5):
            pos = np.arange(off, off + 12)[None, :]
            xj, oj, _, _ = jblocks.apply(
                sj, bj, jnp.asarray(x), mode="full", d_model=D,
                positions=jnp.asarray(pos), moe_strategy="dense")
            xt, ot, _ = tblocks.apply(st, bt, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos),
                                      moe_strategy="dense")
            close(xj, xt)
            close(oj["mixer"], ot["mixer"])
            outs.append(xt)
        assert torch.equal(outs[0], outs[1])
        return
    cache_j = {"k": jnp.asarray(_rand(2, 1, 32, 24, seed=4)),
               "v": jnp.asarray(_rand(2, 1, 24, 32, seed=5)),
               "slots": jnp.asarray(np.r_[np.arange(20), [-1] * 4]
                                    .astype(np.int32))}
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    xj, _, cj, _ = jblocks.apply(sj, bj, jnp.asarray(x[:, :1]), mode="decode",
                                 d_model=D, pos=20, cache=cache_j)
    xt, _, ct = tblocks.apply(st, bt, torch.from_numpy(x[:, :1]),
                              mode="decode", pos=20, cache=cache_t)
    close(xj, xt)
    for name in ("k", "v"):
        close(cj[name], ct[name])
    np.testing.assert_array_equal(np.asarray(cj["slots"]),
                                  ct["slots"].numpy())


@pytest.mark.parametrize("strategy", ["dense", "gshard"])
def test_forward_with_a_prefix_matches(strategy):
    """Logits over 8 prefix embeddings + 20 tokens (past the local window
    of 16), and every MoE call's selected experts bitwise."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks, pre = _tokens(2, 20, seed=6), _rand(2, P, D, seed=7, scale=0.02)
    (lj, auxj), rj = _recorded(jmoe, lambda: jT.forward(
        cfg, pj, jnp.asarray(toks), prefix_embeds=jnp.asarray(pre),
        moe_strategy=strategy))
    (lt, auxt), rt = _recorded(tmoe, lambda: tT.forward(
        tc, pt, torch.from_numpy(toks).long(),
        prefix_embeds=torch.from_numpy(pre), moe_strategy=strategy))
    assert tuple(lt.shape) == (2, P + 20, V)
    close(lj, lt)
    close(auxj["aux"], auxt["aux"])
    assert len(rj) == len(rt) == 2
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a.reshape(b.shape), b)


def test_prefill_step_and_gshard_serve_steps_match():
    """The prefill step (dense) over 8 prefix embeddings and 14 tokens,
    caches of 32 slots (the local blocks' ring of 16), then 10 gshard
    serve steps at positions 22 … 31 against the JAX package's factories,
    the selections bitwise, and each step against the port's own dense
    forward."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks, pre = _tokens(2, 24, seed=8), _rand(2, P, D, seed=9, scale=0.02)
    plen, clen = 14, P + 24
    (lj, cj), rj = _recorded(jmoe, lambda: jprog.make_prefill_step(
        cfg, clen, moe_strategy="dense")(pj, jnp.asarray(toks[:, :plen]),
                                         jnp.asarray(pre)))
    (lt, ct), rt = _recorded(tmoe, lambda: tprog.make_prefill_step(
        tc, clen, moe_strategy="dense")(
        pt, torch.from_numpy(toks[:, :plen]).long(), torch.from_numpy(pre)))
    close(lj, lt)
    _close_caches(cj, ct)
    assert tuple(ct[0][0]["k"].shape) == (1, 2, 1, 32, 16)
    assert tuple(ct[0][3]["k"].shape) == (1, 2, 1, 32, clen)
    full, _ = tT.forward(tc, pt, torch.from_numpy(toks).long(),
                         prefix_embeds=torch.from_numpy(pre),
                         moe_strategy="dense")
    for i in range(10):
        pos = P + plen + i
        tok = toks[:, plen + i:plen + i + 1]
        (lj, cj), sj = _recorded(jmoe, lambda: jprog.make_serve_step(
            cfg, pos)(pj, jnp.asarray(tok), cj))
        (lt, ct), st = _recorded(tmoe, lambda: tprog.make_serve_step(
            tc, pos)(pt, torch.from_numpy(tok).long(), ct))
        close(lj, lt)
        close(full[:, pos:pos + 1], lt)
        rj, rt = rj + sj, rt + st
    _close_caches(cj, ct)
    assert len(rj) == len(rt) == 2 + 2 * 10
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a.reshape(b.shape), b)


def test_generate_greedy_matches():
    """Dense prefill, gshard decode, on both sides (no prefix: the JAX
    package's ``generate`` takes none)."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(3, 17, seed=10)
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 8)
    got = tserve.generate(tc, pt, torch.from_numpy(toks).long(), 8,
                          device="cpu")
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--variant", "smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "llama4-maverick-400b-a17b-smoke on cpu: generated (2, 3)" in out


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_forward_calls_linear_as_lm_products_books(decode, monkeypatch):
    """The RoPE and NoPE mixers are one set of widths (4 products each);
    the dense MLPs' 3, the MoE blocks' router, 4 experts × 3 (each over
    all rows in a dense prefill, over its 8 capacity rows in a gshard
    decode step) and the shared 3: 54 calls."""
    _, tc = _cfgs()
    _, pt = _params()
    toks = torch.from_numpy(_tokens(2, 6, seed=11)).long()
    _, caches = tT.prefill(tc, pt, toks[:, :5], cache_len=6,
                           moe_strategy="dense")
    seen = []
    real = ops.linear
    monkeypatch.setattr(ops, "linear", lambda x, w, *a, **k: seen.append(
        (x.reshape(-1, x.shape[-1]).shape[0], *w.shape)) or real(x, w, *a,
                                                                 **k))
    if decode:
        tT.decode_step(tc, pt, toks[:, 5:], caches, pos=5)
    else:
        tT.forward(tc, pt, toks, moe_strategy="dense")
    booked = products.lm_products(tc, 2 if decode else 12, decode=decode)
    assert len(seen) == 54 == sum(r[-1] for r in booked)
    assert sorted(set(seen)) == sorted({r[1:4] for r in booked})
    assert [r[:2] for r in booked if r[0].startswith("expert")] == [
        ("expert_up_gate", 8 if decode else 12),
        ("expert_down", 8 if decode else 12)]
