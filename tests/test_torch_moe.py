"""The port's mixture-of-experts FFN and DeepSeek-V3 language model against
the JAX package's, on the same numpy weights and inputs.

The MoE layer alone at d_model 32 (router, ``apply_dense``,
``apply_gshard`` with drops and several groups, ``capacity``, the
load-balance loss, the shared expert), a MoE block in both strategies, and
deepseek-v3-671b smoke — 1 dense block and 1 MoE block (4 experts, top-2,
sigmoid router with a selection bias, scale 2.5, one shared expert), MLA at
smoke widths (4 heads, q_lora 64, kv_lora 64, nope 32, rope 16, v 32), d
128, vocab 512, untied head, an MTP head, f32.  The weights are the JAX
package's init plus a seeded 0.05·N(0,1) on every leaf (so the router bias
and the norm scales matter), handed to both packages through numpy.  The
plain attention at DeepSeek-V3's (192, 128) head dims is held against the
JAX Pallas kernel in interpret mode, on V zero-padded to 192.

Tolerance: 5e-5 (atol and rtol) in f32; the selected experts bitwise;
greedy ``generate`` token for token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import config as jcfg, configs as jconfigs
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.launch import serve as jserve
from repro.models import blocks as jblocks, moe as jmoe, transformer as jT
from repro_torch import config as tcfg, configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as tfa, ops, products, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks, moe as tmoe
from repro_torch.models import transformer as tT
from test_torch_attn_lm import _close_caches
from test_torch_lm import _same

ARCH = "deepseek-v3-671b"
D = 32


def _specs(**kw):
    """The same MoESpec in both packages: 8 experts, top-3, d_ff 48, one
    shared expert 40 wide, sigmoid router, scale 2.5 unless ``kw`` says
    otherwise."""
    kw = {"num_experts": 8, "top_k": 3, "d_ff": 48, "num_shared": 1,
          "d_ff_shared": 40, "router": "sigmoid", "router_scale": 2.5, **kw}
    return jcfg.MoESpec(**kw), tcfg.MoESpec(**kw)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def _moe_params(spec, seed=0):
    """(jax params, torch params on the CPU) of one MoE FFN, equal."""
    pn = _noisy(jmoe.init(jax.random.PRNGKey(seed), spec, D), seed + 1)
    return jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(b, l, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["sigmoid", "softmax"])
@pytest.mark.parametrize("norm_topk", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_matches(router, norm_topk, ties):
    """Weights and probabilities within tolerance, the selected experts
    bitwise.  ``ties``: the router's columns 1 and 3, and 0 and 7, are the
    same (and so are their biases), so those experts' scores tie exactly
    on both sides; ``jax.lax.top_k`` takes the lower index, as must the
    port."""
    sj, st = _specs(router=router, norm_topk=norm_topk)
    pj, pt = _moe_params(sj, seed=3)
    if ties:
        pn = jax.tree.map(np.array, pj)
        for a, b in ((3, 1), (7, 0)):
            pn["router"][:, a] = pn["router"][:, b]
            if router == "sigmoid":
                pn["router_bias"][a] = pn["router_bias"][b]
        pj = jax.tree.map(jnp.asarray, pn)
        pt = params_from_numpy(pn, device="cpu")
    x = _rand(4, 9, D, seed=4)
    wj, ij, probj = jmoe.route(sj, pj, jnp.asarray(x))
    wt, it, probt = tmoe.route(st, pt, torch.from_numpy(x))
    if ties:
        sel = tmoe.selection_scores(st, pt, probt).numpy()
        assert (sel[..., 3] == sel[..., 1]).all()
        assert (sel[..., 7] == sel[..., 0]).all()
        assert (np.asarray(probj)[..., 3] == np.asarray(probj)[..., 1]).all()
        # a tied pair sits at the top-k's edge somewhere
        both = (it == 1).any(-1) ^ (it == 3).any(-1)
        assert both.any()
    assert it.dtype == torch.int64 and tuple(it.shape) == (4, 9, 3)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    close(wj, wt)
    close(probj, probt)


def test_route_bias_moves_selection_not_weights():
    """The selection bias picks the experts; the weights are the bias-free
    probabilities at them, renormalized and scaled by 2.5."""
    _, st = _specs()
    _, pt = _moe_params(_specs()[0])
    x = torch.from_numpy(_rand(2, 5, D, seed=5))
    pt["router_bias"] = torch.zeros(8)
    pt["router_bias"][6] = 10.0
    w, idx, probs = tmoe.route(st, pt, x)
    assert (idx[..., 0] == 6).all()
    want = torch.gather(probs, -1, idx)
    want = want / want.sum(-1, keepdim=True) * 2.5
    assert torch.allclose(w, want, atol=1e-6)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

CASES = [(4, 2, "sigmoid"), (8, 3, "sigmoid"), (8, 2, "softmax"),
         (6, 1, "softmax")]


@pytest.mark.parametrize("experts,top_k,router", CASES)
def test_apply_dense_matches(experts, top_k, router):
    sj, st = _specs(num_experts=experts, top_k=top_k, router=router)
    pj, pt = _moe_params(sj, seed=experts + top_k)
    x = _rand(2, 11, D, seed=6)
    oj, aj = jmoe.apply_dense(sj, pj, jnp.asarray(x))
    ot, at = tmoe.apply_dense(st, pt, torch.from_numpy(x))
    close(oj, ot)
    close(aj, at)


@pytest.mark.parametrize("experts,top_k,router", CASES)
@pytest.mark.parametrize("group", [64, 16], ids=["one_group", "4_groups"])
def test_apply_gshard_matches(experts, top_k, router, group):
    """64 tokens in one group or four, capacity ≥ each expert's load at the
    default factor — and equal to the dense oracle where nothing drops."""
    sj, st = _specs(num_experts=experts, top_k=top_k, router=router)
    pj, pt = _moe_params(sj, seed=experts)
    x = _rand(2, 32, D, seed=7)
    oj, aj = jmoe.apply_gshard(sj, pj, jnp.asarray(x), group_size=group)
    ot, at = tmoe.apply_gshard(st, pt, torch.from_numpy(x), group_size=group)
    close(oj, ot)
    close(aj, at)
    if tmoe.capacity(st, group) >= group:
        close(tmoe.apply_dense(st, pt, torch.from_numpy(x))[0], ot)


@pytest.mark.parametrize("group", [64, 32], ids=["one_group", "2_groups"])
def test_apply_gshard_drops_the_same_tokens(group):
    """A tiny capacity factor (capacity 8 of ~32 pairs an expert): the
    (token, slot) pairs past each expert's 8 rows, in (t, k) order, add
    nothing — the same pairs on both sides, the tokens whose every pair
    dropped zero (top-1, no shared expert: the reference's
    ``test_moe_capacity_drops_tokens``)."""
    sj, st = _specs(num_experts=2, top_k=1, num_shared=0, d_ff_shared=0,
                    router="softmax", router_scale=1.0, capacity_factor=0.01)
    pj, pt = _moe_params(sj, seed=11)
    x = _rand(1, 64, D, seed=8)
    oj, _ = jmoe.apply_gshard(sj, pj, jnp.asarray(x), group_size=group)
    ot, _ = tmoe.apply_gshard(st, pt, torch.from_numpy(x), group_size=group)
    close(oj, ot)
    zj = np.linalg.norm(np.asarray(oj), axis=-1) < 1e-6
    zt = ot.norm(dim=-1).numpy() < 1e-6
    assert zt.sum() == 64 - 2 * 8 * (64 // group)
    np.testing.assert_array_equal(zj, zt)
    # with top-2 and a shared expert, partial drops
    sj, st = _specs(num_experts=4, top_k=2, capacity_factor=0.05)
    pj, pt = _moe_params(sj, seed=12)
    oj, _ = jmoe.apply_gshard(sj, pj, jnp.asarray(x), group_size=group)
    ot, _ = tmoe.apply_gshard(st, pt, torch.from_numpy(x), group_size=group)
    close(oj, ot)
    assert not torch.allclose(ot, tmoe.apply_dense(st, pt,
                                                   torch.from_numpy(x))[0])


def test_apply_gshard_refuses_a_group_that_does_not_divide():
    _, st = _specs()
    _, pt = _moe_params(_specs()[0])
    with pytest.raises(ValueError, match="not divisible by group size 16"):
        tmoe.apply_gshard(st, pt, torch.zeros(2, 15, D), group_size=16)
    with pytest.raises(ValueError, match="strategy"):
        tmoe.apply(st, pt, torch.zeros(2, 16, D), strategy="grouped")


@pytest.mark.parametrize("experts,top_k,cf", [(4, 2, 0.0), (32, 8, 0.0),
                                              (256, 8, 0.0), (8, 1, 2.0),
                                              (2, 1, 0.01)])
def test_capacity_matches(experts, top_k, cf):
    sj, st = _specs(num_experts=experts, top_k=top_k, capacity_factor=cf)
    for t in (1, 2, 4, 7, 8, 63, 64, 200, 1000, 2048, 4096):
        assert tmoe.capacity(st, t) == jmoe.capacity(sj, t)
    assert tmoe.capacity(_specs(num_experts=32, top_k=8)[1], 4) == 8
    assert tmoe.capacity(_specs(num_experts=32, top_k=8)[1], 2048) == 640


def test_apply_picks_the_strategy():
    sj, st = _specs()
    pj, pt = _moe_params(sj)
    x = _rand(1, 8, D, seed=9)
    for strategy in ("dense", "gshard"):
        oj, _ = jmoe.apply(sj, pj, jnp.asarray(x), strategy=strategy,
                           group_size=4)
        ot, _ = tmoe.apply(st, pt, torch.from_numpy(x), strategy=strategy,
                           group_size=4)
        close(oj, ot)


# ---------------------------------------------------------------------------
# Load balance and the shared expert
# ---------------------------------------------------------------------------

def test_load_balance_loss_uniform_is_one_and_matches():
    _, st = _specs(num_experts=4, top_k=1)
    probs = torch.full((1, 64, 4), 0.25)
    idx = (torch.arange(64) % 4).reshape(1, 64, 1)
    assert abs(float(tmoe.load_balance_loss(st, probs, idx)) - 1.0) < 1e-6
    sj, st = _specs()
    rng = np.random.default_rng(10)
    p = rng.random((3, 7, 8)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    i = np.argsort(-rng.random((3, 7, 8)), axis=-1)[..., :3]
    close(jmoe.load_balance_loss(sj, jnp.asarray(p), jnp.asarray(i)),
          tmoe.load_balance_loss(st, torch.from_numpy(p),
                                 torch.from_numpy(i)))


@pytest.mark.parametrize("strategy", ["dense", "gshard"])
def test_shared_expert_is_always_applied(strategy):
    """Zeroing the shared expert takes exactly its FFN off the output."""
    sj, st = _specs()
    _, pt = _moe_params(sj)
    x = torch.from_numpy(_rand(1, 4, D, seed=12))
    with_shared, _ = tmoe.apply(st, pt, x, strategy=strategy, group_size=4)
    p2 = dict(pt, shared={k: torch.zeros_like(v)
                          for k, v in pt["shared"].items()})
    without, _ = tmoe.apply(st, p2, x, strategy=strategy, group_size=4)
    assert torch.allclose(with_shared - without,
                          tmoe._shared_ffn(st, pt, x), atol=1e-6)


# ---------------------------------------------------------------------------
# deepseek-v3-671b smoke
# ---------------------------------------------------------------------------

def _cfgs():
    return jconfigs.get(ARCH, "smoke"), tconfigs.get(ARCH, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params():
    cfg, _ = _cfgs()
    init = jax.jit(jT.init_params, static_argnums=1)
    return _noisy(init(jax.random.PRNGKey(0), cfg), 23)


def _params():
    pn = _numpy_params()
    return (jax.tree.map(jnp.asarray, pn),
            params_from_numpy(pn, device="cpu"))


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_matches_jax(variant):
    _same(tconfigs.get(ARCH, variant), jconfigs.get(ARCH, variant))


def test_configs_are_deepseek_v3_widths():
    full = tconfigs.get(ARCH)
    m = full.stages[0].unit[0].mixer
    f = full.stages[1].unit[0].ffn
    assert [st.repeat for st in full.stages] == [3, 58]
    assert (full.d_model, full.vocab_size, full.tie_embeddings,
            full.mtp_depth) == (7168, 129280, False, 1)
    assert (m.num_heads, m.q_lora_rank, m.kv_lora_rank, m.nope_head_dim,
            m.rope_head_dim, m.v_head_dim) == (128, 1536, 512, 128, 64, 128)
    assert full.stages[0].unit[0].ffn.d_ff == 18432
    assert (f.num_experts, f.top_k, f.d_ff, f.num_shared, f.d_ff_shared,
            f.router, f.router_scale, f.norm_topk) == (
        256, 8, 2048, 1, 2048, "sigmoid", 2.5, True)
    smoke = tconfigs.get(ARCH, "smoke").stages[1].unit[0].ffn
    assert (smoke.num_experts, smoke.top_k, smoke.d_ff, smoke.num_shared,
            smoke.d_ff_shared) == (4, 2, 128, 1, 128)


def test_init_params_tree_matches_jax_and_converts():
    """The port's init draws other numbers into the JAX tree — the MoE
    FFN's router, router_bias, stacked experts and shared expert, and the
    MTP head — with the same shapes and dtypes; ``params_from_numpy``
    carries the JAX tree over leaf for leaf."""
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
    ffn = pt["stages"][1][0]["ffn"]
    assert set(ffn) == {"router", "router_bias", "w_up", "w_gate", "w_down",
                        "shared"}
    assert tuple(ffn["w_up"].shape) == (1, 4, 128, 128)
    assert not ffn["router_bias"].any()
    assert set(pt["mtp"]) == {"h_norm", "e_norm", "proj", "block"}
    pn = _numpy_params()
    conv = params_from_numpy(pn, device="cpu")
    ln, _ = jax.tree_util.tree_flatten_with_path(pn)
    lc, _ = jax.tree_util.tree_flatten_with_path(
        tT.tree_map(lambda a: a.numpy(), conv))
    assert [p for p, _ in ln] == [p for p, _ in lc]
    for (path, a), (_, b) in zip(ln, lc):
        assert np.array_equal(a, b), path


def test_token_weights_take_every_expert_and_leave_out_mtp():
    """The dense block's 5 MLA and 3 MLP products; the MoE block's 5 MLA,
    the router, 4 experts × 3 (views ``a[r][e]``) and the shared 3 — none
    of the MTP head's."""
    _, pt = _params()
    ws = tT.token_weights(pt)
    assert len(ws) == 8 + 5 + 1 + 12 + 3
    up = pt["stages"][1][0]["ffn"]["w_up"]
    assert any(w.data_ptr() == up[0][2].data_ptr()
               and w.shape == up[0][2].shape for w in ws)
    mtp = {a.data_ptr() for a in jax.tree_util.tree_leaves(pt["mtp"])}
    assert all(w.dim() == 2 and w.data_ptr() not in mtp for w in ws)


@pytest.mark.parametrize("strategy", ["dense", "gshard"])
def test_moe_block_matches(strategy):
    """The MoE block (MLA + MoE FFN), full mode: output, both branches and
    the load-balance loss; ``with_aux=False`` keeps the 3-tuple."""
    cfg, tc = _cfgs()
    sj, st = cfg.stages[1].unit[0], tc.stages[1].unit[0]
    pj, pt = _params()
    bj = jax.tree.map(lambda a: a[0], pj["stages"][1][0])
    bt = tT.tree_map(lambda a: a[0], pt["stages"][1][0])
    x = _rand(2, 12, 128, seed=13)
    pos = np.arange(12)[None, :]
    xj, oj, _, aj = jax.jit(lambda p, h, ps: jblocks.apply(
        sj, p, h, mode="full", d_model=128, positions=ps,
        moe_strategy=strategy, moe_group_size=8))(
        bj, jnp.asarray(x), jnp.asarray(pos))
    xt, ot, _, at = tblocks.apply(st, bt, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos),
                                  moe_strategy=strategy, moe_group_size=8,
                                  with_aux=True)
    close(xj, xt)
    close(oj["mixer"], ot["mixer"])
    close(oj["ffn"], ot["ffn"])
    close(aj, at)
    assert len(tblocks.apply(st, bt, torch.from_numpy(x),
                             positions=torch.from_numpy(pos),
                             moe_strategy=strategy, moe_group_size=8)) == 3


@pytest.mark.parametrize("strategy", ["dense", "gshard"])
def test_forward_logits_and_aux_match(strategy):
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 21, seed=1)
    lj, auxj = jax.jit(lambda p, t: jT.forward(cfg, p, t,
                                               moe_strategy=strategy))(
        pj, jnp.asarray(toks))
    lt, auxt = tT.forward(tc, pt, torch.from_numpy(toks).long(),
                          moe_strategy=strategy)
    assert lt.shape == (2, 21, 512)
    close(lj, lt)
    close(auxj["aux"], auxt["aux"])
    assert float(auxt["aux"]) > 0


def test_prefill_logits_and_caches_match():
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 21, seed=2)
    lj, cj = jT.prefill(cfg, pj, jnp.asarray(toks), cache_len=29,
                        cache_dtype=jnp.float32, moe_strategy="dense")
    lt, ct = tT.prefill(tc, pt, torch.from_numpy(toks).long(), cache_len=29,
                        moe_strategy="dense")
    close(lj, lt)
    _close_caches(cj, ct)
    assert sorted(ct[1][0]) == ["ckv", "krope", "slots"]


def test_decode_teacher_forced_matches():
    """8 gshard decode steps (group 2, capacity 8) at positions 21 … 28
    against the JAX package's, and against the port's own dense forward
    over the whole sequence."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(2, 29, seed=3)
    plen = 21
    _, cj = jT.prefill(cfg, pj, jnp.asarray(toks[:, :plen]), cache_len=29,
                       cache_dtype=jnp.float32, moe_strategy="dense")
    _, ct = tT.prefill(tc, pt, torch.from_numpy(toks[:, :plen]).long(),
                       cache_len=29, moe_strategy="dense")
    full, _ = tT.forward(tc, pt, torch.from_numpy(toks).long(),
                         moe_strategy="dense")
    step = jax.jit(lambda t, p, c: jT.decode_step(cfg, pj, t, p, c))
    for i in range(8):
        tj = jnp.asarray(toks[:, plen + i: plen + i + 1])
        tt = torch.from_numpy(toks[:, plen + i: plen + i + 1]).long()
        lj, cj = step(tj, plen + i, cj)
        lt, ct = tT.decode_step(tc, pt, tt, ct, pos=plen + i)
        close(lj, lt)
        close(full[:, plen + i: plen + i + 1], lt)
    _close_caches(cj, ct)


def test_generate_greedy_matches():
    """Dense prefill, gshard decode, on both sides."""
    cfg, tc = _cfgs()
    pj, pt = _params()
    toks = _tokens(3, 17, seed=4)
    want = jserve.generate(cfg, pj, jnp.asarray(toks), 8)
    got = tserve.generate(tc, pt, torch.from_numpy(toks).long(), 8,
                          device="cpu")
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--variant", "smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "deepseek-v3-671b-smoke on cpu: generated (2, 3)" in out


# ---------------------------------------------------------------------------
# The products and the card's cut
# ---------------------------------------------------------------------------

def test_lm_cut_takes_a_count_per_stage():
    cut = products.lm_cut(tconfigs.get(ARCH), (1, 2))
    assert [st.repeat for st in cut.stages] == [1, 2]
    assert cut.d_model == 7168 and cut.num_layers == 3
    assert products.lm_cut(tconfigs.get("minicpm3-4b"), 4).num_layers == 4
    assert products.lm_cut(tconfigs.get("minicpm3-4b"), (4,)).num_layers == 4
    with pytest.raises(ValueError, match="block counts"):
        products.lm_cut(tconfigs.get(ARCH), 3)
    with pytest.raises(ValueError, match="whole number"):
        products.lm_cut(tconfigs.get(ARCH), (0, 2))


def _card_cut():
    cfg = products.lm_cut(tconfigs.get(ARCH), (1, 2))
    moe = dataclasses.replace(cfg.stages[1].unit[0].ffn, num_experts=32)
    st = dataclasses.replace(cfg.stages[1], unit=(dataclasses.replace(
        cfg.stages[1].unit[0], ffn=moe),))
    return cfg.replace(stages=(cfg.stages[0], st), mtp_depth=0)


def test_lm_products_book_moe_products():
    """1 dense + 2 MoE blocks with 32 experts: 218 products in a prefill (8
    a dense block, 105 a MoE block: its 5 MLA products, the router, 32 × 3
    experts over every token, the shared 3) and 215 in a decode step (no
    kv_b; each expert over its 8 capacity rows)."""
    cfg = _card_cut()
    pre = products.lm_products(cfg, 4096)
    dec = products.lm_products(cfg, 4, decode=True)
    assert sum(r[-1] for r in pre) == 218 and sum(r[-1] for r in dec) == 215
    assert pre[5:] == [("up_gate", 4096, 7168, 18432, 2),
                       ("down", 4096, 18432, 7168, 1),
                       ("router", 4096, 7168, 32, 2),
                       ("expert_up_gate", 4096, 7168, 2048, 128),
                       ("expert_down", 4096, 2048, 7168, 64),
                       ("shared_up_gate", 4096, 7168, 2048, 4),
                       ("shared_down", 4096, 2048, 7168, 2)]
    assert [r[:2] for r in dec if r[0].startswith("expert")] == [
        ("expert_up_gate", 8), ("expert_down", 8)]
    assert pre[:5] == [("q_a", 4096, 7168, 1536, 3),
                       ("q_b", 4096, 1536, 24576, 3),
                       ("kv_a", 4096, 7168, 576, 3),
                       ("kv_b", 4096, 512, 32768, 3),
                       ("o", 4096, 16384, 7168, 3)]


@pytest.mark.parametrize("strategy", ["dense", "gshard"])
def test_moe_forward_calls_linear_as_lm_products_books(strategy,
                                                       monkeypatch):
    """The smoke forward's ``ops.linear`` calls in either strategy: 8 for
    the dense block and 5 + 1 + 4 × 3 + 3 for the MoE block (every expert,
    empty or not), as ``lm_products`` books them; the head is not one."""
    _, tc = _cfgs()
    _, pt = _params()
    seen = []
    real = ops.linear
    monkeypatch.setattr(ops, "linear",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    tT.forward(tc, pt, torch.from_numpy(_tokens(2, 8)).long(),
               moe_strategy=strategy, moe_group_size=16)
    assert len(seen) == 29 == sum(r[-1] for r in
                                  products.lm_products(tc, 16))


# ---------------------------------------------------------------------------
# The attention kernel at (192, 128)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_192_128_matches_pallas_on_padded_v(causal):
    """``flash_attention_ref`` with q and k 192 wide and v 128 (DeepSeek-V3's
    MLA) against the JAX Pallas kernel (interpret mode), which takes one
    head dim: V zero-padded to 192, its output sliced to 128."""
    rng = np.random.default_rng(192)
    q = rng.standard_normal((2, 40, 4, 192)).astype(np.float32)
    k = rng.standard_normal((2, 40, 4, 192)).astype(np.float32)
    v = rng.standard_normal((2, 40, 4, 128)).astype(np.float32)
    vp = np.pad(v, ((0, 0),) * 3 + ((0, 64),))
    want = pallas_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp),
                     causal=causal, block_q=32, block_k=32,
                     interpret=True)[..., :128]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, 40, 4, 128)
    close(want, got)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=causal), got)


def test_kernel_wrapper_takes_deepseek_v3_head_dims():
    """(192, 128) passes every check but the device's, as a strided view of
    the kv_b product the way ``_mla_full`` hands it over."""
    q = torch.zeros(2, 16, 4, 192)
    kvb = torch.zeros(2, 16, 4, 256)
    assert tfa.plan(q, q, kvb[..., 128:])["load"] == "cp.async"
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_cuda(q, q, kvb[..., 128:])
