"""The redesigned linear kernels' plain parts, on the CPU: the TF32 split the
token kernel's prepared weights carry (``ref.tf32_split``), its 3xTF32
arithmetic (``ref.linear_3xtf32``) against JAX's ``x @ w`` at ``highest``
precision, the variant plan (``gemm.plan``: nothing in it follows M), the
prepared-weight cache (``gemm.prepare`` / ``release``), and which variant
each product of the DiT forward asks for (``ops.linear(rows=)``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import smoke_cfgs, smoke_params
from repro_torch.core import diffusion
from repro_torch.kernels import gemm, ops, ref

D = 1152
# (K, N, rows) of every DiT-XL/2 product
DIT = [(16, D, "tokens"), (256, D, "requests"), (D, D, "requests"),
       (D, 6 * D, "requests"), (D, D, "tokens"), (D, 4 * D, "tokens"),
       (4 * D, D, "tokens"), (D, 2 * D, "requests"), (D, 16, "tokens")]
FLT_MAX = float(np.finfo(np.float32).max)


def cvt_rna(v):
    """``cvt.rna.tf32.f32`` in float64 arithmetic, written apart from the
    kernel's integer trick: keep 10 bits after the leading one (the f32
    exponent floor of -126 for subnormals), round half away from zero, and
    overflow past the largest TF32 value to inf."""
    out = np.empty_like(v)
    for i, x in enumerate(v.astype(np.float64)):
        if x == 0 or np.isinf(x):
            out[i] = v[i]
            continue
        e = max(np.frexp(abs(x))[1] - 1, -126)
        q = 2.0 ** (e - 10)
        r = np.floor(abs(x) / q + 0.5) * q
        out[i] = np.copysign(np.inf if r >= 2.0 ** 128 else r, x)
    return out


def _bits(*u):
    return np.array(u, np.uint32).view(np.float32)


EDGES = np.concatenate([
    np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
              1 + 2 ** -11 - 2 ** -23, 1.5, -2.75, 0.0, -0.0, np.inf,
              -np.inf, FLT_MAX, -FLT_MAX], np.float32),
    # the largest value that stays finite; the smallest subnormal; a tie
    # among subnormals; the largest subnormal (rounds up to the smallest
    # normal); a normal tie just above it
    _bits(0x7F7FEFFF, 0xFF7FEFFF, 0x00000001, 0x80001000, 0x00001000,
          0x007FFFFF, 0x00801000, 0x00800FFF)])


def test_split_rounds_edges_as_cvt_rna():
    got = ref.tf32_round(torch.from_numpy(EDGES)).numpy()
    assert np.array_equal(got.view(np.uint32), cvt_rna(EDGES).view(np.uint32))
    big, small = ref.tf32_split(torch.from_numpy(EDGES[np.isfinite(EDGES)]))
    assert torch.equal(big, ref.tf32_round(big))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e4, 1e30])
def test_split_halves_are_tf32_and_sum_to_w(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    w = (rng.standard_normal(4096) * scale).astype(np.float32)
    w = np.concatenate([w, EDGES[np.isfinite(EDGES)
                                 & (np.abs(EDGES) < 3e38)]])
    big, small = ref.tf32_split(torch.from_numpy(w))
    for half in (big, small):
        assert not (half.numpy().view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(big.numpy().view(np.uint32),
                          cvt_rna(w).view(np.uint32))
    # the rest keeps 11 bits of its own while it stays a normal number
    keep = torch.from_numpy(np.abs(w) >= 2.0 ** -100)
    total = (big.double() + small.double())[keep]
    want = torch.from_numpy(w).double()[keep]
    assert bool(((total - want).abs() <= 2.0 ** -22 * want.abs()).all())


def test_prepared_halves_are_the_split_transposed():
    w = torch.randn(48, 20, generator=torch.Generator().manual_seed(1))
    big_t, small_t = ref.split_tf32_t(w)
    big, small = ref.tf32_split(w)
    assert big_t.shape == (20, 48) and big_t.is_contiguous()
    assert torch.equal(big_t, big.t()) and torch.equal(small_t, small.t())


@pytest.mark.parametrize("k", [16, 256, D, 4 * D])
def test_3xtf32_arithmetic_matches_jax(k):
    rng = np.random.default_rng(k)
    n = 160
    x = rng.standard_normal((6, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jnp.matmul(jnp.asarray(x), jnp.asarray(w),
                                 precision="highest") + jnp.asarray(b))
    got = ref.linear_3xtf32(*(torch.from_numpy(a) for a in (x, w, b)))
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 5e-5 * scale
    # one TF32 product alone misses that limit: the split is what keeps it
    one = (ref.tf32_round(torch.from_numpy(x))
           @ ref.tf32_round(torch.from_numpy(w))).numpy() + b
    assert float(np.abs(one - want).max()) > 5e-5 * scale


@pytest.mark.parametrize("k,n,rows", DIT)
def test_plan_does_not_follow_m(k, n, rows):
    plan = gemm.plan(k, n, rows)
    grids = set()
    for m in list(range(1, 65)) + [100, 255, 256, 511, 512, 1024, 2048,
                                   3000, 4096]:
        lp = gemm.launch_plan(m, k, n, rows)
        grids.add(tuple(lp.pop("grid")))
        assert lp == plan
    assert len(grids) > 1  # only the grid follows M
    assert plan["kernel"] == {"tokens": "gemm_tokens_wgmma",
                              "requests": "gemm_requests_ffma"}[rows]


def test_plan_tiles():
    for k, n, rows in DIT:
        p = gemm.plan(k, n, rows)
        bm, bn = p["tile"]
        if rows == "tokens":
            assert bm == 128 and bn in gemm.TOKEN_BN and bn % 8 == 0
            assert 2 <= p["stages"] <= 6
        else:
            # every DiT request-row product spreads over the card's 132 SMs
            assert bm == 16 and -(-n // bn) >= 132
            assert p["k_slices"] * p["k_slice"] >= k
    assert gemm.plan(D, D, "tokens") != gemm.plan(D, D, "requests")
    with pytest.raises(ValueError, match="rows"):
        gemm.plan(D, D, "batch")


def test_prepared_weight_is_made_once_and_shared_by_views():
    gemm.release()
    gen = torch.Generator().manual_seed(2)
    stacked = torch.randn(3, 32, 16, generator=gen)
    first = gemm.prepare(stacked[1])
    assert gemm.prepare(stacked[1]) is first  # a new view, the same copy
    assert gemm.prepared_bytes() == 2 * 32 * 16 * 4
    big, small = ref.tf32_split(stacked[1])
    assert torch.equal(first.big_t, big.t())
    assert torch.equal(first.small_t, small.t())
    assert gemm.prepare(stacked[2]) is not first
    assert gemm.prepared_bytes() == 2 * 2 * 32 * 16 * 4
    gemm.release()
    assert gemm.prepared_bytes() == 0
    assert gemm.prepare(stacked[1]) is not first


def test_prepared_weight_is_remade_after_an_in_place_change():
    gemm.release()
    gen = torch.Generator().manual_seed(3)
    stacked = torch.randn(2, 16, 8, generator=gen)
    w = torch.randn(16, 8, generator=gen)
    before = gemm.prepare(w), gemm.prepare(stacked[0])
    w.mul_(3.0)
    stacked.add_(1.0)  # through the stacked leaf: its views see it
    after = gemm.prepare(w), gemm.prepare(stacked[0])
    for old, new, now in zip(before, after, (w, stacked[0])):
        assert new is not old
        assert torch.equal(new.big_t, ref.tf32_split(now)[0].t())
    assert gemm.prepared_bytes() == 2 * 2 * 16 * 8 * 4
    gemm.release()


def test_token_weights_of_the_smoke_dit():
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    ws = diffusion.token_weights(pt)
    assert len(ws) == 2 + 6 * tcfg.num_layers
    assert all(w.dim() == 2 for w in ws)
    # on the CPU the products are the plain ones: nothing is prepared
    assert diffusion.prepare_linear(pt) == 0


def test_call_sites_ask_for_their_variant(monkeypatch):
    _, tcfg = smoke_cfgs()
    _, pt = smoke_params()
    seen = []
    plain = ops.linear

    def linear(x, w, b=None, *, rows="tokens"):
        seen.append((rows, x.reshape(-1, x.shape[-1]).shape[0]))
        return plain(x, w, b, rows=rows)

    monkeypatch.setattr(ops, "linear", linear)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    t = torch.tensor([900.0, 900.0])
    diffusion.apply(tcfg, pt, x, t, label=torch.tensor([3, 1000]))
    requests = [m for rows, m in seen if rows == "requests"]
    tokens = [m for rows, m in seen if rows == "tokens"]
    assert len(requests) == tcfg.num_layers + 3
    assert len(tokens) == 2 + 6 * tcfg.num_layers
    assert set(requests) == {2}  # one row per request
    n_tok, _, _ = diffusion.token_shape(tcfg)
    assert set(tokens) == {2 * n_tok}


def test_cpu_linear_ignores_the_variant_and_checks_it():
    gen = torch.Generator().manual_seed(4)
    x, w, b = (torch.randn(5, 24, generator=gen),
               torch.randn(24, 12, generator=gen),
               torch.randn(12, generator=gen))
    before = dict(ops.LAUNCHES)
    for rows in gemm.ROWS:
        assert torch.equal(ops.linear(x, w, b, rows=rows), x @ w + b)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="rows"):
        ops.linear(x, w, b, rows="batch")
    with pytest.raises(ValueError, match="rows"):
        gemm.linear_cuda(x, w, b, rows="batch")


def test_request_kernel_refuses_a_k_past_its_shared_memory():
    x = torch.zeros(4, 4096)
    with pytest.raises(ValueError, match="shared memory"):
        gemm.linear_cuda(x, torch.zeros(4096, 8), rows="requests")
    with pytest.raises(ValueError, match="65535"):
        gemm.linear_cuda(torch.zeros(4).expand(16 * 65535 + 1, 4),
                         torch.zeros(4, 4), rows="requests")


@pytest.mark.parametrize("argv", [["baseline.cu"], ["--tiles"],
                                  ["--tiles", "--model", "qwen3"],
                                  ["--tiles", "--model", "minicpm3"],
                                  ["--tiles", "--model", "gemma2",
                                   "--generate"],
                                  ["--accuracy", "baseline.cu"]])
def test_gemm_ab_needs_a_card(monkeypatch, tmp_path, argv):
    from repro_torch.kernels import gemm_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path / a) if a.endswith(".cu") else a for a in argv]
    with pytest.raises(SystemExit, match="CUDA card"):
        gemm_ab.main(argv)


def test_gemm_ab_shapes_are_the_forwards_products():
    from repro_torch.kernels import gemm_ab
    got = sorted((k, n, rows) for _, k, n, rows, _, _ in gemm_ab.SHAPES)
    assert got == sorted(DIT)
    calls = sum(c for *_, c in gemm_ab.SHAPES)
    assert calls == 5 + 28 * 7  # a DiT-XL/2 forward's 201 products
    assert sum(c for _, _, _, rows, _, c in gemm_ab.SHAPES
               if rows == "requests") == 28 + 3


def test_gemm_ab_qwen3_shapes_are_the_lm_products():
    """``--model qwen3`` times the products of Qwen3-14B's blocks: 7 a
    block (q, k, v, o, up, gate, down) at the config's widths."""
    from repro_torch import configs
    from repro_torch.kernels import gemm_ab, products
    cfg = configs.get("qwen3-14b")
    spec, ffn = cfg.stages[0].unit[0].mixer, cfg.stages[0].unit[0].ffn
    d, kv = cfg.d_model, spec.num_kv_heads * spec.head_dim
    shapes = products.lm_products(gemm_ab.qwen3_config(), gemm_ab.Q_DECODE)
    assert {(k, n) for _, _, k, n, _ in shapes} == {
        (d, spec.num_heads * spec.head_dim), (d, kv), (d, ffn.d_ff),
        (ffn.d_ff, d)}
    assert sum(c for *_, c in shapes) == 7 * gemm_ab.Q_BLOCKS
    assert [m for m, *_ in gemm_ab.forwards()["qwen3"]] == [4 * 1024] * 4


# each model's forward token products as (M, K, N, bias, calls), written
# out: DiT-XL/2 at 4 requests, OpenSora-v1.2 and Stable-Audio-Open at 1
# (under CFG), Qwen3-14B's prefill at 8 blocks
FORWARD_TOKENS = {
    "dit": [(2048, 16, 1152, True, 1), (2048, 1152, 1152, False, 112),
            (2048, 1152, 4608, False, 28), (2048, 4608, 1152, False, 28),
            (2048, 1152, 16, True, 1)],
    "video": [(8192, 16, 1152, True, 1), (8192, 1152, 1152, False, 336),
              (600, 1152, 1152, False, 112), (8192, 1152, 4608, False, 56),
              (8192, 4608, 1152, False, 56), (8192, 1152, 16, True, 1)],
    "audio": [(432, 64, 1536, True, 1), (432, 1536, 1536, False, 144),
              (256, 768, 1536, False, 48), (432, 1536, 6144, False, 48),
              (432, 6144, 1536, False, 24), (432, 1536, 64, True, 1)],
    "qwen3": [(4096, 5120, 5120, False, 16), (4096, 5120, 1024, False, 16),
              (4096, 5120, 17408, False, 16),
              (4096, 17408, 5120, False, 8)]}


@pytest.mark.parametrize("model", sorted(FORWARD_TOKENS))
def test_gemm_ab_forwards_come_from_the_configs(model):
    """``--accuracy`` times each model's forward token products as the
    configs give them (``kernels.products``, which ``chip_smoke.py``
    checks too)."""
    from repro_torch.kernels import gemm_ab
    assert gemm_ab.forwards()[model] == FORWARD_TOKENS[model]
