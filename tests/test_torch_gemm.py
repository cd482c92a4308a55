"""The port's linear layer (``ops.linear``: the batch-invariant Hopper
kernel ``kernels/gemm.cu`` on a card, ``x @ w (+ b)`` on the CPU) and the
proxy's batch-invariant row sums, against the JAX package.

On the CPU: ``linear_ref`` against JAX's ``x @ w`` at ``highest``
precision at the DiT-XL/2 shapes (5e-5 of the output's scale); the CPU
dispatch is the plain product, bit for bit, and counts no launch; the
wrapper refuses what the kernel does not take; ``row_sums`` gives a row
the same bits whatever batch it rides in, and agrees with JAX's sum; the
token kernel's plan gives every Stable-Audio-Open product a tile width
that divides N, whatever M, and keeps DiT-XL/2's and OpenSora's widths.
On a
CUDA card (skipped elsewhere): both kernels (the token and the
request-row variant) against the plain version, a row's bits across batch
sizes and row orders, a captured launch against an eager one, and a
capture that finds no prepared weight raising."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro_torch.core import calibration
from repro_torch.kernels import gemm, ops, ref

D = 1152
# (K, N) of every DiT-XL/2 product: patch embed, time MLP, q/k/v/o, MLP
# up/down, adaLN modulation, final modulation, output projection
SHAPES = [(16, D), (256, D), (D, D), (D, 4 * D), (4 * D, D), (D, 6 * D),
          (D, 2 * D), (D, 16)]


def _xwb(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_linear_matches_jax(k, n):
    x, w, b = _xwb(6, k, n)
    want = np.asarray(jnp.matmul(jnp.asarray(x), jnp.asarray(w),
                                 precision="highest") + jnp.asarray(b))
    got = ref.linear_ref(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    assert got.shape == (6, n)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 5e-5 * scale


def test_cpu_dispatch_is_the_plain_product_and_counts_nothing():
    x, w, b = (torch.from_numpy(a) for a in _xwb(2 * 3 * 4, 64, 32))
    x3 = x.reshape(2, 12, 64)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.linear(x3, w), x3 @ w)
    assert torch.equal(ops.linear(x3, w, b), x3 @ w + b)
    assert ops.linear(x3, w, b).shape == (2, 12, 32)
    assert ops.LAUNCHES == before


def _bad_inputs():
    x, w, b = (torch.from_numpy(a) for a in _xwb(8, 16, 32))
    return {
        "rank": ((x[None], w, None), "expected x"),
        "inner": ((x, w[:8], None), "expected x"),
        "k": ((torch.zeros(8, 18), torch.zeros(18, 32), None), "multiples"),
        "n": ((x, torch.zeros(16, 30), None), "multiples"),
        "grid": ((torch.zeros(4).expand(64 * 65535 + 1, 4),
                  torch.zeros(4, 4), None), "65535"),
        "bias": ((x, w, b[:16]), "bias"),
        "dtype": ((x.double(), w.double(), None), "float32"),
        "bf16": ((x.bfloat16(), w.bfloat16(), None), "float32"),
        "bias dtype": ((x, w, b.double()), "float32"),
        "strided": ((torch.zeros(8, 32)[:, :16], w, None), "contiguous"),
        "aligned": ((torch.zeros(8 * 16 + 1)[1:].reshape(8, 16), w, None),
                    "aligned"),
        "device": ((x, w, b), "CUDA"),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_kernel_wrapper_refuses_bad_inputs(name):
    args, match = _bad_inputs()[name]
    with pytest.raises(ValueError, match=match):
        gemm.linear_cuda(*args)


def test_row_sums_are_batch_invariant_and_match_jax():
    rng = np.random.default_rng(3)
    for shape in ((8, 32, 32, 4), (5, 7, 3), (3, 1)):
        v = rng.standard_normal(shape).astype(np.float32)
        full = calibration.row_sums(torch.from_numpy(v))
        for lo, hi in ((0, 1), (1, 3), (2, shape[0])):
            part = calibration.row_sums(torch.from_numpy(v[lo:hi]))
            assert torch.equal(part, full[lo:hi])
        want = v.reshape(shape[0], -1).astype(np.float64).sum(axis=1)
        np.testing.assert_allclose(full.numpy(), want, rtol=1e-5, atol=1e-5)
    cur, prev = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
                 for _ in range(2))
    got = calibration.rel_l1_change_rows(torch.from_numpy(cur),
                                         torch.from_numpy(prev)).numpy()
    want = np.asarray(jcal.rel_l1_change_rows(jnp.asarray(cur),
                                              jnp.asarray(prev)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The token kernel's plan
# ---------------------------------------------------------------------------

# (K, N) of Stable-Audio-Open's token products: patch embedding, q/k/v/o
# of self- and cross-attention (d 1536), the cross k/v over the 768-wide
# memory, the gated MLP up/gate and down, the output projection
AUDIO = [(64, 1536), (1536, 1536), (768, 1536), (1536, 6144), (6144, 1536),
         (1536, 64)]


@pytest.mark.parametrize("k,n", AUDIO)
def test_audio_products_get_a_width_that_divides_n(k, n):
    assert (k, n) in gemm.TOKEN_CHOICE
    p = gemm.plan(k, n, "tokens")
    bm, bn = p["tile"]
    assert bn == gemm.TOKEN_CHOICE[(k, n)] and bn in gemm.TOKEN_BN
    assert n % bn == 0 and bm == gemm.TOKEN_BM


@pytest.mark.parametrize("k,n", AUDIO)
def test_audio_plan_does_not_follow_m(k, n):
    """The row contract: tile, stages and k order from (K, N) alone — the
    audio path's row counts (2·216·B tokens, 2·128·B memory rows) and
    others give one plan; only the grid follows M."""
    plan = gemm.plan(k, n, "tokens")
    grids = set()
    for m in (1, 63, 256, 432, 512, 864, 1296, 1728, 4096):
        lp = gemm.launch_plan(m, k, n, "tokens")
        grids.add(tuple(lp.pop("grid")))
        assert lp == plan
    assert len(grids) > 1


# (K, N) of Qwen3-14B's products: q and o (d 5120 = 40 × 128), k and v
# (8 KV heads × 128), the gated MLP's up and gate (d_ff 17408), down
QWEN3 = [(5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120)]


@pytest.mark.parametrize("k,n", QWEN3)
def test_qwen3_products_get_a_built_width_that_divides_n(k, n):
    """The LM's widths are planned by (K, N), a prefill's 4096 rows and a
    decode step's 4 alike, never the 16-wide fallback."""
    assert (k, n) in gemm.TOKEN_CHOICE
    bm, bn = gemm.plan(k, n, "tokens")["tile"]
    assert bn in gemm.TOKEN_BN and n % bn == 0 and bn >= 64
    for m in (4, 200, 4096, 4220):
        assert gemm.launch_plan(m, k, n, "tokens")["tile"] == [bm, bn]


def test_token_widths_override_the_plan_within_the_block():
    """``gemm.token_widths`` plans the (K, N) it is given at a built width
    inside the ``with`` block only, and refuses a width not built."""
    k, n = 5120, 17408
    before = gemm.plan(k, n)
    assert before["tile"][1] == 128
    with gemm.token_widths({(k, n): 64}):
        assert gemm.plan(k, n)["tile"][1] == 64
        assert gemm.plan(5120, 5120)["tile"][1] == 64     # as planned
    assert gemm.plan(k, n) == before
    with pytest.raises(ValueError, match="not built"):
        with gemm.token_widths({(k, n): 32}):
            pass
    assert gemm.plan(k, n) == before


def test_token_k_order_names_the_promotion():
    """``plan`` reads the tile and the promotion interval from the source
    the library is built from: 4 k-tiles of 32, the interval whose error
    against an f64 product was measured."""
    order = gemm.plan(17408, 5120, "tokens")["k_order"]
    assert "runs of 4 k-tiles of 32" in order
    assert (gemm.TOKEN_BM, gemm.TOKEN_BK, gemm.TOKEN_PROMOTE) == (128, 32, 4)


def test_dit_and_video_widths_are_pinned():
    """DiT-XL/2's and OpenSora's token products (d 1152) keep the widths
    their bitwise serving checks ran on; a change must be deliberate."""
    assert {kn: w for kn, w in gemm.TOKEN_CHOICE.items()
            if 1152 in kn} == {(16, 1152): 144, (1152, 1152): 144,
                               (4608, 1152): 144, (1152, 4608): 144,
                               (1152, 16): 16}
    for (k, n), w in gemm.TOKEN_CHOICE.items():
        assert gemm.plan(k, n, "tokens")["tile"] == [gemm.TOKEN_BM, w]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (rows, K, N, M): every DiT shape through the token variant, and through
# the request-row variant where 16 rows of x fit its shared memory
CARD_CASES = [("tokens", k, n, m) for k, n in SHAPES
              for m in (2, 16, 512, 4096)] + [
    ("requests", k, n, m) for k, n in SHAPES if k <= 1152
    for m in (1, 2, 8, 16, 40)]


@pytest.mark.parametrize("rows,k,n,m", CARD_CASES)
def test_cuda_kernel_matches_plain(cuda, rows, k, n, m):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _xwb(m, k, n))
    got = gemm.linear_cuda(x, w, b, rows=rows)
    want = ref.linear_ref(x, w, b)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-5 * float(want.abs().max())
    gemm.release()


@pytest.mark.parametrize("rows,k,n", [
    ("tokens", D, D), ("tokens", 4 * D, D), ("tokens", D, 6 * D),
    ("tokens", 16, D), ("requests", D, 6 * D), ("requests", 256, D),
    ("requests", D, 2 * D)])
def test_cuda_rows_are_batch_invariant(cuda, rows, k, n):
    total = 2048 if rows == "tokens" else 48
    x, w, _ = (torch.from_numpy(a).to(cuda) for a in _xwb(total, k, n))
    full = gemm.linear_cuda(x, w, rows=rows)
    for m in (1, 2, 4, 8, 16, 17, 512, 1024):
        if m < total:
            sub = gemm.linear_cuda(x[:m].contiguous(), w, rows=rows)
            assert torch.equal(sub, full[:m])
    perm = torch.randperm(total, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    assert torch.equal(gemm.linear_cuda(x[perm].contiguous(), w, rows=rows),
                       full[perm])
    gemm.release()


@pytest.mark.parametrize("rows,m", [("tokens", 512), ("requests", 8)])
def test_cuda_captured_launch_equals_eager(cuda, rows, m):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _xwb(m, D, D))
    eager = gemm.linear_cuda(x, w, b, rows=rows)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm.linear_cuda(x, w, b, rows=rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(ops.CAPTURED)
    with torch.cuda.graph(graph):
        captured = ops.linear(x, w, b, rows=rows)
    assert ops.CAPTURED["linear"] == before["linear"] + 1
    assert ops.CAPTURED["linear_" + rows] == before["linear_" + rows] + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    gemm.release()


def test_cuda_capture_without_a_prepared_weight_raises(cuda):
    x, w, _ = (torch.from_numpy(a).to(cuda) for a in _xwb(512, D, D))
    gemm.release()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="prepared copy"):
        with torch.cuda.graph(graph):
            gemm.linear_cuda(x, w)
