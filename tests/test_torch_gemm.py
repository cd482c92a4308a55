"""The port's linear layer (``ops.linear``: the batch-invariant Hopper
kernel ``kernels/gemm.cu`` on a card, ``x @ w (+ b)`` on the CPU) and the
proxy's batch-invariant row sums, against the JAX package.

On the CPU: ``linear_ref`` against JAX's ``x @ w`` at ``highest``
precision at the DiT-XL/2 shapes (5e-5 of the output's scale); the CPU
dispatch is the plain product, bit for bit, and counts no launch; the
wrapper refuses what the kernel does not take; ``row_sums`` gives a row
the same bits whatever batch it rides in, and agrees with JAX's sum.  On a
CUDA card (skipped elsewhere): the kernel against the plain version, a
row's bits across batch sizes and row orders, and a captured launch
against an eager one."""
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
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [2, 16, 512, 4096])
def test_cuda_kernel_matches_plain(cuda, m, k, n):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _xwb(m, k, n))
    got = gemm.linear_cuda(x, w, b)
    want = ref.linear_ref(x, w, b)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-5 * float(want.abs().max())


@pytest.mark.parametrize("k,n", [(D, D), (4 * D, D), (D, 6 * D), (16, D)])
def test_cuda_rows_are_batch_invariant(cuda, k, n):
    x, w, _ = (torch.from_numpy(a).to(cuda) for a in _xwb(2048, k, n))
    full = gemm.linear_cuda(x, w)
    for m in (1, 2, 4, 8, 512, 1024):
        assert torch.equal(gemm.linear_cuda(x[:m].contiguous(), w), full[:m])
    perm = torch.randperm(2048, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    assert torch.equal(gemm.linear_cuda(x[perm].contiguous(), w), full[perm])


def test_cuda_captured_launch_equals_eager(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _xwb(512, D, D))
    eager = gemm.linear_cuda(x, w, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm.linear_cuda(x, w, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(ops.CAPTURED)
    with torch.cuda.graph(graph):
        captured = ops.linear(x, w, b)
    assert ops.CAPTURED["linear"] == before["linear"] + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
