"""The port's SSD scan against the JAX package's.

On the CPU, over the sweep of ``tests/test_kernels.py`` in f32 and bf16 (the
same numpy inputs on both sides):
- the kernel's plain version ``ref.ssd_ref`` (f32 arithmetic, y in x's
  dtype) against the Pallas kernel in interpret mode: 5e-5 in f32; in bf16
  y is rounded to bf16 on both sides, so 5e-2 as in ``test_kernels.py``;
- the same against the JAX sequential oracle, at ``test_kernels.py``'s own
  tolerances;
- ``ssd_chunked`` and ``ssd_sequential_ref`` against their JAX twins in the
  inputs' own dtype.
On a CUDA card: the hand-written kernel against the plain version, over the
sweep and at the Mamba-2-1.3B prefill shape (these tests skip where there is
no card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro.kernels.ref import ssd_sequential_ref as jax_seq
from repro.kernels.ssd import ssd as pallas_ssd
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as tssd

# (b, l, h, p, g, n, chunk) of tests/test_kernels.py; L = 33 pads
SWEEP = [(2, 64, 4, 16, 1, 16, 16), (1, 96, 8, 32, 2, 32, 32),
         (2, 33, 2, 16, 1, 8, 16), (1, 16, 2, 8, 2, 8, 8)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                        torch.bfloat16)}
F32 = dict(atol=5e-5, rtol=5e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)
# tests/test_kernels.py's tolerances against the sequential oracle
SEQ_Y = {"f32": dict(atol=2e-4, rtol=2e-3), "bf16": dict(atol=1e-1, rtol=1e-1)}
SEQ_H = {"f32": dict(atol=1e-4, rtol=1e-2), "bf16": dict(atol=1e-2, rtol=1e-2)}


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _inputs(b, l, h, p, g, n, seed=0):
    """f32 numpy inputs drawn as ``test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(b, l, h, p)
    dt = _softplus(f(b, l, h) - 1.0).astype(np.float32)
    a = np.exp(rng.uniform(0.0, 1.0, h)).astype(np.float32)
    return x, dt, a, f(b, l, g, n), f(b, l, g, n)


def _both(arrs, dtype):
    """numpy (x, dt, a, b, c) → (jax, torch) tuples; x, b, c in ``dtype``,
    dt and a in f32."""
    jdt, tdt = DTYPES[dtype]
    cast = (True, False, False, True, True)
    j = tuple(jnp.asarray(v, jdt if c else jnp.float32)
              for v, c in zip(arrs, cast))
    t = tuple(torch.from_numpy(v).to(tdt if c else torch.float32)
              for v, c in zip(arrs, cast))
    return j, t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_matches_pallas_and_sequential_oracle(shape, dtype):
    *dims, chunk = shape
    j, t = _both(_inputs(*dims), dtype)
    y, hT = ref.ssd_ref(*t, chunk=chunk)
    assert y.dtype == DTYPES[dtype][1] and hT.dtype == torch.float32
    assert y.shape == t[0].shape and hT.shape == (dims[0], dims[2], dims[3],
                                                   dims[5])
    yp, hp = pallas_ssd(*j, chunk=chunk, interpret=True)
    close(yp, y, **(F32 if dtype == "f32" else BF16))
    close(hp, hT)
    ys, hs = jax_seq(*j)
    close(ys, y, **SEQ_Y[dtype])
    close(hs, hT, **SEQ_H[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SWEEP)
def test_chunked_and_sequential_match_jax(shape, dtype):
    *dims, chunk = shape
    j, t = _both(_inputs(*dims, seed=1), dtype)
    tol = F32 if dtype == "f32" else BF16
    yj, hj = jssm.ssd_chunked(*j, chunk)
    yt, ht = ref.ssd_chunked(*t, chunk)
    assert yt.dtype == DTYPES[dtype][1]
    close(yj, yt, **tol)
    close(hj, ht, **tol)
    yj, hj = jax_seq(*j)
    yt, ht = ref.ssd_sequential_ref(*t)
    close(yj, yt, **tol)
    close(hj, ht, **tol)


def test_segsum_matches():
    from repro.models.ssm import segsum as jsegsum
    v = np.random.default_rng(2).standard_normal((2, 3, 8)).astype(np.float32)
    want = np.asarray(jsegsum(jnp.asarray(v)))
    got = ref.segsum(torch.from_numpy(v)).numpy()
    assert np.array_equal(np.isneginf(want), np.isneginf(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **F32)


def test_initial_state_split_matches_whole_sequence():
    """h0 threading matches splitting a sequence in two, as in
    ``test_kernels.py``, and the JAX reference given the same h0."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in _inputs(1, 32, 2, 8, 1, 8,
                                                            seed=3))
    y_full, h_full = ref.ssd_ref(x, dt, a, b, c, chunk=8)
    _, h1 = ref.ssd_ref(x[:, :16], dt[:, :16], a, b[:, :16], c[:, :16],
                        chunk=8)
    y2, h2 = ref.ssd_ref(x[:, 16:], dt[:, 16:], a, b[:, 16:], c[:, 16:],
                         chunk=8, h0=h1)
    close(y_full[:, 16:], y2, atol=1e-5, rtol=1e-4)
    close(h_full, h2, atol=1e-5, rtol=1e-4)
    jy2, jh2 = jssm.ssd_chunked(
        *(jnp.asarray(v[:, 16:].numpy()) for v in (x, dt)), jnp.asarray(a),
        *(jnp.asarray(v[:, 16:].numpy()) for v in (b, c)), 8,
        jnp.asarray(h1.numpy()))
    close(jy2, y2)
    close(jh2, h2)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    x, dt, a, b, c = (torch.from_numpy(v) for v in _inputs(1, 20, 2, 8, 1, 8))
    before = ops.LAUNCHES["ssd"]
    y, hT = ops.ssd(x, dt, a, b, c, chunk=8)
    yr, hr = ref.ssd_ref(x, dt, a, b, c, chunk=8)
    assert torch.equal(y, yr) and torch.equal(hT, hr)
    assert ops.LAUNCHES["ssd"] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    t = [torch.from_numpy(v) for v in _inputs(1, 16, 2, 8, 1, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_cuda(*t, chunk=8)


def test_kernel_wrapper_checks_shapes_before_the_device():
    x, dt, a, b, c = (torch.from_numpy(v) for v in _inputs(1, 16, 4, 8, 1, 8))
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_cuda(x, dt, a, b, c, chunk=256)
    with pytest.raises(ValueError, match="d_state"):
        tssd.ssd_cuda(x, dt, a, torch.zeros(1, 16, 1, 256),
                      torch.zeros(1, 16, 1, 256))
    with pytest.raises(ValueError, match="groups"):
        tssd.ssd_cuda(x, dt, a, torch.zeros(1, 16, 3, 8),
                      torch.zeros(1, 16, 3, 8))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _run_both(device, dims, chunk, dtype):
    _, t = _both(_inputs(*dims), dtype)
    t = [v.to(device) for v in t]
    y, hT = tssd.ssd_cuda(*t, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == t[0].dtype and hT.dtype == torch.float32
    yr, hr = ref.ssd_ref(*t, chunk=chunk)
    return y.cpu().float(), hT.cpu(), yr.cpu().float(), hr.cpu()


@pytest.mark.parametrize("case", [s + (dt,) for s in SWEEP for dt in DTYPES])
def test_cuda_kernel_matches_plain(cuda, case):
    *dims, chunk, dtype = case
    y, hT, yr, hr = _run_both(cuda, dims, chunk, dtype)
    close(y, yr, **SEQ_Y[dtype])
    close(hT, hr, **SEQ_H[dtype])


@pytest.mark.parametrize("length", [1024, 1000])
def test_cuda_kernel_matches_plain_at_prefill_width(cuda, length):
    """Mamba-2-1.3B's prefill shape, and a ragged length.  y reaches ~400
    there and near-zero outputs carry the rounding of large f32 sums taken
    in another order, so the limit is max |err| / max |plain| <= 1e-4."""
    y, hT, yr, hr = _run_both(cuda, (4, length, 64, 64, 1, 128), 128, "f32")
    for got, want in ((y, yr), (hT, hr)):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_cuda_dispatch_launches_kernel_and_counts(cuda):
    x, dt, a, b, c = (torch.from_numpy(v).to(cuda)
                      for v in _inputs(2, 40, 4, 16, 2, 16))
    # strided views, as the model hands them over: one projection split
    xbc = torch.cat([x.reshape(2, 40, 64), b.reshape(2, 40, 32),
                     c.reshape(2, 40, 32)], dim=-1)
    xs, bs, cs = torch.split(xbc, [64, 32, 32], dim=-1)
    xs, bs, cs = xs.reshape(2, 40, 4, 16), bs.reshape(2, 40, 2, 16), \
        cs.reshape(2, 40, 2, 16)
    before = ops.LAUNCHES["ssd"]
    y, hT = ops.ssd(xs, dt, a, bs, cs, chunk=16)
    assert ops.LAUNCHES["ssd"] == before + 1
    yr, hr = ref.ssd_ref(x, dt, a, b, c, chunk=16)
    close(y.cpu(), yr.cpu(), **SEQ_Y["f32"])
    close(hT.cpu(), hr.cpu(), **SEQ_H["f32"])
