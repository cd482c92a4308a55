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
The CUDA kernel's design, on the CPU: its three-pass decomposition (C·Bᵀ
once per group, the state entering each chunk, then every chunk's output)
in plain torch against the plain version and the Pallas kernel; and the
same decomposition with each product in the kernel's TF32 arithmetic, which
shows why every f32 product takes the 3xTF32 split.
On a CUDA card: the hand-written kernel against the plain version, over the
sweep and at the Mamba-2-1.3B prefill shape (these tests skip where there is
no card).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, tf32, tf32_matmul, tf32_rz
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
# The kernel's decomposition and arithmetic
# ---------------------------------------------------------------------------

PRODUCTS = ("cb", "state", "sx", "ch")


def _three_passes(x, dt, a, b, c, chunk, mm=lambda name, u, v: u @ v):
    """The CUDA kernel's decomposition in plain torch, f32: pass 0 takes
    C·Bᵀ once per (batch, chunk, group); pass 1 walks the chunks and keeps
    h_in, the state entering each; pass 2 forms every chunk's output from
    CB, x, C and its h_in.  ``mm(name, u, v)`` takes each product: "cb"
    (C·Bᵀ), "state" ((x ∘ w)ᵀ·B), "sx" (scores·x), "ch" (C·h_inᵀ)."""
    x, dt, a, b, c = (v.float() for v in (x, dt, a, b, c))
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, l)
    nch = -(-l // q)
    pad = nch * q - l
    x, b, c = (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
               for v in (x, b, c))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    rep = h // g
    xc = x.reshape(bs, nch, q, h, p).permute(0, 1, 3, 2, 4)      # b z h q p
    dtc = dt.reshape(bs, nch, q, h).permute(0, 1, 3, 2)          # b z h q
    bc, cc = (v.reshape(bs, nch, q, g, n).permute(0, 1, 3, 2, 4)
              for v in (b, c))                                   # b z g q n
    cb = mm("cb", cc, bc.transpose(-1, -2)).repeat_interleave(rep, dim=2)
    bh, ch = (v.repeat_interleave(rep, dim=2) for v in (bc, cc))
    cum = torch.cumsum(-dtc * a[None, None, :, None], dim=-1)
    total = cum[..., -1]
    state = torch.zeros(bs, h, p, n)
    h_in = []
    for z in range(nch):
        h_in.append(state)
        w = dtc[:, z] * torch.exp(total[:, z, :, None] - cum[:, z])
        upd = mm("state", (xc[:, z] * w[..., None]).transpose(-1, -2),
                 bh[:, z])
        state = torch.exp(total[:, z])[..., None, None] * state + upd
    h_in = torch.stack(h_in, dim=1)                              # b z h p n
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    scores = cb * decay * dtc[..., None, :]
    y = (mm("ch", ch, h_in.transpose(-1, -2)) * torch.exp(cum)[..., None]
         + mm("sx", scores, xc))
    return y.permute(0, 1, 3, 2, 4).reshape(bs, nch * q, h, p)[:, :l], state


@pytest.mark.parametrize("shape", [
    (2, 33, 2, 16, 1, 8, 16),    # ragged L
    (1, 96, 8, 32, 2, 32, 32),   # G > 1
    (2, 70, 4, 12, 2, 12, 32),   # ragged L and G > 1
    (1, 20, 2, 8, 1, 8, 64),     # L < chunk
], ids=["ragged", "groups", "ragged-groups", "short"])
def test_three_pass_decomposition_matches_plain_and_pallas(shape):
    *dims, chunk = shape
    j, t = _both(_inputs(*dims, seed=4), "f32")
    y, hT = _three_passes(*t, chunk)
    yr, hr = ref.ssd_ref(*t, chunk=chunk)
    close(y, yr)
    close(hT, hr)
    yp, hp = pallas_ssd(*j, chunk=chunk, interpret=True)
    close(yp, y)
    close(hp, hT)


WIDE = (1, 256, 2, 64, 1, 128, 128)   # the prefill's widths, shorter


@functools.lru_cache(maxsize=None)
def _oracles(shape):
    """numpy inputs, and the Pallas kernel's and the sequential oracle's
    (y, hT) on them, in f32."""
    *dims, chunk = shape
    arrs = _inputs(*dims, seed=5)
    j = [jnp.asarray(v) for v in arrs]
    pallas = [np.asarray(v) for v in pallas_ssd(*j, chunk=chunk,
                                                interpret=True)]
    seq = [np.asarray(v) for v in jax_seq(*j)] if shape != WIDE else None
    return arrs, pallas, seq


# which products take one TF32 pass instead of the 3xTF32 split
ARITH = {"3xtf32": (), "tf32": PRODUCTS,
         **{f"tf32-{name}-only": (name,) for name in PRODUCTS}}


@pytest.mark.parametrize("arith", list(ARITH))
def test_kernel_arithmetic_against_jax_oracles(arith):
    """Why every product of the f32 kernel takes the 3xTF32 split: with all
    four split, the kernel's passes stay within ``test_kernels.py``'s
    tolerances of the Pallas kernel and the sequential oracle over its
    sweep, and within max-rel 1e-4 of the Pallas kernel at the prefill's
    widths; one TF32 pass on any one product misses somewhere."""
    def mm(name, u, v):
        return torch.from_numpy(tf32_matmul(u.numpy(), v.numpy(),
                                            name not in ARITH[arith],
                                            tf32_rz))

    within = True
    for shape in SWEEP + [WIDE]:
        (x, dt, a, b, c), (yp, hp), seq = _oracles(shape)
        y, hT = (v.numpy() for v in _three_passes(
            *(torch.from_numpy(v) for v in (x, dt, a, b, c)), shape[-1], mm))
        if seq is None:
            within &= bool(max(np.abs(y - yp).max() / np.abs(yp).max(),
                               np.abs(hT - hp).max() / np.abs(hp).max())
                           <= 1e-4)
            continue
        for want_y, want_h in ((yp, hp), seq):
            within &= bool(np.allclose(y, want_y, **SEQ_Y["f32"])
                           and np.allclose(hT, want_h, **SEQ_H["f32"]))
    assert within == (arith == "3xtf32")


def test_bf16_inputs_are_exact_in_tf32():
    """Why the bf16 kernel skips the split of x, b and c: a bf16 value has
    8 mantissa bits and TF32 keeps 10, so its small part is zero."""
    v = torch.randn(4096, generator=torch.Generator().manual_seed(6))
    v = v.bfloat16().float().numpy()
    for rnd in (tf32, tf32_rz):
        assert np.array_equal(rnd(v), v)
        assert not np.any(rnd(v - rnd(v)))


def test_split_toward_zero_keeps_21_bits():
    """The SSD kernel's split: big = x with its last 13 bits cleared,
    small = x - big read toward zero by the tensor cores; big + small
    differs from x by less than 2^-20 of |x|."""
    x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(7))
    x = x.numpy()
    big = tf32_rz(x)
    small = tf32_rz(x - big)
    err = np.abs((big.astype(np.float64) + small) - x)
    assert np.all(err <= 2.0 ** -20 * np.abs(x))
    assert np.all(np.abs(x - big) < 2.0 ** -10 * np.abs(x))


def test_scratch_shapes():
    # the prefill: 2 MB of C·Bᵀ and 58.7 MB of entering states
    s = tssd.scratch_shapes(4, 1024, 64, 64, 1, 128, 128)
    assert s == {"cb": (4, 8, 1, 128, 128), "h_in": (4, 7, 64, 64, 128)}
    # Q and N round up to 8; one chunk needs no entering state
    assert tssd.scratch_shapes(2, 50, 3, 6, 1, 5, 13) == {
        "cb": (2, 4, 1, 16, 16), "h_in": (2, 3, 3, 6, 8)}
    assert tssd.scratch_shapes(1, 20, 2, 8, 2, 8, 20)["h_in"] == (
        1, 0, 2, 8, 8)


def _split_views(dtype=torch.float32, width=0):
    """x, b, c as the model hands them over: views of one (B, L, H·P + 2·N
    + width) projection."""
    xbc = torch.zeros(2, 8, 4 * 16 + 2 * 8 + width, dtype=dtype)
    x, b, c, _ = torch.split(xbc, [64, 8, 8, width], dim=-1)
    return x.reshape(2, 8, 4, 16), b.reshape(2, 8, 1, 8), \
        c.reshape(2, 8, 1, 8)


@pytest.mark.parametrize("make,load", [
    (lambda: _split_views(), "cp.async"),
    (lambda: _split_views(width=4), "cp.async"),
    (lambda: _split_views(width=1), "scalar"),
    (lambda: _split_views(torch.bfloat16), "scalar"),
    (lambda: (torch.zeros(1, 8, 2, 6), torch.zeros(1, 8, 1, 8),
              torch.zeros(1, 8, 1, 8)), "scalar"),
    (lambda: (torch.zeros(1, 8, 2, 17)[..., 1:], torch.zeros(1, 8, 1, 8),
              torch.zeros(1, 8, 1, 8)), "scalar"),
], ids=["model-split", "row-16B", "row-4B", "bf16", "p6", "offset"])
def test_plan_picks_load_path_from_pointers_and_strides(make, load):
    x, b, c = make()
    arith = {torch.float32: "3xtf32-mma.sync",
             torch.bfloat16: "tf32-mma.sync, f32 operands split"}[x.dtype]
    assert tssd.plan(x, b, c) == {"arith": arith, "load": load}


@pytest.mark.parametrize("l,p", [(2 ** 31, 8), (2 ** 22, 2 ** 22)],
                         ids=["length", "width"])
def test_kernel_wrapper_refuses_grids_past_its_limit(l, p):
    """The output pass runs ceil(P/64)·chunks blocks per head along the
    grid's x, at most 2^31 - 1 (stride-0 views: no memory)."""
    x = torch.zeros(1, 1, 1, p).expand(1, l, 1, p)
    b = torch.zeros(1, 1, 1, 8).expand(1, l, 1, 8)
    dt = torch.zeros(1, 1, 1).expand(1, l, 1)
    with pytest.raises(ValueError, match="grid"):
        tssd.ssd_cuda(x, dt, torch.ones(1), b, b, chunk=128)


def test_mma_rate_needs_a_card(monkeypatch):
    from repro_torch.kernels import mma_rate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        mma_rate.main([])


def test_ssd_ab_needs_a_card(monkeypatch, tmp_path):
    from repro_torch.kernels import ssd_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        ssd_ab.main([str(tmp_path / "ssd.cu")])


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


def test_cuda_kernel_is_deterministic_at_prefill_shape(cuda):
    """No atomics and a fixed order of every sum: two launches agree
    bitwise."""
    _, t = _both(_inputs(4, 1024, 64, 64, 1, 128), "f32")
    t = [v.to(cuda) for v in t]
    y1, h1 = tssd.ssd_cuda(*t, chunk=128)
    y2, h2 = tssd.ssd_cuda(*t, chunk=128)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_cuda_kernel_on_split_views_at_prefill_width(cuda):
    """x, b and c as ``models/ssm.py`` hands them over: strided views of one
    (B, L, 4352) projection, staged with cp.async."""
    x, dt, a, b, c = (torch.from_numpy(v).to(cuda)
                      for v in _inputs(4, 1024, 64, 64, 1, 128))
    xbc = torch.cat([x.reshape(4, 1024, -1), b.reshape(4, 1024, -1),
                     c.reshape(4, 1024, -1)], dim=-1)
    xs, bs, cs = torch.split(xbc, [4096, 128, 128], dim=-1)
    xs, bs, cs = (xs.reshape(4, 1024, 64, 64), bs.reshape(4, 1024, 1, 128),
                  cs.reshape(4, 1024, 1, 128))
    assert tssd.plan(xs, bs, cs)["load"] == "cp.async"
    y, hT = tssd.ssd_cuda(xs, dt, a, bs, cs, chunk=128)
    yr, hr = ref.ssd_ref(x, dt, a, b, c, chunk=128)
    for got, want in ((y, yr), (hT, hr)):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
