"""The port's flash attention against the JAX package's, and on a card
the RG-LRU scan kernel against its plain version.

On the CPU: the port's plain ``flash_attention_ref`` against the Pallas
kernel (interpret mode) and against the JAX oracle, over the sweep of
``tests/test_kernels.py`` plus the DiT-XL/2 head dim 72, non-causal; an
emulation of the kernel's 3xTF32 arithmetic against the JAX oracle; the
wrapper's checks and its choice of load path.  On a CUDA card: the
hand-written kernel against the plain version (these tests skip where
there is no card).  Tolerance 5e-5 in f32, 5e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close, tf32, tf32_matmul
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import flash_attention as tfa, ops, ref

SHAPES = [(2, 64, 4, 4, 32), (2, 64, 4, 1, 32),      # MHA, MQA
          (1, 96, 8, 2, 64), (1, 128, 16, 8, 64),    # GQA 4:1, 2:1
          (2, 40, 4, 2, 16)]                         # non-multiple length
MASKS = [(True, None, None), (True, 16, None), (True, None, 50.0),
         (False, None, None), (True, 8, 30.0)]
DTYPES = {"f32": (jnp.float32, torch.float32, dict(atol=5e-5, rtol=5e-5)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=5e-2, rtol=5e-2))}
# (b, l, h, kv, d, causal, window, softcap, dtype): as in test_kernels.py,
# the shapes in both dtypes and the masks in f32, plus DiT-XL/2's head dim
CASES = ([s + (True, None, None, dt) for s in SHAPES for dt in DTYPES]
         + [(2, 64, 4, 2, 32) + m + ("f32",) for m in MASKS]
         + [(2, 48, 4, 4, 72, False, None, None, dt) for dt in DTYPES])


# the kernel's new code paths: D 72 at L 256, D 128, a head dim that is not
# a multiple of 8 (and, in bf16, rows that are not 16 B); the wide instance
# at D 256 (Gemma-2) and D 200, with GQA, a window and a softcap
NEW_CASES = [(2, 256, 4, 4, 72, False, None, None, dt) for dt in DTYPES] + [
    (1, 128, 4, 2, 128, True, None, None, dt) for dt in DTYPES] + [
    (2, 64, 4, 2, 20, True, None, None, dt) for dt in DTYPES] + [
    (1, 200, 4, 2, 256, True, 16, 50.0, dt) for dt in DTYPES] + [
    (2, 72, 4, 4, 200, False, None, None, dt) for dt in DTYPES]


def _qkv(b, l, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, l, kv, d)).astype(np.float32),
            rng.standard_normal((b, l, kv, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_jax_oracle(case):
    b, l, h, kv, d, causal, window, softcap, dtype = case
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(b, l, h, kv, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ref.flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, k, v)), **kw)
    assert out.dtype == tdt and out.shape == (b, l, h, d)
    close(pallas_fa(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw),
          out, **tol)
    close(jax_ref(jq, jk, jv, **kw), out, **tol)


def _emulated_attention(q, k, v, split):
    """Non-causal attention, (B, L, H, D) f32 numpy, with both products in
    the kernel's TF32 arithmetic and P·V on unnormalized probabilities."""
    qh, kh, vh = (np.swapaxes(a, 1, 2) for a in (q, k, v))   # (B, H, L, D)
    s = tf32_matmul(qh, np.swapaxes(kh, -1, -2), split) / np.sqrt(
        np.float32(q.shape[-1]))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    o = tf32_matmul(p, vh, split) / p.sum(-1, keepdims=True)
    return np.swapaxes(o, 1, 2)


@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "tf32"])
def test_tf32_arithmetic_against_jax_oracle(split):
    """Why the f32 kernel splits each operand: at L 256, D 72 the 3xTF32
    products stay within the 5e-5 parity limit of the JAX oracle; one TF32
    pass does not."""
    q, k, v = _qkv(1, 256, 4, 4, 72, seed=3)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=False), np.float32)
    got = _emulated_attention(q, k, v, split)
    within = np.allclose(got, want, atol=5e-5, rtol=5e-5)
    assert within == split, float(np.abs(got - want).max())


def test_tf32_rounding_matches_cvt_rna():
    """Nearest, ties away from zero: the kernel's rounding of ``big``."""
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                     -(1.0 + 2.0 ** -10), 1.0], np.float32)
    np.testing.assert_array_equal(tf32(x), want)


def _bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 8))
    wide = torch.zeros(1, 16, 4, 257)
    return {
        "rank": ((q[0], k, v), {}, "expected q"),
        "v shape": ((q, k, v[:, :8]), {}, "expected q"),
        "batch": ((q, torch.cat([k, k]), torch.cat([v, v])), {}, "differ"),
        "head dim": ((wide, wide, wide), {}, "head dim 257"),
        "gqa": ((q[:, :, :3], k, v), {}, "not a multiple"),
        # 65535 query tiles of 64 rows at most along the grid's y
        "grid": ((torch.zeros(1, 64 * 65535 + 1, 1, 1),
                  torch.zeros(1, 1, 1, 1), torch.zeros(1, 1, 1, 1)), {},
                 "65535"),
        "window": ((q, k, v), {"window": 0}, "window"),
        "softcap": ((q, k, v), {"softcap": 0.0}, "softcap"),
        "scale": ((q, k, v), {"scale": float("inf")}, "scale"),
        "mixed dtype": ((q, k.double(), v), {}, "dtype"),
        "half": ((q.half(), k.half(), v.half()), {}, "dtype"),
        "last stride": ((q, k.transpose(1, 3).contiguous().transpose(1, 3),
                         v), {}, "unit stride"),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_kernel_wrapper_refuses_bad_inputs(name):
    args, kw, match = _bad_inputs()[name]
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_cuda(*args, **kw)


def _dit_qkv(dtype=torch.float32):
    """q, k, v as DiT-XL/2 makes them: (B, L, H·D) products reshaped."""
    x = torch.zeros(2, 16, 3 * 16 * 72, dtype=dtype)
    return [x[..., i * 1152:(i + 1) * 1152].reshape(2, 16, 16, 72)
            for i in range(3)]


@pytest.mark.parametrize("make,dtype,load", [
    (lambda dt: _dit_qkv(dt), torch.float32, "cp.async"),
    (lambda dt: _dit_qkv(dt), torch.bfloat16, "cp.async"),
    (lambda dt: [torch.zeros(2, 8, 4, 20, dtype=dt)] * 3, torch.float32,
     "cp.async"),
    (lambda dt: [torch.zeros(2, 8, 4, 20, dtype=dt)] * 3, torch.bfloat16,
     "scalar"),
    (lambda dt: [torch.zeros(2, 8, 4, 33, dtype=dt)[..., 1:]] * 3,
     torch.float32, "scalar"),
    (lambda dt: [torch.zeros(2, 8, 4 * 32 + 4, dtype=dt)[..., :128]
                 .reshape(2, 8, 4, 32)] * 3, torch.float32, "cp.async"),
    (lambda dt: [torch.zeros(2, 8, 4 * 32 + 2, dtype=dt)[..., :128]
                 .reshape(2, 8, 4, 32)] * 3, torch.float32, "scalar"),
    (lambda dt: [torch.zeros(1, 8, 4 * 32 + 2, dtype=dt)[:, :1, :128]
                 .reshape(1, 1, 4, 32)] * 3, torch.float32, "cp.async"),
], ids=["dit-f32", "dit-bf16", "d20-f32", "d20-bf16", "offset",
        "row-16B", "row-8B", "row-8B-length-1"])
def test_plan_picks_load_path_from_pointers_and_strides(make, dtype, load):
    q, k, v = make(dtype)
    arith = {torch.float32: "3xtf32-mma.sync",
             torch.bfloat16: "bf16-mma.sync"}[dtype]
    assert tfa.plan(q, k, v) == {"arith": arith, "load": load}


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=False)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=False))
    assert ops.LAUNCHES["flash_attention"] == before


def test_kernel_wrapper_takes_batch_heads_past_65535():
    """Batch x heads sits on the grid's x, which takes 2^31 - 1 blocks:
    OpenSora's temporal attention at 8 requests under CFG, (16·256, 16)
    rows of 16 heads = 65536 blocks, passes every check but the device's
    (so this CPU tensor is refused for its device alone)."""
    q = torch.zeros(16 * 256, 16, 16, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_cuda(q, q, q, causal=False)
    big = torch.zeros(1, 64 * 65535, 1, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_cuda(big, big[:, :1], big[:, :1], causal=False)


@pytest.mark.parametrize("d", [129, 256])
def test_kernel_wrapper_takes_head_dims_up_to_256(d):
    """Head dims 129..256 go to the wide instance: every check passes but
    the device's."""
    q = torch.zeros(1, 16, 4, d)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA device"):
            tfa.flash_attention_cuda(q.to(dtype), q[:, :, :2].to(dtype),
                                     q[:, :, :2].to(dtype), window=16,
                                     softcap=50.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)


def test_attention_ab_needs_a_card(monkeypatch, tmp_path):
    from repro_torch.kernels import attention_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        attention_ab.main([str(tmp_path / "baseline.cu")])


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


@pytest.mark.parametrize("case", CASES + NEW_CASES + [
    (8, 256, 16, 16, 72, False, None, None, dt) for dt in DTYPES])
def test_cuda_kernel_matches_plain(cuda, case):
    b, l, h, kv, d, causal, window, softcap, dtype = case
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda, tdt) for a in _qkv(b, l, h, kv, d))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = tfa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == tdt
    close(out.cpu(), ref.flash_attention_ref(q, k, v, **kw).cpu(), **tol)


@pytest.mark.parametrize("d,dv", [(192, 128), (160, 96), (256, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_wide_kernel_takes_a_value_head_dim(cuda, d, dv, causal, dtype):
    """The wide instance with V narrower than q and k (DeepSeek-V3's MLA:
    192, 128): V as a strided view of a wider row, as ``_mla_full`` hands
    it over; out (B, L, H, Dv), two launches bitwise."""
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in _qkv(2, 100, 4, 2, d))
    v = v[..., d - dv:]
    out = tfa.flash_attention_cuda(q, k, v, causal=causal)
    again = tfa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 100, 4, dv)
    assert torch.equal(out, again)
    close(out.cpu(), ref.flash_attention_ref(q, k, v, causal=causal).cpu(),
          **tol)


def test_cuda_dispatch_launches_kernel_and_counts(cuda):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(2, 40, 4, 2, 16))
    # a strided view: the kernel reads (B, L, H, D) through strides
    q = torch.cat([q, q], dim=-1)[..., :16]
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    close(out.cpu(), ref.flash_attention_ref(q, k, v, causal=True).cpu())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_unaligned_rows_take_scalar_staging(cuda, dtype):
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(np.pad(a, ((0, 0),) * 3 + ((1, 0),)))
               .to(cuda, tdt)[..., 1:] for a in _qkv(2, 64, 4, 2, 32))
    assert tfa.plan(q, k, v)["load"] == "scalar"
    out = tfa.flash_attention_cuda(q, k, v, causal=True)
    close(out.cpu(), ref.flash_attention_ref(q, k, v, causal=True).cpu(),
          **tol)


def test_cuda_kernel_is_deterministic_at_dit_shape(cuda):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(8, 256, 16, 16, 72))
    first = tfa.flash_attention_cuda(q, k, v, causal=False)
    second = tfa.flash_attention_cuda(q, k, v, causal=False)
    assert torch.equal(first, second)


def _scan_inputs(b, l, w, with_h0, device, strided=False):
    """Seeded RG-LRU scan inputs; ``strided``: ga and gx views of one (B,
    L, 2W), as ``models/rglru.py`` hands them over."""
    rng = np.random.default_rng(l + w)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    xr, gate = f(b, l, w), f(b, l, w)
    g = f(b, l, 2 * w)
    ga, gx = (g[..., :w], g[..., w:]) if strided else (
        g[..., :w].contiguous(), g[..., w:].contiguous())
    a = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.5, 0.999, w)) / 8.0)).to(device)
    return xr, ga, gx, gate, a, (f(b, w) if with_h0 else None)


@pytest.mark.parametrize("b,l,w,with_h0,strided", [
    (2, 1, 2560, True, False), (2, 7, 200, False, True),
    (1, 300, 64, True, True), (3, 1000, 96, False, False),
    # either side of the kernel's chunk boundaries (chunks of 32)
    (2, 31, 2560, True, True), (2, 32, 2560, True, True),
    (2, 33, 2560, True, True), (2, 101, 2560, True, True)])
def test_cuda_rglru_scan_matches_plain(cuda, b, l, w, with_h0, strided):
    from repro_torch.kernels import rglru
    t = _scan_inputs(b, l, w, with_h0, cuda, strided)
    before = rglru.launched()
    y, h = rglru.rglru_scan_cuda(*t[:5], 8.0, t[5])
    # one launch of each pass of the plan, counted by the library
    assert {k: n - before[k] for k, n in rglru.launched().items()} == {
        k: int(k in rglru.plan(l)) for k in rglru.PASSES}
    again = rglru.rglru_scan_cuda(*t[:5], 8.0, t[5])
    yr, hr = ref.rglru_scan_ref(*t[:5], 8.0, t[5])
    torch.cuda.synchronize()
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])
    assert float((y - yr).abs().max()) <= 5e-5 * float(yr.abs().max())
    assert float((h - hr).abs().max()) <= 5e-5 * float(hr.abs().max())
    # a row alone gives the same bits as inside the batch
    one = rglru.rglru_scan_cuda(*(a[-1:] for a in t[:4]), t[4], 8.0,
                                None if t[5] is None else t[5][-1:])
    assert torch.equal(one[0], y[-1:]) and torch.equal(one[1], h[-1:])


def test_cuda_rglru_dispatch_launches_kernel_and_counts(cuda):
    t = _scan_inputs(2, 5, 32, True, cuda)
    before = ops.LAUNCHES["rglru_scan"]
    y, _ = ops.rglru_scan(*t[:5], 8.0, t[5])
    assert ops.LAUNCHES["rglru_scan"] == before + 1
    close(y.cpu(), ref.rglru_scan_ref(*t[:5], 8.0, t[5])[0].cpu())
