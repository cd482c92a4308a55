"""The port's flash attention against the JAX package's.

On the CPU: the port's plain ``flash_attention_ref`` against the Pallas
kernel (interpret mode) and against the JAX oracle, over the sweep of
``tests/test_kernels.py`` plus the DiT-XL/2 head dim 72, non-causal.  On a
CUDA card: the hand-written kernel against the plain version (these tests
skip where there is no card).  Tolerance 5e-5 in f32, 5e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
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


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=False)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=False))
    assert ops.LAUNCHES["flash_attention"] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)


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


@pytest.mark.parametrize("case", CASES + [
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


def test_cuda_dispatch_launches_kernel_and_counts(cuda):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(2, 40, 4, 2, 16))
    # a strided view: the kernel reads (B, L, H, D) through strides
    q = torch.cat([q, q], dim=-1)[..., :16]
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    close(out.cpu(), ref.flash_attention_ref(q, k, v, causal=True).cpu())
