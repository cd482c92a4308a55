"""Build and launch of the Hopper SSD-scan kernel (``ssd.cu``), which
replaces the JAX package's Pallas kernel ``repro/kernels/ssd.py::ssd``.

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, shapes, strides and PyTorch's current stream.  A failed build or
launch raises; nothing here falls back to the plain version.

One call is three launches (``ssd.cu`` explains them): C·Bᵀ once per
(batch, group, chunk), the states chunk after chunk, and the output of
every chunk in parallel.  The wrapper allocates their two f32 scratches
(``scratch_shapes``).  Every product runs on the tensor cores in TF32; one
of f32 operands as three TF32 products (``plan``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("ssd.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARITH = {torch.float32: "3xtf32-mma.sync",
          torch.bfloat16: "tf32-mma.sync, f32 operands split"}
MAX_CHUNK = 128
MAX_STATE = 128
MAX_GRID_X = 2 ** 31 - 1
TILE = 64  # P columns of a block (ssd.cu)
_LIB = None


def work(b: int, l: int, h: int, p: int, g: int, n: int,
         chunk: int = 128) -> tuple:
    """(FLOPs, bytes, unit) of one f32 call with no initial state, counted
    per chunk of qz = min(chunk, L − start) steps: C·Bᵀ on its causal
    triangle once per (batch, group), since every head of a group shares
    it; per (batch, head) the scores·x triangle, the state update x'·B,
    and C·stateᵀ from the second chunk on (the state entering the first
    chunk is zero).  x, dt, B, C and A read once, y and hT written once;
    3xTF32 on the tensor cores."""
    macs = 0
    for z, start in enumerate(range(0, l, chunk)):
        qz = min(chunk, l - start)
        tri = qz * (qz + 1) // 2
        macs += b * g * tri * n
        macs += b * h * (tri * p + qz * n * p + (qz * n * p if z else 0))
    nbytes = 4 * (2 * b * l * h * p + b * h * p * n + 2 * b * l * g * n
                  + b * l * h + h)
    return 2 * macs, nbytes, "3xtf32"


def build() -> dict:
    """Compile the kernel (a no-op when this source is already built).
    Returns ``{"path", "seconds"}``."""
    return _build.build("ssd", SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_fwd.argtypes = [p] * 9 + [i] * 9 + [ll] * 12 + [p]
        lib.ssd_fwd.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def scratch_shapes(bs: int, l: int, h: int, p: int, g: int, n: int,
                   q: int) -> dict:
    """The kernel's f32 scratches for a call with chunk q (<= L): ``cb``,
    C·Bᵀ per (batch, chunk, group), and ``h_in``, the state entering each
    chunk after the first; QS and NP are q and N rounded up to 8."""
    nch = -(-l // q)
    return {"cb": (bs, nch, g, _round8(q), _round8(q)),
            "h_in": (bs, nch - 1, h, p, _round8(n))}


def plan(x, b, c) -> dict:
    """How the kernel computes these inputs: ``arith`` names the tensor-core
    arithmetic of x's dtype, ``load`` how x, b and c reach shared memory —
    ``"cp.async"`` for float32 when P, N, every pointer and every stride (of
    a dim longer than 1) are multiples of 16 bytes, else ``"scalar"``."""
    e = 16 // x.element_size()
    aligned = (x.dtype == torch.float32 and x.shape[-1] % e == 0
               and b.shape[-1] % e == 0 and all(
                   t.data_ptr() % 16 == 0
                   and all(st % e == 0 for st, n in zip(t.stride()[:3],
                                                        t.shape[:3]) if n > 1)
                   for t in (x, b, c)))
    return {"arith": _ARITH[x.dtype],
            "load": "cp.async" if aligned else "scalar"}


def ssd_cuda(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,) decay rates; b, c: (B, L, G, N)
    CUDA tensors.  x, b and c share one dtype (float32 or bfloat16) and have
    a unit stride on their last dim; dt and a are taken to float32.
    Returns (y (B, L, H, P) in x's dtype, hT (B, H, P, N) float32), computed
    in f32 over chunks of min(chunk, L) steps."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 \
            or c.shape != b.shape:
        raise ValueError(f"expected x (B,L,H,P), dt (B,L,H), a (H,) and "
                         f"b = c (B,L,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(dt.shape) != (bs, l, h) or tuple(a.shape) != (h,) \
            or tuple(b.shape[:2]) != (bs, l):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if l < 1 or g < 1 or h % g:
        raise ValueError(f"need L >= 1 and heads {h} a multiple of groups {g}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"d_state {n} outside the kernel's 1..{MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside the kernel's 1..{MAX_CHUNK}")
    if bs > 65535 or h > 65535:
        raise ValueError(f"batch {bs} or heads {h} exceed the grid's 65535")
    q = min(chunk, l)
    blocks = -(-p // TILE) * -(-l // q)
    if blocks > MAX_GRID_X or l > MAX_GRID_X:
        raise ValueError(f"L {l} needs {blocks} output blocks per head, over "
                         f"the grid's {MAX_GRID_X}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype != x.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             "x, b, c all float32 or all bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last dim")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected x's CUDA "
                             f"device {x.device}")
    dt = dt.float()
    a = a.float().contiguous()
    y = torch.empty((bs, l, h, p), dtype=x.dtype, device=x.device)
    hT = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    scratch = {k: torch.empty(s, dtype=torch.float32, device=x.device)
               for k, s in scratch_shapes(bs, l, h, p, g, n, q).items()}
    vec = plan(x, b, c)["load"] == "cp.async"
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), hT.data_ptr(),
            scratch["cb"].data_ptr(), scratch["h_in"].data_ptr(),
            _DTYPES[x.dtype], int(vec), bs, l, h, p, g, n, q,
            *x.stride()[:3], *dt.stride(), *b.stride()[:3], *c.stride()[:3],
            stream)
    if rc != 0:
        raise RuntimeError("ssd launch failed: "
                           + lib.ssd_error_string(rc).decode())
    return y, hT
