"""Build and launch of the Hopper SSD-scan kernel (``ssd.cu``), which
replaces the JAX package's Pallas kernel ``repro/kernels/ssd.py::ssd``.

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, shapes, strides and PyTorch's current stream.  A failed build or
launch raises; nothing here falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("ssd.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_STATE = 128
_LIB = None


def build() -> dict:
    """Compile the kernel (a no-op when this source is already built).
    Returns ``{"path", "seconds"}``."""
    return _build.build("ssd", SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_fwd.argtypes = [p] * 7 + [i] * 8 + [ll] * 12 + [p]
        lib.ssd_fwd.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected x's CUDA "
                             f"device {x.device}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype != x.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             "x, b, c all float32 or all bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last dim")
    dt = dt.float()
    a = a.float().contiguous()
    y = torch.empty((bs, l, h, p), dtype=x.dtype, device=x.device)
    hT = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), hT.data_ptr(), _DTYPES[x.dtype],
            bs, l, h, p, g, n, min(chunk, l),
            *x.stride()[:3], *dt.stride(), *b.stride()[:3], *c.stride()[:3],
            stream)
    if rc != 0:
        raise RuntimeError("ssd launch failed: "
                           + lib.ssd_error_string(rc).decode())
    return y, hT
