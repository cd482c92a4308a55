"""Build and launch of the batch-invariant f32 linear kernel (``gemm.cu``),
which replaces cuBLAS's f32 GEMM on the DiT path: cuBLAS picks its
reduction by M, so a row's bits change with the batch it rides in, and the
serving stack's per-row contract needs them not to.

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, the shape and PyTorch's current stream.  A failed build or launch
raises; nothing here falls back to cuBLAS or to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("gemm.cu")
#: the kernel's constant block tile (rows, columns) and k-step
TILE = (64, 64, 16)
_LIB = None


def build() -> dict:
    """Compile the kernel (a no-op when this source is already built).
    Returns ``{"path", "seconds"}``."""
    return _build.build("gemm", SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.linear_f32.argtypes = [p, p, p, p, i, i, i, p]
        lib.linear_f32.restype = i
        lib.linear_error_string.argtypes = [i]
        lib.linear_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x, w, b):
    """Raise ValueError on what the kernel does not take; the device last,
    so that every other check also runs on CPU tensors."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if k % 4 or n % 4 or k == 0 or n == 0:
        raise ValueError(f"K = {k} and N = {n} must be positive multiples "
                         "of 4 (16-byte rows)")
    if -(-m // TILE[0]) > 65535:
        raise ValueError(f"M = {m} exceeds the grid's 65535 row tiles")
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"bias of shape {tuple(b.shape)}, expected ({n},)")
    named = [("x", x), ("w", w)] + ([] if b is None else [("b", b)])
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             "float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, t in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected x's CUDA "
                             f"device {x.device}")


def linear_cuda(x, w, b=None):
    """x: (M, K), w: (K, N), b: (N,) or None — contiguous float32 CUDA
    tensors → y = x @ w (+ b), (M, N) float32, each row computed from its
    own row of x alone, in one fixed order."""
    _check(x, w, b)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.linear_f32(x.data_ptr(), w.data_ptr(),
                            None if b is None else b.data_ptr(),
                            y.data_ptr(), m, n, k,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("linear launch failed: "
                           + lib.linear_error_string(rc).decode())
    return y
