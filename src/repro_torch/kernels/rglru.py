"""Build and launch of the Hopper RG-LRU scan kernel (``rglru.cu``), the
port's own kernel for the recurrence of RecurrentGemma's recurrent block:
the JAX package has no Pallas kernel there (``jax.lax.associative_scan``
in ``repro/models/rglru.py``, which XLA fuses on the TPU).

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, shapes, strides and PyTorch's current stream.  A failed build or
launch raises; nothing here falls back to the plain version
(``ref.rglru_scan_ref``).  One call is one launch: one thread per (batch,
channel), looping over the steps.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("rglru.cu")
THREADS = 64  # channels per block (rglru.cu)
_LIB = None


def build() -> dict:
    """Compile the kernel (a no-op when this source is already built).
    Returns ``{"path", "seconds"}``."""
    return _build.build("rglru", SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.rglru_scan_f32.argtypes = [p] * 8 + [i] * 3 + [f] + [ll] * 9 + [p]
        lib.rglru_scan_f32.restype = i
        lib.rglru_error_string.argtypes = [i]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(xr, ga, gx, gate, a_param, h0):
    """Raise ValueError on what the kernel does not take; the device last,
    so that every other check also runs on CPU tensors."""
    if xr.dim() != 3:
        raise ValueError(f"expected xr (B, L, W); got {tuple(xr.shape)}")
    bs, l, w = xr.shape
    for name, t in (("ga", ga), ("gx", gx), ("gate", gate)):
        if t.shape != xr.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, xr "
                             f"{tuple(xr.shape)}")
    if tuple(a_param.shape) != (w,):
        raise ValueError(f"a_param is {tuple(a_param.shape)}, expected "
                         f"({w},)")
    if h0 is not None and tuple(h0.shape) != (bs, w):
        raise ValueError(f"h0 is {tuple(h0.shape)}, expected ({bs}, {w})")
    if not (1 <= bs <= 65535 and l >= 1 and w >= 1):
        raise ValueError(f"need 1 <= B <= 65535, L >= 1 and W >= 1; got "
                         f"{tuple(xr.shape)}")
    named = [("xr", xr), ("ga", ga), ("gx", gx), ("gate", gate),
             ("a_param", a_param)] + ([] if h0 is None else [("h0", h0)])
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             "float32 only")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last dim")
    for name, t in named:
        if t.device.type != "cuda" or t.device != xr.device:
            raise ValueError(f"{name} is on {t.device}, expected xr's CUDA "
                             f"device {xr.device}")


def rglru_scan_cuda(xr, ga, gx, gate, a_param, c: float, h0=None):
    """xr, ga, gx, gate: (B, L, W) float32 CUDA tensors, read through their
    (B, L) strides with a unit stride along W; a_param: (W,); h0: optional
    (B, W) f32 state.  Returns (y (B, L, W) f32, hT (B, W) f32), the
    function of ``ref.rglru_scan_ref``."""
    _check(xr, ga, gx, gate, a_param, h0)
    bs, l, w = xr.shape
    y = torch.empty((bs, l, w), dtype=torch.float32, device=xr.device)
    hT = torch.empty((bs, w), dtype=torch.float32, device=xr.device)
    lib = _library()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rglru_scan_f32(
            xr.data_ptr(), ga.data_ptr(), gx.data_ptr(), gate.data_ptr(),
            a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hT.data_ptr(), bs, l, w, float(c),
            *xr.stride()[:2], *ga.stride()[:2], *gx.stride()[:2],
            *gate.stride()[:2], 0 if h0 is None else h0.stride(0), stream)
    if rc != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + lib.rglru_error_string(rc).decode())
    return y, hT
