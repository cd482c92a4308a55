"""Build and launch of the Hopper RG-LRU scan kernel (``rglru.cu``), the
port's own kernel for the recurrence of RecurrentGemma's recurrent block:
the JAX package has no Pallas kernel there (``jax.lax.associative_scan``
in ``repro/models/rglru.py``, which XLA fuses on the TPU).

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, shapes, strides and PyTorch's current stream.  A failed build or
launch raises; nothing here falls back to the plain version
(``ref.rglru_scan_ref``).  The scan is chunked (``rglru.cu``; its plain
model is ``ref.rglru_scan_chunked_ref``): a call over L > ``CHUNK`` steps
is three launches — chunk summaries, the carries, the output — and one of
L <= ``CHUNK`` steps, a decode step's, is one (:func:`plan`).  The library
counts the launches it makes of each pass (:func:`launched`), so that what
a call ran is read, not reckoned; a captured graph's replays are counted
beside it (:data:`REPLAYED`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("rglru.cu")
THREADS = 128  # channels per block (rglru.cu)
CHUNK = 32     # steps per chunk (rglru.cu)
MAX_GRID_X = 2**31 - 1  # blocks of the one-dimensional grid
# the kernels of rglru.cu, in launch order, as the SASS and a profiler
# trace name them
PASSES = ("rglru_summary", "rglru_carry", "rglru_output")
_LIB = None
#: {pass: launches} made by replays of captured graphs (the decode graphs,
#: ``launch/decode_graph.py``): the captured launches times the replays
REPLAYED = dict.fromkeys(PASSES, 0)


def work(b: int, l: int, w: int, h0: bool = False) -> tuple:
    """(FLOPs, bytes, unit) of one call over (b, l, w): about 20 f32
    operations a channel and step (the gates, the decay's power and
    square root, the recurrence, the GELU branch's product); xr, ga, gx
    and gate read and y written once, Λ, h0 (when given) and hT; f32
    FMAs outside the tensor cores."""
    n = b * l * w
    return 20 * n, 4 * (5 * n + w + (2 if h0 else 1) * b * w), "fp32"


def build() -> dict:
    """Compile the kernel (a no-op when this source is already built).
    Returns ``{"path", "seconds"}``."""
    return _build.build("rglru", SOURCE)


def load(path) -> ctypes.CDLL:
    """The library at ``path``, built from this source or a variant of it
    with the same entry points, its arguments declared."""
    lib = ctypes.CDLL(str(path))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.rglru_scan_f32.argtypes = [p] * 10 + [i] * 3 + [f] + [ll] * 9 + [p]
    lib.rglru_scan_f32.restype = i
    lib.rglru_error_string.argtypes = [i]
    lib.rglru_error_string.restype = ctypes.c_char_p
    lib.rglru_chunk.argtypes = []
    lib.rglru_chunk.restype = i
    lib.rglru_launched.argtypes = [ctypes.POINTER(ll)]
    lib.rglru_launched.restype = None
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = load(build()["path"])
        if lib.rglru_chunk() != CHUNK:
            raise RuntimeError(f"rglru.cu is built with chunk "
                               f"{lib.rglru_chunk()}, the wrapper takes "
                               f"{CHUNK}")
        _LIB = lib
    return _LIB


def plan(l: int) -> tuple:
    """The passes one call over ``l`` steps launches, once each."""
    return PASSES if l > CHUNK else PASSES[-1:]


def launched() -> dict:
    """{pass: launches} this source's library has made since it was
    loaded, counted in ``rglru.cu`` where each launch reported no error
    (zeros before it is loaded).  A launch recorded by a CUDA graph's
    capture counts here once; the graph's replays make no call into the
    library, and their launches are counted in :data:`REPLAYED`."""
    if _LIB is None:
        return dict.fromkeys(PASSES, 0)
    out = (ctypes.c_longlong * len(PASSES))()
    _LIB.rglru_launched(out)
    return dict(zip(PASSES, out))


def pass_totals(kern: dict) -> dict:
    """{pass: [device µs, launches]} summed from a profiler's {kernel name:
    [device µs, launches]}, whose names hold the pass names."""
    out = {}
    for k, (us, n) in kern.items():
        for name in PASSES:
            if name in k:
                row = out.setdefault(name, [0.0, 0])
                row[0] += us
                row[1] += n
    return out


def scratch_shape(bs: int, l: int, w: int, chunk: int = CHUNK) -> tuple:
    """Shape of each of the two f32 chunk summaries a call needs: every
    chunk but the last, per row and channel."""
    return (bs, -(-l // chunk) - 1, w)


def blocks(bs: int, l: int, w: int) -> int:
    """Blocks of the output pass, the largest of the call's grids."""
    return bs * -(-l // CHUNK) * -(-w // THREADS)


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
    if not (bs >= 1 and l >= 1 and w >= 1):
        raise ValueError(f"need B, L and W >= 1; got {tuple(xr.shape)}")
    if blocks(bs, l, w) > MAX_GRID_X:
        raise ValueError(f"{tuple(xr.shape)} needs {blocks(bs, l, w)} "
                         f"blocks of {THREADS} channels and {CHUNK} steps, "
                         f"over the grid's {MAX_GRID_X}")
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
    return scan(None, xr, ga, gx, gate, a_param, c, h0)


def scan(lib, xr, ga, gx, gate, a_param, c: float, h0=None):
    """:func:`rglru_scan_cuda` through ``lib`` (:func:`load`; None is this
    source's library, built on first use), whose own chunk length sizes
    the scratch."""
    _check(xr, ga, gx, gate, a_param, h0)
    bs, l, w = xr.shape
    if lib is None:
        lib = _library()
    chunk = lib.rglru_chunk()
    y = torch.empty((bs, l, w), dtype=torch.float32, device=xr.device)
    hT = torch.empty((bs, w), dtype=torch.float32, device=xr.device)
    # the two chunk summaries, one allocation; none for a single chunk
    sums = (torch.empty((2,) + scratch_shape(bs, l, w, chunk),
                        dtype=torch.float32, device=xr.device)
            if l > chunk else None)
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rglru_scan_f32(
            xr.data_ptr(), ga.data_ptr(), gx.data_ptr(), gate.data_ptr(),
            a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hT.data_ptr(),
            *((None, None) if sums is None else
              (sums.data_ptr(), sums.data_ptr() + 4 * sums.stride(0))),
            bs, l, w, float(c),
            *xr.stride()[:2], *ga.stride()[:2], *gx.stride()[:2],
            *gate.stride()[:2], 0 if h0 is None else h0.stride(0), stream)
    if rc != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + lib.rglru_error_string(rc).decode())
    return y, hT
