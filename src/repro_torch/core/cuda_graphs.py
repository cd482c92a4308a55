"""Conditional (IF) nodes in a captured CUDA graph (``cuda_graphs.cu``).

PyTorch 2.11 captures CUDA graphs but gives Python no conditional node
(``CUDAGraph.begin_capture_to_if_node`` arrives in later releases).  This
module adds one: :meth:`GraphCapture.if_body` opens an IF node in the graph the current
stream is capturing, with the condition ``code == value`` read on the
device when the graph replays, and captures the body into it from a
stream of its own.  The CUDA source is compiled on first use like the
kernels (``kernels/build.py``, a plain C interface bound with ``ctypes``)
and needs CUDA 12.4 or later.

While a body captures, its stream is PyTorch's current stream, and the
caching allocator serves that stream from ``body_pool`` — a private pool
apart from the graph's own, so that the graph's allocation routing is
left as it was when the body ends.  Nothing here falls back: a missing
piece raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import weakref
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).with_name("cuda_graphs.cu")
#: cudaStreamCaptureMode of the bodies; the enclosing capture uses the
#: matching ``capture_error_mode`` of ``torch.cuda.graph``
CAPTURE_MODE = ("thread_local", 1)
_LIB = None


def build() -> dict:
    """Compile the helper (a no-op when already built): ``{"path",
    "seconds"}``."""
    return _build.build("cuda_graphs", SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p = ctypes.c_void_p
        lib.cond_begin_if.argtypes = [p, p, ctypes.c_longlong, p,
                                      ctypes.c_int]
        lib.cond_begin_if.restype = ctypes.c_int
        lib.cond_end.argtypes = [p]
        lib.cond_end.restype = ctypes.c_int
        lib.cond_stream_create.argtypes = [ctypes.POINTER(p)]
        lib.cond_stream_create.restype = ctypes.c_int
        lib.cond_error_string.argtypes = [ctypes.c_int]
        lib.cond_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + _library().cond_error_string(rc).decode())


def require() -> None:
    """Raise unless this PyTorch and CUDA can build IF nodes."""
    major, minor = (int(v) for v in (torch.version.cuda or "0.0")
                    .split(".")[:2])
    if (major, minor) < (12, 4):
        raise RuntimeError(
            "CUDA graph IF nodes need CUDA >= 12.4; this PyTorch is built "
            f"with CUDA {torch.version.cuda}")
    if not all(hasattr(torch._C, f) for f in (
            "_cuda_beginAllocateCurrentStreamToPool",
            "_cuda_endAllocateToPool", "_cuda_releasePool")):
        raise RuntimeError(
            f"PyTorch {torch.__version__} cannot route a stream's "
            "allocations to a graph memory pool")


def _body_stream() -> torch.cuda.ExternalStream:
    ptr = ctypes.c_void_p()
    _check(_library().cond_stream_create(ctypes.byref(ptr)),
           "cudaStreamCreateWithFlags")
    return torch.cuda.ExternalStream(ptr.value)


def _release(device: int, pool, begins) -> None:
    for _ in range(begins[0]):
        torch._C._cuda_releasePool(device, pool)


class GraphCapture:
    """What one owner's graphs share: the memory pool they capture into
    (``pool``, the owner's, which its plain graphs share too), and the
    pool and streams their IF bodies capture from (a stream per branch
    index, kept for the owner's life: cuBLAS keys its workspaces by
    stream).  The body pool is released when the owner is dropped."""

    def __init__(self, device: torch.device, pool):
        require()
        self.device = torch.device(device).index or 0
        self.pool = pool
        self.body_pool = torch.cuda.graph_pool_handle()
        self.streams = []
        self._begins = [0]
        weakref.finalize(self, _release, self.device, self.body_pool,
                         self._begins)

    def stream(self, i: int):
        while len(self.streams) <= i:
            self.streams.append(_body_stream())
        return self.streams[i]

    @contextlib.contextmanager
    def if_body(self, code: torch.Tensor, value: int):
        """Capture the block's work into an IF node that runs when the
        int64 scalar ``code`` equals ``value`` at replay, from body stream
        ``value``.  Call inside ``torch.cuda.graph(..., pool=self.pool,
        capture_error_mode=CAPTURE_MODE[0])``."""
        if code.dtype != torch.int64 or code.numel() != 1:
            raise ValueError(f"code must be one int64, got {code.dtype} "
                             f"{tuple(code.shape)}")
        lib = _library()
        body = self.stream(value)
        capture = torch.cuda.current_stream()
        _check(lib.cond_begin_if(capture.cuda_stream, code.data_ptr(),
                                 int(value), body.cuda_stream,
                                 CAPTURE_MODE[1]),
               "opening a CUDA graph IF node")
        try:
            with torch.cuda.stream(body):
                torch._C._cuda_beginAllocateCurrentStreamToPool(
                    self.device, self.body_pool)
                self._begins[0] += 1
                try:
                    yield
                finally:
                    torch._C._cuda_endAllocateToPool(self.device,
                                                     self.body_pool)
        finally:
            _check(lib.cond_end(body.cuda_stream),
                   "closing a CUDA graph IF node")
