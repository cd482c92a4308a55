"""Build and launch of the batch-invariant f32 linear kernels (``gemm.cu``),
which replace cuBLAS's f32 GEMM on the DiT path: cuBLAS picks its
reduction by M, so a row's bits change with the batch it rides in, and the
serving stack's per-row contract needs them not to.

Two variants behind one call, picked by the call site (``rows``), never by
M: ``"tokens"`` (the token products: 3xTF32 ``wgmma`` over the weight's
split halves, ``prepare``) and ``"requests"`` (the request-row products:
f32 FMAs streaming w as stored).  ``plan`` gives each variant's tile,
stages and k order from (K, N) alone; only the grid follows M.

The source is compiled on first use (``kernels/build.py``) into a shared
library with a plain C interface, called through ``ctypes`` with raw
pointers, the shape, the tile and PyTorch's current stream.  A failed build
or launch raises; nothing here falls back to cuBLAS or to the plain
version.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import re
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref

SOURCE = Path(__file__).with_name("gemm.cu")
ROWS = ("tokens", "requests")


def _source_constant(name: str) -> int:
    """``gemm.cu``'s ``constexpr int name``: what the library is built with."""
    found = re.search(rf"^constexpr int {name} = (\d+);",
                      SOURCE.read_text(), re.M)
    if found is None:
        raise RuntimeError(f"{SOURCE.name} defines no constexpr int {name}")
    return int(found.group(1))


#: the token kernel: rows per tile (two warpgroups of 64), the k-tile
#: (128 B of f32) and the k-tiles of one accumulator run, read from
#: ``gemm.cu``; the tile widths built into it (``TOKEN_TILES``) and the
#: width picked per (K, N) by timing candidates (``gemm_ab --tiles``):
#: DiT-XL/2's and OpenSora's products (d 1152) at M = 512 to 2048,
#: Stable-Audio-Open's (d 1536) by their sum over one forward at 1, 2 and 4
#: requests (``--model audio``), Qwen3-14B's (d 5120) by their sum over one
#: generate, a prefill at M = 4096 and 31 decode steps at M = 4 (``--model
#: qwen3``); other shapes take the widest built width that divides N
TOKEN_BM, TOKEN_BK, TOKEN_PROMOTE = (_source_constant(name)
                                     for name in ("BM", "BK", "PROMOTE"))
TOKEN_BN = (144, 128, 96, 64, 16)
TOKEN_CHOICE = {(16, 1152): 144, (1152, 1152): 144, (4608, 1152): 144,
                (1152, 4608): 144, (1152, 16): 16,
                (64, 1536): 96, (1536, 1536): 96, (768, 1536): 96,
                (1536, 6144): 96, (6144, 1536): 96, (1536, 64): 16,
                (5120, 5120): 64, (5120, 1024): 64, (5120, 17408): 128,
                (17408, 5120): 64}
#: the request-row kernel: rows per tile, threads per block, column slices
#: (16 bytes a thread along N), and the blocks it aims for (the H100's 132
#: SMs)
REQUEST_ROWS, REQUEST_THREADS, REQUEST_NB = 16, 256, (32, 16, 8)
REQUEST_BLOCKS = 132
#: each variant's tile table, as the ``kernels`` line reports it
TILE = {"tokens": {"bm": TOKEN_BM, "bk": TOKEN_BK, "built_bn": TOKEN_BN,
                   "bn": {f"{k}x{n}": bn
                          for (k, n), bn in TOKEN_CHOICE.items()}},
        "requests": {"rows": REQUEST_ROWS, "nb": REQUEST_NB,
                     "threads": REQUEST_THREADS}}
_LIB = None


def token_stages(bn: int) -> int:
    """Stages of the token kernel's ring at tile width bn, as ``gemm.cu``'s
    ``TokenTile`` counts them: as many as fit in 220 KB, at most 6."""
    stage = TOKEN_BM * TOKEN_BK * 4 + 2 * bn * TOKEN_BK * 4
    return min(6, (220 * 1024) // stage)


@functools.lru_cache(maxsize=None)
def _width(k: int, n: int, rows: str) -> int:
    if rows == "tokens":
        if (k, n) in TOKEN_CHOICE:
            return TOKEN_CHOICE[(k, n)]
        fits = [bn for bn in TOKEN_BN if n % bn == 0]
        return fits[0] if fits else min(
            (bn for bn in TOKEN_BN if bn >= n), default=TOKEN_BN[0])
    fits = [nb for nb in REQUEST_NB if -(-n // nb) >= REQUEST_BLOCKS]
    return fits[0] if fits else REQUEST_NB[-1]


@contextlib.contextmanager
def token_widths(choice: dict):
    """Within the block, plan the token kernel's (K, N) in ``choice`` at
    the built width it gives, as if it were in ``TOKEN_CHOICE``: an A/B of
    whole runs at other widths (``gemm_ab --generate``)."""
    bad = {kn: bn for kn, bn in choice.items() if bn not in TOKEN_BN}
    if bad:
        raise ValueError(f"widths not built: {bad}; built: {TOKEN_BN}")
    saved = dict(TOKEN_CHOICE)
    TOKEN_CHOICE.update(choice)
    _width.cache_clear()
    try:
        yield
    finally:
        TOKEN_CHOICE.clear()
        TOKEN_CHOICE.update(saved)
        _width.cache_clear()


def plan(k: int, n: int, rows: str = "tokens") -> dict:
    """What fixes a row's bits in the product of an (M, k) x by a (k, n) w:
    the kernel, its tile, stages and k order — from (k, n, rows) alone."""
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    width = _width(k, n, rows)
    if rows == "tokens":
        return {"rows": rows, "kernel": "gemm_tokens_wgmma",
                "tile": [TOKEN_BM, width], "bk": TOKEN_BK,
                "stages": token_stages(width),
                "k_order": f"runs of {TOKEN_PROMOTE} k-tiles of 32 "
                           "ascending, each run in a fresh wgmma "
                           "accumulator (per k8 slice small_x*big_w, "
                           "big_x*small_w, big_x*big_w), then added to an "
                           "f32 sum in run order"}
    slices = REQUEST_THREADS // (width // 4)
    return {"rows": rows, "kernel": "gemm_requests_ffma",
            "tile": [REQUEST_ROWS, width], "k_slices": slices,
            "k_slice": -(-k // slices),
            "k_order": "each slice ascending by f32 FMA, the slices summed "
                       "in a pairwise tree"}


def launch_plan(m: int, k: int, n: int, rows: str = "tokens") -> dict:
    """``plan`` and the grid of one launch over m rows on the H100's 132
    SMs: the token kernel is persistent (one block per SM, at most one per
    tile), the request-row kernel one block per (column slice, 16 rows)."""
    p = plan(k, n, rows)
    bm, bn = p["tile"]
    tiles = -(-m // bm) * -(-n // bn)
    grid = ([min(tiles, REQUEST_BLOCKS)] if rows == "tokens"
            else [-(-n // bn), -(-m // bm)])
    return {**p, "grid": grid}


def work(m: int, k: int, n: int, bias: bool = False,
         rows: str = "tokens") -> tuple:
    """(FLOPs, bytes, unit) of one product of an (m, k) x by a (k, n) w in
    f32: x, w and the bias read once, the (m, n) output written once; the
    token kernel runs 3xTF32 on the tensor cores, the request-row kernel
    f32 FMAs outside them."""
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    return (2 * m * k * n, 4 * (m * k + k * n + m * n + (n if bias else 0)),
            "3xtf32" if rows == "tokens" else "fp32")


def build(flags=()) -> dict:
    """Compile the kernels (a no-op when this source is already built);
    ``flags`` (for example ``("-DGEMM_ALL_TILES",)``) build a separate
    library.  Returns ``{"path", "seconds"}``."""
    name = "gemm" + "".join("_" + f.lstrip("-").replace("=", "").lower()
                            for f in flags)
    return _build.build(name, SOURCE, flags=list(flags))


def bind(path: str):
    """The library at path with its C entry points typed."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_tokens_f32.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.linear_tokens_f32.restype = i
    lib.linear_requests_f32.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.linear_requests_f32.restype = i
    lib.linear_error_string.argtypes = [i]
    lib.linear_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()["path"])
    return _LIB


# ---------------------------------------------------------------------------
# The token kernel's prepared weights
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Prepared:
    """A weight's split halves for the token kernel, each (N, K) f32."""
    weight: torch.Tensor  # held, so that its address is not reused
    version: int
    big_t: torch.Tensor
    small_t: torch.Tensor
    captured: bool = False  # read by a launch that a CUDA graph captured


_PREPARED: dict = {}
# copies replaced after an in-place change of their weight that a captured
# graph may still read: they live until ``release``.  A copy that no
# capture read is dropped when it is replaced, so that a training loop's
# in-place updates keep one copy a weight.
_RETIRED: list = []
# copies dropped from ``_PREPARED`` so far (``release``, or a weight's copy
# made anew): a holder of copies checks that they are current only when
# this has moved
_DROPPED = [0]


def _key(w):
    # the storage's address plus the view's offset, its shape and strides:
    # a view of a stacked leaf made anew (a[r]) finds its copy
    return (w.device, w.data_ptr(), tuple(w.shape), tuple(w.stride()))


def prepare(w) -> Prepared:
    """The split halves of weight w (K, N) for the token kernel, made once
    (``ref.split_tf32_t``) and kept until ``release``; made anew when w was
    changed in place (``w._version``: update weights through the tensor,
    ``p.add_`` or ``p.copy_``, never through ``p.data``, whose version is
    not shared).  A copy missing while the stream captures a CUDA graph
    raises: prepare every weight before a capture."""
    key = _key(w)
    hit = _PREPARED.get(key)
    if hit is not None and hit.version == w._version:
        return hit
    if w.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"no prepared copy of a ({w.shape[0]}, {w.shape[1]}) weight "
            "while a CUDA graph captures: call gemm.prepare (or "
            "diffusion.prepare_linear) on every weight before the capture")
    if hit is not None:
        del _PREPARED[key]
        _DROPPED[0] += 1
        if hit.captured:
            _RETIRED.append(hit)
        hit = None  # the old halves go before the new ones are made
    with torch.no_grad():
        w = w.detach()  # shares w's version counter
        big_t, small_t = ref.split_tf32_t(w)
    hit = Prepared(w, w._version, big_t, small_t)
    _PREPARED[key] = hit
    return hit


def prepare_params(weights) -> int:
    """Prepare every weight of an iterable; returns the bytes the prepared
    copies hold in all."""
    for w in weights:
        prepare(w)
    return prepared_bytes()


def _bytes(copies) -> int:
    return sum(p.big_t.numel() * p.big_t.element_size() * 2 for p in copies)


def prepared_bytes() -> int:
    """Bytes of the current prepared copies."""
    return _bytes(_PREPARED.values())


def retired_bytes() -> int:
    """Bytes of the replaced copies that a captured graph may still read."""
    return _bytes(_RETIRED)


def release() -> None:
    """Drop every prepared copy (and the hold on its weight).  A holder of
    copies, such as a captured graph that reads them, keeps its own alive
    (see ``current``)."""
    _DROPPED[0] += len(_PREPARED)
    _PREPARED.clear()
    _RETIRED.clear()


def dropped() -> int:
    """How many copies have been dropped so far: while it stands still,
    every copy that ``prepare`` returned is still current."""
    return _DROPPED[0]


def current(p: Prepared) -> bool:
    """Whether ``p`` is still its weight's prepared copy, at the weight's
    version (not dropped by ``release``, not made anew)."""
    return (p.version == p.weight._version
            and _PREPARED.get(_key(p.weight)) is p)


# ---------------------------------------------------------------------------
# The call
# ---------------------------------------------------------------------------

def _check(x, w, b, rows):
    """Raise ValueError on what the kernels do not take; the device last,
    so that every other check also runs on CPU tensors."""
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if k % 4 or n % 4 or k == 0 or n == 0:
        raise ValueError(f"K = {k} and N = {n} must be positive multiples "
                         "of 4 (16-byte rows)")
    if rows == "tokens" and m > 64 * 65535:
        raise ValueError(f"M = {m} exceeds 65535 tiles of 64 rows")
    if rows == "requests":
        if -(-m // REQUEST_ROWS) > 65535:
            raise ValueError(f"M = {m} exceeds the grid's 65535 row tiles "
                             f"of {REQUEST_ROWS}")
        if k * REQUEST_ROWS * 4 > 227 * 1024:
            raise ValueError(f"K = {k}: 16 rows of x exceed the request-row "
                             "kernel's shared memory")
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


def linear_cuda(x, w, b=None, *, rows: str = "tokens"):
    """x: (M, K), w: (K, N), b: (N,) or None — contiguous float32 CUDA
    tensors → y = x @ w (+ b), (M, N) float32, each row computed from its
    own row of x alone, in one fixed order; ``rows`` picks the variant
    (``"tokens"``: w's prepared halves, made here on first use)."""
    _check(x, w, b, rows)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    lib = _library()
    width = _width(k, n, rows)
    bias = None if b is None else b.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rows == "tokens":
            p = prepare(w)
            p.captured |= torch.cuda.is_current_stream_capturing()
            rc = lib.linear_tokens_f32(x.data_ptr(), p.big_t.data_ptr(),
                                       p.small_t.data_ptr(), bias,
                                       y.data_ptr(), m, n, k, width, stream)
        else:
            rc = lib.linear_requests_f32(x.data_ptr(), w.data_ptr(), bias,
                                         y.data_ptr(), m, n, k, width,
                                         stream)
    if rc != 0:
        raise RuntimeError(f"linear ({rows}) launch failed: "
                           + lib.linear_error_string(rc).decode())
    return y
