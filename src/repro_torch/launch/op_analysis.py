"""FLOPs and bytes of a program, counted on the meta device.

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which
parses compiled HLO text.  The port has no compiled program to parse: it
is eager PyTorch.  So :func:`analyze` runs the program itself on meta
tensors — no allocation, no launch — under a ``TorchDispatchMode`` that
sees every ATen op it dispatches, and counts:

  * FLOPs: 2 × |result| × |contraction| for every product op (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``: what ``matmul``,
    ``einsum`` and ``linear`` decompose into), plus each hand-written
    kernel's own ``work(...)``, which its meta stand-in reports
    (``kernels/ops.py``);
  * bytes: each op's result bytes, plus the entry arguments once.  This is
    the JAX package's model (each intermediate written once and read by
    its consumers; counting results and arguments avoids counting a
    producer / consumer pair twice), except that in eager code every op
    is its own "fusion": an elementwise chain XLA would fuse into one
    result writes each intermediate here, as eager PyTorch does on the
    card.  Views move no bytes and allocation alone writes none; a
    kernel's meta stand-in counts its outputs.

Both are tallied by arithmetic unit (``mesh.UNITS``), since the port
mixes precisions: the token and attention kernels run f32 as 3xTF32 on
the tensor cores, while every ATen product on f32 (the LM head, the
decode einsums, the backward) is cuBLAS with TF32 off, on the FP32 units.

Running ops on meta tensors is itself slow (most of them go through
Python shape rules, ~0.1 ms an op), and a sampler unrolls tens of
thousands.  The mode memoizes each functional op's result metadata by
(op, its tensors' shapes, strides and dtypes, its other arguments) and
answers a repeat with a fresh empty meta tensor of the same metadata; a
view or in-place op, or any op whose arguments cannot be keyed, runs as
it stands.

Python loops unroll by themselves: the JAX package's trip-count logic
(a ``lax.scan`` body counted once by XLA) has nothing to port.  Nothing
collective runs on one card, so ``Totals.coll`` stays empty.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops

#: the unit an ATen product runs on, by its result's dtype
PRODUCT_UNITS = {torch.float32: "fp32", torch.bfloat16: "bf16",
                 torch.float16: "bf16"}
#: ops whose result moves no bytes: allocation, and views ATen does not
#: mark as views
_NO_BYTES = {"empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided", "_unsafe_view", "lift_fresh"}


#: per op: (name, whether it returns fresh tensors — no view, no
#: in-place result —, whether its result moves bytes)
_INFO: dict = {}


def _op_info(func):
    name = func.overloadpacket.__name__
    functional = not (func.is_view or any(r.alias_info is not None
                                          for r in func._schema.returns))
    return name, functional, not (func.is_view or name in _NO_BYTES)


def _product_flops(name: str, args, out) -> float:
    """2 × |result| × |contraction| of one ATen product, 0 for any other
    op."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "mv":
        return 2.0 * out.numel() * args[0].shape[-1]
    if name == "dot":
        return 2.0 * args[0].numel()
    return 0.0


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


_SCALARS = frozenset((int, float, bool, str, type(None), torch.dtype,
                      torch.device, torch.layout, torch.memory_format))


def _key(tree):
    """A hashable stand-in of an op's arguments, each meta tensor by its
    metadata; raises TypeError for an argument it cannot key (a tensor
    with data, whose values may decide the result's shape)."""
    kind = type(tree)
    if kind is tuple or kind is list:
        return tuple([_key(v) if type(v) not in _SCALARS else v
                      for v in tree])
    if kind in _SCALARS:
        return tree
    if isinstance(tree, torch.Tensor):
        if not tree.is_meta:
            raise TypeError("a tensor with data")
        return (tree.shape, tree.stride(), tree.dtype)
    if isinstance(tree, dict):
        return tuple([(k, _key(v)) for k, v in tree.items()])
    if isinstance(tree, tuple(_SCALARS)):
        return tree
    raise TypeError(f"cannot key {kind.__name__}")


def _shape_of(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), [_shape_of(o) for o in out])
    return ("V", out)


def _remake(spec):
    if spec[0] == "T":
        _, shape, stride, dtype = spec
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    if spec[0] == "V":
        return spec[1]
    kind, items = spec
    return kind(_remake(s) for s in items)


def _row_key(kind, name, outs):
    """``top_contributors``' row: the op and its results' shapes."""
    return (f"{kind}:{name}",
            " ".join(str(tuple(o.shape)) for o in outs)[:60])


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: FLOPs by arithmetic unit (``mesh.UNITS``)
    by_unit: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: per hand-written kernel: [calls, FLOPs, bytes by its own ``work``]
    kernels: Dict[str, list] = dataclasses.field(default_factory=dict)
    #: ATen ops dispatched
    ops: int = 0


class _Count(TorchDispatchMode):
    """Counts every ATen op and kernel stand-in of the run it wraps; with
    ``rows`` on, also each one's FLOPs and bytes by (op, result shape)."""

    def __init__(self, rows: bool = False):
        super().__init__()
        self.totals = Totals()
        self.rows = {} if rows else None
        self._memo = {}

    def _tally(self, flops, unit, nbytes, row):
        t = self.totals
        if flops:
            t.flops += flops
            t.by_unit[unit] = t.by_unit.get(unit, 0.0) + flops
        t.bytes += nbytes
        if self.rows is not None and (flops or nbytes):
            acc = self.rows.setdefault(row, [0.0, 0.0, 0])
            acc[0] += flops
            acc[1] += nbytes
            acc[2] += 1

    def meter(self, name, work, outs):
        flops, _, unit = work
        self._tally(flops, unit, _nbytes(outs), _row_key("kernel", name, outs))
        row = self.totals.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += work[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        """Run ``func`` on meta tensors and count it.  A functional op seen
        before with the same arguments' metadata is answered from the memo:
        a fresh empty meta result and the same counts."""
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _op_info(func)
        name, functional, moves_bytes = info
        kwargs = kwargs or {}
        self.totals.ops += 1
        key = None
        if functional:
            try:
                key = (func, _key(args), _key(kwargs) if kwargs else ())
                hit = self._memo.get(key)
            except TypeError:
                key = hit = None
            if hit is not None:
                spec, cost = hit
                self._tally(*cost)
                return _remake(spec)
        out = func(*args, **kwargs)
        cost = (0.0, None, 0, None)
        if moves_bytes:
            outs = _tensors(out)
            flops = _product_flops(name, args, out) if outs else 0.0
            cost = (flops, PRODUCT_UNITS[out.dtype] if flops else None,
                    _nbytes(outs), _row_key("aten", name, outs))
        self._tally(*cost)
        if key is not None and all(t.is_meta for t in _tensors(out)):
            self._memo[key] = (_shape_of(out), cost)
        return out

    def __enter__(self):
        ops.METERS.append(self.meter)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.METERS.remove(self.meter)
        return super().__exit__(*exc)


def _run(count: _Count, fn, args, kw):
    entry = {id(t): t for t in _tensors((args, kw))}
    count.totals.bytes += _nbytes(entry.values())
    with count:
        fn(*args, **kw)
    return count


def analyze(fn, *args, **kw) -> Totals:
    """The FLOPs and bytes of ``fn(*args, **kw)``, run as it stands: give
    it meta tensors (``launch.programs``' structs) to count without
    allocating or launching anything."""
    return _run(_Count(), fn, args, kw).totals


def top_contributors(fn, *args, n: int = 15, kind: str = "bytes", **kw):
    """The largest contributions to ``analyze(fn, *args, **kw)``'s
    ``kind`` ("bytes", "flops" or "coll"), summed by (op, result shapes):
    rows (value, op, shapes, times run), largest first.  "coll" is empty
    on one card."""
    if kind not in ("bytes", "flops", "coll"):
        raise ValueError(f"kind must be bytes, flops or coll, got {kind!r}")
    count = _run(_Count(rows=True), fn, args, kw)
    if kind == "coll":
        return []
    at = 0 if kind == "flops" else 1
    rows = [(v[at], op, shapes, v[2])
            for (op, shapes), v in count.rows.items() if v[at]]
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:n]
