"""Roofline terms of a program on one card.

    compute term    = Σ over units  FLOPs_unit / peak_unit
    memory term     = bytes / HBM bandwidth
    collective term = 0

The counts come from ``launch/op_analysis.py`` (a run on the meta device)
and the peaks from ``launch/mesh.py``.  The port mixes precisions: the
token and attention kernels run f32 as 3xTF32 on the tensor cores, the
request-row kernel, the RG-LRU scan and every cuBLAS product (the LM
head, the backward) run f32 outside them.  So the compute term sums each
unit's FLOPs over that unit's own peak; one peak for all of them would
misstate the bound.

What the JAX package's roofline has and this one does not, by design: the
collective term and ``collective_bytes`` (parsed from partitioned HLO
text), the production meshes of ``mesh.py``, ``sharding.py`` and
``shardctx.py``.  Those are GSPMD over TPU v5e pods.  The port runs one
program on one card, with no GSPMD partitioner and no HLO text: ``chips``
is 1, ``coll_bytes_per_chip`` is 0 and ``coll_breakdown`` is empty.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.launch import mesh


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, float]
    memory_per_chip: Optional[dict] = None
    model_flops: Optional[float] = None
    #: FLOPs by arithmetic unit (``mesh.UNITS``); FLOPs no unit claims
    #: count at the FP32 peak
    flops_by_unit: Dict[str, float] = dataclasses.field(default_factory=dict)
    card: str = mesh.DEFAULT_CARD

    @property
    def t_compute(self) -> float:
        peak = mesh.peaks(self.card)
        claimed = sum(self.flops_by_unit.values())
        t = sum(f / mesh.unit_rate(peak, u)
                for u, f in self.flops_by_unit.items())
        return t + max(self.flops_per_chip - claimed, 0.0) / peak["fp32"]

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / mesh.peaks(self.card)["hbm"]

    @property
    def t_collective(self) -> float:
        return 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops:
            return None
        return self.model_flops / max(self.flops_per_chip * self.chips, 1.0)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "memory_per_chip": self.memory_per_chip,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def kernel_bound(peak: Dict[str, float], work) -> Tuple[float, str]:
    """(bound ms, "operations" or "bytes") of one kernel call's ``work``
    (flops, bytes, unit) on a card of peaks ``peak``: the larger of its
    FLOPs over its unit's rate and its bytes over HBM bandwidth."""
    flops, nbytes, unit = work
    t_ops = flops / mesh.unit_rate(peak, unit) * 1e3
    t_bytes = nbytes / peak["hbm"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def model_flops_estimate(n_params_active: float, tokens: float,
                         train: bool) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward."""
    return (6.0 if train else 2.0) * n_params_active * tokens


def fmt_seconds(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"
