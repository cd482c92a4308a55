"""The card's constants: one NVIDIA H100, one device.

The JAX package's ``mesh.py`` builds GSPMD meshes over TPU v5e pods and
holds their roofline constants.  The port runs on one card, so its mesh
is that card (:func:`num_chips` is 1) and its constants are the card's
published peaks, keyed by the name ``nvidia-smi`` reports
(``--query-gpu=name``).  Sources: NVIDIA H100 Tensor Core GPU data sheet
(SXM5 = "H100 80GB HBM3", PCIe, NVL): FP32 on the CUDA cores; TF32 and
BF16 on the tensor cores, dense (the sheet's sparse figures halved); HBM
bandwidth.  In FLOP/s and bytes/s.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                       "hbm": 3.35e12},
    "H100 PCIe": {"fp32": 51e12, "tf32": 378e12, "bf16": 756e12,
                  "hbm": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "tf32": 417.5e12, "bf16": 835.5e12,
                 "hbm": 3.9e12},
}
#: the card the port is written for, whose peaks a count on the meta
#: device is read against
DEFAULT_CARD = "H100 80GB HBM3"

#: arithmetic units a kernel or an op runs its products on: (the peak it
#: runs at, passes a FLOP takes).  An f32 product on the tensor cores is
#: three TF32 passes (3xTF32: the big and small halves of each operand);
#: an f32 product outside them (cuBLAS with TF32 off, FMAs) runs at the
#: FP32 peak.
UNITS = {"3xtf32": ("tf32", 3), "fp32": ("fp32", 1), "bf16": ("bf16", 1)}


def peaks(card: Optional[str] = None) -> Dict[str, float]:
    """The published peaks of the card named ``card`` as ``nvidia-smi``
    names it (``DEFAULT_CARD`` when None).  Raises for a card with no
    entry, or a name that matches more than one."""
    card = DEFAULT_CARD if card is None else card
    found = [v for k, v in PEAKS.items() if k in card]
    if len(found) != 1:
        raise KeyError(f"no published peaks on file for {card!r}")
    return found[0]


def unit_rate(peak: Dict[str, float], unit: str) -> float:
    """FLOP/s of ``unit`` (a key of ``UNITS``) on a card of peaks
    ``peak``."""
    key, passes = UNITS[unit]
    return peak[key] / passes


def num_chips() -> int:
    """Devices a program of the port runs on: one card."""
    return 1


#: device memory of one card, for ``dryrun``'s ``fits_one_card``
CARD_BYTES = 80e9
