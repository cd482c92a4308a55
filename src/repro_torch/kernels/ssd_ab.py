"""Time the SSD-scan kernel against an earlier version of its source at the
Mamba-2-1.3B prefill shape, in one process on one card.

    git show 3c7b3f9:src/repro_torch/kernels/ssd.cu > build/ab/ssd_pr12.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.ssd_ab build/ab/ssd_pr12.cu

The baseline's C entry point ``ssd_fwd`` is the one-launch design's: the
current arguments without the two scratches and ``vec``.  Both sources are
built in parallel.  The inputs are x, b and c as the model hands them over
(strided views of one projection, ``models/ssm.py``).  In f32 and in bf16,
each kernel is first held against the plain version (max |err| / max
|plain| <= 1e-4 in f32, 1e-2 in bf16, for y and the final state), then
timed with both methods of ``kernels.timing`` in the order baseline,
current, current, baseline.  Prints the card's name and power limit, then
one JSON line with every reading and the ratios of the means.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref, timing
from repro_torch.kernels import ssd as _ssd

SHAPE = (4, 1024, 64, 64, 1, 128)  # (B, L, H, P, G, N) of the prefill
CHUNK = 128
METHODS = ("per_call_ms", "device_ms")
LIMITS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _baseline(path: str):
    """A call of the baseline library at path, as ``ssd_cuda`` makes it."""
    fwd = ctypes.CDLL(path).ssd_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd.argtypes = [p] * 7 + [i] * 8 + [ll] * 12 + [p]
    fwd.restype = i
    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def call(x, dt, a, b, c):
        bs, l, h, p_ = x.shape
        g, n = b.shape[2], b.shape[3]
        y = torch.empty((bs, l, h, p_), dtype=x.dtype, device=x.device)
        hT = torch.empty((bs, h, p_, n), dtype=torch.float32, device=x.device)
        rc = fwd(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), y.data_ptr(), hT.data_ptr(), dtypes[x.dtype],
                 bs, l, h, p_, g, n, min(CHUNK, l), *x.stride()[:3],
                 *dt.stride(), *b.stride()[:3], *c.stride()[:3],
                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: cudaError {rc}")
        return y, hT

    return call


def inputs(dtype, gen: torch.Generator):
    """Seeded prefill-shape inputs on the card; x, b and c are views of one
    (B, L, H·P + 2·G·N) tensor, as ``models/ssm.py`` splits its projection."""
    bs, l, h, p, g, n = SHAPE
    xbc = torch.randn(bs, l, h * p + 2 * g * n, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(bs, l, h, generator=gen)
                                      - 1.0)
    a = torch.exp(torch.rand(h, generator=gen))
    xbc = xbc.to("cuda", dtype)
    x, b, c = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    return (x.reshape(bs, l, h, p), dt.cuda(), a.cuda(),
            b.reshape(bs, l, g, n), c.reshape(bs, l, g, n))


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def compare(kernels: dict, dtype, gen: torch.Generator) -> dict:
    t = inputs(dtype, gen)
    want_y, want_h = ref.ssd_ref(*t, chunk=CHUNK)
    row = {}
    for name, fn in kernels.items():
        y, hT = fn(*t)
        errs = {"y": _rel(y, want_y), "state": _rel(hT, want_h)}
        if max(errs.values()) > LIMITS[dtype]:
            raise RuntimeError(f"{name} kernel vs plain in {dtype}: "
                               f"relative errors {errs}")
        row[name] = {"rel_max_err": errs, **{m: [] for m in METHODS}}
    for name in ("baseline", "current", "current", "baseline"):
        for m in METHODS:
            row[name][m].append(getattr(timing, m)(
                lambda fn=kernels[name]: fn(*t)))
    mean = {name: {m: statistics.mean(row[name][m]) for m in METHODS}
            for name in kernels}
    row["baseline_over_current"] = {
        m: mean["baseline"][m] / mean["current"][m] for m in METHODS}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="the earlier ssd.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ab needs a CUDA card")
    card = timing.card()
    print(card, flush=True)
    with ThreadPoolExecutor(2) as pool:
        base = pool.submit(_build.build, "ssd_baseline",
                           Path(args.baseline).resolve())
        current = pool.submit(_ssd.build)
        base_path = base.result()["path"]
        current.result()
    kernels = {"baseline": _baseline(base_path),
               "current": lambda *t: _ssd.ssd_cuda(*t, chunk=CHUNK)}
    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "shape": list(SHAPE), "chunk": CHUNK,
              "order": ["baseline", "current", "current", "baseline"]}
    for dtype in LIMITS:
        result[str(dtype)[6:]] = compare(kernels, dtype, gen)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
