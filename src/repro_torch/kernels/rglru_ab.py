"""Time the RG-LRU scan kernel against an earlier version of its source at
RecurrentGemma-2B's prefill and decode shapes, in one process on one card.

    git show 3e8270e:src/repro_torch/kernels/rglru.cu > build/ab/rglru0.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.rglru_ab build/ab/rglru0.cu

The baseline's C entry point ``rglru_scan_f32`` is the one-launch design's:
the current arguments without the two chunk summaries.  Both sources are
built in parallel.  The inputs are those of ``models/rglru.py``: xr, gate,
and ga and gx as strided views of one (B, L, 2W) product; the prefill
starts from h = 0, the decode step from a random h0.  At each shape each
kernel is first held against the plain version (max |err| <= 5e-5 of max
|y| and of max |hT|), then timed with both methods of ``kernels.timing``
in the order baseline, current, current, baseline; the current kernel's
launches per call of each pass are read from its library's own counts
over those 10 calls and held to its plan, and the device ms of a launch of
each pass come from a ``torch.profiler`` trace of the same calls.  ``--chunks 64 128`` also builds the current source with those
chunk lengths and times each, held against the plain version first, at
the prefill shape with ``device_ms`` in the order current, the others,
the others reversed, current.  Prints the card's name and power limit,
then one JSON line with every reading, the bytes bound and the ratios of
the means.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref, timing
from repro_torch.kernels import rglru as _rglru

SHAPES = {"prefill": (2, 3072, 2560, False), "decode": (2, 1, 2560, True)}
C = 8.0             # RecurrentGemma's c
HBM_BYTES_S = 3.35e12
LIMIT = 5e-5
METHODS = ("per_call_ms", "device_ms")


def _baseline(path: str):
    """A call of the baseline library at path, as its wrapper made it."""
    scan = ctypes.CDLL(path).rglru_scan_f32
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    scan.argtypes = [p] * 8 + [i] * 3 + [f] + [ll] * 9 + [p]
    scan.restype = i

    def call(xr, ga, gx, gate, a, c, h0):
        # the same checks and device guard as the current wrapper, so that
        # ``per_call_ms`` reads the same host work for both
        _rglru._check(xr, ga, gx, gate, a, h0)
        bs, l, w = xr.shape
        y = torch.empty((bs, l, w), dtype=torch.float32, device=xr.device)
        hT = torch.empty((bs, w), dtype=torch.float32, device=xr.device)
        with torch.cuda.device(xr.device):
            rc = scan(xr.data_ptr(), ga.data_ptr(), gx.data_ptr(),
                      gate.data_ptr(), a.data_ptr(),
                      None if h0 is None else h0.data_ptr(), y.data_ptr(),
                      hT.data_ptr(), bs, l, w, float(c), *xr.stride()[:2],
                      *ga.stride()[:2], *gx.stride()[:2], *gate.stride()[:2],
                      0 if h0 is None else h0.stride(0),
                      torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: cudaError {rc}")
        return y, hT

    return call


def inputs(b, l, w, with_h0, gen: torch.Generator):
    """Seeded inputs on the card, Λ as the model's init draws it."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    xr, gate, g = rand(b, l, w), rand(b, l, w), rand(b, l, 2 * w)
    u = 0.81 + (0.998001 - 0.81) * torch.rand(w, generator=gen,
                                              device="cuda")
    a = torch.log(torch.expm1(-torch.log(u) / 16.0))
    return (xr, g[..., :w], g[..., w:], gate, a, C,
            rand(b, w) if with_h0 else None)


def variant_source(chunk: int) -> str:
    """The current ``rglru.cu`` built with chunks of ``chunk`` steps."""
    text = _rglru.SOURCE.read_text()
    line = f"constexpr int CHUNK = {_rglru.CHUNK};"
    if line not in text:
        raise RuntimeError(f"{_rglru.SOURCE.name} lacks {line!r}")
    return text.replace(line, f"constexpr int CHUNK = {chunk};")


def passes(fn, l: int, calls: int = 10) -> dict:
    """Per pass of ``calls`` calls of ``fn`` over ``l`` steps, traced with
    device activity only: the launches per call from the library's counts
    (held to :func:`rglru.plan`), the launches the trace recorded, and
    the device ms of a recorded launch."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = _rglru.launched()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    after = _rglru.launched()
    per_call = {k: (after[k] - before[k]) / calls for k in _rglru.PASSES}
    want = {k: float(k in _rglru.plan(l)) for k in _rglru.PASSES}
    if per_call != want:
        raise RuntimeError(f"L {l}: launches per call {per_call}, the plan "
                           f"{want}")
    kern = {}
    for evt in prof.key_averages():
        row = kern.setdefault(evt.key, [0.0, 0])
        row[0] += evt.self_device_time_total
        row[1] += evt.count
    traced, out = _rglru.pass_totals(kern), {}
    for k in _rglru.plan(l):
        us, n = traced.get(k, (0.0, 0))
        out[k] = {"launches_per_call": per_call[k], "traced_launches": n,
                  "ms_per_launch": us / 1e3 / n if n else None}
    return out


def _held(name, fn, t, want_y, want_h, label) -> dict:
    """fn's relative errors against the plain version; raises past
    ``LIMIT``."""
    y, hT = fn(*t)
    errs = {"y": float((y - want_y).abs().max() / want_y.abs().max()),
            "state": float((hT - want_h).abs().max() / want_h.abs().max())}
    if max(errs.values()) > LIMIT:
        raise RuntimeError(f"{name} kernel vs plain at {label}: relative "
                           f"errors {errs}")
    return errs


def compare_chunks(variants: dict, gen: torch.Generator) -> dict:
    """The current kernel against builds of its source at other chunk
    lengths, at the prefill shape."""
    b, l, w, with_h0 = SHAPES["prefill"]
    t = inputs(b, l, w, with_h0, gen)
    want_y, want_h = ref.rglru_scan_ref(*t)
    kernels = {f"chunk{_rglru.CHUNK}": _rglru.rglru_scan_cuda, **variants}
    row = {name: {"rel_max_err": _held(name, fn, t, want_y, want_h,
                                       "the prefill"), "device_ms": []}
           for name, fn in kernels.items()}
    for name in list(kernels) + list(kernels)[::-1]:
        row[name]["device_ms"].append(timing.device_ms(
            lambda fn=kernels[name]: fn(*t), iters=20))
    first = f"chunk{_rglru.CHUNK}"
    mean = {name: statistics.mean(row[name]["device_ms"]) for name in row}
    row["over_current"] = {name: mean[name] / mean[first] for name in row}
    return row


def compare(kernels: dict, shape, gen: torch.Generator) -> dict:
    b, l, w, with_h0 = shape
    t = inputs(b, l, w, with_h0, gen)
    want_y, want_h = ref.rglru_scan_ref(*t)
    n = b * l * w
    # xr, ga, gx, gate read and y written once; Λ, h0 and hT
    nbytes = 4 * (5 * n + w + (2 if with_h0 else 1) * b * w)
    row = {"shape": [b, l, w], "h0": with_h0, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_S * 1e3}
    for name, fn in kernels.items():
        row[name] = {"rel_max_err": _held(name, fn, t, want_y, want_h,
                                          shape),
                     **{m: [] for m in METHODS}}
    for name in ("baseline", "current", "current", "baseline"):
        for m in METHODS:
            row[name][m].append(getattr(timing, m)(
                lambda fn=kernels[name]: fn(*t), iters=20 if l > 1 else 50))
    mean = {name: {m: statistics.mean(row[name][m]) for m in METHODS}
            for name in kernels}
    row["bound_share"] = {name: {m: row["bound_ms"] / mean[name][m]
                                 for m in METHODS} for name in kernels}
    row["baseline_over_current"] = {
        m: mean["baseline"][m] / mean["current"][m] for m in METHODS}
    row["current_passes"] = passes(lambda: kernels["current"](*t), l)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", help="the earlier rglru.cu")
    ap.add_argument("--chunks", type=int, nargs="*", default=[],
                    help="also time the current source at these chunk "
                         "lengths")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rglru_ab needs a CUDA card")
    card = timing.card()
    print(card, flush=True)
    chunks = [n for n in args.chunks if n != _rglru.CHUNK]
    ab_dir = _build.BUILD_ROOT.parent / "ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    for n in chunks:
        (ab_dir / f"rglru_chunk{n}.cu").write_text(variant_source(n))
    with ThreadPoolExecutor(2 + len(chunks)) as pool:
        base = pool.submit(_build.build, "rglru_baseline",
                           Path(args.baseline).resolve())
        current = pool.submit(_rglru.build)
        built = {n: pool.submit(_build.build, f"rglru_chunk{n}",
                                ab_dir / f"rglru_chunk{n}.cu")
                 for n in chunks}
        base_path = base.result()["path"]
        current.result()
        built = {n: f.result()["path"] for n, f in built.items()}
    kernels = {"baseline": _baseline(base_path),
               "current": _rglru.rglru_scan_cuda}
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "chunk": _rglru.CHUNK,
              "order": ["baseline", "current", "current", "baseline"]}
    for name, shape in SHAPES.items():
        result[name] = compare(kernels, shape, gen)
    if chunks:
        variants = {f"chunk{n}": functools.partial(
            _rglru.scan, _rglru.load(path)) for n, path in built.items()}
        result["chunks"] = compare_chunks(variants, gen)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
