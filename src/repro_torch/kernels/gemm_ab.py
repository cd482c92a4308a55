"""Time the linear kernels against an earlier version of ``gemm.cu`` at every
DiT-XL/2 product shape, in one process on one card.

    git show 11d7ad3:src/repro_torch/kernels/gemm.cu > build/ab/gemm_pr17.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.gemm_ab build/ab/gemm_pr17.cu

The baseline's C entry point is ``linear_f32(x, w, b, y, M, N, K,
stream)`` (one kernel for every product).  Both sources are built in
parallel.  At B = 1, 2 and 4 requests under CFG (token products over
M = 2·256·B rows, request-row products over M = 2B), each kernel is first
held against the plain version (max |err| <= 5e-5 of max |plain|), then
timed with both methods of ``kernels.timing`` in the order baseline,
current, current, baseline, with cuBLAS (``addmm`` / ``mm``, TF32 off)
beside them.  Prints the card's name and power limit, then one JSON line:
every reading, the ratios of the means, and each bucket's forward (the
shapes summed by their calls per forward).

    PYTHONPATH=src python3 -m repro_torch.kernels.gemm_ab --tiles

times the token kernel's candidate tile widths instead (a build with
``-DGEMM_ALL_TILES``) at M = 512, 1024 and 2048 for each token shape
(``device_ms``), checks each against the plain version and reports how far
its bits are from the first candidate's.

    PYTHONPATH=src python3 -m repro_torch.kernels.gemm_ab --tiles --model audio

does the same at Stable-Audio-Open's token shapes for 1, 2 and 4 requests
under CFG (2·216·B token rows, 2·128·B memory rows for the cross k/v), and
sums each width over one forward per bucket.
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
from repro_torch.kernels import gemm, ref, timing

D, FF, TOK, TOK_DIM, T_DIM, BLOCKS = 1152, 4608, 256, 16, 256, 28
# (name, K, N, rows, bias, calls per forward) of every DiT-XL/2 product
SHAPES = [("patch", TOK_DIM, D, "tokens", True, 1),
          ("time_mlp_1", T_DIM, D, "requests", True, 1),
          ("time_mlp_2", D, D, "requests", True, 1),
          ("adaln", D, 6 * D, "requests", True, BLOCKS),
          ("qkvo", D, D, "tokens", False, 4 * BLOCKS),
          ("mlp_up", D, FF, "tokens", False, BLOCKS),
          ("mlp_down", FF, D, "tokens", False, BLOCKS),
          ("final_mod", D, 2 * D, "requests", True, 1),
          ("out", D, TOK_DIM, "tokens", True, 1)]
# Stable-Audio-Open's token products: (name, K, N, rows per request under
# CFG, calls per forward) — 24 blocks of self-attention q/k/v/o,
# cross-attention q/o over the tokens and k/v over a 128-token memory,
# and a gated MLP
A_D, A_FF, A_TOK, A_MEM, A_CH, A_BLOCKS = 1536, 6144, 216, 128, 64, 24
AUDIO_SHAPES = [("patch", A_CH, A_D, 2 * A_TOK, 1),
                ("qkvo", A_D, A_D, 2 * A_TOK, 6 * A_BLOCKS),
                ("cross_kv", 768, A_D, 2 * A_MEM, 2 * A_BLOCKS),
                ("mlp_up_gate", A_D, A_FF, 2 * A_TOK, 2 * A_BLOCKS),
                ("mlp_down", A_FF, A_D, 2 * A_TOK, A_BLOCKS),
                ("out", A_D, A_CH, 2 * A_TOK, 1)]
BUCKETS = (1, 2, 4)
METHODS = ("per_call_ms", "device_ms")
LIMIT = 5e-5
CANDIDATES = (16, 64, 96, 128, 144, 192, 256)


def rows_of(rows: str, bucket: int) -> int:
    return 2 * bucket * (TOK if rows == "tokens" else 1)


def inputs(m, k, n, bias, gen):
    x = torch.randn(m, k, generator=gen).cuda()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).cuda()
    b = torch.randn(n, generator=gen).cuda() if bias else None
    return x, w, b


def _baseline(path: str):
    """A call of the baseline library at path, as its wrapper made it."""
    fwd = ctypes.CDLL(path).linear_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd.argtypes = [p, p, p, p, i, i, i, p]
    fwd.restype = i

    def call(x, w, b, rows):
        m, k = x.shape
        n = w.shape[1]
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        rc = fwd(x.data_ptr(), w.data_ptr(),
                 None if b is None else b.data_ptr(), y.data_ptr(), m, n, k,
                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: cudaError {rc}")
        return y

    return call


def _current(x, w, b, rows):
    return gemm.linear_cuda(x, w, b, rows=rows)


def _cublas(x, w, b, rows):
    return torch.mm(x, w) if b is None else torch.addmm(b, x, w)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def compare(kernels: dict, gen: torch.Generator) -> dict:
    out = {}
    for bucket in BUCKETS:
        cases, forward = [], {}
        for name, k, n, rows, bias, calls in SHAPES:
            m = rows_of(rows, bucket)
            x, w, b = inputs(m, k, n, bias, gen)
            want = ref.linear_ref(x, w, b)
            row = {"shape": name, "m": m, "k": k, "n": n, "rows": rows,
                   "calls": calls}
            for kname, fn in kernels.items():
                err = _rel(fn(x, w, b, rows), want)
                if err > LIMIT:
                    raise RuntimeError(f"{kname} vs plain at {row}: {err}")
                row[kname] = {"rel_max_err": err, **{t: [] for t in METHODS}}
            for kname in ("baseline", "current", "current", "baseline"):
                for t in METHODS:
                    row[kname][t].append(getattr(timing, t)(
                        lambda fn=kernels[kname]: fn(x, w, b, rows)))
            row["cublas"] = {t: getattr(timing, t)(
                lambda: _cublas(x, w, b, rows)) for t in METHODS}
            mean = {kn: {t: statistics.mean(row[kn][t]) for t in METHODS}
                    for kn in kernels}
            row["baseline_over_current"] = {
                t: mean["baseline"][t] / mean["current"][t] for t in METHODS}
            row["current_over_cublas"] = {
                t: mean["current"][t] / row["cublas"][t] for t in METHODS}
            for kn in ("baseline", "current"):
                for t in METHODS:
                    forward.setdefault(f"{kn}_{t}", 0.0)
                    forward[f"{kn}_{t}"] += calls * mean[kn][t]
            for t in METHODS:
                forward.setdefault(f"cublas_{t}", 0.0)
                forward[f"cublas_{t}"] += calls * row["cublas"][t]
            cases.append(row)
            gemm.release()
        out[str(bucket)] = {"cases": cases, "forward": forward}
    return out


def _tile_row(lib, name, m, k, n, bias, widths, gen):
    """Each width's device ms at one product, its error against the plain
    version and its distance from the first width's bits."""
    x, w, b = inputs(m, k, n, bias, gen)
    p = gemm.prepare(w)
    want = ref.linear_ref(x, w, b)
    first, row = None, {"shape": name, "m": m, "k": k, "n": n}

    def call(bn):
        y = torch.empty(m, n, device="cuda")
        rc = lib.linear_tokens_f32(
            x.data_ptr(), p.big_t.data_ptr(), p.small_t.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), m, n,
            k, bn, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(lib.linear_error_string(rc).decode())
        return y

    for bn in widths:
        y = call(bn)
        first = y if first is None else first
        row[str(bn)] = {
            "ms": timing.device_ms(lambda: call(bn)),
            "rel_max_err": _rel(y, want),
            "max_abs_vs_first": float((y - first).abs().max()),
            "stages": gemm.token_stages(bn),
            "tiles": -(-m // gemm.TOKEN_BM) * -(-n // bn)}
        if row[str(bn)]["rel_max_err"] > LIMIT:
            raise RuntimeError(f"tile {bn} vs plain at {row}")
    gemm.release()
    return row


def tiles(gen: torch.Generator) -> dict:
    lib = gemm.bind(gemm.build(("-DGEMM_ALL_TILES",))["path"])
    out = []
    for name, k, n, rows, bias, _ in SHAPES:
        if rows != "tokens":
            continue
        widths = [bn for bn in CANDIDATES
                  if n % bn == 0 and (bn >= 64 or n < 64)]
        for m in (512, 1024, 2048):
            out.append(_tile_row(lib, name, m, k, n, bias, widths, gen))
    return {"tiles": out}


def audio_tiles(gen: torch.Generator) -> dict:
    """Every candidate width no wider than N (144 leaves a ragged last
    tile on N = 1536 and 6144, kept for comparison) at each audio token
    shape for buckets 1, 2 and 4, and each width's sum over one forward
    (its calls per forward times its ms) with the width that wins it."""
    lib = gemm.bind(gemm.build(("-DGEMM_ALL_TILES",))["path"])
    out, forward = [], {}
    for bucket in BUCKETS:
        for name, k, n, per_request, calls in AUDIO_SHAPES:
            widths = [bn for bn in CANDIDATES if bn <= n]
            row = _tile_row(lib, name, per_request * bucket, k, n,
                            name in ("patch", "out"), widths, gen)
            row.update(bucket=bucket, calls=calls,
                       best=min(widths, key=lambda bn: row[str(bn)]["ms"]))
            out.append(row)
            f = forward.setdefault(f"{k}x{n}", {})
            for bn in widths:
                f.setdefault(str(bn), {})[str(bucket)] = (
                    calls * row[str(bn)]["ms"])
    return {"tiles": out, "forward_ms": forward}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", help="the earlier gemm.cu")
    ap.add_argument("--tiles", action="store_true",
                    help="time the token kernel's candidate tile widths")
    ap.add_argument("--model", choices=("dit", "audio"), default="dit",
                    help="whose token shapes --tiles times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab needs a CUDA card")
    if not args.tiles and args.baseline is None:
        ap.error("give the earlier gemm.cu, or --tiles")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(0)
    result = {"card": card}
    if args.tiles:
        result.update(tiles(gen) if args.model == "dit"
                      else audio_tiles(gen))
    else:
        with ThreadPoolExecutor(2) as pool:
            base = pool.submit(_build.build, "gemm_baseline",
                               Path(args.baseline).resolve())
            current = pool.submit(gemm.build)
            base_path = base.result()["path"]
            current.result()
        result["order"] = ["baseline", "current", "current", "baseline"]
        result["buckets"] = compare(
            {"baseline": _baseline(base_path), "current": _current}, gen)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
