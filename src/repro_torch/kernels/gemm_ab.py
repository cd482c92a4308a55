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
sums each width over one forward per bucket.  ``--model qwen3`` times
Qwen3-14B's products (8 blocks) at M = 4096 (a prefill of 4 × 1024 tokens)
and M = 4 (a decode step of 4 sequences), and sums each width over one
``generate`` of 32 tokens: one prefill and 31 decode steps.
``--model gemma2`` does the same for Gemma-2-9B's (12 blocks; M = 8704,
2 × 4352 tokens, and M = 2) and ``--model minicpm3`` for MiniCPM3-4B's
(16 of 62 blocks, as ``chip_smoke.py`` runs it since the deepseek3
phase; M = 4096 and 4; kv_b in the prefill only).  Each (K, N) also
names the width its plan takes now and the built width (``gemm.TOKEN_BN``)
that wins the sum.

    PYTHONPATH=src python3 -m repro_torch.kernels.gemm_ab --tiles \
        --model minicpm3 --generate

then runs whole ``generate`` calls of that model (random weights drawn on
the card, 32 new tokens, greedy) with the planned widths (``base``) and
with every product at its sum's winning built width (``tiles``), in the
order base, tiles, tiles, base, base, tiles: the prefill's seconds and a
decode step's ms on the host's clock, whether the tokens agree, and the
widths tried.  A width goes into ``gemm.TOKEN_CHOICE`` only where the
whole generate gains, not its device time alone.

    git show <commit>:src/repro_torch/kernels/gemm.cu > build/ab/gemm_base.cu
    PYTHONPATH=src python3 -m repro_torch.kernels.gemm_ab --accuracy build/ab/gemm_base.cu

holds the token kernel's accumulation against an earlier ``gemm.cu`` with
the same C entry points (``linear_tokens_f32``), both built with
``-DGEMM_ALL_TILES``: the error against an f64 product at K = 1152 …
17408, the resources ``cuobjdump`` reports per instance, and the device ms
of each model's forward token products at its planned widths, timed in
turns (baseline, current, current, baseline).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.kernels import build as _build
from repro_torch.kernels import gemm, products, ref, timing

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
# Qwen3-14B at 8 of its 40 blocks: the prefill's rows (4 × 1024 tokens),
# a decode step's (4 sequences) and the decode steps of one generate
Q_BLOCKS, Q_PREFILL, Q_DECODE, Q_STEPS = 8, 4 * 1024, 4, 31
# the attention LMs' generates as chip_smoke.py runs them: (config, blocks,
# prefill rows, decode rows), each with Q_STEPS decode steps
# (tests/test_torch_mla.py holds them to chip_smoke.py's constants)
LM_TILES = {"qwen3": ("qwen3-14b", Q_BLOCKS, Q_PREFILL, Q_DECODE),
            "gemma2": ("gemma2-9b", 12, 2 * 4352, 2),
            "minicpm3": ("minicpm3-4b", 16, 4 * 1024, 4)}
# OpenSora-v1.2's text memory, in tokens
V_MEM = 300
K_SWEEP = (1152, 1536, 4608, 6144, 17408)
BUCKETS = (1, 2, 4)
METHODS = ("per_call_ms", "device_ms")
LIMIT = 5e-5
CANDIDATES = (16, 64, 96, 128, 144, 192, 256)


def forwards() -> dict:
    """Each model's forward token products as (M, K, N, bias, calls), from
    its config: DiT-XL/2 at 4 requests, OpenSora and Stable-Audio-Open at
    1 (under CFG), Qwen3-14B's prefill."""
    def tokens(cfg, batch, mem_len=0):
        return [(m, k, n, bias, calls) for m, k, n, bias, calls, rows
                in products.gemms(cfg, batch, mem_len) if rows == "tokens"]

    return {"dit": tokens(configs.get("dit-xl-256"), 8),
            "video": tokens(configs.get("opensora-v12"), 2, V_MEM),
            "audio": tokens(configs.get("stable-audio-open"), 2, A_MEM),
            "qwen3": [(m, k, n, False, calls) for _, m, k, n, calls
                      in products.lm_products(qwen3_config(), Q_PREFILL)]}


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


def _tokens(lib, x, w, b, bn):
    """The token kernel of library ``lib`` at tile width bn over w's
    prepared halves."""
    (m, k), n = x.shape, w.shape[1]
    p = gemm.prepare(w)
    y = torch.empty(m, n, device="cuda")
    rc = lib.linear_tokens_f32(
        x.data_ptr(), p.big_t.data_ptr(), p.small_t.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), m, n, k, bn,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.linear_error_string(rc).decode())
    return y


def _tile_row(lib, name, m, k, n, bias, widths, gen):
    """Each width's device ms at one product, its error against the plain
    version and its distance from the first width's bits."""
    x, w, b = inputs(m, k, n, bias, gen)
    want = ref.linear_ref(x, w, b)
    first, row = None, {"shape": name, "m": m, "k": k, "n": n}

    def call(bn):
        return _tokens(lib, x, w, b, bn)

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


def lm_tiles(model: str, gen: torch.Generator) -> dict:
    """Every built width that divides N at each product of an attention
    LM (``LM_TILES[model]``), at the prefill's and a decode step's rows,
    and each width's sum over one generate (prefill calls × prefill ms +
    ``Q_STEPS`` × decode calls × decode ms) with the width that wins it,
    the built width (``gemm.TOKEN_BN``) that wins it and the planned
    one."""
    name, blocks, prefill_rows, decode_rows = LM_TILES[model]
    cfg = products.lm_cut(configs.get(name), blocks)
    lib = gemm.bind(gemm.build(("-DGEMM_ALL_TILES",))["path"])
    out, generate = [], {}
    calls = {phase: {(k, n): c for _, _, k, n, c in products.lm_products(
        cfg, 1, decode=phase == "decode")} for phase in ("prefill", "decode")}
    for shape, _, k, n, _ in products.lm_products(cfg, 1):
        widths = [bn for bn in CANDIDATES if n % bn == 0]
        ms = {}
        for phase, m in (("prefill", prefill_rows), ("decode", decode_rows)):
            c = calls[phase].get((k, n), 0)
            row = _tile_row(lib, shape, m, k, n, False, widths, gen)
            row.update(phase=phase, calls=c)
            out.append(row)
            ms[phase] = {bn: c * row[str(bn)]["ms"] for bn in widths}
        total = {bn: ms["prefill"][bn] + Q_STEPS * ms["decode"][bn]
                 for bn in widths}
        built = [bn for bn in widths if bn in gemm.TOKEN_BN]
        generate[f"{k}x{n}"] = {
            "ms": {str(bn): v for bn, v in total.items()},
            "prefill_ms": {str(bn): v for bn, v in ms["prefill"].items()},
            "decode_step_ms": {str(bn): v for bn, v in ms["decode"].items()},
            "best": min(widths, key=total.get),
            "best_built": min(built, key=total.get) if built else None,
            "planned": gemm.plan(k, n)["tile"][1]}
    return {"model": name, "blocks": blocks, "tiles": out,
            "generate": generate}


def lm_generate_ab(model: str, sums: dict) -> dict:
    """Whole generates of ``LM_TILES[model]``'s cut, 32 new tokens, greedy,
    with the planned widths and with the winning built widths of ``sums``
    (:func:`lm_tiles`' ``generate``), in turns (see the module's doc)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    name, blocks, prefill_rows, decode_rows = LM_TILES[model]
    cfg = products.lm_cut(configs.get(name), blocks)
    plen = prefill_rows // decode_rows
    new = Q_STEPS + 1
    tiles = {tuple(map(int, kn.split("x"))): g["best_built"]
             for kn, g in sums.items()
             if g["best_built"] not in (None, g["planned"])}
    params = serve.init_params(torch.Generator(device="cuda").manual_seed(7),
                               cfg, device="cuda")
    T.prepare_linear(params)
    prompts = torch.randint(0, cfg.vocab_size, (decode_rows, plen),
                            generator=torch.Generator().manual_seed(3))
    marks = {}

    def mark(phase):
        torch.cuda.synchronize()
        marks[phase] = time.perf_counter()

    # a cold generate first: the first call of each routine stays out.
    # The decode steps are launched from the host (graphs=False): a
    # captured decode graph keeps the widths planned at its capture
    serve.generate(cfg, params, prompts.cuda(), 2, cache_len=plen + new,
                   on_phase=mark, graphs=False)
    runs, tokens = {"base": [], "tiles": []}, {}
    try:
        for which in ("base", "tiles", "tiles", "base", "base", "tiles"):
            with gemm.token_widths(tiles if which == "tiles" else {}):
                mark("start")
                toks = serve.generate(cfg, params, prompts.cuda(), new,
                                      cache_len=plen + new, on_phase=mark,
                                      graphs=False)
            runs[which].append({
                "prefill_s": marks["prefill"] - marks["start"],
                "decode_ms": 1e3 * (marks["decode"] - marks["prefill"])
                / (new - 1)})
            tokens.setdefault(which, toks)
    finally:
        gemm.release()
    mean = {which: {k: statistics.mean(r[k] for r in rs)
                    for k in ("prefill_s", "decode_ms")}
            for which, rs in runs.items()}
    return {"widths": {f"{k}x{n}": bn for (k, n), bn in tiles.items()},
            "order": ["base", "tiles", "tiles", "base", "base", "tiles"],
            "runs": runs, "mean": mean,
            "same_tokens": bool(torch.equal(tokens["base"],
                                            tokens["tiles"]))}


def qwen3_config():
    """Qwen3-14B at its published widths, ``Q_BLOCKS`` blocks deep."""
    return products.lm_cut(configs.get("qwen3-14b"), Q_BLOCKS)


def _resources(path: str) -> dict:
    """Registers, stack and local memory of each token-kernel instance in
    the library at path (``cuobjdump -res-usage``)."""
    import re
    import subprocess
    from torch.utils.cpp_extension import CUDA_HOME
    res = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                          "-res-usage", path], capture_output=True,
                         text=True, check=True).stdout
    return {name: {k.lower(): int(v) for k, v in re.findall(
        r"(REG|STACK|LOCAL):(\d+)", usage)}
        for name, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                      res) if "gemm_tokens" in name}


def accuracy(baseline: str, gen: torch.Generator) -> dict:
    """The token kernel of an earlier source (``baseline``) against this
    one: error against f64 per K, resources per instance, and each model's
    forward token products in ms."""
    flags = ("-DGEMM_ALL_TILES",)
    with ThreadPoolExecutor(2) as pool:
        builds = {"baseline": pool.submit(
            _build.build, "gemm_accum_baseline", Path(baseline).resolve(),
            flags), "current": pool.submit(gemm.build, flags)}
        paths = {name: f.result()["path"] for name, f in builds.items()}
    libs = {name: gemm.bind(path) for name, path in paths.items()}
    result = {"resources": {name: _resources(path)
                            for name, path in paths.items()}}

    # one product of 512 rows and 1024 columns per K: max |y - exact| over
    # max |exact|, exact the f64 product; every library at width 128 (the
    # k order does not depend on the width), cuBLAS f32 beside them
    errs = {}
    for k in K_SWEEP:
        x, w, _ = inputs(512, k, 1024, False, gen)
        exact = x.double() @ w.double()
        scale = float(exact.abs().max())
        row = {name: float((_tokens(lib, x, w, None, 128) - exact).abs()
                           .max()) / scale for name, lib in libs.items()}
        row["cublas"] = float((torch.mm(x, w) - exact).abs().max()) / scale
        errs[str(k)] = row
        gemm.release()
    result["rel_err_vs_f64"] = errs

    order = ["baseline", "current", "current", "baseline"]
    result["forwards"] = {}
    for model, shapes in forwards().items():
        total = {name: 0.0 for name in libs}
        for m, k, n, bias, calls in shapes:
            x, w, b = inputs(m, k, n, bias, gen)
            bn = gemm.plan(k, n)["tile"][1]
            ms = {name: [] for name in libs}
            for name in order:
                ms[name].append(timing.device_ms(
                    lambda lib=libs[name]: _tokens(lib, x, w, b, bn),
                    iters=10, reps=3, warmup=2))
            for name in libs:
                total[name] += calls * statistics.mean(ms[name])
            gemm.release()
        result["forwards"][model] = {
            "ms": total, "current_over_baseline":
            total["current"] / total["baseline"]}
    result["order"] = order
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", help="the earlier gemm.cu")
    ap.add_argument("--tiles", action="store_true",
                    help="time the token kernel's candidate tile widths")
    ap.add_argument("--model", choices=("dit", "audio", *LM_TILES),
                    default="dit", help="whose token shapes --tiles times")
    ap.add_argument("--generate", action="store_true",
                    help="with --tiles and an LM --model: whole generates "
                         "at the planned and the winning widths")
    ap.add_argument("--accuracy", metavar="BASELINE",
                    help="an earlier gemm.cu with linear_tokens_f32: hold "
                         "the token kernel's accumulation against it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab needs a CUDA card")
    if not (args.tiles or args.accuracy) and args.baseline is None:
        ap.error("give the earlier gemm.cu, --tiles or --accuracy")
    if args.generate and not (args.tiles and args.model in LM_TILES):
        ap.error(f"--generate goes with --tiles --model {sorted(LM_TILES)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(0)
    result = {"card": card}
    if args.accuracy:
        result.update(accuracy(args.accuracy, gen))
    elif args.tiles:
        if args.model in LM_TILES:
            result.update(lm_tiles(args.model, gen))
            if args.generate:
                result["generate_ab"] = lm_generate_ab(args.model,
                                                       result["generate"])
        else:
            result.update({"dit": tiles, "audio": audio_tiles}[args.model](
                gen))
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
