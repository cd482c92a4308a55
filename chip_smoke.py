"""Drive the PyTorch port (``src/repro_torch``) once on one CUDA card and
check every phase.  Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build of the three CUDA sources (flash attention, SSD scan, the
   batch-invariant linear layer's two kernels) and of the CUDA graph
   IF-node helper (``core/cuda_graphs.cu``) from the checkout's sources,
   in parallel, and the kernels' SASS: tensor-core instructions
   (``mma.sync`` HMMA, ``wgmma`` HGMMA), FFMA, registers and local memory
   per flash-attention template instance, per SSD pass and per linear
   kernel (``cuobjdump``);
3. the flash-attention kernel against its plain PyTorch version over the
   kernel test sweep (each case with its arithmetic and load path) and at
   the DiT-XL/2 shape, where two launches must agree bitwise, with device
   times (``repro_torch.kernels.timing``) in f32 and bf16 beside SDPA's;
4. the SSD-scan kernel against its plain PyTorch version over the kernel
   test sweep (f32 and bf16), at the Mamba-2-1.3B prefill shape (where two
   launches must agree bitwise), at a ragged length and on strided views
   of one projection as the model hands them over, with times; then the
   linear kernels (``gemm``: the token rows' 3xTF32 ``wgmma`` kernel, the
   request rows' FFMA kernel) against their plain version (cuBLAS f32,
   TF32 off) at every DiT-XL/2 product shape for buckets 1–8 under CFG
   (≤ 5e-5 of the output's scale), each row bitwise against products of
   fewer and of permuted rows in both variants, a captured launch against
   an eager one in both, a capture without a prepared weight raising, and
   the device times of one B = 8 forward's products beside their bound
   and cuBLAS's;
5. a full-width DiT-XL/2 denoiser forward on the card (kernel attention)
   against the same forward on the CPU (plain attention), then a
   ``torch.profiler`` trace of one forward at B = 8: device time by
   kernel, the attention and linear kernels' shares (every product of the
   forward through the linear kernels: 201 calls, 31 of them request
   rows, no library GEMM), the device's idle share;
6. the DiT slice: full-width DiT-XL/2, DDIM 50, cfg_scale 1.5 — calibrate
   on 10 samples, save the artifact, load it strictly into a fresh pipeline
   and answer 4 requests with no cache, the artifact's SmoothCache schedule
   and ``static:n=2``; every latent finite, kernel launches = 28 × attention
   steps computed, linear launches = 5 + 28 × (1 + 4 per computed
   attention + 2 per computed MLP) per step, segmented ≡ eager bitwise;
   the q/k/v that the model's
   attention makes take 3xTF32 with ``cp.async`` loads;
7. a full-width Mamba-2-1.3B prefill of one 200-token prompt on the card
   (kernel scan) against the same prefill on the CPU (plain scan): logits
   and final states;
8. the LM slice: ``launch.serve.generate`` on 4 prompts × 1024 tokens, 32
   new tokens, greedy — 48 SSD launches in the prefill and none in the
   decode loop; then a card forward over prompt + the first 31 new tokens
   whose logits must match the recurrent decode step's;
9. a ``torch.profiler`` trace of one prefill and of 4 decode steps: device
   time by kernel, the SSD passes' time, and the device's idle share of the
   wall time;
10. the serving stack (``repro_torch.serve``), after the DiT slice on its
   weights: a ``ServeEngine`` over four store entries (``no_cache``, the
   slice's SmoothCache artifact, ``static:n=2`` and an adaptive artifact
   calibrated on 10 samples and loaded through JSON) drains 16 requests, 4
   per entry, arriving at once (``max_batch`` 4, 2 in flight,
   ``interleave``).  One line per entry (batches, wall, queue wait and
   service p50/p95, images/s, realized compute fraction, attention
   launches = 28 × computed attention steps, host syncs) and a summary
   (model variants within the program budget; the idle share of a second,
   traced drain, whose attention kernels, counted in its device trace,
   must be 28 × its computed attention steps).  One served batch per
   entry replayed through
   ``DiffusionPipeline.generate`` must match bitwise, and the adaptive
   batch replayed at τ = 0 on its own realized decisions gives the per-step
   cost of the host loop's decision sync.  The adaptive entry rides the
   fused path: its graph replays launch the attention kernel without a
   Python call, so its check counts each new graph's warm-up and captured
   calls (28 per attention-computing branch); it makes no decision
   sync;
11. the fused adaptive path (``fused``, ~20 s): the serve phase's adaptive
   artifact, 4 requests (B = 8 in the kernel) — capture seconds, graph
   count and device memory around the capture (warm-up and captured
   attention calls counted from 0), the run state's copy into the
   graph's buffers and out (CUDA events); fused ≡ host loop
   (decisions and latents, bitwise) with the replays under
   ``torch.cuda.set_sync_debug_mode("error")`` and ``host_sync_count`` 0;
   τ = 0 fused ≡ ``sample_compiled``; chunks of 4 ≡ one call; a graph
   first captured for a run split at its last step (finite, and a repeat
   on the built graph bitwise); the fused batch's and the host loop's
   walls in the order A B B A; the idle share of one traced fused batch,
   whose attention kernels, counted in the trace, must be 28 × its
   computed attention steps;
12. continuous batching (``continuous``, ~25 s): the SmoothCache artifact,
   ``static:n=2`` and the adaptive artifact, ``max_batch`` 4, 2 in flight,
   ``adaptive_chunk`` 4, a wall clock, 2 requests per entry at t = 0 and 2
   more at t ≈ 0.3 s; with and without ``continuous=True``: joins, merges,
   regroups, coalesces, variants against the budget, images/s, queue wait
   and service p50/p95 (joins ≥ 1, merges ≥ 1, variants within the budget
   are checked); every served request against its own solo ``generate``
   (B = 1): the max abs difference per row, which must be 0 (bitwise),
   beside the row stability across batch shapes of the products (the
   linear kernel: 0; cuBLAS for the record) and of the served path's row
   reductions (the proxy's ``row_sums``, layernorm, gelu: 0; the plain
   ``sum`` the proxy replaced, for the record);
13. the SLO layer (``slo``, ~40 s): a τ ladder [0, 0.05, 0.3] of the
   adaptive artifact behind ``ElasticPolicy`` and ``AdmissionController``,
   26 requests of an ``overload_trace`` on a wall clock (1 / s, 4 / s,
   1 / s; strict and bulk classes): controller changes, sheds by reason,
   deferrals, attainment, goodput, p95 wait, realized τ; checked: ≥ 1
   rung change, one graph per served (bucket, τ > 0) pair, a hand-made
   move between the τ > 0 rungs capturing nothing, variants within the
   budget, every request served or shed with a reason, every served batch
   bitwise its ``generate`` at its rung's τ;
14. fault recovery (``resilience``, ~60 s): the SmoothCache and adaptive
   artifacts under ``ResiliencePolicy(watchdog_factor=4.0,
   watchdog_floor_s=0.5)``, the chaos harness writing real NaNs that only
   the executor's sentinels see — clean drains with resilience off and on
   (A B B A) bitwise equal; a fixed plan (NaN rows in a fused adaptive
   and a static batch, an injected fault, a stall past the watchdog's
   deadline) served in full, its static survivors bitwise their clean
   rows, every unsplit record bitwise its ``generate``; a seeded ramp at
   rate 0.3 with every request resolved;
15. step telemetry (``telemetry``, ~15 s): a fused batch with the proxy
   trace on and off bitwise under the sync guard, its reports realizing
   the host loop's decisions; a traced telemetry drain bitwise the plain
   one, a report per request, a valid trace;
16. durable serving (``durable``, ~60 s): the SmoothCache and adaptive
   artifacts, ``max_batch`` 2, 2 in flight, ``adaptive_chunk`` 4, the
   fused advances under the sync guard, snapshots in a temporary
   directory with at least 4 GB free — 8 requests with durability off,
   on, on, off at ``checkpoint_every=1`` and on / off at 4 (walls,
   overhead, bytes per snapshot and seconds of its device→host copy,
   sha256 and write per run kind, journal fsyncs); a kill with a static
   and a fused batch in flight restored by a fresh engine on a fresh
   executor bitwise the uninterrupted rows; a torn and a drifted snapshot
   quarantined with reasons and replayed bitwise; a seeded kill ramp
   (``KillPlan(seed=0, kill_rate=0.3, max_kills=4)``) losing nothing,
   every row bitwise, device memory at each restart not growing.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
The weights are random (seeded); depth and widths are DiT-XL/2's and
Mamba-2-1.3B's.
"""
import gc
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
REQUEST_LABELS = [207, 360, 387, 974]
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 32
# Published peaks per card (NVIDIA H100 data sheet: FP32 outside the tensor
# cores, dense TF32 and BF16 on the tensor cores where cited, HBM
# bandwidth), keyed by the name nvidia-smi reports.
PEAKS = {"H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12,      # SXM5
                            "bf16": 989e12, "hbm": 3.35e12},
         "H100 PCIe": {"fp32": 51e12, "hbm": 2.0e12},
         "H100 NVL": {"fp32": 60e12, "hbm": 3.9e12}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    name, power = (s.strip() for s in line.split(",", 1))
    emit({"card": name, "power_limit": power})
    peaks = [v for k, v in PEAKS.items() if k in name]
    check(len(peaks) == 1, f"no published peaks on file for {name!r}")
    return peaks[0]


def kernel_phase(fa, ref, peaks):
    """Kernel vs plain over the sweep and at the DiT-XL/2 shape, where two
    launches must agree bitwise; device times (``kernels.timing``) at the
    DiT-XL/2 shape, in f32 and in bf16, beside SDPA's."""
    import torch.nn.functional as F
    from repro_torch.kernels.timing import device_ms
    gen = torch.Generator().manual_seed(SEED)

    def qkv(b, l, h, kv, d, dtype, offset=0):
        """Seeded q, k, v; ``offset`` > 0 views each from ``offset``
        elements into a wider row, so no row is 16 B-aligned."""
        return [torch.randn(shape[:-1] + (d + offset,), generator=gen)
                .to("cuda", dtype)[..., offset:]
                for shape in ((b, l, h, d), (b, l, kv, d), (b, l, kv, d))]

    sweep = []
    # (shape, causal, window, softcap, row offset)
    cases = ([((2, 64, 4, 4, 32), True, None, None, 0),
              ((2, 64, 4, 1, 32), True, None, None, 0),
              ((1, 96, 8, 2, 64), True, None, None, 0),
              ((1, 128, 16, 8, 64), True, None, None, 0),
              ((2, 40, 4, 2, 16), True, None, None, 0)]
             + [((2, 64, 4, 2, 32),) + m + (0,) for m in (
                 (True, 16, None), (True, None, 50.0), (False, None, None),
                 (True, 8, 30.0))]
             + [((2, 256, 4, 4, 72), False, None, None, 0),
                ((1, 128, 4, 2, 128), True, None, None, 0),
                ((2, 64, 4, 2, 20), True, None, None, 0),
                ((2, 64, 4, 2, 32), True, None, None, 1)])
    for shape, causal, window, softcap, offset in cases:
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 5e-2)):
            q, k, v = qkv(*shape, dtype, offset)
            kw = dict(causal=causal, window=window, softcap=softcap)
            out = fa.flash_attention_cuda(q, k, v, **kw).float()
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            ok = bool(torch.allclose(out, want, atol=tol, rtol=tol))
            sweep.append({"shape": shape, "causal": causal, "window": window,
                          "softcap": softcap, "dtype": str(dtype)[6:],
                          "offset": offset, **fa.plan(q, k, v),
                          "max_abs_err": err, "ok": ok})
            check(ok, f"kernel vs plain {sweep[-1]}")
            if offset:
                check(sweep[-1]["load"] == "scalar",
                      f"unaligned rows took {sweep[-1]['load']}")
    emit({"sweep": sweep})

    b, l, h, d = 8, 256, 16, 72          # DiT-XL/2: 2 x 4 requests under CFG
    q, k, v = qkv(b, l, h, h, d, torch.float32)
    out = fa.flash_attention_cuda(q, k, v, causal=False)
    again = fa.flash_attention_cuda(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
          f"kernel vs plain at the DiT-XL/2 shape: max abs err {err}")
    check(bool(torch.equal(out, again)),
          "two launches at the DiT-XL/2 shape differ")
    ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=False))
    plain_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                         causal=False))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    _, lib_kernels = _traced(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4 * b * h * l * l * d
    nbytes = 4 * q.numel() * q.element_size()
    # f32 runs as three TF32 products on the tensor cores (3xTF32)
    t_ops = (3 * flops / peaks["tf32"] * 1e3 if "tf32" in peaks else None)
    t_bytes = nbytes / peaks["hbm"] * 1e3

    # the same shape in bf16, against SDPA in bf16
    qb, kb, vb = (a.bfloat16() for a in (q, k, v))
    out = fa.flash_attention_cuda(qb, kb, vb, causal=False)
    want = ref.flash_attention_ref(qb, kb, vb, causal=False)
    bf16_err = float((out.float() - want.float()).abs().max())
    check(bool(torch.allclose(out.float(), want.float(), atol=5e-2,
                              rtol=5e-2)),
          f"bf16 kernel vs plain at the DiT-XL/2 shape: max abs err "
          f"{bf16_err}")
    bf16_ms = device_ms(lambda: fa.flash_attention_cuda(qb, kb, vb,
                                                        causal=False))
    bf16_plain_ms = device_ms(lambda: ref.flash_attention_ref(qb, kb, vb,
                                                              causal=False))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (qb, kb, vb))
    bf16_library_ms = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bf16_bound = (max(flops / peaks["bf16"], nbytes / 2 / peaks["hbm"]) * 1e3
                  if "bf16" in peaks else None)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "shape": [b, l, h, h, d], "dtype": "float32", "causal": False,
            **fa.plan(q, k, v),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": None if t_ops is None else max(t_ops, t_bytes),
            "bound_by": (None if t_ops is None else
                         "operations" if t_ops >= t_bytes else "bytes"),
            "bound_simt_ms": flops / peaks["fp32"] * 1e3,
            "library_ms": library_ms,
            "library_kernel": max(lib_kernels, key=lambda k:
                                  lib_kernels[k][0])[:90],
            "flops": flops, "bytes": nbytes,
            "bf16": {**fa.plan(qb, kb, vb), "max_abs_err": bf16_err,
                     "ms": bf16_ms, "plain_ms": bf16_plain_ms,
                     "library_ms": bf16_library_ms, "bound_ms": bf16_bound}}


# name fragments of the kernels in each library's SASS; every one of them
# runs a product on the tensor cores but the request-row linear kernel,
# which is bound by bytes and runs f32 FMAs
SASS_KERNELS = {"flash_attention": ("attn_fwd",),
                "ssd": ("ssd_cb", "ssd_state", "ssd_out"),
                "gemm": ("gemm_tokens_wgmma", "gemm_requests_ffma")}
FFMA_KERNELS = ("gemm_requests_ffma",)
# the port's linear kernels, as a profiler trace names them
LINEAR_KERNELS = {"tokens": "gemm_tokens_wgmma",
                  "requests": "gemm_requests_ffma"}


def sass_phase(libs):
    """What the compiler made of each CUDA library: per kernel (template
    instance or SSD pass), tensor-core instructions — ``mma.sync`` (HMMA)
    and ``wgmma`` (HGMMA) — and f32 FMAs (FFMA) in the SASS, and
    registers, stack and local memory from the resource usage.  Every
    kernel needs tensor-core instructions but those of ``FFMA_KERNELS``,
    which need FFMA; the token linear kernel needs HGMMA."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    out = {}
    for lib, names in SASS_KERNELS.items():
        path = libs[lib]
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        res = subprocess.run([tool, "-res-usage", path], capture_output=True,
                             text=True, check=True).stdout
        rows = {}
        for part in sass.split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            if any(k in name for k in names):
                rows[name] = {"hmma": part.count("HMMA"),
                              "hgmma": part.count("HGMMA"),
                              "ffma": len(re.findall(r"\bFFMA\b", part))}
        for name, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                      res):
            if name in rows:
                rows[name].update({k.lower(): int(v) for k, v in re.findall(
                    r"(REG|STACK|SHARED|LOCAL):(\d+)", usage)})
        emit({"phase": "sass", "kernel": lib, "instances": rows})
        check(all(any(k in name for name in rows) for k in names),
              f"{lib}: a kernel of {names} missing from the SASS")
        for name, r in rows.items():
            if any(k in name for k in FFMA_KERNELS):
                check(r["ffma"] > 0, f"{lib}: {name} without FFMA")
            else:
                check(r["hmma"] + r["hgmma"] > 0,
                      f"{lib}: {name} without tensor-core instructions")
            if LINEAR_KERNELS["tokens"] in name:
                check(r["hgmma"] > 0, f"{lib}: {name} without HGMMA")
        out[lib] = rows
    return out


def dit_gemms(cfg, batch):
    """Every product of one DiT forward over ``batch`` rows (CFG-doubled
    requests) as ``(M, K, N, bias, calls, rows)``: the patch embedding,
    the time MLP, per block the adaLN modulation, q/k/v/o and the MLP, the
    final modulation and the output projection; ``rows`` is the linear
    kernel's variant (``"requests"``: one row per request)."""
    from repro_torch.core.diffusion import TIME_EMB_DIM, token_shape
    d, ff = cfg.d_model, cfg.stages[0].unit[0].ffn.d_ff
    n_tok, tok_dim = token_shape(cfg)
    rows, toks, blocks = batch, batch * n_tok, cfg.num_layers
    t, r = "tokens", "requests"
    return [(toks, tok_dim, d, True, 1, t),
            (rows, TIME_EMB_DIM, d, True, 1, r), (rows, d, d, True, 1, r),
            (rows, d, 6 * d, True, blocks, r),
            (toks, d, d, False, 4 * blocks, t),
            (toks, d, ff, False, blocks, t), (toks, ff, d, False, blocks, t),
            (rows, d, 2 * d, True, 1, r), (toks, d, tok_dim, True, 1, t)]


def linear_calls(cfg, computed):
    """``ops.linear`` calls of one forward whose branches of the types in
    ``computed`` run: 5 outside the blocks, per block the modulation, 4
    attention projections, 2 MLP products."""
    per_block = 1 + sum(4 if "attn" in t else 2 for t in computed)
    return 5 + cfg.num_layers * per_block


def gemm_kernel_phase(gemm, ref, peaks, cfg):
    """The linear kernels against their plain version (cuBLAS f32, TF32
    off) at every DiT-XL/2 product shape for buckets 1–8 under CFG (M = 2B
    request rows, 2B·256 token rows), each through its call site's variant,
    ≤ 5e-5 of the output's scale; each row bitwise against the product of
    fewer rows and of permuted rows, in both variants; a captured launch
    against an eager one in both, and a capture that finds no prepared
    weight raising; device times of one B = 8 forward's products beside
    their bound and cuBLAS's ``addmm`` / ``mm``, summed per variant."""
    from repro_torch.kernels.timing import device_ms, per_call_ms
    gen = torch.Generator().manual_seed(SEED + 11)

    def inputs(m, k, n):
        x = torch.randn(m, k, generator=gen).cuda()
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).cuda()
        return x, w, torch.randn(n, generator=gen).cuda()

    shapes = sorted({(k, n, rows)
                     for _, k, n, _, _, rows in dit_gemms(cfg, 2)})
    sweep, worst, worst_abs = [], 0.0, 0.0
    for k, n, rows in shapes:
        for bucket in (1, 2, 4, 8):
            m = 2 * bucket * (1 if rows == "requests" else 256)
            x, w, b = inputs(m, k, n)
            out = gemm.linear_cuda(x, w, b, rows=rows)
            want = ref.linear_ref(x, w, b)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            rel = err / float(want.abs().max())
            worst, worst_abs = max(worst, rel), max(worst_abs, err)
            sweep.append({"m": m, "k": k, "n": n, "rows": rows,
                          "max_abs_err": err, "rel_max_err": rel})
            check(rel <= 5e-5, f"linear vs plain at {sweep[-1]}")
        gemm.release()
    emit({"phase": "gemm_sweep", "limit": 5e-5, "cases": sweep})

    out_rows = {}
    for k, n, rows in shapes:
        ms = (1, 2, 4, 8, 16) if rows == "requests" else (512, 1024, 2048,
                                                          4096)
        x, w, _ = inputs(ms[-1], k, n)
        full = gemm.linear_cuda(x, w, rows=rows)
        d = {str(m): float((gemm.linear_cuda(x[:m].contiguous(), w,
                                             rows=rows)
                            - full[:m]).abs().max()) for m in ms[:-1]}
        perm = torch.randperm(x.shape[0], generator=gen).cuda()
        d["permuted"] = float((gemm.linear_cuda(x[perm].contiguous(), w,
                                                rows=rows)
                               - full[perm]).abs().max())
        out_rows[f"{k}x{n}:{rows}"] = d
        gemm.release()
    emit({"phase": "gemm_rows", "max_abs_vs_full": out_rows})
    check(all(v == 0.0 for d in out_rows.values() for v in d.values()),
          f"a row's bits change with the batch: {out_rows}")

    captured_ok = {}
    for rows, m in (("tokens", 512), ("requests", 8)):
        x, w, b = inputs(m, cfg.d_model, cfg.d_model)
        eager = gemm.linear_cuda(x, w, b, rows=rows)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            gemm.linear_cuda(x, w, b, rows=rows)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = gemm.linear_cuda(x, w, b, rows=rows)
        graph.replay()
        torch.cuda.synchronize()
        captured_ok[rows] = bool(torch.equal(captured, eager))
        del graph
    # a weight with no prepared copy: the capture raises, it allocates none
    x, w, _ = inputs(512, cfg.d_model, cfg.d_model)
    graph, raised = torch.cuda.CUDAGraph(), False
    try:
        with torch.cuda.graph(graph):
            gemm.linear_cuda(x, w)
    except RuntimeError as e:
        raised = "prepared copy" in str(e)
    torch.cuda.synchronize()
    del graph
    gemm.release()
    emit({"phase": "gemm_capture", "captured_equals_eager": captured_ok,
          "unprepared_capture_raises": raised})
    check(all(captured_ok.values()), f"captured linear != eager: "
          f"{captured_ok}")
    check(raised, "a capture without a prepared weight did not raise")

    # one B = 8 forward's products (4 requests under CFG), each shape timed
    # alone and summed by its calls, in all and per variant
    keys = ("ms", "per_call_ms", "plain_ms", "library_ms", "bound_ms")
    timed, total = [], {**{key: 0.0 for key in keys}, "flops": 0,
                        "bytes": 0}
    variants = {rows: {**{key: 0.0 for key in keys}, "calls": 0}
                for rows in gemm.ROWS}
    for m, k, n, bias, calls, rows in dit_gemms(cfg, 8):
        x, w, b = inputs(m, k, n)
        b = b if bias else None
        lib = ((lambda: torch.addmm(b, x, w)) if bias
               else (lambda: torch.mm(x, w)))
        flops = 2 * m * k * n
        nbytes = 4 * (m * k + k * n + m * n + (n if bias else 0))
        # 3xTF32 on the tensor cores for the token rows, f32 FMAs outside
        # them for the request rows
        t_ops = (3 * flops / peaks["tf32"] if rows == "tokens"
                 else flops / peaks["fp32"]) * 1e3
        t_bytes = nbytes / peaks["hbm"] * 1e3
        row = {"m": m, "k": k, "n": n, "bias": bias, "calls": calls,
               "plan": gemm.launch_plan(m, k, n, rows),
               "ms": device_ms(lambda: gemm.linear_cuda(x, w, b, rows=rows)),
               "per_call_ms": per_call_ms(
                   lambda: gemm.linear_cuda(x, w, b, rows=rows)),
               "plain_ms": device_ms(lambda: ref.linear_ref(x, w, b)),
               "library_ms": device_ms(lib),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["tflops"] = flops / row["ms"] / 1e9
        timed.append(row)
        for key in keys:
            total[key] += calls * row[key]
            variants[rows][key] += calls * row[key]
        variants[rows]["calls"] += calls
        total["flops"] += calls * flops
        total["bytes"] += calls * nbytes
        gemm.release()
    emit({"phase": "gemm_times", "batch": 8, "shapes": timed,
          "forward": total, "variants": variants})
    return {"name": "linear", "route": "cuda",
            "source": "src/repro_torch/kernels/gemm.cu",
            "replaces": "no TPU kernel: x @ w, XLA's dot on the TPU "
                        "(src/repro/models/mlp.py:22), cuBLAS f32 in "
                        "PyTorch; added for the row contract",
            "work": "one B = 8 DiT-XL/2 forward's products "
                    f"({sum(r['calls'] for r in timed)} calls)",
            "max_abs_err": worst_abs, "max_rel_err": worst,
            "ms": total["ms"], "per_call_ms": total["per_call_ms"],
            "plain_ms": total["plain_ms"], "library_ms": total["library_ms"],
            # each product's own bound, summed: the token products by
            # operations, the request-row products by bytes
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if variants["tokens"]["bound_ms"]
            >= variants["requests"]["bound_ms"] else "bytes",
            "flops": total["flops"], "bytes": total["bytes"],
            "variants": variants, "tile": gemm.TILE}


def full_width_params(cfg):
    """Seeded full-width parameters on the CPU (``serve_diffusion``'s
    recipe: each zero-initialized adaLN-zero leaf gets N(0,1)/√fan_in, so
    all 28 blocks contribute and activations stay finite)."""
    from repro_torch.launch.serve_diffusion import random_params
    return random_params(torch.Generator().manual_seed(SEED), cfg,
                         device="cpu")


def cross_check_phase(cfg, diffusion, params_cpu, params_gpu):
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((2,) + cfg.latent_shape, generator=gen)
    t = torch.tensor([999.0, 500.0])
    label = torch.tensor([207, cfg.num_classes])
    t0 = time.perf_counter()
    pred_gpu, _ = diffusion.apply(cfg, params_gpu, x.cuda(), t.cuda(),
                                  label=label.cuda())
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred_cpu, _ = diffusion.apply(cfg, params_cpu, x, t, label=label)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(pred_cpu).all()), "CPU prediction not finite")
    scale = float(pred_cpu.abs().max())
    rel = float((pred_gpu.cpu() - pred_cpu).abs().max()) / scale
    emit({"phase": "cross_check", "batch": 2, "max_abs_pred": scale,
          "rel_max_err": rel, "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(rel <= 1e-4, f"card vs CPU forward: relative error {rel}")


def attention_path(cfg, diffusion, fa, params):
    """How the kernel computes the q/k/v that the first DiT block makes
    (``models.attention``'s own projection) at B = 8 under CFG: every
    block's q/k/v are fresh (B, L, H, D) views of one matmul output, so
    they all take this path."""
    from repro_torch.models import attention
    from repro_torch.models.transformer import tree_map
    spec = cfg.stages[0].unit[0].mixer
    mixer = tree_map(lambda a: a[0],
                     params["backbone"]["stages"][0][0]["mixer"])
    x = torch.randn(8, diffusion.token_shape(cfg)[0], cfg.d_model,
                    device="cuda")
    return fa.plan(*attention._gqa_qkv(spec, mixer, x))


def slice_phase(cfg, params, ops):
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    n_attn = cfg.num_layers
    calib_labels = torch.tensor([(97 * i) % cfg.num_classes
                                 for i in range(10)], device="cuda")
    pipe = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                             cfg_scale=1.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = pipe.calibrate(params, torch.Generator().manual_seed(SEED + 2), 10,
                         cond_args={"label": calib_labels})
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    emit({"phase": "calibrate", "samples": 10, "steps": 50, "seconds": calib_s,
          "compute_fraction": pipe.compute_fraction(),
          "lag1_err_mid": {t: float(c[25, 1]) for t, c in art.curves.items()}})

    with tempfile.TemporaryDirectory() as tmp:
        path = pipe.save_artifact(str(Path(tmp) / "dit_xl_ddim50.cache.json"))
        serve = DiffusionPipeline(cfg, solvers.ddim(50),
                                  "smoothcache:alpha=0.18", cfg_scale=1.5)
        serve.load_artifact(path, strict=True)
    check(serve.schedule.to_json() == art.schedule.to_json(),
          "loaded schedule differs from the calibrated one")

    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    runs, latents = [], {}
    for name, override in (("no_cache", None),
                           ("smoothcache:alpha=0.18", "artifact"),
                           ("static:n=2", "static:n=2")):
        sch = (serve.schedule if override == "artifact"
               else serve.schedule_for(override) if override else None)
        kw = {} if override == "artifact" else {"schedule": sch}
        attn_steps = 50 if sch is None else int((~sch.skip["attn"]).sum())
        gemm_calls = sum(linear_calls(cfg, [
            t for t in cfg.layer_types()
            if sch is None or not sch.skip[t][s]]) for s in range(50))
        before = ops.LAUNCHES["flash_attention"]
        before_linear = ops.LAUNCHES["linear"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = serve.generate(params, torch.Generator().manual_seed(SEED + 3),
                           len(REQUEST_LABELS), label=labels, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["flash_attention"] - before
        linear = ops.LAUNCHES["linear"] - before_linear
        latents[name] = x
        frac = (1.0 if sch is None else float(sum(
            sch.compute_fraction(t) for t in sch.skip) / len(sch.skip)))
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite latents")
        check(launches == n_attn * attn_steps,
              f"{name}: {launches} kernel launches, expected "
              f"{n_attn} x {attn_steps}")
        check(linear == gemm_calls,
              f"{name}: {linear} linear launches, expected {gemm_calls}")
        base = latents["no_cache"]
        runs.append({"run": name, "requests": len(REQUEST_LABELS),
                     "wall_s": wall, "compute_fraction": frac,
                     "attn_steps": attn_steps, "launches": launches,
                     "linear_launches": linear,
                     "rel_l1_to_no_cache": float((x - base).abs().sum()
                                                 / base.abs().sum())})
        emit({"phase": "generate", **runs[-1]})
    eager = serve.generate(params, torch.Generator().manual_seed(SEED + 3),
                           len(REQUEST_LABELS), label=labels, compiled=False)
    same = bool(torch.equal(eager, latents["smoothcache:alpha=0.18"]))
    emit({"phase": "segmented_vs_eager", "run": "smoothcache:alpha=0.18",
          "bitwise_equal": same})
    check(same, "segmented and eager latents differ")
    return runs, art


def ssd_kernel_phase(ssd, ref, peaks):
    """SSD kernel vs plain over the sweep, at the prefill shape (where two
    launches must agree bitwise), at a ragged length and on strided views
    of one projection; device times at the prefill shape."""
    from repro_torch.kernels.timing import device_ms
    gen = torch.Generator().manual_seed(SEED)

    def inputs(b, l, h, p, g, n, dtype, split=False):
        """Seeded inputs; ``split``: x, b and c are views of one (B, L,
        H·P + 2·G·N) tensor, as ``models/ssm.py`` splits its projection."""
        f = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
        x, dt = f(b, l, h, p), torch.nn.functional.softplus(f(b, l, h) - 1.0)
        a = torch.exp(torch.rand(h, generator=gen))
        bb, cc = f(b, l, g, n), f(b, l, g, n)
        if split:
            xbc = torch.cat([x.reshape(b, l, h * p), bb.reshape(b, l, g * n),
                             cc.reshape(b, l, g * n)], -1).to("cuda", dtype)
            x, bb, cc = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
            return [x.reshape(b, l, h, p), dt.cuda(), a.cuda(),
                    bb.reshape(b, l, g, n), cc.reshape(b, l, g, n)]
        return [x.to("cuda", dtype), dt.cuda(), a.cuda(),
                bb.to("cuda", dtype), cc.to("cuda", dtype)]

    # tests/test_kernels.py's tolerances against its sequential oracle
    tols = {torch.float32: ((2e-4, 2e-3), (1e-4, 1e-2)),
            torch.bfloat16: ((1e-1, 1e-1), (1e-2, 1e-2))}

    def compare(shape, chunk, dtype, elementwise=True, split=False):
        """Element-wise at the sweep's tolerances; at full width, where y
        reaches ~400 and near-zero outputs carry the rounding of large
        sums, max |err| / max |plain| <= 1e-4 for y and the state."""
        t = inputs(*shape, dtype, split)
        y, hT = ssd.ssd_cuda(*t, chunk=chunk)
        yr, hr = ref.ssd_ref(*t, chunk=chunk)
        torch.cuda.synchronize()
        (ya, yr_), (ha, hr_) = tols[dtype]
        row = {"shape": shape, "chunk": chunk, "dtype": str(dtype)[6:],
               **ssd.plan(t[0], t[3], t[4]), "split_views": split,
               "max_abs_err": float((y.float() - yr.float()).abs().max()),
               "max_abs_y": float(yr.float().abs().max()),
               "rel_max_err": rel_err(y, yr),
               "state_rel_max_err": rel_err(hT, hr)}
        if elementwise:
            row["ok"] = bool(
                torch.allclose(y.float(), yr.float(), atol=ya, rtol=yr_)
                and torch.allclose(hT, hr, atol=ha, rtol=hr_))
        else:
            row["ok"] = max(row["rel_max_err"],
                            row["state_rel_max_err"]) <= 1e-4
        check(row["ok"], f"ssd kernel vs plain {row}")
        return row, t, (y, hT)

    sweep = [compare(shape, chunk, dtype)[0]
             for *shape, chunk in ((2, 64, 4, 16, 1, 16, 16),
                                   (1, 96, 8, 32, 2, 32, 32),
                                   (2, 33, 2, 16, 1, 8, 16),
                                   (1, 16, 2, 8, 2, 8, 8),
                                   (1, 50, 2, 6, 1, 5, 13),
                                   (1, 100, 1, 72, 1, 20, 128))
             for dtype in (torch.float32, torch.bfloat16)]
    emit({"ssd_sweep": sweep})
    b, l, h, p, g, n, q = LM_BATCH, LM_PROMPT, 64, 64, 1, 128, 128
    ragged, _, _ = compare((b, 1000, h, p, g, n), q, torch.float32, False)
    split, _, _ = compare((b, l, h, p, g, n), q, torch.float32, False, True)
    check(split["load"] == "cp.async", f"split views took {split['load']}")
    full, t, (y, hT) = compare((b, l, h, p, g, n), q, torch.float32, False)
    y2, hT2 = ssd.ssd_cuda(*t, chunk=q)
    bitwise = bool(torch.equal(y, y2) and torch.equal(hT, hT2))
    emit({"ssd_prefill_shape": full, "ssd_ragged": ragged,
          "ssd_split_views": split, "bitwise_equal": bitwise})
    check(bitwise, "two SSD launches at the prefill shape differ")
    ms = device_ms(lambda: ssd.ssd_cuda(*t, chunk=q))
    plain_ms = device_ms(lambda: ref.ssd_ref(*t, chunk=q), iters=10,
                         reps=3)
    _, passes = _traced(lambda: [ssd.ssd_cuda(*t, chunk=q)
                                 for _ in range(10)])
    flops = ssd_flops(b, l, h, p, g, n, q)
    nbytes = 4 * (2 * b * l * h * p + b * h * p * n + 2 * b * l * g * n
                  + b * l * h + h)
    # f32 runs as three TF32 products on the tensor cores (3xTF32)
    t_ops = (3 * flops / peaks["tf32"] * 1e3 if "tf32" in peaks else None)
    t_bytes = nbytes / peaks["hbm"] * 1e3
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:76",
            "shape": [b, l, h, p, g, n, q], "dtype": "float32",
            **ssd.plan(t[0], t[3], t[4]),
            "max_abs_err": full["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": None if t_ops is None else max(t_ops, t_bytes),
            "bound_by": (None if t_ops is None else
                         "operations" if t_ops >= t_bytes else "bytes"),
            "bound_simt_ms": flops / peaks["fp32"] * 1e3,
            "library_ms": None,
            "pass_ms": {k: us / 1e3 / calls
                        for k, (us, calls) in ssd_passes(passes).items()},
            "flops": flops, "bytes": nbytes}


def ssd_passes(kern):
    """{pass: [device µs, calls]} of the SSD kernels in ``_kernel_times``'s
    result, summed by pass name."""
    out = {}
    for k, (us, calls) in kern.items():
        for name in SASS_KERNELS["ssd"]:
            if name + "<" in k or k.endswith(name):
                row = out.setdefault(name, [0.0, 0])
                row[0] += us
                row[1] += calls
    return out


def ssd_flops(b, l, h, p, g, n, q):
    """FLOPs the SSD function needs with no initial state, counted per chunk
    of qz = min(q, L - start) steps: C·Bᵀ on its causal triangle once per
    (batch, group), since every head of a group shares it; per (batch,
    head) the scores·x triangle, the state update x'·B, and C·stateᵀ from
    the second chunk on (the state entering the first chunk is zero)."""
    macs = 0
    for z, start in enumerate(range(0, l, q)):
        qz = min(q, l - start)
        tri = qz * (qz + 1) // 2
        macs += b * g * tri * n
        macs += b * h * (tri * p + qz * n * p + (qz * n * p if z else 0))
    return 2 * macs


def rel_err(got, want):
    """max |got - want| / max |want|, on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / float(want.abs().max())


def lm_cross_check_phase(cfg, T, params_cpu, params_gpu):
    """Prefill of one 200-token prompt (a ragged last chunk): card against
    CPU, logits and every block's final states."""
    toks = torch.randint(0, cfg.vocab_size, (1, 200),
                         generator=torch.Generator().manual_seed(SEED + 4))
    t0 = time.perf_counter()
    lg_gpu, c_gpu = T.prefill(cfg, params_gpu, toks.cuda())
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg_cpu, c_cpu = T.prefill(cfg, params_cpu, toks)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lg_cpu).all()), "CPU logits not finite")
    errs = {"logits": rel_err(lg_gpu, lg_cpu),
            "conv_state": rel_err(c_gpu[0][0]["conv"], c_cpu[0][0]["conv"]),
            "ssm_state": rel_err(c_gpu[0][0]["ssm"], c_cpu[0][0]["ssm"])}
    emit({"phase": "lm_cross_check", "prompt": 200, "rel_max_err": errs,
          "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    for name, err in errs.items():
        check(err <= 1e-4, f"card vs CPU prefill {name}: relative error {err}")


def lm_slice_phase(cfg, T, serve, params, ops):
    """The LM main path: prefill + recurrent decode through ``generate``."""
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 5))
    prompts = prompts.cuda()
    marks = {}

    def mark(phase):
        torch.cuda.synchronize()
        marks[phase] = (time.perf_counter(), dict(ops.LAUNCHES))

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    mark("start")
    toks = serve.generate(cfg, params, prompts, LM_GEN, on_phase=mark)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    (t0, _), (t1, at_prefill), (t2, at_end) = (
        marks["start"], marks["prefill"], marks["decode"])
    steps = LM_GEN - 1
    row = {"phase": "lm_generate", "arch": cfg.name, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "new_tokens": LM_GEN, "prefill_s": t1 - t0,
           "decode_ms_per_step": 1e3 * (t2 - t1) / steps,
           "decode_tokens_per_s": LM_BATCH * steps / (t2 - t1),
           "tokens_per_s": LM_BATCH * LM_GEN / (t2 - t0),
           "ssd_launches_prefill": at_prefill["ssd"],
           "ssd_launches_decode": at_end["ssd"] - at_prefill["ssd"],
           "launches": launches, "peak_device_bytes": peak}
    emit(row)
    check(at_prefill["ssd"] == cfg.num_layers,
          f"{at_prefill['ssd']} SSD launches in the prefill, expected "
          f"{cfg.num_layers}")
    check(at_end["ssd"] == at_prefill["ssd"], "SSD launches in the decode")
    check(launches["flash_attention"] == 0, "attention launched in the LM")
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of range")
    return prompts, toks, launches


def lm_decode_consistency_phase(cfg, T, params, prompts, toks):
    """Teacher-forced recurrent decode of the generated tokens against one
    card forward over prompt + the first 31 of them: the kernel's final
    state and the conv tail must hand over to the decode step."""
    steps = LM_GEN - 1
    logits, caches = T.prefill(cfg, params, prompts)
    check(all(bool(torch.isfinite(c[k]).all())
              for st in caches for c in st for k in c),
          "prefill states not finite")
    dec = []
    for i in range(steps):
        lg, caches = T.decode_step(cfg, params, toks[:, i:i + 1], caches)
        dec.append(lg)
    check(all(bool(torch.isfinite(c[k]).all())
              for st in caches for c in st for k in c),
          "decode states not finite")
    dec = torch.cat(dec, dim=1)
    full, _ = T.forward(cfg, params, torch.cat([prompts, toks[:, :steps]], 1))
    err = rel_err(dec, full[:, LM_PROMPT:])
    first = rel_err(logits[:, -1], full[:, LM_PROMPT - 1])
    agree = float((dec.argmax(-1) == toks[:, 1:]).float().mean())
    emit({"phase": "lm_decode_consistency", "length": LM_PROMPT + steps,
          "rel_max_err": err, "prefill_last_rel_err": first,
          "limit": 1e-4, "greedy_agreement": agree})
    check(err <= 1e-4 and first <= 1e-4,
          f"decode vs forward logits: relative error {err}, {first}")


def _kernel_times(prof):
    """{kernel name: [self device µs, calls]} from a profile, CUDA kernels
    only."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        row = out.setdefault(evt.key, [0.0, 0])
        row[0] += float(us)
        row[1] += evt.count
    return out


def _traced(fn):
    """Run ``fn`` once under ``torch.profiler``: (wall µs, kernel times)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return wall_us, _kernel_times(prof)


def _profiled(fn):
    """Run ``fn`` once under ``torch.profiler`` recording device activity
    only: (wall µs, the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return wall_us, prof


def _device_us(prof, fragment):
    """(device µs of every CUDA activity, device µs of those whose name
    holds ``fragment``, their count) from the profiler's raw events, which
    skips the per-event parsing behind ``key_averages`` (slow over a long
    window).  Kernels replayed from a CUDA graph are traced one by one,
    those of an IF body only when its predicate held."""
    busy = part = count = 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            busy += evt.duration_ns()
            if fragment in evt.name():
                part += evt.duration_ns()
                count += 1
    return busy / 1e3, part / 1e3, count


def dit_profile_phase(cfg, diffusion, params, ops):
    """Where a DiT-XL/2 step's time goes: one full-width denoiser forward at
    B = 8 (4 requests under CFG) after one untraced warm-up forward —
    device time by kernel, the attention kernel's and the GEMMs' shares of
    it, and the device's idle share of the wall time."""
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn((8,) + cfg.latent_shape, generator=gen).cuda()
    t = torch.full((8,), 500.0, device="cuda")
    label = torch.tensor(REQUEST_LABELS + [cfg.num_classes] * 4,
                         device="cuda")
    diffusion.apply(cfg, params, x, t, label=label)
    before = {k: ops.LAUNCHES[k] for k in ("linear", "linear_tokens",
                                           "linear_requests")}
    wall_us, kern = _traced(
        lambda: diffusion.apply(cfg, params, x, t, label=label))
    launched = {k: ops.LAUNCHES[k] - v for k, v in before.items()}
    busy = sum(us for us, _ in kern.values())
    attn = [v for k, v in kern.items() if "attn_fwd" in k]
    linear = {rows: [v for k, v in kern.items() if name in k]
              for rows, name in LINEAR_KERNELS.items()}
    # any other product kernel (cuBLAS, CUTLASS) would break the row
    # contract: every DiT product must go through the port's linear kernels
    library = [k for k in kern
               if not any(n in k for n in LINEAR_KERNELS.values()) and any(
                   f in k.lower() for f in ("gemm", "cutlass", "xmma",
                                            "cublas"))]
    by_variant = {rows: {"ms": sum(us for us, _ in v) / 1e3,
                         "kernels_in_profile": sum(n for _, n in v),
                         "calls": launched["linear_" + rows]}
                  for rows, v in linear.items()}
    gemm = sum(us for v in linear.values() for us, _ in v)
    attn_us = sum(us for us, _ in attn)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    row = {"phase": "dit_profile", "batch": 8, "wall_ms": wall_us / 1e3,
           "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
           "attn_ms": attn_us / 1e3, "attn_calls": sum(n for _, n in attn),
           "attn_share": attn_us / busy, "gemm_ms": gemm / 1e3,
           "gemm_share": gemm / busy,
           "gemm_calls": launched["linear"],
           "gemm_kernels_in_profile": sum(
               v["kernels_in_profile"] for v in by_variant.values()),
           "gemm_variants": by_variant,
           "library_gemm_kernels": library, "kernels": len(kern),
           "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                   for k, (us, n) in top]}
    emit(row)
    check(busy > 0, "the profiler saw no device time")
    check(row["attn_calls"] == cfg.num_layers,
          f"{row['attn_calls']} attention kernels in one forward, expected "
          f"{cfg.num_layers}")
    want = linear_calls(cfg, cfg.layer_types())
    check(row["gemm_calls"] == want and all(linear.values())
          and not library,
          f"{row['gemm_calls']} linear launches in one forward (expected "
          f"{want}), other product kernels {library}")
    # the four request-row sites: the adaLN modulation of every block, the
    # time MLP's two products, the final modulation
    want = {"requests": cfg.num_layers + 3,
            "tokens": want - cfg.num_layers - 3}
    check(all(by_variant[r]["calls"] == n for r, n in want.items()),
          f"linear calls by variant {by_variant}, expected {want}")


def lm_profile_phase(cfg, T, params, prompts, toks):
    """Where the LM slice's time goes: device time by kernel, and the
    device's idle share of the wall time, for one prefill and for 4 decode
    steps (after one untraced warm-up step)."""
    rows = {}
    _, caches = T.prefill(cfg, params, prompts)
    _, caches = T.decode_step(cfg, params, toks[:, :1], caches)
    runs = {"prefill": lambda: T.prefill(cfg, params, prompts)}

    def decode4():
        c = caches
        for i in range(1, 5):
            _, c = T.decode_step(cfg, params, toks[:, i:i + 1], c)
    runs["decode_4_steps"] = decode4
    for name, fn in runs.items():
        wall_us, kern = _traced(fn)
        busy = sum(us for us, _ in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
        rows[name] = {
            "wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else None,
            "idle_share": 1 - busy / wall_us if busy else None,
            "ssd_ms": sum(us for us, _ in ssd_passes(kern).values()) / 1e3,
            "ssd_pass_ms": {k: us / 1e3
                            for k, (us, _) in ssd_passes(kern).items()},
            "kernels": len(kern),
            "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                    for k, (us, n) in top]}
    emit({"phase": "lm_profile", **rows})
    check(rows["prefill"]["ssd_ms"] > 0, "the prefill trace shows no SSD pass")
    check(set(rows["prefill"]["ssd_pass_ms"]) == set(SASS_KERNELS["ssd"]),
          f"SSD passes in the prefill trace: {rows['prefill']['ssd_pass_ms']}")
    check(rows["decode_4_steps"]["ssd_ms"] == 0, "an SSD pass in the decode")


SERVE_ADAPTIVE = "adaptive:base=smoothcache(alpha=0.18),tau=0.3"
SERVE_ENTRIES = ("no_cache", "smoothcache:alpha=0.18", "static:n=2",
                 SERVE_ADAPTIVE)


def computed_attn_steps(record, entry):
    """Steps of one served batch that computed attention; each is one
    model call at B = 2 × bucket, 28 kernel launches (replayed from a
    captured graph on the fused path)."""
    if record.decisions is not None:
        return sum("attn" not in d for d in record.decisions)
    return int((~entry.schedule.skip["attn"]).sum())


def attn_branches(graph_stats):
    """Branches of a fused graph whose model call computes attention
    (their IF bodies hold the captured attention launches)."""
    types, n = graph_stats["types"], graph_stats["branches"]
    if "attn" not in types:                  # the pool never skips it
        return n
    bit = types.index("attn")
    return sum(1 for code in range(n) if not code >> bit & 1)


def serve_store(cfg, params, smooth_art):
    """The four-entry store (the adaptive artifact calibrated here on 10
    samples and loaded back from JSON) and one pipeline per entry to
    replay served batches."""
    from repro_torch import serve
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    labels = torch.tensor([(97 * i) % cfg.num_classes for i in range(10)],
                          device="cuda")
    calib = DiffusionPipeline(cfg, solvers.ddim(50), SERVE_ADAPTIVE,
                              cfg_scale=1.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calib.calibrate(params, torch.Generator().manual_seed(SEED + 7), 10,
                    cond_args={"label": labels})
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    store = serve.ArtifactStore(cfg, solvers.ddim(50), cfg_scale=1.5)
    replay = {name: DiffusionPipeline(cfg, solvers.ddim(50), name,
                                      cfg_scale=1.5)
              for name in SERVE_ENTRIES}
    with tempfile.TemporaryDirectory() as tmp:
        for name, art in (("smoothcache:alpha=0.18", smooth_art),
                          (SERVE_ADAPTIVE, calib.artifact)):
            path = art.save(str(Path(tmp) / f"{len(store)}.cache.json"))
            store.add_artifact(name, path)
            replay[name].load_artifact(path, strict=True)
    store.add_policy("no_cache", "none")
    store.add_policy("static:n=2", "static:n=2")
    emit({"phase": "serve_store", "adaptive_calibrate_s": calib_s,
          "entries": {n: {"adaptive": store.get(n).adaptive,
                          "static_compute_fraction":
                              store.get(n).compute_fraction(),
                          "pool": store.get(n).pool_size()}
                      for n in SERVE_ENTRIES}})
    return store, replay


def serve_drain(cfg, params, store, ops, executor):
    """16 requests, 4 per entry, seeds and labels from ``SEED``, all
    arriving at once on a wall clock; ``max_batch`` 4, 2 in flight,
    ``interleave``.  Attention launches and decision syncs are attributed
    to the entry whose run advanced (two entries' runs interleave)."""
    import numpy as np
    from repro_torch import serve
    rng = np.random.RandomState(SEED)
    reqs = [serve.Request(rid=i, seed=int(rng.randint(1 << 31)),
                          label=int(rng.randint(cfg.num_classes)),
                          policy=SERVE_ENTRIES[i % 4]) for i in range(16)]
    per = {n: {"launches": 0, "captured": 0, "host_syncs": 0}
           for n in SERVE_ENTRIES}

    class CountingEngine(serve.ServeEngine):
        # reads the executor through self: a class made per call sits in a
        # reference cycle, and must not keep the executor (its graphs hold
        # the weights) alive until the collector runs
        def _advance(self, fl):
            before = (ops.LAUNCHES["flash_attention"],
                      ops.CAPTURED["flash_attention"],
                      self.executor.host_sync_count)
            super()._advance(fl)
            row = per[fl.mb.group]
            row["launches"] += ops.LAUNCHES["flash_attention"] - before[0]
            row["captured"] += ops.CAPTURED["flash_attention"] - before[1]
            row["host_syncs"] += self.executor.host_sync_count - before[2]

    eng = CountingEngine(executor, params, store, max_batch=4,
                         max_inflight=2, scheduler="interleave")
    eng.submit(*reqs)
    eng.run_until_drained()
    return eng, reqs, per


def serve_phase(cfg, params, ops, smooth_art):
    """The serving stack at full width (see the module docstring, phase
    10).  Returns the attention kernels of the traced drain (counted in
    its device trace), the attention wrapper calls of the untraced drain
    (eager calls and the fused graph's warm-up and capture) and the
    store."""
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import schedule as schedule_lib, solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    store, replay = serve_store(cfg, params, smooth_art)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    _reset_counts(ops)
    eng, reqs, per = serve_drain(cfg, params, store, ops, executor)
    launches = dict(ops.LAUNCHES)
    drain_syncs = executor.host_sync_count
    graphs = executor.fused_graphs()
    check(launches["ssd"] == 0, "SSD launched in the serve drain")
    check(sorted(eng.results) == list(range(16)),
          f"served {sorted(eng.results)} of 16 requests")
    check(all(bool(np.isfinite(x).all()) for x in eng.results.values()),
          "non-finite served latents")
    rep = eng.report()
    for name in SERVE_ENTRIES:
        entry = store.get(name)
        recs = [r for r in eng.records if r.group == name]
        mine = [r for r in reqs if r.policy == name]
        steps = sum(computed_attn_steps(r, entry) for r in recs)
        wall = (max(r.finished for r in mine)
                - min(r.started for r in mine))
        waits = [r.queue_wait for r in mine]
        service = [r.service_time for r in mine]
        row = {"phase": "serve_entry", "entry": name, "batches": len(recs),
               "buckets": [r.bucket for r in recs], "requests": len(mine),
               "wall_s": wall, "images_per_s": len(mine) / wall,
               "queue_wait_s": {"p50": percentile(waits, 50),
                                "p95": percentile(waits, 95)},
               "service_s": {"p50": percentile(service, 50),
                             "p95": percentile(service, 95)},
               "compute_fraction": float(np.mean(
                   [r.compute_fraction for r in recs])),
               "steps": sum(r.num_steps for r in recs),
               "attn_steps": steps, **per[name]}
        if entry.adaptive:
            # fused entries: the graph replays launch without a Python
            # call, so the replayed launches come from the decision trace;
            # the calls counted are each new graph's eager warm-up of every
            # branch and its capture, one per attention-computing branch
            mine_graphs = [g for g in graphs if g["runtime"]]
            expect = cfg.num_layers * sum(attn_branches(g)
                                          for g in mine_graphs)
            row.update(replayed_launches=cfg.num_layers * steps,
                       graphs=len(mine_graphs),
                       capture_s=[g["capture_s"] for g in mine_graphs])
            emit(row)
            check(row["launches"] == expect and row["captured"] == expect,
                  f"{name}: {row['launches']} warm-up and {row['captured']}"
                  f" captured attention calls, expected {expect} each")
            check(row["host_syncs"] == 0,
                  f"{name}: {row['host_syncs']} decision syncs on the "
                  "fused path")
        else:
            emit(row)
            check(row["launches"] == cfg.num_layers * steps
                  and row["captured"] == 0,
                  f"{name}: {row['launches']} attention launches, expected "
                  f"{cfg.num_layers} x {steps}")
        if entry.adaptive:
            age = {t: 0 for t in cfg.layer_types()}
            for rec in recs:
                for step in rec.decisions:
                    for t in age:
                        age[t] = age[t] + 1 if t in step else 0
                        check(age[t] <= entry.k_max,
                              f"{name}: cache age {age[t]} > k_max")
        else:
            check(row["host_syncs"] == 0, f"{name}: host syncs")

    # one served batch per entry, replayed through generate: bitwise
    replays = {}
    for name in SERVE_ENTRIES:
        rec = next(r for r in eng.records if r.group == name)
        label = torch.tensor(rec.labels, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = replay[name].generate(
            params, serve.batch_generator(rec.seeds), rec.bucket,
            label=label, **({"return_decisions": True}
                            if store.get(name).adaptive else {}))
        x, dec = out if isinstance(out, tuple) else (out, None)
        x = x.cpu()
        wall = time.perf_counter() - t0
        served = torch.from_numpy(np.stack([eng.results[i]
                                            for i in rec.rids]))
        same = bool(torch.equal(x, served)) and dec == rec.decisions
        replays[name] = {"bucket": rec.bucket, "wall_s": wall,
                         "ms_per_step": 1e3 * wall / rec.num_steps,
                         "bitwise_equal": same}
        check(same, f"{name}: served batch differs from its generate replay")
    # the host loop's decision sync, which the served (fused) batch no
    # longer pays: the batch on the host loop with its per-step reads (A)
    # against the same batch at τ = 0 on its own realized decisions (B:
    # the same model calls, no reads), in the order A B B A
    rec = next(r for r in eng.records if r.group == SERVE_ADAPTIVE)
    entry = store.get(SERVE_ADAPTIVE)
    realized = schedule_lib.Schedule(
        {t: np.array([t in d for d in rec.decisions])
         for t in entry.schedule.skip}, rec.num_steps)
    served = torch.from_numpy(np.stack([eng.results[i] for i in rec.rids]))
    label = torch.tensor(rec.labels, device="cuda")

    def run(tau, schedule):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = executor.sample_adaptive(
            params, serve.batch_generator(rec.seeds), rec.bucket,
            schedule=schedule, tau=tau, proxy_map=entry.proxy_map,
            pool=entry.pool(), k_max=entry.k_max, label=label).cpu()
        check(bool(torch.equal(x, served)),
              f"the adaptive batch at tau={tau} differs from the served one")
        return time.perf_counter() - t0

    synced = [run(entry.tau, entry.schedule)]
    syncs = executor.host_sync_count
    unsynced = [run(0.0, realized), run(0.0, realized)]
    check(executor.host_sync_count == syncs, "decision syncs at tau=0")
    synced.append(run(entry.tau, entry.schedule))
    emit({"phase": "serve_replay", "replays": replays,
          "adaptive_sync_cost": {
              "steps": rec.num_steps, "synced_s": synced,
              "unsynced_s": unsynced,
              "ms_per_step": 1e3 * (sum(synced) - sum(unsynced)) / 2
              / (rec.num_steps - 1)}})

    # a second drain under the profiler (device activity only), on the
    # same executor so that no graph capture falls in the window: the
    # device's idle share, and every attention kernel of the drain counted
    # in the trace — eager launches and graph replays alike
    n_graphs = len(executor.fused_graphs())
    traced = {}
    wall_us, prof = _profiled(lambda: traced.update(
        eng=serve_drain(cfg, params, store, ops, executor)[0]))
    busy, attn_us, attn_kernels = _device_us(prof, "attn_fwd")
    traced_steps = sum(computed_attn_steps(r, store.get(r.group))
                       for r in traced["eng"].records)
    check(len(executor.fused_graphs()) == n_graphs,
          "a graph was captured in the traced drain")
    row = {"phase": "serve", "requests": rep["requests"],
           "batches": rep["batches"], "buckets": rep["buckets"],
           "drain_s": rep["makespan_s"],
           "images_per_s": rep["throughput_rps"],
           "queue_wait_s": rep["queue_wait_s"], "service_s": rep["service_s"],
           "compute_fraction": rep["compute_fraction"],
           "model_variants": rep["compiles"]["model_variants"],
           "variants": rep["compiles"],
           "program_budget": rep["program_budget"],
           "host_sync_count": drain_syncs,
           "launches": launches,
           "traced_drain": {"wall_ms": wall_us / 1e3,
                            "device_ms": busy / 1e3,
                            "idle_share": 1 - busy / wall_us,
                            "attn_ms": attn_us / 1e3,
                            "attn_steps": traced_steps,
                            "attn_kernels_in_trace": attn_kernels},
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(rep["compiles"]["model_variants"] <= rep["program_budget"],
          f"{rep['compiles']['model_variants']} model variants over the "
          f"budget {rep['program_budget']}")
    check(busy > 0, "the profiler saw no device time in the serve drain")
    check(attn_kernels == cfg.num_layers * traced_steps,
          f"{attn_kernels} attention kernels in the traced drain, expected "
          f"{cfg.num_layers} x {traced_steps} attention steps")
    return attn_kernels, launches["flash_attention"], store


def _reset_counts(ops):
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
        ops.CAPTURED[k] = 0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fused_phase(cfg, params, ops, store):
    """The fused adaptive path at full width (phase 11; budget ~20 s): the
    serve phase's adaptive artifact, 4 requests (bucket 4, B = 8 in the
    kernel).  Capture seconds and graph count; peak memory before and
    after the capture; fused ≡ host loop (decisions and latents) with the
    replays under ``set_sync_debug_mode("error")`` and no decision sync;
    τ = 0 fused ≡ ``sample_compiled``; chunks of 4 ≡ one call; the walls
    of the fused batch and the host loop in the order A B B A; the idle
    share of one traced fused batch; the replayed attention launches from
    the trace against the captured ones."""
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    t_phase = time.perf_counter()
    entry = store.get(SERVE_ADAPTIVE)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    kw = dict(schedule=entry.schedule, proxy_map=entry.proxy_map,
              pool=entry.pool(), k_max=entry.k_max, label=labels)
    n = len(REQUEST_LABELS)

    def gen():
        return torch.Generator().manual_seed(SEED + 8)

    # the capture, outside the guard: memory and seconds
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rs = executor.start_adaptive_fused_run(params, gen(), n, tau=entry.tau,
                                           **kw)
    _reset_counts(ops)
    (step, capture_wall) = _timed(lambda: executor.fused_step_for(params, rs))
    captured = ops.CAPTURED["flash_attention"]
    warm = ops.LAUNCHES["flash_attention"]
    mem1 = torch.cuda.memory_allocated()
    peak1 = torch.cuda.max_memory_allocated()
    expect = cfg.num_layers * attn_branches(step.stats)
    check(captured == expect and warm == expect,
          f"{warm} warm-up and {captured} captured attention calls, "
          f"expected {cfg.num_layers} x {attn_branches(step.stats)} "
          "branches each")
    # one model call per branch, its products through the linear kernel
    expect_linear = sum(
        linear_calls(cfg, [t for t in cfg.layer_types()
                           if not sig.skip.get(t, False)])
        for sig in step.table.branches)
    linear_calls_seen = (ops.LAUNCHES["linear"], ops.CAPTURED["linear"])
    check(linear_calls_seen == (expect_linear, expect_linear),
          f"{linear_calls_seen} warm-up and captured linear calls, "
          f"expected {expect_linear} each")

    # the run state's copy into the graph's buffers and out of them, at
    # bucket 4 (median of 5, CUDA events)
    def event_ms(fn):
        ms = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return sorted(ms)[2]

    state_bytes = sum(v.numel() * v.element_size() for v in
                      [rs.x, rs.x_prev, rs.acc, rs.lag, rs.trace,
                       rs.healthy] + [c for stage in rs.cache for d in stage
                                      for c in d.values()])
    copy = {"state_bytes": state_bytes,
            "copy_in_ms": event_ms(lambda: step._load(rs)),
            "copy_out_ms": event_ms(step._unload)}

    # fused (B) under the sync guard against the host loop (A)
    syncs = executor.host_sync_count

    def fused_run(rs=None):
        """One fused batch (start unless given, then every step), its
        replays under the sync guard: (run state, wall s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rs is None:
            rs = executor.start_adaptive_fused_run(params, gen(), n,
                                                   tau=entry.tau, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            rs = executor.advance_adaptive_fused(params, rs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return rs, time.perf_counter() - t0

    (xh, dh), a1 = _timed(lambda: executor.sample_adaptive(
        params, gen(), n, tau=entry.tau, return_decisions=True, **kw))
    host_syncs = executor.host_sync_count - syncs
    syncs = executor.host_sync_count
    rs, _ = fused_run(rs)            # the captured run (started above)
    _, b1 = fused_run()
    fused_syncs = executor.host_sync_count - syncs
    xf, df = rs.x, rs.decisions
    max_abs = float((xf - xh).abs().max())
    row = {"phase": "fused", "requests": n, "steps": rs.num_steps,
           # whether this PyTorch has its own conditional-node API (the
           # port builds IF nodes with core/cuda_graphs.cu either way)
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "torch_if_nodes": hasattr(torch.cuda.CUDAGraph,
                                     "begin_capture_to_if_node"),
           "graphs": len(executor.fused_graphs()),
           "capture": step.stats, "capture_wall_s": capture_wall,
           "linear_captured": ops.CAPTURED["linear"],
           "state_copy": copy,
           "device_bytes": {"before": mem0, "after_capture": mem1,
                            "peak_with_capture": peak1},
           "sync_guard": "error", "host_sync_count": fused_syncs,
           "host_loop_syncs": host_syncs,
           "decisions_equal": df == dh,
           "bitwise_vs_host_loop": bool(torch.equal(xf, xh)),
           "max_abs_vs_host_loop": max_abs}
    check(fused_syncs == 0, f"{fused_syncs} host syncs on the fused path")
    check(df == dh, "fused decisions differ from the host loop's")
    check(row["bitwise_vs_host_loop"],
          f"fused latents differ from the host loop's: max abs {max_abs}")

    # the rule compares a (1,) tensor τ as it compares a float τ (both
    # round to f32; a float divisor, by contrast, becomes a reciprocal
    # multiply on CUDA): values one ulp around τ, every k_max edge
    from repro_torch.core import calibration
    g = torch.Generator().manual_seed(SEED + 13)
    tau32 = torch.tensor(entry.tau, dtype=torch.float32)
    near = torch.stack([torch.nextafter(tau32, torch.tensor(-1.0)), tau32,
                        torch.nextafter(tau32, torch.tensor(2.0))])
    acc = torch.cat([near, torch.rand(509, generator=g) * 2 * entry.tau])
    acc = acc.reshape(128, 4).cuda()
    lag = torch.randint(0, entry.k_max + 2, (128, 4), generator=g,
                        dtype=torch.int32).cuda()
    zeros = (torch.zeros(128, device="cuda"), torch.zeros(4, device="cuda"),
             torch.zeros(4, device="cuda"))
    want = calibration.batch_rule(zeros[0], acc, lag, zeros[1], zeros[2],
                                  entry.tau, entry.k_max)
    got = calibration.batch_rule(
        zeros[0], acc, lag, zeros[1], zeros[2],
        *calibration.rule_limits(entry.tau, entry.k_max, "cuda"))
    row["tau_buffer_vs_float_bitwise"] = all(
        bool(torch.equal(a, b)) for a, b in zip(want, got))
    check(row["tau_buffer_vs_float_bitwise"],
          "the rule decides otherwise with a tensor tau than a float tau")

    # τ = 0 on the base schedule against the segmented path
    x0 = executor.sample_adaptive_fused(params, gen(), n, tau=0.0, **kw)
    xc = executor.sample_compiled(params, gen(), n, schedule=entry.schedule,
                                  label=labels)
    row["tau0_bitwise_vs_compiled"] = bool(torch.equal(x0, xc))
    check(row["tau0_bitwise_vs_compiled"],
          "fused tau=0 differs from sample_compiled")
    # chunks of 4 against one call
    rc = executor.start_adaptive_fused_run(params, gen(), n, tau=entry.tau,
                                           **kw)
    while not rc.done:
        rc = executor.advance_adaptive_fused(params, rc, n_steps=4)
    row["chunked_bitwise"] = bool(torch.equal(rc.x, xf))
    check(row["chunked_bitwise"], "chunks of 4 differ from one call")
    # a graph first built at the last step (a split at step num_steps − 1
    # into buckets of 2, which have no graph yet): its warm-up runs every
    # branch, one step each, and must stay inside the step tables; the
    # second half replays the graph the first half built
    n_graphs = len(executor.fused_graphs())
    late = executor.start_adaptive_fused_run(params, gen(), n,
                                             tau=entry.tau, **kw)
    late = executor.advance_adaptive_fused(params, late,
                                           n_steps=late.num_steps - 1)
    halves = [executor.advance_adaptive_fused(params, h)
              for h in executor.split_run(late, [[0, 1], [2, 3]])]
    again = executor.advance_adaptive_fused(
        params, executor.split_run(late, [[0, 1]])[0])
    merged = executor.merge_runs(halves)
    torch.cuda.synchronize()
    row["late_capture"] = {
        "split_at": late.step,
        "new_graphs": len(executor.fused_graphs()) - n_graphs,
        "finite": bool(torch.isfinite(merged.x).all()),
        "repeat_bitwise": bool(torch.equal(again.x, halves[0].x)),
        "max_abs_vs_unsplit": float((merged.x - xf).abs().max())}
    check(all(h.done for h in halves) and row["late_capture"]["finite"]
          and row["late_capture"]["repeat_bitwise"]
          and row["late_capture"]["new_graphs"] == 1,
          f"a graph built at step {late.step}: {row['late_capture']}")

    # walls, A B B A (A: host loop, B: fused), and one traced fused batch
    rs2, b2 = fused_run()
    check(torch.equal(rs2.x, xf), "two fused batches differ")
    _, a2 = _timed(lambda: executor.sample_adaptive(
        params, gen(), n, tau=entry.tau, **kw))
    traced = {}
    wall_us, prof = _profiled(lambda: traced.update(
        d=executor.sample_adaptive_fused(params, gen(), n, tau=entry.tau,
                                         return_decisions=True, **kw)[1]))
    busy, attn_us, attn_kernels = _device_us(prof, "attn_fwd")
    attn_steps = sum("attn" not in d for d in traced["d"])
    row.update({
        "walls_ABBA_s": {"host_loop": [a1, a2], "fused": [b1, b2]},
        "order": "A B B A",
        "traced_fused": {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
                         "idle_share": 1 - busy / wall_us,
                         "attn_ms": attn_us / 1e3,
                         "attn_kernels_in_trace": attn_kernels},
        "attn_steps": attn_steps,
        "replayed_launches": attn_kernels,
        "captured_launches_per_graph": captured,
        "phase_s": time.perf_counter() - t_phase})
    emit(row)
    check(attn_kernels == cfg.num_layers * attn_steps,
          f"{attn_kernels} attention kernels replayed in the traced fused "
          f"batch, expected {cfg.num_layers} x {attn_steps} attention steps")
    return row


def gemm_row_stability(cfg, ops):
    """Whether the DiT's f32 products keep a row's bits across batch
    shapes: the first M rows of an (M_max, K) @ (K, N) product against the
    (M, K) @ (K, N) product of those rows alone, for M = 2·256·bucket
    (CFG-doubled rows of 1 and 2 requests) against 4 requests — through
    ``ops.linear`` (the linear kernel; must read 0) and, for the record,
    cuBLAS.  The same for the served path's row reductions: the adaptive
    proxy (``calibration.rel_l1_change_rows``, must read 0; beside it the
    plain ``sum`` it replaced) over B = 1, 2, 4 of 8 latents, and
    layernorm and gelu over 2, 4 of 8 requests' tokens (must read 0).
    Seeded N(0, 1) inputs; max abs difference per shape and M."""
    from repro_torch.core import calibration
    from repro_torch.kernels import gemm
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(SEED + 10)
    tok, d = 256, cfg.d_model
    shapes = [(d, d), (d, 3 * d), (d, 4 * d), (4 * d, d), (d, 6 * d)]
    out = {"linear": {}, "cublas": {}}
    for k, n in shapes:
        a = torch.randn(2 * 4 * tok, k, generator=gen).cuda()
        b = torch.randn(k, n, generator=gen).cuda()
        for name, fn in (("linear", ops.linear), ("cublas", torch.mm)):
            full = fn(a, b)
            out[name][f"{k}x{n}"] = {
                str(m): float((fn(a[:m], b) - full[:m]).abs().max())
                for m in (2 * tok, 2 * 2 * tok)}
    # the request-row products over the rows of 1 and 2 of 4 requests
    for k, n in ((256, d), (d, d), (d, 6 * d), (d, 2 * d)):
        a = torch.randn(2 * 4, k, generator=gen).cuda()
        b = torch.randn(k, n, generator=gen).cuda()
        full = ops.linear(a, b, rows="requests")
        out["linear"][f"{k}x{n}:requests"] = {
            str(m): float((ops.linear(a[:m], b, rows="requests")
                           - full[:m]).abs().max()) for m in (2, 4)}
    gemm.release()

    def rows(fn, x, ms):
        full = fn(x)
        return {str(m): float((fn(x[:m]) - full[:m]).abs().max())
                for m in ms}

    lat = [torch.randn((8,) + cfg.latent_shape, generator=gen).cuda()
           for _ in range(2)]
    dims = tuple(range(1, lat[0].dim()))
    out["proxy"] = rows(lambda x: calibration.rel_l1_change_rows(
        x, lat[1][:len(x)]), lat[0], (1, 2, 4))
    out["proxy_plain_sum"] = rows(lambda x: (
        (x - lat[1][:len(x)]).abs().sum(dim=dims)
        / (lat[1][:len(x)].abs().sum(dim=dims) + 1e-12)), lat[0], (1, 2, 4))
    h = torch.randn(2 * 8, tok, d, generator=gen).cuda()
    norm = {"scale": torch.randn(d, generator=gen).cuda(),
            "bias": torch.randn(d, generator=gen).cuda()}
    out["layernorm"] = rows(lambda x: layers.layernorm(norm, x), h, (4, 8))
    out["gelu"] = rows(layers.gelu_tanh, h, (4, 8))
    return out


def continuous_phase(cfg, params, ops, store):
    """Continuous batching at full width (phase 12; budget ~25 s): the
    SmoothCache artifact, ``static:n=2`` and the adaptive artifact,
    ``max_batch`` 4, 2 in flight, ``interleave``, ``adaptive_chunk`` 4, a
    wall clock; 2 requests per entry at t = 0 and 2 more per entry at
    t ≈ 0.3 s, inside the 0.5 join horizon.  Once with ``continuous=True``
    and once without; joins ≥ 1 and merges ≥ 1, variants within the
    budget; every served request against its own solo ``generate``
    (B = 1) from its seed: the max abs difference per row; and whether
    the DiT's f32 products keep a row's bits across batch shapes."""
    import numpy as np
    from repro_torch import serve
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    entries = ("smoothcache:alpha=0.18", "static:n=2", SERVE_ADAPTIVE)
    rng = np.random.RandomState(SEED + 9)
    trace = [(i, entries[i % 3], 0.0 if i < 6 else 0.3,
              int(rng.randint(1 << 31)), int(rng.randint(cfg.num_classes)))
             for i in range(12)]

    def drain(continuous):
        executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
        eng = serve.ServeEngine(executor, params, store, max_batch=4,
                                max_inflight=2, scheduler="interleave",
                                adaptive_chunk=4, continuous=continuous)
        t0 = eng.clock.now()
        reqs = [serve.Request(rid=i, seed=seed, policy=pol, label=lab,
                              arrival=t0 + at)
                for i, pol, at, seed, lab in trace]
        eng.submit(*reqs)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        rep = eng.report()
        waits = [r.queue_wait for r in reqs]
        service = [r.service_time for r in reqs]
        out = {"continuous": continuous, "drain_s": time.perf_counter() - w0,
               "images_per_s": rep["throughput_rps"],
               "queue_wait_s": {"p50": percentile(waits, 50),
                                "p95": percentile(waits, 95)},
               "service_s": {"p50": percentile(service, 50),
                             "p95": percentile(service, 95)},
               **{k: rep["continuous"][k] for k in
                  ("joins", "joined_requests", "merges", "join_merges",
                   "regroups", "coalesces")},
               "lineage": [list(r.lineage) for r in eng.records
                           if r.lineage],
               "buckets": rep["buckets"],
               "model_variants": rep["compiles"]["model_variants"],
               "variants": rep["compiles"],
               "program_budget": rep["program_budget"],
               "host_sync_count": executor.host_sync_count,
               "graphs": len(executor.fused_graphs())}
        check(sorted(eng.results) == list(range(12)),
              f"served {sorted(eng.results)} of 12 requests")
        check(out["model_variants"] <= out["program_budget"],
              f"{out['model_variants']} model variants over the budget "
              f"{out['program_budget']}")
        check(executor.host_sync_count == 0, "decision syncs in the drain")
        return eng, out

    eng, on = drain(True)
    check(on["joins"] >= 1 and on["merges"] >= 1,
          f"continuous drain: {on['joins']} joins, {on['merges']} merges")
    _, off = drain(False)
    # each request's solo replay: generate(batch_generator([seed]), 1)
    solo = {name: DiffusionPipeline(cfg, solvers.ddim(50), name,
                                    cfg_scale=1.5) for name in entries}
    for name in entries:
        e = store.get(name)
        if e.artifact is not None:
            solo[name].load_artifact(e.artifact, strict=True)
    rows = []
    for i, pol, _, seed, lab in trace:
        x = solo[pol].generate(params, serve.batch_generator([seed]), 1,
                               label=torch.tensor([lab], device="cuda"))
        got = torch.from_numpy(eng.results[i])
        rows.append({"rid": i, "entry": pol,
                     "max_abs": float((x[0].cpu() - got).abs().max()),
                     "max_abs_latent": float(got.abs().max())})
    stability = gemm_row_stability(cfg, ops)
    emit({"phase": "continuous", "requests": 12, "runs": [on, off],
          "solo_replay_max_abs": rows, "solo_replay_limit": 0.0,
          "gemm_row_max_abs_vs_4_requests": stability,
          "phase_s": time.perf_counter() - t_phase})
    check(all(v == 0.0 for d in stability["linear"].values()
              for v in d.values())
          and all(v == 0.0 for op in ("proxy", "layernorm", "gelu")
                  for v in stability[op].values()),
          f"a served-path op's rows change with the batch: {stability}")
    # every product goes through the batch-invariant linear kernel and
    # the proxy's row sums through one fixed tree: bitwise
    bad = [r for r in rows if r["max_abs"] != 0.0]
    check(not bad, f"served rows differ from their solo replays: {bad}")
    return on, off, rows


SLO_TAUS = [0.0, 0.05, 0.3]
SLO_CONTROLLER = dict(target_p95_wait_s=2.0, min_samples=2, interval_s=0.5,
                      cooldown_s=2.0)
# headroom < 1: the backlog estimate prices two interleaved batches'
# service times in full, which overstates each one's wait
SLO_ADMISSION = dict(max_backlog_s=8.0, aging_rate=0.5, headroom=0.75)
SLO_PHASES = [(1.0, 6), (4.0, 14), (1.0, 6)]   # (requests / s, requests)


def slo_phase(cfg, params, ops, store):
    """The SLO layer at full width (phase 13; budget ~40 s): a τ ladder
    (``SLO_TAUS``) of the serve phase's adaptive artifact behind an
    ``ElasticPolicy`` (target p95 wait 2 s) and an ``AdmissionController``
    (backlog threshold 8 s, aging 0.5 / s), ``max_batch`` 4, 2 in flight, a
    wall clock; an ``overload_trace`` of 26 requests (6 at ~1 / s, 14 at
    ~4 / s, above the ~1.7 images / s the drain sustains, then 6 at
    ~1 / s), strict (max τ 0.05, 6 s deadline, priority 1, 1 in 8) and
    bulk (8–16 s deadlines).  Then one
    request at each τ > 0 rung through a second engine on the same
    executor, the rung set by hand: the second rung must capture no graph.
    Checks: ≥ 1 controller change; graphs = distinct (bucket, τ > 0) pairs
    served; variants within the budget; every request served or shed with
    a reason; every served batch bitwise its ``generate`` at its rung's
    τ."""
    import numpy as np
    from repro_torch import serve, slo
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    art = store.get(SERVE_ADAPTIVE).artifact
    ladder_store = serve.ArtifactStore(cfg, solvers.ddim(50), cfg_scale=1.5)
    ladder = ladder_store.add_ladder("gen", art, taus=SLO_TAUS)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    changes = []

    class Elastic(slo.ElasticPolicy):
        # records the graphs and captured calls at each rung change
        def on_finish(self, engine, record, requests, now):
            before = self.controller.rung
            super().on_finish(engine, record, requests, now)
            if self.controller.rung != before:
                changes.append({
                    "t": now - t0, "rung": self.controller.rung,
                    "graphs": len(engine.executor.fused_graphs()),
                    "captured_linear": ops.CAPTURED["linear"]})

    ctrl = slo.ElasticTauController(len(ladder.taus), **SLO_CONTROLLER)
    eng = serve.ServeEngine(
        executor, params, ladder_store, max_batch=4, max_inflight=2,
        scheduler=Elastic(ctrl),
        admission=slo.AdmissionController(**SLO_ADMISSION))
    classes = [slo.RequestClass("strict", "gen", weight=1.0, priority=1,
                                deadline_budget=6.0, max_tau=0.05),
               slo.RequestClass("bulk", "gen", weight=7.0,
                                deadline_budget=(8.0, 16.0))]
    rng = np.random.RandomState(SEED + 12)
    t0 = eng.clock.now()
    reqs = slo.overload_trace(classes, SLO_PHASES, rng, start=t0)
    for r in reqs:
        r.label = int(rng.randint(cfg.num_classes))
    eng.submit(*reqs)
    torch.cuda.synchronize()
    eng.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t_phase
    rep = eng.report()
    outcomes = {r.rid: eng.outcome(r.rid)[0] for r in reqs}
    graphs = len(executor.fused_graphs())
    pairs = {(r.bucket, r.tau > 0) for r in eng.records}

    # the rung moved by hand between the two τ > 0 rungs: one request each
    # through an engine on the same executor (no controller)
    probe = serve.ServeEngine(executor, params, ladder_store, max_batch=4,
                              scheduler="edf")
    seen = []
    for i, rung in enumerate((1, 2)):
        ladder_store.set_rung("gen", rung)
        probe.submit(serve.Request(rid=1000 + i, seed=1000 + i,
                                   policy="gen", label=i))
        probe.run_until_drained()
        seen.append((len(executor.fused_graphs()), ops.CAPTURED["linear"]))
    # every served batch against generate at its rung's τ
    replay = {}
    for tau in sorted({r.tau for r in eng.records + probe.records}):
        replay[tau] = DiffusionPipeline(
            cfg, solvers.ddim(50),
            f"adaptive:base=smoothcache(alpha=0.18),tau={tau:g}",
            cfg_scale=1.5)
        replay[tau].load_artifact(art.at_tau(tau), strict=True)
    mismatched = []
    results = {**eng.results, **probe.results}
    for rec in eng.records + probe.records:
        x, dec = replay[rec.tau].generate(
            params, serve.batch_generator(rec.seeds), rec.bucket,
            label=torch.tensor(rec.labels, device="cuda"),
            return_decisions=True)
        served = torch.from_numpy(np.stack([results[i] for i in rec.rids]))
        if not (torch.equal(x.cpu(), served) and dec == rec.decisions):
            mismatched.append(rec.rids)
    waits = [r.queue_wait for r in reqs if r.queue_wait is not None]
    row = {"phase": "slo", "requests": len(reqs),
           "classes": {c.name: sum(r.slo.cls == c.name for r in reqs)
                       for c in classes},
           "served": rep["requests"], "shed": rep["shed"],
           "deferrals": rep["deferrals"],
           "attainment": rep["slo"]["attainment"],
           "goodput_fraction": rep["slo"]["goodput_fraction"],
           "goodput_rps": rep["slo"].get("goodput_rps"),
           "images_per_s": rep.get("throughput_rps"),
           "queue_wait_p95_s": percentile(waits, 95) if waits else None,
           "realized_tau": rep["realized_tau"],
           "batches": [(r.bucket, r.tau) for r in eng.records],
           "controller_history": [(t - t0, rung, p95)
                                  for t, rung, p95 in ctrl.history],
           "changes": changes, "graphs": graphs,
           "graph_keys_served": sorted(pairs),
           "graph_records": executor.fused_graphs(),
           "rung_probe": {"graphs_and_captured_after": seen,
                          "batches": [(r.bucket, r.tau)
                                      for r in probe.records]},
           "model_variants": rep["compiles"]["model_variants"],
           "program_budget": rep["program_budget"],
           "controller": SLO_CONTROLLER, "admission": SLO_ADMISSION,
           "arrivals": SLO_PHASES,
           "replays": len(eng.records) + len(probe.records),
           "replays_bitwise": not mismatched,
           "drain_s": drain_s, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(len(ctrl.history) >= 1, "the controller never moved a rung")
    check(graphs == len(pairs),
          f"{graphs} fused graphs for the served (bucket, tau > 0) pairs "
          f"{sorted(pairs)}")
    check(seen[1] == seen[0],
          f"moving between tau > 0 rungs captured: {seen}")
    check(row["model_variants"] <= row["program_budget"],
          f"{row['model_variants']} model variants over the budget "
          f"{row['program_budget']}")
    check(all(o in ("done", "shed") for o in outcomes.values())
          and all(eng.shed[r][0] for r in eng.shed),
          f"requests without an outcome: {outcomes}")
    check(not mismatched, f"served batches differ from generate at their "
          f"rung's tau: {mismatched}")
    return row


RESILIENCE_POLICY = dict(watchdog_factor=4.0, watchdog_floor_s=0.5)
RESILIENCE_RAMP = dict(seed=1, nan_rate=0.15, stuck_rate=0.09,
                       error_rate=0.06)


def _replay_pipe(cfg, entry):
    """A pipeline that replays ``entry``'s batches through ``generate``
    (its policy, and its artifact where it has one)."""
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    pipe = DiffusionPipeline(cfg, solvers.ddim(50), entry.policy,
                             cfg_scale=1.5)
    if entry.artifact is not None:
        pipe.load_artifact(entry.artifact, strict=True)
    return pipe


def resilience_phase(cfg, params, ops, store):
    """Fault recovery at full width (phase 14; budget ~60 s): the
    SmoothCache artifact and the adaptive artifact, ``max_batch`` 4, 2 in
    flight, a wall clock, ``ResiliencePolicy(watchdog_factor=4.0,
    watchdog_floor_s=0.5)``, the chaos harness writing real NaNs into
    latents with ``mark_flags=False`` (only the executor's sentinels
    detect them).  (a) 8 requests clean, resilience off and on (A B B A):
    bitwise equal, the same batches, 0 faults, the health reads.  (b) 16
    requests under a fixed plan — the first batch formed (the adaptive
    one: the batcher takes groups in name order) a NaN in row 2 at chunk
    1, the second (static) a NaN in row 1, serial 2 an injected fault,
    serial 3 a stall 1 s past the deadline the watchdog holds that advance
    to: every request served, the fault kinds exact, one watchdog fire,
    records on the degraded and fallback entries, the static survivors
    bitwise their clean rows, every record without a split replaying
    bitwise through ``generate``.  (c) 16 requests under a seeded ramp of
    rate 0.3: every request resolves."""
    import dataclasses
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.resilience import (ChaosExecutor, FaultPlan, FaultSpec,
                                        ResiliencePolicy, faults)
    from repro_torch.serve.store import DEGRADED_PREFIX, FALLBACK_ENTRY
    from repro_torch.slo.slo import remaining_steps
    t_phase = time.perf_counter()
    static, adaptive = "smoothcache:alpha=0.18", SERVE_ADAPTIVE
    rng = np.random.RandomState(SEED + 19)
    trace = [(i, (static, adaptive)[i % 2], int(rng.randint(1 << 31)),
              int(rng.randint(cfg.num_classes))) for i in range(32)]
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    _reset_counts(ops)
    # the bucket-4 adaptive graph, captured before any drain is timed
    entry = store.get(adaptive)
    warm = executor.start_adaptive_fused_run(
        params, torch.Generator().manual_seed(0), 4, schedule=entry.schedule,
        tau=entry.tau, proxy_map=entry.proxy_map, pool=entry.pool(),
        k_max=entry.k_max,
        label=torch.zeros(4, dtype=torch.int64, device="cuda"))
    executor.fused_step_for(params, warm)
    del warm

    class Stall(ChaosExecutor):
        """Stalls a ``stuck_batch`` 1 s past the deadline the engine's
        watchdog will hold that advance to (the engine's own formula on
        its own cost model, for the batch the plan's serial turns out to
        be); ``stalls`` records (deadline, stall) per strike."""
        engine = None

        def _strike(self, rs):
            spec = rs._spec
            if (spec is not None and spec.kind == faults.STUCK_BATCH
                    and not rs._struck and rs._advances >= spec.chunk):
                fl = next(f for f in self.engine._inflight if f.rs is rs)
                steps = rs.num_steps - remaining_steps(rs)
                deadline = self.engine._watchdog_deadline(
                    steps, fl.mb.group, fl.mb.bucket)
                rs._spec = dataclasses.replace(spec, stall_s=deadline + 1.0)
                self.stalls.append({"serial": rs._serial,
                                    "group": fl.mb.group,
                                    "bucket": fl.mb.bucket, "steps": steps,
                                    "deadline_s": deadline,
                                    "stall_s": deadline + 1.0})
            super()._strike(rs)

    def drain(reqs, plan=None, chaos=ChaosExecutor):
        ex = executor
        if plan is not None:
            ex = chaos(executor, plan, mutate_latent=True, mark_flags=False)
            ex.stalls = []
        eng = serve.ServeEngine(
            ex, params, store, max_batch=4, max_inflight=2,
            scheduler="interleave",
            resilience=(ResiliencePolicy(**RESILIENCE_POLICY)
                        if plan is not None else None))
        if plan is not None:
            ex.engine = eng
        t0 = eng.clock.now()
        eng.submit(*[serve.Request(rid=i, seed=seed, policy=pol, label=lab,
                                   arrival=t0)
                     for i, pol, seed, lab in reqs])
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        return eng, time.perf_counter() - w0

    # (a) clean: off (A), on (B), on (B), off (A)
    clean = trace[:8]
    runs = [drain(clean, FaultPlan() if on else None)
            for on in (False, True, True, False)]
    off, on = runs[0][0], runs[1][0]
    same_batches = all([(r.group, r.rids) for r in e.records]
                       == [(r.group, r.rids) for r in off.records]
                       for e, _ in runs)
    bitwise = all(sorted(e.results) == list(range(8)) and all(
        np.array_equal(e.results[i], off.results[i]) for i in range(8))
        for e, _ in runs)
    row_a = {"requests": 8, "walls_ABBA_s": [w for _, w in runs],
             "order": "A B B A (A: resilience off, B: on)",
             "bitwise": bitwise, "same_batches": same_batches,
             "faults": [e.metrics.faults_total for e, _ in runs],
             "batches": len(on.records), "health_reads": on.health_reads,
             "health_reads_per_batch": on.health_reads / len(on.records)}
    check(bitwise and same_batches and row_a["faults"] == [0, 0, 0, 0],
          f"clean drains differ with resilience on: {row_a}")

    # (b) the fixed plan; the first 8 requests are the clean drain's
    mem0 = torch.cuda.memory_allocated()
    graphs0 = len(executor.fused_graphs())
    plan = FaultPlan(faults={
        0: FaultSpec(faults.NAN_LATENT, row=2, chunk=1),
        1: FaultSpec(faults.NAN_LATENT, row=1, chunk=1),
        2: FaultSpec(faults.INJECTED, chunk=1),
        3: FaultSpec(faults.STUCK_BATCH, chunk=1)})
    eng, wall_b = drain(trace[:16], plan, Stall)
    rep = eng.report()
    m = eng.metrics
    last = {}
    for rec in eng.records:                  # a rid's delivering record is
        for rid in rec.rids:                 # its last one
            last[rid] = rec
    groups = {r.group for r in eng.records}
    batches0 = eng.executor.serial
    static_rids = [i for i, pol, _, _ in trace[:8] if pol == static]
    survivors = [r for r in static_rids if r != static_rids[1]]
    surv_diff = max(float(np.abs(eng.results[r] - off.results[r]).max())
                    for r in survivors)
    adaptive_split = [r for r in eng.records if r.group == adaptive
                      and any("split_retry@" in t for t in r.lineage)]
    replays, mismatched = 0, []
    pipes = {}
    for rec in eng.records:
        if any("split_retry@" in t for t in rec.lineage):
            continue
        e = store.get(rec.group)
        pipe = pipes.setdefault(rec.group, _replay_pipe(cfg, e))
        out = pipe.generate(params, serve.batch_generator(rec.seeds),
                            rec.bucket,
                            label=torch.tensor(rec.labels, device="cuda"),
                            **({"return_decisions": True} if e.adaptive
                               else {}))
        x, dec = out if isinstance(out, tuple) else (out, None)
        x = x.cpu().numpy()
        replays += 1
        rows = [j for j, rid in enumerate(rec.rids) if last[rid] is rec]
        if dec != rec.decisions or not all(
                np.array_equal(x[j], eng.results[rec.rids[j]])
                for j in rows):
            mismatched.append((rec.group, rec.rids))
    row_b = {"requests": 16, "drain_s": wall_b, "served": len(eng.results),
             "goodput": len(eng.results) / 16,
             "goodput_fraction": rep["slo"]["goodput_fraction"],
             "faults": rep["faults"], "row_retries": m.row_retries,
             "stalls": eng.executor.stalls,
             "injected": dict(eng.executor.injected),
             "launched_serials": batches0,
             "records": [(r.group, r.bucket, list(r.lineage))
                         for r in eng.records],
             "static_survivors": survivors,
             "static_survivors_max_abs_vs_clean": surv_diff,
             "adaptive_split_records": len(adaptive_split),
             "adaptive_survivors_finite": all(
                 bool(np.isfinite(eng.results[rid]).all())
                 for r in adaptive_split for rid in r.rids),
             "replays": replays, "replays_bitwise": not mismatched,
             "host_sync_count": executor.host_sync_count,
             "health_reads": eng.health_reads,
             "model_variants": rep["compiles"]["model_variants"],
             "program_budget": rep["program_budget"],
             "new_graphs": executor.fused_graphs()[graphs0:],
             "device_bytes_added": torch.cuda.memory_allocated() - mem0}
    check(sorted(eng.results) == list(range(16)),
          f"fixed plan: served {sorted(eng.results)} of 16")
    check(m.fault_kinds == {faults.NAN_LATENT: 2, faults.INJECTED: 1,
                            faults.STUCK_BATCH: 1},
          f"fixed plan: fault kinds {m.fault_kinds}")
    check(len(row_b["stalls"]) == 1
          and row_b["stalls"][0]["stall_s"] > row_b["stalls"][0][
              "deadline_s"], f"fixed plan: stalls {row_b['stalls']}")
    check(f"{DEGRADED_PREFIX}{adaptive}/tau0" in groups
          and FALLBACK_ENTRY in groups,
          f"fixed plan: no degraded or fallback record in {groups}")
    check(surv_diff == 0.0,
          f"static survivors differ from the clean run: {surv_diff}")
    check(adaptive_split and row_b["adaptive_survivors_finite"],
          "the adaptive batch did not split its NaN row out, or a "
          "survivor is not finite")
    check(not mismatched, f"records differ from generate: {mismatched}")
    check(executor.host_sync_count == 0,
          f"{executor.host_sync_count} decision syncs")
    check(row_b["model_variants"] <= row_b["program_budget"],
          f"{row_b['model_variants']} variants over the budget "
          f"{row_b['program_budget']}")

    # (c) a seeded ramp: 50 / 30 / 20 NaN / stall / error at rate 0.3
    eng, wall_c = drain(trace[16:], FaultPlan(**RESILIENCE_RAMP))
    rep = eng.report()
    m = eng.metrics
    outcomes = {i: eng.outcome(i) for i, _, _, _ in trace[16:]}
    row_c = {"requests": 16, "plan": RESILIENCE_RAMP, "drain_s": wall_c,
             "served": len(eng.results),
             "goodput": len(eng.results) / 16,
             "shed": rep["shed"], "faults": rep["faults"],
             "row_retries": m.row_retries,
             "injected": dict(eng.executor.injected),
             "host_sync_count": executor.host_sync_count}
    check(all(k == "done" or (k == "shed" and (v == "stalled"
                                               or v.startswith("fault:")))
              for k, v in outcomes.values()),
          f"ramp: unresolved requests {outcomes}")
    check(m.faults_total == sum(m.fault_kinds.values()),
          f"ramp: {m.faults_total} faults against {m.fault_kinds}")
    check(executor.host_sync_count == 0, "ramp: decision syncs")
    launches = dict(ops.LAUNCHES)
    emit({"phase": "resilience", "policy": RESILIENCE_POLICY,
          "clean": row_a, "fixed_plan": row_b, "ramp": row_c,
          "launches": launches, "captured": dict(ops.CAPTURED),
          "phase_s": time.perf_counter() - t_phase})
    check(launches["flash_attention"] > 0 and launches["linear"] > 0,
          f"a kernel never launched in the resilience phase: {launches}")
    return launches


def telemetry_phase(cfg, params, ops, store):
    """Step telemetry at full width (phase 15; budget ~15 s): one fused
    batch of 4 on the adaptive artifact with ``telemetry=True`` and
    without, the replays under ``set_sync_debug_mode("error")``: latents,
    decisions and flags bitwise equal, no decision sync, 4 reports whose
    realized decisions are the host loop's, proxies finite from step 1;
    the telemetry graph's capture seconds and device bytes.  Then 8
    requests (adaptive and SmoothCache) through a ``ServeEngine`` with a
    ``Tracer`` and ``telemetry=True``, and with both off: bitwise equal,
    a report per served request, a valid trace."""
    import math
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.obs import Tracer, run_cache_reports, \
        validate_chrome_trace
    t_phase = time.perf_counter()
    entry = store.get(SERVE_ADAPTIVE)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    kw = dict(schedule=entry.schedule, tau=entry.tau,
              proxy_map=entry.proxy_map, pool=entry.pool(),
              k_max=entry.k_max, label=labels)
    n = len(REQUEST_LABELS)
    _reset_counts(ops)

    def gen():
        return torch.Generator().manual_seed(SEED + 19)

    runs, capture = {}, {}
    for on in (False, True):
        rs = executor.start_adaptive_fused_run(params, gen(), n,
                                               telemetry=on, **kw)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        step, wall = _timed(lambda: executor.fused_step_for(params, rs))
        capture[on] = {"warmup_s": step.stats["warmup_s"],
                       "capture_s": step.stats["capture_s"],
                       "wall_s": wall,
                       "device_bytes": torch.cuda.memory_allocated() - mem0}
        torch.cuda.set_sync_debug_mode("error")
        try:
            rs = executor.advance_adaptive_fused(params, rs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        runs[on] = rs
    on, off = runs[True], runs[False]
    _, dh = executor.sample_adaptive(params, gen(), n, return_decisions=True,
                                     **kw)
    host_syncs = executor.host_sync_count
    reps = run_cache_reports(on, n)
    fields = ("x", "trace", "healthy", "acc", "lag")
    row = {"requests": n, "capture": {"off": capture[False],
                                      "telemetry": capture[True]},
           "bitwise": {f: bool(torch.equal(getattr(on, f), getattr(off, f)))
                       for f in fields},
           "decisions_equal": on.decisions == off.decisions == dh,
           "sync_guard": "error", "host_loop_syncs": host_syncs,
           "reports": len(reps),
           "reports_realized_host_loop": all(r.realized == dh
                                             for r in reps),
           "proxy_finite_from_step_1": all(
               all(p is not None and math.isfinite(p) for p in r.proxy[1:])
               for r in reps),
           "proxy_rows": [[round(p, 6) for p in r.proxy[1:6]] for r in reps],
           "graphs": executor.fused_graphs()}
    check(all(row["bitwise"].values()) and row["decisions_equal"],
          f"telemetry changed the run: {row['bitwise']}")
    check(row["reports"] == n and row["reports_realized_host_loop"]
          and row["proxy_finite_from_step_1"],
          "telemetry reports disagree with the host loop or hold a "
          "non-finite proxy")

    # the engine with a tracer and telemetry, and with both off
    rng = np.random.RandomState(SEED + 20)
    reqs = [(i, (SERVE_ADAPTIVE, "smoothcache:alpha=0.18")[i % 2],
             int(rng.randint(1 << 31)), int(rng.randint(cfg.num_classes)))
            for i in range(8)]
    engines = {}
    for obs_on in (True, False):
        clock = serve.WallClock()
        kwe = ({"tracer": Tracer(clock), "telemetry": True} if obs_on
               else {})
        eng = serve.ServeEngine(executor, params, store, clock=clock,
                                max_batch=4, max_inflight=2, **kwe)
        eng.submit(*[serve.Request(rid=i, seed=seed, policy=pol, label=lab)
                     for i, pol, seed, lab in reqs])
        _, wall = _timed(eng.run_until_drained)
        engines[obs_on] = (eng, wall)
    e_on, e_off = engines[True][0], engines[False][0]
    n_events = validate_chrome_trace(e_on.tracer.to_chrome_trace())
    drain_bitwise = sorted(e_on.results) == sorted(e_off.results) == \
        list(range(8)) and all(np.array_equal(e_on.results[i],
                                              e_off.results[i])
                               for i in range(8))
    realized = all(e_on.cache_reports[rid].realized == rec.decisions
                   for rec in e_on.records if rec.decisions
                   for rid in rec.rids)
    launches = dict(ops.LAUNCHES)
    row.update({"engine": {
        "requests": 8, "walls_s": {"tracer_and_telemetry":
                                   engines[True][1],
                                   "both_off": engines[False][1]},
        "bitwise": drain_bitwise,
        "reports": sorted(e_on.cache_reports),
        "reports_realized": realized,
        "trace_events": n_events,
        "host_sync_count": executor.host_sync_count - host_syncs},
        "launches": launches, "captured": dict(ops.CAPTURED),
        "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "telemetry", **row})
    check(drain_bitwise, "the traced telemetry drain differs from the "
          "plain one")
    check(sorted(e_on.cache_reports) == list(range(8)) and realized,
          "a served request has no report, or one realizing other "
          "decisions")
    check(row["engine"]["host_sync_count"] == 0,
          "decision syncs in the telemetry drains")
    check(launches["flash_attention"] > 0 and launches["linear"] > 0,
          f"a kernel never launched in the telemetry phase: {launches}")
    return launches


DURABLE_KILLS = dict(seed=0, kill_rate=0.3, max_kills=4)
DURABLE_MIN_FREE = 4e9        # bytes the snapshot directory must have free


def _free_engine(eng):
    """What a process death frees on the card: the engine's in-flight run
    states and its executor's captured graphs (buffers and memory pool)."""
    eng._inflight.clear()
    eng.executor._fused.clear()
    eng.executor._capture = None
    gc.collect()
    torch.cuda.empty_cache()


def durable_phase(cfg, params, ops, store):
    """Durable serving at full width (phase 16; budget ~60 s): the
    SmoothCache artifact and the adaptive artifact (fused), ``max_batch``
    2, 2 in flight, ``adaptive_chunk`` 4, a wall clock, the fused
    advances under ``set_sync_debug_mode("error")`` (captures and
    checkpoints outside it).  (d) 8 requests with durability off, on, on,
    off at ``checkpoint_every=1`` and one on / off pair at 4: walls,
    overhead, and per run kind the bytes of a snapshot and the seconds of
    its device→host copy, sha256 and file write, with the journal's
    fsyncs; the off drains' rows are the uninterrupted rows below.  (a)
    2 + 2 requests stepped until both batches hold a snapshot, killed; a
    fresh engine on a fresh executor (the old one's graphs freed)
    restores both and finishes bitwise the uninterrupted rows.  (b) the
    same with one snapshot's body byte flipped and the other's entry
    re-registered under a new version: both quarantined with reasons,
    their requests replayed from the start, bitwise.  (c) the 8 requests
    under ``KillPlan(seed=0, kill_rate=0.3, max_kills=4)``, a fresh
    engine and executor per incarnation: 0 lost, rows bitwise, every rid
    ``done`` in a probe recovered from the journal alone, device memory
    at each restart not growing."""
    import shutil

    import numpy as np
    from repro_torch import serve
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.durable import KillPlan, crash, drain_with_kills
    t_phase = time.perf_counter()
    static, adaptive = "smoothcache:alpha=0.18", SERVE_ADAPTIVE
    rng = np.random.RandomState(SEED + 23)
    reqs = [(i, (adaptive, static)[i % 2], int(rng.randint(1 << 31)),
             int(rng.randint(cfg.num_classes))) for i in range(8)]
    _reset_counts(ops)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    free = shutil.disk_usage(tmp).free
    check(free >= DURABLE_MIN_FREE,
          f"{tmp} has {free} bytes free; the durable phase needs "
          f"{DURABLE_MIN_FREE:.0f}")
    costs = {}                               # run kind → checkpoint costs

    def make_store(bump=None):
        dstore = serve.ArtifactStore(cfg, solvers.ddim(50), cfg_scale=1.5)
        for name in (static, adaptive):
            dstore.add_artifact(name, store.get(name).artifact)
        if bump is not None:                 # re-registered: version 2
            dstore.reload(bump, store.get(bump).artifact)
        return dstore

    class Engine(serve.ServeEngine):
        """Fused advances under the sync guard (a new graph's capture
        before it); each checkpoint's bytes and seconds by run kind."""

        def _advance(self, fl):
            if fl.kind != "adaptive_fused":
                return super()._advance(fl)
            self.executor.fused_step_for(self.params, fl.rs)
            torch.cuda.set_sync_debug_mode("error")
            try:
                super()._advance(fl)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def _checkpoint(self, fl):
            t0 = dict(self._snapshots.timings)
            b0, n0 = self.metrics.checkpoint_bytes, self.metrics.checkpoints
            super()._checkpoint(fl)
            row = costs.setdefault(fl.kind, {"snapshots": 0, "bytes": 0})
            row["snapshots"] += self.metrics.checkpoints - n0
            row["bytes"] += self.metrics.checkpoint_bytes - b0
            for k, v in self._snapshots.timings.items():
                row[k] = row.get(k, 0.0) + v - t0.get(k, 0.0)

    def engine(ex, dstore=None, sub=None, **kw):
        dur = {}
        if sub is not None:
            dur = dict(journal=str(Path(tmp) / sub / "journal.jsonl"),
                       snapshot_dir=str(Path(tmp) / sub / "snapshots"))
        return Engine(ex, params, dstore or make_store(), max_batch=2,
                      max_inflight=2, adaptive_chunk=4, **dur, **kw)

    def submit(eng, rows):
        t0 = eng.clock.now()
        eng.submit(*[serve.Request(rid=i, seed=seed, policy=pol, label=lab,
                                   arrival=t0) for i, pol, seed, lab in rows])

    def executor():
        return SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)

    def bitwise(results, rids):
        return (sorted(results) == sorted(rids) and max(
            float(np.abs(results[i] - clean[i]).max()) for i in rids) == 0.0)

    # (d) what durability costs: off, on, on, off at checkpoint_every=1,
    # then on, off at 4; one executor, its bucket-2 graph captured first
    ex = executor()
    warm = engine(ex)
    submit(warm, reqs[:2])
    warm.run_until_drained()
    drains, syncs = [], []
    for on, every in ((False, 1), (True, 1), (True, 1), (False, 1),
                      (True, 4), (False, 4)):
        costs.clear()
        eng = engine(ex, sub=f"d{len(drains)}" if on else None,
                     checkpoint_every=every)
        submit(eng, reqs)
        _, wall = _timed(eng.run_until_drained)
        row = {"durability": on, "checkpoint_every": every, "wall_s": wall,
               "checkpoints": eng.metrics.checkpoints,
               "checkpoint_bytes": eng.metrics.checkpoint_bytes}
        if on:
            row.update(fsyncs=eng.journal.synced,
                       fsync_s=eng.journal.sync_s,
                       by_kind={k: dict(v) for k, v in costs.items()})
        drains.append(row)
        syncs.append(ex.host_sync_count)
        if not on and every == 1:
            if len(drains) == 1:
                clean = dict(eng.results)
            check(bitwise(eng.results, [r[0] for r in reqs]),
                  "two durability-off drains differ")
        else:
            check(bitwise(eng.results, [r[0] for r in reqs]),
                  f"a drain with durability on differs: {row}")
    walls = [d["wall_s"] for d in drains]
    per_kind = {}
    for kind in ("plan", "adaptive_fused"):
        rows = [d["by_kind"][kind] for d in drains[1:3]
                if kind in d["by_kind"]]
        n = sum(r["snapshots"] for r in rows)
        check(n > 0, f"no {kind} snapshot in the durable drains")
        per_kind[kind] = {"snapshots": n,
                          "bytes_per_snapshot": sum(r["bytes"]
                                                    for r in rows) / n}
        for k in ("sync_s", "copy_s", "hash_s", "write_s"):
            per_kind[kind][k + "_per_snapshot"] = sum(
                r.get(k, 0.0) for r in rows) / n
    off1, on1 = (walls[0] + walls[3]) / 2, (walls[1] + walls[2]) / 2
    row_d = {"requests": 8, "walls_s": walls,
             "order": "off, on, on, off at checkpoint_every=1; on, off at 4",
             "drains": drains, "per_kind": per_kind,
             "overhead_every_1": (on1 - off1) / off1,
             "overhead_every_4": (walls[4] - walls[5]) / walls[5],
             "host_sync_count": ex.host_sync_count}
    check(ex.host_sync_count == 0, f"decision syncs: {syncs}")
    _free_engine(warm)
    del warm, eng, ex

    # (a) kill with a static and a fused batch in flight, restore, finish
    def kill_midflight(sub):
        ex = executor()
        eng = engine(ex, sub=sub)
        submit(eng, reqs[:4])
        for _ in range(64):
            if (len(eng._inflight) == 2 and len(eng._snapshots.live()) == 2
                    and all(not fl.rs.done for fl in eng._inflight)):
                break
            eng.step()
        kinds = sorted(fl.kind for fl in eng._inflight)
        steps = [int(fl.rs.step) for fl in eng._inflight]
        check(len(eng._snapshots.live()) == 2,
              f"{sub}: no snapshot of both batches ({kinds}, {steps})")
        crash(eng)
        _free_engine(eng)
        return kinds, steps

    kinds, steps = kill_midflight("a")
    mem0 = torch.cuda.memory_allocated()
    ex = executor()
    eng = engine(ex, sub="a")
    summary = eng.recover()
    _, wall = _timed(eng.run_until_drained)
    rids = [r[0] for r in reqs[:4]]
    diff = max(float(np.abs(eng.results[i] - clean[i]).max()) for i in rids)
    row_a = {"requests": 4, "killed_kinds": kinds, "killed_at_steps": steps,
             "summary": summary, "drain_s": wall, "max_abs_vs_clean": diff,
             "lineage": [list(r.lineage) for r in eng.records],
             "host_sync_count": ex.host_sync_count,
             "device_bytes_before_restart": mem0}
    check(summary["restored_runs"] == 2 and summary["replayed"] == 0
          and not summary["refused"], f"(a) recover: {summary}")
    check(kinds == ["adaptive_fused", "plan"], f"(a) in flight: {kinds}")
    check(bitwise(eng.results, rids), f"(a) restored rows differ: {diff}")
    check(ex.host_sync_count == 0, "(a) decision syncs")
    _free_engine(eng)
    del eng, ex

    # (b) one snapshot torn by a flipped body byte, the other's entry
    # re-registered under a new version
    kill_midflight("b")
    sdir = Path(tmp) / "b" / "snapshots"
    for path in sorted(sdir.iterdir()):
        if ckpt_io.read_meta(str(path))["kind"] == "plan":
            raw = bytearray(path.read_bytes())
            raw[-1] ^= 0xFF
            path.write_bytes(bytes(raw))
    dstore = make_store(bump=adaptive)
    ex = executor()
    eng = engine(ex, dstore, sub="b")
    summary = eng.recover()
    eng.run_until_drained()
    reasons = {q: dstore.health.quarantine_reason(f"snapshot:{q}")
               for q, _ in summary["refused"]}
    row_b = {"summary": summary, "health": reasons,
             "quarantined_files": sorted(p.name for p in sdir.iterdir()),
             "max_abs_vs_clean": max(float(np.abs(
                 eng.results[i] - clean[i]).max()) for i in rids)}
    check(summary["restored_runs"] == 0 and summary["replayed"] == 4
          and len(summary["refused"]) == 2, f"(b) recover: {summary}")
    check(all(reasons[q] == r for q, r in summary["refused"])
          and any("CheckpointError" in r for r in reasons.values())
          and any("provenance drift on version" in r
                  for r in reasons.values()),
          f"(b) quarantine reasons: {reasons}")
    check(bitwise(eng.results, rids), "(b) replayed rows differ")
    _free_engine(eng)
    del eng, ex

    # (c) the kill ramp: a fresh engine and executor per incarnation
    incarnations, live = [], {}

    def factory():
        old = live.pop("eng", None)
        if old is not None:
            incarnations[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
            _free_engine(old)
        torch.cuda.reset_peak_memory_stats()
        incarnations.append({"start_bytes": torch.cuda.memory_allocated()})
        live["eng"] = engine(executor(), sub="c")
        return live["eng"]

    first = factory()
    submit(first, reqs)
    crash(first)
    plan = KillPlan(**DURABLE_KILLS)
    t0 = time.perf_counter()
    rep = drain_with_kills(factory, plan)
    ramp_s = time.perf_counter() - t0
    incarnations[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
    final = rep.engine.report()["durable"]
    probe = factory()
    probe.recover()
    outcomes = {r[0]: probe.outcome(r[0])[0] for r in reqs}
    starts = [m["start_bytes"] for m in incarnations[:-1]]
    row_c = {"requests": 8, "plan": DURABLE_KILLS, "restarts": rep.restarts,
             "kill_ticks": sorted(t for t, hit in plan._memo.items() if hit),
             "ticks": rep.ticks, "ramp_s": ramp_s,
             "delivered": len(rep.delivered),
             "max_abs_vs_clean": max(float(np.abs(
                 rep.delivered[i] - clean[i]).max()) for i in rep.delivered),
             "final_durable": final, "probe_outcomes": outcomes,
             "incarnations": incarnations[:-1]}
    check(rep.restarts == DURABLE_KILLS["max_kills"],
          f"(c) {rep.restarts} restarts")
    check(bitwise(rep.delivered, [r[0] for r in reqs]),
          f"(c) lost or changed rows: {sorted(rep.delivered)}")
    check(all(v == "done" for v in outcomes.values()),
          f"(c) probe outcomes: {outcomes}")
    check(max(starts) - starts[0] <= 64 << 20,
          f"(c) device memory grew across restarts: {starts}")
    _free_engine(probe)
    del probe, first, rep, live
    shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(ops.LAUNCHES)
    emit({"phase": "durable", "costs": row_d, "restore": row_a,
          "refusals": row_b, "kill_ramp": row_c, "launches": launches,
          "captured": dict(ops.CAPTURED),
          "phase_s": time.perf_counter() - t_phase})
    check(launches["flash_attention"] > 0 and launches["linear"] > 0,
          f"a kernel never launched in the durable phase: {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core import cuda_graphs, diffusion
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref, ssd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        builds = {m.__name__.rsplit(".", 1)[-1]: pool.submit(m.build)
                  for m in (fa, ssd, gemm, cuda_graphs)}
        builds = {k: f.result() for k, f in builds.items()}
    emit({"phase": "build",
          "seconds": {k: r["seconds"] for k, r in builds.items()},
          "wall_s": time.perf_counter() - t0})
    sass_phase({k: r["path"] for k, r in builds.items()})
    cfg = configs.get("dit-xl-256")
    kernels = {"flash_attention": kernel_phase(fa, ref, peaks),
               "ssd": ssd_kernel_phase(ssd, ref, peaks),
               "linear": gemm_kernel_phase(gemm, ref, peaks, cfg)}

    t0 = time.perf_counter()
    params_cpu = full_width_params(cfg)
    params_gpu = tree_map(lambda a: a.cuda(), params_cpu)
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    # the token products' split weights, made once before anything is
    # timed or captured
    t0 = time.perf_counter()
    prepared = diffusion.prepare_linear(params_gpu)
    torch.cuda.synchronize()
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": params_s,
          "count": sum(a.numel() for a in tree_leaves(params_cpu)),
          "linear_prepared_bytes": prepared,
          "linear_prepare_s": time.perf_counter() - t0,
          "device_bytes": torch.cuda.memory_allocated()})
    check(prepared == 2 * 4 * sum(
        w.numel() for w in diffusion.token_weights(params_gpu)),
        f"{prepared} prepared bytes")
    kernels["linear"]["prepared_bytes"] = prepared
    cross_check_phase(cfg, diffusion, params_cpu, params_gpu)
    del params_cpu
    dit_profile_phase(cfg, diffusion, params_gpu, ops)

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    _, smooth_art = slice_phase(cfg, params_gpu, ops)
    dit_launches = dict(ops.LAUNCHES)
    path = attention_path(cfg, diffusion, fa, params_gpu)
    emit({"phase": "slice", "launches": dit_launches, "attention_path": path,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    check(dit_launches["ssd"] == 0, "SSD launched in the DiT slice")
    check(path == {"arith": "3xtf32-mma.sync", "load": "cp.async"},
          f"the DiT slice's attention takes {path}")
    kernels["flash_attention"]["launches"] = dit_launches["flash_attention"]
    kernels["linear"]["launches"] = dit_launches["linear"]
    for rows in gemm.ROWS:
        kernels["linear"]["variants"][rows]["launches"] = \
            dit_launches["linear_" + rows]
    check(all(dit_launches["linear_" + rows] > 0 for rows in gemm.ROWS),
          f"a linear variant never launched in the DiT slice: "
          f"{dit_launches}")
    serve_launches, serve_calls, store = serve_phase(cfg, params_gpu, ops,
                                                     smooth_art)
    kernels["flash_attention"]["serve_launches"] = serve_launches
    kernels["flash_attention"]["serve_calls"] = serve_calls
    fused = fused_phase(cfg, params_gpu, ops, store)
    kernels["flash_attention"]["fused_captured_per_graph"] = \
        fused["captured_launches_per_graph"]
    kernels["flash_attention"]["fused_replayed"] = fused["replayed_launches"]
    continuous_phase(cfg, params_gpu, ops, store)
    slo_phase(cfg, params_gpu, ops, store)
    for name, phase in (("resilience", resilience_phase),
                        ("telemetry", telemetry_phase),
                        ("durable", durable_phase)):
        launches = phase(cfg, params_gpu, ops, store)
        kernels["flash_attention"][name + "_launches"] = \
            launches["flash_attention"]
        kernels["linear"][name + "_launches"] = launches["linear"]
    del params_gpu, store
    gemm.release()            # the prepared halves hold the DiT weights
    gc.collect()              # the DiT weights go before the Mamba phases

    cfg = configs.get("mamba2-1.3b")
    t0 = time.perf_counter()
    params_cpu = serve.init_params(torch.Generator().manual_seed(SEED), cfg,
                                   device="cpu")
    params_gpu = tree_map(lambda a: a.cuda(), params_cpu)
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params_cpu))})
    lm_cross_check_phase(cfg, T, params_cpu, params_gpu)
    del params_cpu
    prompts, toks, lm_launches = lm_slice_phase(cfg, T, serve, params_gpu,
                                                ops)
    kernels["ssd"]["launches"] = lm_launches["ssd"]
    lm_decode_consistency_phase(cfg, T, params_gpu, prompts, toks)
    lm_profile_phase(cfg, T, params_gpu, prompts, toks)

    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
