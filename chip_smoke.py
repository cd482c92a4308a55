"""Drive the PyTorch port (``src/repro_torch``) once on one CUDA card and
check every phase.  Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build of both CUDA kernels from the checkout's sources, in parallel,
   and their SASS: tensor-core instructions, registers and local memory
   per flash-attention template instance and per SSD pass (``cuobjdump``);
3. the flash-attention kernel against its plain PyTorch version over the
   kernel test sweep (each case with its arithmetic and load path) and at
   the DiT-XL/2 shape, where two launches must agree bitwise, with device
   times (``repro_torch.kernels.timing``) in f32 and bf16 beside SDPA's;
4. the SSD-scan kernel against its plain PyTorch version over the kernel
   test sweep (f32 and bf16), at the Mamba-2-1.3B prefill shape (where two
   launches must agree bitwise), at a ragged length and on strided views
   of one projection as the model hands them over, with times;
5. a full-width DiT-XL/2 denoiser forward on the card (kernel attention)
   against the same forward on the CPU (plain attention), then a
   ``torch.profiler`` trace of one forward at B = 8: device time by
   kernel, the attention kernel's share, the device's idle share;
6. the DiT slice: full-width DiT-XL/2, DDIM 50, cfg_scale 1.5 — calibrate
   on 10 samples, save the artifact, load it strictly into a fresh pipeline
   and answer 4 requests with no cache, the artifact's SmoothCache schedule
   and ``static:n=2``; every latent finite, kernel launches = 28 × attention
   steps computed, segmented ≡ eager bitwise; the q/k/v that the model's
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
   traced drain).  One served batch per entry replayed through
   ``DiffusionPipeline.generate`` must match bitwise, and the adaptive
   batch replayed at τ = 0 on its own realized decisions gives the per-step
   cost of the host loop's decision sync.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
The weights are random (seeded); depth and widths are DiT-XL/2's and
Mamba-2-1.3B's.
"""
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
# runs a product on the tensor cores
SASS_KERNELS = {"flash_attention": ("attn_fwd",),
                "ssd": ("ssd_cb", "ssd_state", "ssd_out")}


def sass_phase(libs):
    """What the compiler made of each CUDA library: per kernel (template
    instance or SSD pass), tensor-core (HMMA) and f32 FMA (FFMA)
    instructions in the SASS, and registers, stack and local memory from
    the resource usage.  Every kernel runs a product, so every one needs
    HMMA."""
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
                              "ffma": len(re.findall(r"\bFFMA\b", part))}
        for name, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                      res):
            if name in rows:
                rows[name].update({k.lower(): int(v) for k, v in re.findall(
                    r"(REG|STACK|SHARED|LOCAL):(\d+)", usage)})
        emit({"phase": "sass", "kernel": lib, "instances": rows})
        check(all(any(k in name for name in rows) for k in names),
              f"{lib}: a kernel of {names} missing from the SASS")
        check(all(r["hmma"] > 0 for r in rows.values()),
              f"{lib}: a kernel without tensor-core instructions")
        out[lib] = rows
    return out


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
        before = ops.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = serve.generate(params, torch.Generator().manual_seed(SEED + 3),
                           len(REQUEST_LABELS), label=labels, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["flash_attention"] - before
        latents[name] = x
        frac = (1.0 if sch is None else float(sum(
            sch.compute_fraction(t) for t in sch.skip) / len(sch.skip)))
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite latents")
        check(launches == n_attn * attn_steps,
              f"{name}: {launches} kernel launches, expected "
              f"{n_attn} x {attn_steps}")
        base = latents["no_cache"]
        runs.append({"run": name, "requests": len(REQUEST_LABELS),
                     "wall_s": wall, "compute_fraction": frac,
                     "attn_steps": attn_steps, "launches": launches,
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
    """(device µs of every CUDA activity, of those whose name holds
    ``fragment``) from the profiler's raw events, which skips the
    per-event parsing behind ``key_averages`` (slow over a long window)."""
    busy = part = 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            busy += evt.duration_ns()
            if fragment in evt.name():
                part += evt.duration_ns()
    return busy / 1e3, part / 1e3


def dit_profile_phase(cfg, diffusion, params):
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
    wall_us, kern = _traced(
        lambda: diffusion.apply(cfg, params, x, t, label=label))
    busy = sum(us for us, _ in kern.values())
    attn = [v for k, v in kern.items() if "attn_fwd" in k]
    gemm = sum(us for k, (us, _) in kern.items() if "gemm" in k.lower())
    attn_us = sum(us for us, _ in attn)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    row = {"phase": "dit_profile", "batch": 8, "wall_ms": wall_us / 1e3,
           "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
           "attn_ms": attn_us / 1e3, "attn_calls": sum(n for _, n in attn),
           "attn_share": attn_us / busy, "gemm_ms": gemm / 1e3,
           "gemm_share": gemm / busy, "kernels": len(kern),
           "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                   for k, (us, n) in top]}
    emit(row)
    check(busy > 0, "the profiler saw no device time")
    check(row["attn_calls"] == cfg.num_layers,
          f"{row['attn_calls']} attention kernels in one forward, expected "
          f"{cfg.num_layers}")


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
    model call at B = 2 × bucket, 28 kernel launches."""
    if record.decisions is not None:
        return sum("attn" not in d for d in record.decisions)
    return int((~entry.schedule.skip["attn"]).sum())


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
    per = {n: {"launches": 0, "host_syncs": 0} for n in SERVE_ENTRIES}

    class CountingEngine(serve.ServeEngine):
        def _advance(self, fl):
            before = (ops.LAUNCHES["flash_attention"],
                      executor.host_sync_count)
            super()._advance(fl)
            row = per[fl.mb.group]
            row["launches"] += ops.LAUNCHES["flash_attention"] - before[0]
            row["host_syncs"] += executor.host_sync_count - before[1]

    eng = CountingEngine(executor, params, store, max_batch=4,
                         max_inflight=2, scheduler="interleave")
    eng.submit(*reqs)
    eng.run_until_drained()
    return eng, reqs, per


def serve_phase(cfg, params, ops, smooth_art):
    """The serving stack at full width (see the module docstring, phase
    10).  Returns the attention launches of the untraced drain."""
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import schedule as schedule_lib, solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    store, replay = serve_store(cfg, params, smooth_art)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    eng, reqs, per = serve_drain(cfg, params, store, ops, executor)
    launches = dict(ops.LAUNCHES)
    drain_syncs = executor.host_sync_count
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
        emit(row)
        check(row["launches"] == cfg.num_layers * steps,
              f"{name}: {row['launches']} attention launches, expected "
              f"{cfg.num_layers} x {steps}")
        if entry.adaptive:
            check(row["host_syncs"] == sum(r.num_steps - 1 for r in recs),
                  f"{name}: {row['host_syncs']} decision syncs")
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
    # the decision sync's cost: the adaptive batch with its per-step reads
    # (A) against the same batch at τ = 0 on its own realized decisions
    # (B: the same model calls, no reads), in the order A B B A
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

    synced = [replays[SERVE_ADAPTIVE]["wall_s"]]
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

    # a second drain under the profiler (device activity only): the
    # device's idle share
    wall_us, prof = _profiled(lambda: serve_drain(
        cfg, params, store, ops, SmoothCacheExecutor(cfg, solvers.ddim(50),
                                                     cfg_scale=1.5)))
    busy, attn_us = _device_us(prof, "attn_fwd")
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
                            "attn_ms": attn_us / 1e3},
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(rep["compiles"]["model_variants"] <= rep["program_budget"],
          f"{rep['compiles']['model_variants']} model variants over the "
          f"budget {rep['program_budget']}")
    check(busy > 0, "the profiler saw no device time in the serve drain")
    return launches["flash_attention"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core import diffusion
    from repro_torch.kernels import flash_attention as fa, ops, ref, ssd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = {m.__name__.rsplit(".", 1)[-1]: pool.submit(m.build)
                  for m in (fa, ssd)}
        builds = {k: f.result() for k, f in builds.items()}
    emit({"phase": "build",
          "seconds": {k: r["seconds"] for k, r in builds.items()},
          "wall_s": time.perf_counter() - t0})
    sass_phase({k: r["path"] for k, r in builds.items()})
    kernels = {"flash_attention": kernel_phase(fa, ref, peaks),
               "ssd": ssd_kernel_phase(ssd, ref, peaks)}

    cfg = configs.get("dit-xl-256")
    t0 = time.perf_counter()
    params_cpu = full_width_params(cfg)
    params_gpu = tree_map(lambda a: a.cuda(), params_cpu)
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params_cpu))})
    cross_check_phase(cfg, diffusion, params_cpu, params_gpu)
    del params_cpu
    dit_profile_phase(cfg, diffusion, params_gpu)

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
    kernels["flash_attention"]["serve_launches"] = serve_phase(
        cfg, params_gpu, ops, smooth_art)
    del params_gpu

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
