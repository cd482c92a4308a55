"""Drive the PyTorch port (``src/repro_torch``) once on one CUDA card and
check every phase.  Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernel from the checkout's sources;
3. the flash-attention kernel against its plain PyTorch version at the
   DiT-XL/2 shape and over the kernel test sweep, with times (CUDA events);
4. a full-width DiT-XL/2 denoiser forward on the card (kernel attention)
   against the same forward on the CPU (plain attention);
5. the slice: full-width DiT-XL/2, DDIM 50, cfg_scale 1.5 — calibrate on 10
   samples, save the artifact, load it strictly into a fresh pipeline and
   answer 4 requests with no cache, the artifact's SmoothCache schedule and
   ``static:n=2``; every latent finite, kernel launches = 28 × attention
   steps computed, segmented ≡ eager bitwise.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
The weights are random (seeded); depth and widths are DiT-XL/2's.
"""
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
REQUEST_LABELS = [207, 360, 387, 974]
# Published peaks per card (NVIDIA H100 data sheet: FP32 outside the tensor
# cores, HBM bandwidth), keyed by the name nvidia-smi reports.
PEAKS = {"H100 80GB HBM3": (67e12, 3.35e12),      # SXM5
         "H100 PCIe": (51e12, 2.0e12),
         "H100 NVL": (60e12, 3.9e12)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def median_ms(fn, iters=50, warmup=5):
    """Median over ``iters`` launches, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    marks = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


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
    """Kernel vs plain at the DiT-XL/2 shape and over the sweep."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(SEED)

    def qkv(b, l, h, kv, d, dtype):
        return [torch.randn(shape, generator=gen).to("cuda", dtype)
                for shape in ((b, l, h, d), (b, l, kv, d), (b, l, kv, d))]

    sweep = []
    cases = ([((2, 64, 4, 4, 32), True, None, None),
              ((2, 64, 4, 1, 32), True, None, None),
              ((1, 96, 8, 2, 64), True, None, None),
              ((1, 128, 16, 8, 64), True, None, None),
              ((2, 40, 4, 2, 16), True, None, None)]
             + [((2, 64, 4, 2, 32),) + m for m in (
                 (True, 16, None), (True, None, 50.0), (False, None, None),
                 (True, 8, 30.0))])
    for shape, causal, window, softcap in cases:
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 5e-2)):
            q, k, v = qkv(*shape, dtype)
            kw = dict(causal=causal, window=window, softcap=softcap)
            out = fa.flash_attention_cuda(q, k, v, **kw).float()
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            ok = bool(torch.allclose(out, want, atol=tol, rtol=tol))
            sweep.append({"shape": shape, "causal": causal, "window": window,
                          "softcap": softcap, "dtype": str(dtype)[6:],
                          "max_abs_err": err, "ok": ok})
            check(ok, f"kernel vs plain {sweep[-1]}")
    emit({"sweep": sweep})

    b, l, h, d = 8, 256, 16, 72          # DiT-XL/2: 2 x 4 requests under CFG
    q, k, v = qkv(b, l, h, h, d, torch.float32)
    out = fa.flash_attention_cuda(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
          f"kernel vs plain at the DiT-XL/2 shape: max abs err {err}")
    ms = median_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=False))
    plain_ms = median_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                         causal=False))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4 * b * h * l * l * d
    nbytes = 4 * q.numel() * q.element_size()
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "shape": [b, l, h, h, d], "dtype": "float32", "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "flops": flops, "bytes": nbytes}


def full_width_params(cfg, diffusion):
    """Seeded full-width parameters on the CPU.  The adaLN-zero init zeroes
    the modulation and output layers, which would make every prediction 0:
    each zero-initialized leaf gets N(0,1)/√fan_in, so all 28 blocks
    contribute and activations stay finite."""
    from repro_torch.models.transformer import tree_map
    gen = torch.Generator().manual_seed(SEED)
    params = diffusion.init_params(gen, cfg, device="cpu")

    def perturb(a):
        if bool((a == 0).all()):
            fan_in = a.shape[-2] if a.dim() >= 2 else cfg.d_model
            a = a + torch.randn(a.shape, generator=gen) / math.sqrt(fan_in)
        return a

    return tree_map(perturb, params)


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
    return runs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core import diffusion
    from repro_torch.kernels import flash_attention as fa, ops, ref
    from repro_torch.models.transformer import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card()
    info = fa.build()
    emit({"phase": "build", "kernel": "flash_attention",
          "seconds": info["seconds"]})
    kernel = kernel_phase(fa, ref, peaks)

    cfg = configs.get("dit-xl-256")
    t0 = time.perf_counter()
    params_cpu = full_width_params(cfg, diffusion)
    params_gpu = tree_map(lambda a: a.cuda(), params_cpu)
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params_cpu))})
    cross_check_phase(cfg, diffusion, params_cpu, params_gpu)
    del params_cpu

    ops.LAUNCHES["flash_attention"] = 0
    torch.cuda.reset_peak_memory_stats()
    slice_phase(cfg, params_gpu, ops)
    kernel["launches"] = ops.LAUNCHES["flash_attention"]
    emit({"phase": "slice", "peak_device_bytes":
          torch.cuda.max_memory_allocated()})
    emit({"kernels": [kernel]})
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
