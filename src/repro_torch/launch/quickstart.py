"""Quickstart: SmoothCache end to end on trained weights — the JAX
package's ``examples/quickstart.py``.

1. train the smoke DiT on class-conditional synthetic latents (150 steps),
2. run one 10-sample calibration pass through ``DiffusionPipeline`` (DDIM
   50, CFG 1.5) — a serializable ``CacheArtifact``,
3. sweep cache policies by spec string (Eq. 4 α-schedules and FORA static
   intervals) against ``no_cache``,
4. report each policy's ms a batch, speedup, Fréchet distance to held-out
   latents and compute fraction.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.cache import DiffusionPipeline
from repro_torch.core import solvers
from repro_torch.data.synthetic import BlobLatents
from repro_torch.launch.train_dit import train_dit

POLICIES = ("smoothcache:alpha=0.08", "smoothcache:alpha=0.18",
            "static:n=2", "static:n=3")


def time_call(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall time a call in microseconds, each call ended by
    ``torch.cuda.synchronize()`` on a card."""
    def run():
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out

    for _ in range(warmup):
        run()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def frechet_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Fréchet distance between two sample sets on flattened features, with
    diagonal covariances (stable for small sample counts): the offline FID
    proxy, as no Inception network is available."""
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    mu_a, mu_b = a.mean(0), b.mean(0)
    va, vb = a.var(0) + 1e-8, b.var(0) + 1e-8
    return float(np.sum((mu_a - mu_b) ** 2)
                 + np.sum(va + vb - 2.0 * np.sqrt(va * vb)))


def run(device=None, *, steps: int = 150, batch: int = 16, lr: float = 2e-3,
        samples: int = 32, iters: int = 2, log=print):
    """The protocol; returns ``{"losses", "curves", "rows"}``, a row a
    policy (``no_cache`` first): ``{"policy", "ms", "speedup", "frechet",
    "compute_fraction"}``."""
    dev = resolve_device(device)
    cfg = configs.get("dit-xl-256", "smoke")
    log(f"model: {cfg.name} ({cfg.num_layers} blocks, d={cfg.d_model}, "
        f"latents {cfg.latent_shape}), types={cfg.layer_types()}")
    log("training small DiT on synthetic class-conditional latents ...")
    params, _, losses = train_dit(cfg, torch.Generator().manual_seed(0),
                                  steps=steps, batch=batch, lr=lr,
                                  device=dev)
    log(f"  loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    pipe = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                             cfg_scale=1.5, device=dev)
    label = torch.arange(10, device=dev) % cfg.num_classes
    log("calibration pass (10 samples, 50 DDIM steps) ...")
    artifact = pipe.calibrate(params, torch.Generator().manual_seed(1), 10,
                              cond_args={"label": label})
    for t, c in artifact.curves.items():
        log(f"  {t:5s} lag-1 err: start={c[1, 1]:.3f} "
            f"mid={c[25, 1]:.3f} end={c[-1, 1]:.3f}")

    data = BlobLatents(cfg.latent_shape, cfg.num_classes, samples, seed=7)
    ref_x0, ref_label = data.batch_at(0, device=dev)
    ref_np = ref_x0.cpu().numpy()

    def sample(sch):
        return pipe.generate(params, torch.Generator().manual_seed(3),
                             samples, schedule=sch, label=ref_label)

    rows = []
    base = sample(None)
    t_base = time_call(lambda: sample(None), iters=iters)
    rows.append({"policy": "no_cache", "ms": t_base / 1e3, "speedup": 1.0,
                 "frechet": frechet_distance(base.cpu().numpy(), ref_np),
                 "compute_fraction": 1.0, "finite":
                 bool(torch.isfinite(base).all())})
    for spec in POLICIES:
        sch = pipe.schedule_for(spec)     # resolved against the artifact
        x = sample(sch)
        t = time_call(lambda: sample(sch), iters=iters)
        rows.append({"policy": spec, "ms": t / 1e3, "speedup": t_base / t,
                     "frechet": frechet_distance(x.cpu().numpy(), ref_np),
                     "compute_fraction": float(np.mean(
                         [sch.compute_fraction(ty) for ty in sch.skip])),
                     "finite": bool(torch.isfinite(x).all())})
    log(f"\n{'policy':24s} {'ms/batch':>9s} {'speedup':>8s} "
        f"{'frechet':>9s} {'compute%':>9s}")
    for r in rows:
        log(f"{r['policy']:24s} {r['ms']:9.0f} {r['speedup']:8.2f}x "
            f"{r['frechet']:9.4f} {100 * r['compute_fraction']:8.0f}%")
    return {"losses": losses, "curves": artifact.curves, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    return run(args.device, steps=args.steps)


if __name__ == "__main__":
    main()
