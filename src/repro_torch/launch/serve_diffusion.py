"""End-to-end diffusion serving from the command line — a thin CLI over
``repro_torch.serve``.

A calibration pass runs once and saves ``CacheArtifact``s (curves +
resolved schedule + plan + provenance); the serving side *loads* them into
an ``ArtifactStore`` — it never recalibrates — and drains an open-loop
queue of generation requests with synthetic Poisson arrivals through the
``ServeEngine``: power-of-two micro-batch buckets per store entry,
step-interleaved scheduling over the executor's resumable runs, the
segmented path for static entries and the fused on-device path for
adaptive ones (no per-step decision sync: the report's ``host syncs``
stay 0), and ``--eager`` for the reference sampler.

Three scenarios share one arrival trace: every request on ``no_cache``,
every request on the calibrated policy, and a heterogeneous queue mixing
both with an adaptive policy.  The report separates p50/p95 queue wait
from service time.

    python -m repro_torch.launch.serve_diffusion --device cpu \\
        --requests 8 --batch 4 --steps 10 --rate 20 --max-wait 0.05

The weights are random, drawn from ``--seed`` (every zero-initialized
adaLN-zero leaf gets N(0,1)/√fan_in so that every block contributes), or
loaded from ``--params``: an ``.npz`` of ``convert.flatten_params`` paths.
Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from repro_torch import configs, resolve_device, serve
from repro_torch.cache import DiffusionPipeline, registry
from repro_torch.convert import params_from_npz
from repro_torch.core import diffusion, solvers
from repro_torch.core.executor import SmoothCacheExecutor
from repro_torch.models.transformer import tree_map

CFG_SCALE = 1.5


def random_params(gen: torch.Generator, cfg, *, device=None):
    """Seeded DiT parameters on ``device`` (default ``cuda``), drawn on the
    generator's device (a CPU generator gives the same parameters on every
    device; a CUDA generator draws on the card).  The adaLN-zero init
    zeroes the modulation and output layers, which would make every
    prediction 0: each zero-initialized leaf gets N(0,1)/√fan_in, so all
    blocks contribute and activations stay finite."""
    dev = resolve_device(device)
    params = diffusion.init_params(gen, cfg, device=gen.device)

    def perturb(a):
        if bool((a == 0).all()):
            fan_in = a.shape[-2] if a.dim() >= 2 else cfg.d_model
            a = a.to(gen.device) + torch.randn(
                a.shape, generator=gen, device=gen.device) / math.sqrt(fan_in)
        return a.to(dev)

    return tree_map(perturb, params)


def adaptive_spec_for(policy: str, tau: float) -> str:
    """``adaptive:base=<policy>,tau=<tau>`` in the registry grammar."""
    base = policy.replace(":", "(", 1) + (")" if ":" in policy else "")
    return f"adaptive:base={base},tau={tau:g}"


def make_requests(n, policies, rng, cfg, rate):
    """Open-loop trace: Poisson arrivals, random labels/seeds, policies
    assigned round-robin (the heterogeneous case passes several)."""
    arrivals = serve.poisson_arrivals(rate, n, rng)
    return [serve.Request(
        rid=i, seed=int(rng.randint(1 << 30)),
        policy=policies[i % len(policies)],
        label=int(rng.randint(cfg.num_classes)),
        arrival=a) for i, a in enumerate(arrivals)]


def serve_scenario(name, policies, *, executor, params, store, args, cfg):
    """Drain one Poisson trace; returns the engine report."""
    rng = np.random.RandomState(0)      # one trace across scenarios
    eng = serve.ServeEngine(
        executor, params, store, max_batch=args.batch,
        max_wait=args.max_wait, max_inflight=args.max_inflight,
        eager=args.eager)
    syncs = executor.host_sync_count
    t0 = eng.clock.now()
    reqs = make_requests(args.requests, policies, rng, cfg, args.rate)
    for r in reqs:
        r.arrival += t0
    eng.submit(*reqs)
    eng.run_until_drained()
    rep = eng.report()
    qw, sv = rep["queue_wait_s"], rep["service_s"]
    print(f"[serve] {name:16s}: {rep['requests']} req "
          f"{rep['throughput_rps']:6.2f} req/s | "
          f"queue p50/p95 {qw['p50']:.2f}/{qw['p95']:.2f}s | "
          f"service p50/p95 {sv['p50']:.2f}/{sv['p95']:.2f}s | "
          f"compute {rep['compute_fraction']:.2f} | "
          f"model variants {rep['compiles']['model_variants']}"
          f"≤{rep['program_budget']} | "
          f"graphs {rep['compiles']['graphs']['total']} | "
          f"host syncs {executor.host_sync_count - syncs}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dit-xl-256")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8,
                    help="max micro-batch bucket (power of two)")
    ap.add_argument("--policy", default="smoothcache:alpha=0.18",
                    help="calibrated policy spec for the static artifact")
    ap.add_argument("--tau", type=float, default=0.3,
                    help="adaptive threshold for the mixed-queue scenario")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--max-wait", type=float, default=0.5,
                    help="batching window before a partial bucket forms")
    ap.add_argument("--max-inflight", type=int, default=2)
    ap.add_argument("--eager", action="store_true",
                    help="escape hatch: serve on the eager reference "
                         "sampler instead of the segmented path")
    ap.add_argument("--artifact-dir", default="results",
                    help="directory for calibration artifacts")
    ap.add_argument("--params", default=None,
                    help=".npz of convert.flatten_params paths (default: "
                         "random weights from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    registry.get(args.policy)              # fail fast on a bad spec
    adaptive_spec = adaptive_spec_for(args.policy, args.tau)
    cfg = configs.get(args.arch, args.variant)
    params = (params_from_npz(args.params, device=dev) if args.params
              else random_params(torch.Generator().manual_seed(args.seed),
                                 cfg, device=dev))

    # --- calibration: once, saved as artifacts ------------------------------
    os.makedirs(args.artifact_dir, exist_ok=True)
    labels = torch.arange(8, device=dev) % cfg.num_classes
    paths = {}
    for kind, spec in [("static", args.policy), ("adaptive", adaptive_spec)]:
        calib = DiffusionPipeline(cfg, solvers.ddim(args.steps), spec,
                                  cfg_scale=CFG_SCALE, device=dev)
        calib.calibrate(params, torch.Generator().manual_seed(args.seed + 1),
                        8, cond_args={"label": labels})
        paths[kind] = calib.save_artifact(os.path.join(
            args.artifact_dir, f"serve_{cfg.name}.{kind}.cache.json"))
        print(f"[serve] saved {paths[kind]}")

    # --- serving: load, validate, never recalibrate -------------------------
    solver = solvers.ddim(args.steps)
    executor = SmoothCacheExecutor(cfg, solver, cfg_scale=CFG_SCALE,
                                   device=dev)
    store = serve.ArtifactStore(cfg, solver, cfg_scale=CFG_SCALE)
    store.add_policy("no_cache", "none")
    store.add_artifact(args.policy, paths["static"])
    store.add_artifact(adaptive_spec, paths["adaptive"])
    print("[serve] " + store.summary().replace("\n", "\n[serve] "))
    for name, policies in [
            ("no_cache", ["no_cache"]),
            (args.policy, [args.policy]),
            ("mixed+adaptive", ["no_cache", args.policy, adaptive_spec])]:
        serve_scenario(name, policies, executor=executor, params=params,
                       store=store, args=args, cfg=cfg)


if __name__ == "__main__":
    main()
