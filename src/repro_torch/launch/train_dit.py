"""DiT training on synthetic latents, then a sample from the checkpoint:
the JAX package's ``benchmarks/common.py::train_small_dit`` and
``examples/train_dit.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_dit --steps 300 \\
        --ckpt results/dit.ckpt [--arch dit-xl-256] [--device cpu]

The loss is ε-prediction (``eps_loss``), or rectified flow (``rf_loss``)
for OpenSora; the data class-conditional blobs (``BlobLatents``), or
text-conditioned latents (``CondLatents``) for a config without classes.
AdamW with no weight decay and ``cosine_schedule(10, steps)``.  Each
step's t and noise come from a generator for (seed, step), so that a run
resumed at a step draws what the uninterrupted run drew.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import diffusion, solvers
from repro_torch.core.executor import SmoothCacheExecutor
from repro_torch.data.synthetic import BlobLatents, CondLatents, step_generator
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import adamw

#: the text-memory length of ``CondLatents`` in the examples
COND_LEN = 8


def batch_at(data, step: int, device):
    """(x0, {"label": …} or {"memory": …}) of ``data`` at ``step``."""
    x0, cond = data.batch_at(step, device=device)
    return x0, ({"label": cond} if isinstance(data, BlobLatents)
                else {"memory": cond})


def dit_loss(cfg, *, loss_kind: str = "eps"):
    """``loss(params, x0, gen, **cond)``: the ε loss on the VP schedule
    or, for ``loss_kind == "rf"``, the rectified-flow loss; ``gen`` draws
    t and the noise."""
    sched = diffusion.vp_schedule()

    def loss(params, x0, gen, **cond):
        if loss_kind == "rf":
            return diffusion.rf_loss(cfg, params, gen, x0, **cond)
        return diffusion.eps_loss(cfg, params, gen, x0, sched=sched, **cond)

    return loss


def make_dit_step(cfg, opt_cfg: adamw.AdamWConfig, *, loss_kind: str = "eps"):
    """``step(params, opt_state, x0, gen, **cond)`` → (loss, metrics): the
    gradient of :func:`dit_loss` (through the kernels' forwards on a card)
    and one AdamW update of params and opt_state in place."""
    loss_fn = dit_loss(cfg, loss_kind=loss_kind)

    def step(params, opt_state, x0, gen, **cond):
        loss, grads = adamw.value_and_grad(
            lambda p: loss_fn(p, x0, gen, **cond), params)
        _, _, metrics = adamw.apply_updates(opt_cfg, params, grads, opt_state)
        return loss, metrics

    return step


def train_dit(cfg, gen: torch.Generator, steps: int = 150, batch: int = 16,
              lr: float = 2e-3, data=None, loss_kind: str = "eps",
              device=None):
    """Train ``cfg`` from seeded weights (``gen``) for ``steps`` steps.
    Returns ``(params, sched, losses)``, the losses as floats (one host
    read at the end)."""
    dev = resolve_device(device)
    params = diffusion.init_params(gen, cfg, device=dev)
    sched = diffusion.vp_schedule()
    if data is None:
        data = BlobLatents(cfg.latent_shape, max(cfg.num_classes, 1), batch)
    opt_cfg = adamw.AdamWConfig(lr=lr, weight_decay=0.0,
                                schedule=adamw.cosine_schedule(10, steps))
    opt_state = adamw.init_state(params)
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    step = make_dit_step(cfg, opt_cfg, loss_kind=loss_kind)
    losses = []
    for i in range(steps):
        x0, cond = batch_at(data, i, dev)
        loss, _ = step(params, opt_state, x0, step_generator(seed, i), **cond)
        losses.append(loss)
    return params, sched, torch.stack(losses).tolist()


def sample_check(cfg, params, data, kind: str, device, n: int = 4):
    """``n`` latents from the port's executor (DDIM 50, or rectified flow
    30 for ``kind == "rf"``; CFG 1.5 with classes): (latents, finite)."""
    solver = solvers.rectified_flow(30) if kind == "rf" else solvers.ddim(50)
    ex = SmoothCacheExecutor(cfg, solver,
                             cfg_scale=1.5 if cfg.num_classes else None,
                             device=device)
    if cfg.num_classes:
        cond = {"label": torch.arange(n, device=device) % cfg.num_classes}
    else:
        cond = {"memory": batch_at(data, 0, device)[1]["memory"][:n]}
    x = ex.sample(params, torch.Generator().manual_seed(1), n, **cond)
    return x, bool(torch.isfinite(x).all())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="dit-xl-256")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt", default="results/repro_torch_dit.ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, args.variant)
    kind = "rf" if args.arch.startswith("opensora") else "eps"
    if cfg.num_classes:
        data = BlobLatents(cfg.latent_shape, cfg.num_classes, args.batch)
    else:
        data = CondLatents(cfg.latent_shape, cfg.cond_dim, COND_LEN,
                           args.batch)
    print(f"[train_dit] {cfg.name}: {cfg.num_layers} blocks, latents "
          f"{cfg.latent_shape}, {args.steps} steps on {dev}")
    params, _, losses = train_dit(
        cfg, torch.Generator().manual_seed(0), steps=args.steps,
        batch=args.batch, lr=args.lr, data=data, loss_kind=kind, device=dev)
    tail = losses[-20:]
    print(f"[train_dit] loss: {losses[0]:.4f} → {sum(tail) / len(tail):.4f} "
          "(last-20 mean)")
    ckpt_io.save(args.ckpt, {"params": params},
                 {"arch": args.arch, "steps": args.steps, "kind": kind})
    print(f"[train_dit] saved {args.ckpt}")
    tree, _ = ckpt_io.restore(args.ckpt)
    restored = tree_map(lambda a: a.to(dev), tree["params"])
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in
               zip(tree_leaves(params), tree_leaves(restored)))
    x, finite = sample_check(cfg, restored, data, kind, dev)
    print(f"[train_dit] restored ≡ trained: {same}; sampled "
          f"{tuple(x.shape)}, finite={finite}")
    if not (same and finite and all(map(math.isfinite, losses))):
        raise SystemExit("train_dit: a non-finite loss or sample, or the "
                         "checkpoint did not round-trip")
    return params, losses


if __name__ == "__main__":
    main()
