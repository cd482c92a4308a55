"""LM trainer: real steps on one device with checkpointing and the
synthetic token pipeline — the JAX package's ``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen3-14b --variant smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt results/q3.ckpt --device cpu

AdamW at ``--lr`` with ``cosine_schedule(10, steps · 10)``, the loss of
``launch.programs.make_train_step`` without remat, tokens from
``TokenStream`` at each step's index, and for a prefix model (InternVL2,
Llama-4) the ViT patch-embedding stub, for a cross-attention model
(MusicGen) a 16-token text-memory stub, each drawn once.  ``--ckpt``
saves ``{"params", "opt"}`` with ``{"step", "arch"}`` in the port's
checkpoint format (``checkpoint/io.py``); ``--resume`` restores one and
goes on from its step.  The JAX package's ``--production-mesh`` is not
ported: the mesh waits for ``launch/mesh.py``.  Runs on ``cuda`` unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.synthetic import TokenStream, text_memory, \
    vit_patch_embeds
from repro_torch.launch import programs, serve
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import adamw

#: the text-memory stub's length, as the JAX package's trainer draws it
MEMORY_LEN = 16


def extras(cfg, batch: int, device):
    """The prefix embeddings and text memory the config takes, drawn from
    fixed seeds (5 and 6, as the JAX package's trainer keys them)."""
    out = {}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = vit_patch_embeds(
            torch.Generator().manual_seed(5), batch, cfg.num_prefix_embeds,
            cfg.d_model, device=device)
    if cfg.cond_dim:
        out["memory"] = text_memory(torch.Generator().manual_seed(6), batch,
                                    MEMORY_LEN, cfg.cond_dim, device=device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--moe-strategy", default="dense",
                    choices=["dense", "gshard"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, args.variant)
    print(f"[train] {cfg.name}: {cfg.num_layers} layers, "
          f"d_model={cfg.d_model}, device={dev}")
    if args.resume:
        tree, meta = ckpt_io.restore(args.resume)
        params = tree_map(lambda a: a.to(dev), tree["params"])
        opt_state = tree_map(lambda a: a.to(dev), tree["opt"])
        start = meta.get("step", 0)
        print(f"[train] resumed from {args.resume} at step {start}")
    else:
        params = serve.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
        opt_state = adamw.init_state(params)
        start = 0
    n_params = sum(a.numel() for a in tree_leaves(params))
    print(f"[train] params: {n_params / 1e6:.1f}M")

    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=adamw.cosine_schedule(10, args.steps * 10))
    step_fn = programs.make_train_step(cfg, opt_cfg, remat=False,
                                       moe_strategy=args.moe_strategy)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         num_codebooks=cfg.num_codebooks)
    extra = extras(cfg, args.batch, dev)
    losses = []
    for i in range(start, start + args.steps):
        toks, tgts = stream.batch_at(i, device=dev)
        t0 = time.perf_counter()
        params, opt_state, loss, metrics = step_fn(params, opt_state, toks,
                                                   tgts, **extra)
        loss = float(loss)
        dt = time.perf_counter() - t0
        losses.append(loss)
        if i < start + 3 or (i + 1) % 10 == 0:
            print(f"[train] step {i + 1}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt * 1e3:.0f} ms)")

    if args.ckpt:
        ckpt_io.save(args.ckpt, {"params": params, "opt": opt_state},
                     {"step": start + args.steps, "arch": args.arch})
        print(f"[train] saved {args.ckpt}")
    return params, opt_state, losses


if __name__ == "__main__":
    main()
