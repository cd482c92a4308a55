"""Dry run on the meta device: what every (architecture × input shape)
program does and holds on one card, without allocating or launching
anything.

For each LM architecture and each ``SHAPES`` preset, build the program of
that shape (``launch/programs.py``: the train step with its backward and
AdamW update, the prefill step, or one serve step against a full cache),
run it on meta tensors under ``launch/op_analysis.py``, and record its
FLOPs and bytes by arithmetic unit, the roofline terms on the H100
(``launch/roofline.py``) and the bytes it holds on the card: the weights,
the token kernel's TF32 halves of them (``kernels/gemm.py::prepare``),
the caches, the optimizer state, the gradients and the inputs.

What differs from the JAX package's dry run, by design: one device, no
production mesh (``--multi-pod`` is not ported), no lowering or
compilation, so no ``lower_s`` / ``compile_s``; XLA's ``temp_bytes`` and
``peak_bytes`` have no meta counterpart and are null; the weights are the
port's f32 (the JAX package's structs are bf16).

Usage (CPU, nothing allocated):
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.launch import mesh, op_analysis, programs
from repro_torch.launch.roofline import (Roofline, fmt_seconds,
                                         model_flops_estimate)
from repro_torch.models import transformer as T

#: the architectures the dry run covers: every LM of the registry (the
#: JAX package's ``configs.ASSIGNED``)
ARCHS = sorted(a for a in configs.REGISTRY if configs.get(a).task == "lm")
MESH = "1"


def _bytes(tree) -> float:
    return float(sum(a.numel() * a.element_size()
                     for a in T.tree_leaves(tree)))


def meta_params_bytes(shape_tree) -> float:
    """Bytes of the weights as the port holds them (f32: twice the JAX
    package's bf16 figure)."""
    return _bytes(shape_tree)


def count_params(cfg, shape_tree) -> float:
    return float(sum(math.prod(a.shape) for a in T.tree_leaves(shape_tree)))


def active_params(cfg) -> float:
    """Parameters touched per token (MoE: top-k + shared experts only)."""
    full = count_params(cfg, programs.params_struct(cfg))
    inactive = 0.0
    for st in cfg.stages:
        for b in st.unit:
            f = b.ffn
            if f is not None and hasattr(f, "num_experts"):
                per_e = cfg.d_model * f.d_ff * (3 if f.gated else 2)
                inactive += st.repeat * per_e * (f.num_experts - f.top_k)
    return full - inactive


def halves_bytes(token_weights) -> int:
    """Bytes of the token kernel's prepared TF32 halves of
    ``token_weights`` (``gemm.prepare``: a big and a small f32 copy of
    each): ``transformer.token_weights`` of an LM's params,
    ``diffusion.token_weights`` of a denoiser's."""
    return 2 * 4 * sum(w.numel() for w in token_weights)


def memory(params, ins, *, opt=None, caches=None) -> dict:
    """What a program holds on the card, by part, in bytes."""
    parts = {"weights": meta_params_bytes(params),
             "halves": float(halves_bytes(T.token_weights(params))),
             "caches": _bytes(caches) if caches is not None else 0.0,
             "optimizer": _bytes(opt) if opt is not None else 0.0,
             "gradients": meta_params_bytes(params) if opt is not None
             else 0.0,
             "inputs": _bytes({k: v for k, v in ins.items()
                               if k != "caches"})}
    total = sum(parts.values())
    return {**parts, "total": total, "temp_bytes": None, "peak_bytes": None,
            "fits_one_card": total <= mesh.CARD_BYTES}


def build(arch: str, shape_name: str, *, variant: str = "full"):
    """Returns (fn, args, kwargs, meta): the program of this shape, its
    meta inputs and the record's static part."""
    shape = SHAPES[shape_name]
    cfg = programs.adapt_for_shape(configs.get(arch, variant), shape)
    p = programs.params_struct(cfg)
    ins = programs.input_specs(cfg, shape)
    kw = {k: ins[k] for k in ("prefix_embeds", "memory") if k in ins}
    opt = caches = None
    if shape.program == "train":
        opt = programs.opt_struct(p)
        fn = programs.make_train_step(cfg)
        args = [p, opt, ins["tokens"], ins["targets"]]
    elif shape.program == "prefill":
        plen = shape.seq_len + (cfg.num_prefix_embeds if "prefix_embeds"
                                in kw else 0)
        # MoE groups of 2048 tokens, as the JAX package's, or the largest
        # power of two that divides the prefill's tokens where 2048 does
        # not (the smoke Llama-4: 32 × (8 + 32768) tokens, groups of 256)
        fn = programs.make_prefill_step(
            cfg, moe_group_size=math.gcd(shape.global_batch * plen, 2048))
        args = [p, ins["tokens"]]
        with programs.on_meta():
            caches = T.init_caches(cfg, shape.global_batch, plen,
                                   programs.CACHE_DTYPE, device="meta")
    else:  # decode
        caches = ins["caches"]
        fn = programs.make_serve_step(cfg, pos=shape.seq_len - 1)
        args = [p, ins["token"], caches]
    meta = {"arch": arch, "shape": shape_name, "mesh": MESH,
            "chips": mesh.num_chips(), "program": shape.program,
            "params": count_params(cfg, p),
            "active_params": active_params(cfg),
            "memory": memory(p, ins, opt=opt, caches=caches)}
    return fn, args, kw, meta


def run_combo(arch: str, shape_name: str, *, variant: str = "full") -> dict:
    t0 = time.time()
    fn, args, kw, meta = build(arch, shape_name, variant=variant)
    totals = op_analysis.analyze(fn, *args, **kw)
    shape = SHAPES[shape_name]
    tokens = (shape.global_batch * shape.seq_len
              if shape.program in ("train", "prefill")
              else shape.global_batch * 1)
    mf = model_flops_estimate(meta["active_params"], tokens,
                              train=(shape.program == "train"))
    rec = dict(meta)
    rec.update({
        "ok": True, "count_s": round(time.time() - t0, 2),
        "flops_per_chip": totals.flops, "bytes_per_chip": totals.bytes,
        "flops_by_unit": totals.by_unit, "kernels": totals.kernels,
        "ops": totals.ops, "collectives": {}, "coll_bytes_per_chip": 0.0,
        "model_flops": mf, "tokens": tokens})
    r = Roofline(arch, shape_name, MESH, meta["chips"], totals.flops,
                 totals.bytes, 0.0, {}, rec["memory"], mf,
                 flops_by_unit=totals.by_unit)
    rec["roofline"] = r.to_dict()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            tag = f"{a}__{s}__{MESH}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                continue
            print(f"[run ] {tag}", flush=True)
            try:
                rec = run_combo(a, s)
            except Exception as e:
                rec = {"arch": a, "shape": s, "ok": False, "mesh": MESH,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("ok"):
                rf = rec["roofline"]
                print(f"  ok  count={rec['count_s']}s "
                      f"flops={rec['flops_per_chip']:.3g} "
                      f"bytes={rec['bytes_per_chip']:.3g} "
                      f"t_compute={fmt_seconds(rf['t_compute'])} "
                      f"t_memory={fmt_seconds(rf['t_memory'])} "
                      f"bottleneck={rf['bottleneck']} "
                      f"fits_one_card={rec['memory']['fits_one_card']}",
                      flush=True)
            else:
                print(f"  FAIL {rec['error']}", flush=True)


if __name__ == "__main__":
    main()
