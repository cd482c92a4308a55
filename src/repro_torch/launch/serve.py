"""Autoregressive serving: prefill + decode loop over a static batch.

    python -m repro_torch.launch.serve --arch mamba2-1.3b --variant full \
        --batch 4 --prompt-len 1024 --gen 32
    python -m repro_torch.launch.serve --arch qwen3-14b --variant smoke \
        --device cpu
    python -m repro_torch.launch.serve --arch gemma2-9b --variant smoke \
        --device cpu --prompt-len 24
    python -m repro_torch.launch.serve --arch minicpm3-4b --variant smoke \
        --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v3-671b \
        --variant smoke --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --variant smoke --device cpu
    python -m repro_torch.launch.serve --arch musicgen-medium \
        --variant smoke --device cpu
    python -m repro_torch.launch.serve --arch internvl2-1b \
        --variant smoke --device cpu

The weights are random, drawn from ``--seed``; the prompts come from a
``TokenStream`` of the same seed ((B, L, K) for K codebooks), and a model
with cross-attention (``cond_dim``) gets a 16-token text-memory stub.  As
in the JAX package, ``generate`` takes no prefix embeddings: a prefix
model (InternVL2, Llama-4) generates from its tokens alone here, and with
a prefix through ``launch.programs``.  Runs on ``cuda`` unless ``--device
cpu``; there each decode step replays one captured CUDA graph, or, with
``--no-graphs``, is launched from the host.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import configs, resolve_device
from repro_torch.config import ModelConfig
from repro_torch.data.synthetic import TokenStream, text_memory
from repro_torch.launch import decode_graph
from repro_torch.models import transformer as T


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                *, device=None):
    """Seeded LM parameters in the JAX package's layout, drawn from ``gen``
    on its device (a CPU generator gives the same parameters on every
    device; a CUDA generator draws on the card) and moved to ``device``
    (default ``cuda``)."""
    if cfg.task != "lm":
        raise ValueError(f"{cfg.name} is not a language model config")
    dev = resolve_device(device)
    return T.tree_map(lambda a: a.to(dev), T.init_params(gen, cfg, dtype))


def _pick(logits, temperature: float, generator):
    """logits (B, 1, V) → tokens (B, 1), or (B, 1, K, V) → (B, 1, K) for
    K codebooks: argmax, or a sample at
    ``temperature`` by Gumbel-max with noise drawn from ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=generator.device).to(logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


def generate(cfg: ModelConfig, params, prompts, gen_len: int, *,
             memory=None, cache_len: Optional[int] = None,
             temperature: float = 0.0, generator=None, device=None,
             on_phase=None, graphs: Optional[bool] = None):
    """Greedy or temperature batched generation on ``device`` (default
    ``cuda``), where ``params`` must lie.  prompts: (B, L) tokens, or (B, L,
    K) for K codebooks.  Returns (B, gen_len[, K]) new tokens; decode step
    i runs at position L + i against KV caches of ``cache_len`` slots
    (default L + gen_len; a state-cache model has none).
    ``memory`` (B, Lm, cond_dim) feeds the cross-attention branches in the
    prefill and in every decode step.  Sampling (``temperature > 0``)
    needs an explicit ``torch.Generator``.  ``on_phase``, if given, is
    called with ``"prefill"`` once the prompts are prefilled and the first
    token is picked, and with ``"decode"`` at the end.  As in the JAX
    package, a mixture-of-experts FFN prefills with ``dense`` dispatch (no
    token dropped) and decodes with ``gshard`` (``decode_step``'s default).

    The prefill runs eagerly; the decode steps go through the decode
    graph of their shape (``launch/decode_graph.py``, the counterpart of
    the JAX package's jitted step): on a card one captured CUDA graph
    replayed a step, ``graphs=False`` the same step launched from the
    host; on the CPU always the latter.  A sampled token is drawn from
    ``generator`` between the steps."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['embed'].device}, "
                         f"generation runs on {dev}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    prompts = prompts.to(params["embed"].device)
    plen = prompts.shape[1]
    cache_len = cache_len or plen + gen_len
    logits, caches = T.prefill(cfg, params, prompts, cache_len=cache_len,
                               memory=memory, moe_strategy="dense")
    tok = _pick(logits[:, -1:], temperature, generator)
    del logits
    if on_phase is not None:
        on_phase("prefill")
    out = tok
    if gen_len > 1:
        pick = (None if temperature <= 0 else
                lambda lg: _pick(lg, temperature, generator))
        out, _ = decode_graph.decode(cfg, params, tok, caches, plen,
                                     gen_len - 1, cache_len=cache_len,
                                     memory=memory, pick=pick,
                                     graphs=graphs)
    if on_phase is not None:
        on_phase("decode")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--no-graphs", action="store_true",
                    help="launch each decode step from the host instead of "
                         "replaying its captured CUDA graph")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, args.variant)
    params = init_params(torch.Generator().manual_seed(args.seed), cfg,
                         device=dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts, _ = TokenStream(cfg.vocab_size, args.prompt_len, args.batch,
                             num_codebooks=cfg.num_codebooks,
                             seed=args.seed).batch_at(0, device=dev)
    memory = (text_memory(torch.Generator().manual_seed(args.seed + 3),
                          args.batch, 16, cfg.cond_dim, device=dev)
              if cfg.cond_dim else None)
    marks = {}

    def mark(phase):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks[phase] = time.perf_counter()

    mark("start")
    toks = generate(cfg, params, prompts, args.gen, memory=memory,
                    temperature=args.temperature, generator=gen,
                    device=dev, on_phase=mark,
                    graphs=False if args.no_graphs else None)
    prefill_s = marks["prefill"] - marks["start"]
    decode_s = marks["decode"] - marks["prefill"]
    steps = max(args.gen - 1, 1)
    print(f"[serve] {cfg.name} on {dev}: generated {tuple(toks.shape)}; "
          f"prefill {prefill_s:.3f} s for {args.batch}x{args.prompt_len} "
          f"tokens, decode {1e3 * decode_s / steps:.2f} ms/step "
          f"({args.batch * steps / max(decode_s, 1e-9):.1f} tok/s)")
    print("[serve] first sequence:", toks[0].tolist()[:16])


if __name__ == "__main__":
    main()
