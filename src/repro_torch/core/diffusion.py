"""Diffusion wrapper: turns the backbone into a DiT denoiser.

Adds image patchify/unpatchify, a sinusoidal timestep embedding → MLP, a
class-label embedding with a CFG null class, and adaLN-zero conditioning
(the backbone's blocks carry ``adaln=True``).  Prediction type: ε (DDIM).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L, transformer as T

TIME_EMB_DIM = 256


# ---------------------------------------------------------------------------
# Patchify (image latents)
# ---------------------------------------------------------------------------

def token_shape(cfg: ModelConfig):
    """Returns (num_tokens, token_dim) of an (H, W, C) image latent."""
    if len(cfg.latent_shape) != 3:
        raise NotImplementedError(
            f"latent shape {cfg.latent_shape}: only (H, W, C) image "
            "latents are ported")
    h, w, c = cfg.latent_shape
    p = cfg.patch
    return (h // p) * (w // p), p * p * c


def patchify(cfg: ModelConfig, x):
    """x: (B, H, W, C) → (B, N, p·p·C)."""
    p = cfg.patch
    h, w, c = cfg.latent_shape
    b = x.shape[0]
    x = x.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                               p * p * c)


def unpatchify(cfg: ModelConfig, tok):
    p = cfg.patch
    h, w, c = cfg.latent_shape
    b = tok.shape[0]
    x = tok.reshape(b, h // p, w // p, p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                *, device=None):
    """Seeded parameters in the JAX package's layout, drawn on the CPU from
    ``gen`` (so a seed gives the same parameters on every device) and moved
    to ``device`` (default ``cuda``)."""
    if cfg.task != "diffusion":
        raise ValueError(f"{cfg.name} is not a diffusion config")
    dev = resolve_device(device)
    _, tok_dim = token_shape(cfg)
    d = cfg.d_model
    z = lambda *shape: torch.zeros(*shape, dtype=dtype)  # noqa: E731
    p = {
        "backbone": T.init_params(gen, cfg, dtype, adaln_dim=d),
        "patch_in": {"w": L.dense_init(gen, tok_dim, d, dtype), "b": z(d)},
        "t_mlp": {"w1": L.dense_init(gen, TIME_EMB_DIM, d, dtype),
                  "b1": z(d),
                  "w2": L.dense_init(gen, d, d, dtype),
                  "b2": z(d)},
        # adaLN-zero final layer: cond → (shift, scale); zero-init out proj
        "final_mod": {"w": z(d, 2 * d), "b": z(2 * d)},
        "out": {"w": z(d, tok_dim), "b": z(tok_dim)},
    }
    if cfg.num_classes:
        # +1 slot = CFG null label
        p["label_embed"] = L.embed_init(gen, cfg.num_classes + 1, d, dtype)
    return T.tree_map(lambda a: a.to(dev), p)


def _cond_vector(cfg: ModelConfig, params, t, label=None):
    """t: (B,) diffusion time in [0, 1000); label: (B,) int."""
    te = L.sinusoidal_embedding(t.float(), TIME_EMB_DIM)
    te = F.silu(ops.linear(te, params["t_mlp"]["w1"], params["t_mlp"]["b1"]))
    te = ops.linear(te, params["t_mlp"]["w2"], params["t_mlp"]["b2"])
    if label is not None and "label_embed" in params:
        te = te + params["label_embed"][label]
    return te


def apply(cfg: ModelConfig, params, x, t, *, label=None, skip=None,
          branch_caches=None, collect_branches=False):
    """Denoiser: x (B, H, W, C), t (B,) → prediction (B, H, W, C).

    Returns ``(pred, aux)``; ``aux["branch"]`` holds the per-layer
    pre-residual branch outputs (the SmoothCache payload) of the types
    ``collect_branches`` names (a bool or a collection of layer types)."""
    tok = patchify(cfg, x)
    h = ops.linear(tok, params["patch_in"]["w"], params["patch_in"]["b"])
    # fixed sin-cos positional embedding over flattened tokens (DiT-style)
    pos = torch.arange(h.shape[1], device=h.device)
    h = h + L.sinusoidal_embedding(pos, cfg.d_model)[None].to(h.dtype)
    cond = _cond_vector(cfg, params, t, label)
    out, aux = T.forward(cfg, params["backbone"], embeds=h, cond=cond,
                         skip=skip, branch_caches=branch_caches,
                         collect_branches=collect_branches)
    mod = ops.linear(F.silu(cond), params["final_mod"]["w"],
                     params["final_mod"]["b"])
    shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
    out = out * (1.0 + scale) + shift
    out = ops.linear(out, params["out"]["w"], params["out"]["b"])
    return unpatchify(cfg, out), aux


# ---------------------------------------------------------------------------
# VP forward process
# ---------------------------------------------------------------------------

def vp_schedule(num_train_steps: int = 1000, beta_start: float = 1e-4,
                beta_end: float = 2e-2):
    """Linear-β VP schedule in float32 (CPU tensors)."""
    betas = torch.linspace(beta_start, beta_end, num_train_steps,
                           dtype=torch.float32)
    alphas = 1.0 - betas
    return {"betas": betas, "alphas": alphas,
            "alpha_bar": torch.cumprod(alphas, dim=0)}
