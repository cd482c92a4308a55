"""Diffusion wrapper: turns the backbone into a DiT denoiser.

Adds patchify/unpatchify of image latents (H, W, C), video latents
(T, H, W, C — spatial patchify, factorized attention) and audio latents
(L, C — patch 1, the latent rows are the tokens), a sinusoidal
timestep embedding → MLP, a class-label embedding with a CFG null class,
the cross-attention memory of a text-conditioned model, and adaLN-zero
conditioning (the backbone's blocks carry ``adaln=True``).  Prediction
types: ε (DDIM, DPM-Solver++) and velocity (rectified flow).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import gemm as _gemm, ops
from repro_torch.models import layers as L, transformer as T

TIME_EMB_DIM = 256


# ---------------------------------------------------------------------------
# Patchify (image, video and audio latents)
# ---------------------------------------------------------------------------

def token_shape(cfg: ModelConfig):
    """Returns ``(num_tokens, token_dim, video_shape)`` of an (H, W, C)
    image latent (``video_shape`` None), a (T, H, W, C) video latent,
    patchified in space only (``video_shape`` = (T, S)), or an (L, C)
    audio latent, whose L rows are the tokens (patch 1)."""
    ls, p = cfg.latent_shape, cfg.patch
    if len(ls) == 3:
        h, w, c = ls
        return (h // p) * (w // p), p * p * c, None
    if len(ls) == 4:
        t, h, w, c = ls
        s = (h // p) * (w // p)
        return t * s, p * p * c, (t, s)
    if len(ls) == 2:
        if p != 1:
            raise ValueError(f"an (L, C) latent takes patch 1, got {p}")
        return ls[0], ls[1], None
    raise ValueError(f"latent shape {ls}: expected (H, W, C), (T, H, W, C) "
                     "or (L, C)")


def patchify(cfg: ModelConfig, x):
    """x: (B, *latent_shape) → (B, N, p·p·C); an (L, C) latent is its own
    tokens."""
    p, ls = cfg.patch, cfg.latent_shape
    b = x.shape[0]
    if len(ls) == 2:
        return x
    if len(ls) == 3:
        h, w, c = ls
        x = x.reshape(b, h // p, p, w // p, p, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                                   p * p * c)
    t, h, w, c = ls
    x = x.reshape(b, t, h // p, p, w // p, p, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(
        b, t * (h // p) * (w // p), p * p * c)


def unpatchify(cfg: ModelConfig, tok):
    p, ls = cfg.patch, cfg.latent_shape
    b = tok.shape[0]
    if len(ls) == 2:
        return tok
    if len(ls) == 3:
        h, w, c = ls
        x = tok.reshape(b, h // p, w // p, p, p, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    t, h, w, c = ls
    x = tok.reshape(b, t, h // p, w // p, p, p, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h, w, c)


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
    _, tok_dim, _ = token_shape(cfg)
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
    te = F.silu(ops.linear(te, params["t_mlp"]["w1"], params["t_mlp"]["b1"],
                           rows="requests"))
    te = ops.linear(te, params["t_mlp"]["w2"], params["t_mlp"]["b2"],
                    rows="requests")
    if label is not None and "label_embed" in params:
        te = te + params["label_embed"][label]
    return te


def apply(cfg: ModelConfig, params, x, t, *, label=None, memory=None,
          skip=None, branch_caches=None, collect_branches=False):
    """Denoiser: x (B, *latent_shape), t (B,) → prediction (B,
    *latent_shape); ``memory`` (B, Lm, cond_dim) is the cross-attention
    memory of a text-conditioned model.

    Returns ``(pred, aux)``; ``aux["branch"]`` holds the per-layer
    pre-residual branch outputs (the SmoothCache payload) of the types
    ``collect_branches`` names (a bool or a collection of layer types)."""
    _, _, video_shape = token_shape(cfg)
    tok = patchify(cfg, x)
    h = ops.linear(tok, params["patch_in"]["w"], params["patch_in"]["b"])
    # fixed sin-cos positional embedding over flattened tokens (DiT-style)
    pos = torch.arange(h.shape[1], device=h.device)
    h = h + L.sinusoidal_embedding(pos, cfg.d_model)[None].to(h.dtype)
    cond = _cond_vector(cfg, params, t, label)
    out, aux = T.forward(cfg, params["backbone"], embeds=h, cond=cond,
                         skip=skip, branch_caches=branch_caches,
                         collect_branches=collect_branches, memory=memory,
                         video_shape=video_shape)
    mod = ops.linear(F.silu(cond), params["final_mod"]["w"],
                     params["final_mod"]["b"], rows="requests")
    shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
    out = out * (1.0 + scale) + shift
    out = ops.linear(out, params["out"]["w"], params["out"]["b"])
    return unpatchify(cfg, out), aux


def token_weights(params):
    """The weights of the denoiser's token products (patch embedding,
    q/k/v/o of self- and cross-attention, the MLP, output projection), one
    per product as the forward takes it: a block's weight as the view
    ``a[r]`` of its stacked leaf."""
    return ([params["patch_in"]["w"], params["out"]["w"]]
            + T.token_weights(params["backbone"]))


def prepare_linear(params) -> int:
    """Make the token kernel's prepared weights (``gemm.prepare``) for every
    token product of the denoiser, before any timed window or CUDA-graph
    capture; a no-op for parameters on the CPU, where ``ops.linear`` is the
    plain product.  Returns the bytes the prepared copies hold."""
    if params["patch_in"]["w"].device.type != "cuda":
        return 0
    return _gemm.prepare_params(token_weights(params))


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


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------

def q_sample(sched, x0, t, noise):
    """VP forward: x_t = √ᾱ_t x₀ + √(1 − ᾱ_t) ε.  t: (B,) int."""
    ab = sched["alpha_bar"].to(x0.device)[t]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (torch.sqrt(ab).reshape(shape) * x0
            + torch.sqrt(1.0 - ab).reshape(shape) * noise)


def _draw(gen, x0, t, noise, draw_t):
    """(t, noise) on x0's device: each drawn from ``gen`` (t first, then
    the noise, on the generator's device) unless the caller passed it."""
    if t is None:
        t = draw_t(gen).to(x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=gen, dtype=x0.dtype,
                            device=gen.device).to(x0.device)
    return t, noise


def eps_loss(cfg, params, gen, x0, *, sched, label=None, memory=None,
             t=None, noise=None):
    """DDPM ε-prediction loss: t uniform over the schedule's integer steps,
    ε ~ N(0, 1), mean (ε̂(x_t, t) − ε)².  ``t`` (B,) and ``noise`` (x0's
    shape), when passed, replace the draws from ``gen``."""
    n = sched["betas"].shape[0]
    t, noise = _draw(gen, x0, t, noise, lambda g: torch.randint(
        0, n, (x0.shape[0],), generator=g, device=g.device))
    pred, _ = apply(cfg, params, q_sample(sched, x0, t, noise), t,
                    label=label, memory=memory)
    return torch.mean(torch.square(pred - noise))


def rf_loss(cfg, params, gen, x0, *, label=None, memory=None, t=None,
            noise=None):
    """Rectified-flow velocity loss: t ~ U[0, 1), x_t = (1 − t)x₀ + t·ε,
    the target v* = ε − x₀, the model's time t·1000.  ``t`` and ``noise``
    as in :func:`eps_loss`."""
    t, noise = _draw(gen, x0, t, noise, lambda g: torch.rand(
        (x0.shape[0],), generator=g, device=g.device))
    shape = (-1,) + (1,) * (x0.dim() - 1)
    xt = (1.0 - t).reshape(shape) * x0 + t.reshape(shape) * noise
    pred, _ = apply(cfg, params, xt, t * 1000.0, label=label, memory=memory)
    return torch.mean(torch.square(pred - (noise - x0)))
