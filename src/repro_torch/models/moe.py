"""Mixture-of-experts FFN: a routed top-k of ``num_experts`` gated MLPs
plus optional shared experts (DeepSeek-V3's sigmoid router with a
selection bias, top-k renormalization and a routed scaling factor).

Two dispatch strategies, as in the JAX package:

* ``gshard`` — tokens in groups of ``min(group_size, tokens)``; each
  expert takes at most ``capacity`` (token, slot) pairs of a group, in
  (token, slot) order, and drops the rest.  The JAX package dispatches
  and combines with one-hot einsums; here an index scatter fills each
  expert's capacity rows (zero where no token landed) and an index gather
  reads them back, which gives the same values.
* ``dense`` — every expert computes every token (no drops): the oracle,
  and the path ``launch/serve.py::generate`` prefills with.

Every expert product goes through :func:`repro_torch.kernels.ops.linear`
on the view ``w[e]`` of the stacked leaf, over the expert's own rows (all
tokens under ``dense``, its capacity rows under ``gshard``); empty
experts run too, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import MoESpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L

STRATEGIES = ("gshard", "dense")


def init(gen: torch.Generator, spec: MoESpec, d_model: int,
         dtype=torch.float32):
    """The JAX package's leaves: ``router`` (d, E) f32, ``w_up`` /
    ``w_gate`` (E, d, f), ``w_down`` (E, f, d), ``router_bias`` (E,) zeros
    for a sigmoid router, and ``shared`` {w_up, w_gate, w_down} of width
    ``d_ff_shared`` (or ``d_ff · num_shared``)."""
    e, f = spec.num_experts, spec.d_ff

    def ew(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(dtype)

    p = {"router": L.dense_init(gen, d_model, e, torch.float32),
         "w_up": ew((e, d_model, f), d_model),
         "w_down": ew((e, f, d_model), f)}
    if spec.gated:
        p["w_gate"] = ew((e, d_model, f), d_model)
    if spec.router == "sigmoid":
        p["router_bias"] = torch.zeros(e, dtype=torch.float32)
    if spec.num_shared:
        fs = spec.d_ff_shared or spec.d_ff * spec.num_shared
        p["shared"] = {"w_up": L.dense_init(gen, d_model, fs, dtype),
                       "w_down": L.dense_init(gen, fs, d_model, dtype)}
        if spec.gated:
            p["shared"]["w_gate"] = L.dense_init(gen, d_model, fs, dtype)
    return p


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def selection_scores(spec: MoESpec, params, probs):
    """The scores the top-k is taken over: the probabilities, plus the
    selection bias for a sigmoid router."""
    if spec.router == "sigmoid":
        return probs + params["router_bias"]
    return probs


def route(spec: MoESpec, params, x):
    """x (..., d) → (weights (..., k), idx (..., k), probs (..., E)).  The
    logits in f32; the top k of the selection scores, ties to the lower
    index (as ``jax.lax.top_k``: a stable descending sort); the weights
    from the bias-free probabilities at the selected experts, renormalized
    (``norm_topk``) and scaled by ``router_scale``."""
    logits = ops.linear(x.float(), params["router"])
    if spec.router == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    sel = selection_scores(spec, params, probs)
    idx = torch.sort(sel, dim=-1, descending=True,
                     stable=True)[1][..., :spec.top_k]
    w = torch.gather(probs, -1, idx)
    if spec.norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * spec.router_scale, idx, probs


def load_balance_loss(spec: MoESpec, probs, top_idx):
    """Switch-Transformer aux loss: E · Σ_e f_e · P_e."""
    e = spec.num_experts
    onehot = F.one_hot(top_idx, e).float()                   # (..., k, E)
    f = onehot.sum(dim=-2).reshape(-1, e).mean(dim=0) / spec.top_k
    p = probs.reshape(-1, e).mean(dim=0)
    return e * (f * p).sum()


# ---------------------------------------------------------------------------
# Expert FFNs
# ---------------------------------------------------------------------------

def _expert(spec: MoESpec, params, e: int, x):
    """Expert ``e`` on its rows x (..., d): each product one
    ``ops.linear`` on the view ``w[e]``."""
    act = L.activation(spec.activation)
    up = ops.linear(x, params["w_up"][e])
    if spec.gated:
        up = act(ops.linear(x, params["w_gate"][e])) * up
    else:
        up = act(up)
    return ops.linear(up, params["w_down"][e])


def _expert_ffn(spec: MoESpec, params, xe):
    """xe (..., E, C, d) → (..., E, C, d): expert e on its C rows."""
    return torch.stack([_expert(spec, params, e, xe[..., e, :, :])
                        for e in range(spec.num_experts)], dim=-3)


def _shared_ffn(spec: MoESpec, params, x):
    act = L.activation(spec.activation)
    sp = params["shared"]
    up = ops.linear(x, sp["w_up"])
    if spec.gated:
        up = act(ops.linear(x, sp["w_gate"])) * up
    else:
        up = act(up)
    return ops.linear(up, sp["w_down"])


# ---------------------------------------------------------------------------
# Dispatch strategies
# ---------------------------------------------------------------------------

def apply_dense(spec: MoESpec, params, x):
    """Oracle: every expert on every token, the top k combined by their
    weights (experts summed in index order).  x (B, L, d) → (out, aux)."""
    w, idx, probs = route(spec, params, x)
    comb = torch.zeros(probs.shape, dtype=x.dtype, device=x.device)
    comb.scatter_(-1, idx, w.to(x.dtype))                        # (..., E)
    out = None
    for e in range(spec.num_experts):
        ye = _expert(spec, params, e, x) * comb[..., e:e + 1]
        out = ye if out is None else out + ye
    if spec.num_shared:
        out = out + _shared_ffn(spec, params, x)
    return out, load_balance_loss(spec, probs, idx)


def capacity(spec: MoESpec, group_tokens: int) -> int:
    """(token, slot) pairs an expert takes from a group: ⌈t·k·cf / E⌉
    (``capacity_factor`` 0 reads as 1.25), at least 8, rounded up to 8."""
    cf = spec.capacity_factor or 1.25
    c = int(math.ceil(group_tokens * spec.top_k * cf / spec.num_experts))
    return max(8, -(-c // 8) * 8)


def apply_gshard(spec: MoESpec, params, x, group_size: int = 2048):
    """Capacity dispatch over groups of ``min(group_size, B·L)`` tokens,
    which must divide the token count.  x (B, L, d) → (out, aux); a
    dropped (token, slot) adds nothing."""
    b, l, d = x.shape
    t = b * l
    g_sz = min(group_size, t)
    if t % g_sz:
        raise ValueError(f"tokens {t} not divisible by group size {g_sz}")
    g, k, n_exp = t // g_sz, spec.top_k, spec.num_experts
    xg = x.reshape(g, g_sz, d)
    w, idx, probs = route(spec, params, xg)                      # (g, t, k)
    c = capacity(spec, g_sz)
    # each (token, slot)'s place in its expert's queue, in (t, k) order
    onehot = F.one_hot(idx, n_exp)                               # (g,t,k,E)
    flat = onehot.reshape(g, g_sz * k, n_exp)
    pos = (flat.cumsum(dim=1) - flat).reshape(g, g_sz, k, n_exp)
    pos = (pos * onehot).sum(dim=-1)                             # (g, t, k)
    keep = pos < c
    # expert e's C capacity rows, zero where no token landed; a dropped
    # pair writes the spare row C, which no expert reads
    gi = torch.arange(g, device=x.device)[:, None, None]
    xe = x.new_zeros(g, n_exp, c + 1, d)
    xe[gi, idx, torch.where(keep, pos, c)] = xg[:, :, None, :].expand(
        g, g_sz, k, d)
    ye = _expert_ffn(spec, params, xe[:, :, :c])                 # (g,E,C,d)
    wk = (w * keep).to(x.dtype)
    slot = torch.where(keep, pos, 0)
    out = x.new_zeros(g, g_sz, d)
    for j in range(k):
        out = out + ye[gi[..., 0], idx[..., j], slot[..., j]] * wk[..., j,
                                                                    None]
    out = out.reshape(b, l, d)
    if spec.num_shared:
        out = out + _shared_ffn(spec, params, x)
    return out, load_balance_loss(spec, probs, idx)


def apply(spec: MoESpec, params, x, *, strategy: str = "gshard",
          group_size: int = 2048):
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got "
                         f"{strategy!r}")
    if strategy == "dense":
        return apply_dense(spec, params, x)
    return apply_gshard(spec, params, x, group_size=group_size)
