"""String-spec registry for cache policies.

``get("smoothcache:alpha=0.18")`` turns a declarative spec into a
:class:`~repro_torch.cache.policy.CachePolicy`.  Two equivalent grammars:

* flat:    ``name`` or ``name:k=v,k=v``      (CLI-friendly)
* nested:  ``name(k=v,k=v)`` where a value may itself be a spec —
           ``per_type(attn=smoothcache(alpha=0.1),ffn=static(n=2))``

``register`` adds new policies without touching any callsite.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

from repro_torch.cache import policy as P

_REGISTRY: Dict[str, Callable[..., P.CachePolicy]] = {}


def register(name: str, *aliases: str):
    """Decorator registering a policy factory under ``name`` (+ aliases)."""
    def deco(factory):
        for n in (name,) + aliases:
            key = n.lower()
            if key in _REGISTRY:
                raise ValueError(f"cache policy {key!r} already registered")
            _REGISTRY[key] = factory
        return factory
    return deco


def names():
    return sorted(_REGISTRY)


# -- built-ins ---------------------------------------------------------------

register("none", "no_cache", "nocache")(P.NoCache)
register("static", "static_interval", "fora")(P.StaticInterval)
register("smoothcache", "smooth_cache")(P.SmoothCache)
register("budget", "budgeted", "budgeted_smoothcache")(P.BudgetedSmoothCache)


@register("per_type", "per-type", "composite")
def _per_type(default=None, **policies) -> P.PerLayerType:
    coerce = lambda v: get(v) if isinstance(v, (str, dict)) else v
    return P.PerLayerType({t: coerce(p) for t, p in policies.items()},
                          default=coerce(default) if default is not None
                          else None)


@register("adaptive", "teacache")
def _adaptive(base="smoothcache", tau=0.05, k_max=None) -> P.AdaptivePolicy:
    # base may be a nested spec string, a to_config() dict, or a policy;
    # k_max (cache-age cap, default: the base's) is validated >= 1 in
    # AdaptivePolicy — "adaptive:...,k_max=0" must fail loudly, not
    # compile the whole pool and silently never reuse
    if isinstance(tau, (list, tuple)):
        raise ValueError(
            f"tau={list(tau)} is a τ-ladder spec — one policy per rung, "
            "not a single policy; expand it with "
            "registry.expand_ladder(spec) or register it via "
            "ArtifactStore.add_ladder()")
    return P.AdaptivePolicy(base=base, tau=tau, k_max=k_max)


# -- spec parsing ------------------------------------------------------------

def _split_top(s: str, sep: str = ","):
    """Split on ``sep`` at paren/bracket depth 0 (brackets delimit list
    values — the τ-ladder grammar's ``tau=[0.0,0.05,0.2]``)."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced {ch!r} in spec {s!r}")
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced '(' or '[' in spec {s!r}")
    if cur or out:
        out.append("".join(cur))
    return [p.strip() for p in out if p.strip()]


def _coerce(v: str):
    """Typed coercion: list > nested spec > bool > int > float > str."""
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [_coerce(p) for p in _split_top(inner)] if inner else []
    if "(" in v or v.lower() in _REGISTRY:
        return get(v)
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse(spec: str):
    """``spec`` → (name, kwargs)."""
    spec = spec.strip()
    # a spec is parenthesized only when "(" opens the *top-level* arg list,
    # i.e. precedes any ":" — a flat spec may carry parenthesized nested
    # values ("per_type:attn=smoothcache(alpha=0.1)") whose "(" belongs to
    # the value, not the grammar
    i_par, i_col = spec.find("("), spec.find(":")
    if i_par != -1 and (i_col == -1 or i_par < i_col):
        if not spec.endswith(")"):
            raise ValueError(f"malformed policy spec {spec!r}")
        name, inner = spec.split("(", 1)
        args = _split_top(inner[:-1])
    elif ":" in spec:
        name, argstr = spec.split(":", 1)
        args = _split_top(argstr)
    else:
        name, args = spec, []
    kwargs = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"policy arg {a!r} in {spec!r} is not k=v")
        k, v = a.split("=", 1)
        kwargs[k.strip()] = _coerce(v.strip())
    return name.strip().lower(), kwargs


def get(spec: Union[str, dict, P.CachePolicy]) -> P.CachePolicy:
    """Resolve a policy from a spec string, a ``to_config()`` dict, or pass
    an already-constructed policy through unchanged."""
    if isinstance(spec, P.CachePolicy):
        return spec
    if isinstance(spec, dict):
        return from_config(spec)
    name, kwargs = parse(spec)
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown cache policy {name!r}; registered: {names()}")
    return _REGISTRY[name](**kwargs)


def expand_ladder(spec: str):
    """Expand a τ-ladder spec into one adaptive policy per rung.

    ``"adaptive:base=smoothcache(alpha=0.18),tau=[0.0,0.05,0.2]"`` →
    three :class:`~repro_torch.cache.policy.AdaptivePolicy` instances sharing
    base (and ``k_max``), with strictly ascending τ values.  The rungs of
    a ladder serve the *same* artifact — same schedule, proxy map, and
    candidate pool (``ArtifactStore.add_ladder`` validates that) — so the
    τ values are the only thing this grammar varies."""
    name, kwargs = parse(spec)
    if name not in ("adaptive", "teacache"):
        raise ValueError(
            f"a τ ladder is rungs of one adaptive policy; got {name!r} "
            f"in {spec!r}")
    taus = kwargs.pop("tau", None)
    if not isinstance(taus, (list, tuple)) or not taus:
        raise ValueError(
            f"τ-ladder spec needs tau=[v0,v1,...] with at least one "
            f"rung, got tau={taus!r} in {spec!r}")
    taus = [float(t) for t in taus]
    if sorted(taus) != taus or len(set(taus)) != len(taus):
        raise ValueError(
            f"ladder taus must be strictly ascending, got {taus}")
    return [_REGISTRY[name](tau=t, **kwargs) for t in taus]


def from_config(cfg: dict) -> P.CachePolicy:
    """Inverse of ``CachePolicy.to_config()`` (used by CacheArtifact)."""
    cfg = dict(cfg)
    name = cfg.pop("name").lower()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown cache policy {name!r}; registered: {names()}")
    if name in ("per_type", "per-type", "composite"):
        subs = {t: from_config(c) for t, c in cfg.pop("policies", {}).items()}
        default = cfg.pop("default", None)
        return P.PerLayerType(
            subs, default=from_config(default) if default else None)
    return _REGISTRY[name](**cfg)
