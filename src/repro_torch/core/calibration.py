"""SmoothCache calibration: run an uncached sampling trajectory, measure each
layer's pre-residual branch output against its value k steps earlier, and
build the per-type L1 relative error curves of paper Fig. 2 / Eq. 4.

The error at step s for lag k is

    err[t][s, k] = mean_{j ∈ layers of type t}
                   ||L̃_{j}(s) − L̃_{j}(s−k)||₁ / ||L̃_{j}(s)||₁

averaged over calibration samples; per-sample curves are also returned.

Under classifier-free guidance only the **conditioned half** of the
``[cond; uncond]`` batch enters the curves.  Unlike the JAX package, which
copies every branch output of every step to the host, the port keeps only
the last ``k_max + 1`` steps' cond-half outputs on the device, takes the
per-sample L1 sums there in float64, and moves only the ``(B, S, K+1)``
results to the host.

The same pass records the per-step **proxy signal** (relative L1 change of
the model input between steps) and fits the per-type proxy→error map that
input-adaptive policies use.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig


def branch_outputs_by_type(cfg: ModelConfig, branch_tree) -> Dict[str, List]:
    """Flatten the per-stage repeat-stacked branch outputs into
    {type: [per-layer tensors (B, N, d)] in depth order}."""
    out: Dict[str, List] = {}
    for si, st in enumerate(cfg.stages):
        stage_branches = branch_tree[si]
        for bi, b in enumerate(st.unit):
            bo = stage_branches[bi]
            for name, t in zip(b.branch_names(), b.branch_types()):
                if bo is None or name not in bo:
                    continue
                arr = bo[name]                    # (repeat, B, N, d)
                for r in range(arr.shape[0]):
                    out.setdefault(t, []).append(arr[r])
    return out


def l1_rel_error(a, b):
    """Per-sample ||a − b||₁ / ||a||₁ over every axis but the first, taken
    in float64: (B,)."""
    dims = tuple(range(1, a.dim()))
    num = (a - b).abs().double().sum(dim=dims)
    den = a.abs().double().sum(dim=dims) + 1e-12
    return num / den


class _CurveAccumulator:
    """Streaming error curves: ``push`` one step's {type: [layer outputs]}
    at a time; only the last ``k_max`` steps are kept for the lags."""

    def __init__(self, k_max: int):
        self.k_max = k_max
        self.window = collections.deque(maxlen=k_max)   # newest last
        self.rows: Dict[str, list] = {}                 # type → [(B, K+1)]

    def push(self, by_type: Mapping[str, list]) -> None:
        for t, cur in by_type.items():
            row = torch.full((cur[0].shape[0], self.k_max + 1), float("nan"),
                             dtype=torch.float64, device=cur[0].device)
            row[:, 0] = 0.0
            for k, prev in enumerate(reversed(self.window), start=1):
                errs = [l1_rel_error(c, p) for c, p in zip(cur, prev[t])]
                row[:, k] = torch.stack(errs).mean(dim=0)   # layer mean
            self.rows.setdefault(t, []).append(row)
        self.window.append(by_type)

    def finish(self):
        per_sample = {t: torch.stack(rows, dim=1).cpu().numpy()
                      for t, rows in sorted(self.rows.items())}
        mean = {t: np.mean(ps, axis=0) for t, ps in per_sample.items()}
        return mean, per_sample


def error_curves_from_trajectory(cfg: ModelConfig, per_step, k_max: int = 3):
    """per_step[s] = branch_outputs_by_type at sampling step s.

    Returns (mean_curves {t: (S, K+1)}, per_sample {t: (B, S, K+1)}).
    Entries with k > s are NaN; the k=0 column is 0."""
    acc = _CurveAccumulator(k_max)
    for by_type in per_step:
        acc.push(by_type)
    return acc.finish()


# ---------------------------------------------------------------------------
# Proxy signal (input-adaptive policies)
# ---------------------------------------------------------------------------

def rel_l1_change(cur, prev):
    """||cur − prev||₁ / ||prev||₁ over the whole array — THE proxy
    formula."""
    return abs(cur - prev).sum() / (abs(prev).sum() + 1e-12)


def row_sums(v):
    """Per-row sums of ``v`` (B, ...) by one fixed pairwise tree of
    elementwise adds (the row padded with zeros to a power of two, then
    halved until one value is left): row i's bits depend on row i alone.
    PyTorch's CUDA reduction shapes its thread blocks by the number of
    outputs, so ``v.sum(dim)`` would give a row other bits at another B."""
    v = v.reshape(v.shape[0], -1)
    n = v.shape[1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v[:, 0]


def rel_l1_change_rows(cur, prev):
    """Per-sample :func:`rel_l1_change`: reduce over every axis but the
    leading batch axis, returning one proxy signal per row (in the
    tensors' dtype, on their device), so a batch-1 run and row i of a
    batch-B run see the same signal, bit for bit (:func:`row_sums`)."""
    return (row_sums((cur - prev).abs())
            / (row_sums(prev.abs()) + 1e-12))


def _unforced(skip, force_compute):
    """``skip & ~force_compute``.  ``force_compute`` is a Python bool or a
    bool tensor on ``skip``'s device (a captured graph's ``step == 0``);
    a bool never becomes a tensor, so nothing here copies host to device
    (which a CUDA graph capture forbids), and ``False`` leaves the bits
    as they are."""
    if isinstance(force_compute, torch.Tensor):
        return skip & ~force_compute
    return torch.zeros_like(skip) if force_compute else skip


def runtime_rule(proxy, acc, lag, a, b, tau, k_max, force_compute=False):
    """One evaluation of the adaptive reuse rule, vectorized over layer
    types: estimate the per-type lag-1 error from the proxy signal
    (``max(a·proxy + b, 0)`` — clamped, so an adversarial fit can never
    shrink the accumulator while skipping), skip a type while the error
    accumulated since its last compute stays under ``tau`` and the cache
    age stays ≤ ``k_max``, and return the updated accumulator/lag state.
    ``acc``/``a``/``b`` are float32 tensors, ``lag`` int32;
    ``force_compute`` (step 0, empty cache; a bool or a device bool
    tensor) overrides every skip."""
    delta = torch.clamp_min(a * proxy + b, 0.0)
    skip = _unforced((lag + 1 <= k_max) & (acc + delta < tau),
                     force_compute)
    acc = torch.where(skip, acc + delta, 0.0)
    lag = torch.where(skip, lag + 1, 0)
    return skip, acc, lag


def rule_limits(tau: float, k_max: int, device):
    """τ and k_max as the (1,) float32 / int32 device tensors the rule
    compares against — the form both adaptive loops pass, so that one
    captured fused step serves every τ > 0 (each a buffer it reads) and
    the host loop compares exactly as the graph does.  ``torch.full``
    writes the values on the device: no host-to-device copy."""
    return (torch.full((1,), float(tau), dtype=torch.float32, device=device),
            torch.full((1,), int(k_max), dtype=torch.int32, device=device))


def batch_rule(proxy_rows, acc, lag, a, b, tau, k_max, force_compute=False):
    """Per-sample adaptive rule over a batch: each row evaluates
    :func:`runtime_rule` arithmetic against its own ``(B, T)``
    accumulator/lag state from its own proxy signal, yielding the per-row
    *desired* skip bits ``want (B, T)``; the batch *realizes* their AND
    (``realized (T,)`` — one model call refreshes a type's cache for every
    row, so any row needing a type's compute forces it for the batch).
    acc/lag update against the realized bits, so a batch of one realizes
    exactly its solo trajectory.  ``tau`` / ``k_max`` are the (1,)
    tensors of :func:`rule_limits` in both adaptive loops (a Python float
    and int compare to the same bits)."""
    delta = torch.clamp_min(a * proxy_rows[:, None] + b[None, :], 0.0)
    want = _unforced((lag + 1 <= k_max) & (acc + delta < tau),
                     force_compute)
    realized = want.all(dim=0)                                   # (T,)
    acc = torch.where(realized[None, :], acc + delta, 0.0)
    lag = torch.where(realized[None, :], lag + 1, 0)
    return want, realized, acc, lag


def proxy_signal(cur, prev) -> float:
    """Relative L1 change of the model input between consecutive steps —
    one scalar per step over the whole batch, in float64 on the host."""
    return float(rel_l1_change(np.asarray(cur, np.float64),
                               np.asarray(prev, np.float64)))


def proxies_from_inputs(inputs: List[np.ndarray]) -> np.ndarray:
    """Per-step proxy signals from the model-input trajectory.
    ``proxies[0]`` is NaN; ``proxies[s]`` compares inputs s and s−1."""
    out = np.full(len(inputs), np.nan)
    for s in range(1, len(inputs)):
        out[s] = proxy_signal(inputs[s], inputs[s - 1])
    return out


@dataclasses.dataclass(frozen=True)
class ProxyMap:
    """Fitted per-type linear map from the proxy signal to the one-step
    (lag-1) relative output error: ``est_t(p) = max(a_t·p + b_t, 0)`` (the
    clamp keeps an adversarial fit from shrinking the accumulator)."""
    coeffs: Dict[str, Tuple[float, float]]   # type → (a, b)
    mean_proxy: float = float("nan")         # calibration-mean proxy (diag)

    def est(self, t: str, proxy: float) -> float:
        a, b = self.coeffs[t]
        return max(a * float(proxy) + b, 0.0)

    def stacked(self, types) -> Tuple[np.ndarray, np.ndarray]:
        """Per-type ``(a, b)`` coefficients stacked into two float32 arrays
        in the given type order."""
        missing = [t for t in types if t not in self.coeffs]
        if missing:
            raise KeyError(f"proxy_map lacks coefficients for {missing}; "
                           f"have {self.types()}")
        a = np.asarray([self.coeffs[t][0] for t in types], np.float32)
        b = np.asarray([self.coeffs[t][1] for t in types], np.float32)
        return a, b

    def types(self):
        return sorted(self.coeffs)

    def to_jsonable(self) -> Dict:
        return {"coeffs": {t: [float(a), float(b)]
                           for t, (a, b) in sorted(self.coeffs.items())},
                "mean_proxy": None if np.isnan(self.mean_proxy)
                else float(self.mean_proxy)}

    @staticmethod
    def from_jsonable(d: Mapping) -> "ProxyMap":
        mp = d.get("mean_proxy")
        return ProxyMap(
            coeffs={t: (float(a), float(b))
                    for t, (a, b) in d["coeffs"].items()},
            mean_proxy=float("nan") if mp is None else float(mp))


def fit_proxy_map(curves: Mapping[str, np.ndarray],
                  proxies: np.ndarray) -> ProxyMap:
    """Least-squares fit of the lag-1 error column against the proxy
    signal, per layer type.  Degenerate data (fewer than two finite points,
    or a constant proxy) falls back to the constant map ``b = mean(err)``."""
    coeffs = {}
    for t, err in curves.items():
        xs = np.asarray(proxies, np.float64)
        ys = np.asarray(err[:, 1], np.float64)       # lag-1 column
        ok = np.isfinite(xs) & np.isfinite(ys)
        xs, ys = xs[ok], ys[ok]
        if xs.size >= 2 and np.ptp(xs) > 1e-12:
            a, b = np.polyfit(xs, ys, 1)
        else:
            a, b = 0.0, float(np.mean(ys)) if ys.size else 0.0
        coeffs[t] = (float(a), float(b))
    finite = np.asarray(proxies)[np.isfinite(proxies)]
    return ProxyMap(coeffs=coeffs,
                    mean_proxy=float(np.mean(finite)) if finite.size
                    else float("nan"))


# ---------------------------------------------------------------------------
# Calibration pass
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationRecord:
    """Everything one uncached calibration pass produces."""
    curves: Dict[str, np.ndarray]        # {type: (S, K+1)} mean curves
    per_sample: Dict[str, np.ndarray]    # {type: (calib_batch, S, K+1)}
    proxies: np.ndarray                  # (S,) per-step proxy signal
    proxy_map: ProxyMap                  # fitted proxy→lag-1-error map
    x0: np.ndarray                       # final denoised latents
    cfg_halved: bool                     # True → cond half of a CFG batch


def calibrate_record(executor, params, generator: torch.Generator,
                     batch: int, *, cond_args=None,
                     k_max: int = 3) -> CalibrationRecord:
    """Run one uncached sampling pass with ``batch`` calibration samples
    (paper uses 10), recording branch errors *and* the per-step proxy
    signal, and fit the proxy→error map."""
    cond_args = cond_args or {}
    cfg_halved = executor.cfg_scale is not None
    acc = _CurveAccumulator(k_max)

    def hook(s, branch_tree):
        by_type = branch_outputs_by_type(executor.cfg, branch_tree)
        if cfg_halved:
            # a copy of the conditioned half, so the doubled batch is freed
            by_type = {t: [a[:batch].clone() for a in arrs]
                       for t, arrs in by_type.items()}
        acc.push(by_type)

    # the sampler draws the same initial latent from the same generator state
    state = generator.get_state()
    x_init = executor.initial_latent(generator, batch)
    generator.set_state(state)
    x0, traj = executor.sample(params, generator, batch, schedule=None,
                               collect_hook=hook, return_trajectory=True,
                               **cond_args)
    # model input at step s: the initial noise for s=0, else the latent
    # produced by step s−1
    inputs = [x_init.cpu().numpy()] + [x.cpu().numpy() for x in traj[:-1]]
    proxies = proxies_from_inputs(inputs)
    curves, per_sample = acc.finish()
    return CalibrationRecord(
        curves=curves, per_sample=per_sample, proxies=proxies,
        proxy_map=fit_proxy_map(curves, proxies), x0=x0.cpu().numpy(),
        cfg_halved=cfg_halved)


def calibrate(executor, params, generator: torch.Generator, batch: int, *,
              cond_args=None, k_max: int = 3):
    """The reference's back-compat wrapper over :func:`calibrate_record`:
    returns (mean_curves, per_sample, final latents x₀)."""
    rec = calibrate_record(executor, params, generator, batch,
                           cond_args=cond_args, k_max=k_max)
    return rec.curves, rec.per_sample, rec.x0
