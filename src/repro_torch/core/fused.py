"""The fused adaptive step: decision, branch dispatch, model, DDIM step,
decision trace and health fold with no host read in between.

The JAX package runs the adaptive loop as one donated program that picks
each step's branch with ``lax.switch`` on a code computed on the device.
Eager PyTorch cannot branch on a device value without reading it, so on a
CUDA device one step is captured as a **CUDA graph** whose model calls sit
in conditional nodes: one IF node per pool signature, each with the
predicate ``code == i`` (IF nodes need CUDA 12.4; IF/ELSE and SWITCH nodes
need 12.8), built by :mod:`repro_torch.core.cuda_graphs`.  Every branch body writes the same output buffers (the
prediction and the collected cache entries), so the rest of the step reads
one set of addresses whichever branch ran.  A device step counter indexes
the model times, the DDIM coefficients, the static skip table and the
trace, and the graph advances it; a chunk of ``n`` steps is ``n`` replays
enqueued back to back.

One :class:`FusedGraph` exists per ``(batch, SwitchTable, runtime,
labelled, telemetry, params)`` key — the counterpart of JAX's one fused
program per (batch shape, pool, runtime, telemetry).  A telemetry step
also writes each row's proxy signal into an (S, B) ``proxy_trace``: a
graph of its own, so the steps without it stay as they were.  τ and
k_max are (1,) device tensors in the graph's fixed buffers, as JAX
passes them as traced arguments: every τ > 0 rung of a ladder replays
one graph, so a rung change captures nothing.  The buffers are fixed: a
chunk copies the run state in (τ and k_max with it), replays, and copies
the result out, device to device, so run states stay ordinary tensors
that ``split_run`` / ``merge_runs`` gather by rows.  The executor's
graphs share one memory pool; they replay one after another on one
stream.

On the CPU (the tests) the same step runs eagerly and the branch is picked
in Python from the CPU code tensor — reading a CPU tensor waits for no
device, so ``host_sync_count`` stays 0 there too.  On a CUDA device there
is no such path: a failed capture, or a CUDA or PyTorch that cannot build
IF nodes, raises.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import calibration, cuda_graphs
from repro_torch.kernels import ops


def rows_finite(x):
    """Per-sample ``isfinite`` reduction of a latent batch: ``(B,)`` bool,
    True where row ``i`` holds no NaN/Inf."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def cache_leaves(cache) -> List[Tuple[int, int, str]]:
    """(stage, block, branch name) of every resident cache entry."""
    return [(si, bi, name)
            for si, stage in enumerate(cache)
            for bi, d in enumerate(stage)
            for name in sorted(d)]


class FusedGraph:
    """One fused adaptive step for one key, with its fixed buffers: a
    captured CUDA graph on a CUDA device, the eager step on the CPU.

    ``stats`` records the capture: seconds of the eager warm-up of every
    branch and of the capture itself, and the kernel calls recorded into
    the graph (``ops.CAPTURED`` during the capture).  It keeps no
    reference to the executor (which holds it), so dropping the executor
    frees the graph and its buffers at once."""

    def __init__(self, executor, params, rs, writes):
        self.params = params                # the graph reads these addresses
        self.table, self.runtime = rs.table, rs.runtime
        self.telemetry = rs.proxy_trace is not None
        dev = executor.device
        batch = int(rs.x.shape[0])
        types = self.table.types
        self.buf = {name: None if v is None else torch.zeros_like(v)
                    for name, v in self._state(rs)}
        self.buf["pred"] = torch.zeros_like(rs.x)
        self.buf["step"] = torch.zeros(1, dtype=torch.int64, device=dev)
        self.buf["tau"], self.buf["k_max"] = calibration.rule_limits(
            0.0, 0, dev)
        self.buf["weights"] = torch.tensor(
            [1 << i for i in range(len(types))], dtype=torch.int32,
            device=dev)
        self.cache = [tuple({n: torch.zeros_like(v) for n, v in d.items()}
                            for d in stage) for stage in rs.cache]
        self.leaves = cache_leaves(rs.cache)
        #: per branch, the (stage, block, name) entries its model call writes
        self.writes = writes
        self.batch = batch
        self.graph = None
        self.stats: Dict = {"batch": batch, "types": list(types),
                            "branches": len(self.table.branches),
                            "runtime": self.runtime,
                            "telemetry": self.telemetry, "warmup_s": None,
                            "capture_s": None, "captured": None}
        if dev.type == "cuda":
            self._load(rs)
            self._capture(executor)

    @staticmethod
    def _state(rs):
        return (("x", rs.x), ("x_prev", rs.x_prev), ("acc", rs.acc),
                ("lag", rs.lag), ("trace", rs.trace),
                ("healthy", rs.healthy), ("a", rs.coeff_a),
                ("b", rs.coeff_b), ("skip_table", rs.skip_table),
                ("label", rs.label), ("proxy_trace", rs.proxy_trace))

    def _load(self, rs):
        """Copy a run state into the buffers (device to device)."""
        for name, v in self._state(rs):
            if v is not None:
                self.buf[name].copy_(v)
        self.buf["step"].fill_(rs.step)
        self.buf["tau"].fill_(rs.tau)
        self.buf["k_max"].fill_(rs.k_max)
        for si, bi, name in self.leaves:
            self.cache[si][bi][name].copy_(rs.cache[si][bi][name])

    # -- the step ------------------------------------------------------------

    def _step(self, ex, pick):
        """One adaptive step of ``ex``'s model and solver on the buffers.
        ``pick(code, i)`` is a context manager yielding whether branch
        ``i`` runs: a Python comparison on the CPU, a forced branch in the
        warm-up, an IF node under capture."""
        b = self.buf
        x, s = b["x"], b["step"]
        acc, lag = b["acc"], b["lag"]
        if self.runtime or self.telemetry:
            proxy = calibration.rel_l1_change_rows(x, b["x_prev"])
        if self.runtime:
            want, bits, acc, lag = calibration.batch_rule(
                proxy, acc, lag, b["a"], b["b"], b["tau"], b["k_max"],
                force_compute=s == 0)
        else:
            bits = b["skip_table"].index_select(0, s)[0]
            want = bits.expand(acc.shape)
        code = (bits.to(torch.int32) * b["weights"]).sum()
        t = ex._times(s, self.batch)
        for i, sig in enumerate(self.table.branches):
            with pick(code, i) as taken:
                if not taken:
                    continue
                skip = sig.skip
                pred, computed = ex._model_call(
                    self.params, x, t, b["label"],
                    self.cache if any(skip.values()) else None,
                    skip=skip, collect=frozenset(sig.collect))
                b["pred"].copy_(pred)
                for si, bi, name in self.writes[i]:
                    self.cache[si][bi][name].copy_(computed[si][bi][name])
        x_next = ex.solver.step(x, b["pred"], s)
        b["trace"].index_copy_(0, s, want.unsqueeze(0))
        if self.telemetry:
            b["proxy_trace"].index_copy_(0, s, proxy.unsqueeze(0))
        healthy = (b["healthy"] & rows_finite(x_next)
                   & torch.isfinite(acc).all(dim=-1))
        b["x_prev"].copy_(x)
        x.copy_(x_next)
        if self.runtime:
            b["acc"].copy_(acc)
            b["lag"].copy_(lag)
        b["healthy"].copy_(healthy)
        s.add_(1)

    @staticmethod
    @contextlib.contextmanager
    def _pick_host(code, i):
        yield int(code) == i                 # a CPU tensor: no device wait

    # -- capture ---------------------------------------------------------------

    def _warm_up(self, ex, on_stream=lambda i: contextlib.nullcontext()):
        """Every branch once, eagerly, each inside ``on_stream(i)``.  Each
        pass starts at step 0: the loaded run state may sit at any step
        (a split or merge at a late chunk boundary builds a graph there),
        and one pass per branch from that step would index the model
        times, the DDIM tables, the skip table and the trace past the
        last step.  ``run`` loads the run state again before replaying."""
        for forced in range(len(self.table.branches)):
            self.buf["step"].zero_()

            @contextlib.contextmanager
            def pick(code, i, forced=forced):
                yield i == forced

            with on_stream(forced):
                self._step(ex, pick)

    def _capture(self, ex):
        cap = ex._graph_capture()
        main = torch.cuda.current_stream()

        @contextlib.contextmanager
        def on_side(i):
            # the stream branch i's IF body will capture from
            side = cap.stream(i)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                yield
            main.wait_stream(side)

        # warm-up: the kernel library, cuBLAS handles and workspaces, and
        # the step tables on the device exist before the capture starts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._warm_up(ex, on_side)
        torch.cuda.synchronize()
        self.stats["warmup_s"] = time.perf_counter() - t0
        graph = torch.cuda.CUDAGraph()

        @contextlib.contextmanager
        def pick(code, i):
            with cap.if_body(code, i):
                yield True

        before = dict(ops.CAPTURED)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=cap.pool,
                              capture_error_mode=cuda_graphs.CAPTURE_MODE[0]):
            self._step(ex, pick)
        torch.cuda.synchronize()
        self.stats["capture_s"] = time.perf_counter() - t0
        self.stats["captured"] = {k: ops.CAPTURED[k] - before[k]
                                  for k in before}
        self.graph = graph

    # -- a chunk ----------------------------------------------------------------

    def run(self, ex, rs, n: int) -> dict:
        """Copy ``rs`` in, run ``n`` steps, copy the state out: new
        tensors, device to device, with no host read.  ``ex`` is the
        executor the step was built for (its model and solver run the
        eager step on the CPU)."""
        self._load(rs)
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step(ex, self._pick_host)
        return self._unload()

    def _unload(self) -> dict:
        """The run state's tensors, copied out of the buffers."""
        b = self.buf
        out = {"x": b["x"].clone(), "x_prev": b["x_prev"].clone(),
               "acc": b["acc"].clone(), "lag": b["lag"].clone(),
               "trace": b["trace"].clone(),
               "healthy": b["healthy"].clone(),
               "cache": [tuple({k: v.clone() for k, v in d.items()}
                               for d in stage) for stage in self.cache]}
        if self.telemetry:
            out["proxy_trace"] = b["proxy_trace"].clone()
        return out


def graph_key(rs, params) -> tuple:
    """What a captured step is specialized on: the batch, the pool's
    branch table, τ > 0 or not, labels or not, step telemetry or not, and
    the parameters (read by address).  τ and k_max are not in it: they
    are buffers."""
    return (int(rs.x.shape[0]), rs.table, rs.runtime, rs.label is not None,
            rs.proxy_trace is not None, id(params))
