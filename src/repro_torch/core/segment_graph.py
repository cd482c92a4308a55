"""The segmented path's step: one captured CUDA graph per plan signature.

The JAX package runs a plan segment as one jitted program per signature
(``SmoothCacheExecutor._get_sig_loop_fn``): model, solver step and health
fold under ``lax.fori_loop`` over a dynamic ``[start, start + length)``,
so one compilation serves every segment of that mask at any length or
position.  Its counterpart here captures **one step** of a signature into
a CUDA graph over fixed buffers, with a ``(1,)`` int64 device step
counter that indexes the model times and the solver's coefficient tables
(``solvers.StepTable.at``) and that the graph advances; a segment of
``length`` steps is ``length`` replays enqueued back to back, so one
graph serves every segment of its signature too, and a segment makes no
host read.

A non-scannable solver (DPM++(3M) SDE branches in Python on the step
index and on its state's structure) gets a model-only graph instead: the
graph runs the model call and the cache writes, and the solver step, its
noise and the health fold run eagerly between replays with the Python
step index — the counterpart of JAX's ``_get_sig_model_fn``.

One :class:`SegmentGraph` exists per :class:`SegmentKey` — batch,
signature, labelled or not, memory shape and parameters — which is the
``("seg", signature, batch)`` variant the executor records, so the graph
count is bounded by a serving engine's program budget.  The graphs of one
(batch, labelled, memory shape) read and write one set of fixed tensors,
:class:`SegmentBuffers`: the latent, health flags, label, memory, the
step counter, the solver state and the branch cache, one tensor per cache
entry that any of them holds.  A segment copies the run state in (only
the entries its mask reads), replays, and copies the state out (only the
entries the next segment reads), device to device on one stream, so run
states stay ordinary tensors that ``split_run`` / ``merge_runs`` /
``export_run`` handle as before, and graphs that share the buffers never
see each other's data.

On the CPU (the tests), and on a card with ``graphs=False`` (the A/B),
the same step runs eagerly on the same buffers, with the step as a
``(1,)`` tensor, so the tests run the body a card captures.  On a CUDA
device there is no eager fallback: a failed capture raises.  A plain
graph needs no conditional node, so this path shares the executor's
memory pool with the fused graphs but not their IF-node helper.

A captured graph reads the linear kernel's prepared weight halves by
address, so it holds the ``gemm.Prepared`` copies it captured: a
``gemm.release`` cannot free them under it.  It is stale (rebuilt by the
executor) once a weight changed in place or a copy it holds is no longer
its weight's current one.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cuda_graphs, diffusion
from repro_torch.core.fused import rows_finite
from repro_torch.kernels import gemm, ops

#: boundaries whose copy-in / copy-out events a graph keeps for its stats
COPY_EVENTS_KEPT = 256
_TIME_COPIES = [False]


@contextlib.contextmanager
def timing_copies():
    """Inside the block, a captured graph's segments time their copy in
    and copy out with CUDA events (``SegmentGraph.copy_ms``); outside it
    a segment records no event."""
    _TIME_COPIES[0] = True
    try:
        yield
    finally:
        _TIME_COPIES[0] = False


class SegmentKey(NamedTuple):
    """What a segment graph is specialized on: the batch, the plan
    signature (mask and canonical collect set), labels or not, the
    memory's shape (None without one) and the parameters (read by
    address)."""
    batch: int
    sig: object
    labelled: bool
    memory_shape: Optional[tuple]
    params: int

    @property
    def buffers(self) -> tuple:
        """The key of the :class:`SegmentBuffers` the graph works on."""
        return (self.batch, self.labelled, self.memory_shape)


def segment_key(rs, sig, params) -> SegmentKey:
    return SegmentKey(int(rs.x.shape[0]), sig, rs.label is not None,
                      None if rs.memory is None else tuple(rs.memory.shape),
                      id(params))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        if isinstance(tree, torch.Tensor):
            yield tree
        return
    for v in tree:
        yield from _tensors(v)


class SegmentBuffers:
    """The fixed tensors of every segment graph of one (batch, labelled,
    memory shape).  Cache entries are made as the graphs that hold them
    are built (``(repeat, rows, tokens, d_model)`` each, rows doubled
    under CFG)."""

    def __init__(self, ex, rs):
        dev = ex.device
        self.x = torch.zeros_like(rs.x)
        self.pred = torch.zeros_like(rs.x)
        self.healthy = torch.ones(rs.x.shape[0], dtype=torch.bool,
                                  device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.label = (None if rs.label is None
                      else torch.zeros_like(rs.label))
        self.memory = (None if rs.memory is None
                       else torch.zeros_like(rs.memory))
        #: a scannable solver's state; a non-scannable one's stays eager
        self.state = ({k: torch.zeros_like(v) for k, v in rs.state.items()}
                      if ex.solver.scannable else {})
        self.cache = [tuple({} for _ in st.unit) for st in ex.cfg.stages]
        self._structs = ex._branch_structs(int(rs.x.shape[0]))
        self._device = dev
        self.bytes = sum(_nbytes(t) for t in (
            self.x, self.pred, self.healthy, self.step, self.label,
            self.memory, *self.state.values()) if t is not None)

    def entries(self, names) -> int:
        """Make the cache entries ``names`` ((stage, block, branch)
        triples) that do not exist yet; returns the bytes they add."""
        added = 0
        for si, bi, name in names:
            d = self.cache[si][bi]
            if name not in d:
                d[name] = torch.zeros(self._structs[si][bi][name],
                                      device=self._device)
                added += _nbytes(d[name])
        self.bytes += added
        return added


class SegmentGraph:
    """One signature's step on its :class:`SegmentBuffers`: a captured
    CUDA graph on a CUDA device, the eager step on the CPU.

    ``stats`` records what it cost: the eager warm-up's and the capture's
    seconds, the kernel calls the warm-up launched, the calls recorded
    into the graph (``ops.CAPTURED`` during the capture: a replay
    launches these, and adds them to ``ops.REPLAYED``), the bytes of the
    buffers it added and of the device memory its capture keeps reserved
    (its share of the executor's graph pool); ``replays`` counts the
    steps run.  ``capture=False`` builds the step without capturing it
    (the CPU, and ``graphs=False`` on a card).  It keeps no reference to
    the executor (which holds it), so dropping the executor frees the
    graph and its buffers at once."""

    def __init__(self, ex, params, rs, sig, buffers: SegmentBuffers, *,
                 capture: bool):
        from repro_torch.core.executor import cache_entry_names
        self.params = params                # the graph reads these addresses
        #: the weights' versions at the build: an in-place update leaves
        #: the linear kernel's captured prepared halves behind
        self._versions = [(w, w._version) for w in _tensors(params)]
        #: the prepared halves the capture read (held), and the count of
        #: dropped copies when they were last found current
        self._halves: List[gemm.Prepared] = []
        self._dropped = gemm.dropped()
        self.sig = sig
        self.buf = buffers
        self.scannable = ex.solver.scannable
        self.batch = int(rs.x.shape[0])
        self.reads_cache = any(sig.skip.values())
        self.collect = frozenset(sig.collect)
        #: the (stage, block, name) entries the model reads / writes
        self.reads = cache_entry_names(ex.cfg, sig.live_in)
        self.writes = cache_entry_names(ex.cfg, sig.collect)
        self._read_set = frozenset(self.reads)
        added = buffers.entries(self.reads + self.writes)
        self.cache = [tuple({} for _ in st.unit) for st in ex.cfg.stages]
        for si, bi, name in self.reads + self.writes:
            self.cache[si][bi][name] = buffers.cache[si][bi][name]
        self.graph = None
        self.replays = 0
        self._copies = collections.deque(maxlen=COPY_EVENTS_KEPT)
        self.stats: Dict = {
            "batch": self.batch,
            "skip": sorted(t for t, sk in sig.skip.items() if sk),
            "collect": list(sig.collect), "scannable": self.scannable,
            "buffer_bytes_added": added, "warmup_s": None,
            "warmup_launches": dict.fromkeys(ops.LAUNCHES, 0),
            "capture_s": None, "captured": dict.fromkeys(ops.LAUNCHES, 0),
            "reserved_bytes": None}
        if capture:
            self._capture(ex, rs)

    def stale(self) -> bool:
        """Whether a weight changed in place since the graph was built, or
        a prepared copy its capture read was dropped or made anew."""
        if any(w._version != v for w, v in self._versions):
            return True
        if self._dropped != gemm.dropped():
            if not all(gemm.current(p) for p in self._halves):
                return True
            self._dropped = gemm.dropped()
        return False

    # -- the step ------------------------------------------------------------

    def _step(self, ex):
        """One step of ``ex``'s model (and, for a scannable solver, its
        solver step and the health fold) on the buffers, at the step
        counter, which it advances."""
        b = self.buf
        s = b.step
        pred, computed = ex._model_call(
            self.params, b.x, ex._times(s, self.batch), b.label, b.memory,
            self.cache if self.reads_cache else None, skip=self.sig.skip,
            collect=self.collect)
        for si, bi, name in self.writes:
            self.cache[si][bi][name].copy_(computed[si][bi][name])
        if self.scannable:
            x_next, state = ex.solver.step(b.x, pred, s, b.state)
            healthy = b.healthy & rows_finite(x_next)
            b.x.copy_(x_next)
            for k, v in state.items():
                if v is not b.state[k]:
                    b.state[k].copy_(v)
            b.healthy.copy_(healthy)
        else:
            b.pred.copy_(pred)
        s.add_(1)

    def _capture(self, ex, rs):
        # a capture cannot make the linear kernel's prepared weights; the
        # graph reads them by address, so it holds them
        ex.prepare_params(self.params)
        self._halves = [gemm.prepare(w)
                        for w in diffusion.token_weights(self.params)]
        self._dropped = gemm.dropped()
        torch.cuda.synchronize()
        # the capture empties the allocator's cache as it starts: measure
        # from an empty cache, so that what stays reserved is the graph's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(ex.device)
        self._load(rs, 0)
        stream = ex._graph_stream()
        stream.wait_stream(torch.cuda.current_stream())
        # warm-up from step 0: the kernel libraries and the step tables on
        # the device exist before the capture starts
        t0 = time.perf_counter()
        launched = dict(ops.LAUNCHES)
        with torch.cuda.stream(stream):
            self._step(ex)
        torch.cuda.synchronize()
        self.stats["warmup_s"] = time.perf_counter() - t0
        self.stats["warmup_launches"] = {k: ops.LAUNCHES[k] - launched[k]
                                         for k in launched}
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.CAPTURED)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=ex._graph_pool(), stream=stream,
                              capture_error_mode=cuda_graphs.CAPTURE_MODE[0]):
            self._step(ex)
        torch.cuda.synchronize()
        self.stats["capture_s"] = time.perf_counter() - t0
        self.stats["captured"] = {k: ops.CAPTURED[k] - before[k]
                                  for k in before}
        self.stats["reserved_bytes"] = (torch.cuda.memory_reserved(ex.device)
                                        - reserved)
        self.graph = graph

    # -- a segment -------------------------------------------------------------

    def _load(self, rs, start: int):
        """Copy the run state into the buffers: the latent, health flags,
        label, memory, a scannable solver's state and the cache entries
        the mask reads; the step counter to ``start``."""
        b = self.buf
        b.x.copy_(rs.x)
        b.healthy.copy_(rs.healthy)
        if b.label is not None:
            b.label.copy_(rs.label)
        if b.memory is not None:
            b.memory.copy_(rs.memory)
        for k, v in b.state.items():
            v.copy_(rs.state[k])
        for si, bi, name in self.reads:
            self.cache[si][bi][name].copy_(rs.cache[si][bi][name])
        b.step.fill_(start)

    def run(self, ex, rs, run, live_out) -> dict:
        """Run the plan segment ``run`` of ``rs``: copy in, one replay a
        step, copy out.  Returns new tensors for the latent, the solver
        state, the health flags and the ``live_out`` cache entries ((stage,
        block, name) triples); an entry the segment only read passes
        through as the run state's own tensor.  No host read."""
        b = self.buf
        graphed = self.graph is not None
        timed = graphed and _TIME_COPIES[0]
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            events[0].record()
        self._load(rs, run.start)
        if timed:
            events[1].record()
        state, healthy = rs.state, rs.healthy
        for s in range(run.start, run.start + run.length):
            if graphed:
                self.graph.replay()
            else:
                self._step(ex)
            self.replays += 1
            if not self.scannable:
                # the solver step between replays, at the Python step
                x, state = ex._solver_step(b.x, b.pred, s, state,
                                           rs.noise_seed)
                healthy = healthy & rows_finite(x)
                b.x.copy_(x)
        if graphed:
            for k, n in self.stats["captured"].items():
                ops.REPLAYED[k] += n * run.length
        if timed:
            events[2].record()
        if self.scannable:
            x = b.x.clone()
            state = {k: v.clone() for k, v in b.state.items()}
            healthy = b.healthy.clone()
        cache = [tuple({} for _ in stage) for stage in rs.cache]
        for si, bi, name in live_out:
            cache[si][bi][name] = (rs.cache[si][bi][name]
                                   if (si, bi, name) in self._read_set
                                   else self.cache[si][bi][name].clone())
        if timed:
            events[3].record()
            self._copies.append(events)
        return {"x": x, "state": state, "healthy": healthy, "cache": cache}

    def copy_ms(self) -> Tuple[List[float], List[float]]:
        """The device ms of the copy in and of the copy out at each of the
        last boundaries timed (``timing_copies``; waits for them to
        finish)."""
        for ev in self._copies:
            ev[3].synchronize()
        return ([ev[0].elapsed_time(ev[1]) for ev in self._copies],
                [ev[2].elapsed_time(ev[3]) for ev in self._copies])
