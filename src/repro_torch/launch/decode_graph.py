"""The compiled LM decode step: one captured CUDA graph per decode shape.

The JAX package jits its decode step with the position as a traced value
(``repro/launch/serve.py::generate``'s ``step(tok, pos, caches)``), so
one compiled program serves every position of a generation.  Its
counterpart here captures **one step** of
``models/transformer.py::decode_step`` into a CUDA graph over fixed
tensors, :class:`DecodeBuffers`: the token in, the position as a ``(1,)``
int64 device tensor, every cache leaf, the memory and the logits.  The
step reads the position only on the device (``attention.decode_slot``;
the KV and latent caches and their ``slots`` are written at that slot by
``index_copy_``) and advances it itself.  A generation is the prefill
(eager, as the JAX package's is not jitted), one device-to-device copy of
its caches into the buffers, and one replay a token.  The graph stops at
the logits: the token is picked between the replays (argmax, or the
caller's ``pick``, as the JAX ``generate`` picks outside its jitted step)
and copied into the token in, with no host read until the end.  The
recurrent decodes (SSD, RG-LRU) return new state tensors, which the step
copies back into their buffers inside the graph; a MoE FFN decodes
``gshard``, static in shape.

A graph is specialized on a :class:`DecodeKey` (config, batch, codebooks,
cache length, memory shape, parameter tree), so a second generation of the
same shape captures nothing, whatever its prompt length or number of new
tokens.  One graph is kept per config and parameter tree, the newest
shape's: a new shape replaces it, and it goes when the tree's embedding
tensor is freed, so that no buffers as large as the KV cache outlive their
weights.  On a CUDA device the step is captured on first use, after one
eager warm-up step (the kernel libraries, cuBLAS's workspace and the
step's allocations exist before the capture), into a private memory pool
that every decode graph shares (they replay one after another on one
stream); a failed capture raises, and nothing falls back.  On the CPU, and
with ``graphs=False`` (``generate(graphs=False)``, the A/B), :func:`decode`
runs the same step from the host on the prefill's own caches and keeps
nothing; the tests run a graph's body on the CPU through
:class:`DecodeGraph` itself.

A replay makes no Python call: its kernel calls are counted in
``ops.REPLAYED`` as the calls captured times the replays, and the RG-LRU
library's launches by pass in ``rglru.REPLAYED`` the same way.  A graph
reads the linear kernel's prepared weight halves by address, so it holds
the ``gemm.Prepared`` copies it captured (``gemm.release`` cannot free
them under it); it is stale, and built anew, once a weight was replaced
or changed in place or a held copy is no longer its weight's current one.
It holds the parameter tree only weakly (the prepared copies hold their
weights' storage, as ``gemm``'s own table of them does).  :func:`release`
drops every graph, its buffers and the pool.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import cuda_graphs
from repro_torch.kernels import gemm, ops, rglru
from repro_torch.models import attention
from repro_torch.models import transformer as T

#: the graph kept for each (config name, parameter tree's id)
_GRAPHS: Dict[tuple, "DecodeGraph"] = {}
#: per CUDA device: the memory pool the decode graphs capture into, and
#: the side stream they warm up and capture on
_POOLS: dict = {}
_STREAMS: dict = {}


class DecodeKey(NamedTuple):
    """What a decode graph is specialized on: the config's name, the
    batch, the codebooks, the cache length, the memory's shape (None
    without one) and the parameters (read by address)."""
    config: str
    batch: int
    codebooks: int
    cache_len: int
    memory_shape: Optional[tuple]
    params: int


def decode_key(cfg: ModelConfig, params, batch: int, cache_len: int,
               memory=None) -> DecodeKey:
    """The key of a generation of ``batch`` sequences over KV caches of
    ``cache_len`` slots."""
    return DecodeKey(cfg.name, int(batch), cfg.num_codebooks, int(cache_len),
                     None if memory is None else tuple(memory.shape),
                     id(params))


def _argmax(logits):
    return torch.argmax(logits, dim=-1)


def _copy_into(dst, src) -> None:
    """Copy the tree ``src`` into the same-structure tree of tensors
    ``dst`` leaf by leaf, skipping a leaf that is ``dst``'s own tensor."""
    for d, s in zip(T.tree_leaves(dst), T.tree_leaves(src)):
        if d is not s:
            d.copy_(s)


class DecodeBuffers:
    """The fixed tensors one decode graph reads and writes: the token in
    ``tok`` (B, 1[, K]), the position ``pos`` ((1,) int64), every cache
    leaf (``caches``, the prefill's structure), the memory and the last
    step's ``logits``."""

    def __init__(self, cfg: ModelConfig, params, key: DecodeKey, caches,
                 memory):
        dev = params["embed"].device
        cb = (key.codebooks,) if key.codebooks > 1 else ()
        self.tok = torch.zeros((key.batch, 1) + cb, dtype=torch.int64,
                               device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.caches = T.tree_map(torch.zeros_like, caches)
        self.memory = None if memory is None else torch.zeros_like(memory)
        # the head's dtype: the embedding's, f32 after a logit softcap
        dtype = (torch.float32 if cfg.logit_softcap
                 else params["embed"].dtype)
        self.logits = torch.zeros((key.batch, 1) + cb + (cfg.vocab_size,),
                                  dtype=dtype, device=dev)
        self.bytes = sum(t.numel() * t.element_size() for t in T.tree_leaves(
            [self.tok, self.pos, self.caches, self.memory, self.logits]))


def _pool(dev):
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    return _POOLS[dev]


def _stream(dev) -> torch.cuda.Stream:
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


class DecodeGraph:
    """One decode shape's step on its :class:`DecodeBuffers`: captured on
    a CUDA device at its first run, run eagerly on the CPU.

    ``stats`` records what it cost: the eager warm-up's and the capture's
    seconds, the kernel calls the warm-up made, the calls recorded into
    the graph (``ops.CAPTURED`` during the capture; a replay launches
    these) and the RG-LRU library's launches by pass in it, the bytes of
    its buffers and of the device memory its capture keeps reserved (its
    share of the decode graphs' pool); ``replays`` counts the graph's
    replays."""

    def __init__(self, cfg: ModelConfig, params, key: DecodeKey, caches,
                 memory=None):
        self.cfg = cfg
        self.key = key
        #: the weights (weakly) and their versions at the build: a weight
        #: replaced or changed in place leaves the graph's addresses and
        #: the linear kernel's captured prepared halves behind
        self._weights = [(weakref.ref(w), w._version)
                         for w in T.tree_leaves(params)]
        #: the prepared halves the capture read (held), and the count of
        #: dropped copies when they were last found current
        self._halves: List[gemm.Prepared] = []
        self._dropped = gemm.dropped()
        self.buf = DecodeBuffers(cfg, params, key, caches, memory)
        self.device = self.buf.pos.device
        self.graph = None
        self.replays = 0
        self.stats: Dict = {
            **key._asdict(), "buffer_bytes": self.buf.bytes,
            "warmup_s": None,
            "warmup_launches": dict.fromkeys(ops.LAUNCHES, 0),
            "capture_s": None, "captured": dict.fromkeys(ops.LAUNCHES, 0),
            "captured_passes": dict.fromkeys(rglru.PASSES, 0),
            "reserved_bytes": None}

    def stale(self, params) -> bool:
        """Whether a weight of ``params`` was replaced or changed in place
        since the graph was built, or a prepared copy its capture read was
        dropped or made anew."""
        leaves = T.tree_leaves(params)
        if len(leaves) != len(self._weights) or any(
                r() is not w or w._version != v
                for (r, v), w in zip(self._weights, leaves)):
            return True
        if self._dropped != gemm.dropped():
            if not all(gemm.current(p) for p in self._halves):
                return True
            self._dropped = gemm.dropped()
        return False

    # -- the step ------------------------------------------------------------

    def _step(self, params) -> None:
        """One decode step on the buffers at their position, which it
        advances: the logits and the recurrent states into their
        buffers (the KV caches are written in place)."""
        b = self.buf
        lg, caches = T.decode_step(self.cfg, params, b.tok, b.caches,
                                   pos=b.pos, memory=b.memory)
        b.logits.copy_(lg)
        _copy_into(b.caches, caches)
        b.pos.add_(1)

    def load(self, caches, tok, start: int, memory=None) -> None:
        """Copy a prefill's state into the buffers: its caches, the token
        ``tok`` at position ``start``, the memory."""
        b = self.buf
        if tuple(tok.shape) != tuple(b.tok.shape):
            raise ValueError(f"token of shape {tuple(tok.shape)}, the graph "
                             f"takes {tuple(b.tok.shape)}")
        if (memory is None) != (b.memory is None):
            raise ValueError("the graph was built with"
                             + ("out" if b.memory is None else "")
                             + " a memory")
        _copy_into(b.caches, caches)
        b.tok.copy_(tok)
        if memory is not None:
            b.memory.copy_(memory)
        b.pos.fill_(start)

    def _capture(self, params, caches, tok, start: int, memory) -> None:
        # a capture cannot make the linear kernel's prepared weights; the
        # graph reads them by address, so it holds them
        T.prepare_linear(params)
        self._halves = [gemm.prepare(w) for w in T.token_weights(params)]
        self._dropped = gemm.dropped()
        dev = self.device
        torch.cuda.synchronize(dev)
        # the capture empties the allocator's cache as it starts: measure
        # from an empty cache, so that what stays reserved is the graph's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.load(caches, tok, start, memory)
        stream = _stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        launched = dict(ops.LAUNCHES)
        with torch.cuda.stream(stream):
            self._step(params)
        torch.cuda.synchronize(dev)
        self.stats["warmup_s"] = time.perf_counter() - t0
        self.stats["warmup_launches"] = {k: ops.LAUNCHES[k] - launched[k]
                                         for k in launched}
        graph = torch.cuda.CUDAGraph()
        before, passes = dict(ops.CAPTURED), rglru.launched()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=_pool(dev), stream=stream,
                              capture_error_mode=cuda_graphs.CAPTURE_MODE[0]):
            self._step(params)
        torch.cuda.synchronize(dev)
        self.stats["capture_s"] = time.perf_counter() - t0
        self.stats["captured"] = {k: ops.CAPTURED[k] - before[k]
                                  for k in before}
        # the library counted the launches the capture recorded
        after = rglru.launched()
        self.stats["captured_passes"] = {k: after[k] - passes[k]
                                         for k in passes}
        self.stats["reserved_bytes"] = (torch.cuda.memory_reserved(dev)
                                        - reserved)
        self.graph = graph

    # -- a generation ----------------------------------------------------------

    @torch.no_grad()
    def run(self, params, caches, tok, start: int, steps: int, *,
            memory=None, pick: Optional[Callable] = None):
        """Decode ``steps`` tokens after ``tok`` (B, 1[, K]), the first at
        position ``start``, from a prefill's ``caches`` (read, not
        written): copy in, then a replay of the captured step a token on
        a CUDA device (captured now if it is not yet), the step run
        eagerly on the CPU; ``pick(logits)`` → token (default argmax)
        between the steps, and no host read.  Returns ((B, steps + 1[,
        K]) tokens, ``tok`` first; the last step's logits)."""
        pick = pick or _argmax
        graphed = self.device.type == "cuda"
        if graphed and self.graph is None:
            self._capture(params, caches, tok, start, memory)
        self.load(caches, tok, start, memory)
        b, out = self.buf, [tok]
        for _ in range(steps):
            if graphed:
                self.graph.replay()
            else:
                self._step(params)
            t = pick(b.logits)
            b.tok.copy_(t)
            out.append(t)
        if graphed:
            self.replays += steps
            for k, n in self.stats["captured"].items():
                ops.REPLAYED[k] += n * steps
            for k, n in self.stats["captured_passes"].items():
                rglru.REPLAYED[k] += n * steps
        return torch.cat(out, dim=1), b.logits.clone()


def decoder(cfg: ModelConfig, params, batch: int, cache_len: int, caches, *,
            memory=None) -> DecodeGraph:
    """The decode graph of this shape (:class:`DecodeKey`), built on first
    use, and built anew when it is stale; ``caches`` (a prefill's) give
    its buffers' structure.  It replaces the graph kept for an earlier
    shape of the same config and parameters."""
    key = decode_key(cfg, params, batch, cache_len, memory)
    slot = (cfg.name, id(params))
    g = _GRAPHS.get(slot)
    if g is not None and g.key == key and not g.stale(params):
        return g
    if g is not None:
        # its buffers and pool share go before the new graph's are made
        _drop(slot)
        del g
    g = _GRAPHS[slot] = DecodeGraph(cfg, params, key, caches, memory)
    # the graph goes with its weights (at exit, with the process)
    g._evict = weakref.finalize(params["embed"], _drop, slot)
    g._evict.atexit = False
    return g


def _drop(slot) -> None:
    g = _GRAPHS.pop(slot, None)
    if g is not None:
        g._evict.detach()


@torch.no_grad()
def decode(cfg: ModelConfig, params, tok, caches, start: int, steps: int, *,
           cache_len: int, memory=None, pick: Optional[Callable] = None,
           graphs: Optional[bool] = None):
    """``steps`` decode steps after a prefill: ``tok`` (B, 1[, K]) is the
    prefill's token, the first step runs it at position ``start`` over
    ``caches`` (KV caches of ``cache_len`` slots), ``memory`` feeds every
    cross branch, ``pick(logits)`` → token (default argmax) picks each
    token.  On a CUDA device the steps replay the decode graph of their
    shape (:func:`decoder`), which reads ``caches`` and leaves them as
    they are; with ``graphs=False``, and on the CPU, the same step runs
    from the host on ``caches`` themselves, which it updates.  Returns
    ((B, steps + 1[, K]) tokens, ``tok`` first; the last step's
    logits)."""
    if graphs is not False and tok.device.type == "cuda":
        g = decoder(cfg, params, tok.shape[0], cache_len, caches,
                    memory=memory)
        return g.run(params, caches, tok, start, steps, memory=memory,
                     pick=pick)
    pick = pick or _argmax
    pos = attention.as_position(start, tok.device)
    out, lg = [tok], None
    for _ in range(steps):
        lg, caches = T.decode_step(cfg, params, tok, caches, pos=pos,
                                   memory=memory)
        pos = pos + 1
        tok = pick(lg)
        out.append(tok)
    return torch.cat(out, dim=1), lg


def lookup(key: DecodeKey) -> Optional[DecodeGraph]:
    """The graph kept for ``key``, if any."""
    g = _GRAPHS.get((key.config, key.params))
    return g if g is not None and g.key == key else None


def graphs() -> List[dict]:
    """One record per decode graph kept: its key, buffer bytes, warm-up
    and capture seconds, the calls captured (by kernel, and the RG-LRU
    library's by pass), the pool bytes its capture reserved, its replays
    (the capture's entries None and 0 for a graph never captured)."""
    return [dict(g.stats, replays=g.replays) for g in _GRAPHS.values()]


def release() -> None:
    """Drop every decode graph, with its buffers and prepared halves, and
    the graphs' memory pool."""
    for slot in list(_GRAPHS):
        _drop(slot)
    _POOLS.clear()
    _STREAMS.clear()
