"""The compiled LM decode step (``launch/decode_graph.py``: one captured
CUDA graph per decode shape behind ``generate``) against the JAX
package's jitted ``step(tok, pos, caches)``, on the smoke variants of the
nine LM families: Qwen3 (GQA, qk-norm), Gemma-2 (a local window of 16
under a 24-token prompt: the ring wraps twice in 31 steps), MiniCPM3
(MLA), DeepSeek-V3 (MLA + MoE, a gshard decode), RecurrentGemma (RG-LRU
states beside a ring KV cache), Mamba-2 (SSD states), MusicGen (4
codebooks, sinusoidal positions, a memory), and the prefix LMs InternVL2
and Llama-4 (MoE) through ``launch.programs``.  The weights are each
config's JAX init plus a seeded 0.05·N(0,1) on every leaf, handed to both
packages through numpy; prompts, prefixes and memories come from numpy.

On the CPU a ``DecodeGraph`` runs the step a card captures eagerly on
its buffers, so these tests hold that body:
- ``decode_step`` at a ``(1,)`` int64 position tensor is bitwise the step
  at the int position, logits and every cache leaf;
- 31 greedy steps of the graph body give the JAX package's ``generate``
  tokens (the prefix LMs: its prefill with the prefix, then its jitted
  step at traced positions P + L + i), and the host-launched steps
  (``decode`` on the CPU or with ``graphs=False``) give the body's tokens
  and last logits bitwise;
- each step's logits are within 5e-5 (atol and rtol, f32) of the JAX
  package's jitted step at a traced position fed the same tokens, and its
  ``slots`` equal the JAX package's at every step;
- a generation longer than its cache (a ring window, a state cache)
  gives the JAX package's tokens;
- one graph kept per config and parameters, reused for the same key and
  replaced for a new one, and gone with its weights; a sampled generation
  draws from the caller's generator between the steps as the host loop
  did; a graph rebuilt once a weight was replaced or changed in place or
  a prepared copy it holds was dropped.
The card tests capture the graph and hold its replays against the
uncaptured step bitwise, and a capture that fails raises; they skip
without a CUDA device.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import gemm
from repro_torch.launch import decode_graph, programs as tprog
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn, transformer as tT

STEPS = 31
# arch: (batch, prompt length, seed of the weights' noise)
FAMILIES = {"qwen3-14b": (2, 12, 41), "gemma2-9b": (2, 24, 42),
            "minicpm3-4b": (2, 12, 43), "deepseek-v3-671b": (2, 12, 44),
            "recurrentgemma-2b": (2, 12, 45), "mamba2-1.3b": (2, 12, 46),
            "musicgen-medium": (2, 12, 47), "internvl2-1b": (2, 12, 48),
            "llama4-maverick-400b-a17b": (2, 12, 49)}
ARCHS = list(FAMILIES)
MEMORY = 16          # memory tokens of a cross-attention model


def _cfgs(arch):
    return jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    cfg, _ = _cfgs(arch)
    p = jax.jit(jT.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(FAMILIES[arch][2])
    return jax.tree.map(
        lambda a: (np.asarray(a)
                   + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """(prompts (B, L[, K]) int32, prefix (B, P, d) or None, memory (B,
    16, cond_dim) or None), numpy."""
    _, tcfg = _cfgs(arch)
    b, l, seed = FAMILIES[arch]
    rng = np.random.default_rng(seed + 100)
    cb = (tcfg.num_codebooks,) if tcfg.num_codebooks > 1 else ()
    prompts = rng.integers(0, tcfg.vocab_size, (b, l) + cb).astype(np.int32)
    prefix = ((0.02 * rng.standard_normal(
        (b, tcfg.num_prefix_embeds, tcfg.d_model))).astype(np.float32)
        if tcfg.num_prefix_embeds else None)
    memory = (rng.standard_normal((b, MEMORY, tcfg.cond_dim)).astype(
        np.float32) if tcfg.cond_dim else None)
    return prompts, prefix, memory


def _start(arch):
    """The first decode step's position: P + L."""
    prompts, prefix, _ = _inputs(arch)
    return prompts.shape[1] + (0 if prefix is None else prefix.shape[1])


def _cache_len(arch):
    return _start(arch) + STEPS + 1


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _port_prefill(arch):
    """The port's prefill (the prefix LMs through ``launch.programs``):
    (params, the first greedy token, caches, memory)."""
    _, tcfg = _cfgs(arch)
    pt = params_from_numpy(_numpy_params(arch), device="cpu")
    prompts, prefix, memory = _inputs(arch)
    mem = _torch(memory)
    logits, caches = tprog.make_prefill_step(
        tcfg, _cache_len(arch), moe_strategy="dense")(
        pt, torch.from_numpy(prompts).long(), _torch(prefix), mem)
    return pt, torch.argmax(logits, dim=-1), caches, mem


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    cfg, _ = _cfgs(arch)
    pj = jax.tree.map(jnp.asarray, _numpy_params(arch))
    _, _, memory = _inputs(arch)
    mem = None if memory is None else jnp.asarray(memory)
    return pj, mem, jax.jit(lambda tok, pos, caches: jT.decode_step(
        cfg, pj, tok, pos, caches, memory=mem))


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch):
    """The JAX package's greedy tokens (B, 32[, K]): its ``generate``, or
    for a prefix LM its prefill with the prefix and its jitted step at
    traced positions P + L + i."""
    cfg, _ = _cfgs(arch)
    prompts, prefix, memory = _inputs(arch)
    pj, mem, step = _jax_step(arch)
    if prefix is None:
        return np.asarray(jserve.generate(cfg, pj, jnp.asarray(prompts),
                                          STEPS + 1, memory=mem))
    logits, caches = jT.prefill(cfg, pj, jnp.asarray(prompts),
                                cache_len=_cache_len(arch),
                                prefix_embeds=jnp.asarray(prefix),
                                cache_dtype=jnp.float32, moe_strategy="dense")
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    out = [tok]
    for i in range(STEPS):
        lg, caches = step(tok, jnp.asarray(_start(arch) + i), caches)
        tok = jnp.argmax(lg, axis=-1)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def _graph(arch, pt, tok, caches, mem, cache_len=None):
    _, tcfg = _cfgs(arch)
    key = decode_graph.decode_key(tcfg, pt, tok.shape[0],
                                  cache_len or _cache_len(arch), mem)
    return decode_graph.DecodeGraph(tcfg, pt, key, caches, mem)


@functools.lru_cache(maxsize=None)
def _graph_body(arch):
    """The graph body run eagerly for 31 greedy steps from the port's
    prefill: (tokens (B, 32[, K]), each step's logits, each step's
    ``slots`` leaves)."""
    pt, tok, caches, mem = _port_prefill(arch)
    g = _graph(arch, pt, tok, caches, mem)
    logits, slots = [], []

    def pick(lg):
        logits.append(lg.clone())
        slots.append([c["slots"].clone() for st in g.buf.caches for c in st
                      if c is not None and "slots" in c])
        return torch.argmax(lg, dim=-1)

    tokens, _ = g.run(pt, caches, tok, _start(arch), STEPS, memory=mem,
                      pick=pick)
    return tokens, logits, slots


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_step_is_bitwise_the_int_one(arch):
    """Three decode steps at int positions and at the same positions as
    ``(1,)`` int64 tensors, each on its own copy of the prefill's caches:
    the logits and every cache leaf bitwise."""
    _, tcfg = _cfgs(arch)
    pt, tok, caches, mem = _port_prefill(arch)
    copies = [tT.tree_map(torch.clone, caches) for _ in range(2)]
    for i in range(3):
        pos = _start(arch) + i
        li, copies[0] = tT.decode_step(tcfg, pt, tok, copies[0], pos=pos,
                                       memory=mem)
        lt, copies[1] = tT.decode_step(
            tcfg, pt, tok, copies[1],
            pos=torch.tensor([pos], dtype=torch.int64), memory=mem)
        assert torch.equal(li, lt)
        a, b = (tT.tree_leaves(c) for c in copies)
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
        tok = torch.argmax(li, dim=-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_body_gives_the_jax_greedy_tokens(arch):
    tokens, _, _ = _graph_body(arch)
    want = _jax_greedy(arch)
    assert tuple(tokens.shape) == want.shape
    np.testing.assert_array_equal(want, tokens.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_host_steps_are_bitwise_the_graph_body(arch):
    """``decode`` on the CPU (as with ``graphs=False`` on a card) runs the
    step from the host on the prefill's own caches: the graph body's
    tokens and last logits, bitwise, and no graph kept."""
    _, tcfg = _cfgs(arch)
    pt, tok, caches, mem = _port_prefill(arch)
    tokens, logits, _ = _graph_body(arch)
    got, last = decode_graph.decode(tcfg, pt, tok, caches, _start(arch),
                                    STEPS, cache_len=_cache_len(arch),
                                    memory=mem)
    assert torch.equal(got, tokens)
    assert torch.equal(last, logits[-1])
    assert decode_graph.graphs() == []


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_body_matches_the_jitted_step_at_every_position(arch):
    """The JAX package's step, jitted with the position traced, fed the
    graph body's tokens from the JAX package's own prefill: each step's
    logits within 5e-5 and its ``slots`` equal, at all 31 positions."""
    cfg, _ = _cfgs(arch)
    prompts, prefix, memory = _inputs(arch)
    pj, mem, step = _jax_step(arch)
    _, caches = jT.prefill(cfg, pj, jnp.asarray(prompts),
                           cache_len=_cache_len(arch),
                           prefix_embeds=(None if prefix is None
                                          else jnp.asarray(prefix)),
                           memory=mem, cache_dtype=jnp.float32,
                           moe_strategy="dense")
    tokens, logits, slots = _graph_body(arch)
    for i in range(STEPS):
        lg, caches = step(jnp.asarray(tokens[:, i:i + 1].numpy()),
                          jnp.asarray(_start(arch) + i), caches)
        close(lg, logits[i])
        want = [np.asarray(c["slots"]) for st in caches for c in st
                if c is not None and "slots" in c]
        assert len(want) == len(slots[i])
        for w, s in zip(want, slots[i]):
            np.testing.assert_array_equal(w, s.numpy())


@pytest.mark.parametrize("window,cache_len,pos", [
    (None, 12, 7), (None, 8, 10), (4, 6, 9), (16, 16, 40), (32, 16, 20)])
def test_decode_slot_on_the_device_matches_the_int_one(window, cache_len,
                                                       pos):
    """The slot from a ``(1,)`` int64 position: a ring (``pos % S``) under
    a window that fits the cache, else ``min(pos, S - 1)``."""
    _, tcfg = _cfgs("qwen3-14b")
    spec = dataclasses.replace(tcfg.stages[0].unit[0].mixer, window=window)
    got = tattn.decode_slot(spec, torch.tensor([pos]), cache_len)
    assert got.dtype == torch.int64 and tuple(got.shape) == (1,)
    assert int(got) == tattn.decode_slot(spec, pos, cache_len)


def _generate(arch, pt, prompts, gen, **kw):
    _, tcfg = _cfgs(arch)
    _, _, memory = _inputs(arch)
    return tserve.generate(tcfg, pt, prompts, gen, memory=_torch(memory),
                           device="cpu", **kw)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_a_generation_longer_than_its_cache(arch):
    """32 tokens over a cache of 16 slots: RecurrentGemma's local ring
    (window 16) wraps, Mamba-2 keeps only states.  ``generate`` and the
    graph body both give the JAX package's ``generate`` tokens."""
    cfg, tcfg = _cfgs(arch)
    prompts, _, _ = _inputs(arch)
    pj, _, _ = _jax_step(arch)
    want = np.asarray(jserve.generate(cfg, pj, jnp.asarray(prompts),
                                      STEPS + 1, cache_len=16))
    pt = params_from_numpy(_numpy_params(arch), device="cpu")
    got = _generate(arch, pt, torch.from_numpy(prompts).long(), STEPS + 1,
                    cache_len=16)
    np.testing.assert_array_equal(want, got.numpy())
    logits, caches = tT.prefill(tcfg, pt, torch.from_numpy(prompts).long(),
                                cache_len=16, moe_strategy="dense")
    tok = torch.argmax(logits[:, -1:], dim=-1)
    g = _graph(arch, pt, tok, caches, None, cache_len=16)
    body, _ = g.run(pt, caches, tok, prompts.shape[1], STEPS)
    np.testing.assert_array_equal(want, body.numpy())


def test_one_graph_kept_per_config_and_params():
    """The same key finds the kept graph, whatever the prompt length; a
    new batch or cache length replaces it; another parameter tree gets
    its own; ``generate`` on the CPU keeps none."""
    arch = "qwen3-14b"
    _, tcfg = _cfgs(arch)
    pt, tok, caches, mem = _port_prefill(arch)
    decode_graph.release()
    try:
        g = decode_graph.decoder(tcfg, pt, 2, 18, caches)
        assert decode_graph.decoder(tcfg, pt, 2, 18, caches) is g
        assert decode_graph.lookup(decode_graph.decode_key(
            tcfg, pt, 2, 18)) is g
        shapes = []
        for batch, cache_len in ((1, 18), (2, 20)):
            h = decode_graph.decoder(tcfg, pt, batch, cache_len, caches)
            assert h is not g and list(decode_graph._GRAPHS.values()) == [h]
            shapes.append((h.key.batch, h.key.cache_len))
            g = h
        assert shapes == [(1, 18), (2, 20)]
        assert decode_graph.lookup(decode_graph.decode_key(
            tcfg, pt, 2, 18)) is None
        other = params_from_numpy(_numpy_params(arch), device="cpu")
        decode_graph.decoder(tcfg, other, 2, 20, caches)
        assert len(decode_graph.graphs()) == 2
        assert all(r["capture_s"] is None and r["replays"] == 0
                   for r in decode_graph.graphs())
        decode_graph.release()
        prompts = torch.from_numpy(_inputs(arch)[0]).long()
        _generate(arch, pt, prompts, 6)
        assert decode_graph.graphs() == []
    finally:
        decode_graph.release()


def test_a_graph_goes_with_its_weights():
    """A kept graph holds its parameter tree only weakly: once the caller
    drops the weights, the graph and its buffers go too."""
    arch = "qwen3-14b"
    _, tcfg = _cfgs(arch)
    pt, tok, caches, mem = _port_prefill(arch)
    decode_graph.release()
    try:
        g = decode_graph.decoder(tcfg, pt, 2, _cache_len(arch), caches)
        g.run(pt, caches, tok, _start(arch), 3)
        buffers = weakref.ref(g.buf)
        del g, pt
        gc.collect()
        assert decode_graph.graphs() == [] and buffers() is None
    finally:
        decode_graph.release()


@pytest.mark.parametrize("arch", ["qwen3-14b", "musicgen-medium"])
def test_sampling_draws_from_the_generator_between_steps(arch):
    """At temperature > 0 the graph stops at the logits and the caller's
    generator draws each token between the steps: the tokens equal the
    eager host loop's (prefill, pick, then ``decode_step`` and pick at
    each position) from the same generator, bitwise; another seed gives
    other tokens."""
    _, tcfg = _cfgs(arch)
    pt = params_from_numpy(_numpy_params(arch), device="cpu")
    prompts, _, memory = _inputs(arch)
    prompts, mem = torch.from_numpy(prompts).long(), _torch(memory)
    runs = [_generate(arch, pt, prompts, 8, temperature=0.7,
                      generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    gen = torch.Generator().manual_seed(5)
    plen = prompts.shape[1]
    logits, caches = tT.prefill(tcfg, pt, prompts, cache_len=plen + 8,
                                memory=mem, moe_strategy="dense")
    tok = tserve._pick(logits[:, -1:], 0.7, gen)
    out = [tok]
    for i in range(7):
        lg, caches = tT.decode_step(tcfg, pt, tok, caches, pos=plen + i,
                                    memory=mem)
        tok = tserve._pick(lg, 0.7, gen)
        out.append(tok)
    assert torch.equal(torch.cat(out, dim=1), runs[0])
    # the graph body, from the same generator: its pick runs between steps
    gen = torch.Generator().manual_seed(5)
    logits, caches = tT.prefill(tcfg, pt, prompts, cache_len=plen + 8,
                                memory=mem, moe_strategy="dense")
    tok = tserve._pick(logits[:, -1:], 0.7, gen)
    g = _graph(arch, pt, tok, caches, mem, cache_len=plen + 8)
    body, _ = g.run(pt, caches, tok, plen, 7, memory=mem,
                    pick=lambda lg: tserve._pick(lg, 0.7, gen))
    assert torch.equal(body, runs[0])


def test_the_graphs_refuse_what_they_cannot_hold():
    """A graph's buffers take one token shape, and a memory only if it was
    built with one."""
    arch = "qwen3-14b"
    pt, tok, caches, mem = _port_prefill(arch)
    g = _graph(arch, pt, tok, caches, mem)
    with pytest.raises(ValueError, match="token of shape"):
        g.run(pt, caches, tok[:1], _start(arch), 2)
    with pytest.raises(ValueError, match="without a memory"):
        g.run(pt, caches, tok, _start(arch), 2, memory=torch.zeros(2, 4, 8))


def test_an_in_place_weight_update_or_a_dropped_copy_rebuilds_the_graph():
    """A weight changed in place or replaced leaves a graph's captured
    addresses and prepared halves behind, and ``gemm.release`` drops the
    copies it holds: each makes the graph stale, and the next decode
    builds it anew and decodes the weights as they are.  On the CPU no capture prepares a copy: the test
    hands the graph the copies a capture would hold."""
    arch = "qwen3-14b"
    _, tcfg = _cfgs(arch)
    pt, tok, caches, mem = _port_prefill(arch)

    def run():
        g = decode_graph.decoder(tcfg, pt, 2, _cache_len(arch), caches)
        return g, g.run(pt, caches, tok, _start(arch), 5)[0]

    decode_graph.release()
    try:
        g, a = run()
        g._halves = [gemm.prepare(w) for w in tT.token_weights(pt)]
        g._dropped = gemm.dropped()
        assert not g.stale(pt)
        gemm.release()
        assert g.stale(pt)
        g2, again = run()
        assert torch.equal(again, a)
        assert g2 is not g and len(decode_graph._GRAPHS) == 1
        with torch.no_grad():
            pt["final_norm"]["scale"].add_(0.5)
        assert g2.stale(pt)
        g3, b = run()
        assert g3 is not g2
        want, _ = decode_graph.decode(
            tcfg, pt, tok, tT.tree_map(torch.clone, caches), _start(arch), 5,
            cache_len=_cache_len(arch))
        assert torch.equal(b, want)
        pt["final_norm"]["scale"] = pt["final_norm"]["scale"].clone()
        assert g3.stale(pt)
        g4, c = run()
        assert g4 is not g3 and torch.equal(c, b)
    finally:
        gemm.release()
        decode_graph.release()


# ---------------------------------------------------------------------------
# On a card: the captured graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step is a captured CUDA "
                    "graph there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_graph_replays_equal_the_uncaptured_step(cuda, arch):
    _, tcfg = _cfgs(arch)
    pt = params_from_numpy(_numpy_params(arch), device="cuda")
    tT.prepare_linear(pt)
    prompts, prefix, memory = _inputs(arch)
    mem = None if memory is None else torch.from_numpy(memory).cuda()
    logits, caches = tprog.make_prefill_step(
        tcfg, _cache_len(arch), moe_strategy="dense")(
        pt, torch.from_numpy(prompts).long().cuda(),
        None if prefix is None else torch.from_numpy(prefix).cuda(), mem)
    tok = torch.argmax(logits, dim=-1)
    try:
        runs = []
        for graphs in (True, False, True):
            # the host-launched steps update the caches they are given
            runs.append(decode_graph.decode(
                tcfg, pt, tok, caches if graphs else tT.tree_map(
                    torch.clone, caches), _start(arch), STEPS,
                cache_len=_cache_len(arch), memory=mem, graphs=graphs))
        g = decode_graph.lookup(decode_graph.decode_key(
            tcfg, pt, tok.shape[0], _cache_len(arch), mem))
        assert g.graph is not None and g.replays == 2 * STEPS
        for toks, lg in runs[1:]:
            assert torch.equal(toks, runs[0][0])
            assert torch.equal(lg, runs[0][1])
    finally:
        decode_graph.release()
        gemm.release()


def test_cuda_a_failed_capture_raises(cuda, monkeypatch):
    """A decode step that fails while its graph captures: ``generate``
    raises the fault, and nothing falls back to the uncaptured step."""
    arch = "qwen3-14b"
    _, tcfg = _cfgs(arch)
    pt = params_from_numpy(_numpy_params(arch), device="cuda")
    prompts = torch.from_numpy(_inputs(arch)[0]).long().cuda()
    real = tT.decode_step

    class Broken(RuntimeError):
        pass

    def step(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise Broken("a fault inside the capture")
        return real(*a, **kw)

    monkeypatch.setattr(tT, "decode_step", step)
    try:
        with pytest.raises(Broken):
            tserve.generate(tcfg, pt, prompts, 4)
        g = next(iter(decode_graph._GRAPHS.values()))
        assert g.graph is None and g.replays == 0
    finally:
        decode_graph.release()
        gemm.release()
