"""Gradients through the kernel ops (``repro_torch.kernels.autograd``).

On the CPU: the one mechanism with an injected "kernel" (the plain op
plus a known offset) — the forward carries the offset, the gradient is the
plain op's —; ``gradcheck`` in f64 of all four ops through the mechanism
(their plain versions keep f64); the linear layer's closed-form gradient
against autograd of the plain product; no graph and no saved tensor when
no input requires a gradient; and the prepared-copy bookkeeping under
in-place updates (``kernels/gemm.py``).

On a card (skipped here): each op's gradient, its forward the hand-written
kernel and counted in ``ops.LAUNCHES``, against the plain op's autograd,
within 1e-4 of each input's largest |g|.  No JAX here."""
import functools

import pytest
import torch

from repro_torch.kernels import autograd as ag, gemm, ops, ref

F64 = torch.float64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _inputs(name, dtype=torch.float32, seed=0, device="cpu"):
    """(plain function, its inputs) of one op at a small shape."""
    g = _gen(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    if name == "linear":
        args = (r(6, 8), r(8, 4), r(4))
        fn = ref.linear_ref
    elif name == "flash_attention":
        args = (r(1, 5, 4, 8), r(1, 5, 2, 8), r(1, 5, 2, 8))
        fn = functools.partial(ref.flash_attention_ref, causal=True,
                               softcap=20.0)
    elif name == "ssd":
        args = (r(1, 6, 2, 3), torch.rand(1, 6, 2, generator=g,
                                          dtype=dtype) + 0.1,
                torch.rand(2, generator=g, dtype=dtype) + 0.5,
                r(1, 6, 1, 4), r(1, 6, 1, 4))
        fn = functools.partial(ref.ssd_ref, chunk=4)
    else:
        args = (r(2, 5, 3), r(2, 5, 3), r(2, 5, 3), r(2, 5, 3), r(3),
                r(2, 3))
        fn = lambda *t: ref.rglru_scan_ref(*t[:5], 8.0, t[5])  # noqa: E731
    return fn, tuple(a.to(device) for a in args)


OPS = ["linear", "flash_attention", "ssd", "rglru_scan"]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _loss(outs, seed=5):
    g = _gen(seed)
    return sum((o.float() * torch.randn(o.shape, generator=g).to(o.device)
                ).sum() for o in outs)


@pytest.mark.parametrize("name", OPS)
def test_injected_kernel_forward_and_plain_gradient(name):
    fn, args = _inputs(name)
    offset = 0.25

    def kernel(*t):
        out = fn(*t)
        return (tuple(o + offset for o in out) if isinstance(out, tuple)
                else out + offset)

    leaves = [a.clone().requires_grad_(True) for a in args]
    vjp = ag.linear_vjp if name == "linear" else None
    got = _outputs(ag.differentiable(kernel, fn, *leaves, vjp=vjp))
    plain = [a.clone().requires_grad_(True) for a in args]
    want = _outputs(fn(*plain))
    for o, w in zip(got, want):
        torch.testing.assert_close(o.detach(), w.detach() + offset)
    gg = torch.autograd.grad(_loss(got), leaves)
    gw = torch.autograd.grad(_loss(want), plain)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", OPS)
def test_gradcheck_f64_through_the_mechanism(name):
    fn, args = _inputs(name, dtype=F64, seed=1)
    leaves = tuple(a.requires_grad_(True) for a in args)
    vjp = ag.linear_vjp if name == "linear" else None
    assert torch.autograd.gradcheck(
        lambda *t: ag.differentiable(fn, fn, *t, vjp=vjp), leaves,
        eps=1e-6, atol=1e-6, rtol=1e-4)


def test_gradcheck_f64_linear_without_bias_and_partial_inputs():
    x, w, _ = _inputs("linear", dtype=F64, seed=2)[1]
    x.requires_grad_(True)
    out = ag.differentiable(ref.linear_ref, ref.linear_ref, x, w, None,
                            vjp=ag.linear_vjp)
    (gx,) = torch.autograd.grad(out.sum(), [x])
    torch.testing.assert_close(gx, torch.ones(6, 4, dtype=F64) @ w.t())


def test_an_unused_output_gets_no_gradient():
    fn, args = _inputs("ssd", seed=3)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, _ = ag.differentiable(fn, fn, *leaves)
    got = torch.autograd.grad(y.sum(), leaves)
    plain = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(fn(*plain)[0].sum(), plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


def test_no_input_requires_grad_no_graph():
    calls = []

    def kernel(*t):
        calls.append(torch.is_grad_enabled())
        return ref.linear_ref(*t)

    fn, args = _inputs("linear")
    out = ops._call("linear", kernel, ref.linear_ref, *args)
    assert out.grad_fn is None and calls == [True]
    leaves = [a.clone().requires_grad_(True) for a in args]
    with torch.no_grad():
        out = ops._call("linear", kernel, ref.linear_ref, *leaves)
        assert not ag.needs_grad(*leaves)
    assert out.grad_fn is None
    out = ops._call("linear", kernel, ref.linear_ref, *leaves,
                    vjp=ag.linear_vjp)
    # the kernel runs inside the Function's forward, with grad mode off
    assert out.grad_fn is not None and calls[-1] is False
    assert ag.needs_grad(None, leaves[0])


@pytest.mark.parametrize("name", OPS)
def test_cpu_ops_are_the_plain_versions_and_differentiable(name):
    fn, args = _inputs(name, seed=4)
    leaves = [a.clone().requires_grad_(True) for a in args]
    op = {"linear": lambda x, w, b: ops.linear(x, w, b),
          "flash_attention": lambda q, k, v: ops.flash_attention(
              q, k, v, causal=True, softcap=20.0),
          "ssd": lambda *t: ops.ssd(*t, chunk=4),
          "rglru_scan": lambda *t: ops.rglru_scan(*t[:5], 8.0, t[5])}[name]
    before = dict(ops.LAUNCHES)
    got = _outputs(op(*leaves))
    assert ops.LAUNCHES == before  # the CPU launches no kernel
    for o, w in zip(got, _outputs(fn(*args))):
        assert torch.equal(o.detach(), w)
    assert all(g is not None for g in torch.autograd.grad(_loss(got), leaves))


# ---------------------------------------------------------------------------
# The prepared copies under in-place updates
# ---------------------------------------------------------------------------

def test_prepared_bytes_are_bounded_under_in_place_updates():
    gemm.release()
    stacked = torch.randn(3, 32, 16, generator=_gen(6))
    w = torch.randn(16, 8, generator=_gen(7))
    weights = lambda: [w] + list(stacked)  # noqa: E731  views made anew
    for wt in weights():
        gemm.prepare(wt)
    after_one = None
    for step in range(6):
        with torch.no_grad():
            w.add_(0.5)
            stacked.mul_(1.01)
        for wt in weights():
            hit = gemm.prepare(wt)
            assert torch.equal(hit.big_t, ref.tf32_split(wt)[0].t())
        total = gemm.prepared_bytes() + gemm.retired_bytes()
        after_one = after_one or total
        assert total == after_one == 4 * 2 * (16 * 8 + 3 * 32 * 16), step
    assert gemm.retired_bytes() == 0
    gemm.release()


def test_a_captured_copy_is_kept_until_release():
    gemm.release()
    w = torch.randn(16, 8, generator=_gen(8))
    first = gemm.prepare(w)
    first.captured = True  # as a launch under a graph capture marks it
    with torch.no_grad():
        w.add_(1.0)
    second = gemm.prepare(w)
    assert second is not first
    assert gemm.retired_bytes() == 2 * 16 * 8 * 4
    with torch.no_grad():
        w.add_(1.0)
    gemm.prepare(w)  # the uncaptured second copy goes
    assert gemm.retired_bytes() == 2 * 16 * 8 * 4
    gemm.release()
    assert gemm.retired_bytes() == gemm.prepared_bytes() == 0


def test_prepare_of_a_weight_that_requires_grad_records_nothing():
    gemm.release()
    w = torch.randn(16, 8, generator=_gen(9)).requires_grad_(True)
    hit = gemm.prepare(w[None][0])
    assert hit.big_t.grad_fn is None and not hit.weight.requires_grad
    with torch.no_grad():
        w.add_(1.0)
    assert gemm.prepare(w[None][0]) is not hit  # the view's version moved
    gemm.release()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", OPS)
def test_cuda_op_gradient_matches_plain_autograd(cuda, name):
    fn, args = _inputs(name, seed=10, device=cuda)
    if name == "linear":
        args = tuple(torch.randn(s, generator=_gen(11)).to(cuda)
                     for s in ((64, 32), (32, 16), (16,)))
    op = {"linear": lambda x, w, b: ops.linear(x, w, b),
          "flash_attention": lambda q, k, v: ops.flash_attention(
              q, k, v, causal=True, softcap=20.0),
          "ssd": lambda *t: ops.ssd(*t, chunk=4),
          "rglru_scan": lambda *t: ops.rglru_scan(*t[:5], 8.0, t[5])}[name]
    leaves = [a.clone().requires_grad_(True) for a in args]
    ops.LAUNCHES[name] = 0
    got = _outputs(op(*leaves))
    assert ops.LAUNCHES[name] == 1
    gg = torch.autograd.grad(_loss(got), leaves)
    plain = [a.clone().requires_grad_(True) for a in args]
    gw = torch.autograd.grad(_loss(_outputs(fn(*plain))), plain)
    for a, b in zip(gg, gw):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
