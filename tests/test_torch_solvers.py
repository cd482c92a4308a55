"""The port's solver interface (``init_state``, ``step(x, out, s, state,
noise=None) -> (x, state)``) against the JAX package's: rectified-flow
model times and step coefficients bitwise, its steps within 5e-5 of the
output's scale, DDIM's outputs bitwise what its one-state-less form gave,
and the registry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close
from repro.core import solvers as jsolvers
from repro_torch.core import solvers as tsolvers
from repro_torch.core.solvers import StepTable, linspace_f32


@pytest.mark.parametrize("n", [1, 8, 30, 100])
def test_rectified_flow_model_times_bitwise(n):
    ref = np.asarray(jsolvers.rectified_flow(n).model_times)
    got = tsolvers.rectified_flow(n).model_times.numpy()
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)


def test_linspace_f32_matches_jax():
    """Grid lengths up to 352, for both solvers' grids: DDIM's ts took
    other bits at 7, 13, 19, ... steps before the reciprocal form."""
    for n in sorted(set(range(1, 353, 11)) | {7, 13, 31, 51, 101, 352}):
        for start, stop in ((1.0, 0.0), (999, 0)):
            ref = np.asarray(jnp.linspace(start, stop, n))
            assert np.array_equal(linspace_f32(start, stop, n), ref), (n,
                                                                      start)


@pytest.mark.parametrize("n", [8, 30])
def test_rectified_flow_dt_bitwise(n):
    """x = 0, v = 1: one step returns its dt exactly, on both sides and
    for an int and a device-index step."""
    js, ts = jsolvers.rectified_flow(n), tsolvers.rectified_flow(n)
    zero, one = np.zeros((1, 2), np.float32), np.ones((1, 2), np.float32)
    for s in range(n):
        xj, _ = js.step(jnp.asarray(zero), jnp.asarray(one), s, {})
        xt, _ = ts.step(torch.from_numpy(zero), torch.from_numpy(one), s, {})
        xi, _ = ts.step(torch.from_numpy(zero), torch.from_numpy(one),
                        torch.tensor([s]), {})
        assert np.array_equal(xt.numpy(), np.asarray(xj)), s
        assert torch.equal(xt, xi)
        assert float(xt[0, 0]) < 0


def test_rectified_flow_steps_match():
    """Eight steps chained on a seeded latent and seeded velocities."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    js, ts = jsolvers.rectified_flow(8), tsolvers.rectified_flow(8)
    xj, sj = jnp.asarray(x), js.init_state()
    xt, st = torch.from_numpy(x), ts.init_state()
    for s in range(8):
        v = rng.standard_normal(x.shape).astype(np.float32)
        xj, sj = js.step(xj, jnp.asarray(v), s, sj)
        xt, st = ts.step(xt, torch.from_numpy(v), s, st)
        scale = float(np.abs(np.asarray(xj)).max())
        close(xj, xt, atol=5e-5 * scale, rtol=0)
    assert st == {} and sj == {}


def _ddim_before(num_steps):
    """DDIM's step as the port computed it before it carried a state,
    ts from the division form of the grid: ``step(x, eps, s) -> x``."""
    sched = tsolvers.diffusion.vp_schedule(1000)
    div = num_steps - 1
    frac = np.arange(div, dtype=np.float32) / np.float32(div)
    grid = np.float32(999) * (np.float32(1) - frac) + np.float32(0) * frac
    ts = np.round(np.append(grid, np.float32(0))).astype(np.int64)
    ab = sched["alpha_bar"].numpy()[ts]
    ab_next = np.concatenate([ab[1:], np.ones(1, np.float32)])
    one = np.float32(1)
    coeffs = StepTable(np.stack([np.sqrt(one - ab), np.sqrt(ab),
                                 np.sqrt(ab_next), np.sqrt(one - ab_next)]))

    def step(x, eps, s):
        c_eps, c_x, c_x0n, c_epsn = coeffs.at(s, x.device)
        x0 = (x - c_eps * eps) / c_x
        return c_x0n * x0 + c_epsn * eps

    return step


@pytest.mark.parametrize("n", [6, 50])
def test_ddim_interface_bitwise(n):
    """The DiT slice's DDIM 50 (and the tests' 6) keep every bit: their
    ts are the same under both forms of the grid."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    before, solver = _ddim_before(n), tsolvers.ddim(n)
    state = solver.init_state()
    assert state == {}
    for s in range(n):
        eps = torch.from_numpy(rng.standard_normal(x.shape)
                               .astype(np.float32))
        want = before(x, eps, s)
        got, state = solver.step(x, eps, s, state)
        got_idx, _ = solver.step(x, eps, torch.tensor([s]), state,
                                 noise=torch.ones_like(x))
        assert torch.equal(got, want) and torch.equal(got_idx, want), s
        x = got


def test_registry_and_flags():
    assert set(tsolvers.SOLVERS) <= set(jsolvers.SOLVERS)
    assert set(tsolvers.SOLVERS) == {"ddim", "dpmpp_3m_sde",
                                     "rectified_flow"}
    for name, make in tsolvers.SOLVERS.items():
        ts, js = make(10), jsolvers.SOLVERS[name](10)
        assert ts.name == js.name == name
        assert (ts.stochastic, ts.scannable) == (js.stochastic, js.scannable)
        assert ts.init_state() == js.init_state()
        assert ts.init_state() == ({} if name != "dpmpp_3m_sde" else
                                   dict.fromkeys(("d1", "d2", "h1", "h2")))
        assert ts.num_steps == 10
