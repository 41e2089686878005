"""Port parity: the analytic IVP suite (models/ivp.py) and the Picard
solve's implicit-function derivatives (ops/collocation.py).

The suite's cases run through the JAX package and the port with the gates of
``tests/test_ivp_suite.py``; the implicit Picard solve's jvp and vjp are held
to ``jax.jvp``/``jax.vjp`` of the JAX ``solve_ivp_picard_implicit`` in f64 on
the same ``default_rng`` inputs, and it is driven through ``torch.func.vmap``,
``jacfwd`` and ``torch.autograd.grad``.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    ivp as jivp,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    collocation as jcoll,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    ivp,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    collocation as coll,
)
from torch_threads import one_cpu_thread  # noqa: F401

CASES = {   # name: (problem, kwargs, rtol, atol); tests/test_ivp_suite.py
    "exponential_decay": ("exponential_ivp", dict(lam=-2.5, n=24), 1e-12, 1e-13),
    "exponential_growth": ("exponential_ivp", dict(lam=1.7, n=24), 1e-12, 0.0),
    "oscillator": ("oscillator_ivp", dict(omega=6.0, forcing_freq=2.0, n=32), 1e-10, 1e-11),
    "rotating_frame": ("rotating_frame_ivp", dict(k=(0.5, 2.0, -1.0), n=24), 1e-11, 1e-12),
    "rotating_frame_picard": ("rotating_frame_ivp", dict(k=(0.0, 3.0, 0.0), n=16,
                                                         method="picard"), 1e-9, 1e-10),
    "rotating_frame_zero": ("rotating_frame_ivp", dict(k=(0.0, 0.0, 0.0), n=8), 0.0, 1e-13),
    "rotating_frame_q0": ("rotating_frame_ivp", dict(k=(0.0, 2.0, 0.0), n=20,
                                                     q0=(math.cos(0.4), math.sin(0.4), 0, 0)),
                          1e-11, 1e-12),
}


# each problem and method once through the JAX suite too (eager JAX: ~1 s a call)
WITH_JAX = ("exponential_decay", "oscillator", "rotating_frame", "rotating_frame_picard")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ivp_suite_matches_closed_form_and_jax(name):
    problem, kwargs, rtol, atol = CASES[name]
    numeric, exact = getattr(ivp, problem)(device="cpu", **kwargs)
    assert numeric.dtype == torch.float64 and numeric.shape == exact.shape
    np.testing.assert_allclose(numeric.numpy(), exact.numpy(), rtol=rtol, atol=atol)
    if name in WITH_JAX:
        j_numeric, j_exact = getattr(jivp, problem)(**kwargs)
        np.testing.assert_allclose(exact.numpy(), np.asarray(j_exact), rtol=1e-15, atol=1e-15)
        np.testing.assert_allclose(numeric.numpy(), np.asarray(j_numeric), rtol=rtol, atol=atol)
    if name == "rotating_frame_zero":
        np.testing.assert_allclose(numeric.numpy(), np.broadcast_to([1.0, 0, 0, 0], (7, 4)),
                                   atol=1e-13)


@pytest.mark.parametrize("problem", ["exponential_ivp", "oscillator_ivp"])
def test_convergence_sweep_is_spectral(problem):
    if problem == "exponential_ivp":
        errs = ivp.convergence_sweep(ivp.exponential_ivp, ns=(6, 8, 12, 16), lam=-2.5,
                                     device="cpu")
        assert errs[8] < errs[6] * 0.2 and errs[12] < errs[8] * 0.05 and errs[16] < 1e-12
    else:
        errs = ivp.convergence_sweep(ivp.oscillator_ivp, ns=(8, 12, 16, 24, 32), device="cpu")
        assert errs[12] < errs[8] and errs[24] < errs[12] * 1e-4 and errs[32] < 1e-10


def test_oscillator_resonance_rejected():
    with pytest.raises(ValueError, match="resonant"):
        ivp.oscillator_ivp(omega=2.0, forcing_freq=2.0, device="cpu")


def test_terminal_value_grid():
    """tests/test_chebyshev.py:109-123: known='first' integrates a
    terminal-value problem backward from the tip."""
    n, lam, y_end = 16, -1.7, 2.0
    grid = coll.make_grid(n, known="first", device="cpu")
    m = torch.full((n - 1, 1, 1), lam, dtype=torch.float64)
    sol = coll.solve_ivp_dense(grid, m, torch.tensor([y_end], dtype=torch.float64))
    exact = y_end * np.exp(lam * (grid.points[1:].numpy() - 1.0))
    np.testing.assert_allclose(sol[:, 0].numpy(), exact, rtol=1e-11)
    jgrid = jcoll.make_grid(n, known="first")
    np.testing.assert_array_equal(grid.dn_nn.numpy(), np.asarray(jgrid.dn_nn))
    ref = jcoll.solve_ivp_dense(jgrid, jnp.asarray(m.numpy()), jnp.asarray([y_end]))
    np.testing.assert_allclose(sol.numpy(), np.asarray(ref), rtol=1e-13, atol=0)


N, D, ITERS = 10, 4, 16


def _inputs():
    rng = np.random.default_rng(0)
    m = 0.5 * rng.standard_normal((3, N - 1, D, D))
    return m, *(rng.standard_normal((3, N - 1, D)) for _ in range(2)), \
        rng.standard_normal(m.shape), rng.standard_normal((3, N - 1, D))


@pytest.fixture(scope="module")
def jax_derivatives():
    """JAX jvp, vjp and jacfwd of its implicit Picard solve, one program."""
    m, rhs, drhs, dm, g = _inputs()
    grid = jcoll.make_grid(N)

    @jax.jit
    def run(m, rhs, dm, drhs, g):
        f = lambda m_, r_: jcoll.solve_ivp_picard_implicit(grid, m_, r_, ITERS)  # noqa: E731
        x, dx = jax.jvp(f, (m, rhs), (dm, drhs))
        _, vjp = jax.vjp(f, m, rhs)
        return x, dx, vjp(g), jax.jacfwd(f, argnums=(0, 1))(m[0], rhs[0])

    return jax.tree_util.tree_map(np.asarray, run(m, rhs, dm, drhs, g))


def _solve(m, r):
    return coll.solve_ivp_picard_implicit(coll.make_grid(N, device="cpu"), m, r, ITERS)


def test_implicit_picard_jvp_vjp_match_jax(jax_derivatives):
    x_ref, dx_ref, (gm_ref, grhs_ref), _ = jax_derivatives
    m, rhs, drhs, dm, g = (torch.tensor(a) for a in _inputs())
    x, dx = torch.func.jvp(_solve, (m, rhs), (dm, drhs))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=0, atol=1e-10)
    m_, rhs_ = m.clone().requires_grad_(), rhs.clone().requires_grad_()
    gm, grhs = torch.autograd.grad(_solve(m_, rhs_), (m_, rhs_), g)
    np.testing.assert_allclose(gm.numpy(), gm_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(grhs.numpy(), grhs_ref, rtol=0, atol=1e-10)
    _, vjp = torch.func.vjp(_solve, m, rhs)
    np.testing.assert_allclose(vjp(g)[0].numpy(), gm_ref, rtol=0, atol=1e-10)


def test_implicit_picard_under_vmap_and_jacfwd(jax_derivatives):
    x_ref, dx_ref, _, (jm_ref, jr_ref) = jax_derivatives
    m, rhs, drhs, dm, _ = (torch.tensor(a) for a in _inputs())
    np.testing.assert_allclose(torch.func.vmap(_solve)(m, rhs).numpy(), x_ref, atol=1e-12)
    dx = torch.func.vmap(lambda *a: torch.func.jvp(_solve, a[:2], a[2:])[1])(m, rhs, dm, drhs)
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=0, atol=1e-10)
    jm, jr = torch.func.jacfwd(_solve, argnums=(0, 1))(m[0], rhs[0])
    np.testing.assert_allclose(jm.numpy(), jm_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(jr.numpy(), jr_ref, rtol=0, atol=1e-10)
    # a shared m against a batch of rhs: the cotangent of m sums over the batch
    m0 = m[0].clone().requires_grad_()
    (gm,) = torch.autograd.grad(_solve(m0, rhs).sum(), m0)
    (gm_loop,) = torch.autograd.grad(sum(_solve(m0, r).sum() for r in rhs), m0)
    np.testing.assert_allclose(gm.numpy(), gm_loop.numpy(), rtol=1e-13, atol=1e-13)


def test_constants_first_built_inside_jacfwd():
    """A grid and basis table first built inside ``torch.func.jacfwd`` (a
    configuration no test used before) serve later calls: the cached
    constants are made with the transforms suspended."""
    from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
        rod,
    )

    cfg = rod.RodConfig(n=19, length=0.7)
    qe = torch.tensor(np.random.default_rng(3).standard_normal(9) * 0.3)
    jac = torch.func.jacfwd(lambda q: rod.rod_shape(q, cfg=cfg, method="picard").positions)(qe)
    again = rod.rod_shape(qe, cfg=cfg, method="picard").positions
    assert jac.shape == (18, 3, 9) and torch.isfinite(jac).all() and torch.isfinite(again).all()


def test_implicit_picard_nested_forward_mode_raises():
    """A jvp of a jvp through the solve would get a zero second-order tangent
    (torch runs a Function's jvp rule with forward-mode AD off), so it
    raises; a second derivative with a reverse-mode level agrees with the
    central difference of the first."""
    m, rhs, _, dm, g = (torch.tensor(a[0]) for a in _inputs())

    def f(s):
        return torch.sum(g * _solve(m + s * dm, rhs))

    s0, one = torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="nested forward-mode"):
        torch.func.jvp(lambda s: torch.func.jvp(f, (s,), (one,))[1], (s0,), (one,))
    with pytest.raises(RuntimeError, match="nested forward-mode"):
        torch.func.jacfwd(torch.func.jacfwd(f))(s0)
    h = 1e-4
    fd = (torch.func.jvp(f, (s0 + h,), (one,))[1] - torch.func.jvp(f, (s0 - h,), (one,))[1]) / (2 * h)
    for d2 in (torch.func.jacfwd(torch.func.jacrev(f))(s0),
               torch.func.jacrev(torch.func.jacfwd(f))(s0),
               torch.func.jacrev(torch.func.jacrev(f))(s0)):
        assert abs(float(fd)) > 1e-3
        np.testing.assert_allclose(float(d2), float(fd), rtol=1e-6)
