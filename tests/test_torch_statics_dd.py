"""Port parity: the statics layer's FP64 residual on K3, the dd Newton, the
Armijo line search and the load sensitivities (models/cosserat.py).

The same ``default_rng`` strains and loads go through the JAX package's
``equilibrium_residual_dd`` and ``equilibrium_residual`` (f64, compiled as
one program) and through the port's ``equilibrium_residual_dd`` (K3's plain
version on the CPU), at the tolerances of ``tests/test_cosserat_statics.py``
and ``tests/test_stiffness_profile.py``.  The Newtons are held to the f64
dense residual at their solutions; ``solve_statics_differentiable`` to
``jax.grad`` of the same tip functional.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    cosserat as jcos,
    rod as jrod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

R16 = jrod.RodConfig(n=16)


def _taper(xs):                      # tests/test_stiffness_profile.py:21-28
    return np.stack([np.ones_like(xs), 1.0 / (1.0 + 0.8 * xs), np.ones_like(xs)], axis=-1)


CASES = {   # name: JAX config; tests/test_cosserat_statics.py:247,468,641
    "dead": jcos.StaticsConfig(rod=R16),
    "follower": jcos.StaticsConfig(rod=R16, follower=True),
    "distributed": jcos.StaticsConfig(rod=R16, distributed_force=(0.0, 0.0, -0.6)),
    "profile": jcos.StaticsConfig(rod=R16, stiffness=jcos.stiffness_profile(_taper, R16)),
    "reissner_distributed": jcos.StaticsConfig(
        rod=jrod.RodConfig(n=16, na=6, ne=3), stiffness=(1.0, 1.0, 1.0, 50.0, 10.0, 10.0),
        distributed_force=(0.0, 0.0, -0.6)),
    # every branch at once, carried by convert.statics_config_from_jax
    "reissner_profile_follower": jcos.StaticsConfig(
        rod=jrod.RodConfig(n=16, na=6, ne=3), follower=True, distributed_force=(0.0, 0.0, -0.6),
        kappa0=tuple(np.linspace(0.0, 0.1, 18)), stiffness=jcos.stiffness_profile(
            lambda x: np.stack([1.0 + 0 * x, 2 - x, 2 - x, 40 + x, 9 + x, 9 + x], -1),
            jrod.RodConfig(n=16, na=6, ne=3))),
}
WITH_JAX_DD = ("follower",)   # the JAX dd residual compiles for ~5 s a config
DD_GATE = 1e-7                       # times max(scale, 1); :261


def _inputs(name):
    cfg = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    loads = rng.uniform(-0.3, 0.3, (4, 3)).astype(np.float32)
    return rng.standard_normal((4, cfg.rod.na * cfg.rod.ne)) * 0.2, loads


def _split(qe):
    hi = qe.astype(jnp.float32)
    return hi, (qe - hi.astype(jnp.float64)).astype(jnp.float32)


@pytest.fixture(scope="module")
def jax_residuals():
    """Per case: the JAX f64 residual (dense kinematics) at the f64 strain
    and, for WITH_JAX_DD, the JAX dd residual at its f32 pair."""
    inputs = {name: _inputs(name) for name in CASES}

    @jax.jit
    def run(inputs):
        out = {}
        for name, (qe, loads) in inputs.items():
            cfg, zero = CASES[name], jnp.zeros(3)
            out[name] = (jcos.equilibrium_residual(qe, loads[:, None, :], zero, cfg,
                                                  method="dense"),
                         jcos.equilibrium_residual_dd(_split(qe), loads, zero, cfg)
                         if name in WITH_JAX_DD else None)
        return out

    return jax.tree_util.tree_map(np.asarray, run(jax.tree_util.tree_map(jnp.asarray, inputs)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_dd_residual_matches_jax_and_f64(jax_residuals, name):
    res64, res_jdd = jax_residuals[name]
    qe, loads = _inputs(name)
    cfg = convert.statics_config_from_jax(CASES[name])
    assert (cfg.stiffness, cfg.follower, cfg.distributed_force, cfg.kappa0) == (
        CASES[name].stiffness, CASES[name].follower, CASES[name].distributed_force,
        CASES[name].kappa0)
    mine = cosserat.equilibrium_residual_dd(rod.split_strain(torch.tensor(qe)),
                                            torch.tensor(loads), torch.zeros(3), cfg)
    assert mine.dtype == torch.float32 and mine.shape == res64.shape
    gate = DD_GATE * max(np.abs(res64).max(), 1.0)
    assert np.abs(mine.double().numpy() - res64).max() < gate
    if res_jdd is not None:
        assert np.abs(mine.numpy() - res_jdd).max() < gate
    if name == "profile":     # the staged kinematics (K2 around FP64 residuals)
        staged = cosserat.equilibrium_residual_dd(torch.tensor(qe), torch.tensor(loads),
                                                  torch.zeros(3), cfg, refine_steps=2)
        assert np.abs(staged.double().numpy() - res64).max() < gate
    if name == "follower":    # the follower force turns with the tip: not the dead residual
        dead = cosserat.equilibrium_residual_dd(rod.split_strain(torch.tensor(qe)),
                                                torch.tensor(loads), torch.zeros(3),
                                                convert.statics_config_from_jax(CASES["dead"]))
        assert (mine - dead).abs().max() > 1e-3


NEWTON = {"dead": 1, "distributed": 5}    # case: load seed; :228, :541


def test_dd_newton_reaches_1e9_true_residual():
    """solve_statics_batched(dd_residual=True) drives the f64 dense residual
    (the port's, held to the JAX one within 1e-12 in test_torch_statics.py)
    at its f32-pair solution below 1e-9; the f32 tier floors near 1e-6."""
    for name, seed in NEWTON.items():
        cfg = convert.statics_config_from_jax(CASES[name])
        loads = torch.tensor(np.random.default_rng(seed).uniform(-0.3, 0.3, (4, 3)),
                             dtype=torch.float32)
        sol = cosserat.solve_statics_batched(loads, cfg=cfg, tol=1e-9, max_iter=25, iters=16,
                                             dd_residual=True)
        assert sol.converged.all() and sol.qe_lo is not None and sol.qe.dtype == torch.float32
        assert (sol.residual_norm <= 1e-9).all()
        res = cosserat.equilibrium_residual(sol.qe.double() + sol.qe_lo.double(),
                                            loads.double()[:, None, :],
                                            torch.zeros(3, dtype=torch.float64), cfg,
                                            method="dense")
        assert float(res.abs().max()) < 1e-9, name


def test_dd_newton_rod_outside_k3_domain_is_not_converged():
    """A rod whose start lies beyond K3's rho limit gets a NaN residual from
    the rho sentinel: it comes back converged=False, its neighbours as they
    would alone."""
    cfg = convert.statics_config_from_jax(CASES["dead"])
    loads = torch.tensor(np.random.default_rng(7).uniform(-0.3, 0.3, (4, 3)), dtype=torch.float32)
    newton = dict(cfg=cfg, tol=1e-9, max_iter=25, iters=16, dd_residual=True)
    clean = cosserat.solve_statics_batched(loads, **newton)
    qe0 = torch.zeros((4, 9))
    qe0[1, 3] = 14.0                                  # rho = |K| L/2 = 7 > 5
    sol = cosserat.solve_statics_batched(loads, qe0=qe0, **newton)
    assert sol.converged.tolist() == [True, False, True, True]
    assert torch.isnan(sol.residual_norm[1])
    keep = [0, 2, 3]
    torch.testing.assert_close(sol.qe[keep], clean.qe[keep], rtol=0, atol=1e-12)
    torch.testing.assert_close(sol.qe_lo[keep], clean.qe_lo[keep], rtol=0, atol=1e-12)
    for refine_steps in (1, 2):    # K3's sentinel, and the staged path's mask
        res = cosserat.equilibrium_residual_dd(qe0, loads, torch.zeros(3), cfg,
                                               refine_steps=refine_steps)
        assert torch.isnan(res).any(-1).tolist() == [False, True, False, False]


def test_line_search_extends_cold_start_radius():
    """:619: a transverse tip load of 12 EI/L^2 from zero strain: full-step
    Newton wanders, the Armijo search converges to a true equilibrium."""
    cfg = convert.statics_config_from_jax(CASES["dead"])
    f = torch.tensor([0.0, 0.0, 12.0], dtype=torch.float64)
    plain = cosserat.solve_statics(f, cfg=cfg, tol=1e-9, max_iter=40, method="auto")
    assert not bool(plain.converged)
    ls = cosserat.solve_statics(f, cfg=cfg, tol=1e-9, max_iter=40, method="auto",
                                line_search=True)
    assert bool(ls.converged)
    res = cosserat.equilibrium_residual(ls.qe, f, torch.zeros(3, dtype=torch.float64), cfg,
                                        method="dense")
    assert float(res.abs().max()) < 1e-9


def _tip_z(solve, shape):
    """Tip deflection ``z`` under the tip force ``f``, through the
    equilibrium: the functional of :524."""
    def tip_z(f):
        return shape(solve(f, 0.0 * f, 1e-11, 40, 32)).tip_position[2]
    return tip_z


@pytest.fixture(scope="module")
def jax_grad_tip():
    """:524: jax.grad of the tip deflection through the JAX
    solve_statics_differentiable at f0."""
    cfg = CASES["dead"]
    tip_z = _tip_z(lambda f, m, *a: jcos.solve_statics_differentiable(f, m, cfg, *a),
                   lambda qe: jrod.rod_shape(qe, cfg=cfg.rod, method="picard", iters=32))
    return np.asarray(jax.jit(jax.grad(tip_z))(jnp.asarray([0.1, 0.0, 0.8])))


def test_solve_statics_differentiable_matches_jax_grad(jax_grad_tip):
    cfg = convert.statics_config_from_jax(CASES["dead"])
    tip_z = _tip_z(lambda f, m, *a: cosserat.solve_statics_differentiable(f, m, cfg, *a),
                   lambda qe: rod.rod_shape(qe, cfg=cfg.rod, method="picard", iters=32))
    f = torch.tensor([0.0, 0.0, 1e-6], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tip_z(f), f)
    np.testing.assert_allclose(float(g[2]), 1.0 / 3.0, rtol=1e-6)      # L^3 / 3 EI
    f0 = torch.tensor([0.1, 0.0, 0.8], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tip_z(f0), f0)
    np.testing.assert_allclose(g.numpy(), jax_grad_tip, rtol=1e-10, atol=1e-12)
    jac = torch.func.jacfwd(tip_z)(f0.detach())
    np.testing.assert_allclose(jac.numpy(), jax_grad_tip, rtol=1e-10, atol=1e-12)


def test_stiffness_profile_matches_jax():
    rc = jrod.RodConfig(n=16)
    assert cosserat.stiffness_profile(_taper, convert.rod_config_from_jax(rc)) == \
        jcos.stiffness_profile(_taper, rc)
    with pytest.raises(ValueError, match="profile fn returned"):
        cosserat.stiffness_profile(lambda xs: _taper(xs)[:, :2], rod.RodConfig(n=16))
