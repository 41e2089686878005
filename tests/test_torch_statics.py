"""Port parity: the statics Newton (models/cosserat.py) and its small solve.

The same loads (numpy ``default_rng``) go through the JAX package's
``solve_statics`` vmapped over the batch (N=16 and n=64, compiled as one
program) and through the port's ``solve_statics_batched`` (K1 and K2 on the
fused path; their plain versions on the CPU) and ``solve_statics``, at the
tolerances of ``tests/test_cosserat_statics.py``.  The Reissner (na=6)
case is held to the JAX residual at the port's solution instead of a third
JAX Newton, whose trace and compile alone take ~3.5 s.
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
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    smallsolve as jsmall,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    smallsolve,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)

QE_TOL = 2e-5      # tests/test_cosserat_statics.py:207,224
NEWTON = dict(tol=1e-5, max_iter=12, iters=16)
CASES = {   # name: (JAX config, number of loads, load bound); :195-208
    "n16": (jcos.StaticsConfig(rod=jrod.RodConfig(n=16)), 8, 0.4),
    "n64": (jcos.StaticsConfig(rod=jrod.RodConfig(n=64)), 4, 0.4),
}
JCFG6 = jcos.StaticsConfig(rod=jrod.RodConfig(n=16, na=6, ne=3),     # :211-225
                           stiffness=(1.0, 1.0, 1.0, 50.0, 10.0, 10.0))


def _loads(name):
    _, b, bound = CASES[name] if name in CASES else (None, 4, 0.3)
    return np.random.default_rng(11).uniform(-bound, bound, (b, 3)).astype(np.float32)


@jax.jit
def _jax_solves(loads):
    """The JAX ``solve_statics`` vmapped over each case's loads, compiled as
    one program."""
    return {name: jax.vmap(lambda f, c=jcfg: jcos.solve_statics(f, cfg=c, **NEWTON).qe)(
        loads[name]) for name, (jcfg, _, _) in CASES.items()}


@pytest.fixture(scope="module")
def jax_qe():
    out = _jax_solves({name: jnp.asarray(_loads(name)) for name in CASES})
    return {name: np.asarray(qe) for name, qe in out.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_newton_matches_jax_solve_statics(jax_qe, name):
    cfg = convert.statics_config_from_jax(CASES[name][0])
    loads = torch.tensor(_loads(name))
    new = cosserat.solve_statics_batched(loads, cfg=cfg, **NEWTON)
    assert new.converged.all() and new.qe.dtype == torch.float32
    np.testing.assert_allclose(new.qe.numpy(), jax_qe[name], atol=QE_TOL)
    ref = cosserat.solve_statics(loads, cfg=cfg, **NEWTON)
    assert ref.converged.all() and (ref.iterations >= 1).all()
    np.testing.assert_allclose(ref.qe.numpy(), jax_qe[name], atol=QE_TOL)


def test_batched_newton_6dof_matches_jax_residual():
    """na=6 with the stiffness of tests/test_cosserat_statics.py:211-225:
    the batched Newton agrees with the per-sample one, its strains solve the
    JAX balance (JAX residual below the Newton tolerance), and the port's
    Picard residual equals the JAX one at those strains."""
    cfg = convert.statics_config_from_jax(JCFG6)
    loads = torch.tensor(_loads("n16_6dof"))
    new = cosserat.solve_statics_batched(loads, cfg=cfg, **NEWTON)
    ref = cosserat.solve_statics(loads, cfg=cfg, **NEWTON)
    assert new.converged.all() and ref.converged.all()
    np.testing.assert_allclose(new.qe.numpy(), ref.qe.numpy(), atol=QE_TOL)
    jres = np.asarray(jax.jit(jax.vmap(lambda q, f: jcos.equilibrium_residual(
        q, f, jnp.zeros(3), JCFG6, iters=NEWTON["iters"])))(
            jnp.asarray(new.qe.numpy()), jnp.asarray(loads.numpy())))
    assert np.linalg.norm(jres, axis=-1).max() <= NEWTON["tol"]
    mine = cosserat.equilibrium_residual(new.qe, loads[:, None, :], torch.zeros(3), cfg,
                                         iters=NEWTON["iters"])
    np.testing.assert_allclose(mine.numpy(), jres, rtol=0, atol=1e-6)


def test_fused_jacobian_matches_jax_jacfwd():
    """tests/test_cosserat_statics.py:439-465: the fused Jacobian (K1 state,
    K2 direction tangents) against jax.jacfwd of the f64 Picard residual,
    away from zero strain (|qe| ~ 2)."""
    jcfg = jcos.StaticsConfig(rod=jrod.RodConfig(n=16), stiffness=(1.0, 1.0, 1.3))
    qe = np.zeros(9)
    qe[3], qe[4], qe[5], qe[2] = 2.2, -0.6, 0.15, 0.05
    load = 4.0 * np.asarray([-1.0, 0.0, 0.01])
    j64 = np.asarray(jax.jit(jax.jacfwd(lambda q: jcos.equilibrium_residual(
        q, jnp.asarray(load), jnp.zeros(3), jcfg, iters=48)))(jnp.asarray(qe)))
    _, jac = cosserat.residual_and_jacobian_fused(
        torch.tensor(qe[None], dtype=torch.float32),
        torch.tensor(load[None, None], dtype=torch.float32), torch.zeros((1, 1, 3)),
        convert.statics_config_from_jax(jcfg), iters=16)
    assert np.abs(jac[0].double().numpy() - j64).max() < 1e-4 * np.abs(j64).max()


def test_gauss_jordan_matches_jax_smallsolve():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((8, 9, 9))
    b = rng.standard_normal((8, 9, 2))
    # a permutation matrix has zero leading pivots everywhere: pivoting
    perm = np.stack([np.eye(9)[rng.permutation(9)] for _ in range(8)])
    v = rng.standard_normal((8, 9))
    solve = jax.jit(jsmall.gauss_jordan_solve)
    for aa, bb in ((a, b), (perm, v)):
        mine = smallsolve.gauss_jordan_solve(torch.tensor(aa), torch.tensor(bb)).numpy()
        np.testing.assert_allclose(mine, np.asarray(solve(jnp.asarray(aa), jnp.asarray(bb))),
                                   rtol=0, atol=1e-12)
        exact = np.linalg.solve(aa, bb if bb.ndim == 3 else bb[..., None])
        np.testing.assert_allclose(mine, exact.reshape(mine.shape), atol=1e-11)


def test_statics_config_from_jax_round_trips():
    rc = jrod.RodConfig(n=8, na=6, ne=2, length=0.7)
    profile = jcos.stiffness_profile(lambda x: np.stack([1.0 + 0.0 * x, 2.0 - x, 2.0 - x,
                                                         40.0 + x, 9.0 + x, 9.0 + x], -1), rc)
    jcfg = jcos.StaticsConfig(rod=rc, stiffness=profile, kappa0=tuple(np.linspace(0, 0.1, 12)),
                              distributed_force=(0.0, 0.0, -0.3), follower=True)
    cfg = convert.statics_config_from_jax(jcfg)
    assert cfg == cosserat.StaticsConfig(
        rod=rod.RodConfig(n=8, na=6, ne=2, length=0.7), stiffness=profile,
        kappa0=jcfg.kappa0, distributed_force=(0.0, 0.0, -0.3), follower=True)
    assert np.array_equal(cfg.full_basis_table, jcfg.full_basis_table)
    assert np.array_equal(cfg.quad_weights, jcfg.quad_weights)
    # every branch of the residual (profile, rest strain, distributed load,
    # follower tip force, Reissner force rows) against the JAX residual
    qe = np.random.default_rng(5).standard_normal((2, 12)) * 0.3
    tf, tm = np.asarray([0.1, -0.2, 0.3]), np.asarray([0.0, 0.05, 0.0])
    ref = jax.jit(lambda q: jcos.equilibrium_residual(
        q, jnp.asarray(tf), jnp.asarray(tm), jcfg, method="dense"))(jnp.asarray(qe))
    for method in ("dense", "auto"):
        mine = cosserat.equilibrium_residual(torch.tensor(qe), torch.tensor(tf),
                                             torch.tensor(tm), cfg, method=method)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_dd_residual_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cosserat.solve_statics_batched(torch.zeros((2, 3)), dd_residual=True)
