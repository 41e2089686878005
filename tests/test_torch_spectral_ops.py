"""Port parity: host spectral constants, basis tables, quaternion operators.

The same f64 inputs (numpy ``default_rng``) go through the JAX package and
the PyTorch port.  Grid and basis constants are the same NumPy f64
arithmetic on both sides, so they must agree to <= 1e-14.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import rod as jrod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    basis as jbasis,
    chebyshev as jcheb,
    collocation as jcoll,
    doubledouble as jdd,
    lie as jlie,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import (
    diagnostics as jdiag,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    basis,
    chebyshev,
    collocation as coll,
    doubledouble as dd,
    lie,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
    diagnostics,
)
from torch_threads import one_cpu_thread  # noqa: F401

NS = [8, 16, 24, 33]
CONST_TOL = 1e-14   # identical f64 host arithmetic on both sides


def _close(a, b, tol=CONST_TOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("n", NS)
def test_grid_constants_match_jax(n):
    """make_grid reproduces the JAX SpectralGrid, also when carried over
    from the JAX arrays by utils/convert.grid_from_numpy."""
    jg = jcoll.make_grid(n)
    mine = coll.make_grid(n, device="cpu")
    carried = convert.grid_from_numpy(jg.points, jg.dn, jg.dn_nn, jg.dn_in, jg.ginv,
                                      device="cpu")
    assert carried.n == mine.n == n and carried.length == mine.length == 1.0
    for name in ("points", "dn", "dn_nn", "dn_in", "ginv"):
        _close(getattr(mine, name), getattr(jg, name))
        _close(getattr(carried, name), getattr(mine, name))
    _close(mine.ginv.to(torch.float32), jg.ginv_f32, tol=0.0)   # the f32 Picard operator
    _close(chebyshev.clenshaw_curtis_weights(n), jcheb.clenshaw_curtis_weights(n))
    for known in ("first", "last"):
        _close(chebyshev.integration_matrix(n, 2.0, known),
               jcheb.integration_matrix(n, 2.0, known))


@pytest.mark.parametrize("n", NS)
def test_basis_tables_match_jax(n):
    """The rod's f64 basis table, for both bases, and the reference's Phi."""
    for name in ("legendre", "chebyshev"):
        jcfg = jrod.RodConfig(n=n, ne=4, basis=name)
        cfg = convert.rod_config_from_jax(jcfg)
        assert cfg == rod.RodConfig(n=n, ne=4, basis=name)
        _close(cfg.basis_table, jcfg.basis_table)
    _close(basis.phi_matrix(0.3, 3, n % 5 + 1), jbasis.phi_matrix(0.3, 3, n % 5 + 1))


def test_basis_values_and_strain_match_jax():
    x = np.random.default_rng(0).uniform(-1.0, 1.0, 11)
    _close(basis.legendre_vals(x, 6), jbasis.legendre_vals(x, 6))
    _close(basis.chebyshev_t_vals(x, 6), jbasis.chebyshev_t_vals(x, 6))
    cfg, jcfg = rod.RodConfig(na=6), jrod.RodConfig(na=6)
    qe = np.random.default_rng(1).standard_normal((5, 18))
    _close(rod.curvature_at_points(cfg, torch.tensor(qe)),
           jrod.curvature_at_points(jcfg, jnp.asarray(qe)))


_RNG = np.random.default_rng(2)
_V3 = _RNG.standard_normal((6, 3))
_Q4 = _RNG.standard_normal((6, 4))        # not unit: unnormalized semantics
_P4 = _RNG.standard_normal((6, 4))

LIE_CASES = {
    "skew": (lie.skew, jlie.skew, (_V3,)),
    "quat_skew": (lie.quat_skew, jlie.quat_skew, (_V3,)),
    "quat_to_rot": (lie.quat_to_rot, jlie.quat_to_rot, (_Q4,)),
    "quat_tangent": (lie.quat_tangent, jlie.quat_tangent, (_Q4,)),
    "quat_normalize": (lie.quat_normalize, jlie.quat_normalize, (_Q4,)),
    "quat_multiply": (lie.quat_multiply, jlie.quat_multiply, (_Q4, _P4)),
    "quat_conjugate": (lie.quat_conjugate, jlie.quat_conjugate, (_Q4,)),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    mine, ref, args = LIE_CASES[name]
    _close(mine(*[torch.tensor(a) for a in args]),
           ref(*[jnp.asarray(a) for a in args]))


def test_quat_skew_apply_and_rod_tangent():
    """The 12-product action is A(K) s; the rod tangent is R(q)(e1+gamma)
    with the unnormalized R (Kirchhoff: R(q) e1)."""
    k, q, gamma = (torch.tensor(a) for a in (_V3, _Q4, _V3[::-1].copy()))
    _close(lie.quat_skew_apply(k, q),
           np.einsum("bij,bj->bi", jlie.quat_skew(jnp.asarray(_V3)), _Q4))
    _close(lie.rod_tangent(q), jlie.quat_tangent(jnp.asarray(_Q4)))
    e1 = np.array([1.0, 0.0, 0.0])
    _close(lie.rod_tangent(q, gamma),
           np.einsum("bij,bj->bi", jlie.quat_to_rot(jnp.asarray(_Q4)),
                     e1 + _V3[::-1]))


def test_split_f64_matches_jax():
    a = np.random.default_rng(3).standard_normal((4, 5)) * 1e3
    hi, lo = dd.split_f64(torch.tensor(a))
    jhi, jlo = jdd.split_f64(a)
    _close(hi, jhi, tol=0.0)
    _close(lo, jlo, tol=0.0)
    assert hi.dtype == lo.dtype == torch.float32
    assert np.max(np.abs(dd.join_f64(hi, lo).numpy() - a)) <= 1e-13 * 1e3


@pytest.mark.parametrize("rho", [0.25, 1.0, 3.0, 5.0])
def test_picard_bounds_match_jax(rho):
    for iters in (4, 12, 20):
        assert diagnostics.picard_error_bound(rho, iters) == jdiag.picard_error_bound(rho, iters)
    for tol in (1e-5, 1e-7):
        assert (diagnostics.picard_iterations_needed(rho, tol)
                == jdiag.picard_iterations_needed(rho, tol))


def test_component_major_layout_matches_jax():
    s = np.random.default_rng(4).standard_normal((3, 15, 4))
    flat = coll.to_component_major(torch.tensor(s))
    _close(flat, jcoll.to_component_major(jnp.asarray(s)))
    _close(coll.from_component_major(flat, 15, 4), s)
