"""Port parity: the collocation solvers against the JAX paths and the oracle.

N=16, B=8, strains ``0.8 N(0,1)`` from numpy ``default_rng``.  The JAX
references are computed once per module as one ``jax.jit`` program (XLA on
the CPU, x64 enabled by ``tests/conftest.py``).  The port's refined residuals and quadrature run in
true float64 where the JAX package uses double-word f32; both sit far
below the 1e-8 gate.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import rod as jrod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    collocation as jcoll,
    doubledouble as jdd,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import oracle
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    collocation as coll,
    doubledouble as dd,
)

B = 8
JCFG = jrod.RodConfig()


@jax.jit
def _jax_refs(m64, q0, m_dd, rhs_dd, res_pairs, quad_pair, y0, g):
    """Every JAX reference of this module, compiled as one program: the
    dense, picard and refined solves, the collocation matrix, the dd
    residual, the refined quadrature and the IVP right-hand side."""
    jg = JCFG.grid
    dense = jcoll.solve_ivp_dense(jg, m64, q0)
    rhs32 = jcoll.ivp_rhs(jg, q0.astype(jnp.float32))
    picard = jcoll.solve_ivp_picard(jg, m64.astype(jnp.float32),
                                    rhs=jnp.broadcast_to(rhs32, (B, 15, 4)), iters=24)
    refined = jcoll.solve_ivp_refined(jg, m_dd, rhs_dd, iters=24, refine_steps=2)
    return dict(dense=dense, picard=picard, refined=refined,
                matrix=jcoll.collocation_matrix(jg, m64),
                residual_dd=jcoll.residual_quat_dd(jg, res_pairs[0], *res_pairs[1],
                                                   *res_pairs[2]),
                quadrature=jcoll.quadrature_refined(jg, quad_pair, refine_steps=1),
                ivp_rhs=jcoll.ivp_rhs(jg, y0, g))


def _joined(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    qe64 = 0.8 * rng.standard_normal((B, 9))
    k64 = np.asarray(jrod.curvature_at_points(JCFG, jnp.asarray(qe64)))[..., :3]
    m64 = 0.5 * np.stack([oracle.quat_a_matrix(k) for k in k64.reshape(-1, 3)])
    m64 = m64.reshape(B, 15, 4, 4)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    jg = JCFG.grid
    m_dd = jdd_split(m64)
    rhs_dd = jdd_split(np.broadcast_to(-jg.dn_in[:, None] * q0, (B, 15, 4)))
    rng = np.random.default_rng(12)
    x64 = rng.standard_normal((B, 15, 4))
    rhs64 = rng.standard_normal((B, 15, 4))
    res_pairs = [jdd_split(a) for a in (k64, x64, rhs64)]
    quad_pair = jdd_split(np.random.default_rng(13).standard_normal((B, 15, 3)))
    y0 = np.random.default_rng(14).standard_normal((B, 4))
    g = np.random.default_rng(15).standard_normal((B, 15, 4))
    refs = _jax_refs(jnp.asarray(m64), jnp.asarray(q0), m_dd, rhs_dd, res_pairs, quad_pair,
                     jnp.asarray(y0), jnp.asarray(g))
    oracle_q = np.stack([oracle.integrate_quaternions(q).reshape(4, 15).T for q in qe64])
    return dict(qe64=qe64, m64=m64, q0=q0, dense=np.asarray(refs["dense"]),
                picard=np.asarray(refs["picard"]), refined=_joined(refs["refined"]),
                matrix=np.asarray(refs["matrix"]), m_dd=m_dd, rhs_dd=rhs_dd,
                oracle_q=oracle_q, res_pairs=res_pairs, residual_dd=_joined(refs["residual_dd"]),
                quad_pair=quad_pair, quadrature=_joined(refs["quadrature"]), y0=y0, g=g,
                ivp_rhs=np.asarray(refs["ivp_rhs"]))


def jdd_split(a):
    hi, lo = jdd.split_f64(np.asarray(a, np.float64))
    return jnp.asarray(hi), jnp.asarray(lo)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_dense_matches_jax_and_oracle(case):
    grid = coll.make_grid(16, device="cpu")
    x = coll.solve_ivp_dense(grid, _t(case["m64"]), _t(case["q0"])).numpy()
    # f64 LU on both sides; the oracle inverts explicitly (main.cpp:113).
    assert np.abs(x - case["dense"]).max() < 1e-12
    assert np.abs(x - case["oracle_q"]).max() < 1e-10


def test_collocation_matrix_matches_jax(case):
    a = coll.collocation_matrix(coll.make_grid(16, device="cpu"), _t(case["m64"]))
    assert np.abs(a.numpy() - case["matrix"]).max() < 1e-13


def test_picard_matches_jax(case):
    grid = coll.make_grid(16, device="cpu")
    m32 = _t(case["m64"], torch.float32)
    rhs = coll.ivp_rhs(grid, _t(case["q0"], torch.float32)).expand(B, 15, 4)
    x = coll.solve_ivp_picard(grid, m32, rhs=rhs, iters=24)
    assert x.dtype == torch.float32
    # f32 on both sides, summed in different orders: the 'highest' gate of
    # tests/test_pallas_kernel.py:26.
    assert np.abs(x.numpy() - case["picard"]).max() < 2e-6
    # against the f64 truth: the XLA picard path's ~1e-7 accuracy class
    assert np.abs(x.numpy() - case["oracle_q"]).max() < 2e-6
    y = coll.solve_ivp_picard_implicit(grid, m32, rhs, iters=24)
    assert torch.equal(x, y)


def test_refined_matches_jax_and_oracle(case):
    grid = coll.make_grid(16, device="cpu")
    m_dd = tuple(_t(a, torch.float32) for a in case["m_dd"])
    rhs_dd = tuple(_t(a, torch.float32) for a in case["rhs_dd"])
    hi, lo = coll.solve_ivp_refined(grid, m_dd, rhs_dd, iters=24, refine_steps=2)
    x = dd.join_f64(hi, lo).numpy()
    ref = case["oracle_q"]
    # the refined gate, relative L-inf < 1e-8 (tests/test_refined_kernel.py:77)
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-8
    assert np.abs(x - case["refined"]).max() / np.abs(ref).max() < 1e-8


def test_residual_quat_dd_matches_jax(case):
    pairs, ref = case["res_pairs"], case["residual_dd"]
    mine = coll.residual_quat_dd(
        coll.make_grid(16, device="cpu"), tuple(_t(p, torch.float32) for p in pairs[0]),
        *[_t(p, torch.float32) for p in pairs[1]],
        *[_t(p, torch.float32) for p in pairs[2]])
    mine = dd.join_f64(*mine).numpy()
    # the dd residual is exact to ~2^-48 relative (collocation.py:277)
    assert np.abs(mine - ref).max() < 1e-12 * np.abs(ref).max()
    # and equals rhs - Dn_NN x + 1/2 A(K) x formed in numpy f64 from the
    # joined pairs with the 4x4 blocks of main.cpp:72-75
    k, x, rhs = (np.asarray(h, np.float64) + np.asarray(l, np.float64) for h, l in pairs)
    blocks = 0.5 * np.stack([oracle.quat_a_matrix(v) for v in k.reshape(-1, 3)])
    direct = (rhs - np.einsum("ij,bjc->bic", JCFG.grid.dn_nn, x)
              + np.einsum("pce,pe->pc", blocks, x.reshape(-1, 4)).reshape(x.shape))
    assert np.abs(direct - mine).max() < 1e-12 * np.abs(ref).max()


def test_quadrature_refined_matches_jax_and_oracle(case):
    pair, ref = case["quad_pair"], case["quadrature"]
    mine = coll.quadrature_refined(coll.make_grid(16, device="cpu"),
                                   tuple(_t(p, torch.float32) for p in pair))
    mine = dd.join_f64(*mine).numpy()
    exact = np.linalg.solve(oracle.diff_matrix(16)[:15, :15], dd.join_f64(
        *[_t(p, torch.float32) for p in pair]).numpy())
    assert np.abs(mine - exact).max() < 1e-12 * np.abs(exact).max()
    assert np.abs(mine - ref).max() < 1e-10 * np.abs(exact).max()


def test_ivp_rhs_matches_jax(case):
    mine = coll.ivp_rhs(coll.make_grid(16, device="cpu"), _t(case["y0"]), _t(case["g"]))
    assert np.abs(mine.numpy() - case["ivp_rhs"]).max() < 1e-13
