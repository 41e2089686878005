"""Port parity: multi-segment statics (models/segment_statics.py).

The JAX package's chained residual (one ``jax.jit`` program, picard chain
with 24 steps: at these strains a segment's rho stays below ~0.6, so it is
converged to f64 rounding) is the parity reference of the port's 'dense'
and 'picard' residuals; the port's own f64 residual is then the reference
of its kernel paths, as
``tests/test_segment_statics.py`` holds the JAX ones: the fused Jacobian
(K4 state, K2 tangents; plain versions on the CPU) against ``jacfwd`` at
large amplitude, the batched Newton against the per-sample one, the FP64
residual of the K5 chain against the f64 residual, and the exact tip-couple
law.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    segment_statics as jss,
    segments as jseg,
    tendon as jtendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    rod,
    segment_statics as ss,
    segments,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

STIFF = ((1.0, 1.0, 1.3), (1.0, 0.7, 1.0))      # tests/test_segment_statics.py:127-129
JCFGS = {   # name: JAX config of the residual parity cases
    "base": jss.SegmentedStaticsConfig(rods=jseg.uniform_segments(2, n=16), stiffness=STIFF),
    "follower_kappa0": jss.SegmentedStaticsConfig(
        rods=jseg.uniform_segments(3, n=12), stiffness=(1.0, 1.5, 1.5), follower=True,
        kappa0=tuple(tuple(0.1 * np.arange(9.0) - 0.3 + s) for s in range(3))),
    "reissner": jss.SegmentedStaticsConfig(
        rods=jseg.uniform_segments(2, n=12, na=6, ne=2),
        stiffness=(1.0, 1.0, 1.0, 50.0, 10.0, 10.0)),
}
QE_TOL = 2e-5      # batched vs per-sample Newton, tests/test_segment_statics.py:169-170


def _cfg(name):
    return convert.segmented_statics_config_from_jax(JCFGS[name])


def _inputs(name):
    jcfg = JCFGS[name]
    rng = np.random.default_rng(7)
    nq = jcfg.rods.segments[0].na * jcfg.rods.segments[0].ne
    return (0.5 * rng.standard_normal((2, jcfg.rods.num_segments, nq)),
            0.4 * rng.standard_normal((2, 3)), 0.2 * rng.standard_normal((2, 3)))


@jax.jit
def _jax_residuals(inputs):
    return {name: jax.vmap(lambda q, f, m, c=JCFGS[name]: jss.segmented_equilibrium_residual(
        q, f, m, c, iters=24))(*inputs[name]) for name in JCFGS}


@pytest.fixture(scope="module")
def jax_res():
    out = _jax_residuals({name: tuple(map(jnp.asarray, _inputs(name))) for name in JCFGS})
    return {name: np.asarray(r) for name, r in out.items()}


@pytest.mark.parametrize("name", sorted(JCFGS))
def test_residual_matches_jax(jax_res, name):
    """Every branch of the residual (per-segment stiffness, rest strain,
    follower force, Reissner force rows), dense and picard, f64."""
    qe, tf, tm = map(torch.tensor, _inputs(name))
    for method in ("dense", "picard"):
        res = ss.segmented_equilibrium_residual(qe, tf, tm, _cfg(name), iters=24,
                                                method=method)
        assert res.shape == qe.shape and res.dtype == torch.float64
        np.testing.assert_allclose(res.numpy(), jax_res[name], rtol=0, atol=1e-10)


def _dense_residual(cfg, qe_flat, tf):
    nq = qe_flat.shape[-1] // cfg.rods.num_segments
    r = ss.segmented_equilibrium_residual(qe_flat.reshape(-1, nq), tf,
                                          torch.zeros(3, dtype=torch.float64), cfg, iters=40,
                                          method="dense")
    return r.reshape(-1)


def test_fused_jacobian_matches_jacfwd():
    """tests/test_segment_statics.py:122-151: the kernel-lifted chained
    Jacobian at amplitude 0.8 (a scrambled direction table shows here, not
    in converged values) against jacfwd of the f64 dense residual."""
    cfg = _cfg("base")
    rng = np.random.default_rng(0)
    qe = torch.tensor(0.8 * rng.standard_normal((3, 2, 9)), dtype=torch.float32)
    tf = torch.tensor(0.5 * rng.standard_normal((3, 3)), dtype=torch.float32)
    res_f, jac_f = ss.segmented_residual_and_jacobian_fused(qe, tf, torch.zeros((3, 3)), cfg,
                                                            iters=30, jac_iters=30)
    assert res_f.shape == (3, 18) and jac_f.shape == (3, 18, 18)
    for i in range(3):
        q64, f64 = qe[i].double().reshape(18), tf[i].double()
        jac_ref = torch.func.jacfwd(lambda q: _dense_residual(cfg, q, f64))(q64)
        err = (jac_f[i].double() - jac_ref).abs().max() / jac_ref.abs().max()
        assert err < 1e-4, (i, float(err))
        assert (res_f[i].double() - _dense_residual(cfg, q64, f64)).abs().max() < 2e-5


def test_batched_newton_matches_per_sample():
    """tests/test_segment_statics.py:154-178: the batched Newton on the
    kernels against the per-sample jacfwd Newton, and the pure tip couple
    kappa_s = M / EI_s on the batched solver."""
    cfg = ss.SegmentedStaticsConfig(rods=segments.uniform_segments(2, n=16),
                                    stiffness=((1.0, 2.0, 2.0), (1.0, 1.0, 1.0)))
    loads = torch.tensor([[0.0, 0.0, 0.5], [0.2, 0.0, 0.3], [0.0, -0.3, 0.4],
                          [0.1, 0.1, -0.2]], dtype=torch.float32)
    sol = ss.solve_segmented_statics_batched(loads, cfg=cfg, tol=1e-5, max_iter=12, iters=20,
                                             jac_iters=10)
    assert sol.converged.all() and sol.qe.shape == (4, 2, 9) and sol.qe_lo is None
    ref = ss.solve_segmented_statics(loads.double(), cfg=cfg, tol=1e-11)
    assert ref.converged.all() and (ref.iterations >= 1).all()
    np.testing.assert_allclose(sol.qe.numpy(), ref.qe.numpy(), rtol=0, atol=QE_TOL)
    m = ss.solve_segmented_statics_batched(torch.zeros((1, 3)),
                                           tip_moment=torch.tensor([0.0, 0.6, 0.0]), cfg=cfg,
                                           tol=1e-6, iters=20, jac_iters=10)
    assert m.converged.all()
    np.testing.assert_allclose(m.qe[0, :, 3].numpy(), [0.3, 0.6], rtol=0, atol=1e-5)


def test_pure_tip_couple_piecewise_constant_curvature():
    """tests/test_segment_statics.py:26-43: kappa_s = M / EI_s exactly, only
    the P0 mode of kappa_y populated; zero load gives zero strain."""
    ei = (1.0, 2.5, 0.5)
    cfg = ss.SegmentedStaticsConfig(rods=segments.uniform_segments(3, n=16),
                                    stiffness=tuple((1.0, e, e) for e in ei))
    sol = ss.solve_segmented_statics(torch.zeros(3, dtype=torch.float64),
                                     tip_moment=torch.tensor([0.0, 0.7, 0.0], dtype=torch.float64),
                                     cfg=cfg, tol=1e-11)
    assert sol.converged
    expect = np.zeros((3, 9))
    expect[:, 3] = 0.7 / np.asarray(ei)
    np.testing.assert_allclose(sol.qe.numpy(), expect, rtol=0, atol=1e-8)
    zero = ss.solve_segmented_statics(torch.zeros(3, dtype=torch.float64), cfg=cfg)
    assert zero.converged and zero.qe.abs().max() < 1e-9


def test_dd_residual_and_newton():
    """tests/test_segment_statics.py:191-236: the FP64 residual of the K5
    chain against the f64 dense residual (1e-7), and the dd-residual batched
    Newton at tol 1e-9 on the per-sample f64 equilibrium (1e-10)."""
    cfg = _cfg("base")
    rng = np.random.default_rng(1)
    qe64 = torch.tensor(0.6 * rng.standard_normal((2, 2, 9)))
    tf = torch.tensor(0.4 * rng.standard_normal((2, 3)), dtype=torch.float32)
    r_dd = ss.segmented_equilibrium_residual_dd(rod.split_strain(qe64), tf, torch.zeros((2, 3)),
                                                cfg, iters=22)
    assert r_dd.dtype == torch.float32
    r64 = ss.segmented_equilibrium_residual(qe64, tf.double(), torch.zeros(3, dtype=torch.float64),
                                            cfg, iters=40, method="dense")
    assert (r_dd.double() - r64).abs().max() < 1e-7 * max(float(r64.abs().max()), 1.0)

    loads = torch.tensor([[0.0, 0.0, 0.5], [0.2, 0.0, 0.3]], dtype=torch.float32)
    sol = ss.solve_segmented_statics_batched(loads, cfg=cfg, tol=1e-9, max_iter=14, iters=20,
                                             jac_iters=10, dd_residual=True, dd_iters=22)
    assert sol.converged.all()
    qe_full = sol.qe.double() + sol.qe_lo.double()
    ref = ss.solve_segmented_statics(loads.double(), cfg=cfg, tol=1e-12, max_iter=40)
    assert (qe_full - ref.qe).abs().max() < 1e-10


def test_converters_round_trip_and_tendons_raise():
    """The converters carry every field, routed tendons and their anchors
    (``tendon_end``) included: tendons no longer raise."""
    jcfg = JCFGS["follower_kappa0"]
    cfg = convert.segmented_statics_config_from_jax(jcfg)
    assert cfg == ss.SegmentedStaticsConfig(
        rods=segments.uniform_segments(3, n=12), stiffness=(1.0, 1.5, 1.5), follower=True,
        kappa0=jcfg.kappa0)
    assert convert.segmented_rod_config_from_jax(jcfg.rods) == cfg.rods
    assert cfg.rods.boundaries == jcfg.rods.boundaries
    np.testing.assert_array_equal(cfg.stiffness_per_segment, jcfg.stiffness_per_segment)
    for mine, theirs in zip(cfg.full_tables + cfg.quad_weights,
                            jcfg.full_tables + jcfg.quad_weights):
        np.testing.assert_array_equal(mine, theirs)
    with_tendon = jss.SegmentedStaticsConfig(
        rods=jseg.uniform_segments(2, n=14, ne=4),
        tendons=(jtendon.Tendon(offset=(0.0, 0.0, 0.05)),
                 jtendon.Tendon(helix=(0.03, 1.0, 0.2), capstan=0.5)), tendon_end=(0, 1))
    cfg = convert.segmented_statics_config_from_jax(with_tendon)
    assert cfg == ss.SegmentedStaticsConfig(
        rods=segments.uniform_segments(2, n=14, ne=4),
        tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.05)),
                 tendon.Tendon(helix=(0.03, 1.0, 0.2), capstan=0.5)), tendon_end=(0, 1))
    assert cfg.tendon_last_segment == with_tendon.tendon_last_segment == (0, 1)
