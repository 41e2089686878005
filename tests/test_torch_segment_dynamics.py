"""Port parity: dynamics of segmented rods (``SegmentedDynamicsConfig``).

The host tables (``k_ee``, ``quad_weights_full``, ``points_full``,
``kappa0_modes``), ``state_full`` and one ``_mass_and_rhs`` with every load
branch that reads the chained velocity tangent, on a chain with a tendon
terminated at the first junction, take the same numpy ``default_rng``
inputs as the JAX package's (one ``jax.jit``) and agree within ``1e-10
max(1, |ref|)``.  The integrators, the contact statics and the spectra on
the chain are held to the gates of ``tests/test_segment_dynamics.py`` at
that file's sizes or smaller.
"""

import numpy as np
import pytest
import torch
import jax

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    dynamics as jdyn,
    segment_statics as jss,
    segments as jseg,
    tendon as jten,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    dynamics,
    segment_statics,
    segments,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

F64 = torch.float64
B = 3

JCFG = jdyn.SegmentedDynamicsConfig(
    statics=jss.SegmentedStaticsConfig(
        rods=jseg.uniform_segments(2, n=8, ne=3), stiffness=((1.0, 1.5, 1.2), (2.0, 1.0, 1.0)),
        kappa0=((0.1, 0.0, 0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0), (0.0,) * 9),
        tendons=(jten.Tendon(offset=(0.0, 0.0, 0.05)),
                 jten.Tendon(offset=(0.0, 0.03, 0.0), capstan=0.5)),
        tendon_end=(0, 1)),
    rho_a=1.0, rho_i=1e-2, kv_damping=0.01, gravity=(0.0, 0.0, -1.0),
    contact=jdyn.ContactPlane(offset=-0.1, stiffness=1e3, smoothing=1e-2, damping=1.0,
                              friction=0.3, friction_vel=0.1),
    fluid_drag=(0.3, 0.6))


def _inputs():
    rng = np.random.default_rng(0)
    return dict(qe=0.3 * rng.standard_normal((B, 18)), qd=rng.standard_normal((B, 18)),
                tip_force=0.3 * rng.standard_normal((B, 3)),
                tip_moment=0.1 * rng.standard_normal((B, 3)),
                tension=rng.uniform(0.0, 2.0, (B, 2)))


@jax.jit
def _jax_reference(x):
    r, q = JCFG.state_full(x["qe"], 16)
    m, rhs = jdyn._mass_and_rhs(x["qe"], x["qd"], JCFG, x["tip_force"], 16, x["tip_moment"],
                                tension=x["tension"])
    return r, q, m, rhs


def _uniform(rho_i=1e-3, **kw):
    """tests/test_segment_dynamics.py:16-20: two uniform n=12 segments."""
    return dynamics.SegmentedDynamicsConfig(
        statics=segment_statics.SegmentedStaticsConfig(
            rods=segments.uniform_segments(2, n=12, ne=3)), rho_a=1.0, rho_i=rho_i, **kw)


def _bent(cfg):
    qe0 = torch.zeros(cfg.nq, dtype=F64)
    qe0[3], qe0[12] = 0.3, 0.2
    return qe0


def test_segmented_config_matches_jax():
    """The host tables exactly; the tip-first chained state and the whole
    Euler-Lagrange assembly (mass, Coriolis terms through the chained
    velocity tangent, tip wrench, gravity, the damped and frictional plane,
    fluid drag, Kelvin-Voigt, two tendons, one ending at the first
    junction) within 1e-10 max(1, |ref|)."""
    cfg = convert.dynamics_config_from_jax(JCFG)
    assert cfg.nq == JCFG.nq == 18 and cfg.tendons == cfg.statics.tendons
    for name in ("k_ee", "quad_weights_full", "points_full", "kappa0_modes"):
        np.testing.assert_array_equal(getattr(cfg, name), getattr(JCFG, name))
    x = _inputs()
    ref = [np.asarray(a) for a in _jax_reference(x)]
    t = {k: torch.tensor(v) for k, v in x.items()}
    r, q = cfg.state_full(t["qe"], 16)
    m, rhs = dynamics._mass_and_rhs(t["qe"], t["qd"], cfg, t["tip_force"], 16, t["tip_moment"],
                                    tension=t["tension"])
    for mine, theirs in zip((r, q, m, rhs), ref):
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(theirs).max()))
    with pytest.raises(ValueError, match="single-rod"):
        dynamics.mass_matrix_fused(t["qe"], cfg)


def test_segmented_spectrum_matches_cantilever_series():
    """tests/test_segment_dynamics.py:23-33: a uniform two-segment chain is
    a cantilever: (beta_k L)^2, doubled, rtol 2e-3 and 5e-3."""
    cfg = _uniform(rho_i=1e-4)
    freqs = np.sort(dynamics.natural_frequencies(cfg, torch.zeros(cfg.nq, dtype=F64)))
    np.testing.assert_allclose(freqs[:2], 1.875104 ** 2, rtol=2e-3)
    np.testing.assert_allclose(freqs[2], 4.694091 ** 2, rtol=5e-3)


def test_segmented_integrators_conserve_energy():
    """tests/test_segment_dynamics.py:35-57 over fewer steps: RK4 (6 of 300
    steps of 5e-4) within 1e-4 relative energy, Newmark (3 of 60 steps of
    0.02) within 1e-2, both finite."""
    cfg = _uniform()
    qe0 = _bent(cfg)
    for traj, bound in ((dynamics.simulate(qe0, torch.zeros_like(qe0), cfg, dt=5e-4, steps=6),
                         1e-4),
                        (dynamics.simulate_implicit(qe0, torch.zeros_like(qe0), cfg, dt=0.02,
                                                    steps=3, iters=12, tol=1e-10), 1e-2)):
        e = traj.energies.numpy()
        assert np.isfinite(e).all() and traj.qes.shape[-1] == 18
        assert abs(e[-1] - e[0]) / abs(e[0]) < bound
    assert float((traj.qes[-1] - qe0).abs().max()) > 1e-2


def test_segmented_contact_statics_matches_segmented_newton():
    """tests/test_segment_dynamics.py:60-74: the Lagrangian balance's Newton
    on the chain lands on the weak-form segmented equilibrium within
    1e-10."""
    cfg = _uniform()
    tip = torch.tensor([0.0, 0.0, 0.4], dtype=F64)
    ref = segment_statics.solve_segmented_statics(tip, cfg=cfg.statics)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(cfg.nq, dtype=F64), tip_force=tip)
    assert bool(sol.converged)
    assert float((sol.qe.reshape(2, -1) - ref.qe).abs().max()) < 1e-10


def test_segmented_terminated_tendon_closed_form():
    """tests/test_segment_dynamics.py:77-99: a cable anchored at the first
    junction bends the covered segment to kappa_y = -T delta / EI and leaves
    the free one straight (atol 1e-9); its tendons are mirrored from the
    statics config."""
    delta, tension = 0.05, 2.0
    sscfg = segment_statics.SegmentedStaticsConfig(
        rods=segments.uniform_segments(2, n=12, ne=3),
        tendons=(tendon.Tendon(offset=(0.0, 0.0, delta)),), tendon_end=(0,))
    cfg = dynamics.SegmentedDynamicsConfig(statics=sscfg, rho_a=1.0, rho_i=1e-3)
    assert cfg.tendons == sscfg.tendons
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(cfg.nq, dtype=F64),
                                         tension=torch.tensor([tension], dtype=F64))
    assert bool(sol.converged)
    expected = np.zeros((2, 9))
    expected[0, 3] = -tension * delta
    np.testing.assert_allclose(sol.qe.reshape(2, -1).numpy(), expected, atol=1e-9)
