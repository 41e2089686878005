"""Port parity: magnetic actuation (models/magnetics.py).

The JAX reference (one ``jax.jit``) is ``energy_from_state`` for a
``(B0, G)`` field and a profiled magnetization on the same full-grid state;
the equilibrium is held to the closed form of ``tests/test_magnetics.py``
through the port's own Newton.
"""

import numpy as np
import pytest
import torch
import jax

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    magnetics as jmag,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    dynamics,
    magnetics,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401


def _profile(xs):
    return np.stack([0.6 * xs, 0.1 * np.ones_like(xs), -0.2 * xs ** 2], axis=-1)


JMAGNETS = (jmag.Magnet(moment=(0.4, 0.0, 0.1)), jmag.Magnet(fn=_profile))


def _inputs():
    rng = np.random.default_rng(9)
    q, r = cosserat._full_grid_state(rod.RodConfig(n=16),
                                     torch.tensor(0.5 * rng.standard_normal((3, 9))), 30)
    xs = rod.RodConfig(n=16).points
    return dict(r=r.numpy(), q=q.numpy(), table=jmag.magnetization_table(JMAGNETS, xs),
                w=cosserat.StaticsConfig(rod=rod.RodConfig(n=16)).quad_weights,
                b0=0.3 * rng.standard_normal((3, 3)), grad=0.2 * rng.standard_normal((3, 3, 3)))


@jax.jit
def _jax_energy(x):
    b0, g = jmag.parse_field((x["b0"], x["grad"]), x["r"].dtype)
    return (jmag.energy_from_state(x["r"], x["q"], x["w"], x["table"], b0, g),
            jmag.energy_from_state(x["r"], x["q"], x["w"], x["table"], b0))


def test_energy_from_state_matches_jax():
    """``energy_from_state`` within 1e-12, a uniform field and a batched
    ``(B0, G)`` pair, two superposed magnets (one profiled)."""
    x = _inputs()
    ref_g, ref_u = (np.asarray(v) for v in _jax_energy(x))
    t = {k: torch.tensor(v) for k, v in x.items()}
    table = magnetics.magnetization_table(tuple(convert.magnet_from_jax(m) for m in JMAGNETS),
                                          rod.RodConfig(n=16).points)
    np.testing.assert_array_equal(table, x["table"])
    b0, g = magnetics.parse_field((t["b0"], t["grad"]), torch.float64)
    np.testing.assert_allclose(
        magnetics.energy_from_state(t["r"], t["q"], t["w"], t["table"], b0, g).numpy(), ref_g,
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        magnetics.energy_from_state(t["r"], t["q"], t["w"], t["table"], b0).numpy(), ref_u,
        rtol=0, atol=1e-12)


def test_field_spec_validation():
    """tests/test_magnetics.py:248-259: a ``(B0, G)`` pair needs a (..., 3, 3)
    gradient; a magnetization profile must return (n, 3)."""
    with pytest.raises(ValueError, match="3, 3"):
        magnetics.parse_field((np.zeros(3), torch.zeros((2, 2))), torch.float64)
    with pytest.raises(ValueError, match="Magnet.fn"):
        magnetics.Magnet(fn=lambda xs: np.zeros((3, len(xs)))).table(np.linspace(1, 0, 8))
    b0, g = magnetics.parse_field(torch.ones(3), torch.float64)
    assert g is None and b0.dtype == torch.float64
    assert magnetics.field_at(lambda t: t * 2.0, 1.5) == 3.0 and magnetics.field_at(None, 1) is None


def test_axial_magnet_linear_curvature_profile():
    """tests/test_magnetics.py:43-59: an axially magnetized rod in a small
    transverse field bends as kappa_y(X) = -m B (L - X) / EI_y (within 1e-9;
    the other components < 1e-10)."""
    m_mag, b_mag, ei = 0.4, 0.005, 2.0
    cfg = dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16), stiffness=(1.0, ei, ei)),
        magnets=(magnetics.Magnet(moment=(m_mag, 0.0, 0.0)),))
    field = torch.tensor([0.0, 0.0, b_mag], dtype=torch.float64)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(9, dtype=torch.float64),
                                         b_field=field, tol=1e-12)
    assert bool(sol.converged)
    kappa = rod.curvature_at_points(cfg.rod, sol.qe).numpy()
    x = cfg.rod.points[: kappa.shape[0]]
    assert np.abs(kappa[:, 1] + m_mag * b_mag * (cfg.rod.length - x) / ei).max() < 1e-9
    assert np.abs(kappa[:, [0, 2]]).max() < 1e-10
