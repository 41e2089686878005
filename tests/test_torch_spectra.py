"""Port parity: the spectrum and stability tools (models/dynamics.py).

``natural_frequencies`` and ``linearized_spectrum`` (symmetric and not,
with modes) take the same numpy ``default_rng`` state and loads as the JAX
package's and agree within 1e-10 relative.  The JAX functions run their
eigenproblems on the host and are not jitted; the test jits the two JAX
internals they call (``mass_matrix`` and the balance residual that
``jax.jacfwd`` differentiates), which is the same arithmetic compiled once
instead of op by op (13.5 s eager, 4 s jitted).  The other tools are
held to the physical gates of ``tests/test_dynamics.py``,
``tests/test_floquet.py`` and ``tests/test_fluid.py``, cited per test, at
those tests' sizes or smaller.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    cosserat as jcos,
    dynamics as jdyn,
    rod as jrod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    bifurcation,
    cosserat,
    dynamics,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

F64 = torch.float64
EB1, EB2 = 1.875104 ** 2, 4.694091 ** 2     # cantilever (beta_k L)^2, EI = rho_a = L = 1


def _dyn(n=12, ne=3, **kw):
    statics = {k: kw.pop(k) for k in ("stiffness", "follower") if k in kw}
    return dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=n, ne=ne), **statics), **kw)


def _rest(cfg):
    return torch.zeros(cfg.nq, dtype=F64)


def _assert_same_poles(poles, expected, rtol, atol):
    """Equal as multisets: every pole within ``atol + rtol |e|`` of its
    nearest expected one and back (``sort_complex`` pairs a degenerate
    pair's copies by their roundoff in the real part)."""
    for a, b in ((poles, expected), (expected, poles)):
        gap = np.abs(a[:, None] - b[None, :])
        assert (gap.min(axis=1) <= atol + rtol * np.abs(a)).all(), (a, b)
    assert poles.shape == expected.shape


def test_spectra_match_jax(monkeypatch):
    """A bent, loaded state (gravity, follower tip force): the frequencies
    about it and the full spectrum with its modes, symmetric and not,
    within 1e-10 of the JAX package's."""
    mass_matrix, balance = jdyn.mass_matrix, jdyn._balance_residual_fn
    jitted_mass = jax.jit(mass_matrix, static_argnums=(1, 2))
    monkeypatch.setattr(jdyn, "mass_matrix", lambda q, cfg, iters=24: jitted_mass(q, cfg, iters))
    monkeypatch.setattr(jdyn, "_balance_residual_fn", lambda *a: jax.jit(balance(*a)))
    jcfg = jdyn.DynamicsConfig(
        statics=jcos.StaticsConfig(rod=jrod.RodConfig(n=10, ne=3), stiffness=(1.0, 1.3, 0.8),
                                   follower=True),
        rho_a=1.0, rho_i=1e-2, gravity=(0.0, 0.0, -1.0))
    cfg = convert.dynamics_config_from_jax(jcfg)
    rng = np.random.default_rng(1)
    qe, force = 0.3 * rng.standard_normal(9), 0.5 * rng.standard_normal(3)
    ref = jdyn.natural_frequencies(jcfg, jnp.asarray(qe))
    np.testing.assert_allclose(dynamics.natural_frequencies(cfg, torch.tensor(qe)), ref,
                               rtol=1e-10, atol=0)
    for symmetric in (True, False):
        om2_ref, v_ref = jdyn.linearized_spectrum(jcfg, jnp.asarray(qe),
                                                  tip_force=jnp.asarray(force), modes=True,
                                                  symmetric=symmetric)
        om2, v = dynamics.linearized_spectrum(cfg, torch.tensor(qe), tip_force=torch.tensor(force),
                                              modes=True, symmetric=symmetric)
        scale = np.abs(om2_ref).max()
        np.testing.assert_allclose(om2, om2_ref, rtol=0, atol=1e-10 * scale)
        # modes up to sign: each column against the reference's
        v_ref = np.asarray(v_ref)
        sign = np.sign(np.real(np.sum(v * np.conj(v_ref), axis=0)))
        np.testing.assert_allclose(v * sign, v_ref, rtol=0, atol=1e-10 * np.abs(v_ref).max())


def test_natural_frequencies_match_euler_bernoulli():
    """tests/test_dynamics.py:14-25 (and :759-772): the cantilever series,
    doubled for two bending planes; about the rest state the full spectrum
    reproduces them to roundoff."""
    cfg = _dyn(n=16, ne=5, rho_a=1.0, rho_i=1e-4)
    freqs = np.sort(dynamics.natural_frequencies(cfg, _rest(cfg)))
    np.testing.assert_allclose(freqs[:2], EB1, rtol=2e-3)
    np.testing.assert_allclose(freqs[2:4], EB2, rtol=5e-3)
    om2 = dynamics.linearized_spectrum(cfg, _rest(cfg))
    np.testing.assert_allclose(np.sqrt(np.clip(om2, 0.0, None)), freqs, atol=1e-10)


def test_omega2_crosses_zero_at_buckling():
    """tests/test_dynamics.py:775-793: the smallest omega^2 under an axial
    tip load is > 0.3 at 0.95 P_cr and < -0.3 at 1.05 P_cr, P_cr from
    ``bifurcation.linearized_buckling_loads``."""
    cfg = _dyn(rho_a=1.0, rho_i=1e-2)
    pcr = bifurcation.linearized_buckling_loads(torch.tensor([-1.0, 0.0, 0.0], dtype=F64),
                                                cfg.statics)
    p = float(pcr[pcr > 0][0])
    lo, hi = (dynamics.linearized_spectrum(cfg, _rest(cfg),
                                           tip_force=torch.tensor([-s * p, 0.0, 0.0]))
              for s in (0.95, 1.05))
    assert lo[0] > 0.3 and hi[0] < -0.3, (lo[0], hi[0])


def test_beck_column_flutter_and_ziegler_paradox():
    """tests/test_dynamics.py:893-939: under a follower load the spectrum is
    real at P=19.5 and has a complex pair (|Im| > 10) at P=21 with no real
    part below 0; with Kelvin-Voigt damping 1e-3 a pole crosses into Re > 0
    between P=10.5 and 11, where the undamped spectrum is still real."""
    cfg = _dyn(n=14, ne=5, follower=True, rho_a=1.0, rho_i=1e-4)
    lo, hi = (dynamics.linearized_spectrum(cfg, _rest(cfg), tip_force=torch.tensor([-p, 0.0, 0.0]),
                                           symmetric=False) for p in (19.5, 21.0))
    assert np.max(np.abs(lo.imag)) < 1e-6 * np.max(np.abs(lo.real)) and np.min(lo.real) > 0.0
    assert np.max(np.abs(hi.imag)) > 10.0 and np.min(hi.real) > 0.0
    kv = _dyn(n=14, ne=5, follower=True, rho_a=1.0, rho_i=1e-4, kv_damping=1e-3)
    poles_lo, poles_hi = (dynamics.damped_spectrum(kv, _rest(kv),
                                                   tip_force=torch.tensor([-p, 0.0, 0.0]))
                          for p in (10.5, 11.0))
    assert np.max(poles_lo.real) < 0.0 < np.max(poles_hi.real)
    om2 = dynamics.linearized_spectrum(cfg, _rest(cfg), tip_force=torch.tensor([-11.0, 0.0, 0.0]),
                                       symmetric=False)
    assert np.max(np.abs(om2.imag)) < 1e-6 * np.max(np.abs(om2.real)) and np.min(om2.real) > 0


def test_damped_spectrum_poles_match_modal_damping_ratios():
    """tests/test_dynamics.py:868-890: undamped poles are +-i omega
    (rtol 1e-9); with C = c M + kv K the poles are the per-mode roots of
    lambda^2 + (c + kv omega^2) lambda + omega^2 (rtol 1e-6)."""
    cfg0 = _dyn(rho_i=1e-3)
    omega = np.sqrt(np.sort(dynamics.linearized_spectrum(cfg0, _rest(cfg0))))
    poles0 = dynamics.damped_spectrum(cfg0, _rest(cfg0))
    np.testing.assert_allclose(np.max(np.abs(poles0.real)), 0.0, atol=1e-8 * omega[-1])
    np.testing.assert_allclose(np.sort(np.abs(poles0.imag))[::2], omega, rtol=1e-9)
    kv, c_m = 0.015, 0.3
    cfg = _dyn(rho_i=1e-3, damping=c_m, kv_damping=kv)
    poles = dynamics.damped_spectrum(cfg, _rest(cfg))
    expected = np.concatenate([np.roots([1.0, c_m + kv * w ** 2, w ** 2]) for w in omega])
    _assert_same_poles(poles, expected, rtol=1e-6, atol=1e-9)


def test_fluid_drag_in_the_spectra():
    """tests/test_fluid.py:59-70 and :85-100: isotropic drag puts the first
    bending poles at Re = -c / (2 rho_a) (rtol 1e-3), and drag cuts the
    resonant tip response more than tenfold."""
    c = 0.8
    cfg = _dyn(n=16, ne=4, rho_a=1.0, rho_i=1e-7, fluid_drag=(c, c))
    poles = dynamics.damped_spectrum(cfg, _rest(cfg))
    sel = poles[(np.abs(poles.imag) > 0.5 * EB1) & (np.abs(poles.imag) < 1.5 * EB1)]
    assert sel.size >= 2
    np.testing.assert_allclose(sel.real, -c / 2.0, rtol=1e-3)
    amps = [np.max(np.abs(dynamics.frequency_response(
        _dyn(rho_a=1.0, rho_i=1e-3, fluid_drag=fd), [EB1], qe=torch.zeros(9, dtype=F64),
        drive_force=(0.0, 0.0, 1e-3)))) for fd in ((0.0, 1e-6), (1.0, 2.0))]
    assert amps[1] < amps[0] / 10.0, amps


def test_frequency_response_matches_modal_closed_form():
    """tests/test_dynamics.py:970-991, part (a): at rest M, C and K share
    the modal basis, so A = V diag(1/(w_k^2 - w^2 + i w (c + kv w_k^2)))
    V^T f to 1e-12; the tip observation is the tip Jacobian times it."""
    c_m, kv = 0.5, 0.01
    cfg = _dyn(n=10, rho_a=1.0, rho_i=1e-3, damping=c_m, kv_damping=kv)
    z = _rest(cfg)
    om2, v = dynamics.linearized_spectrum(cfg, z, modes=True)
    ws = np.sqrt(om2[0]) * np.array([0.5, 1.0, 2.0])
    ez = torch.tensor([0.0, 0.0, 1e-3], dtype=F64)
    amps = dynamics.frequency_response(cfg, ws, drive_force=ez, qe=z, observe="modes")
    f = (dynamics._balance_residual_fn(cfg, ez, None, 24)(z)
         - dynamics._balance_residual_fn(cfg, None, None, 24)(z)).numpy()
    for i, w in enumerate(ws):
        a_cf = v @ ((v.T @ f) / (om2 - w * w + 1j * w * (c_m + kv * om2)))
        assert np.abs(amps[i] - a_cf).max() < 1e-12 * np.abs(a_cf).max()
    tip = dynamics.frequency_response(cfg, ws, drive_force=ez, qe=z)
    j_tip = torch.func.jacfwd(lambda q: dynamics._positions_full(q, cfg, 24)[0])(z).numpy()
    np.testing.assert_allclose(tip, amps @ j_tip.T, rtol=1e-12, atol=1e-18)
    with pytest.raises(ValueError, match="drive_force"):
        dynamics.frequency_response(cfg, ws, qe=z)


def test_critical_load_classical_boundaries():
    """tests/test_dynamics.py:942-967: one criterion (max Re of the damped
    poles) finds Euler divergence at pi^2/4 (rtol 1e-2), Beck flutter at
    20.05 (rtol 0.03) and the Ziegler limit in (10.3, 11.6)."""
    rc = dict(n=12, ne=4)
    d = torch.tensor([-1.0, 0.0, 0.0], dtype=F64)
    p_euler = dynamics.critical_load(_dyn(**rc, rho_a=1.0, rho_i=1e-4), direction=d, load_hi=5.0,
                                     bisect_tol=0.02)
    np.testing.assert_allclose(p_euler, np.pi ** 2 / 4.0, rtol=1e-2)
    p_beck = dynamics.critical_load(_dyn(**rc, follower=True, rho_a=1.0, rho_i=1e-4),
                                    direction=d, load_lo=15.0, load_hi=25.0, bisect_tol=0.2)
    np.testing.assert_allclose(p_beck, 20.05, rtol=0.03)
    p_zig = dynamics.critical_load(_dyn(**rc, follower=True, rho_a=1.0, rho_i=1e-4,
                                        kv_damping=1e-3),
                                   direction=d, load_lo=5.0, load_hi=15.0, bisect_tol=0.2)
    assert 10.3 < p_zig < 11.6 and p_zig < 0.6 * p_beck, p_zig


def test_floquet_multipliers_equal_exp_of_damped_poles():
    """tests/test_floquet.py:14-36 over 6% of its period (0.015, 6 RK4 steps
    at the test's dt |lambda|_max <= 0.15): the monodromy's eigenvalues are
    exp(lambda T) of the damped_spectrum poles (rtol 2e-4) and lie inside
    the unit circle."""
    cfg = _dyn(n=8, ne=2, rho_a=1.0, rho_i=1e-2, damping=0.5, kv_damping=2e-3)
    poles = dynamics.damped_spectrum(cfg, _rest(cfg))
    period = 0.015
    steps = int(np.ceil(period * float(np.abs(poles).max()) / 0.15))
    mus = dynamics.floquet_multipliers(cfg, period, steps, qe0=_rest(cfg))
    _assert_same_poles(mus, np.exp(poles * period), rtol=2e-4, atol=1e-8)
    assert np.abs(mus).max() < 1.0
