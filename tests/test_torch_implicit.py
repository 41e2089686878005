"""Port checks: implicit Newmark ``simulate_implicit`` and the parametric
stability map (models/dynamics.py).

No JAX ``simulate_implicit`` or ``parametric_stability_map`` is compiled
here (each costs 10-20 s): the port is held to the physical gates of
``tests/test_dynamics.py`` at those tests' sizes or smaller, and to the JAX
package's Newton stop test, which reads the norm of the whole batch's
residual, not a per-sample maximum.
"""

import numpy as np
import pytest
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    dynamics,
    magnetics,
    rod,
    tendon,
)
from torch_threads import one_cpu_thread  # noqa: F401

F64 = torch.float64


def _cfg(n, **kw):
    statics = {k: kw.pop(k) for k in ("stiffness",) if k in kw}
    return dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=n), **statics), rho_a=1.0, **kw)


def _bent(v=0.0):
    qe0, qd0 = torch.zeros(9, dtype=F64), torch.zeros(9, dtype=F64)
    qe0[4], qd0[1] = 0.3, v
    return qe0, qd0


def test_newmark_matches_rk4_and_conserves_energy():
    """tests/test_dynamics.py:105-122 over 3 of its 20 steps at n=8 (12
    Picard steps): the trapezoidal rule at dt = 2e-3 within 5e-4 of RK4 at
    dt/4, and its energy within 1e-3 of the start."""
    cfg = _cfg(8, rho_i=1e-2)
    qe0, qd0 = _bent()
    imp = dynamics.simulate_implicit(qe0, qd0, cfg, dt=2e-3, steps=3, iters=12, tol=1e-11)
    rk = dynamics.simulate(qe0, qd0, cfg, dt=5e-4, steps=12, iters=12)
    assert imp.qes.shape == (3, 9) and imp.energies.shape == (3,)
    torch.testing.assert_close(imp.times, rk.times[3::4], rtol=1e-15, atol=0)
    np.testing.assert_allclose(imp.qes[-1].numpy(), rk.qes[-1].numpy(), rtol=0, atol=5e-4)
    assert float((imp.qes[-1] - qe0).abs().max()) > 1e-3        # it moved
    e = imp.energies.numpy()
    assert abs(e[-1] - e[0]) < 1e-3 * abs(e[0])


def test_newmark_stops_on_the_whole_batch_norm(monkeypatch):
    """The Newton loop stops on the norm of the WHOLE batch's residual
    (the JAX package's models/dynamics.py:1354-1357): one step's residual
    norms run 0.2, 1.4e-3, 7.1e-10, 1.6e-14, so at T = 1e-9 one rod stops
    after two Newton iterates, and four copies of it (norm x2) take a third,
    as one rod at T/2 would; a per-sample maximum would stop them at two."""
    cfg = _cfg(8, rho_i=1e-2)
    qe0, qd0 = _bent(0.5)
    counts = []
    newton_step = cosserat._newton_step

    def counted(jac, res):
        counts[-1] += 1
        return newton_step(jac, res)

    monkeypatch.setattr(cosserat, "_newton_step", counted)

    def run(qe, qd):
        counts.append(0)
        return dynamics.simulate_implicit(qe, qd, cfg, dt=0.01, steps=1, tol=1e-9,
                                          record_energy=False).qes[-1]

    one, four = run(qe0, qd0), run(qe0.expand(4, 9), qd0.expand(4, 9))
    assert counts == [2, 3]
    assert float((four - one).abs().max()) > 1e-12         # the third iterate moved them


def test_newmark_drives_and_loads():
    """Callable drives equal the same constants and are read at t0 (the
    start acceleration) and at each step's end; tendon tension and a
    magnetic field act; the energy record is ``total_energy`` with the loads
    at each step's end."""
    cfg = _cfg(8, rho_i=1e-2, tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.05)),),
               magnets=(magnetics.Magnet(moment=(0.5, 0.0, 0.0)),))
    qe0, qd0 = _bent(0.2)
    force, accel = torch.tensor([0.0, 0.1, -0.2], dtype=F64), torch.tensor([0.0, 0.0, 0.3],
                                                                           dtype=F64)
    kw = dict(dt=0.01, steps=1, iters=12, tension=(0.8,), b_field=(0.0, 0.05, 0.0), t0=0.5)
    seen = []
    traj = dynamics.simulate_implicit(qe0, qd0, cfg, tip_force=lambda t: seen.append(float(t))
                                      or force, base_accel=lambda t: accel, **kw)
    const = dynamics.simulate_implicit(qe0, qd0, cfg, tip_force=force, base_accel=accel, **kw)
    assert seen == pytest.approx([0.5, 0.51])
    torch.testing.assert_close(traj.qes, const.qes, rtol=0, atol=0)
    torch.testing.assert_close(traj.times, torch.tensor([0.51], dtype=F64))
    torch.testing.assert_close(traj.energies[-1], dynamics.total_energy(
        traj.qes[-1], traj.qds[-1], cfg, 12, tension=torch.tensor([0.8], dtype=F64),
        b_field=torch.tensor([0.0, 0.05, 0.0], dtype=F64)), rtol=1e-14, atol=0)
    unloaded = dynamics.simulate_implicit(qe0, qd0, cfg, tip_force=force, base_accel=accel,
                                          dt=0.01, steps=1, iters=12, t0=0.5)
    assert float((unloaded.qes[-1] - traj.qes[-1]).abs().max()) > 1e-6


def test_parametric_stability_map_locates_tongue():
    """tests/test_dynamics.py:352-373 on a 2x2 (Omega, P1) grid, over 7.5
    time units at dt 0.15 (the test's 23 at 0.045): at the stronger drive the
    2:1 row (Omega = 2 omega_1) grows more than 10x the detuned row (1.37
    omega_1), and within it growth increases with the drive (8 Picard steps:
    the growth factors agree with 12 to four digits)."""
    cfg = _cfg(12, stiffness=(1.0, 1.0, 1.3), rho_i=1e-2, damping=0.2)
    w1 = float(np.sort(dynamics.natural_frequencies(cfg, torch.zeros(9, dtype=F64)))[0])
    p_cr = np.pi ** 2 / 4.0
    growth = dynamics.parametric_stability_map(
        cfg, torch.tensor([1.37 * w1, 2.0 * w1], dtype=F64),
        torch.tensor([0.3 * p_cr, 0.55 * p_cr], dtype=F64), t_end=7.5, dt=0.15,
        iters=8).numpy()
    assert growth.shape == (2, 2)
    assert growth[1, 1] > 10.0 * growth[0, 1], growth
    assert growth[1, 1] > growth[1, 0], growth
