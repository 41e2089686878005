"""Port parity: rod-rod contact and multi-rod scenes (models/dynamics.py).

``RodRodContact``'s potential, friction field, partner index and overflow
flag take the same numpy ``default_rng`` scenes as the JAX package's (the
four JAX calls of a scene under one ``jax.jit``) and agree to roundoff.  The broad phase, the friction law and
the scene paths (``simulate_scene``, ``scene_accelerations``,
``solve_contact_statics(rr=...)``, ``linearized_spectrum(rr=...)``) are
held to the physical gates of ``tests/test_broadphase.py`` and
``tests/test_dynamics.py`` at those tests' sizes or smaller; no JAX
``simulate_scene`` or ``solve_contact_statics`` is compiled here.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    dynamics as jdyn,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    dynamics,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    chebyshev,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

F64 = torch.float64


def _scene(nr=6, n=10, spread=0.18, seed=0):
    """tests/test_broadphase.py:24-38: mild random rods planted on a line,
    close enough that neighbours interact (full grids, world frame)."""
    rng = np.random.default_rng(seed)
    rc = rod.RodConfig(n=n, ne=2)
    sol = rod.rod_shape(torch.tensor(0.4 * rng.standard_normal((nr, 6))), cfg=rc, method="dense")
    r = torch.cat([sol.positions, torch.zeros((nr, 1, 3), dtype=F64)], dim=-2)
    base = np.zeros((nr, 3))
    base[:, 1] = spread * np.arange(nr)
    return r + torch.tensor(base)[:, None, :], torch.tensor(
        chebyshev.clenshaw_curtis_weights(n, 1.0)), rc


def _coil():
    """tests/test_broadphase.py:113-130: three coiling rods 2 apart, whose
    only contact is each rod with itself."""
    rc = rod.RodConfig(n=12, ne=2)
    rng = np.random.default_rng(4)
    qe = np.concatenate([6.0 * np.ones((3, 1)), np.zeros((3, 5))], axis=1)
    sol = rod.rod_shape(torch.tensor(qe + 0.1 * rng.standard_normal((3, 6))), cfg=rc,
                        method="dense")
    r = torch.cat([sol.positions, torch.zeros((3, 1, 3), dtype=F64)], dim=-2)
    base = torch.tensor([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 4.0, 0.0]])
    return r + base[:, None, :], torch.tensor(chebyshev.clenshaw_curtis_weights(12, 1.0)), rc


KW = dict(radius=0.09, stiffness=50.0, smoothing=5e-3, friction=0.4)


@pytest.mark.parametrize("scene,kw,overflow", [
    (dict(), dict(KW, self_window=0.3), False),                  # all pairs, self band
    (dict(nr=8, spread=0.05, seed=3), dict(KW, budget=2), True),  # crowded: overflow
    ("coil", dict(radius=0.06, stiffness=30.0, smoothing=5e-3, self_window=0.3, friction=0.2,
                  budget=1), False),
])
def test_rod_rod_contact_matches_jax(scene, kw, overflow):
    """pair_potential (rtol 1e-12), friction_force (1e-12 of its largest
    entry), the broad phase's partners and the overflow flag, against the
    JAX package on the same scene and velocities."""
    r_all, w_q, rc = _coil() if scene == "coil" else _scene(**scene)
    v_all = 0.3 * np.random.default_rng(1).standard_normal(tuple(r_all.shape))
    jrr = jdyn.RodRodContact(**kw)
    rr = convert.rod_rod_contact_from_jax(jrr)

    @jax.jit
    def jax_ref(r, v, w):
        return (jrr.pair_potential(r, w, s_grid=rc.points),
                jrr.friction_force(r, v, w, s_grid=rc.points),
                jrr.broadphase_overflow(r, margin=0.0),
                None if jrr.budget is None else jrr._partner_index(r))

    v_ref, f_ref, overflow_ref, partners_ref = jax_ref(
        jnp.asarray(r_all.numpy()), jnp.asarray(v_all), jnp.asarray(w_q.numpy()))
    v = float(rr.pair_potential(r_all, w_q, s_grid=rc.points))
    assert float(v_ref) > 0.0
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-12)
    f_ref = np.asarray(f_ref)
    f = rr.friction_force(r_all, torch.tensor(v_all), w_q, s_grid=rc.points).numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=1e-12 * np.abs(f_ref).max())
    assert bool(rr.broadphase_overflow(r_all, margin=0.0)) == bool(overflow_ref) == overflow
    if rr.budget is not None:
        np.testing.assert_array_equal(rr._partner_index(r_all).numpy(),
                                      np.asarray(partners_ref))


def test_full_and_adequate_budget_match_all_pairs():
    """tests/test_broadphase.py:41-79: budget R-2 with every partner gathered
    equals all pairs (rtol 1e-12), budget R-1 routes to all pairs, and an
    adequate budget 2 on a line of rods equals all pairs in the potential
    (1e-10), its force and the friction field (1e-8)."""
    r_all, w_q, _ = _scene()
    dense = dynamics.RodRodContact(radius=0.09, stiffness=50.0, smoothing=5e-3)
    full = dynamics.RodRodContact(radius=0.09, stiffness=50.0, smoothing=5e-3, budget=4)
    assert not dynamics.RodRodContact(budget=5)._use_broadphase(r_all)
    v_d = float(dense.pair_potential(r_all, w_q))
    assert v_d > 0.0
    np.testing.assert_allclose(float(full.pair_potential(r_all, w_q)), v_d, rtol=1e-12)

    r_all, w_q, _ = _scene(nr=6, spread=0.15)
    dense, bp = dynamics.RodRodContact(**KW), dynamics.RodRodContact(**KW, budget=2)
    assert not bool(bp.broadphase_overflow(r_all, margin=0.0))
    np.testing.assert_allclose(float(bp.pair_potential(r_all, w_q)),
                               float(dense.pair_potential(r_all, w_q)), rtol=1e-10)
    g_d, g_b = (torch.func.grad(lambda r: c.pair_potential(r, w_q))(r_all) for c in (dense, bp))
    torch.testing.assert_close(g_b, g_d, rtol=1e-8, atol=1e-12)
    v_all = torch.tensor(0.3 * np.random.default_rng(1).standard_normal(tuple(r_all.shape)))
    torch.testing.assert_close(bp.friction_force(r_all, v_all, w_q),
                               dense.friction_force(r_all, v_all, w_q), rtol=1e-8, atol=1e-12)


def test_broadphase_translation_invariant_and_momentum_free():
    """tests/test_broadphase.py:82-110: with an undersized budget (flagged)
    the potential depends on differences only (a shift leaves it to rtol
    1e-12) and its force sums to zero; far-apart rods do not overflow."""
    r_all, w_q, _ = _scene(nr=8, spread=0.05, seed=3)
    bp = dynamics.RodRodContact(radius=0.09, stiffness=50.0, smoothing=5e-3, budget=2)
    assert bool(bp.broadphase_overflow(r_all, margin=0.0))
    assert not bool(bp.broadphase_overflow(_scene(spread=0.5, seed=2)[0]))
    v0 = float(bp.pair_potential(r_all, w_q))
    assert v0 > 0.0
    shift = torch.tensor([0.3, -1.2, 0.7], dtype=F64)
    np.testing.assert_allclose(float(bp.pair_potential(r_all + shift, w_q)), v0, rtol=1e-12)
    g = torch.func.grad(lambda r: bp.pair_potential(r, w_q))(r_all)
    assert float(g.sum(dim=(0, 1)).abs().max()) < 1e-10 * float(g.abs().max())


def test_self_window_rides_broadphase_unchanged():
    """tests/test_broadphase.py:113-130: the self-contact band is per rod,
    so the coils' self-penalty is the same with the broad phase on."""
    r_all, w_q, rc = _coil()
    kw = dict(radius=0.06, stiffness=30.0, smoothing=5e-3, self_window=0.3)
    v_d = float(dynamics.RodRodContact(**kw).pair_potential(r_all, w_q, s_grid=rc.points))
    v_b = float(dynamics.RodRodContact(**kw, budget=1).pair_potential(r_all, w_q,
                                                                      s_grid=rc.points))
    assert v_d > 0.0
    np.testing.assert_allclose(v_b, v_d, rtol=1e-10)


def test_friction_force_antisymmetric_and_dissipative():
    """tests/test_dynamics.py:670-695: the pairwise Coulomb field sums to
    zero (antisymmetric under partner exchange), does negative power, is
    zero at mu = 0 and batches; reordering the rods permutes it."""
    rng = np.random.default_rng(3)
    r_all = torch.tensor(rng.normal(size=(3, 7, 3)) * 0.05)
    v_all = torch.tensor(rng.normal(size=(3, 7, 3)))
    w_q = torch.tensor(rng.uniform(0.1, 1.0, size=7))
    s_grid = torch.linspace(0.0, 1.0, 7, dtype=F64)
    kw = dict(radius=0.06, stiffness=1e3, smoothing=2e-3, self_window=0.3)
    rr = dynamics.RodRodContact(friction=0.7, **kw)
    f = rr.friction_force(r_all, v_all, w_q, s_grid=s_grid)
    assert float(f.sum(dim=(0, 1)).abs().max()) < 1e-12
    assert float(torch.sum(f * v_all)) < 0.0
    assert float(dynamics.RodRodContact(friction=0.0, **kw).friction_force(
        r_all, v_all, w_q, s_grid=s_grid).abs().max()) == 0.0
    fb = rr.friction_force(torch.stack([r_all, r_all * 1.1]), torch.stack([v_all, -v_all]), w_q,
                           s_grid=s_grid)
    torch.testing.assert_close(fb[0], f, rtol=1e-12, atol=0)
    perm = [2, 0, 1]
    torch.testing.assert_close(rr.friction_force(r_all[perm], v_all[perm], w_q, s_grid=s_grid),
                               f[perm], rtol=1e-12, atol=1e-15)


def test_scene_statics_rod_on_rod_and_its_spectrum():
    """tests/test_dynamics.py:730-758 and :816-827: the coupled Newton
    separates two cantilevers clamped 0.08 apart (tip separation in (0.11,
    0.15), JAX measured 0.1297), the solution is a rest point of
    scene_accelerations (|qdd| < 1e-7), and the coupled (2 nq) spectrum
    there is all positive."""
    scfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=12, ne=3))
    rr = dynamics.RodRodContact(radius=0.05, stiffness=2e3, smoothing=2e-3)
    bases = np.array([[0.0, 0.0, 0.0], [0.0, 0.08, 0.0]])
    cfg = dynamics.DynamicsConfig(statics=scfg, rho_a=1.0, rho_i=1e-2)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros((2, 9), dtype=F64), rr=rr,
                                         base_positions=bases, tol=1e-10, max_iter=60)
    assert bool(sol.converged), float(sol.residual_norm)
    assert sol.qe.shape == (2, 9)
    r_all = rod.rod_shape(sol.qe, cfg=scfg.rod, method="picard", iters=24).positions
    r_all = r_all + torch.tensor(bases)[:, None, :]
    tip_sep = float(torch.linalg.vector_norm(r_all[0, 0] - r_all[1, 0]))
    assert 0.11 < tip_sep < 0.15, tip_sep
    qdd = dynamics.scene_accelerations(sol.qe, torch.zeros_like(sol.qe), cfg, rr, bases)
    assert float(qdd.abs().max()) < 1e-7
    om2 = dynamics.linearized_spectrum(cfg, qe=sol.qe, rr=rr, base_positions=bases)
    assert om2.shape == (18,) and om2[0] > 0, om2[0]


def test_broadphase_scene_conserves_energy():
    """tests/test_broadphase.py:133-151 at R=8: a scene on the broad phase
    (budget 3, no overflow) integrates with its energy within 5e-4; its
    accelerations agree with all pairs' there to the force tolerance of
    tests/test_broadphase.py:72-73 (every near pair gathered)."""
    nr = 8
    cfg = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=8, ne=2)),
                                  rho_i=1e-2)
    kw = dict(radius=0.08, stiffness=100.0, smoothing=5e-3)
    rr = dynamics.RodRodContact(**kw, budget=3)
    qe0 = torch.tensor(0.2 * np.random.default_rng(5).standard_normal((nr, 6)))
    base = torch.zeros((nr, 3), dtype=F64)
    base[:, 1] = 0.12 * torch.arange(nr, dtype=F64)
    r_all = dynamics._scene_positions(qe0, cfg, base, 16)
    assert not bool(rr.broadphase_overflow(r_all))
    assert float(dynamics.RodRodContact(**kw).pair_potential(r_all, cfg.quad_weights_full)) > 0
    qd0 = torch.zeros_like(qe0)
    torch.testing.assert_close(
        dynamics.scene_accelerations(qe0, qd0, cfg, rr, base),
        dynamics.scene_accelerations(qe0, qd0, cfg, dynamics.RodRodContact(**kw), base),
        rtol=1e-8, atol=1e-12)
    traj = dynamics.simulate_scene(qe0, qd0, cfg, rr, base, dt=0.004, steps=6)
    assert traj.qes.shape == (6, nr, 6) and traj.energies.shape == (6,)
    assert bool(torch.isfinite(traj.qes[-1]).all())
    e = traj.energies.numpy()
    assert abs(e[-1] - e[0]) < 5e-4 * max(abs(e[0]), 1.0)
