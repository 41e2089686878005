"""Port parity: the single-rod dynamics layer (models/dynamics.py).

The same numpy ``default_rng`` inputs go through the JAX package's
``_mass_and_rhs`` (every load branch in one configuration, plus the
follower form under ``static_only``) and ``kinetic_energy``, compiled as
one ``jax.jit``, and through the port, within ``1e-10 max(1, |rhs|)``.
The fused mass lane (K1 + K2; their plain versions here) is held to the
gates of ``tests/test_mass_fused.py``, the contact Newton to the floor drape
of ``tests/test_dynamics.py:627-651``.  No JAX ``simulate`` or
``solve_contact_statics`` runs here: each costs 10-14 s to compile.
"""

import numpy as np
import pytest
import torch
import jax

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    cosserat as jcos,
    dynamics as jdyn,
    magnetics as jmag,
    rod as jrod,
    segment_statics as jss,
    segments as jseg,
    tendon as jten,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    dynamics,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

B = 4


def _taper(xs):
    return 1.0 - 0.5 * xs


def _every_branch(follower=False):
    """One JAX configuration with every load branch of ``_mass_and_rhs``."""
    return jdyn.DynamicsConfig(
        statics=jcos.StaticsConfig(rod=jrod.RodConfig(n=16), stiffness=(1.0, 2.0, 1.5),
                                   follower=follower),
        rho_a=1.0, rho_i=1e-2, kv_damping=0.01, gravity=(0.0, 0.0, -2.0),
        contact=(jdyn.ContactPlane(normal=(0.0, 0.0, 1.0), offset=-0.1, stiffness=1e3,
                                   damping=2.0, smoothing=1e-2, friction=0.5, friction_vel=0.1),
                 jdyn.ContactSphere(center=(0.6, 0.0, 0.3), radius=0.3, stiffness=1e3,
                                    smoothing=1e-2),
                 jdyn.ContactCylinder(point=(0.5, 0.0, -0.4), axis=(0.0, 1.0, 0.2), radius=0.3,
                                      stiffness=1e3, smoothing=1e-2, damping=1.0)),
        tendons=(jten.Tendon(offset=(0.0, 0.0, 0.05)), jten.Tendon(helix=(0.04, 1.0, 0.3)),
                 jten.Tendon(offset=(0.0, 0.03, 0.0), profile=_taper),
                 jten.Tendon(offset=(0.0, 0.0, -0.05), capstan=0.7)),
        magnets=(jmag.Magnet(moment=(0.4, 0.0, 0.1)),), fluid_drag=(0.3, 0.6))


JCFG, JCFG_FOLLOWER = _every_branch(), _every_branch(follower=True)


def _inputs():
    rng = np.random.default_rng(0)
    return dict(qe=0.4 * rng.standard_normal((B, 9)), qd=rng.standard_normal((B, 9)),
                tip_force=0.3 * rng.standard_normal((B, 3)),
                tip_moment=0.2 * rng.standard_normal((B, 3)), extra_accel=rng.standard_normal(3),
                tension=rng.uniform(0.0, 2.0, (B, 4)), b0=0.3 * rng.standard_normal(3),
                grad=0.2 * rng.standard_normal((3, 3)))


@jax.jit
def _jax_reference(x):
    m, rhs = jdyn._mass_and_rhs(x["qe"], x["qd"], JCFG, x["tip_force"], 16, x["tip_moment"],
                                x["extra_accel"], x["tension"], (x["b0"], x["grad"]))
    _, rhs_static = jdyn._mass_and_rhs(x["qe"], x["qd"], JCFG_FOLLOWER, x["tip_force"], 16,
                                       x["tip_moment"], tension=x["tension"],
                                       b_field=x["b0"], static_only=True)
    return dict(m=m, rhs=rhs, rhs_static=rhs_static,
                ke=jdyn.kinetic_energy(x["qe"], x["qd"], JCFG, 16),
                pe=jdyn.potential_energy(x["qe"], JCFG, x["tension"], (x["b0"], x["grad"])),
                drag=jdyn.fluid_damping_matrix(x["qe"], JCFG, 16))


@pytest.fixture(scope="module")
def jax_ref():
    return {k: np.asarray(v) for k, v in _jax_reference(_inputs()).items()}


def _close(mine, theirs, what):
    """Within ``1e-10 max(1, |ref|)``: f64 parity through the same formulas."""
    err = float(np.abs(mine.detach().numpy() - theirs).max())
    assert err < 1e-10 * max(1.0, float(np.abs(theirs).max())), (what, err)


def test_mass_and_rhs_every_branch_matches_jax(jax_ref):
    """Inertia (mass matrix, Coriolis/centrifugal), Kelvin-Voigt damping,
    gravity plus ``extra_accel``, tip force and moment, four tendons
    (constant, helix, profile, capstan), a magnet in a ``(B0, G)`` field,
    fluid drag and three obstacles with dashpots and friction; then the
    follower form with ``static_only``; ``kinetic_energy``,
    ``potential_energy`` (tendons, magnets, gravity, obstacles) and
    ``fluid_damping_matrix``."""
    x = {k: torch.tensor(v) for k, v in _inputs().items()}
    cfg = convert.dynamics_config_from_jax(JCFG)
    m, rhs = dynamics._mass_and_rhs(x["qe"], x["qd"], cfg, x["tip_force"], 16, x["tip_moment"],
                                    x["extra_accel"], x["tension"], (x["b0"], x["grad"]))
    _close(m, jax_ref["m"], "mass matrix")
    _close(rhs, jax_ref["rhs"], "rhs")
    none, rhs_static = dynamics._mass_and_rhs(
        x["qe"], x["qd"], convert.dynamics_config_from_jax(JCFG_FOLLOWER), x["tip_force"], 16,
        x["tip_moment"], tension=x["tension"], b_field=x["b0"], static_only=True)
    assert none is None
    _close(rhs_static, jax_ref["rhs_static"], "static follower rhs")
    ke = dynamics.kinetic_energy(x["qe"], x["qd"], cfg)
    _close(ke, jax_ref["ke"], "kinetic energy")
    torch.testing.assert_close(ke, 0.5 * torch.einsum("bi,bij,bj->b", x["qd"], m, x["qd"]),
                               rtol=1e-12, atol=0)
    _close(dynamics.potential_energy(x["qe"], cfg, x["tension"], (x["b0"], x["grad"])),
           jax_ref["pe"], "potential energy")
    _close(dynamics.fluid_damping_matrix(x["qe"], cfg), jax_ref["drag"], "fluid damping matrix")


def _mass_cfg(na=3, ne=3):
    return dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16, na=na, ne=ne)), rho_a=1.0,
        rho_i=1e-2)


def _rel_gap(m_f, m_ref):
    return torch.linalg.matrix_norm(m_f - m_ref) / torch.linalg.matrix_norm(m_ref)


def test_mass_matrix_fused_matches_mass_matrix():
    """tests/test_mass_fused.py:22-51: relative Frobenius gap < 2e-3, symmetric
    to 1e-6, positive definite (na=3); < 3e-3 for na=6 (ne=2)."""
    cfg = _mass_cfg()
    qe = torch.tensor(0.5 * np.random.default_rng(3).standard_normal((8, 9)))
    m_f = dynamics.mass_matrix_fused(qe, cfg, iters=20)
    assert m_f.dtype == torch.float64
    assert float(_rel_gap(m_f, dynamics.mass_matrix(qe, cfg, iters=20)).max()) < 2e-3
    assert float((m_f - m_f.transpose(-1, -2)).abs().max()) < 1e-6
    assert float(torch.linalg.eigvalsh(m_f).min()) > 0.0
    rng = np.random.default_rng(4)
    qe6 = torch.tensor(np.concatenate([0.4 * rng.standard_normal((4, 6)),
                                       0.1 * rng.standard_normal((4, 6))], axis=1))
    cfg6 = _mass_cfg(na=6, ne=2)
    m6 = dynamics.mass_matrix(qe6, cfg6, iters=20)
    gap = torch.linalg.vector_norm(dynamics.mass_matrix_fused(qe6, cfg6, iters=20) - m6)
    assert float(gap / torch.linalg.vector_norm(m6)) < 3e-3


def test_simulate_fused_tier_matches_default():
    """tests/test_mass_fused.py:55-68: 12 steps, atol 5e-4 on qes, 5e-3 on
    qds."""
    cfg = _mass_cfg()
    qe0 = torch.zeros((B, 9), dtype=torch.float64)
    qe0[:, 4] = 0.25
    qe0[1, 2] = 0.1
    kw = dict(dt=0.004, steps=12, iters=14, record_energy=False)
    ref = dynamics.simulate(qe0, torch.zeros_like(qe0), cfg, **kw)
    fus = dynamics.simulate(qe0, torch.zeros_like(qe0), cfg, mass_tier="fused", **kw)
    assert fus.qes.shape == (12, B, 9) and torch.isfinite(fus.qes).all()
    assert float(ref.qes[-1, :, 4].abs().max()) < 0.25        # the rod moved
    np.testing.assert_allclose(fus.qes.numpy(), ref.qes.numpy(), atol=5e-4)
    np.testing.assert_allclose(fus.qds.numpy(), ref.qds.numpy(), atol=5e-3)


def test_simulate_drives_and_energy_record():
    """Callable drives are called with the stage time: constants given as
    callables give the same trajectory; ``record_energy`` records
    ``total_energy`` at each step's state and time."""
    cfg = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=10)),
                                  rho_i=1e-2, gravity=(0.0, 0.0, -1.0))
    qe0 = torch.tensor(0.2 * np.random.default_rng(5).standard_normal((1, 9)))
    force, accel = torch.tensor([0.0, 0.1, -0.2]), torch.tensor([0.3, 0.0, 0.0])
    kw = dict(dt=0.01, steps=2, iters=12)
    seen = []
    traj = dynamics.simulate(qe0, torch.zeros_like(qe0), cfg,
                             tip_force=lambda t: seen.append(float(t)) or force,
                             base_accel=lambda t: accel, **kw)
    const = dynamics.simulate(qe0, torch.zeros_like(qe0), cfg, tip_force=force,
                              base_accel=accel, **kw)
    assert seen == pytest.approx([0.0, 0.005, 0.005, 0.01, 0.01, 0.015, 0.015, 0.02])
    torch.testing.assert_close(traj.qes, const.qes, rtol=0, atol=0)
    torch.testing.assert_close(traj.times, torch.tensor([0.01, 0.02], dtype=torch.float64))
    torch.testing.assert_close(traj.energies[-1], dynamics.total_energy(
        traj.qes[-1], traj.qds[-1], cfg, 12), rtol=1e-14, atol=0)


def test_floor_drape_converges_with_line_search():
    """tests/test_dynamics.py:627-651: the rod rests on the floor plane within
    the penalty compliance (measured -0.2596 in JAX), from a cold start
    that needs the line search."""
    cfg = dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=12, ne=3)), rho_a=1.0, rho_i=1e-2,
        gravity=(0.0, 0.0, -8.0),
        contact=dynamics.ContactPlane(normal=(0.0, 0.0, 1.0), offset=-0.25, stiffness=1e4,
                                      smoothing=1e-3))
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(9, dtype=torch.float64),
                                         tol=1e-8, max_iter=60)
    assert bool(sol.converged), float(sol.residual_norm)
    r = rod.rod_shape(sol.qe, cfg=cfg.rod, method="picard", iters=30).positions
    assert -0.27 < float(r[..., 2].min()) < -0.20


def test_config_round_trip_and_unported_paths_raise():
    """``dynamics_config_from_jax`` carries every field and the host tables
    agree, for the single-rod config, a ``SegmentedDynamicsConfig`` with
    tendons (mirrored from its statics config) and a ``RodRodContact``; the
    segmented config has no single rod, as in the JAX package."""
    cfg = convert.dynamics_config_from_jax(JCFG)
    assert cfg.contact[2] == dynamics.ContactCylinder(
        point=(0.5, 0.0, -0.4), axis=(0.0, 1.0, 0.2), radius=0.3, stiffness=1e3, smoothing=1e-2,
        damping=1.0)
    assert (cfg.rho_a, cfg.rho_i, cfg.kv_damping, cfg.gravity, cfg.fluid_drag) == (
        1.0, 1e-2, 0.01, (0.0, 0.0, -2.0), (0.3, 0.6))
    assert cfg.tendons[3].capstan == 0.7 and cfg.tendons[2].profile is _taper
    assert cfg == convert.dynamics_config_from_jax(JCFG) and hash(cfg) == hash(
        convert.dynamics_config_from_jax(JCFG))
    for mine, theirs in ((cfg.k_ee, JCFG.k_ee), (cfg.magnet_table, JCFG.magnet_table),
                         (cfg.quad_weights_full, JCFG.quad_weights_full),
                         (cfg.kappa0_modes, JCFG.kappa0_modes)):
        np.testing.assert_array_equal(mine, theirs)
    jseg_cfg = jdyn.SegmentedDynamicsConfig(
        statics=jss.SegmentedStaticsConfig(
            rods=jseg.uniform_segments(2, n=8), stiffness=((1.0, 2.0, 1.5), (1.0, 1.0, 1.0)),
            tendons=(jten.Tendon(offset=(0.0, 0.0, 0.05)), jten.Tendon(helix=(0.04, 1.0, 0.3))),
            tendon_end=(0, 1)),
        rho_i=1e-2, damping=0.1, gravity=(0.0, 0.0, -1.0))
    seg = convert.dynamics_config_from_jax(jseg_cfg)
    assert type(seg) is dynamics.SegmentedDynamicsConfig and seg.nq == jseg_cfg.nq == 18
    assert seg.tendons == seg.statics.tendons and len(seg.tendons) == 2
    assert seg.statics.tendon_last_segment == (0, 1)
    assert (seg.rho_i, seg.damping, seg.gravity) == (1e-2, 0.1, (0.0, 0.0, -1.0))
    for mine, theirs in ((seg.k_ee, jseg_cfg.k_ee), (seg.quad_weights_full,
                                                     jseg_cfg.quad_weights_full),
                         (seg.points_full, jseg_cfg.points_full),
                         (seg.kappa0_modes, jseg_cfg.kappa0_modes)):
        np.testing.assert_array_equal(mine, theirs)
    with pytest.raises(AttributeError, match="no single rod"):
        seg.rod
    jrr = jdyn.RodRodContact(radius=0.06, stiffness=30.0, smoothing=5e-3, self_window=0.3,
                             friction=0.4, friction_vel=0.01, budget=3)
    assert convert.rod_rod_contact_from_jax(jrr) == dynamics.RodRodContact(
        radius=0.06, stiffness=30.0, smoothing=5e-3, self_window=0.3, friction=0.4,
        friction_vel=0.01, budget=3)
    assert convert.rod_rod_contact_from_jax(jdyn.RodRodContact()) == dynamics.RodRodContact()
    with pytest.raises(ValueError, match="explicit qe0"):
        dynamics.solve_contact_statics(cfg, rr=dynamics.RodRodContact())


def test_mass_matrix_fused_is_forward_only():
    """The fused lane refuses a gradient (K1/K2 have no derivative) under
    autograd and torch.func, and a config other than the single-rod one."""
    cfg = _mass_cfg()
    qe = torch.zeros((2, 9), dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        dynamics.mass_matrix_fused(qe, cfg)
    with pytest.raises(RuntimeError, match="forward-only"):
        torch.func.jacfwd(lambda q: dynamics.mass_matrix_fused(q, cfg))(qe.detach())
    with pytest.raises(RuntimeError, match="forward-only"):
        dynamics.accelerations(qe, torch.zeros_like(qe), cfg, mass_tier="fused")
    with torch.no_grad():
        assert torch.isfinite(dynamics.mass_matrix_fused(qe, cfg)).all()

    class Other(dynamics.DynamicsConfig):
        pass

    with pytest.raises(ValueError, match="single-rod"):
        dynamics.mass_matrix_fused(qe.detach(), Other(statics=cfg.statics))
