"""Port parity: tip-constrained rods and parallel continuum robots
(models/constrained.py).

JAX's residuals (the tip-constrained KKT residual, taken from JAX's
``solve_tip_constrained`` with its Newton replaced by a stub that hands the
residual back, and ``_platform_system``'s) and their forward-mode Jacobians
are compiled as one ``jax.jit``: JAX's own Newton and stability reduction
take ~22 s to compile on a CPU, these ~7 s.  At the same numpy ``default_rng``
points the port's residuals agree within 1e-10; JAX's roots (a host Newton
on JAX's residual and Jacobian to 1e-11, batched) and the port's solutions
(tol 1e-11) within 1e-8; and the platform's ``eig_max`` within 1e-8 of
JAX's reduction (``constrained.py:436-446``: null basis of the constraint
block by a full SVD, ``eigvalsh`` of the symmetrized reduced Jacobian) of
JAX's Jacobian at JAX's root.  The port is also held to
``tests/test_constrained.py``'s closed forms.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    constrained as jcon,
    cosserat as jcos,
    dynamics as jdyn,
    rod as jrod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    constrained,
    cosserat,
    dynamics,
    rod,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

S = float(np.sqrt(2) / 2)
QV = (S, 0.0, -S, 0.0)                   # local e1 -> world e3: legs point up


def _jcfg(n=16, ne=5, na=3, stiffness=(1.0, 1.0, 1.0), **kw):
    return jdyn.DynamicsConfig(
        statics=jcos.StaticsConfig(rod=jrod.RodConfig(n=n, ne=ne, na=na), stiffness=stiffness),
        **kw)


def _cfg(n=16, ne=5, na=3, stiffness=(1.0, 1.0, 1.0), **kw):
    return dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=n, ne=ne, na=na),
                                       stiffness=stiffness), **kw)


def _tripod(radius=0.3):
    return tuple((radius * np.cos(a), radius * np.sin(a), 0.0)
                 for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3))


# a gravity-loaded rod with its tip welded onto displaced targets (roller
# axes 1, 2 and the tip frame): the batched large-deflection case
TIP_CFG = _jcfg(n=12, ne=4, gravity=(0.0, 0.0, -0.3))
TIP_TARGETS = np.array([[0.95, 0.05, 0.10], [0.97, -0.05, 0.05]])
TIP_QUAT = np.array([0.999, 0.0, -0.04, 0.01])
# tests/test_constrained.py:106-116: the three-leg vertical PCR (na = 6)
ROBOT = jcon.PlatformRobot(
    cfg=_jcfg(n=8, ne=2, na=6, stiffness=(1.0, 1.0, 1.0, 100.0, 50.0, 50.0)),
    base_positions=_tripod(), base_quaternions=(QV,) * 3, attach_points=_tripod())


def _wrench():
    rng = np.random.default_rng(0)
    return 0.1 * rng.standard_normal((2, 3)), 0.02 * rng.standard_normal((2, 3))


def _jax_tip_residual():
    """JAX's KKT residual closure and start, from its solve_tip_constrained
    with dynamics.damped_newton stubbed out."""
    got = {}

    def stub(residual, z0, **_):
        got.update(residual=residual, z0=z0)
        return z0, jnp.zeros((), jnp.int32), jnp.zeros_like(z0)

    original = jdyn.damped_newton
    jdyn.damped_newton = stub
    try:
        jcon.solve_tip_constrained(TIP_CFG, tip_position=jnp.asarray(TIP_TARGETS),
                                   tip_axes=(1, 2), tip_quaternion=jnp.asarray(TIP_QUAT))
    finally:
        jdyn.damped_newton = original
    return got["residual"], np.asarray(got["z0"])


JAX_TIP_RES, TIP_Z0 = _jax_tip_residual()
JAX_PLATFORM_RES, JAX_UNPACK, PLATFORM_Z0, _ = jcon._platform_system(
    ROBOT, jnp.asarray(_wrench()[0]), jnp.asarray(_wrench()[1]), None, None, None, 16)


def _columns(f, z):
    eye = jnp.eye(z.shape[-1], dtype=z.dtype)
    cols = jax.vmap(lambda e: jax.jvp(f, (z,), (jnp.broadcast_to(e, z.shape),))[1])(eye)
    return jnp.moveaxis(cols, 0, -1)


@jax.jit
def _jax_reference(z_tip, z_plat):
    return (JAX_TIP_RES(z_tip), _columns(JAX_TIP_RES, z_tip),
            JAX_PLATFORM_RES(z_plat), _columns(JAX_PLATFORM_RES, z_plat))


def _jax_roots(tol=1e-11, max_iter=30):
    """Batched host Newton on JAX's residuals and Jacobians, each sample to
    ``tol``; returns both roots and JAX's platform Jacobian at its root."""
    zt, zp = TIP_Z0.copy(), np.asarray(PLATFORM_Z0).copy()
    for _ in range(max_iter):
        rt, jt, rp, jp = (np.asarray(a) for a in _jax_reference(jnp.asarray(zt),
                                                                 jnp.asarray(zp)))
        if max(np.linalg.norm(rt, axis=-1).max(), np.linalg.norm(rp, axis=-1).max()) <= tol:
            return zt, zp, jp
        zt = zt - np.linalg.solve(jt, rt[..., None])[..., 0]
        zp = zp - np.linalg.solve(jp, rp[..., None])[..., 0]
    raise AssertionError("the host Newton on JAX's residuals did not converge")


def _eig_max(jac, r_legs, nq):
    """JAX's reduction (constrained.py:436-446) in NumPy f64."""
    m = jac.shape[-1]
    prim = np.concatenate([np.arange(r_legs * nq), np.arange(m - 6, m)])
    cons = np.arange(r_legs * nq, r_legs * nq + 6 * r_legs)
    a_blk = jac[..., prim[:, None], prim[None, :]]
    c_blk = jac[..., cons[:, None], prim[None, :]]
    z_basis = np.linalg.svd(c_blk, full_matrices=True)[2][..., 6 * r_legs:, :]
    red = np.einsum("...ip,...pq,...jq->...ij", z_basis, a_blk, z_basis)
    return np.linalg.eigvalsh(0.5 * (red + np.swapaxes(red, -1, -2)))[..., -1]


@pytest.fixture(scope="module")
def jax_ref():
    rng = np.random.default_rng(1)
    z_tip = TIP_Z0 + 0.05 * rng.standard_normal(TIP_Z0.shape)
    z_plat = np.asarray(PLATFORM_Z0) + 0.02 * rng.standard_normal(PLATFORM_Z0.shape)
    rt, _, rp, _ = (np.asarray(a) for a in _jax_reference(jnp.asarray(z_tip),
                                                          jnp.asarray(z_plat)))
    root_t, root_p, jac_p = _jax_roots()
    platform = jcon._platform_solution(ROBOT, jnp.asarray(root_p), jnp.zeros((), jnp.int32),
                                       jnp.zeros(root_p.shape), JAX_UNPACK, 1e-11, 16)
    return dict(z_tip=z_tip, z_plat=z_plat, res_tip=rt, res_plat=rp, root_tip=root_t,
                platform={k: np.asarray(getattr(platform, k)) for k in PLATFORM_FIELDS},
                eig_max=_eig_max(jac_p, 3, ROBOT.cfg.nq))


PLATFORM_FIELDS = ("qe", "platform_position", "platform_quaternion", "reaction_force",
                   "reaction_moment")


def _t(a):
    return torch.tensor(np.asarray(a))


def _port_tip_system():
    return constrained._tip_system(
        convert.dynamics_config_from_jax(TIP_CFG), _t(TIP_TARGETS), _t(TIP_QUAT), (1, 2), None,
        None, None, None, None, 16)


def _port_robot():
    return convert.platform_robot_from_jax(ROBOT)


def test_residual_maps_match_jax(jax_ref):
    """The tip-constrained KKT residual and the platform residual (balances,
    grip constraints, platform equilibrium) within 1e-10 of JAX's at the
    same points; the same starts."""
    residual, z0, _, _ = _port_tip_system()
    np.testing.assert_array_equal(z0.numpy(), TIP_Z0)
    err = np.abs(residual(_t(jax_ref["z_tip"])).numpy() - jax_ref["res_tip"]).max()
    assert err < 1e-10, err
    f, m = _wrench()
    residual, _, z0, _ = constrained._platform_system(_port_robot(), _t(f), _t(m), None, None,
                                                      None, 16)
    np.testing.assert_array_equal(z0.numpy(), np.asarray(PLATFORM_Z0))
    err = np.abs(residual(_t(jax_ref["z_plat"])).numpy() - jax_ref["res_plat"]).max()
    assert err < 1e-10, err


def test_solutions_and_platform_stability_match_jax(jax_ref):
    """solve_tip_constrained and platform_stability (its solve_platform),
    batched, to tol 1e-11: the solutions (strains, multipliers, platform
    pose, world-frame reactions) within 1e-8 of JAX's roots and eig_max
    within 1e-8 of JAX's reduction."""
    cfg = convert.dynamics_config_from_jax(TIP_CFG)
    sol = constrained.solve_tip_constrained(cfg, tip_position=_t(TIP_TARGETS), tip_axes=(1, 2),
                                            tip_quaternion=_t(TIP_QUAT), tol=1e-11)
    assert bool(sol.converged.all())
    z = torch.cat([sol.qe, sol.reaction_force[..., 1:], sol.reaction_moment], dim=-1)
    assert np.abs(z.numpy() - jax_ref["root_tip"]).max() < 1e-8
    f, m = _wrench()
    st = constrained.platform_stability(_port_robot(), platform_force=_t(f),
                                        platform_moment=_t(m), tol=1e-11)
    assert bool(st.solution.converged.all())
    for name in PLATFORM_FIELDS:
        err = np.abs(getattr(st.solution, name).numpy() - jax_ref["platform"][name]).max()
        assert err < 1e-8, (name, err)
    assert np.abs(st.eig_max.numpy() - jax_ref["eig_max"]).max() < 1e-8
    assert bool(st.stable.all())


def test_tip_closed_forms_propped_and_fixed_fixed():
    """tests/test_constrained.py:27-64: a uniformly loaded cantilever
    propped at the tip reacts 3qL/8 (and releasing the prop under that
    force as a tip load gives the same equilibrium); welded, qL/2 and
    qL^2/12."""
    g = 1e-4
    cfg = _cfg(gravity=(0.0, 0.0, -g))
    tip = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    sol = constrained.solve_tip_constrained(cfg, tip_position=tip, tip_axes=(1, 2), tol=1e-13)
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.reaction_force[2]), 3.0 * g / 8.0, rtol=1e-6)
    assert abs(float(sol.reaction_force[1])) < 1e-12
    free = dynamics.solve_contact_statics(cfg, tip_force=sol.reaction_force, tol=1e-13)
    np.testing.assert_allclose(free.qe.numpy(), sol.qe.numpy(), atol=1e-11)
    sol = constrained.solve_tip_constrained(
        cfg, tip_position=tip, tip_axes=(1, 2),
        tip_quaternion=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64), tol=1e-13)
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.reaction_force[2]), g / 2.0, rtol=1e-6)
    np.testing.assert_allclose(float(sol.reaction_moment[1]), g / 12.0, rtol=1e-6)
    # the dtype rule: f64 whatever the inputs' dtype, on their device
    sol32 = constrained.solve_tip_constrained(cfg, tip_position=tip.float(), tip_axes=(1, 2),
                                              max_iter=1)
    assert sol32.qe.dtype == torch.float64 and sol32.qe.device.type == "cpu"


def test_platform_uniform_compression_and_portal_sway():
    """tests/test_constrained.py:136-158: three vertical legs under F sink
    by F L / (3 EA), each carrying F/3; tests/test_constrained.py:195-225:
    a two-leg portal swaying H L^3/(24 EI) + H L/(2 GA) with the axial
    couple H L/d."""
    ea, fz = 100.0, 0.6
    robot = constrained.PlatformRobot(
        cfg=_cfg(n=12, ne=3, na=6, stiffness=(1.0, 1.0, 1.0, ea, 50.0, 50.0)),
        base_positions=_tripod(), base_quaternions=(QV,) * 3, attach_points=_tripod())
    sol = constrained.solve_platform(
        robot, platform_force=torch.tensor([0.0, 0.0, -fz], dtype=torch.float64), tol=1e-11)
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.platform_position[2]), 1.0 - fz / (3.0 * ea),
                               atol=1e-10)
    np.testing.assert_allclose(sol.platform_position[:2].numpy(), 0.0, atol=1e-10)
    np.testing.assert_allclose(sol.platform_quaternion.numpy(), [1.0, 0.0, 0.0, 0.0],
                               atol=1e-10)
    np.testing.assert_allclose(sol.reaction_force[:, 2].numpy(), -fz / 3.0, atol=1e-10)
    np.testing.assert_allclose(sol.reaction_force[:, :2].numpy(), 0.0, atol=1e-10)

    ei, ga, d_sep, h_load = 1.0, 5e3, 0.5, 1e-4
    bases = ((-d_sep / 2, 0.0, 0.0), (d_sep / 2, 0.0, 0.0))
    portal = constrained.PlatformRobot(
        cfg=_cfg(n=14, ne=5, na=6, stiffness=(1.0, ei, ei, 1e6, ga, ga)),
        base_positions=bases, base_quaternions=(QV,) * 2, attach_points=bases)
    sol = constrained.solve_platform(
        portal, platform_force=torch.tensor([h_load, 0.0, 0.0], dtype=torch.float64),
        tol=1e-13)
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.platform_position[0]),
                               h_load / (24.0 * ei) + h_load / (2.0 * ga), rtol=1e-3)
    fz_legs = sol.reaction_force[:, 2].numpy()
    np.testing.assert_allclose(abs(fz_legs[1] - fz_legs[0]), h_load / d_sep, rtol=1e-3)
    np.testing.assert_allclose(fz_legs.sum(), 0.0, atol=1e-10)


def test_platform_euler_column_critical_load():
    """tests/test_constrained.py:228-248: one vertical leg under a dead
    axial platform load is stable at half the Euler load and buckles at
    pi^2 EI / 4 L^2 (10 bisection steps, rtol 1e-2)."""
    robot = constrained.PlatformRobot(
        cfg=_cfg(n=12, ne=4, na=6, stiffness=(1.0, 1.0, 1.0, 1e4, 1e3, 1e3)),
        base_positions=((0.0, 0.0, 0.0),), base_quaternions=(QV,),
        attach_points=((0.0, 0.0, 0.0),))
    euler = np.pi ** 2 / 4.0
    st = constrained.platform_stability(
        robot, platform_force=torch.tensor([0.0, 0.0, -0.5 * euler], dtype=torch.float64))
    assert bool(st.solution.converged) and bool(st.stable)
    lam = constrained.platform_critical_load(robot, unit_force=(0.0, 0.0, -1.0), lam_lo=1.5,
                                             lam_hi=3.5, bisect_steps=10, tol=1e-9,
                                             device="cpu")
    np.testing.assert_allclose(lam, euler, rtol=1e-2)


def test_platform_ik_recovers_forward_pose():
    """tests/test_constrained.py:281-300: tensions solved forward, then the
    platform position recovered by platform_ik (6 Gauss-Newton steps, the
    JAX test's 8 cut for time) to a pose error below 1e-6, every tension
    >= 0."""
    bases = _tripod(0.25)
    robot = constrained.PlatformRobot(
        cfg=_cfg(n=8, ne=2, na=6, stiffness=(1.0, 1.0, 1.0, 100.0, 50.0, 50.0),
                 tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.04)),)),
        base_positions=bases, base_quaternions=(QV,) * 3, attach_points=bases)
    t_true = torch.tensor([[0.8], [0.2], [0.1]], dtype=torch.float64)
    fwd = constrained.solve_platform(robot, tension=t_true, tol=1e-11)
    assert bool(fwd.converged)
    ik = constrained.platform_ik(robot, target_position=fwd.platform_position, gn_steps=6,
                                 tol=1e-11)
    assert float(ik.pose_error) < 1e-6
    assert float(ik.tension.min()) >= 0.0
