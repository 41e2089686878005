"""Constrained-tip BVPs and platform-coupled parallel continuum robots.

Counterpart of the JAX package's ``models/constrained.py``.  A pose
constraint ``c(qe) = 0`` at the tip joins the static balance through its
multiplier: the stationarity of ``V(qe) + w . c(qe)`` is ``Q(qe) + (dc/dqe)^T
w = 0``, and for a position (orientation) constraint ``(dc/dqe)^T w`` is the
generalized force of a tip force (couple) ``w``.  So the constrained
residual is the existing balance of :func:`.dynamics._mass_and_rhs` at
``tip_force/tip_moment = applied + reaction``, stacked with ``c(qe)``, and
the multipliers are the physical reactions at the solution.

* :func:`solve_tip_constrained`: one rod, tip position and/or orientation
  prescribed; unknowns ``[qe, reaction]``, solved by
  :func:`.dynamics.damped_newton`.
* :class:`PlatformRobot` / :func:`solve_platform`: R legs with posed bases
  and a rigid platform gripping every tip; unknowns ``[qe_1..qe_R,
  wrench_1..wrench_R, platform pose]``; equations the per-leg balances (the
  R legs ride as a batch axis of one ``_mass_and_rhs`` call), 6R grip
  constraints and the platform's rigid-body equilibrium.
* :func:`platform_stability` (the energy Hessian reduced to the constraint
  tangent space: full SVD of the constraint block, ``eigvalsh`` of the
  reduced matrix), :func:`platform_critical_load` (host bisection, one host
  sync per step) and :func:`platform_ik` (Gauss-Newton on tendon tensions
  in a host loop, implicit-function sensitivities through the coupled KKT
  system).

Frames: each leg is solved in its own base frame.  Reaction forces are
carried in the LEG frame (the ``tip_force`` convention), reaction couples in
the TIP BODY frame (the ``tip_moment`` pairing); the platform equations
transport both to the world frame.

Everything runs in float64, as :func:`.dynamics.solve_contact_statics`
does, on the device of the first tensor argument (``device`` overrides it;
neither given: the card, ``ops/device.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.device import canonical_device
from . import cosserat
from . import dynamics as dyn

__all__ = [
    "TipConstrainedSolution",
    "solve_tip_constrained",
    "PlatformRobot",
    "PlatformSolution",
    "solve_platform",
    "PlatformStability",
    "platform_stability",
    "platform_critical_load",
    "PlatformIKSolution",
    "platform_ik",
]


def _device(device, *xs) -> torch.device:
    return canonical_device(device) if device is not None else dyn._device_of(*xs)


def _f64(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _quat_exp(phi):
    """Unit quaternion of a rotation vector ``phi (..., 3)``,
    ``(cos|phi|/2, sinc(|phi|/2) phi/2)``.  Smooth at ``phi = 0`` (every
    platform solve's initial point), where the norm's square root has no
    derivative: both branches get a safe input and the small-angle side
    uses the Taylor forms."""
    half = 0.5 * phi
    a2 = torch.sum(half * half, dim=-1)
    small = a2 < 1e-12
    a = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    w = torch.where(small, 1.0 - a2 / 2.0, torch.cos(a))
    s = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    return torch.cat([w[..., None], s[..., None] * half], dim=-1)


class TipConstrainedSolution(NamedTuple):
    qe: torch.Tensor               # (..., nq)
    reaction_force: torch.Tensor   # (..., 3) leg-frame force on the tip
    reaction_moment: torch.Tensor  # (..., 3) tip-body-frame couple (or 0)
    residual_norm: torch.Tensor    # (...,) full KKT residual norm
    iterations: torch.Tensor       # scalar
    converged: torch.Tensor        # (...,)


def _rot_error(q_tip, q_target):
    """Orientation-error chart ``2 vec(q_target^* x q_tip)``: zero iff the
    tip frame matches the target (up to the quaternion's sign)."""
    return 2.0 * lie.quat_multiply(lie.quat_conjugate(q_target),
                                   lie.quat_normalize(q_tip))[..., 1:]


def solve_tip_constrained(cfg: dyn.DynamicsConfig, tip_position=None, tip_quaternion=None,
                          tip_axes: tuple | None = None, qe0=None, w0=None, tip_force=None,
                          tip_moment=None, tension=None, tol: float = 1e-9, max_iter: int = 40,
                          iters: int = 16, line_search: bool = True,
                          device=None) -> TipConstrainedSolution:
    """Static equilibrium with the tip pose (partially) prescribed.

    ``tip_position (..., 3)`` pins the tip point (a reaction force unknown),
    ``tip_quaternion (..., 4)`` the tip frame (a reaction couple); both
    weld the tip.  ``tip_axes`` restricts the position constraint to some
    leg-frame axes (``(1, 2)``: a roller free to slide axially; the axial
    pin of a straight inextensible rod is singular).  ``tip_force``,
    ``tip_moment``, ``tension``, gravity and contacts are the applied loads;
    the reaction adds to them.  Batched over the leading axes of the
    targets and ``qe0``.  Newton on ``[Q(qe) + J^T w, c(qe)] = 0`` with the
    exact coupled Jacobian.
    """
    residual, z0, reactions, batch = _tip_system(
        cfg, tip_position, tip_quaternion, tip_axes, qe0, w0, tip_force, tip_moment, tension,
        iters, device)
    z, k, res = dyn.damped_newton(residual, z0, tol=tol, max_iter=max_iter,
                                  line_search=line_search)
    rn = torch.linalg.vector_norm(res, dim=-1)
    f, m = reactions(z[..., cfg.nq:])
    zero3 = torch.zeros(batch + (3,), dtype=torch.float64, device=z.device)
    return TipConstrainedSolution(
        qe=z[..., :cfg.nq], reaction_force=zero3 if f is None else f,
        reaction_moment=zero3 if m is None else m, residual_norm=rn, iterations=k,
        converged=rn <= tol)


def _tip_system(cfg: dyn.DynamicsConfig, tip_position, tip_quaternion, tip_axes, qe0, w0,
                tip_force, tip_moment, tension, iters, device=None):
    """``(residual, z0, reactions, batch)`` of :func:`solve_tip_constrained`:
    the KKT residual of ``z = [qe, w]``, the start, and ``w -> (leg-frame
    reaction force or None, tip-body couple or None)``."""
    if tip_position is None and tip_quaternion is None:
        raise ValueError("prescribe tip_position, tip_quaternion, or both")
    nq = cfg.nq
    dev = _device(device, tip_position, tip_quaternion, qe0, w0, tip_force, tip_moment,
                  tension)
    has_pos, has_rot = tip_position is not None, tip_quaternion is not None
    axes = tuple(int(a) for a in (tip_axes if tip_axes is not None else (0, 1, 2)))
    np_ax = len(axes) if has_pos else 0
    sel = np.zeros((3, max(np_ax, 1)))            # w_pos -> leg-frame reaction force
    for i, a in enumerate(axes[:np_ax]):
        sel[a, i] = 1.0
    sel_t = _f64(sel, dev)
    nc = np_ax + 3 * has_rot
    p_t = _f64(tip_position, dev) if has_pos else None
    q_t = _f64(tip_quaternion, dev) if has_rot else None
    batch = torch.broadcast_shapes(
        () if qe0 is None else tuple(np.shape(qe0))[:-1],
        () if not has_pos else p_t.shape[:-1], () if not has_rot else q_t.shape[:-1])
    qe0 = _f64(cfg.kappa0_modes if qe0 is None else qe0, dev)
    w0 = torch.zeros(batch + (nc,), dtype=torch.float64, device=dev) if w0 is None else w0
    z0 = torch.cat([qe0.expand(batch + (nq,)), _f64(w0, dev).expand(batch + (nc,))], dim=-1)
    add_f = None if tip_force is None else _f64(tip_force, dev)
    add_m = None if tip_moment is None else _f64(tip_moment, dev)
    tension = None if tension is None else _f64(tension, dev)

    def reactions(w):
        f = torch.einsum("ck,...k->...c", sel_t, w[..., :np_ax]) if has_pos else None
        return f, (w[..., np_ax:] if has_rot else None)

    def residual(z):
        qe, w = z[..., :nq], z[..., nq:]
        f, m = reactions(w)
        if add_f is not None:
            f = add_f if f is None else f + add_f
        if add_m is not None:
            m = add_m if m is None else m + add_m
        _, rhs = dyn._mass_and_rhs(qe, torch.zeros_like(qe), cfg, f, iters, m,
                                   tension=tension, static_only=True)
        r, q = cfg.state_full(qe, iters)
        cons = []
        if has_pos:
            cons.append(torch.einsum("ck,...c->...k", sel_t, r[..., 0, :] - p_t))
        if has_rot:
            cons.append(_rot_error(q[..., 0, :], q_t))
        return torch.cat([rhs.expand(z.shape[:-1] + (nq,))] + cons, dim=-1)

    return residual, z0, reactions, batch


@dataclass(frozen=True)
class PlatformRobot:
    """R flexible legs gripping one rigid platform (a parallel continuum
    robot in the Stewart-platform topology).

    All legs share ``cfg`` (extensible na = 6 legs recommended: an
    inextensible leg welded at both ends has a statically indeterminate
    axial force).  ``base_positions``/``base_quaternions`` pose each leg's
    clamped base in the world (local -> world); ``attach_points`` are the
    platform-frame grip offsets, ``attach_quaternions`` the platform ->
    tip-frame grip rotations (default: the base quaternions, so the
    straight-leg assembly at the identity platform pose is a zero-load
    equilibrium).  ``gravity`` (world) loads the legs (``cfg.gravity`` must
    then be None) and, with ``platform_mass``, the platform.
    """

    cfg: dyn.DynamicsConfig
    base_positions: tuple
    base_quaternions: tuple
    attach_points: tuple
    attach_quaternions: tuple | None = None
    gravity: tuple | None = None
    platform_mass: float = 0.0

    @functools.cached_property
    def num_legs(self) -> int:
        return len(self.base_positions)

    def _tables(self):
        """Host f64 constants: base poses, grips, per-leg local gravity."""
        r = self.num_legs
        pb = np.asarray(self.base_positions, np.float64)
        qb = np.asarray(self.base_quaternions, np.float64)
        qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
        att = np.asarray(self.attach_points, np.float64)
        if self.attach_quaternions is None:
            grip = qb.copy()
        else:
            grip = np.asarray(self.attach_quaternions, np.float64)
            grip = grip / np.linalg.norm(grip, axis=-1, keepdims=True)
        for name, arr, shape in (("base_positions", pb, (r, 3)),
                                 ("base_quaternions", qb, (r, 4)),
                                 ("attach_points", att, (r, 3)),
                                 ("attach_quaternions", grip, (r, 4))):
            if arr.shape != shape:
                raise ValueError(f"{name} has shape {arr.shape}, need {shape}")
        if self.gravity is not None and self.cfg.gravity is not None:
            raise ValueError("set gravity on the PlatformRobot (world frame), not on the "
                             "shared leg cfg")
        g_loc = None
        if self.gravity is not None:
            # world gravity in each leg's base frame: rotation by the conjugate
            g_w = np.asarray(self.gravity, np.float64)
            u, qw = -qb[:, 1:], qb[:, :1]
            g_loc = g_w + 2.0 * qw * np.cross(u, g_w) + 2.0 * np.cross(u, np.cross(u, g_w))
        return pb, qb, att, grip, g_loc


class PlatformSolution(NamedTuple):
    qe: torch.Tensor                   # (..., R, nq) per-leg strain modes
    platform_position: torch.Tensor    # (..., 3) world
    platform_quaternion: torch.Tensor  # (..., 4) world
    reaction_force: torch.Tensor       # (..., R, 3) world force platform -> tip
    reaction_moment: torch.Tensor      # (..., R, 3) world couple platform -> tip
    residual_norm: torch.Tensor        # (...,)
    iterations: torch.Tensor
    converged: torch.Tensor            # (...,)


def solve_platform(robot: PlatformRobot, platform_force=None, platform_moment=None,
                   tension=None, pose0=None, qe0=None, tol: float = 1e-9, max_iter: int = 60,
                   iters: int = 16, line_search: bool = True, device=None) -> PlatformSolution:
    """Coupled equilibrium of a parallel continuum robot.

    Unknowns ``z = [qe (R nq), wrench (6R), platform pose (6)]``, the pose
    as a world position and a world rotation vector about ``pose0``
    (default: the straight-leg assembly pose implied by leg 0's tip).
    Equations: the per-leg balances with the grip reactions (all legs in
    one ``_mass_and_rhs`` call), the 6R grip constraints, and the
    platform's force/moment balance under ``platform_force``/
    ``platform_moment`` (world, at the platform origin) and its weight.
    Batched over the leading axes of the wrench, ``pose0`` and ``qe0``.
    """
    residual, unpack, z0, _ = _platform_system(robot, platform_force, platform_moment, tension,
                                               pose0, qe0, iters, device)
    z, k, res = dyn.damped_newton(residual, z0, tol=tol, max_iter=max_iter,
                                  line_search=line_search)
    return _platform_solution(robot, z, k, res, unpack, tol, iters)


def _platform_solution(robot, z, k, res, unpack, tol, iters):
    qb = _f64(robot._tables()[1], z.device)
    rn = torch.linalg.vector_norm(res, dim=-1)
    qe, w, p, q_plat = unpack(z)
    _, q_full = robot.cfg.state_full(qe, iters)
    qtip_w = lie.quat_multiply(qb, q_full[..., 0, :])
    return PlatformSolution(
        qe=qe, platform_position=p, platform_quaternion=q_plat,
        reaction_force=lie.quat_rotate_normalized(qb, w[..., :3]),
        reaction_moment=lie.quat_rotate_normalized(qtip_w, w[..., 3:]),
        residual_norm=rn, iterations=k, converged=rn <= tol)


def _platform_system(robot: PlatformRobot, platform_force, platform_moment, tension, pose0,
                     qe0, iters, device=None):
    """``(residual, unpack, z0, batch)`` of the coupled unknowns ``z = [qe
    (R nq), wrench (6R), pose (6)]``, shared by :func:`solve_platform`, the
    stability tools and the IK."""
    cfg = robot.cfg
    r_legs, nq = robot.num_legs, cfg.nq
    dev = _device(device, platform_force, platform_moment, tension, pose0, qe0)
    pb, qb, att, grip, g_loc = robot._tables()
    pb_t, qb_t, att_t, grip_t = (_f64(a, dev) for a in (pb, qb, att, grip))
    f_ext = _f64(np.zeros(3) if platform_force is None else platform_force, dev)
    m_ext = _f64(np.zeros(3) if platform_moment is None else platform_moment, dev)
    if robot.gravity is not None and robot.platform_mass:
        f_ext = f_ext + robot.platform_mass * _f64(robot.gravity, dev)
    if pose0 is None:
        # straight-leg assembly: attachment 0 on leg 0's undeformed tip
        v = np.asarray([cfg.rod.length, 0.0, 0.0])
        u, qw = qb[0, 1:], qb[0, 0]
        tip0 = pb[0] + v + 2.0 * qw * np.cross(u, v) + 2.0 * np.cross(u, np.cross(u, v))
        p0 = _f64(tip0 - att[0], dev)
        q0 = _f64([1.0, 0.0, 0.0, 0.0], dev)
    else:
        p0 = _f64(pose0[0], dev)
        q0 = lie.quat_normalize(_f64(pose0[1], dev))
    tension = None if tension is None else _f64(tension, dev)
    # a batched tension (..., R, K) batches the solve too (the JAX system
    # takes its batch from the wrench, pose0 and qe0 only)
    batch = torch.broadcast_shapes(f_ext.shape[:-1], m_ext.shape[:-1], p0.shape[:-1],
                                   () if qe0 is None else tuple(np.shape(qe0))[:-2],
                                   () if tension is None else tension.shape[:-2])
    qe0 = _f64(cfg.kappa0_modes if qe0 is None else qe0, dev).expand(batch + (r_legs, nq))
    z0 = torch.cat([qe0.reshape(batch + (r_legs * nq,)),
                    torch.zeros(batch + (6 * r_legs + 6,), dtype=torch.float64, device=dev)],
                   dim=-1)
    extra = None if g_loc is None else _f64(g_loc, dev)

    def unpack(z):
        b = z.shape[:-1]
        qe = z[..., :r_legs * nq].reshape(b + (r_legs, nq))
        w = z[..., r_legs * nq:r_legs * (nq + 6)].reshape(b + (r_legs, 6))
        return qe, w, p0 + z[..., -6:-3], lie.quat_multiply(_quat_exp(z[..., -3:]), q0)

    def residual(z):
        qe, w, p, q_plat = unpack(z)
        f_leg, m_body = w[..., :3], w[..., 3:]
        _, rhs = dyn._mass_and_rhs(qe, torch.zeros_like(qe), cfg, f_leg, iters, m_body,
                                   extra_accel=extra, tension=tension, static_only=True)
        r_full, q_full = cfg.state_full(qe, iters)
        tip_w = pb_t + lie.quat_rotate_normalized(qb_t, r_full[..., 0, :])
        qtip_w = lie.quat_multiply(qb_t, q_full[..., 0, :])
        tgt_p = p[..., None, :] + lie.quat_rotate_normalized(q_plat[..., None, :], att_t)
        tgt_q = lie.quat_multiply(q_plat[..., None, :], grip_t)
        c_pos = tip_w - tgt_p                                         # (..., R, 3)
        c_rot = _rot_error(qtip_w, tgt_q)                             # (..., R, 3)
        # platform rigid-body balance (world, moments about p)
        f_w = lie.quat_rotate_normalized(qb_t, f_leg)
        m_w = lie.quat_rotate_normalized(qtip_w, m_body)
        f_bal = f_ext - torch.sum(f_w, dim=-2)
        m_bal = m_ext - torch.sum(m_w + lie.cross(tip_w - p[..., None, :], f_w), dim=-2)
        b = z.shape[:-1]
        return torch.cat([rhs.reshape(b + (r_legs * nq,)),
                          torch.cat([c_pos, c_rot], dim=-1).reshape(b + (6 * r_legs,)),
                          f_bal.expand(b + (3,)), m_bal.expand(b + (3,))], dim=-1)

    return residual, unpack, z0, batch


class PlatformStability(NamedTuple):
    eig_max: torch.Tensor      # (...,) largest reduced force-Jacobian eigenvalue
    stable: torch.Tensor       # (...,) eig_max < 0
    solution: PlatformSolution


def platform_stability(robot: PlatformRobot, platform_force=None, platform_moment=None,
                       tension=None, pose0=None, qe0=None, tol: float = 1e-9,
                       max_iter: int = 60, iters: int = 16, line_search: bool = True,
                       device=None) -> PlatformStability:
    """Equilibrium and stability of a parallel continuum robot.

    A constrained conservative equilibrium is stable iff the force Jacobian
    ``A = d(primal rows)/d(primal vars)`` (primal = ``[qe..., pose]``, the
    multipliers held at their equilibrium values) is negative definite on
    ``null(dc/dx)``.  Both blocks come from one per-sample Jacobian of the
    Newton residual at the solution; the null basis from a full SVD of the
    constraint block, ``eig_max`` from ``eigvalsh`` of the symmetrized
    reduced Jacobian.  The null basis is not unique; ``eig_max`` is.
    """
    residual, unpack, z0, _ = _platform_system(robot, platform_force, platform_moment, tension,
                                               pose0, qe0, iters, device)
    z, k, res = dyn.damped_newton(residual, z0, tol=tol, max_iter=max_iter,
                                  line_search=line_search)
    r_legs, nq = robot.num_legs, robot.cfg.nq
    m = r_legs * nq + 6 * r_legs + 6
    jac = cosserat._per_sample_jacobian(residual, z)                  # (..., m, m)
    prim = torch.cat([torch.arange(r_legs * nq), torch.arange(m - 6, m)]).to(z.device)
    cons = torch.arange(r_legs * nq, r_legs * nq + 6 * r_legs, device=z.device)
    a_blk = jac[..., prim[:, None], prim[None, :]]                    # (..., P, P)
    c_blk = jac[..., cons[:, None], prim[None, :]]                    # (..., 6R, P)
    z_basis = torch.linalg.svd(c_blk, full_matrices=True)[2][..., 6 * r_legs:, :]
    red = torch.einsum("...ip,...pq,...jq->...ij", z_basis, a_blk, z_basis)
    eig_max = torch.linalg.eigvalsh(0.5 * (red + red.transpose(-1, -2)))[..., -1]
    sol = _platform_solution(robot, z, k, res, unpack, tol, iters)
    return PlatformStability(eig_max=eig_max, stable=eig_max < 0.0, solution=sol)


def platform_critical_load(robot: PlatformRobot, unit_force=None, unit_moment=None,
                           lam_lo: float = 0.0, lam_hi: float = 1.0, bisect_steps: int = 30,
                           device=None, **kwargs) -> float:
    """Buckling load of a PCR under the wrench ray ``lambda * unit``: host
    bisection on the sign of :func:`platform_stability`'s ``eig_max``, each
    equilibrium warm-started from the last stable one (one host sync per
    step, the sign test).  ``lam_lo`` must be stable and ``lam_hi``
    unstable (checked).  ``kwargs`` go to :func:`platform_stability`."""
    dev = _device(device, unit_force, unit_moment)
    uf = _f64(np.zeros(3) if unit_force is None else unit_force, dev)
    um = _f64(np.zeros(3) if unit_moment is None else unit_moment, dev)

    def probe(lam, warm=None):
        qe0, pose0 = (None, None) if warm is None else (warm[0], warm[1:])
        st = platform_stability(robot, platform_force=lam * uf, platform_moment=lam * um,
                                qe0=qe0, pose0=pose0, device=dev, **kwargs)
        sol = st.solution
        ok = bool(torch.logical_and(st.stable, sol.converged))
        return ok, (sol.qe, sol.platform_position, sol.platform_quaternion)

    ok_lo, warm = probe(float(lam_lo))
    if not ok_lo:
        raise ValueError(f"lam_lo={lam_lo} is not a stable equilibrium")
    if probe(float(lam_hi), warm)[0]:
        raise ValueError(f"lam_hi={lam_hi} is still stable — raise it")
    lo, hi = float(lam_lo), float(lam_hi)
    for _ in range(bisect_steps):
        mid = 0.5 * (lo + hi)
        ok, state = probe(mid, warm)
        if ok:
            lo, warm = mid, state
        else:
            hi = mid
    return 0.5 * (lo + hi)


class PlatformIKSolution(NamedTuple):
    tension: torch.Tensor              # (..., R, K) recovered tensions
    qe: torch.Tensor                   # (..., R, nq)
    platform_position: torch.Tensor    # (..., 3)
    platform_quaternion: torch.Tensor  # (..., 4)
    pose_error: torch.Tensor           # (...,) ||pose residual chart||_2


def platform_ik(robot: PlatformRobot, target_position, target_quaternion=None, tension0=None,
                gn_steps: int = 10, lm_damping: float = 1e-8, min_tension: float = 0.0,
                platform_force=None, platform_moment=None, tol: float = 1e-9,
                max_iter: int = 40, iters: int = 16, device=None) -> PlatformIKSolution:
    """Inverse actuation of a tendon-driven PCR: per-leg cable tensions that
    place the platform at a target pose.

    ``gn_steps`` Gauss-Newton steps in a host loop.  Each solves the coupled
    equilibrium ``R(z, T) = 0`` (warm-started), takes the implicit-function
    sensitivity ``dz/dT = -J_z^-1 dR/dT`` (per-sample Jacobians in ``z`` and
    in ``T``, one ``torch.linalg.solve_ex`` with a matrix right-hand side),
    and a Levenberg-Marquardt step on the pose rows, with the active set of
    :func:`.tendon.tendon_ik` on ``T >= min_tension`` (a cable at the bound
    whose gradient pushes it lower is frozen).  ``target_quaternion`` adds
    the orientation chart (a 6-dim target).  Batched over the leading axes
    of the targets; tensions are per (leg, cable), ``R*K`` coordinates.
    """
    k_t = len(robot.cfg.tendons)
    if k_t == 0:
        raise ValueError("platform_ik needs robot.cfg.tendons")
    r_legs, nq = robot.num_legs, robot.cfg.nq
    dev = _device(device, target_position, target_quaternion, tension0, platform_force,
                  platform_moment)
    target_p = _f64(target_position, dev)
    has_rot = target_quaternion is not None
    target_q = _f64(target_quaternion, dev) if has_rot else None
    batch = torch.broadcast_shapes(target_p.shape[:-1],
                                   () if not has_rot else target_q.shape[:-1])
    n_act = r_legs * k_t
    tension = (torch.zeros(batch + (n_act,), dtype=torch.float64, device=dev)
               if tension0 is None
               else _f64(tension0, dev).reshape(batch + (n_act,)).clone())

    def system(t_flat):
        return _platform_system(robot, platform_force, platform_moment,
                                t_flat.reshape(t_flat.shape[:-1] + (r_legs, k_t)), None, None,
                                iters, dev)

    _, unpack, z, _ = system(tension)
    z = z.expand(batch + (z.shape[-1],))
    eye_t = torch.eye(n_act, dtype=torch.float64, device=dev)

    def pose_error(zz):
        _, _, p, q_plat = unpack(zz)
        err = [p - target_p]
        if has_rot:
            err.append(_rot_error(q_plat, target_q))
        return torch.cat(err, dim=-1)                                  # (..., 3 or 6)

    def equilibrium(zz, tt):
        return dyn.damped_newton(system(tt)[0], zz, tol=tol, max_iter=max_iter)[0]

    for _ in range(gn_steps):
        z = equilibrium(z, tension)
        j_z = cosserat._per_sample_jacobian(system(tension)[0], z)    # (..., m, m)
        j_t = cosserat._per_sample_jacobian(lambda tt: system(tt)[0](z), tension)  # (..., m, RK)
        dz_dt = -torch.linalg.solve_ex(j_z, j_t)[0]
        err, j_pose = cosserat.jvp_columns(pose_error, (z,), (torch.movedim(dz_dt, -1, 0),))
        g = torch.einsum("...ck,...c->...k", j_pose, err)
        frozen = torch.logical_and(tension <= min_tension + 1e-12, g > 0.0)
        free = 1.0 - frozen.to(torch.float64)
        jtj = torch.einsum("...ck,...cl->...kl", j_pose, j_pose)
        jtj = (free[..., :, None] * free[..., None, :] * jtj
               + (lm_damping * free + frozen.to(torch.float64))[..., None, :] * eye_t)
        step = torch.linalg.solve_ex(jtj, (free * g)[..., None])[0][..., 0]
        tension = torch.clamp(tension - free * step, min=min_tension)
    z = equilibrium(z, tension)
    qe, _, p, q_plat = unpack(z)
    return PlatformIKSolution(
        tension=tension.reshape(batch + (r_legs, k_t)), qe=qe, platform_position=p,
        platform_quaternion=q_plat,
        pose_error=torch.linalg.vector_norm(pose_error(z), dim=-1))
