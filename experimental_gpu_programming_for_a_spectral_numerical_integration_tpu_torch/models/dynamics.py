"""Rod dynamics: Lagrangian mechanics in the strain-mode space.

Counterpart of the JAX package's ``models/dynamics.py``, the single-rod
parts: the strain modes ``qe`` are generalized coordinates with

* potential energy ``V = 1/2 (qe - kappa0)^T K_ee (qe - kappa0)``,
  ``K_ee = int Phi^T H Phi dX`` (:func:`stiffness_matrix`), plus gravity,
  obstacle penalties, tendon (``T l``) and magnetic potentials;
* kinetic energy ``T = 1/2 int [rho_a |r_dot|^2 + rho_i |omega|^2] dX``,
  ``T = 1/2 qd^T M(qe) qd`` with the configuration-dependent mass
  :func:`mass_matrix` from the implicit-function tangents of the Picard
  solve, or :func:`mass_matrix_fused` from one K1 and one direction-stacked
  K2 launch;
* the Euler-Lagrange balance ``M qdd = rhs`` (:func:`_mass_and_rhs`), whose
  inertial terms are ``-(dM/dt) qd + dT/dqe`` from ``torch.func``
  derivatives of the scalar ``T`` and whose loads are cotangents on the
  full-grid state pulled back through one ``torch.func.vjp``.

:func:`simulate` integrates it with RK4 in a host loop with no host sync
per step; :func:`solve_contact_statics` solves the static balance by a
damped Newton (:func:`damped_newton`, one host sync per iterate) with a
batched Armijo line search.

``torch.func.jvp`` of a jvp through the Picard solve's ``autograd.Function``
returns a zero tangent (torch runs a Function's jvp rule with forward-mode AD
off), and the Coriolis term differentiates a velocity tangent again.  So the
state's velocity tangent is written out here (:func:`_tangent_from_state`:
one more Picard solve, the JAX rule, and the tangent map's derivative by
hand), and the inertial terms are reverse-mode derivatives of it.

Not ported yet (ROADMAP.md Queue 1 item 5): the segmented dynamics
configuration, rod-rod scenes (``rr``), ``simulate_implicit`` and the
spectrum tools.  Factories and non-tensor input go to the card
(``ops/device.py``); torch tensors keep their device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ops import basis as basis_ops
from ..ops import collocation as coll
from ..ops import lie
from ..ops.device import as_tensor, cached_constants, default_device
from . import cosserat, rod
from . import magnetics as magnetics_mod
from . import tendon as tendon_mod

__all__ = [
    "ContactPlane",
    "ContactSphere",
    "ContactCylinder",
    "DynamicsConfig",
    "Trajectory",
    "stiffness_matrix",
    "mass_matrix",
    "mass_matrix_fused",
    "fluid_damping_matrix",
    "potential_energy",
    "kinetic_energy",
    "total_energy",
    "accelerations",
    "simulate",
    "ContactStaticsSolution",
    "damped_newton",
    "solve_contact_statics",
]

MASS_TIERS = ("xla", "fused")
_NOT_PORTED = "not ported yet: ROADMAP.md Queue 1 item 5"


@cached_constants
def _vector(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """A constant vector of an obstacle or config on ``like``'s device,
    cached, so the hot path makes no host-to-device copy."""
    return _vector(tuple(float(v) for v in values), like.device, like.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` without torch's linear cut-off above 20 (JAX's form)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class _Obstacle:
    """Smooth-penalty unilateral contact.  A concrete obstacle is a frozen
    dataclass with ``stiffness``, ``damping``, ``smoothing``, ``friction``,
    ``friction_vel`` and a ``gap(r)``: a penetration field at positions
    ``r (..., n, 3)``, positive inside the obstacle, pointwise, with
    ``|grad g| = 1``.  The penetration maps through ``s(g) = smoothing *
    softplus(g / smoothing)`` into the potential ``1/2 stiffness int s^2 dX``;
    ``damping`` adds a normal dashpot ``-damping s'(g) (dg/dt) grad g`` and
    ``friction`` a regularized Coulomb law ``-mu N v_t / sqrt(|v_t|^2 +
    friction_vel^2)``."""

    def gap_ramp(self, r):
        """``s(g)`` at positions ``r (..., n, 3)``."""
        return self.smoothing * _softplus(self.gap(r) / self.smoothing)


@dataclass(frozen=True)
class ContactPlane(_Obstacle):
    """Half-space: the rod stays on ``normal . r >= offset``; ``gap = offset
    - normal . r``."""

    normal: tuple = (0.0, 0.0, 1.0)
    offset: float = 0.0
    stiffness: float = 1e4
    damping: float = 0.0
    smoothing: float = 1e-3
    friction: float = 0.0
    friction_vel: float = 1e-3

    def gap(self, r):
        return self.offset - torch.einsum("...c,c->...", r, _vec(self.normal, r))


@dataclass(frozen=True)
class ContactSphere(_Obstacle):
    """Ball of ``radius`` at ``center``: the rod stays outside
    (``gap = radius - |r - c|``), or inside with ``interior=True``."""

    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 0.5
    interior: bool = False
    stiffness: float = 1e4
    damping: float = 0.0
    smoothing: float = 1e-3
    friction: float = 0.0
    friction_vel: float = 1e-3

    def gap(self, r):
        # the epsilon guards the gradient's 0/0 at the center
        d = torch.sqrt(torch.sum((r - _vec(self.center, r)) ** 2, dim=-1) + 1e-30)
        g = self.radius - d
        return -g if self.interior else g


@dataclass(frozen=True)
class ContactCylinder(_Obstacle):
    """Infinite cylinder, axis through ``point`` along ``axis``; the rod stays
    outside (``gap = radius - dist_to_axis``)."""

    point: tuple = (0.0, 0.0, 0.0)
    axis: tuple = (0.0, 1.0, 0.0)
    radius: float = 0.5
    stiffness: float = 1e4
    damping: float = 0.0
    smoothing: float = 1e-3
    friction: float = 0.0
    friction_vel: float = 1e-3

    def gap(self, r):
        u = np.asarray(self.axis, np.float64)
        u = _vec(u / np.linalg.norm(u), r)
        d = r - _vec(self.point, r)
        d_perp = d - torch.einsum("...c,c->...", d, u)[..., None] * u
        return self.radius - torch.sqrt(torch.sum(d_perp ** 2, dim=-1) + 1e-30)


@dataclass(frozen=True)
class DynamicsConfig:
    """Statics configuration plus inertia, damping and loads.

    ``rho_a``: mass per unit length; ``rho_i``: rotary inertia per unit
    length, > 0 (torsion carries no translational inertia, so ``rho_i = 0``
    makes ``M`` singular).  ``damping``: mass-proportional, ``qdd -= damping
    qd``.  ``kv_damping``: Kelvin-Voigt, the generalized force ``-kv_damping
    K_ee qd``.  ``gravity``: constant acceleration ``(3,)``.  ``contact``: an
    obstacle or a tuple of them.  ``tendons`` (:mod:`.tendon`) and ``magnets``
    (:mod:`.magnetics`): driven by the runtime ``tension`` and ``b_field``.
    ``fluid_drag = (c_t, c_n)``: resistive-force drag per unit length,
    ``f = -c_t (v.t) t - c_n v_perp``.
    """

    statics: cosserat.StaticsConfig = field(
        default_factory=lambda: cosserat.StaticsConfig(rod=rod.RodConfig(n=16)))
    rho_a: float = 1.0
    rho_i: float = 1e-3
    damping: float = 0.0
    kv_damping: float = 0.0
    gravity: tuple | None = None
    contact: _Obstacle | tuple | None = None
    tendons: tuple = ()
    magnets: tuple = ()
    fluid_drag: tuple | None = None

    def __post_init__(self):
        if not isinstance(self.statics, cosserat.StaticsConfig):
            raise NotImplementedError(
                f"dynamics of a segmented rod (SegmentedDynamicsConfig) is {_NOT_PORTED}")

    @property
    def contacts(self) -> tuple:
        if self.contact is None:
            return ()
        return self.contact if isinstance(self.contact, tuple) else (self.contact,)

    @property
    def rod(self) -> rod.RodConfig:
        return self.statics.rod

    @functools.cached_property
    def k_ee(self) -> np.ndarray:
        return stiffness_matrix(self.statics)

    @functools.cached_property
    def kappa0_modes(self) -> np.ndarray:
        if self.statics.kappa0 is None:
            return np.zeros(self.nq)
        return np.asarray(self.statics.kappa0, np.float64)

    @property
    def nq(self) -> int:
        return self.rod.na * self.rod.ne

    @functools.cached_property
    def quad_weights_full(self) -> np.ndarray:
        """Clenshaw-Curtis weights on ``state_full``'s grid."""
        return np.asarray(self.statics.quad_weights, np.float64)

    @functools.cached_property
    def points_full(self) -> np.ndarray:
        """Arclengths of ``state_full``'s grid, tip first."""
        return np.asarray(self.rod.points, np.float64)

    @functools.cached_property
    def magnet_table(self) -> np.ndarray:
        """Summed ``(n, 3)`` body-frame dipole density of ``magnets``."""
        xs = self.points_full
        total = float(xs[0]) if xs[0] > 0 else 1.0
        return magnetics_mod.magnetization_table(self.magnets, xs / total)

    def state_full(self, qe, iters: int):
        """Full-grid ``(r (..., n, 3), q (..., n, 4))``, tip at point 0, base
        appended, through the differentiable Picard solve."""
        return _state_full(qe, self, iters)

    def tendon_lengths_from_state(self, r, q):
        """Routed lengths ``(..., K)`` of ``tendons`` from ``state_full``."""
        return tendon_mod.lengths_from_state(r, q, self.tendons, self.rod,
                                             self.statics.quad_weights)


def stiffness_matrix(scfg: cosserat.StaticsConfig) -> np.ndarray:
    """Host f64 ``K_ee = int Phi^T H Phi dX``: ``na`` copies of the basis
    Gram matrix under Clenshaw-Curtis quadrature, each scaled by its ``H``
    entry (weighted per point for an ``(n, na)`` stiffness profile)."""
    table = scfg.full_basis_table                  # (n, ne)
    w = scfg.quad_weights
    h = np.asarray(scfg.stiffness, np.float64)
    na = scfg.rod.na
    if h.shape[-1] != na:
        raise ValueError(f"stiffness has {h.shape[-1]} entries, na={na}")
    if h.ndim == 1:
        return np.kron(np.diag(h), table.T @ (w[:, None] * table))
    ne = table.shape[1]
    out = np.zeros((na * ne, na * ne))
    for a in range(na):
        out[a * ne:(a + 1) * ne, a * ne:(a + 1) * ne] = table.T @ ((w * h[:, a])[:, None] * table)
    return out


class _Constants(NamedTuple):
    k_ee: torch.Tensor           # (nq, nq)
    kappa0: torch.Tensor         # (nq,)
    weights: torch.Tensor        # (n,) quadrature weights of state_full
    magnets: torch.Tensor        # (n, 3) dipole table
    gravity: torch.Tensor | None  # (3,)


@cached_constants
def _constants(cfg: DynamicsConfig, device: torch.device, dtype: torch.dtype) -> _Constants:
    def dev(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    return _Constants(k_ee=dev(cfg.k_ee), kappa0=dev(cfg.kappa0_modes),
                      weights=_weights(cfg, device, dtype), magnets=dev(cfg.magnet_table),
                      gravity=None if cfg.gravity is None else dev(cfg.gravity))


@cached_constants
def _weights(cfg: DynamicsConfig, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The quadrature weights alone: the inertia needs no stiffness."""
    return torch.tensor(cfg.quad_weights_full, dtype=dtype, device=device)


def _state_full(qe, cfg: DynamicsConfig, iters: int):
    """``(r, q)`` on the full grid (``cosserat._full_grid_state``, which
    returns them the other way round)."""
    q, r = cosserat._full_grid_state(cfg.rod, qe, iters)
    return r, q


def _pad_base(t: torch.Tensor) -> torch.Tensor:
    """Append the clamped base point's zero tangent to ``(..., n-1, c)``."""
    return torch.cat([t, t.new_zeros(t.shape[:-2] + (1, t.shape[-1]))], dim=-2)


def _tangent_from_state(qe, v, q_full, cfg: DynamicsConfig, iters: int):
    """``(dr, dq)``: the tangent of ``state_full`` at ``qe`` along ``v``,
    given the state's quaternions ``q_full``.  The implicit-function rule
    written out, ``dq = solve(m, 1/2 A(dK) q)`` (one more Picard solve) and
    ``dr = G db``, so that the derivatives of this tangent (the inertial
    terms) never nest a forward-mode rule of the solve (module docstring)."""
    rc = cfg.rod
    grid = rc.grid(qe.device)
    table = rod._basis_table(rc, qe.device)
    k = basis_ops.strain_at_points(qe, table)
    dk = basis_ops.strain_at_points(v, table)
    q = q_full[..., :-1, :]
    dq = coll.solve_ivp_picard_implicit(grid, 0.5 * lie.quat_skew(k[..., :3]),
                                        lie.quat_skew_apply(0.5 * dk[..., :3], q), iters)
    db = (lie.rod_tangent_jvp(q, dq, k[..., 3:6], dk[..., 3:6]) if rc.na == 6
          else lie.rod_tangent_jvp(q, dq))
    return _pad_base(torch.matmul(grid.ginv.to(qe.dtype), db)), _pad_base(dq)


def _direction_tangents(qe, q_full, cfg: DynamicsConfig, iters: int):
    """State tangents ``(dr, omega)`` along every unit strain direction,
    ``(..., n, 3, nq)`` each (``omega`` the body angular velocity)."""
    eye = torch.eye(qe.shape[-1], dtype=qe.dtype, device=qe.device)
    dr, dq = torch.func.vmap(
        lambda e: _tangent_from_state(qe, e.expand(qe.shape), q_full, cfg, iters))(eye)
    return torch.movedim(dr, 0, -1), torch.movedim(_omega_from_dq(q_full, dq), 0, -1)


def _omega_from_dq(q, dq):
    """Body angular velocity ``2 (q* x dq)_vec`` from a quaternion rate."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    dw, dx, dy, dz = dq[..., 0], dq[..., 1], dq[..., 2], dq[..., 3]
    return 2.0 * torch.stack([
        -x * dw + w * dx + z * dy - y * dz,
        -y * dw - z * dx + w * dy + x * dz,
        -z * dw + y * dx - x * dy + w * dz,
    ], dim=-1)


def mass_matrix(qe, cfg: DynamicsConfig, iters: int = 16):
    """``M(qe) = int [rho_a J_r^T J_r + rho_i B^T B] dX``, ``(..., nq, nq)``:
    ``J_r = dr/dqe`` and ``B = d omega/d qd`` from the ``nq`` implicit-function
    tangents of the Picard solve (vmapped over the unit directions)."""
    qe = as_tensor(qe)
    return _mass_from_state(qe, cfg.state_full(qe, iters)[1], cfg, iters)


def _mass_from_state(qe, q_full, cfg: DynamicsConfig, iters: int):
    """:func:`mass_matrix` given the state's quaternions ``q_full``."""
    dr, om = _direction_tangents(qe, q_full, cfg, iters)
    w = _weights(cfg, qe.device, qe.dtype)
    return (cfg.rho_a * torch.einsum("j,...jci,...jck->...ik", w, dr, dr)
            + cfg.rho_i * torch.einsum("j,...jci,...jck->...ik", w, om, om))


def _forward_only(qe: torch.Tensor, what: str) -> None:
    """Refuse a call that asks the kernels for a derivative: K1 and K2 have
    none, and a launch would drop the tangent or gradient silently."""
    from torch.autograd import forward_ad

    if (torch._C._are_functorch_transforms_active()
            or (qe.requires_grad and torch.is_grad_enabled())
            or forward_ad.unpack_dual(qe).tangent is not None):
        raise RuntimeError(
            f"{what} is forward-only: the K1/K2 kernels it launches have no derivative. "
            "Under torch.autograd or torch.func use mass_matrix (mass_tier='xla').")


def mass_matrix_fused(qe, cfg: DynamicsConfig, iters: int = 16, jac_iters: int | None = None,
                      jac_precision: str = "high"):
    """``M(qe)`` from the kernels' implicit-function tangents: one K1 launch
    for the state and one K2 launch over the ``3 ne`` curvature directions
    stacked into the batch (``cosserat._fused_state_and_tangents``), then
    the quadrature of :func:`mass_matrix`.  f32 kernels (relative gap to
    :func:`mass_matrix` ~1e-7 to 1e-6); the RK4 throughput lane of
    ``simulate(mass_tier='fused')``.

    Single-rod :class:`DynamicsConfig` only, and forward-only: it raises under
    ``torch.autograd`` (a ``qe`` that requires grad) and ``torch.func``.
    ``jac_iters``: the direction solves' Picard count (default ``iters``).
    ``jac_precision`` is accepted for call compatibility with the JAX API
    and checked, but every value runs as FP32.  The JAX API's TPU ``tile``
    has no counterpart: the kernels pick their launch shape.  CPU tensors
    run the kernels' plain versions.
    """
    from ..ops.kernels import rod_kernel as rk

    if type(cfg) is not DynamicsConfig:
        raise ValueError("mass_matrix_fused supports the single-rod DynamicsConfig only, got "
                         f"{type(cfg).__name__}; use mass_matrix")
    if jac_precision not in rk.PRECISIONS:
        raise ValueError(f"jac_precision must be one of {rk.PRECISIONS}, got {jac_precision!r}")
    qe = as_tensor(qe)
    _forward_only(qe, "mass_matrix_fused")
    lead, nq = qe.shape[:-1], qe.shape[-1]
    qe2 = qe.reshape(-1, nq).to(torch.float32)
    q_full, _, dq_dirs, dr_dirs = cosserat._fused_state_and_tangents(qe2, cfg.statics, iters,
                                                                     jac_iters)
    npts = cfg.rod.n - 1
    om = _pad_base(_omega_from_dq(q_full[None, :, :npts, :], dq_dirs))
    dr = _pad_base(dr_dirs)
    w = _weights(cfg, qe2.device, torch.float32)
    m = (cfg.rho_a * torch.einsum("j,ibjc,kbjc->bik", w, dr, dr)
         + cfg.rho_i * torch.einsum("j,ibjc,kbjc->bik", w, om, om))
    return m.reshape(lead + (nq, nq)).to(qe.dtype)


def fluid_damping_matrix(qe, cfg: DynamicsConfig, iters: int = 16):
    """``C_f(qe) = int J_r^T [c_n I + (c_t - c_n) t t^T] J_r dX``, the exact
    generalized damping of the resistive-force drag (``Q_drag = -C_f qd``)."""
    if cfg.fluid_drag is None:
        raise ValueError("config has no fluid_drag coefficients")
    c_tan, c_nrm = cfg.fluid_drag
    qe = as_tensor(qe)
    r, q = cfg.state_full(qe, iters)
    dr, _ = _direction_tangents(qe, q, cfg, iters)
    t_hat = lie.quat_rotate_normalized(q, _vec((1.0, 0.0, 0.0), qe).expand(r.shape))
    eye3 = torch.eye(3, dtype=qe.dtype, device=qe.device)
    proj = c_nrm * eye3 + (c_tan - c_nrm) * t_hat[..., :, None] * t_hat[..., None, :]
    w = _weights(cfg, qe.device, qe.dtype)
    return torch.einsum("j,...jci,...jcd,...jdk->...ik", w, dr, proj, dr)


def potential_energy(qe, cfg: DynamicsConfig, tension=None, b_field=None):
    """Elastic energy ``1/2 dqe^T K_ee dqe``, plus gravity, contact penalties,
    the tendon potentials ``T_k l_k`` (constant ``tension``) and the magnetic
    potential (constant ``b_field``); the state at 16 Picard steps, as in
    the JAX package."""
    qe = as_tensor(qe)
    c = _constants(cfg, qe.device, qe.dtype)
    dq = qe - c.kappa0
    v = 0.5 * torch.einsum("...i,ij,...j->...", dq, c.k_ee, dq)
    actuated = tension is not None and cfg.tendons
    magnetized = b_field is not None and cfg.magnets
    if actuated or magnetized or cfg.gravity is not None or cfg.contacts:
        r, q = cfg.state_full(qe, 16)
    if actuated:
        lens = cfg.tendon_lengths_from_state(r, q)
        v = v + torch.sum(torch.as_tensor(tension, dtype=qe.dtype, device=qe.device) * lens,
                          dim=-1)
    if magnetized:
        b0, g = magnetics_mod.parse_field(b_field, qe.dtype, qe.device)
        v = v + magnetics_mod.energy_from_state(r, q, c.weights, c.magnets, b0, g)
    if cfg.gravity is not None:
        v = v - cfg.rho_a * torch.einsum("j,...jc,c->...", c.weights, r, c.gravity)
    for ct in cfg.contacts:
        s = ct.gap_ramp(r)
        v = v + 0.5 * ct.stiffness * torch.einsum("j,...j->...", c.weights, s * s)
    return v


def kinetic_energy(qe, qd, cfg: DynamicsConfig, iters: int = 16):
    """``T = 1/2 int [rho_a |r_dot|^2 + rho_i |omega|^2] dX`` from one state
    tangent along ``qd`` (equal to ``1/2 qd^T M qd``); the generating
    functional of the inertial forces in :func:`_mass_and_rhs`."""
    qe = as_tensor(qe)
    qd = torch.as_tensor(qd, dtype=qe.dtype, device=qe.device)
    _, q = cfg.state_full(qe, iters)
    rdot, qdot = _tangent_from_state(qe, qd, q, cfg, iters)
    om = _omega_from_dq(q, qdot)
    w = _weights(cfg, qe.device, qe.dtype)
    return 0.5 * (cfg.rho_a * torch.einsum("j,...jc,...jc->...", w, rdot, rdot)
                  + cfg.rho_i * torch.einsum("j,...jc,...jc->...", w, om, om))


def total_energy(qe, qd, cfg: DynamicsConfig, iters: int = 16, tension=None, b_field=None):
    return kinetic_energy(qe, qd, cfg, iters) + potential_energy(qe, cfg, tension, b_field)


def _at_tip(v: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., c)`` placed at grid point 0 of an ``(..., n, c)`` zero field."""
    return torch.cat([v[..., None, :], v.new_zeros(v.shape[:-1] + (n - 1, v.shape[-1]))],
                     dim=-2)


def _load_at(load, t, like: torch.Tensor):
    """A loading protocol at stage time ``t``: ``None`` passes, a callable is
    called with ``t``, anything else is a constant; as a tensor like
    ``like``."""
    if load is None:
        return None
    if callable(load):
        load = load(t)
    return torch.as_tensor(load, dtype=like.dtype, device=like.device)


def _on_device(load, like: torch.Tensor):
    """A constant load as a tensor like ``like``, copied to the device once;
    ``None`` and callables pass."""
    if load is None or callable(load):
        return load
    return torch.as_tensor(load, dtype=like.dtype, device=like.device)


def _mass_and_rhs(qe, qd, cfg: DynamicsConfig, tip_force=None, iters: int = 16,
                  tip_moment=None, extra_accel=None, tension=None, b_field=None,
                  static_only: bool = False, mass_tier: str = "xla"):
    """``(M(qe), rhs)`` of ``M qdd = rhs`` (mass-proportional damping is
    applied in :func:`accelerations`).

    ``static_only=True`` (the ``qd = 0`` balance of the statics Newton)
    skips the mass matrix and the inertial terms and returns ``(None, rhs)``.
    ``tip_force`` (follower when ``cfg.statics.follower``), ``tip_moment``,
    ``extra_accel`` (a uniform acceleration field, e.g. the d'Alembert term
    of a moving base), ``tension (..., K)`` and ``b_field`` are cotangents
    on the full-grid state, pulled back through one vjp of the solve.
    ``mass_tier='fused'`` assembles ``M`` with :func:`mass_matrix_fused`.
    """
    if mass_tier not in MASS_TIERS:
        raise ValueError(f"mass_tier must be one of {MASS_TIERS}, got {mass_tier!r}")
    qe = as_tensor(qe)
    qd = torch.as_tensor(qd, dtype=qe.dtype, device=qe.device)
    c = _constants(cfg, qe.device, qe.dtype)
    rhs = -torch.einsum("ij,...j->...i", c.k_ee, qe - c.kappa0)
    if cfg.kv_damping:
        rhs = rhs - cfg.kv_damping * torch.einsum("ij,...j->...i", c.k_ee, qd)

    g_eff = c.gravity
    if extra_accel is not None:
        ea = torch.as_tensor(extra_accel, dtype=qe.dtype, device=qe.device)
        g_eff = ea if g_eff is None else g_eff + ea

    actuated = tension is not None and cfg.tendons
    magnetized = b_field is not None and cfg.magnets
    dragged = cfg.fluid_drag is not None
    loaded = (tip_force is not None or tip_moment is not None or cfg.contacts
              or g_eff is not None or actuated or magnetized or dragged)
    # One state solve serves the mass matrix and the loads; every load below
    # is a cotangent on the full-grid (r, q) state, pulled back through ONE
    # vjp of the solve.
    if loaded:
        (r_full, q_full), pull = torch.func.vjp(lambda q_: cfg.state_full(q_, iters), qe)
    elif not static_only and mass_tier == "xla":
        q_full = cfg.state_full(qe, iters)[1]

    if static_only:
        m = None
    else:
        # M qdd = ... - (dM/dt) qd + dT/dqe with T the scalar kinetic
        # energy.  (dM/dt) qd = d/dt grad_qd T along qd, taken as
        # grad_qd <grad_qe T, u> at u = qd (the mixed partials commute):
        # reverse over reverse, which torch.func runs far cheaper than the
        # forward-over-reverse of the JAX package.
        m = (mass_matrix_fused(qe, cfg, iters) if mass_tier == "fused"
             else _mass_from_state(qe, q_full, cfg, iters))

        def t_scalar(q_, qd_):
            return torch.sum(kinetic_energy(q_, qd_, cfg, iters))

        def along_qd(qd_):
            dt_dq_ = torch.func.grad(t_scalar)(qe, qd_)
            return torch.sum(dt_dq_ * qd), dt_dq_

        mdot_qd, dt_dq = torch.func.grad(along_qd, has_aux=True)(qd)
        rhs = rhs - mdot_qd + dt_dq
    if not loaded:
        return m, rhs

    n = r_full.shape[-2]
    w_q = c.weights
    r_cot = torch.zeros_like(r_full)
    q_cot = torch.zeros_like(q_full)
    rdot = None
    if dragged or any(ct.damping or ct.friction for ct in cfg.contacts):
        rdot = _tangent_from_state(qe, qd, q_full, cfg, iters)[0]
    if dragged:
        c_tan, c_nrm = cfg.fluid_drag
        t_hat = lie.quat_rotate_normalized(q_full, _vec((1.0, 0.0, 0.0), qe).expand(r_full.shape))
        v_t = torch.einsum("...c,...c->...", rdot, t_hat)[..., None] * t_hat
        r_cot = r_cot + w_q[:, None] * -(c_tan * v_t + c_nrm * (rdot - v_t))
    if tip_force is not None:
        f = torch.as_tensor(tip_force, dtype=qe.dtype, device=qe.device).expand(
            qe.shape[:-1] + (3,))
        if cfg.statics.follower:
            # given in the tip's body frame, turning with it
            f = lie.quat_rotate_normalized(q_full[..., 0, :], f)
        r_cot = r_cot + _at_tip(f, n)
    if tip_moment is not None:
        # virtual work of a dead couple through the tip rotation 2 (q* x dq)_vec
        q_tip = q_full[..., 0, :]
        m_vec = torch.as_tensor(tip_moment, dtype=qe.dtype, device=qe.device).expand(
            qe.shape[:-1] + (3,))
        _, pull_m = torch.func.vjp(lambda dq: _omega_from_dq(q_tip, dq), torch.zeros_like(q_tip))
        q_cot = q_cot + _at_tip(pull_m(m_vec)[0], n)
    if g_eff is not None:
        r_cot = r_cot + cfg.rho_a * w_q[:, None] * g_eff[..., None, :]
    if actuated:
        t_vec = torch.as_tensor(tension, dtype=qe.dtype, device=qe.device)
        lens, pull_l = torch.func.vjp(cfg.tendon_lengths_from_state, r_full, q_full)
        dr_l, dq_l = pull_l(-t_vec.expand(lens.shape))
        r_cot = r_cot + dr_l
        q_cot = q_cot + dq_l
    if magnetized:
        b0, g_field = magnetics_mod.parse_field(b_field, qe.dtype, qe.device)
        u, pull_u = torch.func.vjp(
            lambda rr_, qq_: magnetics_mod.energy_from_state(rr_, qq_, w_q, c.magnets, b0,
                                                             g_field), r_full, q_full)
        dr_u, dq_u = pull_u(-torch.ones_like(u))
        r_cot = r_cot + dr_u
        q_cot = q_cot + dq_u
    for ct in cfg.contacts:
        # One vjp of the gap field gives the penalty force -k s s' grad g,
        # the dashpot along the same grad g and (|grad g| = 1) the normal.
        g, pull_g = torch.func.vjp(ct.gap, r_full)
        s = ct.smoothing * _softplus(g / ct.smoothing)
        sprime = torch.sigmoid(g / ct.smoothing)
        coef = ct.stiffness * s * sprime
        if ct.damping or ct.friction:
            gdot = torch.func.jvp(ct.gap, (r_full,), (rdot,))[1]
        if ct.damping:
            coef = coef + ct.damping * sprime * gdot
        r_cot = r_cot + pull_g(-(w_q * coef))[0]
        if ct.friction:
            n_out = -pull_g(torch.ones_like(g))[0]
            v_t = rdot - torch.einsum("...c,...c->...", rdot, n_out)[..., None] * n_out
            speed = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + ct.friction_vel ** 2)
            f_f = -(ct.friction * torch.clamp(coef, min=0.0) / speed)[..., None] * v_t
            r_cot = r_cot + w_q[:, None] * f_f
    return m, rhs + pull((r_cot, q_cot))[0]


def accelerations(qe, qd, cfg: DynamicsConfig, tip_force=None, iters: int = 16,
                  tip_moment=None, extra_accel=None, tension=None, b_field=None,
                  mass_tier: str = "xla"):
    """``qdd`` from the Euler-Lagrange balance (``torch.linalg.solve_ex``, no
    host sync), then mass-proportional damping ``qdd -= damping qd``."""
    m, rhs = _mass_and_rhs(qe, qd, cfg, tip_force, iters, tip_moment, extra_accel, tension,
                           b_field, mass_tier=mass_tier)
    qdd = torch.linalg.solve_ex(m, rhs.unsqueeze(-1))[0][..., 0]
    if cfg.damping:
        qdd = qdd - cfg.damping * qd
    return qdd


class Trajectory(NamedTuple):
    times: torch.Tensor     # (steps,)
    qes: torch.Tensor       # (steps, ..., nq)
    qds: torch.Tensor       # (steps, ..., nq)
    energies: torch.Tensor  # (steps, ...)


def simulate(qe0, qd0, cfg: DynamicsConfig, dt: float, steps: int, tip_force=None,
             iters: int = 16, record_energy: bool = True, tip_moment=None, base_accel=None,
             t0: float = 0.0, tension=None, b_field=None, mass_tier: str = "xla") -> Trajectory:
    """RK4 integration, batched over the leading axes of ``qe0``, in a host
    loop with no host sync per step.

    ``tip_force``, ``tip_moment``, ``base_accel``, ``tension`` and
    ``b_field`` are constants, copied to ``qe0``'s device once, or callables
    of the stage time (a 0-d tensor on that device), called at every RK4
    stage; a callable that returns host data costs a copy, and with it a
    host sync, per stage, so return device tensors.  ``base_accel``
    prescribes the base's acceleration: the motion is solved relative to
    the moving base, under the d'Alembert body force ``-rho_a a_b``.
    ``mass_tier='fused'``: the mass matrix from :func:`mass_matrix_fused`
    (K1 + K2, forward-only); the default ``'xla'`` is the differentiable
    torch tier (the JAX name).  ``record_energy``: :func:`total_energy` after
    each step.
    """
    qe = as_tensor(qe0)
    qd = torch.as_tensor(qd0, dtype=qe.dtype, device=qe.device)
    t = torch.full((), float(t0), dtype=qe.dtype, device=qe.device)
    tip_force, tip_moment, base_accel, tension = (
        _on_device(v, qe) for v in (tip_force, tip_moment, base_accel, tension))
    if b_field is not None and not callable(b_field):
        b0, g = magnetics_mod.parse_field(b_field, qe.dtype, qe.device)
        b_field = b0 if g is None else (b0, g)

    def deriv(qe_, qd_, t_):
        ea = _load_at(base_accel, t_, qe)
        return qd_, accelerations(qe_, qd_, cfg, _load_at(tip_force, t_, qe), iters,
                                  tip_moment=_load_at(tip_moment, t_, qe),
                                  extra_accel=None if ea is None else -ea,
                                  tension=_load_at(tension, t_, qe),
                                  b_field=magnetics_mod.field_at(b_field, t_),
                                  mass_tier=mass_tier)

    qes, qds, energies = [], [], []
    for _ in range(steps):
        k1 = deriv(qe, qd, t)
        k2 = deriv(qe + 0.5 * dt * k1[0], qd + 0.5 * dt * k1[1], t + 0.5 * dt)
        k3 = deriv(qe + 0.5 * dt * k2[0], qd + 0.5 * dt * k2[1], t + 0.5 * dt)
        k4 = deriv(qe + dt * k3[0], qd + dt * k3[1], t + dt)
        qe = qe + dt / 6.0 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        qd = qd + dt / 6.0 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        t = t + dt
        energies.append(total_energy(qe, qd, cfg, iters, tension=_load_at(tension, t, qe),
                                     b_field=magnetics_mod.field_at(b_field, t))
                        if record_energy else qe.new_zeros(qe.shape[:-1]))
        qes.append(qe)
        qds.append(qd)
    times = t0 + dt * torch.arange(1, steps + 1, dtype=qe.dtype, device=qe.device)
    return Trajectory(times=times, qes=torch.stack(qes), qds=torch.stack(qds),
                      energies=torch.stack(energies))


def _balance_residual_fn(cfg: DynamicsConfig, tip_force, tip_moment, iters: int, rr=None,
                         base_positions=None, scene_shape=None, tension=None, b_field=None):
    """The static balance ``Q(qe)`` of :func:`_mass_and_rhs` at ``qd = 0``:
    elastic restoring, gravity, tip wrench, obstacle penalties, tendons and
    magnets.  Rod-rod scenes (``rr``) are not ported."""
    if rr is not None or scene_shape is not None:
        raise NotImplementedError(f"rod-rod scenes (rr) are {_NOT_PORTED}(b)")

    def residual(qe):
        return _mass_and_rhs(qe, torch.zeros_like(qe), cfg, tip_force, iters, tip_moment,
                             tension=tension, b_field=b_field, static_only=True)[1]

    return residual


class ContactStaticsSolution(NamedTuple):
    qe: torch.Tensor             # (..., nq)
    residual_norm: torch.Tensor  # (...,)
    iterations: torch.Tensor     # scalar
    converged: torch.Tensor      # (...,)


def damped_newton(residual, z0, tol: float = 1e-8, max_iter: int = 40,
                  line_search: bool = True, jac_chunk: int | None = None):
    """Batched damped Newton on ``residual(z) = 0``, ``z (..., m)``: until the
    batch's largest residual norm is ``<= tol`` or ``max_iter`` steps, one
    host sync per iterate (that test).  Per-sample Jacobians from one jvp
    per unit direction (``jac_chunk`` directions at a time through
    ``torch.func.vmap(chunk_size=...)``, which bounds the live memory of the
    tangent passes), steps from ``torch.linalg.solve_ex``.  ``line_search``:
    a per-sample backtracking Armijo search over ``{1, 1/2, ..., 1/16}`` with
    the current iterate as candidate 0, all six priced by one residual call.
    Returns ``(z, iterations, residual)``."""
    z = as_tensor(z0)
    res = residual(z)
    alphas = torch.tensor([0.0, 1.0, 0.5, 0.25, 0.125, 0.0625], dtype=z.dtype,
                          device=z.device).reshape((6,) + (1,) * z.ndim)
    k = 0
    while k < max_iter and bool(torch.linalg.vector_norm(res, dim=-1).max() > tol):
        jac = cosserat._per_sample_jacobian(residual, z, jac_chunk)
        step = cosserat._newton_step(jac, res)
        k += 1
        if not line_search:
            z = z - step
            res = residual(z)
            continue
        cand = z[None] - alphas * step[None]                       # (6, ..., m)
        res_c = residual(cand)
        norms = torch.linalg.vector_norm(res_c, dim=-1)            # (6, ...)
        ok = norms[1:] < (1.0 - 1e-4 * alphas[1:, ..., 0]) * norms[0]
        idx = 1 + torch.where(ok.any(0), ok.int().argmax(0), norms[1:].argmin(0))
        pick = idx[None, ..., None]
        z = torch.take_along_dim(cand, pick, dim=0)[0]
        res = torch.take_along_dim(res_c, pick, dim=0)[0]
    return z, torch.tensor(k, dtype=torch.int32, device=z.device), res


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (tuple, list)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    return y.device
    return default_device()


def solve_contact_statics(cfg: DynamicsConfig, qe0=None, tip_force=None, tip_moment=None,
                          tol: float = 1e-8, max_iter: int = 40, iters: int = 16,
                          line_search: bool = True, rr=None, base_positions=None,
                          tension=None, b_field=None,
                          jac_chunk: int | None = None) -> ContactStaticsSolution:
    """Static equilibrium with the environment: :func:`damped_newton` on the
    balance of :func:`_mass_and_rhs` at ``qd = 0`` (elastic, gravity, tip
    wrench, obstacle penalties, tendons under ``tension (..., K)``, magnets
    under a constant ``b_field``).  Batched over the leading axes of
    ``qe0`` (default: the rest strain, f64, on the loads' device or the
    card).  The line search is what lets a stiff penalty's cold start
    converge.  ``jac_chunk`` streams the Jacobian's tangent passes in chunks
    of that many directions.  Rod-rod scenes (``rr``) are not ported.
    """
    if rr is not None:
        raise NotImplementedError(f"rod-rod scenes (rr) are {_NOT_PORTED}(b)")
    if qe0 is None:
        qe0 = torch.tensor(cfg.kappa0_modes, dtype=torch.float64,
                           device=_device_of(tension, tip_force, tip_moment, b_field))
    qe0 = as_tensor(qe0)
    residual = _balance_residual_fn(cfg, tip_force, tip_moment, iters, tension=tension,
                                    b_field=b_field)
    qe, k, res = damped_newton(residual, qe0, tol=tol, max_iter=max_iter,
                               line_search=line_search, jac_chunk=jac_chunk)
    rn = torch.linalg.vector_norm(res, dim=-1)
    return ContactStaticsSolution(qe=qe, residual_norm=rn, iterations=k, converged=rn <= tol)
