"""Rod dynamics: Lagrangian mechanics in the strain-mode space.

Counterpart of the JAX package's ``models/dynamics.py``: the strain modes
``qe`` are generalized coordinates with

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

Integrators: RK4 :func:`simulate` and implicit Newmark
:func:`simulate_implicit` (a Newton per step, one host sync per Newton
iterate), both host loops with no other host sync per step.  Statics:
:func:`solve_contact_statics`, a damped Newton (:func:`damped_newton`) with
a batched Armijo line search.  Multi-rod scenes: :class:`RodRodContact`
(all-pairs or a top-k broad phase) with :func:`simulate_scene` and
``rr=`` on the statics and spectra.  Chained rods:
:class:`SegmentedDynamicsConfig` runs the same stack on the segment chain.
Stability: :func:`natural_frequencies`, :func:`linearized_spectrum`,
:func:`damped_spectrum`, :func:`frequency_response`, :func:`critical_load`,
:func:`floquet_multipliers` and :func:`parametric_stability_map`, with the
eigenproblems in NumPy f64 on the host, as in the JAX package.

``torch.func.jvp`` of a jvp through the Picard solve's ``autograd.Function``
returns a zero tangent (torch runs a Function's jvp rule with forward-mode AD
off), and the Coriolis term differentiates a velocity tangent again.  So the
state's velocity tangent is written out here (the config's
``state_tangent``: one more Picard solve per segment, the JAX rule, and the
tangent map's derivative by hand), and the inertial terms are reverse-mode
derivatives of it; a Jacobian of the balance (Newmark, spectra, monodromy)
adds one forward level on top.  Factories and non-tensor input go to the
card (``ops/device.py``); torch tensors keep their device.
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
from .bifurcation import _host
from . import segment_statics
from . import tendon as tendon_mod

__all__ = [
    "ContactPlane",
    "ContactSphere",
    "ContactCylinder",
    "RodRodContact",
    "scene_energy",
    "scene_accelerations",
    "simulate_scene",
    "DynamicsConfig",
    "SegmentedDynamicsConfig",
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
    "simulate_implicit",
    "ContactStaticsSolution",
    "damped_newton",
    "solve_contact_statics",
    "parametric_stability_map",
    "floquet_multipliers",
    "natural_frequencies",
    "linearized_spectrum",
    "damped_spectrum",
    "frequency_response",
    "critical_load",
]

MASS_TIERS = ("xla", "fused")


@cached_constants
def _vector(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """A constant host vector (an obstacle's or config's, grid weights or
    arclengths) on ``like``'s device, cached, so the hot path makes no
    host-to-device copy; a tensor is cast to ``like``'s dtype."""
    if isinstance(values, torch.Tensor):
        return values.to(device=like.device, dtype=like.dtype)
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


def _ramp(d: torch.Tensor, radius: float, smoothing: float):
    """Distances ``|d|`` of separation vectors ``d (..., 3)``, the penalty
    ramp ``s`` of the gap ``2 radius - |d|`` and its slope ``s'``."""
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-30)
    g = 2.0 * radius - dist
    return dist, smoothing * _softplus(g / smoothing), torch.sigmoid(g / smoothing)


@dataclass(frozen=True)
class RodRodContact:
    """Rod-rod (and self-) contact of multi-rod scenes: a smooth penalty
    between grid points of distinct rods whose centerlines come closer than
    ``2 radius``, through the obstacles' softplus ramp, with the scene
    potential ``V = 1/2 stiffness sum_{i<k} int int s(2 radius - |r_i(X) -
    r_k(Y)|)^2 dX dY``.  All pairs by default, ``(..., R, R, n, n)`` fields;
    ``budget = K`` keeps each rod's K partners of smallest bounding-sphere
    surface distance (``torch.topk``), ``(..., R, K, n, n)`` fields: a pair
    present in only one rod's list counts at half stiffness, and the force
    stays the exact gradient of a translation-invariant potential (check the
    sizing with :meth:`broadphase_overflow`).  ``budget >= R - 1`` routes to
    the all-pairs path.  ``self_window`` (arclength) adds same-rod pairs with
    ``|s_j - s_l| >= self_window``.  ``friction``: the regularized Coulomb
    law per pair on the relative velocity, antisymmetric under partner
    exchange, so it injects no momentum.
    """

    radius: float = 0.05
    stiffness: float = 1e4
    smoothing: float = 1e-3
    self_window: float | None = None
    friction: float = 0.0
    friction_vel: float = 1e-3
    budget: int | None = None

    def _band(self, s_grid, like: torch.Tensor) -> torch.Tensor:
        """``(n, n)`` 1 where ``|s_j - s_l| >= self_window``."""
        if s_grid is None:
            raise ValueError("self_window needs the grid arclengths")
        s = _vec(s_grid, like)
        return (torch.abs(s[:, None] - s[None, :]) >= self.self_window).to(like.dtype)

    def _pair_fields(self, r_all, s_grid):
        """All-pairs separations ``d (..., R, R, n, n, 3)`` (partner ``(k, l)``
        to point ``(i, j)``), distances, ramp, slope and the ordered
        interaction mask (``i != k`` every point; ``i == k`` off-band points
        under ``self_window``)."""
        d = r_all[..., :, None, :, None, :] - r_all[..., None, :, None, :, :]
        dist, s, sprime = _ramp(d, self.radius, self.smoothing)
        nr, n = r_all.shape[-3], r_all.shape[-2]
        eye_r = torch.eye(nr, dtype=r_all.dtype, device=r_all.device)
        off = (1.0 - eye_r)[:, :, None, None].expand(nr, nr, n, n)
        if self.self_window is not None:
            eye_n = torch.eye(n, dtype=r_all.dtype, device=r_all.device)
            off = off + eye_r[:, :, None, None] * ((1.0 - eye_n) * self._band(s_grid, r_all))
        return d, dist, s, sprime, off

    def _use_broadphase(self, r_all) -> bool:
        return self.budget is not None and self.budget < r_all.shape[-3] - 1

    def _partner_index(self, r_all):
        """``(..., R, K)`` candidate partners: the ``budget`` smallest
        bounding-sphere surface distances (centroid separation minus both
        radii), self at ``+inf``."""
        cent = torch.mean(r_all, dim=-2)
        rad = torch.amax(torch.linalg.vector_norm(r_all - cent[..., None, :], dim=-1), dim=-1)
        diff = cent[..., :, None, :] - cent[..., None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
        surf = dist - rad[..., :, None] - rad[..., None, :]
        eye = torch.eye(r_all.shape[-3], dtype=torch.bool, device=r_all.device)
        surf = torch.where(eye, torch.full_like(surf, float("inf")), surf)
        return torch.topk(-surf, self.budget, dim=-1).indices

    def _gather_partner(self, field, idx):
        """``field (..., R, n, c)`` at the partner rods: ``(..., R, K, n, c)``."""
        nr, n, c = field.shape[-3:]
        lead = field.shape[:-3]
        f_exp = field[..., None, :, :, :].expand(lead + (nr, nr, n, c))
        i_exp = idx[..., :, :, None, None].expand(lead + (nr, self.budget, n, c))
        return torch.take_along_dim(f_exp, i_exp, dim=-3)

    def _gathered_fields(self, r_all, idx):
        """Gathered :meth:`_pair_fields`: ``d (..., R, K, n, n, 3)`` (partner
        point ``l`` to own point ``j``), distances, ramp and slope."""
        r_part = self._gather_partner(r_all, idx)
        d = r_all[..., :, None, :, None, :] - r_part[..., :, :, None, :, :]
        return (d,) + _ramp(d, self.radius, self.smoothing)

    def _self_band_fields(self, r_all, s_grid):
        """Same-rod off-band pairs as ``(..., R, n, n)`` fields and their
        mask: the broad phase's rod gather never yields self."""
        d = r_all[..., :, :, None, :] - r_all[..., :, None, :, :]
        dist, s, sprime = _ramp(d, self.radius, self.smoothing)
        eye_n = torch.eye(r_all.shape[-2], dtype=r_all.dtype, device=r_all.device)
        return d, dist, s, sprime, self._band(s_grid, r_all) * (1.0 - eye_n)

    def broadphase_overflow(self, r_all, margin: float | None = None):
        """True (per leading batch element) when a rod pair closer than ``2
        radius + margin`` (default ``6 smoothing``) at some point pair is
        missing from the candidates the broad phase would gather.  All-pairs
        cost: a sizing check, not a hot-loop guard."""
        if self.budget is None or not self._use_broadphase(r_all):
            return torch.zeros(r_all.shape[:-3], dtype=torch.bool, device=r_all.device)
        if margin is None:
            margin = 6.0 * self.smoothing
        d = r_all[..., :, None, :, None, :] - r_all[..., None, :, None, :, :]
        mind = torch.amin(torch.sqrt(torch.sum(d * d, dim=-1) + 1e-30), dim=(-1, -2))
        nr = r_all.shape[-3]
        eye = torch.eye(nr, dtype=torch.bool, device=r_all.device)
        near = ~eye & (mind < 2.0 * self.radius + margin)
        member = torch.nn.functional.one_hot(self._partner_index(r_all), nr).bool().any(-2)
        return torch.any(near & ~member, dim=(-1, -2))

    def pair_potential(self, r_all, w_q, s_grid=None):
        """Scene penalty energy at world positions ``r_all (..., R, n, 3)``
        with quadrature weights ``w_q (n,)``; ``s_grid (n,)``, the grid
        arclengths, is needed with ``self_window``."""
        w_q = _vec(w_q, r_all)
        ww = w_q[:, None] * w_q[None, :]
        if not self._use_broadphase(r_all):
            _, _, s, _, mask = self._pair_fields(r_all, s_grid)
            # the mask counts each unordered pair twice: 1/4, not 1/2
            return 0.25 * self.stiffness * torch.einsum("jl,ikjl,...ikjl->...", ww, mask, s * s)
        _, _, s, _ = self._gathered_fields(r_all, self._partner_index(r_all))
        v = 0.25 * self.stiffness * torch.einsum("jl,...ikjl->...", ww, s * s)
        if self.self_window is not None:
            _, _, s_s, _, mask = self._self_band_fields(r_all, s_grid)
            v = v + 0.25 * self.stiffness * torch.einsum("jl,...ijl->...", ww, mask * s_s * s_s)
        return v

    def _coulomb(self, d, dist, s, sprime, v_rel, ww):
        """Per-pair friction coefficient ``mu N / speed`` and the tangential
        relative velocity ``v_t`` (off the pair direction)."""
        n_hat = d / dist[..., None]
        v_t = v_rel - torch.einsum("...c,...c->...", v_rel, n_hat)[..., None] * n_hat
        speed = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + self.friction_vel ** 2)
        return self.friction * self.stiffness * s * sprime * ww / speed, v_t

    def friction_force(self, r_all, v_all, w_q, s_grid=None):
        """Per-point friction force ``(..., R, n, 3)`` (a cotangent on the
        scene positions) from the grid velocities ``v_all``."""
        w_q = _vec(w_q, r_all)
        ww = w_q[:, None] * w_q[None, :]
        if not self._use_broadphase(r_all):
            d, dist, s, sprime, mask = self._pair_fields(r_all, s_grid)
            v_rel = v_all[..., :, None, :, None, :] - v_all[..., None, :, None, :, :]
            coef, v_t = self._coulomb(d, dist, s, sprime, v_rel, ww)
            return -torch.einsum("...ikjl,...ikjlc->...ijc", mask * coef, v_t)
        idx = self._partner_index(r_all)
        d, dist, s, sprime = self._gathered_fields(r_all, idx)
        v_part = self._gather_partner(v_all, idx)
        v_rel = v_all[..., :, None, :, None, :] - v_part[..., :, :, None, :, :]
        coef, v_t = self._coulomb(d, dist, s, sprime, v_rel, ww)
        f = -torch.einsum("...ikjl,...ikjlc->...ijc", coef, v_t)
        if self.self_window is not None:
            d_s, dist_s, s_s, sp_s, mask = self._self_band_fields(r_all, s_grid)
            v_rel_s = v_all[..., :, :, None, :] - v_all[..., :, None, :, :]
            coef_s, v_t_s = self._coulomb(d_s, dist_s, s_s, sp_s, v_rel_s, ww)
            f = f - torch.einsum("...ijl,...ijlc->...ijc", mask * coef_s, v_t_s)
        return f


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

    def state_tangent(self, qe, v, q_full, iters: int):
        """``(dr, dq)``: the tangent of :meth:`state_full` at ``qe`` along
        ``v``, given the state's quaternions ``q_full``, written out
        (:func:`_tangent_from_state`) so that its derivatives never nest a
        forward-mode rule of the Picard solve."""
        return _tangent_from_state(qe, v, q_full[..., :-1, :], self.rod, iters)

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


@dataclass(frozen=True)
class SegmentedDynamicsConfig(DynamicsConfig):
    """Dynamics of a chained multi-segment rod: ``statics`` holds a
    :class:`~.segment_statics.SegmentedStaticsConfig`.  The dynamics stack
    reads the rod only through the hooks (``nq``, ``k_ee``,
    ``kappa0_modes``, ``quad_weights_full``, ``points_full``,
    ``state_full``, ``state_tangent``, ``tendon_lengths_from_state``), so
    the integrators, the contact statics and the spectra run unchanged on
    the chain.  Coordinates ``qe (..., S*na*ne)`` in base-first segment
    blocks; the ``state_full`` grid is the segments' full grids concatenated
    tip first (the rod's tip at point 0; a junction point appears in both
    neighbours' grids, each inside its own segment's integral).  Rod-rod
    scenes and ``mass_matrix_fused`` take single-rod configs only.
    """

    def __post_init__(self):
        # Tendons live on the statics config (with their termination map);
        # the load assembly reads the dynamics field.
        if getattr(self.statics, "tendons", ()) and not self.tendons:
            object.__setattr__(self, "tendons", tuple(self.statics.tendons))

    @property
    def rod(self) -> rod.RodConfig:
        raise AttributeError("SegmentedDynamicsConfig has no single rod grid: use "
                             "cfg.statics.rods.segments (scenes/rr paths are single-rod)")

    @property
    def nq(self) -> int:
        rods = self.statics.rods
        return rods.num_segments * rods.segments[0].na * rods.segments[0].ne

    @functools.cached_property
    def k_ee(self) -> np.ndarray:
        """Block-diagonal ``kron(diag(H_s), Gram_s)``, base-first blocks."""
        blocks = []
        for s, h in enumerate(self.statics.stiffness_per_segment):
            table = np.asarray(self.statics.full_tables[s], np.float64)
            w = np.asarray(self.statics.quad_weights[s], np.float64)
            blocks.append(np.kron(np.diag(h), table.T @ (w[:, None] * table)))
        return _block_diagonal(np.stack(blocks))

    @functools.cached_property
    def kappa0_modes(self) -> np.ndarray:
        if self.statics.kappa0 is None:
            return np.zeros(self.nq)
        return np.asarray(self.statics.kappa0, np.float64).reshape(-1)

    @functools.cached_property
    def quad_weights_full(self) -> np.ndarray:
        """Per-segment Clenshaw-Curtis weights, tip first."""
        return np.concatenate([np.asarray(w, np.float64)
                               for w in reversed(self.statics.quad_weights)])

    @functools.cached_property
    def points_full(self) -> np.ndarray:
        """Global arclengths of the tip-first grid: each segment's points
        shifted by the length of the segments before it."""
        segs = self.statics.rods.segments
        offsets = np.cumsum([0.0] + [s.length for s in segs])
        return np.concatenate([offsets[i] + np.asarray(segs[i].points, np.float64)
                               for i in reversed(range(len(segs)))])

    @functools.cached_property
    def _blocks(self) -> tuple:
        """Per segment (base first), its ``(start, stop)`` in the tip-first
        ``state_full`` grid."""
        segs = self.statics.rods.segments
        offs = np.cumsum([0] + [s.n for s in reversed(segs)])
        last = len(segs) - 1
        return tuple((int(offs[last - s]), int(offs[last - s + 1])) for s in range(len(segs)))

    def _segments_of(self, qe):
        rods = self.statics.rods
        return qe.reshape(qe.shape[:-1] + (rods.num_segments, self.nq // rods.num_segments))

    def state_full(self, qe, iters: int):
        qs, rs, _ = segment_statics._chained_full_states(self._segments_of(qe), self.statics,
                                                         iters, "picard")
        return torch.cat(rs[::-1], dim=-2), torch.cat(qs[::-1], dim=-2)

    def state_tangent(self, qe, v, q_full, iters: int):
        """The chained tangent: segment ``s+1`` starts from segment ``s``'s
        tip tangent ``(dq0, dr0)``, which enters its Picard right-hand side
        as the known point's term, like ``q0``."""
        qe_s, v_s = self._segments_of(qe), self._segments_of(v)
        drs, dqs, bc = [], [], None
        for s, seg in enumerate(self.statics.rods.segments):
            i0, i1 = self._blocks[s]
            dr, dq = _tangent_from_state(qe_s[..., s, :], v_s[..., s, :],
                                         q_full[..., i0:i1 - 1, :], seg, iters, bc)
            drs.append(dr)
            dqs.append(dq)
            bc = (dq[..., 0, :], dr[..., 0, :])
        return torch.cat(drs[::-1], dim=-2), torch.cat(dqs[::-1], dim=-2)

    def tendon_lengths_from_state(self, r, q):
        segs = self.statics.rods.segments
        lens = []
        for t, last in zip(self.statics.tendons, self.statics.tendon_last_segment):
            total, theta = 0.0, None            # the capstan turning, accumulated
            for s in range(last + 1):           # base segment -> anchor
                i0, i1 = self._blocks[s]
                contrib, theta = tendon_mod.lengths_from_state(
                    r[..., i0:i1, :], q[..., i0:i1, :], (t,), segs[s],
                    self.statics.quad_weights[s], theta0=theta, return_theta=True)
                total = total + contrib[..., 0]
            lens.append(total)
        return torch.stack(lens, dim=-1)


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


def _positions_full(qe, cfg: DynamicsConfig, iters: int):
    return cfg.state_full(qe, iters)[0]


def _pad_base(t: torch.Tensor, base: torch.Tensor | None = None) -> torch.Tensor:
    """Append the base point's tangent (zero at a clamped base) to
    ``(..., n-1, c)``."""
    if base is None:
        base = t.new_zeros(t.shape[:-2] + (t.shape[-1],))
    return torch.cat([t, base.expand(t.shape[:-2] + base.shape[-1:])[..., None, :]], dim=-2)


def _tangent_from_state(qe, v, q, rc: rod.RodConfig, iters: int, bc=None):
    """``(dr, dq)`` on the full grid: the tangent at ``qe`` along ``v`` of one
    rod's state, given its quaternions ``q`` at the solved points and the
    base's tangent ``bc = (dq0, dr0)`` (``None``: a clamped base).  The
    implicit-function rule written out, ``dq = solve(m, 1/2 A(dK) q - Dn_IN
    dq0)`` (one more Picard solve) and ``dr = G (db - Dn_IN dr0)``, so that
    the derivatives of this tangent (the inertial terms) never nest a
    forward-mode rule of the solve (module docstring)."""
    grid = rc.grid(qe.device)
    table = rod._basis_table(rc, qe.device)
    k = basis_ops.strain_at_points(qe, table)
    dk = basis_ops.strain_at_points(v, table)
    rhs = lie.quat_skew_apply(0.5 * dk[..., :3], q)
    if bc is not None:
        rhs = coll.ivp_rhs(grid, bc[0], g=rhs)
    dq = coll.solve_ivp_picard_implicit(grid, 0.5 * lie.quat_skew(k[..., :3]), rhs, iters)
    db = (lie.rod_tangent_jvp(q, dq, k[..., 3:6], dk[..., 3:6]) if rc.na == 6
          else lie.rod_tangent_jvp(q, dq))
    if bc is not None:
        db = coll.ivp_rhs(grid, bc[1], g=db)
    dr = torch.matmul(grid.ginv.to(qe.dtype), db)
    if bc is None:
        return _pad_base(dr), _pad_base(dq)
    return _pad_base(dr, bc[1]), _pad_base(dq, bc[0])


def _direction_tangents(qe, q_full, cfg: DynamicsConfig, iters: int):
    """State tangents ``(dr, omega)`` along every unit strain direction,
    ``(..., n, 3, nq)`` each (``omega`` the body angular velocity)."""
    eye = torch.eye(qe.shape[-1], dtype=qe.dtype, device=qe.device)
    dr, dq = torch.func.vmap(
        lambda e: cfg.state_tangent(qe, e.expand(qe.shape), q_full, iters))(eye)
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
    rdot, qdot = cfg.state_tangent(qe, qd, q, iters)
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
        rdot = cfg.state_tangent(qe, qd, q_full, iters)[0]
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
    return _solve_balance(m, rhs, qd, cfg)


def _solve_balance(m, rhs, qd, cfg: DynamicsConfig):
    """``M^-1 rhs - damping qd`` (``torch.linalg.solve_ex``, no host sync)."""
    qdd = torch.linalg.solve_ex(m, rhs.unsqueeze(-1))[0][..., 0]
    if cfg.damping:
        qdd = qdd - cfg.damping * qd
    return qdd


class Trajectory(NamedTuple):
    times: torch.Tensor     # (steps,)
    qes: torch.Tensor       # (steps, ..., nq)
    qds: torch.Tensor       # (steps, ..., nq)
    energies: torch.Tensor  # (steps, ...)


def _protocol(like: torch.Tensor, tip_force, tip_moment, base_accel, tension, b_field):
    """The loads of an integrator as a function of the stage time ``t`` (a
    0-d tensor on ``like``'s device) to the keywords of :func:`_mass_and_rhs`:
    constants are copied to the device once, here; callables are called
    with ``t``.  ``base_accel`` enters as the d'Alembert ``-a_b``."""
    tip_force, tip_moment, base_accel, tension = (
        _on_device(v, like) for v in (tip_force, tip_moment, base_accel, tension))
    if b_field is not None and not callable(b_field):
        b0, g = magnetics_mod.parse_field(b_field, like.dtype, like.device)
        b_field = b0 if g is None else (b0, g)

    def at(t, energy_only: bool = False):
        """The loads at ``t``; ``energy_only``: the potentials' two alone."""
        out = dict(tension=_load_at(tension, t, like), b_field=magnetics_mod.field_at(b_field, t))
        if not energy_only:
            ea = _load_at(base_accel, t, like)
            out.update(tip_force=_load_at(tip_force, t, like),
                       tip_moment=_load_at(tip_moment, t, like),
                       extra_accel=None if ea is None else -ea)
        return out

    return at


def _rk4(deriv, qe, qd, t0: float, dt: float, steps: int, energy):
    """RK4 over ``steps`` in a host loop; ``deriv(qe, qd, t) -> qdd`` and
    ``energy(qe, qd, t)`` after each step, ``t`` a 0-d tensor on ``qe``'s
    device.  Returns the stacked trajectory."""
    t = torch.full((), float(t0), dtype=qe.dtype, device=qe.device)
    qes, qds, energies = [], [], []
    for _ in range(steps):
        k1 = (qd, deriv(qe, qd, t))
        k2 = (qd + 0.5 * dt * k1[1], deriv(qe + 0.5 * dt * k1[0], qd + 0.5 * dt * k1[1],
                                           t + 0.5 * dt))
        k3 = (qd + 0.5 * dt * k2[1], deriv(qe + 0.5 * dt * k2[0], qd + 0.5 * dt * k2[1],
                                           t + 0.5 * dt))
        k4 = (qd + dt * k3[1], deriv(qe + dt * k3[0], qd + dt * k3[1], t + dt))
        qe = qe + dt / 6.0 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        qd = qd + dt / 6.0 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        t = t + dt
        energies.append(energy(qe, qd, t))
        qes.append(qe)
        qds.append(qd)
    return _trajectory(t0, dt, qes, qds, energies)


def _trajectory(t0, dt: float, qes: list, qds: list, energies: list) -> Trajectory:
    times = t0 + dt * torch.arange(1, len(qes) + 1, dtype=qes[0].dtype, device=qes[0].device)
    return Trajectory(times=times, qes=torch.stack(qes), qds=torch.stack(qds),
                      energies=torch.stack(energies))


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
    loads = _protocol(qe, tip_force, tip_moment, base_accel, tension, b_field)

    def energy(qe_, qd_, t_):
        if not record_energy:
            return qe_.new_zeros(qe_.shape[:-1])
        return total_energy(qe_, qd_, cfg, iters, **loads(t_, energy_only=True))

    return _rk4(lambda qe_, qd_, t_: accelerations(qe_, qd_, cfg, iters=iters,
                                                   mass_tier=mass_tier, **loads(t_)),
                qe, qd, t0, dt, steps, energy)


def _scene_positions(qe, cfg: DynamicsConfig, base_positions, iters: int):
    """World-frame full grids of an ``(..., R, nq)`` scene: the per-rod
    solves (batched) plus the static base offsets ``(R, 3)``."""
    r = _positions_full(qe, cfg, iters)
    return r + torch.as_tensor(base_positions, dtype=r.dtype, device=r.device)[..., :, None, :]


def scene_energy(qe, qd, cfg: DynamicsConfig, rr: RodRodContact, base_positions,
                 iters: int = 16):
    """Total scene energy: the rods' Lagrangian energies (batched over the
    rod axis) plus the rod-rod interaction potential."""
    qe = as_tensor(qe)
    e = torch.sum(total_energy(qe, qd, cfg, iters), dim=-1)
    return e + rr.pair_potential(_scene_positions(qe, cfg, base_positions, iters),
                                 cfg.quad_weights_full, s_grid=cfg.points_full)


def scene_accelerations(qe, qd, cfg: DynamicsConfig, rr: RodRodContact, base_positions,
                        tip_force=None, iters: int = 16, tip_moment=None, extra_accel=None):
    """``qdd`` of a multi-rod scene ``qe (..., R, nq)``: the per-rod
    Euler-Lagrange balance (block-diagonal mass, ``R`` independent
    ``(nq, nq)`` solves) plus the exact gradient of the interaction
    potential and, with ``rr.friction``, the pairwise Coulomb field, both
    cotangents on the scene positions pulled back through one vjp of the
    solves.  ``base_positions (R, 3)`` plants each rod's base."""
    qe = as_tensor(qe)
    qd = torch.as_tensor(qd, dtype=qe.dtype, device=qe.device)
    m, rhs = _mass_and_rhs(qe, qd, cfg, tip_force, iters, tip_moment, extra_accel)
    base = torch.as_tensor(base_positions, dtype=qe.dtype, device=qe.device)
    (r_full, q_full), pull = torch.func.vjp(lambda q: cfg.state_full(q, iters), qe)
    r_all = r_full + base[..., :, None, :]
    cot = -torch.func.grad(lambda r: torch.sum(rr.pair_potential(
        r, cfg.quad_weights_full, s_grid=cfg.points_full)))(r_all)
    if rr.friction:
        v_all = cfg.state_tangent(qe, qd, q_full, iters)[0]
        cot = cot + rr.friction_force(r_all, v_all, cfg.quad_weights_full, s_grid=cfg.points_full)
    return _solve_balance(m, rhs + pull((cot, torch.zeros_like(q_full)))[0], qd, cfg)


def simulate_scene(qe0, qd0, cfg: DynamicsConfig, rr: RodRodContact, base_positions,
                   dt: float, steps: int, tip_force=None, iters: int = 16,
                   record_energy: bool = True, t0: float = 0.0) -> Trajectory:
    """RK4 integration of a multi-rod contact scene ``qe0 (..., R, nq)`` in
    a host loop with no host sync per step: :func:`simulate` with
    :func:`scene_accelerations` (one ``cfg`` for every rod; its obstacles,
    gravity and a constant or driven ``tip_force`` apply per rod).
    ``energies`` records :func:`scene_energy`, the interaction included."""
    qe = as_tensor(qe0)
    qd = torch.as_tensor(qd0, dtype=qe.dtype, device=qe.device)
    base = _on_device(base_positions, qe)
    force = _on_device(tip_force, qe)

    def energy(qe_, qd_, t_):
        if not record_energy:
            return qe_.new_zeros(qe_.shape[:-2])
        return scene_energy(qe_, qd_, cfg, rr, base, iters)

    return _rk4(lambda qe_, qd_, t_: scene_accelerations(qe_, qd_, cfg, rr, base,
                                                         _load_at(force, t_, qe), iters),
                qe, qd, t0, dt, steps, energy)


def simulate_implicit(qe0, qd0, cfg: DynamicsConfig, dt: float, steps: int, tip_force=None,
                      iters: int = 16, beta: float = 0.25, gamma: float = 0.5,
                      tol: float = 1e-9, max_newton: int = 20, record_energy: bool = True,
                      tip_moment=None, base_accel=None, t0: float = 0.0, tension=None,
                      b_field=None) -> Trajectory:
    """Newmark-beta integration (default: the trapezoidal rule, unconditionally
    stable for the linearized system), batched over the leading axes of
    ``qe0``: RK4's step is bounded by the stiff torsion branch
    (``sqrt(GJ / rho_i)``), the implicit step by accuracy alone.

    Each step solves ``M(q1) (a1 + damping v1) - rhs(q1, v1) = 0`` with
    ``a1 = (q1 - q0 - dt v0) / (beta dt^2) - (1/(2 beta) - 1) a0`` and
    ``v1 = v0 + dt ((1 - gamma) a0 + gamma a1)`` by Newton from the
    predictor ``q0 + dt v0`` (a ``1/2 dt^2 a0`` term throws the stiff
    regime's predictor beyond the Picard solve's domain), with per-sample
    Jacobians through the Lagrangian assembly (forward mode over its
    reverse-mode inertial terms: faster than reverse-mode rows on an H100,
    slower on the CPU; ``PERF.md``) and ``torch.linalg.solve_ex``
    steps, until the norm of the WHOLE batch's residual is ``<= tol`` or
    ``max_newton`` steps (the JAX package's test): one host sync per Newton
    iterate and none elsewhere in a step.  ``a0`` comes from
    :func:`accelerations` with the loads at ``t0``; loads as in
    :func:`simulate`, evaluated at each step's end time; energies with the
    loads at that time.
    """
    qe = as_tensor(qe0)
    qd = torch.as_tensor(qd0, dtype=qe.dtype, device=qe.device)
    t = torch.full((), float(t0), dtype=qe.dtype, device=qe.device)
    loads = _protocol(qe, tip_force, tip_moment, base_accel, tension, b_field)
    acc = accelerations(qe, qd, cfg, iters=iters, **loads(t))
    inv_bdt2 = 1.0 / (beta * dt * dt)

    def newmark_va(q1, q0, v0, a0):
        a1 = (q1 - q0 - dt * v0) * inv_bdt2 - (0.5 / beta - 1.0) * a0
        return v0 + dt * ((1.0 - gamma) * a0 + gamma * a1), a1

    qes, qds, energies = [], [], []
    for _ in range(steps):
        t = t + dt
        at = loads(t)

        def residual(q1, q0=qe, v0=qd, a0=acc):
            v1, a1 = newmark_va(q1, q0, v0, a0)
            m, rhs = _mass_and_rhs(q1, v1, cfg, iters=iters, **at)
            lhs = a1 + cfg.damping * v1 if cfg.damping else a1
            return torch.einsum("...ij,...j->...i", m, lhs) - rhs

        q1 = qe + dt * qd
        res = residual(q1)
        k = 0
        while k < max_newton and bool(torch.linalg.vector_norm(res) > tol):
            q1 = q1 - cosserat._newton_step(cosserat._per_sample_jacobian(residual, q1), res)
            res = residual(q1)
            k += 1
        qd, acc = newmark_va(q1, qe, qd, acc)
        qe = q1
        energies.append(total_energy(qe, qd, cfg, iters, tension=at["tension"],
                                     b_field=at["b_field"])
                        if record_energy else qe.new_zeros(qe.shape[:-1]))
        qes.append(qe)
        qds.append(qd)
    return _trajectory(t0, dt, qes, qds, energies)


def _balance_residual_fn(cfg: DynamicsConfig, tip_force, tip_moment, iters: int, rr=None,
                         base_positions=None, scene_shape=None, tension=None, b_field=None):
    """The static balance ``Q(qe)`` of :func:`_mass_and_rhs` at ``qd = 0``:
    elastic restoring, gravity, tip wrench, obstacle penalties, tendons and
    magnets, and with ``rr`` the rod-rod scene potential, as a function of
    the flattened coordinates (scenes pass ``scene_shape = (R, nq)``, so the
    coupled Newton and the spectra see one ``(R nq, R nq)`` Jacobian)."""

    def balance(qe):
        return _mass_and_rhs(qe, torch.zeros_like(qe), cfg, tip_force, iters, tip_moment,
                             tension=tension, b_field=b_field, static_only=True)[1]

    if scene_shape is None:
        return balance

    def residual(qe):
        q = qe.reshape(qe.shape[:-1] + tuple(scene_shape))
        base = torch.as_tensor(base_positions, dtype=q.dtype, device=q.device)
        rhs = balance(q) - torch.func.grad(lambda q2: torch.sum(rr.pair_potential(
            _scene_positions(q2, cfg, base, iters), cfg.quad_weights_full,
            s_grid=cfg.points_full)))(q)
        return rhs.reshape(qe.shape)

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
                          line_search: bool = True, rr: RodRodContact | None = None,
                          base_positions=None, tension=None, b_field=None,
                          jac_chunk: int | None = None) -> ContactStaticsSolution:
    """Static equilibrium with the environment: :func:`damped_newton` on the
    balance of :func:`_mass_and_rhs` at ``qd = 0`` (elastic, gravity, tip
    wrench, obstacle penalties, tendons under ``tension (..., K)``, magnets
    under a constant ``b_field``).  Batched over the leading axes of
    ``qe0`` (default: the rest strain, f64, on the loads' device or the
    card).  The line search is what lets a stiff penalty's cold start
    converge.  ``jac_chunk`` streams the Jacobian's tangent passes in chunks
    of that many directions.  Scenes: ``rr`` with ``base_positions (R, 3)``
    and a ``qe0 (..., R, nq)``; the rods couple through contact, so the
    Newton runs on the flattened ``(R nq)`` coordinates.
    """
    if qe0 is None:
        if rr is not None:
            raise ValueError("scene statics needs an explicit qe0 (..., R, nq) to fix the rod "
                             "count")
        qe0 = _rest_strain(cfg, tension, tip_force, tip_moment, b_field)
    qe0 = as_tensor(qe0)
    scene_shape = None
    if rr is not None:
        scene_shape = tuple(qe0.shape[-2:])
        qe0 = qe0.reshape(qe0.shape[:-2] + (scene_shape[0] * scene_shape[1],))
    residual = _balance_residual_fn(cfg, tip_force, tip_moment, iters, rr, base_positions,
                                    scene_shape, tension, b_field)
    qe, k, res = damped_newton(residual, qe0, tol=tol, max_iter=max_iter,
                               line_search=line_search, jac_chunk=jac_chunk)
    rn = torch.linalg.vector_norm(res, dim=-1)
    if scene_shape is not None:
        qe = qe.reshape(qe.shape[:-1] + scene_shape)
    return ContactStaticsSolution(qe=qe, residual_norm=rn, iterations=k, converged=rn <= tol)


def parametric_stability_map(cfg: DynamicsConfig, omegas, amplitudes,
                             load_dir=(-1.0, 0.0, 0.0), seed: float = 1e-4, seed_index: int = 3,
                             t_end: float = 25.0, dt: float = 0.045, iters: int = 12,
                             tol: float = 2e-6):
    """Growth factors ``(len(omegas), len(amplitudes))`` of parametric
    excitation: the tip load ``P1 cos(Omega t) load_dir`` over the whole
    (Omega, P1) grid in one batched :func:`simulate_implicit` run (f64, on
    ``omegas``' device), strain coordinate ``seed_index`` seeded with
    ``seed``; growth = the late-window (last eighth) maximum of that
    coordinate over ``seed``.  Instability tongues (Mathieu 2:1 at ``Omega
    ~ 2 omega_1`` foremost) are rows of large growth.  ``tol`` keeps the
    JAX package's default, set for its f32 path."""
    omegas = as_tensor(omegas, torch.float64)
    amplitudes = torch.as_tensor(amplitudes, dtype=torch.float64, device=omegas.device)
    n_o, n_a = omegas.shape[0], amplitudes.shape[0]
    og, ag = (x.reshape(-1) for x in torch.meshgrid(omegas, amplitudes, indexing="ij"))
    d = torch.as_tensor(load_dir, dtype=torch.float64, device=omegas.device)

    def drive(t):
        return (ag * torch.cos(og * t))[:, None] * d

    qe0 = torch.zeros((n_o * n_a, cfg.nq), dtype=torch.float64, device=omegas.device)
    qe0[:, seed_index] = seed
    steps = int(round(t_end / dt))
    traj = simulate_implicit(qe0, torch.zeros_like(qe0), cfg, dt=dt, steps=steps, iters=iters,
                             tip_force=drive, tol=tol, record_energy=False)
    window = max(1, steps // 8)
    amp = torch.amax(torch.abs(traj.qes[-window:, :, seed_index]), dim=0)
    return (amp / seed).reshape(n_o, n_a)


def floquet_multipliers(cfg: DynamicsConfig, period: float, steps: int, qe0=None, qd0=None,
                        iters: int = 16, tip_force=None, tip_moment=None, base_accel=None,
                        tension=None, b_field=None):
    """Floquet multipliers of the time-``period`` map about a periodic state:
    the eigenvalues (host NumPy f64) of the monodromy ``dz(T)/dz(0)`` of the
    RK4 flow of :func:`simulate` (``steps`` steps, default mass tier), ``z =
    (qe, qd)`` from ``(qe0, qd0)`` (default the straight rod at rest, f64),
    by ``torch.func.jacrev`` through the host RK4 loop: the ``2 nq`` rows
    pulled back through one taped rollout (faster than ``jacfwd`` on an
    H100 and on the CPU, the same matrix to 2e-16; ``PERF.md``).
    ``max |mu| > 1`` iff the periodic state is linearly unstable; for the
    undriven damped rod the multipliers are ``exp(lambda T)`` of the
    :func:`damped_spectrum` poles."""
    nq = cfg.nq
    if qe0 is None:
        qe0 = torch.zeros(nq, dtype=torch.float64,
                          device=_device_of(qd0, tip_force, tip_moment, base_accel, tension,
                                            b_field))
    qe0 = as_tensor(qe0)
    qd0 = torch.zeros_like(qe0) if qd0 is None else torch.as_tensor(qd0, dtype=qe0.dtype,
                                                                     device=qe0.device)

    def flow(z):
        traj = simulate(z[:nq], z[nq:], cfg, dt=period / steps, steps=steps, iters=iters,
                        tip_force=tip_force, tip_moment=tip_moment, base_accel=base_accel,
                        tension=tension, b_field=b_field, record_energy=False)
        return torch.cat([traj.qes[-1], traj.qds[-1]])

    monodromy = torch.func.jacrev(flow)(torch.cat([qe0, qd0]))
    return np.linalg.eigvals(_host(monodromy))


def _rest_strain(cfg: DynamicsConfig, *loads) -> torch.Tensor:
    """``kappa0_modes`` as f64 on the loads' device (or the card)."""
    return torch.tensor(cfg.kappa0_modes, dtype=torch.float64, device=_device_of(*loads))


def _whiten(m: np.ndarray, k: np.ndarray):
    """``(C^-1, C^-1 K C^-T)`` with ``M = C C^T`` (Cholesky)."""
    cinv = np.linalg.inv(np.linalg.cholesky(m))
    return cinv, cinv @ k @ cinv.T


def _block_diagonal(blocks: np.ndarray) -> np.ndarray:
    """``(R, nq, nq)`` blocks as one ``(R nq, R nq)`` matrix."""
    nr, nq = blocks.shape[0], blocks.shape[-1]
    out = np.zeros((nr * nq, nr * nq))
    for i in range(nr):
        out[i * nq:(i + 1) * nq, i * nq:(i + 1) * nq] = blocks[i]
    return out


def natural_frequencies(cfg: DynamicsConfig, qe0=None, iters: int = 24):
    """Small-oscillation frequencies about ``qe0`` (default the rest strain,
    on the card): ``K_ee v = omega^2 M(qe0) v`` by a Cholesky whitening on
    the host in f64.  About the straight rest state, the strain-space
    Galerkin form of the Euler-Bernoulli cantilever series
    ``omega_k = (beta_k L)^2 sqrt(EI / (rho_a L^4))``, ``beta_1 L =
    1.875104``."""
    qe0 = _rest_strain(cfg) if qe0 is None else as_tensor(qe0)
    _, a = _whiten(_host(mass_matrix(qe0, cfg, iters)), np.asarray(cfg.k_ee, np.float64))
    return np.sqrt(np.clip(np.linalg.eigvalsh(0.5 * (a + a.T)), 0.0, None))


def _linearization(cfg: DynamicsConfig, qe, tip_force, tip_moment, rr, base_positions,
                   iters: int, tension, b_field):
    """``(qe, M, K_eff, scene_shape)`` about ``qe``: the (block-diagonal for
    a scene) mass and ``K_eff = -dQ/dqe``, one ``torch.func.jacfwd`` of the
    balance of :func:`_balance_residual_fn`, both host f64."""
    if qe is None:
        if rr is not None:
            raise ValueError("scene spectra need an explicit qe (R, nq)")
        qe = _rest_strain(cfg, tip_force, tip_moment, tension, b_field)
    qe = as_tensor(qe)
    m = _host(mass_matrix(qe, cfg, iters))
    scene_shape, qe_flat = None, qe
    if rr is not None:
        scene_shape = tuple(qe.shape[-2:])
        qe_flat = qe.reshape(-1)
        m = _block_diagonal(m)
    residual = _balance_residual_fn(cfg, tip_force, tip_moment, iters, rr, base_positions,
                                    scene_shape, tension, b_field)
    return qe, m, -_host(torch.func.jacfwd(residual)(qe_flat)), scene_shape


def linearized_spectrum(cfg: DynamicsConfig, qe=None, tip_force=None, tip_moment=None,
                        rr: RodRodContact | None = None, base_positions=None, iters: int = 24,
                        modes: bool = False, symmetric: bool = True, tension=None,
                        b_field=None):
    """Small-oscillation spectrum about an equilibrium (loaded, sagged,
    contacting, or a scene with ``rr`` and a rod-axis ``qe``): ``K_eff v =
    omega^2 M v`` with ``K_eff = -dQ/dqe`` the full balance Jacobian, host
    f64.  Returns ``omega2`` ascending (negative entries flag an unstable
    equilibrium) and, with ``modes=True``, the mass-orthonormal mode
    columns.  ``symmetric=False`` (non-conservative loads: follower tip
    forces, dead tip couples) eigendecomposes the full whitened operator,
    sorted by real part: complex pairs flag flutter."""
    _, m, k_eff, _ = _linearization(cfg, qe, tip_force, tip_moment, rr, base_positions, iters,
                                    tension, b_field)
    cinv, a = _whiten(m, k_eff)
    if symmetric:
        omega2, w = np.linalg.eigh(0.5 * (a + a.T))
    else:
        omega2, w = np.linalg.eig(a)
        order = np.argsort(omega2.real)
        omega2, w = omega2[order], w[:, order]
    if not modes:
        return omega2
    return omega2, cinv.T @ w


def _damping(cfg: DynamicsConfig, qe, m: np.ndarray, iters: int, scene_shape=None):
    """``C = damping M + kv_damping K_ee (+ the fluid drag's C_f)``, host f64,
    block-diagonal for a scene."""
    k_ee = np.asarray(cfg.k_ee, np.float64)
    if scene_shape is not None:
        k_ee = np.kron(np.eye(scene_shape[0]), k_ee)
    c = cfg.damping * m + cfg.kv_damping * k_ee
    if cfg.fluid_drag is not None:
        cf = _host(fluid_damping_matrix(qe, cfg, iters))
        c = c + (cf if scene_shape is None else _block_diagonal(cf))
    return c


def damped_spectrum(cfg: DynamicsConfig, qe=None, tip_force=None, tip_moment=None,
                    rr: RodRodContact | None = None, base_positions=None, iters: int = 24,
                    tension=None, b_field=None):
    """Complex poles of ``M qdd + C qd + K_eff dq = 0`` about an equilibrium
    (``C = damping M + kv_damping K_ee``, plus the fluid drag's
    :func:`fluid_damping_matrix`; ``K_eff`` as in
    :func:`linearized_spectrum`, scenes too): the ``2 nq`` eigenvalues of
    the companion matrix, host f64, sorted by ``|Im|``.  A pole with a
    positive real part flags flutter or divergence, damping included
    (Ziegler's paradox on Beck's column)."""
    qe, m, k_eff, scene_shape = _linearization(cfg, qe, tip_force, tip_moment, rr,
                                               base_positions, iters, tension, b_field)
    c = _damping(cfg, qe, m, iters, scene_shape)
    minv = np.linalg.inv(m)
    n = m.shape[0]
    comp = np.block([[np.zeros((n, n)), np.eye(n)], [-minv @ k_eff, -minv @ c]])
    poles = np.linalg.eigvals(comp)
    return poles[np.argsort(np.abs(poles.imag))]


def frequency_response(cfg: DynamicsConfig, omegas, drive_force=None, drive_moment=None,
                       qe=None, tip_force=None, tip_moment=None, iters: int = 24, tension=None,
                       b_field=None, observe: str = "tip"):
    """Linearized harmonic response about an equilibrium: ``A(omega) =
    (K_eff + i omega C - omega^2 M)^-1 f`` with ``M``, ``C``, ``K_eff`` as in
    :func:`damped_spectrum` and ``f`` the generalized force of the unit tip
    drive (``drive_force`` and/or ``drive_moment``), an exact difference of
    two balances at the same state (the loads are affine).  ``observe=
    'modes'``: ``(W, nq)`` complex strain amplitudes; ``'tip'``: ``(W, 3)``
    complex tip displacements through the tip Jacobian.  Host f64."""
    if drive_force is None and drive_moment is None:
        raise ValueError("give drive_force and/or drive_moment")
    if observe not in ("tip", "modes"):
        raise ValueError(f"observe must be 'tip' or 'modes', got {observe}")
    qe, m, k_eff, _ = _linearization(cfg, qe, tip_force, tip_moment, None, None, iters,
                                     tension, b_field)
    c = _damping(cfg, qe, m, iters)

    def vec(v):
        return (torch.zeros(3, dtype=qe.dtype, device=qe.device) if v is None
                else torch.as_tensor(v, dtype=qe.dtype, device=qe.device))

    residual = _balance_residual_fn(cfg, tip_force, tip_moment, iters, tension=tension,
                                    b_field=b_field)
    res_drive = _balance_residual_fn(cfg, vec(tip_force) + vec(drive_force),
                                     vec(tip_moment) + vec(drive_moment), iters,
                                     tension=tension, b_field=b_field)
    f = _host(res_drive(qe) - residual(qe))
    amps = np.stack([np.linalg.solve(k_eff + 1j * w * c - w * w * m, f)
                     for w in np.atleast_1d(np.asarray(omegas, np.float64))])
    if observe == "modes":
        return amps
    j_tip = _host(torch.func.jacfwd(lambda q_: cfg.state_full(q_, iters)[0][..., 0, :])(qe))
    return amps @ j_tip.T


def critical_load(cfg: DynamicsConfig, direction=(-1.0, 0.0, 0.0), load_hi: float = 30.0,
                  load_lo: float = 0.0, bisect_tol: float = 1e-2, iters: int = 24,
                  solve_equilibrium: bool = False, tip_moment=None, tension=None, b_field=None,
                  re_tol: float = 1e-8, statics_tol=1e-9, return_qe: bool = False):
    """Smallest load factor where the equilibrium path loses stability:
    bisection on ``max Re`` of the :func:`damped_spectrum` poles under
    ``tip_force = lambda direction`` (f64, on ``direction``'s device; body
    frame with ``cfg.statics.follower``), stable while ``max Re <= re_tol
    max(|poles|, 1)``.  One criterion for static divergence (Euler), flutter
    (Beck) and damped flutter (Ziegler).  ``solve_equilibrium=True`` tracks
    the loaded equilibrium with :func:`solve_contact_statics` (tol
    ``statics_tol``, warm-started up the path) instead of linearizing about
    the rest shape.  Raises when the bracket does not straddle the
    boundary; ``return_qe`` also returns the last stable equilibrium."""
    d = as_tensor(direction, torch.float64)
    qe_warm = _rest_strain(cfg, d)

    def unstable(lam, qe_start):
        qe_eq = qe_start
        if solve_equilibrium:
            qe_eq = solve_contact_statics(cfg, qe0=qe_start, tip_force=lam * d,
                                          tip_moment=tip_moment, tol=statics_tol, iters=iters,
                                          tension=tension, b_field=b_field).qe
        poles = damped_spectrum(cfg, qe=qe_eq, tip_force=lam * d, tip_moment=tip_moment,
                                iters=iters, tension=tension, b_field=b_field)
        scale = max(float(np.max(np.abs(poles))), 1.0)
        return bool(np.max(poles.real) > re_tol * scale), qe_eq

    u_lo, qe_lo = unstable(load_lo, qe_warm)
    if u_lo:
        raise ValueError(f"load_lo={load_lo} is already unstable")
    if not unstable(load_hi, qe_lo)[0]:
        raise ValueError(f"load_hi={load_hi} is still stable: widen the bracket")
    lo, hi, qe_warm = float(load_lo), float(load_hi), qe_lo
    while hi - lo > bisect_tol:
        mid = 0.5 * (lo + hi)
        u_mid, qe_mid = unstable(mid, qe_warm)
        if u_mid:
            hi = mid
        else:
            lo, qe_warm = mid, qe_mid
    lam_c = 0.5 * (lo + hi)
    return (lam_c, qe_warm) if return_qe else lam_c
