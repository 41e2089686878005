"""Cosserat/Kirchhoff rod statics BVP: Newton on the collocation residual.

Counterpart of the JAX package's ``models/cosserat.py``.  At every cross
section the constitutive moment balances the tip wrench ``(F, M)`` (and a
constant distributed force) transported to that section,

    H (kappa(X) - kappa0(X)) = R(X)^T [ (r(L) - r(X)) x F + M ],

projected onto the strain modes with Clenshaw-Curtis quadrature:
``res(qe) = int_0^L Phi^T { H (kappa - kappa0) - tau(X; qe) } dX = 0``.
``r`` and ``R`` come from the rod solves of :mod:`.rod`.

* :func:`solve_statics`: per-sample Newton on the torch path
  (``rod_shape`` 'picard' or 'dense'), with forward-mode Jacobians through
  the solve; the reference of the batched solver.
* :func:`solve_statics_batched`: Newton over the whole batch on the fused
  path.  Each step runs one K1 solve for the state and one K2 solve over
  the ``3 ne`` curvature directions stacked into the batch for the
  implicit-function tangents (:func:`_fused_state_and_tangents`); the
  residual map is plain torch, so its directional derivatives are
  ``torch.func.jvp``.

Both Newton loops take their step with ``torch.linalg.solve_ex`` (no host
sync).  The JAX package hand-rolled a Gauss-Jordan solve because the TPU's
batched LU was slow at ``nq x nq``; on an H100 the library solve is ~26x
faster than the port of that solve (``ops/smallsolve.py``) at ``(16384, 9, 9)``
(``chip_smoke.py`` times both).

Factories and non-tensor loads go to the default device, the card
(``ops/device.py``); torch tensors keep theirs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ops import basis as basis_ops
from ..ops import chebyshev
from ..ops import lie
from ..ops.device import as_tensor
from . import rod

__all__ = [
    "StaticsConfig",
    "StaticsSolution",
    "equilibrium_residual",
    "residual_and_jacobian_fused",
    "solve_statics",
    "solve_statics_batched",
]


@dataclass(frozen=True)
class StaticsConfig:
    """Rod grid plus the constitutive law and the loads that are not tip loads.

    ``stiffness``: the diagonal of ``H``, 3 entries for a Kirchhoff rod
    (``GJ, EI_y, EI_z``, ``rod.na == 3``) or 6 for a Reissner rod (``+ EA,
    GA_y, GA_z``, ``rod.na == 6``), or an ``(n, na)`` nested tuple of
    per-grid-point diagonals (a smooth profile ``H(X)``).  ``kappa0``: rest
    strain modes, same layout as ``qe``.  ``distributed_force``: constant
    force per unit length in the world frame.  ``follower``: the tip force
    is given in the tip's body frame and turns with it.
    """

    rod: rod.RodConfig = field(default_factory=lambda: rod.RodConfig(n=64))
    stiffness: tuple = (1.0, 1.0, 1.0)
    kappa0: tuple | None = None
    distributed_force: tuple | None = None
    follower: bool = False

    @functools.cached_property
    def full_basis_table(self) -> np.ndarray:
        """``(n, ne)`` basis table at ALL grid points, base included."""
        pts = tuple((self.rod.points / self.rod.length).tolist())
        return basis_ops.basis_table(pts, self.rod.ne, self.rod.basis)

    @functools.cached_property
    def quad_weights(self) -> np.ndarray:
        return chebyshev.clenshaw_curtis_weights(self.rod.n, self.rod.length)


class StaticsSolution(NamedTuple):
    qe: torch.Tensor             # (..., na*ne) converged strain modes
    iterations: torch.Tensor     # (...,) Newton iterations used
    residual_norm: torch.Tensor  # (...,) final ||res||_2
    converged: torch.Tensor      # (...,) bool
    qe_lo: torch.Tensor | None = None


@dataclass(frozen=True, eq=False)
class _Constants:
    table: torch.Tensor        # (n, ne) full-grid basis table
    weights: torch.Tensor      # (n,) Clenshaw-Curtis weights
    stiffness: torch.Tensor    # (na,) or (n, na)
    kappa0: torch.Tensor | None     # (n, na) rest strain field
    tail_op: torch.Tensor | None    # (n, n) partial-integral operator T
    tail_len: torch.Tensor     # (n,) L - x_i
    dist: torch.Tensor | None  # (3,) distributed force


@functools.lru_cache(maxsize=None)
def _constants(cfg: StaticsConfig, device: torch.device, dtype: torch.dtype) -> _Constants:
    rc = cfg.rod

    def dev(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    table = dev(cfg.full_basis_table)
    h = dev(cfg.stiffness)
    if h.shape[-1] != rc.na:
        raise ValueError(
            f"stiffness has {h.shape[-1]} entries but rod.na = {rc.na}; use 3 "
            "(Kirchhoff: GJ, EI_y, EI_z) or 6 (Reissner: + EA, GA_y, GA_z with "
            "rod.na = 6)")
    if h.ndim == 2 and h.shape[0] != rc.n:
        raise ValueError(f"stiffness profile has {h.shape[0]} rows but the rod grid "
                         f"has {rc.n} points")
    kappa0 = (None if cfg.kappa0 is None
              else basis_ops.strain_at_points(dev(cfg.kappa0), table))
    has_dist = cfg.distributed_force is not None
    return _Constants(
        table=table, weights=dev(cfg.quad_weights), stiffness=h, kappa0=kappa0,
        tail_op=dev(chebyshev.partial_integral_matrix(rc.n, rc.length)) if has_dist else None,
        tail_len=dev(rc.length - rc.points),
        dist=dev(cfg.distributed_force) if has_dist else None)


def _with_base(q: torch.Tensor, r: torch.Tensor):
    """Append the known base point (identity quaternion, origin): the
    descending grid's index n-1."""
    base_q = q.new_zeros(q.shape[:-2] + (1, 4))
    base_q[..., 0] = 1.0                                          # rod.DEFAULT_Q_INIT
    return (torch.cat([q, base_q], dim=-2),
            torch.cat([r, r.new_zeros(r.shape[:-2] + (1, 3))], dim=-2))


def _full_grid_state(rc: rod.RodConfig, qe: torch.Tensor, iters: int,
                     method: str = "picard"):
    """Kinematics on the FULL grid: the solved points plus the base point
    appended at the end.  ``method='dense'`` for strong curvature, where
    the Picard iteration diverges (``rho = |K| L/2 > ~5``)."""
    sol = rod.rod_shape(qe, cfg=rc, method=method, iters=iters)
    return _with_base(sol.quaternions, sol.positions)


def _auto_method(qe: torch.Tensor, rc: rod.RodConfig, rho_limit: float) -> str:
    """'picard' while the batch's max rho stays within ``rho_limit``, else
    'dense' (one value comes back to the host)."""
    return "picard" if rod.strain_rho(qe.detach(), rc) <= rho_limit else "dense"


def equilibrium_residual(qe, tip_force, tip_moment, cfg: StaticsConfig,
                         iters: int = 24, method: str = "picard",
                         auto_rho_limit: float = 5.0) -> torch.Tensor:
    """Modal moment-balance residual ``(..., na*ne)``, zero at equilibrium.

    ``method='auto'`` routes the whole batch to the dense solve when any
    sample's ``rho = max|K| L/2`` exceeds ``auto_rho_limit`` (the Picard
    kinematics degrade beyond ~5), else to Picard.
    """
    qe = as_tensor(qe)
    if method == "auto":
        method = _auto_method(qe, cfg.rod, auto_rho_limit)
    q, r = _full_grid_state(cfg.rod, qe, iters, method)
    return _residual_from_state(qe, q, r, tip_force, tip_moment, cfg)


def _residual_from_state(qe, q, r, tip_force, tip_moment, cfg: StaticsConfig):
    """The weak-form balance residual given the full-grid state ``q (..., n,
    4)``, ``r (..., n, 3)``: plain torch, so ``torch.func.jvp`` gives its
    tangents in ``(qe, q, r)``."""
    rc = cfg.rod
    c = _constants(cfg, qe.device, qe.dtype)
    kappa = basis_ops.strain_at_points(qe, c.table)               # (..., n, na)
    if c.kappa0 is not None:
        kappa = kappa - c.kappa0

    # Static moment about each section (world frame), then to the body frame
    # with the normalized rotation, in quaternion-vector form.
    arm = r[..., :1, :] - r                                      # tip is point 0
    tip_force = torch.as_tensor(tip_force, dtype=qe.dtype, device=qe.device)
    tip_moment = torch.as_tensor(tip_moment, dtype=qe.dtype, device=qe.device)
    if cfg.follower:
        tip_force = lie.quat_rotate_normalized(
            q[..., :1, :], tip_force.expand(arm[..., :1, :].shape))
    f = tip_force.expand(arm.shape)
    world_moment = lie.cross(arm, f) + tip_moment
    if c.dist is not None:
        # int_{x_i}^L (r(s) - r_i) x w ds = [(T r)_i - (L - x_i) r_i] x w
        dist_arm = torch.matmul(c.tail_op, r) - c.tail_len[:, None] * r
        world_moment = world_moment + lie.cross(dist_arm, c.dist.expand(dist_arm.shape))
    tau = lie.quat_rotate_inv_normalized(q, world_moment)
    if rc.na == 6:
        # Force rows: the internal force (tip force plus the distributed
        # tail) in the body frame; H_shear gamma = n.
        world_force = f if c.dist is None else f + c.tail_len[:, None] * c.dist
        tau = torch.cat([tau, lie.quat_rotate_inv_normalized(q, world_force)], dim=-1)

    # res[a, e] = sum_j w_j P_e(x_j) (H xi - tau)[j, a]
    mr = c.stiffness * kappa - tau
    res = torch.einsum("j,je,...ja->...ae", c.weights, c.table, mr)
    return res.reshape(res.shape[:-2] + (rc.na * rc.ne,))


def solve_statics(tip_force, tip_moment=(0.0, 0.0, 0.0),
                  cfg: StaticsConfig = StaticsConfig(), qe0=None,
                  tol: float = 1e-9, max_iter: int = 30, damping: float = 1.0,
                  iters: int = 24, method: str = "picard") -> StaticsSolution:
    """Per-sample Newton on :func:`equilibrium_residual` with forward-mode
    Jacobians through the torch rod solve.

    ``tip_force (..., 3)``: each sample iterates until its own residual norm
    is ``<= tol`` or it has taken ``max_iter`` steps (a sample that is done
    stops moving).  ``method='auto'`` routes the batch per iterate
    (:func:`equilibrium_residual`).  The JAX version's Armijo line search
    is not ported.
    """
    rc = cfg.rod
    nq = rc.na * rc.ne
    tip_force = as_tensor(tip_force)
    if tip_force.dtype not in (torch.float32, torch.float64):
        tip_force = tip_force.to(torch.float32)
    dtype, device = tip_force.dtype, tip_force.device
    tip_moment = torch.as_tensor(tip_moment, dtype=dtype, device=device)
    batch = tip_force.shape[:-1]
    qe = (torch.zeros(batch + (nq,), dtype=dtype, device=device) if qe0 is None
          else torch.as_tensor(qe0, dtype=dtype, device=device).expand(batch + (nq,)).clone())
    tf, tm = tip_force[..., None, :], (tip_moment if tip_moment.ndim == 1
                                        else tip_moment[..., None, :])

    def residual(q, m):
        return equilibrium_residual(q, tf, tm, cfg, iters, m)

    def jacobian(q, m):
        dirs = torch.eye(nq, dtype=dtype, device=device).reshape(
            (nq,) + (1,) * len(batch) + (nq,)).expand((nq,) + q.shape)
        jvp = torch.func.vmap(lambda t: torch.func.jvp(lambda x: residual(x, m), (q,), (t,))[1])
        return torch.movedim(jvp(dirs), 0, -1)            # (..., nq_out, nq_dir)

    def route(q):
        return _auto_method(q, rc, 5.0) if method == "auto" else method

    res = residual(qe, route(qe))
    k = torch.zeros(batch, dtype=torch.int32, device=device)
    for _ in range(max_iter):
        active = torch.linalg.vector_norm(res, dim=-1) > tol
        if not bool(active.any()):
            break
        step = _newton_step(jacobian(qe, route(qe)), res)
        new_qe = qe - damping * step
        new_res = residual(new_qe, route(new_qe))
        qe = torch.where(active[..., None], new_qe, qe)
        res = torch.where(active[..., None], new_res, res)
        k = k + active.to(torch.int32)
    rnorm = torch.linalg.vector_norm(res, dim=-1)
    return StaticsSolution(qe=qe, iterations=k, residual_norm=rnorm, converged=rnorm <= tol)


def _newton_step(jac: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``jac^-1 res``, batched over leading axes; no host sync."""
    return torch.linalg.solve_ex(jac, res.unsqueeze(-1))[0][..., 0]


def _fused_full_state(qe: torch.Tensor, rc: rod.RodConfig, iters: int):
    """Full-grid kinematics through K1 (demo BCs: the statics BVP anchors
    the base at identity/origin)."""
    from ..ops.kernels import rod_kernel as rk

    return _with_base(*rk.rod_shape_fused(qe, cfg=rc, iters=iters))


def _fused_state_and_tangents(qe: torch.Tensor, cfg: StaticsConfig, iters: int,
                              jac_iters: int | None = None):
    """Full-grid state and its tangents ``d(q, r)/d(qe_j)`` along every
    strain direction, by the implicit-function rule on the fused kernels:
    one K1 solve for the state, then ONE K2 solve over the ``nk = 3 ne``
    curvature directions stacked into the batch,
    ``(I ⊗ Dn_NN - 1/2 A_hat(K)) dq_j = 1/2 A(dK_j) q``.  Shear and
    extension directions (na=6) leave ``q`` alone.  ``jac_iters``: the
    Picard count of the direction solves (default ``iters``)."""
    from ..ops.kernels import rod_kernel as rk

    rc = cfg.rod
    b, nq = qe.shape
    ne, na, npts = rc.ne, rc.na, rc.n - 1
    nk = 3 * ne
    q_full, r_full = _fused_full_state(qe, rc, iters)
    q_unk = q_full[..., :npts, :]

    # Direction strain fields: dk_j[p] = P_e(x_p) on the (a, e) unit mode.
    table = rod._basis_table(rc, qe.device).to(qe.dtype)              # (npts, ne)
    eye_a = torch.eye(na, dtype=qe.dtype, device=qe.device)
    dk_dirs = torch.einsum("ab,pe->aepb", eye_a, table).reshape(nq, npts, na)
    dm = 0.5 * lie.quat_skew(dk_dirs[:nk, :, :3])                      # (nk, npts, 4, 4)
    rhs = torch.einsum("jice,bie->jbic", dm, q_unk)                    # (nk, B, npts, 4)
    dq_dirs = rk.picard_correction_fused(
        qe.repeat(nk, 1), rhs.reshape(nk * b, npts, 4), cfg=rc,
        iters=iters if jac_iters is None else jac_iters).reshape(nk, b, npts, 4)
    if nq > nk:
        dq_dirs = torch.cat([dq_dirs, dq_dirs.new_zeros((nq - nk, b, npts, 4))])

    # Position tangents dr = G db, db from the tangent map's jvp.
    if na == 6:
        gamma = basis_ops.strain_at_points(qe, table)[..., 3:]
        dgamma = dk_dirs[:, None, :, 3:].expand(nq, b, npts, 3)
        db = torch.func.vmap(lambda dq, dg: torch.func.jvp(
            lie.rod_tangent, (q_unk, gamma), (dq, dg))[1])(dq_dirs, dgamma)
    else:
        db = torch.func.vmap(lambda dq: torch.func.jvp(
            lie.quat_tangent, (q_unk,), (dq,))[1])(dq_dirs)
    ginv = rc.grid(qe.device).ginv.to(qe.dtype)
    dr_dirs = torch.matmul(ginv, db)
    return q_full, r_full, dq_dirs, dr_dirs


def _jvp_jacobian(f, qe, q_full, r_full, dq_dirs, dr_dirs):
    """``(res, jac)`` of the residual map ``f(qe, q, r)`` from precomputed
    state tangents: column ``j`` is the jvp along ``e_j`` with the matching
    kinematic tangents (the base point, which never moves, gets an exact
    zero).  ``jac``: ``(B, nq_out, nq_dir)``."""
    nq = qe.shape[-1]
    pad = (0, 0, 0, 1)
    dq_full = torch.nn.functional.pad(dq_dirs, pad)
    dr_full = torch.nn.functional.pad(dr_dirs, pad)
    dqe = torch.eye(nq, dtype=qe.dtype, device=qe.device)[:, None, :].expand(
        (nq,) + qe.shape)
    res = f(qe, q_full, r_full)
    dres = torch.func.vmap(
        lambda a, b, c: torch.func.jvp(f, (qe, q_full, r_full), (a, b, c))[1])(
            dqe, dq_full, dr_full)                                     # (nq, B, nq)
    return res, torch.movedim(dres, 0, -1)


def residual_and_jacobian_fused(qe, tip_force, tip_moment, cfg: StaticsConfig,
                                iters: int = 16, jac_iters: int | None = None):
    """Batched residual and per-sample Jacobian on the fused path:
    ``qe (B, nq)`` -> ``(res (B, nq), jac (B, nq, nq))``."""
    qe = as_tensor(qe, torch.float32)
    q_full, r_full, dq_dirs, dr_dirs = _fused_state_and_tangents(qe, cfg, iters, jac_iters)

    def f(qe_, q_, r_):
        return _residual_from_state(qe_, q_, r_, tip_force, tip_moment, cfg)

    return _jvp_jacobian(f, qe, q_full, r_full, dq_dirs, dr_dirs)


def solve_statics_batched(tip_force, tip_moment=None,
                          cfg: StaticsConfig = StaticsConfig(), qe0=None,
                          tol: float = 1e-5, max_iter: int = 12,
                          damping: float = 1.0, iters: int = 16,
                          dd_residual: bool = False, jac_iters: int = 8,
                          jac_precision: str = "default") -> StaticsSolution:
    """Newton over the whole batch on the fused kernels.

    ``tip_force (B, 3)`` -> converged strains ``(B, nq)``.  Each step is one
    K1 solve plus one direction-stacked K2 solve over the batch
    (:func:`residual_and_jacobian_fused`) and a batched library solve; the
    batch iterates until every sample's residual norm is ``<= tol`` (samples
    that are done stop moving) or ``max_iter`` steps.  The iterate is kept in
    float64 and rounded to f32 for the kernels.  ``jac_iters`` Picard steps
    for the direction solves (Newton tolerates a ~1e-3-grade Jacobian).

    ``jac_precision`` and ``dd_residual`` exist so that calls written for the
    JAX API run unchanged: every ``jac_precision`` of the JAX package is
    accepted and runs as plain FP32 on the card, and ``dd_residual=True``
    raises until the double-word residual is ported.
    """
    from ..ops.kernels import rod_kernel as rk

    if jac_precision not in rk.PRECISIONS:
        raise ValueError(f"jac_precision must be one of {rk.PRECISIONS}, got {jac_precision!r}")
    if dd_residual:
        raise NotImplementedError(
            "dd_residual needs equilibrium_residual_dd, not ported yet: "
            "ROADMAP.md Queue 1 item 7")
    tip_force = as_tensor(tip_force, torch.float32)
    device = tip_force.device
    b, nq = tip_force.shape[0], cfg.rod.na * cfg.rod.ne
    tip_moment = (torch.zeros(3, device=device) if tip_moment is None
                  else torch.as_tensor(tip_moment, dtype=torch.float32, device=device))
    qe = (torch.zeros((b, nq), dtype=torch.float64, device=device) if qe0 is None
          else torch.as_tensor(qe0, device=device).to(torch.float64).expand(b, nq).clone())
    tf = tip_force[:, None, :]
    tm = tip_moment if tip_moment.ndim == 1 else tip_moment[:, None, :]

    def res_jac(q64):
        return residual_and_jacobian_fused(q64.to(torch.float32), tf, tm, cfg, iters=iters,
                                           jac_iters=jac_iters)

    res, jac = res_jac(qe)
    k = 0
    while k < max_iter:
        active = torch.linalg.vector_norm(res, dim=-1) > tol
        if not bool(active.any()):
            break
        step = _newton_step(jac, res)
        qe = qe - torch.where(active[:, None], damping * step, 0.0).to(torch.float64)
        res, jac = res_jac(qe)
        k += 1
    rnorm = torch.linalg.vector_norm(res, dim=-1)
    return StaticsSolution(qe=qe.to(torch.float32),
                           iterations=torch.tensor(k, dtype=torch.int32, device=device),
                           residual_norm=rnorm, converged=rnorm <= tol)
