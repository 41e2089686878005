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
  the solve (the Picard solve's implicit-function rule,
  ``ops/collocation.solve_ivp_picard_implicit``), optionally globalized by
  an Armijo line search; the reference of the batched solvers.
* :func:`solve_statics_batched`: Newton over the whole batch on the fused
  path.  Each step runs one K1 solve for the state and one K2 solve over
  the ``3 ne`` curvature directions stacked into the batch for the
  implicit-function tangents (:func:`_fused_state_and_tangents`); the
  residual map is plain torch, so its directional derivatives are
  ``torch.func.jvp``.  ``dd_residual=True`` takes the convergence residual
  from :func:`equilibrium_residual_dd`: the K3 kinematics and FP64
  transports, for tolerances down to ~1e-9.
* :func:`solve_statics_differentiable`: the equilibrium as a function of
  the loads, differentiable by the implicit-function rule at the solution.
* Continuation: :func:`load_continuation` (warm-started Newton over a load
  schedule), :func:`arc_length_continuation` (the host f64 Riks walker
  that passes limit points) and :func:`arc_length_continuation_batched`
  (Riks over a batch of load rays, each corrector iterate one K1 + K2
  evaluation over the batch, K3 too with ``dd_residual``).

The Newton loops take their step with ``torch.linalg.solve_ex`` (no host
sync).  The JAX package hand-rolled a Gauss-Jordan solve because the TPU's
batched LU was slow at ``nq x nq``; on an H100 the library solve was 26-31x
faster than a port of that solve at ``(16384, 9, 9)``, which was then removed.

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
from ..ops import doubledouble as dd
from ..ops import lie
from ..ops.device import as_tensor, cached_constants, locked_jacfwd, locked_jvp
from . import rod

__all__ = [
    "StaticsConfig",
    "StaticsSolution",
    "stiffness_profile",
    "equilibrium_residual",
    "equilibrium_residual_dd",
    "residual_and_jacobian_fused",
    "solve_statics",
    "solve_statics_differentiable",
    "solve_statics_batched",
    "arc_length_continuation",
    "arc_length_continuation_batched",
    "ContinuationPath",
    "BatchedContinuationPath",
    "load_continuation",
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


def stiffness_profile(fn, rc: rod.RodConfig) -> tuple:
    """Freeze a smooth constitutive profile ``H(X)`` into the ``(n, na)``
    nested tuple a :class:`StaticsConfig` takes (hashable, and an exact f64
    table for the FP64 residual).  ``fn`` maps the normalized arclength
    ``X (n,)`` of the descending grid (tip to base) to ``(n, na)``
    per-point diagonals."""
    xs = np.asarray(rc.points, np.float64) / rc.length
    h = np.asarray(fn(xs), np.float64)
    if h.ndim != 2 or h.shape != (rc.n, rc.na):
        raise ValueError(f"profile fn returned {h.shape}, need ({rc.n}, {rc.na})")
    return tuple(map(tuple, h.tolist()))


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


@cached_constants
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

    return _weak_form(c, c.stiffness * kappa - tau)


def _weak_form(c: _Constants, mr: torch.Tensor) -> torch.Tensor:
    """``res[a, e] = sum_j w_j P_e(x_j) mr[j, a]``, flattened mode-major."""
    res = torch.einsum("j,je,...ja->...ae", c.weights, c.table, mr)
    return res.reshape(res.shape[:-2] + (res.shape[-2] * res.shape[-1],))


def solve_statics(tip_force, tip_moment=(0.0, 0.0, 0.0),
                  cfg: StaticsConfig = StaticsConfig(), qe0=None,
                  tol: float = 1e-9, max_iter: int = 30, damping: float = 1.0,
                  iters: int = 24, method: str = "picard",
                  line_search: bool = False) -> StaticsSolution:
    """Per-sample Newton on :func:`equilibrium_residual` with forward-mode
    Jacobians through the torch rod solve.

    ``tip_force (..., 3)``: each sample iterates until its own residual norm
    is ``<= tol`` or it has taken ``max_iter`` steps (a sample that is done
    stops moving).  ``method='auto'`` routes the batch per iterate
    (:func:`equilibrium_residual`).  ``line_search=True``: a backtracking
    Armijo search over the step fractions ``{1, 1/2, ..., 1/16}``, which
    widens the cold-start convergence radius several-fold (a transverse tip
    load of 12 EI/L^2 converges from zero, where full steps wander).  The
    current iterate rides along as candidate 0, so that all six residuals
    come from ONE call, routed together under ``method='auto'``; the
    candidate axis leads the batch axes.
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
    alphas = torch.tensor([0.0, 1.0, 0.5, 0.25, 0.125, 0.0625], dtype=dtype,
                          device=device).reshape((6,) + (1,) * (len(batch) + 1))

    def residual(q, m):
        return equilibrium_residual(q, tf, tm, cfg, iters, m)

    def route(q):
        return _auto_method(q, rc, 5.0) if method == "auto" else method

    def armijo(q, step):
        """The first candidate with sufficient decrease, else the smallest
        residual: ``(qe, res)`` for each sample."""
        cand = q - damping * alphas * step
        res_c = residual(cand, route(cand))
        norms = torch.linalg.vector_norm(res_c, dim=-1)           # (6, ...)
        ok = norms[1:] < (1.0 - 1e-4 * alphas[1:, ..., 0]) * norms[0]
        idx = 1 + torch.where(ok.any(0), ok.int().argmax(0), norms[1:].argmin(0))
        pick = idx[None, ..., None]
        return (torch.take_along_dim(cand, pick, dim=0)[0],
                torch.take_along_dim(res_c, pick, dim=0)[0])

    res = residual(qe, route(qe))
    k = torch.zeros(batch, dtype=torch.int32, device=device)
    for _ in range(max_iter):
        active = torch.linalg.vector_norm(res, dim=-1) > tol
        if not bool(active.any()):
            break
        m = route(qe)
        step = _newton_step(_per_sample_jacobian(lambda q: residual(q, m), qe), res)
        if line_search:
            new_qe, new_res = armijo(qe, step)
        else:
            new_qe = qe - damping * step
            new_res = residual(new_qe, route(new_qe))
        qe = torch.where(active[..., None], new_qe, qe)
        res = torch.where(active[..., None], new_res, res)
        k = k + active.to(torch.int32)
    rnorm = torch.linalg.vector_norm(res, dim=-1)
    return StaticsSolution(qe=qe, iterations=k, residual_norm=rnorm, converged=rnorm <= tol)


def _refined_state(qe, rc: rod.RodConfig, iters: int, refine_steps: int):
    """The refined kinematics in f64 on the FULL grid, and the strain in
    f64.  ``refine_steps=1`` is one K3 launch with its rho sentinel on: a
    rod whose ``max|K| L/2`` exceeds 5 comes back NaN, and nothing syncs
    the host.  Other counts run the staged path (K2 solves around FP64
    residuals), poisoned the same way."""
    hi, lo = rod._as_dd_input(qe)
    qe64 = hi.to(torch.float64) if lo is None else dd.join_f64(hi, lo)
    batch, nq = hi.shape[:-1], hi.shape[-1]
    hi = hi.reshape(-1, nq)
    lo = None if lo is None else lo.reshape(-1, nq)
    if refine_steps == 1:
        from ..ops.kernels import refined_kernel as rfk

        q_hi, q_lo, r_hi, r_lo = rfk.rod_shape_refined_kernel(hi, lo, cfg=rc, iters=iters,
                                                              corr_iters=iters)
        q, r = dd.join_f64(q_hi, q_lo), dd.join_f64(r_hi, r_lo)
    else:
        sol = rod.rod_shape_refined_fused(hi if lo is None else (hi, lo), cfg=rc, iters=iters,
                                          refine_steps=refine_steps, single_kernel=False,
                                          check_validity=False)
        k = rod.curvature_at_points(rc, qe64.reshape(-1, nq))[..., :3]
        bad = torch.linalg.vector_norm(k, dim=-1).amax(-1) * rc.length / 2.0 > 5.0
        q = sol.quaternions_f64().masked_fill(bad[:, None, None], float("nan"))
        r = sol.positions_f64()
    q, r = _with_base(q.reshape(batch + q.shape[1:]), r.reshape(batch + r.shape[1:]))
    return qe64, q, r


def equilibrium_residual_dd(qe, tip_force, tip_moment, cfg: StaticsConfig,
                            iters: int = 24, refine_steps: int = 1) -> torch.Tensor:
    """The balance residual at f64 grade, for Newton tolerances down to
    ~1e-9 (the f32 residual floors near 1e-6 from the O(1) terms it
    cancels).  The JAX package evaluates it in double-word f32 around its
    refined kinematics; here the kinematics are the K3 kernel
    (:func:`_refined_state`) and every transport and sum is FP64.

    ``qe (..., nq)`` may be an f32 pair ``(hi, lo)`` or f64; ``tip_force``
    and ``tip_moment`` ``(..., 3)`` (no point axis) may be pairs or f64 too,
    as the dd Riks corrector passes ``lam ⊗ load_ref``.  The body
    transports use the unnormalized ``R(q)`` of the refined quaternions
    (``||q| - 1| ~ 1e-12``), as in the JAX package; a follower force turns
    with the tip's f64 rotation.  ``refine_steps``: the kinematics'
    refinement steps; the default 1 is the single K3 launch (one refinement
    already meets the f64 dense solve to ~1e-13, so the JAX default of 2
    buys nothing), and other counts run the staged path.  A rod outside
    K3's domain (rho > 5) gets a NaN residual.  Returns f32 ``(..., nq)``.
    """
    rc = cfg.rod
    qe64, q, r = _refined_state(qe, rc, iters, refine_steps)
    device = q.device
    c = _constants(cfg, device, torch.float64)
    xi = basis_ops.strain_at_points(qe64, c.table)
    if c.kappa0 is not None:
        xi = xi - c.kappa0

    tf, tm = dd.as_f64(tip_force, device), dd.as_f64(tip_moment, device)
    rot = lie.quat_to_rot(q)                                     # R^T v: contract rows
    if cfg.follower:
        tf = torch.einsum("...ij,...j->...i", rot[..., 0, :, :], tf)
    arm = r[..., :1, :] - r
    f = tf[..., None, :].expand(arm.shape)
    world_moment = lie.cross(arm, f) + tm[..., None, :]
    if c.dist is not None:
        dist_arm = torch.matmul(c.tail_op, r) - c.tail_len[:, None] * r
        world_moment = world_moment + lie.cross(dist_arm, c.dist.expand(dist_arm.shape))
    tau = torch.einsum("...ji,...j->...i", rot, world_moment)
    if rc.na == 6:
        world_force = f if c.dist is None else f + c.tail_len[:, None] * c.dist
        tau = torch.cat([tau, torch.einsum("...ji,...j->...i", rot, world_force)], dim=-1)
    return _weak_form(c, c.stiffness * xi - tau).to(torch.float32)


def _per_sample_jacobian(res, q: torch.Tensor, chunk_size: int | None = None) -> torch.Tensor:
    """``d res / d q`` per sample, ``(..., n_out, nq)``, for a residual whose
    samples depend on their own strains only: one jvp per unit direction
    shared by the batch, ``chunk_size`` directions at a time (default all)."""
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    cols = torch.func.vmap(lambda e: locked_jvp(res, (q,), (e.expand(q.shape),))[1],
                           chunk_size=chunk_size)(eye)
    return torch.movedim(cols, 0, -1)


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
        db = lie.rod_tangent_jvp(q_unk, dq_dirs, gamma, dgamma)
    else:
        db = lie.rod_tangent_jvp(q_unk, dq_dirs)
    ginv = rc.grid(qe.device).ginv.to(qe.dtype)
    dr_dirs = torch.matmul(ginv, db)
    return q_full, r_full, dq_dirs, dr_dirs


def jvp_columns(f, primals: tuple, tangents: tuple):
    """``(f(*primals), jac)``: column ``j`` of ``jac`` is the jvp of ``f``
    along the ``j``-th entry of every tangent stack (each ``tangents[i]`` is
    ``primals[i]``'s shape with a leading direction axis).  ``jac``:
    ``(..., n_out, n_dir)``."""
    res = f(*primals)
    dres = torch.func.vmap(lambda *t: locked_jvp(f, primals, t)[1])(*tangents)
    return res, torch.movedim(dres, 0, -1)


def _jvp_jacobian(f, qe, q_full, r_full, dq_dirs, dr_dirs):
    """``(res, jac)`` of the residual map ``f(qe, q, r)`` from precomputed
    state tangents: column ``j`` is the jvp along ``e_j`` with the matching
    kinematic tangents (the base point, which never moves, gets an exact
    zero).  ``jac``: ``(B, nq_out, nq_dir)``."""
    nq = qe.shape[-1]
    pad = (0, 0, 0, 1)
    dqe = torch.eye(nq, dtype=qe.dtype, device=qe.device)[:, None, :].expand(
        (nq,) + qe.shape)
    return jvp_columns(f, (qe, q_full, r_full),
                       (dqe, torch.nn.functional.pad(dq_dirs, pad),
                        torch.nn.functional.pad(dr_dirs, pad)))


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
                          dd_residual: bool = False, dd_iters: int = 24,
                          refine_steps: int = 1, jac_iters: int = 8,
                          jac_precision: str = "default") -> StaticsSolution:
    """Newton over the whole batch on the fused kernels.

    ``tip_force (B, 3)`` -> converged strains ``(B, nq)``.  Each step is one
    K1 solve plus one direction-stacked K2 solve over the batch
    (:func:`residual_and_jacobian_fused`) and a batched library solve; the
    batch iterates until every sample's residual norm is ``<= tol`` (samples
    that are done stop moving) or ``max_iter`` steps.  The iterate is kept in
    float64 and rounded to f32 for the kernels.  ``jac_iters`` Picard steps
    for the direction solves (Newton tolerates a ~1e-3-grade Jacobian).

    ``dd_residual=True`` takes the convergence residual from
    :func:`equilibrium_residual_dd` (K3, ``dd_iters`` Picard steps,
    ``refine_steps``) and keeps the f32 Jacobian, which makes tolerances
    down to ~1e-9 meaningful; the strains then come back as an f32 pair
    (``qe``, ``qe_lo``).  A sample outside K3's domain has a NaN residual:
    it stops moving and comes back ``converged=False``.

    ``jac_precision`` exists so that calls written for the JAX API run
    unchanged: every ``jac_precision`` of the JAX package is accepted and
    runs as plain FP32 on the card.
    """
    from ..ops.kernels import rod_kernel as rk

    if jac_precision not in rk.PRECISIONS:
        raise ValueError(f"jac_precision must be one of {rk.PRECISIONS}, got {jac_precision!r}")
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
        res, jac = residual_and_jacobian_fused(q64.to(torch.float32), tf, tm, cfg, iters=iters,
                                               jac_iters=jac_iters)
        if dd_residual:
            res = equilibrium_residual_dd(dd.split_f64(q64), tip_force, tip_moment, cfg,
                                          iters=dd_iters, refine_steps=refine_steps)
        return res, jac

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
    hi, lo = dd.split_f64(qe) if dd_residual else (qe.to(torch.float32), None)
    return StaticsSolution(qe=hi, iterations=torch.tensor(k, dtype=torch.int32, device=device),
                           residual_norm=rnorm, converged=rnorm <= tol, qe_lo=lo)


class _StaticsIFT(torch.autograd.Function):
    """``loads -> qe*`` with the implicit-function rule at the solution,
    ``dqe* = -J^-1 (d res / d loads) dloads`` (JAX: a ``custom_jvp``, whose
    transpose gives its ``grad``; here ``jvp`` and ``backward`` are both
    written).  ``J^-1`` is applied as a matrix, solved against the
    identity, as the JAX rule does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(tip_force, tip_moment, cfg, tol, max_iter, iters):
        return solve_statics(tip_force, tip_moment, cfg, tol=tol, max_iter=max_iter,
                             iters=iters).qe

    @staticmethod
    def setup_context(ctx, inputs, output):
        tip_force, tip_moment, cfg, _, _, iters = inputs
        ctx.cfg, ctx.iters = cfg, iters
        ctx.save_for_backward(tip_force, tip_moment, output)
        ctx.save_for_forward(tip_force, tip_moment, output)

    @staticmethod
    def _parts(ctx):
        """``(res_loads, J^-1)`` at the saved solution."""
        f, m, qe = ctx.saved_tensors

        def res(q, f_, m_):
            return equilibrium_residual(q, f_[..., None, :], m_[..., None, :], ctx.cfg,
                                        ctx.iters)

        jac = _per_sample_jacobian(lambda q: res(q, f, m), qe)
        eye = torch.eye(qe.shape[-1], dtype=qe.dtype, device=qe.device).expand(jac.shape)
        return (lambda f_, m_: res(qe, f_, m_)), torch.linalg.solve(jac, eye)

    @staticmethod
    def jvp(ctx, d_force, d_moment, *_):
        f, m, _ = ctx.saved_tensors
        res_loads, jinv = _StaticsIFT._parts(ctx)
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in ((f, d_force), (m, d_moment)))
        dres = locked_jvp(res_loads, (f, m), tangents)[1]
        return -torch.einsum("...ij,...j->...i", jinv, dres)

    @staticmethod
    def backward(ctx, g):
        f, m, _ = ctx.saved_tensors
        res_loads, jinv = _StaticsIFT._parts(ctx)
        _, vjp = torch.func.vjp(res_loads, f, m)
        g_force, g_moment = vjp(-torch.einsum("...ji,...j->...i", jinv, g))
        return g_force, g_moment, None, None, None, None


def solve_statics_differentiable(tip_force, tip_moment, cfg: StaticsConfig = StaticsConfig(),
                                 tol: float = 1e-9, max_iter: int = 30,
                                 iters: int = 24) -> torch.Tensor:
    """``(tip_force, tip_moment) -> qe*`` with exact load sensitivities.

    :func:`solve_statics` iterates on the host, which no autodiff mode can
    differentiate; this function attaches the implicit-function rule at the
    solution instead, ``dqe* = -J^-1 (d res/d loads) dloads`` with ``J =
    d res/d qe`` there, so ``torch.func.jvp``/``jacfwd`` and
    ``torch.autograd.grad`` through functionals of the equilibrium
    (compliance, design sensitivities, inverse statics) all work.  Loads
    ``(..., 3)``, each sample its own Newton (batch them this way, not
    with ``torch.func.vmap``).  Returns ``qe*``; feed it to
    ``rod.rod_shape(method='picard')`` for differentiable kinematics.
    """
    tip_force = as_tensor(tip_force)
    tip_moment = torch.as_tensor(tip_moment, dtype=tip_force.dtype, device=tip_force.device)
    return _StaticsIFT.apply(tip_force, tip_moment, cfg, tol, max_iter, iters)


def load_continuation(tip_forces, tip_moments=None, cfg: StaticsConfig = StaticsConfig(),
                      qe0=None, **newton_kwargs) -> list:
    """Sweep a load schedule, each Newton solve warm-started from the last
    converged strain (BASELINE config #5's continuation pattern).

    ``tip_forces (num_steps, ..., 3)``; returns one :class:`StaticsSolution`
    per step from :func:`solve_statics` (``newton_kwargs`` go to it)."""
    tip_forces = as_tensor(tip_forces)
    if tip_moments is None:
        tip_moments = torch.zeros_like(tip_forces)
    tip_moments = torch.as_tensor(tip_moments, dtype=tip_forces.dtype, device=tip_forces.device)
    sols, qe = [], qe0
    for i in range(tip_forces.shape[0]):
        sol = solve_statics(tip_forces[i], tip_moments[i], cfg, qe0=qe, **newton_kwargs)
        sols.append(sol)
        qe = sol.qe
    return sols


class ContinuationPath(NamedTuple):
    """Solution path from :func:`arc_length_continuation`: ``lambdas
    (steps,)``, ``qes (steps, nq)``, ``converged (steps,)``.  A decreasing
    stretch of ``lambdas`` is a passed limit point (fold), which no
    load-stepped Newton can traverse."""

    lambdas: torch.Tensor
    qes: torch.Tensor
    converged: torch.Tensor


def _riks_machinery(res, nq: int, tol: float, max_corrector: int, psi: float):
    """The (tangent, corrector) pair of a pseudo-arclength walk on the host.

    ``res(qe, lam) -> (nq,)`` must be affine in ``lam`` (dead and follower
    tip loads both are), so ``d res/d lam = res(qe, 1) - res(qe, 0)``
    exactly.  The Jacobians are ``torch.func.jacfwd`` through the rod solve
    (the Picard solve's implicit-function rule).  Shared with
    ``bifurcation.switch_branch``."""

    def tangent(qe, lam, t_prev):
        j = locked_jacfwd(res)(qe, lam)
        dqe = torch.linalg.solve(j, res(qe, 0.0) - res(qe, 1.0))
        t = torch.cat([dqe, dqe.new_ones(1)]) / torch.sqrt(torch.sum(dqe * dqe) + psi ** 2)
        # orientation continuity: keep walking the same way along the path
        return torch.where(torch.sum(t * t_prev) < 0, -t, t)

    def corrector(x_pred, t):
        def aug(x):
            c = (torch.sum(t[:nq] * (x[:nq] - x_pred[:nq]))
                 + psi ** 2 * t[nq] * (x[nq] - x_pred[nq]))
            return torch.cat([res(x[:nq], x[nq]), c[None]])

        x, a = x_pred, aug(x_pred)
        for _ in range(max_corrector):
            if not float(torch.linalg.vector_norm(a)) > tol:
                break
            x = x - torch.linalg.solve(locked_jacfwd(aug)(x), a)
            a = aug(x)
        return x, bool(torch.linalg.vector_norm(a) <= tol)

    return tangent, corrector


def _riks_walk(tangent, corrector, x, t, ds: float, steps: int) -> ContinuationPath:
    """Host predictor-corrector loop with adaptive arc steps: halve on a
    corrector failure (up to 8 times), recover gently after a success."""
    nq = x.shape[0] - 1
    lambdas, qes, conv = [], [], []
    ds_k = ds
    for _ in range(steps):
        ok = False
        for _attempt in range(8):
            x_new, ok = corrector(x + ds_k * t, t)
            if ok:
                break
            ds_k *= 0.5
        if ok:
            x = x_new
            t = tangent(x[:nq], x[nq], t)
            ds_k = min(ds, ds_k * 1.5)
        lambdas.append(x[nq])
        qes.append(x[:nq])
        conv.append(ok)
    return ContinuationPath(lambdas=torch.stack(lambdas), qes=torch.stack(qes),
                            converged=torch.tensor(conv, device=x.device))


def arc_length_continuation(load_ref, cfg: StaticsConfig = StaticsConfig(),
                            tip_moment_ref=(0.0, 0.0, 0.0), qe0=None,
                            ds: float = 0.2, steps: int = 40, tol: float = 1e-8,
                            max_corrector: int = 25, psi: float = 1.0, iters: int = 24,
                            method: str = "picard", lambda_start: float = 0.0,
                            direction: float = 1.0) -> ContinuationPath:
    """Riks (arc-length) continuation of ``res(qe, lambda * load_ref) = 0``.

    Newton on the system augmented with the normal-plane constraint ``t .
    (x - x_pred) = 0`` parameterizes the path by arc length instead of the
    load factor, so it walks through limit points where every
    load-controlled Newton jumps branches or fails.  ``psi`` weights the
    load factor in the arc metric; ``direction=-1`` starts with a
    decreasing load factor; ``lambda_start`` anchors the path (the anchor
    is converged by :func:`solve_statics` from ``qe0``).  One path, on the
    host, in the loads' dtype (f64 for the reference walks).
    """
    rc = cfg.rod
    nq = rc.na * rc.ne
    load_ref = as_tensor(load_ref)
    if load_ref.dtype not in (torch.float32, torch.float64):
        load_ref = load_ref.to(torch.float32)
    dtype, device = load_ref.dtype, load_ref.device
    tip_moment_ref = torch.as_tensor(tip_moment_ref, dtype=dtype, device=device)
    if qe0 is None:
        qe0 = torch.zeros(nq, dtype=dtype) if cfg.kappa0 is None else cfg.kappa0
    qe0 = torch.as_tensor(qe0, dtype=dtype, device=device)

    def res(qe, lam):
        return equilibrium_residual(qe, lam * load_ref, lam * tip_moment_ref, cfg, iters, method)

    tangent, corrector = _riks_machinery(res, nq, tol, max_corrector, psi)
    sol0 = solve_statics(lambda_start * load_ref, lambda_start * tip_moment_ref, cfg, qe0=qe0,
                         tol=tol, max_iter=max_corrector, iters=iters, method=method)
    x = torch.cat([sol0.qe, torch.full((1,), lambda_start, dtype=dtype, device=device)])
    t_prev = torch.zeros(nq + 1, dtype=dtype, device=device)
    t_prev[nq] = float(direction)
    return _riks_walk(tangent, corrector, x, tangent(x[:nq], x[nq], t_prev), ds, steps)


class BatchedContinuationPath(NamedTuple):
    """Per-sample paths from :func:`arc_length_continuation_batched`:
    ``lambdas (steps, B)``, ``qes (steps, B, nq)``, ``converged (steps,
    B)``.  ``False`` means the sample spent that step halving its arc
    length (its row repeats the previous state).  With
    ``monitor_stability``, ``det_sign``/``log_abs_det (steps, B)`` of the
    equilibrium Jacobian at each point (``torch.linalg.slogdet``): a sign
    change between converged rows brackets a fold or an odd-multiplicity
    branch point (``bifurcation.detect_critical_points`` refines them).
    dd walks return the low words in ``qes_lo``/``lambdas_lo``."""

    lambdas: torch.Tensor
    qes: torch.Tensor
    converged: torch.Tensor
    det_sign: torch.Tensor | None = None
    log_abs_det: torch.Tensor | None = None
    qes_lo: torch.Tensor | None = None
    lambdas_lo: torch.Tensor | None = None


def _riks_res_jac_slope_fused(qe, lam, load_refs, moment_refs, cfg: StaticsConfig,
                              iters: int):
    """``(res, jac, res_lam)`` at per-sample load factors from ONE fused
    state-and-tangents evaluation (K1 + K2): ``qe (B, nq)``, ``lam (B,)``,
    ``load_refs``/``moment_refs (B, 1, 3)``.  The residual is affine in the
    load, so its slope is two more residual maps on the same state."""
    q_full, r_full, dq_dirs, dr_dirs = _fused_state_and_tangents(qe, cfg, iters)
    tf, tm = lam[:, None, None] * load_refs, lam[:, None, None] * moment_refs

    def f(qe_, q_, r_):
        return _residual_from_state(qe_, q_, r_, tf, tm, cfg)

    res, jac = _jvp_jacobian(f, qe, q_full, r_full, dq_dirs, dr_dirs)
    res1 = _residual_from_state(qe, q_full, r_full, load_refs, moment_refs, cfg)
    res0 = _residual_from_state(qe, q_full, r_full, torch.zeros_like(load_refs),
                                torch.zeros_like(moment_refs), cfg)
    return res, jac, res1 - res0


def _batched_riks_engine(load_refs, moment_refs, cfg: StaticsConfig, x, t0, keller_init: bool,
                         ds: float, steps: int, tol: float, max_corrector: int, psi: float,
                         iters: int, monitor_stability: bool, dd_residual: bool,
                         dd_iters: int, refine_steps: int) -> BatchedContinuationPath:
    """The batched Riks predictor-corrector walk, shared by
    :func:`arc_length_continuation_batched` (``keller_init``: the first
    tangent from the bordered system at the anchor) and
    ``bifurcation.switch_branch_batched`` (``t0`` is the first tangent: the
    bordered system is singular at a branch point).

    ``x (B, nq+1)`` f64, ``[qe, lam]``; the iterate stays f64 (the JAX
    package's double-word pair) and is rounded to f32 for the kernels.
    Each corrector iterate is one K1 + K2 evaluation over the batch and one
    batched solve of the ``(nq+1)`` bordered systems, plus, with
    ``dd_residual``, the K3 residual at ``lam ⊗ load_ref`` taken in f64 (an
    f32 word times an f32 word is exact in f64).  A sample whose corrector
    fails halves its arc step and repeats its row."""
    b = load_refs.shape[0]
    nq = cfg.rod.na * cfg.rod.ne
    lref, mref = load_refs[:, None, :], moment_refs[:, None, :]
    e_last = torch.zeros((b, nq + 1), dtype=torch.float32, device=x.device)
    e_last[:, nq] = 1.0

    def bordered(jac, res_lam, t):
        top = torch.cat([jac, res_lam[:, :, None]], dim=2)
        border = torch.cat([t[:, None, :nq], (psi ** 2 * t[:, nq])[:, None, None]], dim=2)
        return torch.cat([top, border], dim=1)                   # (B, nq+1, nq+1)

    def unit(t):
        return t / torch.sqrt(torch.sum(t[:, :nq] ** 2, dim=1) + psi ** 2 * t[:, nq] ** 2)[:, None]

    def aug_and_jac(x_, x_pred, t):
        qe, lam = x_[:, :nq].to(torch.float32), x_[:, nq].to(torch.float32)
        res, jac, res_lam = _riks_res_jac_slope_fused(qe, lam, lref, mref, cfg, iters)
        if dd_residual:
            lam64 = x_[:, nq:]
            res = equilibrium_residual_dd(dd.split_f64(x_[:, :nq]), lam64 * load_refs.double(),
                                          lam64 * moment_refs.double(), cfg, iters=dd_iters,
                                          refine_steps=refine_steps)
        dx = x_ - x_pred
        t64 = t.double()
        c = torch.sum(t64[:, :nq] * dx[:, :nq], dim=1) + psi ** 2 * t64[:, nq] * dx[:, nq]
        return torch.cat([res, c[:, None].float()], dim=1), bordered(jac, res_lam, t)

    def corrector(x_pred, t):
        x_ = x_pred
        aug, jac_aug = aug_and_jac(x_, x_pred, t)
        for _ in range(max_corrector):
            active = torch.linalg.vector_norm(aug, dim=1) > tol
            if not bool(active.any()):
                break
            step = _newton_step(jac_aug, aug)
            x_ = x_ - torch.where(active[:, None], step, 0.0).double()
            aug, jac_aug = aug_and_jac(x_, x_pred, t)
        return x_, torch.linalg.vector_norm(aug, dim=1) <= tol, jac_aug

    if keller_init:
        # [J, res_lam; t_prev-row] t = e_last: well-conditioned through
        # folds, and t_prev . t = 1 > 0 keeps the orientation.
        _, jac, res_lam = _riks_res_jac_slope_fused(
            x[:, :nq].to(torch.float32), x[:, nq].to(torch.float32), lref, mref, cfg, iters)
        t = unit(_newton_step(bordered(jac, res_lam, t0), e_last))
    else:
        t = t0
    ds_k = torch.full((b,), ds, dtype=torch.float64, device=x.device)
    rows = []
    for _ in range(steps):
        x_new, ok, jac_aug = corrector(x + ds_k[:, None] * t.double(), t)
        x = torch.where(ok[:, None], x_new, x)
        # the next Keller tangent from the corrector's last bordered matrix:
        # its border row is the previous tangent, assembled at the returned x
        t = torch.where(ok[:, None], unit(_newton_step(jac_aug, e_last)), t)
        ds_k = torch.where(ok, torch.clamp(ds_k * 1.5, max=ds), ds_k * 0.5)
        sign, logabs = (torch.linalg.slogdet(jac_aug[:, :nq, :nq]) if monitor_stability
                        else (None, None))
        rows.append((x, ok, sign, logabs))

    xs = torch.stack([row[0] for row in rows])                   # (steps, B, nq+1)
    hi, lo = dd.split_f64(xs)
    out = {}
    if monitor_stability:
        out.update(det_sign=torch.stack([row[2] for row in rows]),
                   log_abs_det=torch.stack([row[3] for row in rows]))
    if dd_residual:
        out.update(qes_lo=lo[..., :nq], lambdas_lo=lo[..., nq])
    return BatchedContinuationPath(lambdas=hi[..., nq], qes=hi[..., :nq],
                                   converged=torch.stack([row[1] for row in rows]), **out)


def arc_length_continuation_batched(load_refs, cfg: StaticsConfig = StaticsConfig(),
                                    tip_moment_refs=None, qe0=None, lambda_start=0.0,
                                    ds: float = 0.2, steps: int = 40, tol: float = 2e-5,
                                    max_corrector: int = 10, psi: float = 1.0,
                                    iters: int = 16, direction: float = 1.0,
                                    monitor_stability: bool = False,
                                    dd_residual: bool = False, dd_iters: int = 24,
                                    refine_steps: int = 1) -> BatchedContinuationPath:
    """Riks continuation over a batch of load rays on the kernels.

    ``load_refs (B, 3)`` -> per-sample arc-length paths: every corrector
    iterate is one K1 state solve and one direction-stacked K2 solve over
    the whole batch (:func:`_riks_res_jac_slope_fused`) and a batched
    solve of the ``(nq+1)`` bordered systems; the walk over ``steps`` is a
    host loop (:func:`arc_length_continuation` is the host f64 walker, one
    path at a time).

    The f32 corrector: ``tol`` ~1e-4..2e-5 (the f32 residual floors near
    1e-5).  ``dd_residual=True`` evaluates the corrector residual with
    :func:`equilibrium_residual_dd` on K3 (the f32 Jacobian stays), which
    makes ``tol`` down to ~1e-9 meaningful; the path's low words come back
    in ``qes_lo``/``lambdas_lo``.  ``lambda_start`` (scalar or ``(B,)``)
    anchors each ray, converged first by :func:`solve_statics_batched`.
    """
    load_refs = as_tensor(load_refs, torch.float32)
    b, device = load_refs.shape[0], load_refs.device
    nq = cfg.rod.na * cfg.rod.ne
    tip_moment_refs = (torch.zeros_like(load_refs) if tip_moment_refs is None else
                       torch.as_tensor(tip_moment_refs, dtype=torch.float32,
                                       device=device).expand(b, 3))
    lam0 = torch.as_tensor(lambda_start, dtype=torch.float32, device=device).expand(b)

    anchor = solve_statics_batched(lam0[:, None] * load_refs, lam0[:, None] * tip_moment_refs,
                                   cfg=cfg, qe0=qe0, tol=tol, max_iter=max_corrector,
                                   iters=iters, dd_residual=dd_residual, dd_iters=dd_iters,
                                   refine_steps=refine_steps)
    qe = (dd.join_f64(anchor.qe, anchor.qe_lo) if dd_residual
          else anchor.qe.to(torch.float64))
    x = torch.cat([qe, lam0[:, None].to(torch.float64)], dim=1)
    t0 = torch.zeros((b, nq + 1), dtype=torch.float32, device=device)
    t0[:, nq] = float(direction)
    return _batched_riks_engine(load_refs, tip_moment_refs, cfg, x, t0, True, ds, steps, tol,
                                max_corrector, psi, iters, monitor_stability, dd_residual,
                                dd_iters, refine_steps)
