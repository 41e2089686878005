"""Multi-segment Cosserat statics: per-segment stiffness, chained BVP.

Counterpart of the JAX package's ``models/segment_statics.py``.  The
unknowns are the stacked per-segment strain modes ``qe (..., S, na*ne)``;
kinematic continuity is exact by construction (the chained solves of
:mod:`.segments`).  Equilibrium is each segment's weak-form moment balance
against the tip wrench transported to its sections,

    res[s, a, e] = int_{seg s} P_e(x) { H_s (kappa_s - kappa0_s)
                                        - R_s(x)^T [ (r_tip - r_s(x)) x F + M ] }_a dx,

with ``r_tip`` the rod's tip (the last segment's point 0), so every segment
couples to every segment beyond it through the chain.

* :func:`solve_segmented_statics`: per-sample Newton on the torch chain
  ('picard' or 'dense'), the Jacobian from ``torch.func`` jvps; the
  reference of the batched solver.
* :func:`solve_segmented_statics_batched`: Newton over the whole batch on the
  kernels.  Each step runs, per segment, one K4 solve for the state and one
  K2 solve over the ``(s+1) nq`` directions that reach segment ``s``
  (:func:`_segmented_fused_state_and_tangents`); ``dd_residual=True`` takes
  the convergence residual from the K5 chain in FP64
  (:func:`segmented_equilibrium_residual_dd`).  The step is
  ``torch.linalg.solve_ex`` (no host sync).

Routed tendons (:mod:`.tendon`): a cable anchored at segment
``tendon_end[k]``'s tip covers segments ``0..tendon_end[k]``, each
segment's length integral on its own grid (:func:`segmented_tendon_lengths`,
the capstan turning angle carried across junctions), so a mid-rod
termination stays spectral.  ``tension=`` on the per-sample residual and
Newton adds the actuation ``+ sum_k T_k dl_k/dqe``.
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
from ..ops.device import as_tensor
from . import rod, segments
from . import tendon as tendon_mod
from .cosserat import _newton_step, _per_sample_jacobian, _with_base, jvp_columns

__all__ = [
    "SegmentedStaticsConfig",
    "SegmentedStaticsSolution",
    "segmented_equilibrium_residual",
    "segmented_equilibrium_residual_dd",
    "segmented_tendon_lengths",
    "segmented_residual_and_jacobian_fused",
    "solve_segmented_statics",
    "solve_segmented_statics_batched",
]


@dataclass(frozen=True)
class SegmentedStaticsConfig:
    """Chained-rod geometry plus per-segment constitutive laws.

    ``stiffness``: per-segment diagonals of ``H`` (``na`` entries each,
    Kirchhoff 3 or Reissner 6), or one flat tuple for every segment.
    ``kappa0``: per-segment rest strains ``(S, na*ne)`` or ``None``.
    ``follower``: the tip force is given in the tip's body frame.
    ``tendons``: routed cables (:class:`~.tendon.Tendon`), each routing
    evaluated per covered segment on that segment's normalized grid;
    ``tendon_end[k]``: the segment at whose tip tendon ``k`` is anchored
    (default: the rod's tip).
    """

    rods: segments.SegmentedRodConfig = field(
        default_factory=lambda: segments.uniform_segments(2))
    stiffness: tuple = (1.0, 1.0, 1.0)
    kappa0: tuple | None = None
    follower: bool = False
    tendons: tuple = ()
    tendon_end: tuple | None = None

    @property
    def tendon_last_segment(self) -> tuple:
        """Per tendon, the index of the last covered segment (its anchor)."""
        if not self.tendons:
            return ()
        if self.tendon_end is None:
            return (self.rods.num_segments - 1,) * len(self.tendons)
        if len(self.tendon_end) != len(self.tendons):
            raise ValueError(f"tendon_end has {len(self.tendon_end)} entries for "
                             f"{len(self.tendons)} tendons")
        for e in self.tendon_end:
            if not 0 <= int(e) < self.rods.num_segments:
                raise ValueError(f"tendon_end entry {e} outside 0..{self.rods.num_segments - 1}")
        return tuple(int(e) for e in self.tendon_end)

    @functools.cached_property
    def stiffness_per_segment(self) -> np.ndarray:
        """``(S, na)`` f64."""
        h = np.asarray(self.stiffness, np.float64)
        s, na = self.rods.num_segments, self.rods.segments[0].na
        if h.ndim == 1:
            h = np.broadcast_to(h, (s, h.shape[0]))
        if h.shape != (s, na):
            raise ValueError(f"stiffness shape {h.shape} incompatible with {s} segments "
                             f"of na={na}")
        return h

    @functools.cached_property
    def full_tables(self) -> tuple:
        """Per-segment ``(n_s, ne)`` basis tables at ALL grid points."""
        return tuple(basis_ops.basis_table(tuple((seg.points / seg.length).tolist()),
                                           seg.ne, seg.basis)
                     for seg in self.rods.segments)

    @functools.cached_property
    def quad_weights(self) -> tuple:
        return tuple(chebyshev.clenshaw_curtis_weights(seg.n, seg.length)
                     for seg in self.rods.segments)


class SegmentedStaticsSolution(NamedTuple):
    qe: torch.Tensor             # (..., S, na*ne) converged strain modes
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
    qe_lo: torch.Tensor | None = None   # low word of the dd_residual solves


@dataclass(frozen=True, eq=False)
class _Constants:
    tables: tuple              # S x (n_s, ne)
    weights: tuple             # S x (n_s,)
    stiffness: torch.Tensor    # (S, na)
    kappa0: tuple | None       # S x (n_s, na) rest strain fields


@functools.lru_cache(maxsize=None)
def _constants(cfg: SegmentedStaticsConfig, device: torch.device,
               dtype: torch.dtype) -> _Constants:
    def dev(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    tables = tuple(dev(t) for t in cfg.full_tables)
    kappa0 = (None if cfg.kappa0 is None else
              tuple(basis_ops.strain_at_points(dev(k), t)
                    for k, t in zip(np.asarray(cfg.kappa0, np.float64), tables)))
    return _Constants(tables=tables, weights=tuple(dev(w) for w in cfg.quad_weights),
                      stiffness=dev(cfg.stiffness_per_segment), kappa0=kappa0)


def _full_grid(s: int, q: torch.Tensor, r: torch.Tensor, jq: torch.Tensor,
               jr: torch.Tensor):
    """Segment ``s``'s state on its FULL grid: its base point appended, the
    rod's base (identity, origin) for the first segment, else the previous
    junction of the trace ``jq (..., S, 4)``, ``jr (..., S, 3)``."""
    if s == 0:
        return _with_base(q, r)
    return (torch.cat([q, jq[..., s - 1:s, :]], dim=-2),
            torch.cat([r, jr[..., s - 1:s, :]], dim=-2))


def _chained_full_states(qe_segs: torch.Tensor, cfg: SegmentedStaticsConfig, iters: int,
                         method: str):
    """Per-segment FULL-grid states plus the rod's tip position."""
    sol = segments.segmented_rod_shape(qe_segs, cfg.rods, method=method, iters=iters)
    full = [_full_grid(s, q, r, sol.junction_quaternions, sol.junction_positions)
            for s, (q, r) in enumerate(zip(sol.quaternions, sol.positions))]
    return [q for q, _ in full], [r for _, r in full], sol.tip_position


def _weak_form(c: _Constants, s: int, mr: torch.Tensor) -> torch.Tensor:
    """``res[a, e] = sum_j w_j P_e(x_j) mr[j, a]``, flattened mode-major."""
    res = torch.einsum("j,je,...ja->...ae", c.weights[s], c.tables[s], mr)
    return res.reshape(res.shape[:-2] + (res.shape[-2] * res.shape[-1],))


def _segment_residual_from_state(qe_s, q_full, r_full, r_tip, q_tip, tip_force,
                                 tip_moment, s: int, cfg: SegmentedStaticsConfig):
    """Segment ``s``'s weak-form balance residual from explicit kinematic
    state: plain torch, so ``torch.func.jvp`` gives its tangents in every
    argument (cf. ``cosserat._residual_from_state``)."""
    dtype, device = qe_s.dtype, qe_s.device
    c = _constants(cfg, device, dtype)
    kappa = basis_ops.strain_at_points(qe_s, c.tables[s])
    if c.kappa0 is not None:
        kappa = kappa - c.kappa0[s]

    tf = torch.as_tensor(tip_force, dtype=dtype, device=device)
    if cfg.follower:
        # The body-frame tip force turns with the rod's tip (couples every
        # segment to the last one's state).
        tf = lie.quat_rotate_normalized(q_tip, tf.expand(q_tip.shape[:-1] + (3,)))
    arm = r_tip[..., None, :] - r_full                               # (..., n_s, 3)
    f = tf[..., None, :].expand(arm.shape)
    tm = torch.as_tensor(tip_moment, dtype=dtype, device=device)
    tau = lie.quat_rotate_inv_normalized(q_full, lie.cross(arm, f) + tm[..., None, :])
    if cfg.rods.segments[s].na == 6:
        tau = torch.cat([tau, lie.quat_rotate_inv_normalized(q_full, f)], dim=-1)
    return _weak_form(c, s, c.stiffness[s] * kappa - tau)


def segmented_tendon_lengths(qe_segs, cfg: SegmentedStaticsConfig, iters: int = 24,
                             method: str = "picard") -> torch.Tensor:
    """Routed lengths ``(..., K)`` of ``cfg.tendons`` over their covered
    segments, each segment's share the spectral length integral on its own
    grid (``tendon.lengths_from_state``), the capstan turning angle carried
    from each segment into the next."""
    qe_segs = as_tensor(qe_segs)
    qs, rs, _ = _chained_full_states(qe_segs, cfg, iters, method)
    lens = []
    for t, last in zip(cfg.tendons, cfg.tendon_last_segment):
        total, theta = 0.0, None
        for s in range(last + 1):                            # base segment -> anchor
            contrib, theta = tendon_mod.lengths_from_state(
                rs[s], qs[s], (t,), cfg.rods.segments[s], cfg.quad_weights[s], theta0=theta,
                return_theta=True)
            total = total + contrib[..., 0]
        lens.append(total)
    return torch.stack(lens, dim=-1)


def segmented_equilibrium_residual(qe_segs, tip_force, tip_moment,
                                   cfg: SegmentedStaticsConfig, iters: int = 24,
                                   method: str = "picard", tension=None) -> torch.Tensor:
    """Stacked weak-form balance residual ``(..., S, na*ne)`` on the torch
    chain (``method`` 'picard' or 'dense').  ``tension (..., K)`` with
    ``cfg.tendons`` adds ``+ sum_k T_k dl_k/dqe`` (``torch.func.grad`` of the
    cable potential)."""
    qe_segs = as_tensor(qe_segs)
    qs, rs, r_tip = _chained_full_states(qe_segs, cfg, iters, method)
    q_tip = qs[-1][..., 0, :]
    out = torch.stack([
        _segment_residual_from_state(qe_segs[..., s, :], qs[s], rs[s], r_tip, q_tip,
                                     tip_force, tip_moment, s, cfg)
        for s in range(cfg.rods.num_segments)], dim=-2)
    if tension is not None and cfg.tendons:
        t_vec = torch.as_tensor(tension, dtype=qe_segs.dtype, device=qe_segs.device)

        def cable_potential(q_):
            return torch.sum(t_vec * segmented_tendon_lengths(q_, cfg, iters, method))

        out = out + torch.func.grad(cable_potential)(qe_segs)
    return out


def segmented_equilibrium_residual_dd(qe_segs, tip_force, tip_moment,
                                      cfg: SegmentedStaticsConfig,
                                      iters: int = 20) -> torch.Tensor:
    """The chained balance residual at f64 grade: the kinematic chain runs
    through K5 (``segmented_rod_shape(method='refined_fused')``, f32-pair
    junction states end to end) and every transport and sum is FP64, where
    the JAX package used double-word error-free transformations.

    ``qe_segs`` may be an f32 pair ``(hi, lo)`` of ``(..., S, nq)`` words,
    ``tip_force``/``tip_moment`` pairs too.  Returns f32 ``(..., S, nq)``
    (the values near zero are representable; the f64 sums carried the
    cancellation).  As in the JAX package the body transports use the
    unnormalized ``R(q)`` of the refined quaternions.
    """
    if isinstance(qe_segs, tuple):
        qe_hi = as_tensor(qe_segs[0]).to(torch.float32)
        qe_lo = torch.as_tensor(qe_segs[1]).to(device=qe_hi.device, dtype=torch.float32)
        chain_in = (qe_hi, qe_lo)
    else:
        qe_hi = chain_in = as_tensor(qe_segs).to(torch.float32)
        qe_lo = None
    device = qe_hi.device
    qe64 = qe_hi.to(torch.float64) if qe_lo is None else dd.join_f64(qe_hi, qe_lo)
    sol = segments.segmented_rod_shape(chain_in, cfg.rods, method="refined_fused",
                                       iters=iters)
    jq = dd.join_f64(*sol.junction_dd[0])                    # (..., S, 4)
    jr = dd.join_f64(*sol.junction_dd[1])
    r_tip = jr[..., -1, :]
    tf, tm = dd.as_f64(tip_force, device), dd.as_f64(tip_moment, device)
    if cfg.follower:
        tf = torch.einsum("...ij,...j->...i", lie.quat_to_rot(jq[..., -1, :]), tf)

    c = _constants(cfg, device, torch.float64)
    out = []
    for s, seg in enumerate(cfg.rods.segments):
        q, r = _full_grid(s, dd.join_f64(*sol.quaternions_dd[s]),
                          dd.join_f64(*sol.positions_dd[s]), jq, jr)
        xi = basis_ops.strain_at_points(qe64[..., s, :], c.tables[s])
        if c.kappa0 is not None:
            xi = xi - c.kappa0[s]
        arm = r_tip[..., None, :] - r
        f = tf[..., None, :].expand(arm.shape)
        rot = lie.quat_to_rot(q)                              # R^T v: contract rows
        tau = torch.einsum("...ji,...j->...i", rot, lie.cross(arm, f) + tm[..., None, :])
        if seg.na == 6:
            tau = torch.cat([tau, torch.einsum("...ji,...j->...i", rot, f)], dim=-1)
        out.append(_weak_form(c, s, c.stiffness[s] * xi - tau))
    return torch.stack(out, dim=-2).to(torch.float32)


def _segmented_fused_state_and_tangents(qe: torch.Tensor, cfg: SegmentedStaticsConfig,
                                        iters: int, jac_iters: int):
    """Chained state and implicit-function tangents on the kernels.

    ``qe (B, S, nq)`` f32 -> per-segment full-grid states and tangent stacks
    over the strain directions.  The chain makes the linearization
    triangular: perturbing segment ``s'`` moves segments ``s >= s'`` only.

    * a segment's own directions solve its linearized ODE with a homogeneous
      boundary condition: K2 on ``1/2 A(dK) q``;
    * upstream directions enter only through the junction: the quaternion
      ODE is linear in its initial value, so their tangent is K2 on the
      boundary right-hand side ``-(dn_in ⊗ dq_jct)``, and the position
      quadrature picks up ``-(dn_in ⊗ dr_jct)``.

    Segment ``s`` carries ``(s+1) nq`` directions, upstream ones first and
    its own last; one K4 and one direction-stacked K2 launch per segment.
    """
    from ..ops.kernels import rod_kernel as rk

    rods = cfg.rods
    b, na, ne = qe.shape[0], rods.segments[0].na, rods.segments[0].ne
    nq, nk = na * ne, 3 * ne                  # curvature directions: gamma has dM = 0
    f32 = dict(dtype=torch.float32, device=qe.device)
    q0 = torch.tensor(rod.DEFAULT_Q_INIT, **f32).expand(b, 4)
    r0 = torch.zeros((b, 3), **f32)
    dq_j = dr_j = None                        # junction tangents (s nq, B, 4 / 3)
    q_fulls, r_fulls, dq_fulls, dr_fulls = [], [], [], []
    for s, seg in enumerate(rods.segments):
        npts, ndir = seg.n - 1, (s + 1) * nq
        qe_s = qe[:, s, :]
        q_unk, r_unk = rk.rod_shape_fused_bc(qe_s, q0, r0, cfg=seg, iters=iters)
        grid = seg.grid(qe.device)
        dn_in, ginv = grid.dn_in.to(torch.float32), grid.ginv.to(torch.float32)

        # Direction strain fields: the axes stay (a, e, p, b) before the
        # (a, e) fold, so direction j = a*ne + e matches qe's layout.
        table = rod._basis_table(seg, qe.device).to(torch.float32)      # (npts, ne)
        dk_dirs = torch.einsum("ab,pe->aepb", torch.eye(na, **f32), table).reshape(
            nq, npts, na)
        dm = 0.5 * lie.quat_skew(dk_dirs[:nk, :, :3])                   # (nk, npts, 4, 4)
        rhs = [torch.einsum("jice,bie->jbic", dm, q_unk),
               q_unk.new_zeros((nq - nk, b, npts, 4))]
        if s > 0:                             # [upstream directions ; own directions]
            rhs.insert(0, -dn_in[None, None, :, None] * dq_j[:, :, None, :])
        dq_dirs = rk.picard_correction_fused(
            qe_s.repeat(ndir, 1), torch.cat(rhs).reshape(ndir * b, npts, 4), cfg=seg,
            iters=jac_iters).reshape(ndir, b, npts, 4)

        # Position tangents: dr = G (db - dn_in ⊗ dr_jct).
        if na == 6:
            gamma = basis_ops.strain_at_points(qe_s, table)[..., 3:]
            dgamma = torch.cat([q_unk.new_zeros((ndir - nq, b, npts, 3)),
                                dk_dirs[:, None, :, 3:].expand(nq, b, npts, 3)])
            db = lie.rod_tangent_jvp(q_unk, dq_dirs, gamma, dgamma)
        else:
            db = lie.rod_tangent_jvp(q_unk, dq_dirs)
        def own(d):   # zero tangents along the segment's own directions
            return q_unk.new_zeros((nq, b, d))

        if s > 0:
            db = db - dn_in[None, None, :, None] * torch.cat([dr_j, own(3)])[:, :, None, :]
        dr_dirs = torch.matmul(ginv, db)

        # Full-grid tangents: the base point carries the junction tangent
        # (zero along the segment's own directions).
        if s > 0:
            dq_base, dr_base = torch.cat([dq_j, own(4)]), torch.cat([dr_j, own(3)])
        else:
            dq_base, dr_base = own(4), own(3)
        q_fulls.append(torch.cat([q_unk, q0[:, None, :]], dim=1))
        r_fulls.append(torch.cat([r_unk, r0[:, None, :]], dim=1))
        dq_fulls.append(torch.cat([dq_dirs, dq_base[:, :, None, :]], dim=2))
        dr_fulls.append(torch.cat([dr_dirs, dr_base[:, :, None, :]], dim=2))

        # The next junction: this segment's tip (point 0).
        q0, r0 = q_unk[:, 0, :], r_unk[:, 0, :]
        dq_j, dr_j = dq_dirs[:, :, 0, :], dr_dirs[:, :, 0, :]
    return q_fulls, r_fulls, dq_fulls, dr_fulls


def segmented_residual_and_jacobian_fused(qe, tip_force, tip_moment,
                                          cfg: SegmentedStaticsConfig, iters: int = 16,
                                          jac_iters: int | None = None):
    """Batched residual and Jacobian of the chained statics system on the
    kernels: ``qe (B, S, nq)`` -> ``(res (B, S nq), jac (B, S nq, S nq))``,
    the implicit-function tangents in place of ``jacfwd`` through the chain."""
    qe = as_tensor(qe, torch.float32)
    b, s_count, nq = qe.shape
    flat = s_count * nq
    q_fulls, r_fulls, dq_fulls, dr_fulls = _segmented_fused_state_and_tangents(
        qe, cfg, iters, iters if jac_iters is None else jac_iters)
    # The tip's tangents cover every direction: the last segment sees all.
    r_tip, q_tip = r_fulls[-1][:, 0, :], q_fulls[-1][:, 0, :]
    dr_tip, dq_tip = dr_fulls[-1][:, :, 0, :], dq_fulls[-1][:, :, 0, :]
    eye = torch.eye(flat, dtype=torch.float32, device=qe.device)

    res_rows, jac_rows = [], []
    for s in range(s_count):
        def f(qe_s, q, r, rtip, qtip, s=s):
            return _segment_residual_from_state(qe_s, q, r, rtip, qtip, tip_force,
                                                tip_moment, s, cfg)

        # Directions of segments beyond s leave segment s's state alone.
        pad = (0, 0, 0, 0, 0, 0, 0, flat - dq_fulls[s].shape[0])
        dqe = eye[:, None, s * nq:(s + 1) * nq].expand(flat, b, nq)
        res, jac = jvp_columns(
            f, (qe[:, s, :], q_fulls[s], r_fulls[s], r_tip, q_tip),
            (dqe, torch.nn.functional.pad(dq_fulls[s], pad),
             torch.nn.functional.pad(dr_fulls[s], pad), dr_tip, dq_tip))
        res_rows.append(res)
        jac_rows.append(jac)
    return torch.cat(res_rows, dim=1), torch.cat(jac_rows, dim=1)


def _initial_strain(qe0, cfg: SegmentedStaticsConfig, shape: tuple, dtype, device):
    if qe0 is None:
        if cfg.kappa0 is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        qe0 = cfg.kappa0
    return torch.as_tensor(qe0, device=device).to(dtype).expand(shape).clone()


def solve_segmented_statics_batched(tip_force, tip_moment=None,
                                    cfg: SegmentedStaticsConfig = SegmentedStaticsConfig(),
                                    qe0=None, tol: float = 1e-5, max_iter: int = 12,
                                    damping: float = 1.0, iters: int = 16,
                                    jac_iters: int = 8, dd_residual: bool = False,
                                    dd_iters: int = 20) -> SegmentedStaticsSolution:
    """Newton over the whole batch on the kernels.

    ``tip_force (B, 3)`` -> converged strains ``(B, S, nq)``.  Each step is
    one K4 and one direction-stacked K2 launch per segment
    (:func:`segmented_residual_and_jacobian_fused`) and a batched library
    solve; the batch iterates until every sample's residual norm is
    ``<= tol`` (samples that are done stop moving) or ``max_iter`` steps.
    The iterate is kept in float64 and rounded to f32 for the kernels.
    ``dd_residual=True`` takes the convergence residual from
    :func:`segmented_equilibrium_residual_dd` (the K5 chain, ``dd_iters``
    Picard steps), which makes tolerances down to ~1e-9 meaningful; the
    strains then come back as an f32 pair (``qe``, ``qe_lo``).
    """
    tip_force = as_tensor(tip_force, torch.float32)
    device = tip_force.device
    rods = cfg.rods
    b, s_count = tip_force.shape[0], rods.num_segments
    nq = rods.segments[0].na * rods.segments[0].ne
    tm = (torch.zeros(3, device=device) if tip_moment is None
          else torch.as_tensor(tip_moment, dtype=torch.float32, device=device))
    tm = tm if tm.ndim > 1 else tm[None, :]
    qe = _initial_strain(qe0, cfg, (b, s_count, nq), torch.float64, device).reshape(b, -1)

    def res_jac(q64):
        res, jac = segmented_residual_and_jacobian_fused(
            q64.to(torch.float32).reshape(b, s_count, nq), tip_force, tm, cfg, iters=iters,
            jac_iters=jac_iters)
        if dd_residual:
            pair = tuple(w.reshape(b, s_count, nq) for w in dd.split_f64(q64))
            res = segmented_equilibrium_residual_dd(pair, tip_force, tm, cfg,
                                                    iters=dd_iters).reshape(b, -1)
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
    return SegmentedStaticsSolution(
        qe=hi.reshape(b, s_count, nq),
        iterations=torch.tensor(k, dtype=torch.int32, device=device),
        residual_norm=rnorm, converged=rnorm <= tol,
        qe_lo=None if lo is None else lo.reshape(b, s_count, nq))


def solve_segmented_statics(tip_force, tip_moment=(0.0, 0.0, 0.0),
                            cfg: SegmentedStaticsConfig = SegmentedStaticsConfig(),
                            qe0=None, tol: float = 1e-9, max_iter: int = 30,
                            damping: float = 1.0, iters: int = 24,
                            method: str = "picard", tension=None) -> SegmentedStaticsSolution:
    """Per-sample Newton on :func:`segmented_equilibrium_residual`, the
    Jacobian from ``torch.func`` jvps through the chained torch solves.

    ``tip_force (..., 3)``: each sample iterates until its own residual norm
    is ``<= tol`` or it has taken ``max_iter`` steps (a sample that is done
    stops moving).  ``tension (..., K)`` actuates ``cfg.tendons``.
    """
    rods = cfg.rods
    s_count = rods.num_segments
    nq = rods.segments[0].na * rods.segments[0].ne
    flat = s_count * nq
    tip_force = as_tensor(tip_force)
    if tip_force.dtype not in (torch.float32, torch.float64):
        tip_force = tip_force.to(torch.float32)
    dtype, device = tip_force.dtype, tip_force.device
    tip_moment = torch.as_tensor(tip_moment, dtype=dtype, device=device)
    batch = tip_force.shape[:-1]
    qe = _initial_strain(qe0, cfg, batch + (s_count, nq), dtype, device).reshape(
        batch + (flat,))

    def residual(q):
        r = segmented_equilibrium_residual(q.reshape(q.shape[:-1] + (s_count, nq)),
                                           tip_force, tip_moment, cfg, iters, method, tension)
        return r.reshape(r.shape[:-2] + (flat,))

    res = residual(qe)
    k = torch.zeros(batch, dtype=torch.int32, device=device)
    for _ in range(max_iter):
        active = torch.linalg.vector_norm(res, dim=-1) > tol
        if not bool(active.any()):
            break
        new_qe = qe - damping * _newton_step(_per_sample_jacobian(residual, qe), res)
        new_res = residual(new_qe)
        qe = torch.where(active[..., None], new_qe, qe)
        res = torch.where(active[..., None], new_res, res)
        k = k + active.to(torch.int32)
    rnorm = torch.linalg.vector_norm(res, dim=-1)
    return SegmentedStaticsSolution(qe=qe.reshape(batch + (s_count, nq)), iterations=k,
                                    residual_norm=rnorm, converged=rnorm <= tol)
