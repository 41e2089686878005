"""Cosserat-rod spectral kinematics: the port's main path.

Counterpart of the JAX package's ``models/rod.py``:

* :func:`quaternion_kinematics` solves ``Q' = 1/2 A(K(X)) Q``, ``Q(0) = q_init``;
* :func:`rod_shape` chains the position quadrature ``r' = R(Q) e1``,
  ``r(0) = r_init``, on the same grid; methods 'dense', 'picard', 'refined'
  and 'fused' (the K1 CUDA kernel, narrow or wide);
* :func:`rod_shape_refined_fused` is the accuracy-gated headline path: the
  single K3 kernel, or the staged path of K2 solves around float64
  residuals and quadrature.

Inputs are torch tensors of shape ``(..., na*ne)``, or an f32 pair
``(hi, lo)`` from :func:`split_strain`; numpy arrays and lists go to the
default device, the card (``ops/device.py``).  Everything runs on the
input's device.  As in the reference
(``main.cpp:130-136``) the position right-hand side uses the
**unnormalized** quaternion-to-rotation map unless
``normalize_quaternions=True``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import basis as basis_ops
from ..ops import chebyshev
from ..ops import collocation as coll
from ..ops import doubledouble as dd
from ..ops import lie
from ..ops.device import as_tensor, canonical_device

__all__ = [
    "RodConfig",
    "demo_qe",
    "curvature_at_points",
    "quaternion_kinematics",
    "rod_shape",
    "rod_shape_refined_fused",
    "split_strain",
    "strain_rho",
    "auto_picard_iters",
    "RodSolution",
]

DEFAULT_Q_INIT = (1.0, 0.0, 0.0, 0.0)
DEFAULT_R_INIT = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class RodConfig:
    """Static problem configuration: ``n`` CGL points, ``na`` strain
    components x ``ne`` modes, rod length and modal basis."""

    n: int = 16
    na: int = 3
    ne: int = 3
    length: float = 1.0
    basis: str = "legendre"

    @property
    def points(self) -> np.ndarray:
        return chebyshev.cgl_points(self.n, self.length)

    @functools.cached_property
    def basis_table(self) -> np.ndarray:
        """``(n-1, ne)`` f64 host table ``P_e(x_i)`` at the unknown points."""
        pts = tuple((self.points[:-1] / self.length).tolist())
        return basis_ops.basis_table(pts, self.ne, self.basis)

    def grid(self, device=None) -> coll.SpectralGrid:
        return coll.make_grid(self.n, self.length, device=device)


@functools.lru_cache(maxsize=None)
def _table(cfg: RodConfig, device: torch.device) -> torch.Tensor:
    return torch.tensor(cfg.basis_table, dtype=torch.float64, device=device)


def _basis_table(cfg: RodConfig, device) -> torch.Tensor:
    """The f64 basis table on ``device``, cached per ``(cfg, device)``."""
    return _table(cfg, canonical_device(device))


def demo_qe(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The demo strain of ``main.cpp:187-195``: bending about body-y, three
    Legendre modes (on the card unless ``device`` says otherwise)."""
    return torch.tensor(
        [0.0, 0.0, 0.0,
         1.2877691307032, -1.63807499160786, 0.437406679142598,
         0.0, 0.0, 0.0],
        dtype=dtype, device=canonical_device(device),
    )


def curvature_at_points(cfg: RodConfig, qe: torch.Tensor) -> torch.Tensor:
    """``K(x_i) = Phi(x_i) qe`` at the n-1 unknown points: ``(..., n-1, na)``."""
    return basis_ops.strain_at_points(qe, _basis_table(cfg, qe.device))


def split_strain(qe_f64):
    """Split an f64 strain into an f32 pair ``(hi, lo)``; pass it as ``qe``
    to keep f64-grade input on the refined paths."""
    return dd.split_f64(qe_f64)


def _as_dd_input(qe):
    """``(hi f32, lo f32 or None)`` from a pair, an f64 tensor or f32 input."""
    if isinstance(qe, tuple):
        hi, lo = qe
        hi = as_tensor(hi).to(torch.float32)
        return hi, torch.as_tensor(lo).to(device=hi.device, dtype=torch.float32)
    qe = as_tensor(qe)
    if qe.dtype == torch.float64:
        return dd.split_f64(qe)
    return qe.to(torch.float32), None


def _hi_word(qe) -> torch.Tensor:
    return as_tensor(qe[0] if isinstance(qe, tuple) else qe)


def _curvature_f64(cfg: RodConfig, qe) -> torch.Tensor:
    """The strain field in f64 from the f64 table and ``hi + lo``."""
    hi, lo = _as_dd_input(qe)
    qe64 = hi.to(torch.float64) if lo is None else dd.join_f64(hi, lo)
    return curvature_at_points(cfg, qe64)


def _ode_blocks(k: torch.Tensor) -> torch.Tensor:
    """Per-point system matrix ``M_i = 1/2 A(K_i)`` of ``Q' = M Q``."""
    return 0.5 * lie.quat_skew(k)


def strain_rho(qe, cfg: RodConfig) -> float:
    """Picard contraction parameter ``rho = max_i |K(x_i)|_2 L / 2`` (f64,
    on the input's device; one value comes back to the host)."""
    hi = _hi_word(qe)
    if hi.numel() == 0:
        return 0.0
    k = curvature_at_points(cfg, hi.to(torch.float64))[..., :3]
    return float(torch.linalg.vector_norm(k, dim=-1).max()) * cfg.length / 2.0


def auto_picard_iters(qe, cfg: RodConfig, tol: float = 1e-5, floor: int = 6) -> int:
    """Iteration count from the batch's strain bound (the Volterra
    truncation bound at the batch-max ``rho``), rounded up to even."""
    from ..utils import diagnostics

    rho = max(strain_rho(qe, cfg), 0.25)
    k = diagnostics.picard_iterations_needed(rho, tol)
    return max(floor, -(-k // 2) * 2)


def _check_rho(qe, cfg: RodConfig, max_rho: float, where: str) -> None:
    """Refuse a strain the fused Picard paths do not converge on."""
    rho = strain_rho(qe, cfg)
    if rho > max_rho:
        raise ValueError(
            f"{where}: strain too strong for the fused Picard paths — "
            f"rho = max|K| L/2 = {rho:.2f} > {max_rho} risks non-convergence "
            "of the f32 Picard solve. Raise iters/corr_iters and pass "
            "check_validity=False if you have verified convergence "
            "(diagnostics.picard_error_bound), or use method='refined'."
        )


def _q_init(q_init, like: torch.Tensor) -> torch.Tensor:
    q0 = torch.as_tensor(DEFAULT_Q_INIT if q_init is None else q_init,
                         dtype=like.dtype, device=like.device)
    return q0.expand(like.shape[:-1] + (4,))


def quaternion_kinematics(qe, q_init=None, cfg: RodConfig = RodConfig(),
                          method: str = "refined", iters: int = 24,
                          refine_steps: int = 2, return_dd: bool = False):
    """Spectral solve of the quaternion kinematics along the rod.

    Returns ``(..., n-1, 4)`` quaternions at the unknown CGL points, tip
    first.  ``method='refined'`` accepts an f32 pair for ``qe`` and, with
    ``return_dd``, returns the solution as a pair.
    """
    qe_arr = _hi_word(qe)
    grid = cfg.grid(qe_arr.device)
    q0 = _q_init(q_init, qe_arr)

    if method == "dense":
        m = _ode_blocks(curvature_at_points(cfg, qe_arr)[..., :3])
        return coll.solve_ivp_dense(grid, m, q0)
    if method == "picard":
        m = _ode_blocks(curvature_at_points(cfg, qe_arr)[..., :3])
        return coll.solve_ivp_picard_implicit(grid, m, coll.ivp_rhs(grid, q0), iters)
    if method == "refined":
        # 6-DoF strains: only the curvature drives the quaternion ODE.
        m_dd = dd.split_f64(_ode_blocks(_curvature_f64(cfg, qe)[..., :3]))
        q0_32 = q0.to(torch.float32).to(torch.float64)
        rhs = -grid.dn_in[:, None] * q0_32[..., None, :]
        x_hi, x_lo = coll.solve_ivp_refined(grid, m_dd, dd.split_f64(rhs),
                                            iters=iters, refine_steps=refine_steps)
        if return_dd:
            return x_hi, x_lo
        return x_hi + x_lo
    raise ValueError(f"unknown method {method!r}")


@dataclass
class RodSolution:
    """Point-major rod state at the unknown CGL points (tip first).

    ``quaternions (..., n-1, 4)``, ``positions (..., n-1, 3)``.  The refined
    paths also fill the f32 pairs ``quaternions_dd`` / ``positions_dd``: a
    single f32 tensor holds ~3e-8 relative, so the 1e-8-grade result is the
    pair, joined by :meth:`quaternions_f64` / :meth:`positions_f64`.
    """

    quaternions: torch.Tensor
    positions: torch.Tensor
    quaternions_dd: tuple | None = None
    positions_dd: tuple | None = None

    def quaternions_f64(self) -> torch.Tensor:
        return dd.join_f64(*self.quaternions_dd)

    def positions_f64(self) -> torch.Tensor:
        return dd.join_f64(*self.positions_dd)

    @property
    def q_stack(self) -> torch.Tensor:
        return coll.to_component_major(self.quaternions)

    @property
    def r_stack(self) -> torch.Tensor:
        return self.positions

    @property
    def tip_quaternion(self) -> torch.Tensor:
        return self.quaternions[..., 0, :]

    @property
    def tip_position(self) -> torch.Tensor:
        return self.positions[..., 0, :]


def _dd_solution(q64: torch.Tensor, r_hi: torch.Tensor, r_lo: torch.Tensor) -> RodSolution:
    q_hi, q_lo = dd.split_f64(q64)
    return RodSolution(quaternions=q_hi + q_lo, positions=r_hi + r_lo,
                       quaternions_dd=(q_hi, q_lo), positions_dd=(r_hi, r_lo))


def rod_shape_refined_fused(qe, cfg: RodConfig = RodConfig(), iters: int = 20,
                            refine_steps: int = 2, tile: int | None = None,
                            precision: str = "high",
                            single_kernel: bool | None = None,
                            corr_iters: int | None = None,
                            check_validity: bool = True,
                            max_rho: float = 5.0) -> RodSolution:
    """Fastest accuracy-gated path: fused f32 solves refined in float64.

    * single kernel (auto-selected for ``refine_steps=1``, ``precision=
      'high'``, na in (3, 6), n-1 <= 512, as in the JAX package): the whole
      solve in the K3 CUDA kernel;
    * staged: the base solve and each correction in the K2 kernel, the
      float64 residual and position quadrature as torch ops; any
      ``refine_steps``.

    Boundary conditions are the demo's (``q0 = (1,0,0,0)``, ``r0 = 0``).
    ``qe`` may be an f32 pair from :func:`split_strain`.  ``tile`` is
    accepted so that calls written for the JAX package run unchanged; the
    CUDA kernels choose their own launch shape.  The kernels cover
    n-1 <= 512 (narrow kernels to 32, wide above) and raise ``ValueError``
    beyond, as the JAX package's do.
    """
    from ..ops.kernels import rod_kernel as rk

    if tile is not None and int(tile) <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    if check_validity:
        _check_rho(qe, cfg, max_rho, "rod_shape_refined_fused")
    if iters == "auto":
        iters = auto_picard_iters(qe, cfg, tol=1e-5)
        if corr_iters is None:
            corr_iters = iters
    if single_kernel is None:
        single_kernel = (refine_steps == 1 and precision == "high"
                         and cfg.na in (3, 6) and cfg.n - 1 <= 512)
    qe_hi, qe_lo = _as_dd_input(qe)
    if single_kernel:
        if cfg.na not in (3, 6):
            raise ValueError("single_kernel supports na in (3, 6)")
        if refine_steps != 1:
            raise ValueError("single_kernel performs exactly one refinement; use "
                             "single_kernel=False for other refine_steps")
        if precision != "high":
            raise ValueError("single_kernel runs at 'high' matmul precision; use "
                             "single_kernel=False to select another precision")
        from ..ops.kernels import refined_kernel as rfk

        q_hi, q_lo, r_hi, r_lo = rfk.rod_shape_refined_kernel(
            qe_hi, qe_lo, cfg=cfg, iters=iters,
            corr_iters=20 if corr_iters is None else corr_iters,
            check_rho=max_rho if check_validity else None)
        return RodSolution(quaternions=q_hi + q_lo, positions=r_hi + r_lo,
                           quaternions_dd=(q_hi, q_lo), positions_dd=(r_hi, r_lo))

    # Staged path.
    grid = cfg.grid(qe_hi.device)
    k64 = _curvature_f64(cfg, qe)
    rhs = torch.zeros(qe_hi.shape[:-1] + (cfg.n - 1, 4), dtype=torch.float64,
                      device=qe_hi.device)
    rhs[..., 0] = -grid.dn_in
    rhs_dd = dd.split_f64(rhs)
    # The base solve goes through the same general-rhs kernel as the
    # corrections: its position stage would be recomputed in f64 anyway.
    x = rk.picard_correction_fused(qe_hi, rhs_dd[0], cfg=cfg, iters=iters,
                                   precision=precision).to(torch.float64)
    k_dd = dd.split_f64(k64[..., :3])
    for _ in range(refine_steps):
        r_hi, r_lo = coll.residual_quat_dd(grid, k_dd, *dd.split_f64(x), *rhs_dd)
        delta = rk.picard_correction_fused(qe_hi, r_hi + r_lo, cfg=cfg,
                                           iters=iters, precision=precision)
        x = x + delta.to(torch.float64)
    b = lie.rod_tangent(x, k64[..., 3:6] if cfg.na == 6 else None)
    r_hi, r_lo = coll.quadrature_refined(grid, dd.split_f64(b),
                                         refine_steps=max(1, refine_steps))
    return _dd_solution(x, r_hi, r_lo)


def rod_shape(qe, q_init=None, r_init=None, cfg: RodConfig = RodConfig(),
              method: str = "refined", iters: int = 24, refine_steps: int = 2,
              normalize_quaternions: bool = False) -> RodSolution:
    """Rod kinematics: the quaternion solve chained into the position
    quadrature ``Dn_NN r = b - Dn_IN r0`` (solved, never inverted).

    For ``cfg.na == 6`` (Reissner strains) the strain is ``(kappa, gamma)``:
    ``kappa`` drives the quaternion ODE and the centerline integrates
    ``r' = R(q)(e1 + gamma)``.
    """
    qe_arr = _hi_word(qe)

    if method == "fused":
        if normalize_quaternions:
            raise NotImplementedError(
                "method='fused' keeps the reference's unnormalized-quaternion "
                "semantics")
        if q_init is not None or r_init is not None:
            raise NotImplementedError(
                "method='fused' with custom boundary conditions needs the K4 "
                "kernel (rod_shape_fused_bc), not yet ported: ROADMAP.md "
                "Queue 2, K4")
        from ..ops.kernels import rod_kernel as rk

        batch = qe_arr.shape[:-1]
        q, r = rk.rod_shape_fused(qe_arr.reshape(-1, qe_arr.shape[-1]), cfg=cfg,
                                  iters=iters)
        return RodSolution(quaternions=q.reshape(batch + q.shape[1:]),
                           positions=r.reshape(batch + r.shape[1:]))

    grid = cfg.grid(qe_arr.device)
    r0 = torch.as_tensor(DEFAULT_R_INIT if r_init is None else r_init,
                         device=qe_arr.device)

    if method == "refined":
        q_hi, q_lo = quaternion_kinematics(qe, q_init, cfg, method="refined",
                                           iters=iters, refine_steps=refine_steps,
                                           return_dd=True)
        q64 = dd.join_f64(q_hi, q_lo)
        if normalize_quaternions:
            q64 = lie.quat_normalize(q64)
        gamma = _curvature_f64(cfg, qe)[..., 3:6] if cfg.na == 6 else None
        b = lie.rod_tangent(q64, gamma)
        r0_32 = r0.to(torch.float32).to(torch.float64)
        rhs = b - grid.dn_in[:, None] * r0_32[..., None, :]
        r_hi, r_lo = coll.quadrature_refined(grid, dd.split_f64(rhs),
                                             refine_steps=refine_steps)
        return _dd_solution(q64, r_hi, r_lo)

    q = quaternion_kinematics(qe_arr, q_init, cfg, method=method, iters=iters)
    qq = lie.quat_normalize(q) if normalize_quaternions else q
    gamma = curvature_at_points(cfg, qe_arr)[..., 3:6] if cfg.na == 6 else None
    b = lie.rod_tangent(qq, gamma)
    rhs = coll.ivp_rhs(grid, r0.to(qe_arr.dtype).expand(qe_arr.shape[:-1] + (3,)), g=b)
    if method == "dense":
        dn_nn = grid.dn_nn.to(qe_arr.dtype)
        r = torch.linalg.solve(dn_nn.expand(rhs.shape[:-2] + dn_nn.shape), rhs)
    else:
        r = torch.matmul(grid.ginv.to(qe_arr.dtype), rhs)
    return RodSolution(quaternions=q, positions=r)
