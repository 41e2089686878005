"""Shape sensing and load identification: the inverse problems of the rod.

Counterpart of the JAX package's ``models/sensing.py``.  Measurements
(markers along the backbone, strain stations, 6-DoF pose stations, a
tracked tip frame) come in, and the modal strain ``qe``, or the tip load
that produced it, is recovered by batched Gauss-Newton whose Jacobians are
forward-mode derivatives of the spectral forward model.

Measurement model (:func:`measure`): markers are world positions at
arclength fractions, interpolated off the CGL grid
(``ops/chebyshev.interpolation_matrix``); strain stations are body-frame
strains at arclength fractions, linear in ``qe``; the tip quaternion's sign
is canonicalized.  ``SensingConfig.method`` goes to ``rod.rod_shape``:
``'fused'`` runs the batch through one K1 launch per call and is
forward-only (simulating or scoring measurements for a large batch); the
estimators differentiate :func:`measure` and refuse it.

Estimators: :func:`fit_strain` (Levenberg-damped Gauss-Newton with a
per-sample backtracking search, a host loop with one host sync per
iterate: the stop test on the batch's largest residual),
:func:`posterior_covariance` (the linearized Gauss-Markov covariance) and
:func:`identify_tip_load` (Gauss-Newton over tip loads through the statics
equilibrium, each Jacobian column the implicit-function tangent of the
solve by the chain rule).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import basis as basis_ops
from ..ops import chebyshev
from ..ops.device import as_tensor, cached_constants
from . import cosserat, rod

__all__ = [
    "SensingConfig",
    "SensingSolution",
    "measure",
    "measurement_size",
    "fit_strain",
    "posterior_covariance",
    "identify_tip_load",
]


@dataclasses.dataclass(frozen=True)
class SensingConfig:
    """Sensor layout and estimator configuration (frozen, hashable).

    ``marker_fracs`` / ``strain_fracs`` / ``pose_fracs`` are arclength
    fractions in ``(0, 1]`` of ``rod.length``.  ``reg`` is the Tikhonov
    weight on ``qe`` (for sensor sets that under-determine the modes).
    ``method`` is ``rod.rod_shape``'s ('picard'; 'fused' for forward-only
    batches on K1).
    """

    rod: rod.RodConfig = rod.RodConfig()
    marker_fracs: tuple = (0.25, 0.5, 0.75, 1.0)
    strain_fracs: tuple = ()
    pose_fracs: tuple = ()
    use_tip_quaternion: bool = False
    marker_weight: float = 1.0
    strain_weight: float = 1.0
    quat_weight: float = 1.0
    reg: float = 0.0
    iters: int = 24
    method: str = "picard"

    def __post_init__(self):
        for f in tuple(self.marker_fracs) + tuple(self.strain_fracs) + tuple(self.pose_fracs):
            if not 0.0 < f <= 1.0:
                raise ValueError(f"sensor fractions must lie in (0, 1], got {f}")

    @functools.cached_property
    def marker_interp(self) -> np.ndarray:
        """(k, n) spectral interpolation rows at the marker arclengths."""
        xs = tuple(float(f) * self.rod.length for f in self.marker_fracs)
        return chebyshev.interpolation_matrix(self.rod.n, xs, self.rod.length)

    @functools.cached_property
    def pose_interp(self) -> np.ndarray:
        """(k, n) interpolation rows at the 6-DoF pose stations."""
        xs = tuple(float(f) * self.rod.length for f in self.pose_fracs)
        return chebyshev.interpolation_matrix(self.rod.n, xs, self.rod.length)

    @functools.cached_property
    def strain_table(self) -> np.ndarray:
        """(k, ne) modal-basis table at the strain stations."""
        return basis_ops.basis_table(tuple(float(f) for f in self.strain_fracs),
                                     self.rod.ne, self.rod.basis)


def measurement_size(cfg: SensingConfig) -> int:
    return (3 * len(cfg.marker_fracs) + cfg.rod.na * len(cfg.strain_fracs)
            + 7 * len(cfg.pose_fracs) + (4 if cfg.use_tip_quaternion else 0))


@cached_constants
def _table(cfg: SensingConfig, name: str, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """``cfg.<name>`` (a host f64 table) on the device, cached."""
    return torch.tensor(getattr(cfg, name), dtype=dtype, device=device)


def _canonical_quat(q):
    """Fix the double cover's sign: ``w >= 0`` (a tie keeps the raw sign;
    ``torch.sign`` would zero it)."""
    return torch.where(q[..., :1] >= 0, q, -q)


def _differentiable(cfg: SensingConfig, what: str) -> None:
    if cfg.method == "fused":
        raise ValueError(
            f"{what} differentiates measure(), and SensingConfig(method='fused') runs the "
            "forward-only K1 kernel; use method='picard' for estimation")


def measure(qe, cfg: SensingConfig = SensingConfig()):
    """Forward measurement model ``qe (..., na*ne) -> y (..., m)``.

    The full spectral kinematics (``rod.rod_shape(method=cfg.method)``), the
    grid shape lifted to the sensor arclengths, every enabled channel
    (markers, pose stations, strain stations, tip quaternion) weighted and
    flattened into one vector, in ``qe``'s dtype (the fused path's f32
    solution is cast).
    """
    qe = as_tensor(qe)
    rc = cfg.rod
    batch = qe.shape[:-1]
    parts = []
    if cfg.marker_fracs or cfg.pose_fracs or cfg.use_tip_quaternion:
        sol = rod.rod_shape(qe, cfg=rc, method=cfg.method, iters=cfg.iters)
        pos = sol.positions.to(qe.dtype)
        # the base (grid index n-1) carries the known BCs: r = 0, q = identity
        r_full = torch.cat([pos, pos.new_zeros(pos.shape[:-2] + (1, 3))], dim=-2)
        if cfg.marker_fracs:
            p = _table(cfg, "marker_interp", qe.device, qe.dtype)
            markers = torch.einsum("kn,...nc->...kc", p, r_full)
            parts.append(cfg.marker_weight * markers.reshape(batch + (-1,)))
        if cfg.pose_fracs:
            quats = sol.quaternions.to(qe.dtype)
            base_q = torch.zeros_like(quats[..., :1, :])
            base_q[..., 0] = 1.0
            q_full = torch.cat([quats, base_q], dim=-2)
            p = _table(cfg, "pose_interp", qe.device, qe.dtype)
            pos_k = torch.einsum("kn,...nc->...kc", p, r_full)
            quat_k = _canonical_quat(torch.einsum("kn,...nc->...kc", p, q_full))
            parts.append(cfg.marker_weight * pos_k.reshape(batch + (-1,)))
            parts.append(cfg.quat_weight * quat_k.reshape(batch + (-1,)))
    if cfg.strain_fracs:
        strains = basis_ops.strain_at_points(qe, _table(cfg, "strain_table", qe.device,
                                                        qe.dtype))
        parts.append(cfg.strain_weight * strains.reshape(batch + (-1,)))
    if cfg.use_tip_quaternion:
        parts.append(cfg.quat_weight * _canonical_quat(sol.tip_quaternion.to(qe.dtype)))
    if not parts:
        raise ValueError("SensingConfig defines no sensors")
    return torch.cat(parts, dim=-1)


class SensingSolution(NamedTuple):
    """``qe (..., na*ne)``, residual 2-norm per sample, iterations used."""

    qe: torch.Tensor
    residual_norm: torch.Tensor
    iterations: torch.Tensor


def _gauss_newton(fwd, y, z0, reg: float, tol: float, max_iter: int, levenberg: float,
                  jac=None):
    """Batched damped Gauss-Newton on ``fwd(z) - y`` with Tikhonov ``reg``.

    Normal-equation steps ``(J^T J + (reg + lm) I) d = J^T r + reg z``
    (``torch.linalg.solve_ex``), the Levenberg term ``lm = levenberg (1 +
    max diag J^T J)`` relative to the Jacobian's scale (a straight start
    leaves some torsion modes with zero sensitivity), then a per-sample
    backtracking search over ``{1, 1/2, ..., 1/16}`` on the regularized
    objective, the current iterate as candidate 0 and all six through
    ``fwd`` as one batch.  A host loop until the batch's largest residual
    norm is ``<= tol`` or ``max_iter`` steps: one host sync per iterate.
    ``jac(z) -> (..., m, p)`` defaults to one jvp of the residual per unit
    direction (``cosserat._per_sample_jacobian``).
    """
    z = z0
    eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    alphas = torch.tensor([0.0, 1.0, 0.5, 0.25, 0.125, 0.0625], dtype=z.dtype,
                          device=z.device)

    def resid(zz):
        return fwd(zz) - y

    if jac is None:
        def jac(zz):
            return cosserat._per_sample_jacobian(resid, zz)

    r = resid(z)
    k = 0
    while k < max_iter and bool(torch.linalg.vector_norm(r, dim=-1).max() > tol):
        j = jac(z)
        jtj = torch.einsum("...mi,...mj->...ij", j, j)
        jtr = torch.einsum("...mi,...m->...i", j, r)
        lm = levenberg * (1.0 + torch.diagonal(jtj, dim1=-2, dim2=-1).max(dim=-1).values)
        lhs = jtj + (reg + lm)[..., None, None] * eye
        step = torch.linalg.solve_ex(lhs, (jtr + reg * z)[..., None])[0][..., 0]
        a = alphas.reshape((6,) + (1,) * step.ndim)
        cand = z[None] - a * step[None]                                 # (6, ..., p)
        r_c = resid(cand)
        obj = torch.sum(r_c * r_c, dim=-1) + reg * torch.sum(cand * cand, dim=-1)
        ok = obj[1:] < obj[0]
        idx = 1 + torch.where(ok.any(0), ok.int().argmax(0), obj[1:].argmin(0))
        pick = idx[None, ..., None]
        z = torch.take_along_dim(cand, pick, dim=0)[0]
        r = torch.take_along_dim(r_c, pick, dim=0)[0]
        k += 1
    return z, torch.tensor(k, dtype=torch.int32), r


def fit_strain(measurements, cfg: SensingConfig = SensingConfig(), qe0=None,
               tol: float = 1e-10, max_iter: int = 25,
               levenberg: float = 1e-7) -> SensingSolution:
    """Recover the modal strain ``qe`` from measurement vectors
    ``(..., measurement_size(cfg))``, batched over the leading axes.
    ``tol`` is on the batch's largest residual 2-norm; with noisy data set
    it below the noise floor and let ``max_iter`` end the loop."""
    _differentiable(cfg, "fit_strain")
    y = as_tensor(measurements)
    nq = cfg.rod.na * cfg.rod.ne
    qe0 = (torch.zeros(y.shape[:-1] + (nq,), dtype=y.dtype, device=y.device) if qe0 is None
           else torch.as_tensor(qe0, dtype=y.dtype, device=y.device))
    z, k, r = _gauss_newton(functools.partial(measure, cfg=cfg), y, qe0, cfg.reg, tol,
                            max_iter, levenberg)
    return SensingSolution(qe=z, residual_norm=torch.linalg.vector_norm(r, dim=-1),
                           iterations=k)


def posterior_covariance(qe, cfg: SensingConfig = SensingConfig(), noise_sigma: float = 1.0):
    """Linearized estimator covariance ``sigma^2 A^-1 J^T J A^-1`` at ``qe``
    for i.i.d. noise, ``J = d measure/d qe``, ``A = J^T J + reg I`` (for
    ``reg = 0`` the Cramér-Rao bound ``sigma^2 (J^T J)^-1``).  Batched over
    the leading axes of ``qe``; returns ``(..., nq, nq)``."""
    _differentiable(cfg, "posterior_covariance")
    qe = as_tensor(qe)
    jac = cosserat._per_sample_jacobian(functools.partial(measure, cfg=cfg), qe)
    jtj = torch.einsum("...mi,...mj->...ij", jac, jac)
    eye = torch.eye(qe.shape[-1], dtype=qe.dtype, device=qe.device)
    a_inv = torch.linalg.solve_ex(jtj + cfg.reg * eye, eye.expand(jtj.shape))[0]
    return noise_sigma ** 2 * torch.einsum("...ij,...jk,...kl->...il", a_inv, jtj, a_inv)


def identify_tip_load(measurements, cfg: SensingConfig = SensingConfig(),
                      statics: cosserat.StaticsConfig | None = None,
                      estimate_moment: bool = False, theta0=None, tol: float = 1e-10,
                      max_iter: int = 25, levenberg: float = 1e-9, statics_tol: float = 1e-9,
                      statics_max_iter: int = 30):
    """Estimate the tip wrench from shape measurements of an equilibrium.

    Forward map ``theta -> qe*(theta) -> measure(qe*)``, ``qe*`` the static
    equilibrium under the tip load ``theta`` (force, and moment with
    ``estimate_moment``): every sample and line-search candidate, flattened,
    goes through one batched ``cosserat.solve_statics``.  Each Jacobian is
    the implicit-function rule at the solution by the chain rule, ``d
    measure/d qe* . (-J^-1 d res/d theta)`` (the numbers of
    ``solve_statics_differentiable``'s tangent), so the inner Newton's
    iterations never enter a derivative.  Returns ``(theta (..., 3 or 6),
    SensingSolution)``.
    """
    _differentiable(cfg, "identify_tip_load")
    y = as_tensor(measurements)
    sc = statics if statics is not None else cosserat.StaticsConfig(rod=cfg.rod)
    if sc.rod != cfg.rod:
        raise ValueError("statics.rod and sensing rod configs differ")
    p = 6 if estimate_moment else 3
    theta0 = (torch.zeros(y.shape[:-1] + (p,), dtype=y.dtype, device=y.device)
              if theta0 is None else torch.as_tensor(theta0, dtype=y.dtype, device=y.device))
    m = measurement_size(cfg)

    def residual(qe, flat):
        moment = flat[..., 3:] if estimate_moment else torch.zeros_like(flat[..., :3])
        return cosserat.equilibrium_residual(qe, flat[..., None, :3], moment[..., None, :], sc,
                                             cfg.iters)

    def equilibrium(theta):
        flat = theta.reshape(-1, p)
        moment = flat[:, 3:] if estimate_moment else torch.zeros_like(flat[:, :3])
        return cosserat.solve_statics(flat[:, :3], moment, sc, tol=statics_tol,
                                      max_iter=statics_max_iter, iters=cfg.iters).qe, flat

    def fwd(theta):
        return measure(equilibrium(theta)[0], cfg).reshape(theta.shape[:-1] + (m,))

    def jac(theta):
        qe, flat = equilibrium(theta)
        h = cosserat._per_sample_jacobian(functools.partial(measure, cfg=cfg), qe)
        j_q = cosserat._per_sample_jacobian(lambda q: residual(q, flat), qe)
        j_t = cosserat._per_sample_jacobian(lambda t: residual(qe, t), flat)
        dq = -torch.linalg.solve_ex(j_q, j_t)[0]                         # (B, nq, p)
        return torch.matmul(h, dq).reshape(theta.shape[:-1] + (m, p))

    z, k, r = _gauss_newton(fwd, y, theta0, 0.0, tol, max_iter, levenberg, jac=jac)
    return z, SensingSolution(qe=z, residual_norm=torch.linalg.vector_norm(r, dim=-1),
                              iterations=k)
