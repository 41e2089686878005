"""Bifurcation tools for statics continuation paths.

Counterpart of the JAX package's ``models/bifurcation.py``.  The statics
BVP has folds and bifurcations; Euler buckling of the axially compressed
cantilever is the canonical one.

* :func:`path_stability`: determinant sign and eigenvalue monitors of the
  equilibrium Jacobian along a :class:`~.cosserat.ContinuationPath` (the
  Jacobians on the path's device, ``torch.func.jacfwd`` through the rod
  solve; the ``nq x nq`` spectra in NumPy on the host).
* :func:`detect_critical_points`: bracket the changes of the unstable
  eigenvalue count between converged path points, refine each by
  bisection along the equilibrium path (the Riks corrector keeps the
  midpoints on it), and classify it as a **fold** or a **branch point**:
  at a fold the left null vector couples to the load direction, at a
  branch point it does not.
* :func:`linearized_buckling_loads`: on a trivial branch the Jacobian is
  affine in the load factor, so the critical loads are the eigenvalues of
  the pencil ``(J0, -J1)``, ``lam = -1/mu`` with ``mu in eig(J0^-1 J1)``.
* :func:`switch_branch` (the host walker) and :func:`switch_branch_batched`
  (the batched Riks engine on the kernels): walk the bifurcated branch
  with the null vector as the first tangent; the Riks constraint then
  excludes the trivial branch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.device import as_tensor, locked_jacfwd
from . import cosserat

__all__ = [
    "StabilityInfo",
    "CriticalPoint",
    "path_jacobians",
    "path_stability",
    "detect_critical_points",
    "linearized_buckling_loads",
    "switch_branch",
    "switch_branch_batched",
]


class StabilityInfo(NamedTuple):
    """Monitors of the equilibrium Jacobian at each path point (host
    NumPy): ``det_sign``/``log_abs_det`` from ``slogdet``, the smallest real
    part of the spectrum (crosses 0 where stability is lost) and the count
    of eigenvalues with negative real part (the Morse index in the
    conservative case)."""

    det_sign: np.ndarray       # (steps,)
    log_abs_det: np.ndarray    # (steps,)
    eig_min_real: np.ndarray   # (steps,)
    n_unstable: np.ndarray     # (steps,) int


class CriticalPoint(NamedTuple):
    segment: int               # path segment [i, i+1] bracketing the point
    kind: str                  # 'fold' | 'branch'
    lam: float                 # refined load factor
    qe: torch.Tensor           # (nq,) refined strain modes
    null_vector: torch.Tensor  # (nq,) right null vector of J, unit norm
    coupling: float            # |phi^T res_lam| / (|phi| |res_lam|): ~0 at a
                               # branch point, O(1) at a fold


def _residual_fn(load_ref, tip_moment_ref, cfg, iters, method):
    load_ref = as_tensor(load_ref)
    if load_ref.dtype not in (torch.float32, torch.float64):
        load_ref = load_ref.to(torch.float64)
    tip_moment_ref = torch.as_tensor(tip_moment_ref, dtype=load_ref.dtype,
                                     device=load_ref.device)

    def res(qe, lam):
        lam = torch.as_tensor(lam, dtype=load_ref.dtype, device=load_ref.device)[..., None, None]
        return cosserat.equilibrium_residual(qe, lam * load_ref, lam * tip_moment_ref, cfg,
                                             iters, method)

    return res, load_ref


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def path_jacobians(qes, lambdas, load_ref, cfg: cosserat.StaticsConfig,
                   tip_moment_ref=(0.0, 0.0, 0.0), iters: int = 24,
                   method: str = "picard") -> torch.Tensor:
    """Equilibrium Jacobians ``(steps, nq, nq)`` along a path, on the path's
    device."""
    res, load_ref = _residual_fn(load_ref, tip_moment_ref, cfg, iters, method)
    qes = torch.as_tensor(qes, dtype=load_ref.dtype, device=load_ref.device)
    lambdas = torch.as_tensor(lambdas, dtype=load_ref.dtype, device=load_ref.device)
    return cosserat._per_sample_jacobian(lambda q: res(q, lambdas), qes)


def path_stability(path: cosserat.ContinuationPath, load_ref,
                   cfg: cosserat.StaticsConfig = cosserat.StaticsConfig(),
                   tip_moment_ref=(0.0, 0.0, 0.0), iters: int = 24,
                   method: str = "picard") -> StabilityInfo:
    """Spectral stability monitors at every point of a continuation path."""
    jacs = _host(path_jacobians(path.qes, path.lambdas, load_ref, cfg, tip_moment_ref,
                                iters, method))
    sign, logdet = np.linalg.slogdet(jacs)
    ev = np.linalg.eigvals(jacs)
    return StabilityInfo(det_sign=sign, log_abs_det=logdet, eig_min_real=ev.real.min(axis=1),
                         n_unstable=(ev.real < 0).sum(axis=1).astype(np.int64))


def _classify(j, res_lam, fold_tol, lam_lo, lam_c, lam_hi):
    """``(kind, null_vector, coupling)`` from the Jacobian, the load slope and
    the bracket.  Either signal makes a fold: the refined ``lam_c`` is an
    extremum of its bracket (the load factor reverses at a limit point and
    passes through at a branch point), or the left null vector couples to
    the load direction, ``|phi^T res_lam| / |res_lam| > fold_tol`` (zero at a
    branch point, small but finite at a fold whose ``res_lam`` lies mostly
    in well-conditioned directions, which is why the geometric test
    leads)."""
    ev, vr = np.linalg.eig(j)
    psi = np.real(vr[:, int(np.argmin(np.abs(ev)))])
    psi = psi / np.linalg.norm(psi)
    evl, vl = np.linalg.eig(j.T)
    phi = np.real(vl[:, int(np.argmin(np.abs(evl)))])
    phi = phi / np.linalg.norm(phi)
    rl_norm = np.linalg.norm(res_lam)
    coupling = float(abs(phi @ res_lam) / max(rl_norm, 1e-30))
    margin = 1e-8 * (1.0 + abs(lam_c))
    interior = (lam_c - lam_lo) * (lam_hi - lam_c) > margin ** 2
    if rl_norm < 1e-9:
        kind = "branch"          # trivial branch: res_lam == 0 identically
    elif not interior or coupling > fold_tol:
        kind = "fold"
    else:
        kind = "branch"
    return kind, psi, coupling


def detect_critical_points(path: cosserat.ContinuationPath, load_ref,
                           cfg: cosserat.StaticsConfig = cosserat.StaticsConfig(),
                           tip_moment_ref=(0.0, 0.0, 0.0), iters: int = 24,
                           method: str = "picard", stability: StabilityInfo | None = None,
                           tol: float = 1e-9, max_corrector: int = 25,
                           psi_weight: float = 1.0, bisect_steps: int = 48,
                           fold_tol: float = 1e-2) -> list[CriticalPoint]:
    """Locate and classify singular-Jacobian crossings along a path.

    A crossing is flagged where the unstable eigenvalue count changes
    between consecutive converged points: that catches determinant sign
    changes and the even-multiplicity crossings the determinant misses
    (the double buckling eigenvalue of an isotropic column).  Each bracket
    is bisected in the path parameter, the midpoint projected back onto the
    equilibrium path by the Riks corrector along the bracket's secant, so
    the refinement walks the path, not the chord.
    """
    res, load_ref = _residual_fn(load_ref, tip_moment_ref, cfg, iters, method)
    if stability is None:
        stability = path_stability(path, load_ref, cfg, tip_moment_ref, iters, method)
    dtype, device = load_ref.dtype, load_ref.device
    qes = torch.as_tensor(path.qes, dtype=dtype, device=device)
    lams = torch.as_tensor(path.lambdas, dtype=dtype, device=device)
    conv = _host(torch.as_tensor(path.converged))
    lam_host = _host(lams)
    nq = qes.shape[1]
    _, corrector = cosserat._riks_machinery(res, nq, tol, max_corrector, psi_weight)

    def jac_at(x):
        return _host(locked_jacfwd(res)(x[:nq], x[nq]))

    def count_at(x):
        return int((np.linalg.eigvals(jac_at(x)).real < 0).sum())

    points = []
    for i in range(len(lam_host) - 1):
        if not (conv[i] and conv[i + 1]):
            continue
        if stability.n_unstable[i] == stability.n_unstable[i + 1]:
            continue
        xa = torch.cat([qes[i], lams[i:i + 1]])
        xb = torch.cat([qes[i + 1], lams[i + 1:i + 2]])
        dx = xb - xa
        t = dx / torch.sqrt(torch.sum(dx[:nq] ** 2) + psi_weight ** 2 * dx[nq] ** 2)
        ca = int(stability.n_unstable[i])
        for _ in range(bisect_steps):
            xm_pred = 0.5 * (xa + xb)
            xm, ok = corrector(xm_pred, t)
            if not ok:
                # Too close to the singular point for the corrector (the
                # augmented Jacobian degenerates at a branch point): the
                # bracket is tight already, take the chord midpoint.
                xm = xm_pred
            if count_at(xm) == ca:
                xa = xm
            else:
                xb = xm
            if (abs(float(xb[nq] - xa[nq])) < 1e-12
                    and float(torch.linalg.vector_norm(xb[:nq] - xa[:nq])) < 1e-12):
                break
        x_c = 0.5 * (xa + xb)
        j_c = jac_at(x_c)
        rl = _host(res(x_c[:nq], 1.0) - res(x_c[:nq], 0.0))
        lam_c = float(x_c[nq])
        kind, null_vec, coupling = _classify(j_c, rl, fold_tol, lam_host[i], lam_c,
                                             lam_host[i + 1])
        points.append(CriticalPoint(
            segment=i, kind=kind, lam=lam_c, qe=x_c[:nq].clone(),
            null_vector=torch.tensor(null_vec, dtype=dtype, device=device), coupling=coupling))
    return points


def linearized_buckling_loads(load_ref, cfg: cosserat.StaticsConfig = cosserat.StaticsConfig(),
                              tip_moment_ref=(0.0, 0.0, 0.0), qe0=None, iters: int = 24,
                              method: str = "picard", real_tol: float = 1e-8) -> np.ndarray:
    """Critical load factors on a trivial branch, by linear eigenanalysis.

    Needs ``res(qe0, lam) = 0`` for every ``lam`` (checked): then ``J(lam) =
    J0 + lam J1`` exactly, and ``det J(lam) = 0`` iff ``lam = -1/mu`` for a
    nonzero eigenvalue ``mu`` of ``J0^-1 J1``.  Returns the nearly real
    ``lam`` sorted by magnitude (host f64); the smallest positive one is the
    classical buckling load (Euler's ``pi^2 EI / (4 L^2)`` for the
    compressed cantilever, up to the modal basis' Galerkin error).
    """
    res, load_ref = _residual_fn(load_ref, tip_moment_ref, cfg, iters, method)
    nq = cfg.rod.na * cfg.rod.ne
    if qe0 is None:
        qe0 = np.zeros(nq) if cfg.kappa0 is None else np.asarray(cfg.kappa0)
    qe0 = torch.as_tensor(qe0, dtype=load_ref.dtype, device=load_ref.device)
    r0, r1 = np.linalg.norm(_host(res(qe0, 0.0))), np.linalg.norm(_host(res(qe0, 1.0)))
    if r0 > 1e-6 or r1 > 1e-6:
        raise ValueError(
            "linearized_buckling_loads needs a trivial branch: res(qe0, lam) must vanish "
            f"for all lam (got |res(0)| = {r0:.2e}, |res(1)| = {r1:.2e}); use "
            "detect_critical_points along a continuation path instead")
    j0 = _host(locked_jacfwd(res)(qe0, 0.0))
    j1 = _host(locked_jacfwd(res)(qe0, 1.0)) - j0
    mu = np.linalg.eigvals(np.linalg.solve(j0, j1))
    lam = -1.0 / mu[np.abs(mu) > 1e-12]
    lam = np.real(lam[np.abs(lam.imag) <= real_tol * np.maximum(np.abs(lam), 1.0)])
    return lam[np.argsort(np.abs(lam))]


def switch_branch(point: CriticalPoint, load_ref,
                  cfg: cosserat.StaticsConfig = cosserat.StaticsConfig(),
                  tip_moment_ref=(0.0, 0.0, 0.0), direction: float = 1.0, ds: float = 0.1,
                  steps: int = 20, tol: float = 1e-8, max_corrector: int = 25,
                  psi_weight: float = 1.0, iters: int = 24,
                  method: str = "picard") -> cosserat.ContinuationPath:
    """Walk the bifurcated branch out of a branch point (host walker).

    The first tangent is the null direction ``t0 = (direction *
    null_vector, 0)``: the first Riks constraint plane is normal to the
    buckling mode, which the trivial branch cannot meet (its constraint
    residual is ``-ds``), so the first corrector lands on the
    post-buckling branch.  ``direction=-1`` walks the mirror branch.
    """
    res, load_ref = _residual_fn(load_ref, tip_moment_ref, cfg, iters, method)
    dtype, device = load_ref.dtype, load_ref.device
    qe = torch.as_tensor(point.qe, dtype=dtype, device=device)
    nq = qe.shape[0]
    tangent, corrector = cosserat._riks_machinery(res, nq, tol, max_corrector, psi_weight)
    psi0 = torch.as_tensor(point.null_vector, dtype=dtype, device=device)
    psi0 = direction * psi0 / torch.linalg.vector_norm(psi0)
    x0 = torch.cat([qe, torch.tensor([point.lam], dtype=dtype, device=device)])
    return cosserat._riks_walk(tangent, corrector, x0, torch.cat([psi0, psi0.new_zeros(1)]),
                               ds, steps)


def switch_branch_batched(qe_c, lam_c, null_vectors, load_refs,
                          cfg: cosserat.StaticsConfig = cosserat.StaticsConfig(),
                          tip_moment_refs=None, directions=1.0, ds: float = 0.1,
                          steps: int = 20, tol: float = 2e-5, max_corrector: int = 10,
                          psi_weight: float = 1.0, iters: int = 16,
                          monitor_stability: bool = False, dd_residual: bool = False,
                          dd_iters: int = 24,
                          refine_steps: int = 1) -> cosserat.BatchedContinuationPath:
    """A batch of post-buckling walks on the kernels, each corrector iterate
    one K1 + K2 evaluation over the batch (``cosserat._batched_riks_engine``).

    ``qe_c (B, nq)``, ``lam_c (B,)``, ``null_vectors (B, nq)`` anchor each
    sample at its critical point (e.g. one branch point replicated with
    ``directions = [+1, -1]`` for both pitchfork branches); ``load_refs (B,
    3)``.  The first predictor steps along the null direction; no tangent is
    solved at the anchor, where the bordered system is singular.
    f32-grade at the default ``tol``; ``dd_residual=True`` runs the K3
    corrector (path low words in ``qes_lo``/``lambdas_lo``).
    """
    load_refs = as_tensor(load_refs, torch.float32)
    b, device = load_refs.shape[0], load_refs.device
    nq = cfg.rod.na * cfg.rod.ne
    f32 = dict(dtype=torch.float32, device=device)
    qe_c = torch.as_tensor(qe_c, **f32)
    null_vectors = torch.as_tensor(null_vectors, **f32)
    if qe_c.shape != (b, nq) or null_vectors.shape != (b, nq):
        raise ValueError(f"switch_branch_batched: qe_c/null_vectors must be (B, nq) = "
                         f"({b}, {nq}); got {tuple(qe_c.shape)} / {tuple(null_vectors.shape)}")
    tip_moment_refs = (torch.zeros_like(load_refs) if tip_moment_refs is None
                       else torch.as_tensor(tip_moment_refs, **f32).expand(b, 3))
    psi0 = null_vectors / torch.linalg.vector_norm(null_vectors, dim=1, keepdim=True)
    psi0 = psi0 * torch.as_tensor(directions, **f32).expand(b)[:, None]
    lam_c = torch.as_tensor(lam_c, **f32).expand(b)
    x = torch.cat([qe_c, lam_c[:, None]], dim=1).to(torch.float64)
    t0 = torch.cat([psi0, psi0.new_zeros((b, 1))], dim=1)
    return cosserat._batched_riks_engine(
        load_refs, tip_moment_refs, cfg, x, t0, False, ds, steps, tol, max_corrector,
        psi_weight, iters, monitor_stability, dd_residual, dd_iters, refine_steps)
