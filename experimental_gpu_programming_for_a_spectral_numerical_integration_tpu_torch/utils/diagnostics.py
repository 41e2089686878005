"""Numerical diagnostics: Picard bounds, conditioning, convergence, invariants.

Counterpart of the JAX package's ``utils/diagnostics.py``.  Every function
returns plain floats or dicts for logging.  The Picard bounds are host
arithmetic; the others take the rod's tensors (on their own device; numpy
and lists go to the card) and fetch one number each to the host.
``f64_support_report`` is not ported: the card has native FP64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import rod as rod_model
from ..ops import collocation as coll
from ..ops.device import as_tensor

__all__ = [
    "condition_number",
    "quaternion_norm_drift",
    "solution_residual_norm",
    "convergence_report",
    "picard_error_bound",
    "picard_iterations_needed",
]


def picard_error_bound(rho: float, iters: int) -> float:
    """Volterra-series truncation bound ``sum_{j>k} rho^j / j!`` after
    ``k = iters`` Picard steps, with ``rho = |K|_max L / 2`` for the rod
    (geometric tail bound; infinite when ``rho >= iters + 2``)."""
    term = rho ** (iters + 1) / math.factorial(iters + 1)
    if rho < iters + 2:
        return term / (1.0 - rho / (iters + 2))
    return float("inf")


def picard_iterations_needed(rho: float, tol: float = 1e-7,
                             max_iters: int = 200) -> int:
    """Smallest iteration count with :func:`picard_error_bound` <= ``tol``."""
    for k in range(1, max_iters + 1):
        if picard_error_bound(rho, k) <= tol:
            return k
    raise ValueError(
        f"rho={rho} needs >{max_iters} Picard iterations for tol={tol}; "
        "split the rod into segments instead"
    )


def _f64(qe) -> torch.Tensor:
    return as_tensor(qe).to(torch.float64)


def _system(qe: torch.Tensor, cfg: rod_model.RodConfig) -> torch.Tensor:
    """The f64 collocation matrix ``A_NN`` of the quaternion solve ``(..., 4(n-1), 4(n-1))``."""
    m = rod_model._ode_blocks(rod_model.curvature_at_points(cfg, qe)[..., :3])
    return coll.collocation_matrix(cfg.grid(qe.device), m)


def condition_number(qe, cfg: rod_model.RodConfig = rod_model.RodConfig()) -> float:
    """cond_2 of the reduced collocation matrix ``A_NN`` of one strain field,
    by host ``np.linalg.cond`` in f64 (about 186 for the demo strain at N=16)."""
    return float(np.linalg.cond(_system(_f64(qe), cfg).cpu().numpy()))


def _quaternions_f64(solution: rod_model.RodSolution) -> torch.Tensor:
    if solution.quaternions_dd is not None:
        return solution.quaternions_f64()
    return solution.quaternions.to(torch.float64)


def quaternion_norm_drift(solution: rod_model.RodSolution) -> float:
    """``max | |q| - 1 |`` along the rod (and the batch): the unit-norm
    invariant of the quaternion ODE."""
    q = _quaternions_f64(solution)
    return float((torch.linalg.vector_norm(q, dim=-1) - 1.0).abs().max())


def solution_residual_norm(qe, solution: rod_model.RodSolution,
                           cfg: rod_model.RodConfig = rod_model.RodConfig(),
                           q_init=(1.0, 0.0, 0.0, 0.0)) -> float:
    """``||A_NN chi - (b - ivp)||_inf`` of the quaternion solve in f64, over
    the batch.  ``q_init`` must be the initial value the solution was
    computed with (default: the demo's identity quaternion)."""
    qe = _f64(qe)
    a = _system(qe, cfg)
    x = coll.to_component_major(_quaternions_f64(solution).to(qe.device))
    q0 = torch.as_tensor(q_init, dtype=torch.float64, device=qe.device).expand(
        qe.shape[:-1] + (4,))
    rhs = coll.to_component_major(coll.ivp_rhs(cfg.grid(qe.device), q0))
    return float((torch.einsum("...ij,...j->...i", a, x) - rhs).abs().max())


def convergence_report(qe, ns=(8, 12, 16, 24, 32), n_ref: int = 64,
                       method: str = "dense") -> dict:
    """Tip-position error against an ``n_ref`` self-reference for each grid
    order in ``ns``, in f64: the spectral-accuracy curve."""
    qe = _f64(qe)
    ref = rod_model.rod_shape(qe, cfg=rod_model.RodConfig(n=n_ref), method=method).tip_position
    return {n: float((rod_model.rod_shape(qe, cfg=rod_model.RodConfig(n=n),
                                          method=method).tip_position - ref).abs().max())
            for n in ns}
