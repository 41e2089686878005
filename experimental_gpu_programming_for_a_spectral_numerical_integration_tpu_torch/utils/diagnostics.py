"""Picard convergence bounds (host arithmetic, no device work).

Counterpart of the two bounds of the JAX package's ``utils/diagnostics.py``
that ``models/rod.auto_picard_iters`` needs.  The conditioning and drift
reports arrive with the layers that use them.
"""

from __future__ import annotations

import math

__all__ = ["picard_error_bound", "picard_iterations_needed"]


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
