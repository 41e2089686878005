"""Modal strain bases: host f64 tables and the on-device strain contraction.

Counterpart of the JAX package's ``ops/basis.py``.  The basis table
``P[i, e] = P_e(x_i)`` over a grid is a NumPy f64 host constant; the strain
field of a batch of rods is then one small contraction ``K = modes @ P^T``
on whatever device the strain tensor lives on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "legendre_vals",
    "chebyshev_t_vals",
    "to_reference_domain",
    "basis_table",
    "phi_matrix",
    "strain_at_points",
]


def to_reference_domain(x, begin: float = 0.0, end: float = 1.0):
    """Map the rod-normalized coordinate to ``[-1, 1]``."""
    return (2.0 * x - (end + begin)) / (end - begin)


def legendre_vals(x, num_modes: int) -> np.ndarray:
    """``P_0(x) .. P_{num_modes-1}(x)`` on a trailing axis (Bonnet recurrence)."""
    x = np.asarray(x, dtype=np.float64)
    vals = [np.ones_like(x)]
    if num_modes > 1:
        vals.append(x.copy())
    for n in range(1, num_modes - 1):
        vals.append(((2 * n + 1) * x * vals[n] - n * vals[n - 1]) / (n + 1))
    return np.stack(vals[:num_modes], axis=-1)


def chebyshev_t_vals(x, num_modes: int) -> np.ndarray:
    """``T_0(x) .. T_{num_modes-1}(x)`` on a trailing axis."""
    x = np.asarray(x, dtype=np.float64)
    vals = [np.ones_like(x)]
    if num_modes > 1:
        vals.append(x.copy())
    for n in range(1, num_modes - 1):
        vals.append(2.0 * x * vals[n] - vals[n - 1])
    return np.stack(vals[:num_modes], axis=-1)


_BASES = {
    "legendre": legendre_vals,
    "chebyshev": chebyshev_t_vals,
}


@functools.lru_cache(maxsize=None)
def basis_table(points: tuple, num_modes: int, basis: str = "legendre",
                begin: float = 0.0, end: float = 1.0) -> np.ndarray:
    """f64 host table ``P[i, e] = P_e(x_i)`` over a static grid.

    ``points`` is a tuple of rod-normalized coordinates (hashable, so the
    table is cached per grid).
    """
    x = to_reference_domain(np.asarray(points, dtype=np.float64), begin, end)
    table = np.asarray(_BASES[basis](x, num_modes), dtype=np.float64)
    table.setflags(write=False)
    return table


def phi_matrix(x, na: int, ne: int, basis: str = "legendre",
               begin: float = 0.0, end: float = 1.0) -> np.ndarray:
    """The reference's block matrix ``Phi(X) = I_na ⊗ P(x)^T``, ``(na, na*ne)``."""
    p = _BASES[basis](to_reference_domain(np.float64(x), begin, end), ne)
    out = np.zeros((na, na * ne), dtype=np.float64)
    for a in range(na):
        out[a, a * ne:(a + 1) * ne] = p
    return out


def strain_at_points(qe: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Strain field on the whole grid: ``(..., na*ne) -> (..., npts, na)``.

    ``qe`` is mode-major within each strain component; ``table`` is a
    ``(npts, ne)`` tensor on ``qe``'s device, cast to ``qe``'s dtype.
    """
    table = table.to(device=qe.device, dtype=qe.dtype)
    ne = table.shape[-1]
    modes = qe.reshape(qe.shape[:-1] + (qe.shape[-1] // ne, ne))
    return torch.einsum("...ae,pe->...pa", modes, table)
