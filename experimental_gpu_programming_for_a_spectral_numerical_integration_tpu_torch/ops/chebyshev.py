"""Chebyshev–Gauss–Lobatto (CGL) spectral primitives as host f64 constants.

Counterpart of the JAX package's ``ops/chebyshev.py``.  Every function here
is NumPy float64 and runs on the host; the results are moved to a device
once and cached there (``ops/collocation.make_grid``).  The grid is the
reference's **descending** CGL grid: ``x[0] = L`` is the rod tip and
``x[n-1] = 0`` the base that carries the initial condition.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "cgl_points",
    "coefficients_c",
    "diff_matrix",
    "split_endpoint",
    "integration_matrix",
    "partial_integral_matrix",
    "clenshaw_curtis_weights",
]


def _frozen(a: np.ndarray) -> np.ndarray:
    """Cached constants are shared by every caller in the process; make an
    in-place edit fail loudly instead of corrupting later solves."""
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def cgl_points(n: int, length: float = 1.0) -> np.ndarray:
    """CGL points ``x_j = (L/2)(1 + cos(pi j/(n-1)))`` on ``[0, L]``, descending."""
    if n < 2:
        raise ValueError(f"need at least 2 CGL points, got {n}")
    j = np.arange(n, dtype=np.float64)
    return _frozen((float(length) / 2.0) * (1.0 + np.cos(np.pi * j / (n - 1))))


@functools.lru_cache(maxsize=None)
def coefficients_c(n: int) -> np.ndarray:
    """Trefethen weights ``c_i = (-1)^i`` times 2 at the endpoints, 1 inside."""
    c = np.ones(n, dtype=np.float64)
    c[0] = 2.0
    c[-1] = 2.0
    c *= (-1.0) ** np.arange(n)
    return _frozen(c)


@functools.lru_cache(maxsize=None)
def diff_matrix(n: int, length: float = 1.0) -> np.ndarray:
    """The ``n x n`` differentiation matrix on the CGL grid.

    Off the diagonal ``D_ij = (c_i/c_j)/(x_i - x_j)``.  The diagonal is the
    negative row sum, ``D_ii = -sum_{j != i} D_ij``, so that constants
    differentiate to zero to machine precision.
    """
    x = cgl_points(n, length)
    c = coefficients_c(n)
    dx = x[:, None] - x[None, :] + np.eye(n)
    d = (c[:, None] / c[None, :]) / dx
    d[np.diag_indices(n)] -= d.sum(axis=1)
    return _frozen(d)


def split_endpoint(d: np.ndarray, known: str = "last"):
    """Split ``D`` into the unknown block ``D_NN`` and the known column ``D_IN``.

    ``known='last'``: the initial condition sits at ``x[n-1] = 0`` and the
    unknowns are points ``0..n-2`` (tip first).  ``known='first'``: the
    mirrored split for a value given at ``x[0]``.
    """
    n = d.shape[0]
    if known == "last":
        return d[: n - 1, : n - 1], d[: n - 1, n - 1:]
    if known == "first":
        return d[1:, 1:], d[1:, :1]
    raise ValueError(f"known must be 'first' or 'last', got {known!r}")


@functools.lru_cache(maxsize=None)
def integration_matrix(n: int, length: float = 1.0,
                       known: str = "last") -> np.ndarray:
    """``G = D_NN^{-1}``, the discrete spectral integration operator (f64 solve)."""
    d_nn, _ = split_endpoint(diff_matrix(n, length), known)
    return _frozen(np.linalg.solve(d_nn, np.eye(d_nn.shape[0])))


@functools.lru_cache(maxsize=None)
def partial_integral_matrix(n: int, length: float = 1.0) -> np.ndarray:
    """``T``: values on the full grid -> tail integrals ``int_{x_i}^{L} f``.

    From the spectral antiderivative ``F = G f`` (``F(0) = 0``):
    ``int_{x_i}^L f = F(tip) - F(x_i)``, the tip at index 0 (descending
    order).  Row ``n-1`` (the base) is the full integral; the base column
    is zero.  Used by the distributed load of the statics residual.
    """
    g = integration_matrix(n, length)
    t = np.zeros((n, n))
    t[: n - 1, : n - 1] = g[0][None, :] - g
    t[n - 1, : n - 1] = g[0]
    return _frozen(t)


@functools.lru_cache(maxsize=None)
def clenshaw_curtis_weights(n: int, length: float = 1.0) -> np.ndarray:
    """Clenshaw–Curtis weights on the descending grid: ``sum_j w_j f(x_j)``
    integrates polynomials of degree ``<= n-1`` over ``[0, L]`` exactly.
    Solved from the Chebyshev moment system ``V^T w = m`` in f64."""
    t = 2.0 * cgl_points(n) - 1.0
    k = np.arange(n)
    v = np.cos(np.outer(np.arccos(np.clip(t, -1.0, 1.0)), k))
    moments = np.zeros(n)
    even = k[k % 2 == 0]
    moments[even] = 2.0 / (1.0 - even.astype(np.float64) ** 2)
    w = np.linalg.solve(v.T, moments)
    return _frozen(w * (float(length) / 2.0))
