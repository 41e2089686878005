"""Spectral collocation IVP solves on batched tensors.

Counterpart of the JAX package's ``ops/collocation.py``.  The problem is a
linear matrix ODE ``y' = M(X) y + g`` on ``[0, L]`` with ``y`` given at the
last (descending) CGL point; collocating at the ``n-1`` unknown points gives

    (I_d ⊗ Dn_NN - M_hat) chi = g - (I_d ⊗ Dn_IN) y0.

The state is kept point-major, ``(..., n-1, d)``; ``I ⊗ Dn_NN`` is one
product over the point axis and ``M_hat`` a per-point ``d x d`` action.
Solvers:

* :func:`solve_ivp_dense`: the assembled system through ``torch.linalg.solve``
  (the reference path, in f64 when the blocks are f64);
* :func:`solve_ivp_picard`: the Picard/Neumann iteration
  ``chi <- G rhs + G M_hat chi`` with ``G = Dn_NN^{-1}``;
* :func:`solve_ivp_refined`: an f32 Picard solve refined against a residual
  taken in true float64.  The JAX package evaluates that residual in
  double-word f32; Hopper has native FP64, so this port does not.  The
  refined functions keep the JAX signatures: ``(hi, lo)`` f32 pairs in and
  out, joined to f64 on entry and split on exit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import chebyshev
from . import doubledouble as dd
from .device import canonical_device
from .lie import quat_skew_apply

__all__ = [
    "SpectralGrid",
    "make_grid",
    "to_component_major",
    "from_component_major",
    "ivp_rhs",
    "collocation_matrix",
    "solve_ivp_dense",
    "solve_ivp_picard",
    "solve_ivp_picard_implicit",
    "residual_quat_dd",
    "solve_ivp_refined",
    "quadrature_refined",
]


@dataclass(frozen=True, eq=False)
class SpectralGrid:
    """The float64 spectral operators of one ``(n, length)`` grid on one device."""

    n: int
    length: float
    points: torch.Tensor        # (n,) descending CGL points on [0, length]
    dn: torch.Tensor            # (n, n) differentiation matrix
    dn_nn: torch.Tensor         # (n-1, n-1) unknown block
    dn_in: torch.Tensor         # (n-1,) known-endpoint column
    ginv: torch.Tensor          # (n-1, n-1) inverse of dn_nn

    @property
    def num_unknown(self) -> int:
        return self.n - 1


def make_grid(n: int, length: float = 1.0, known: str = "last",
              device=None) -> SpectralGrid:
    """The grid's f64 host constants, moved to ``device`` (default: the
    card) once and cached.

    ``known='last'``: the boundary value sits at ``x[n-1] = 0``, the
    reference's IVP case; the unknowns are points ``0..n-2``, tip first.
    """
    return _make_grid(int(n), float(length), known, canonical_device(device))


@functools.lru_cache(maxsize=None)
def _make_grid(n: int, length: float, known: str,
               device: torch.device) -> SpectralGrid:
    dn = chebyshev.diff_matrix(n, length)
    dn_nn, dn_in = chebyshev.split_endpoint(dn, known=known)
    ginv = chebyshev.integration_matrix(n, length, known=known)

    def dev(a):
        return torch.tensor(a, dtype=torch.float64, device=device)

    return SpectralGrid(
        n=n,
        length=length,
        points=dev(chebyshev.cgl_points(n, length)),
        dn=dev(dn),
        dn_nn=dev(dn_nn),
        dn_in=dev(dn_in[:, 0]),
        ginv=dev(ginv),
    )


def to_component_major(s: torch.Tensor) -> torch.Tensor:
    """``(..., np, d)`` point-major to the reference's flat ``(..., d*np)``:
    ``flat[c*np + i] = s[i, c]``."""
    npts, d = s.shape[-2], s.shape[-1]
    return s.transpose(-1, -2).reshape(s.shape[:-2] + (d * npts,))


def from_component_major(flat: torch.Tensor, npts: int, d: int) -> torch.Tensor:
    """Inverse of :func:`to_component_major`."""
    return flat.reshape(flat.shape[:-1] + (d, npts)).transpose(-1, -2)


def ivp_rhs(grid: SpectralGrid, y0: torch.Tensor, g: torch.Tensor | None = None,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """``rhs[i, c] = g[i, c] - Dn_IN[i] y0[c]``, point-major ``(..., np, d)``."""
    dtype = dtype or y0.dtype
    ivp = grid.dn_in.to(dtype)[:, None] * y0.to(dtype)[..., None, :]
    return -ivp if g is None else g.to(dtype) - ivp


def collocation_matrix(grid: SpectralGrid, m_blocks: torch.Tensor) -> torch.Tensor:
    """Dense component-major system ``I_d ⊗ Dn_NN - M_hat``, ``(..., d*np, d*np)``.

    ``m_blocks``: ``(..., np, d, d)`` per-point ODE matrices.
    """
    dtype, device = m_blocks.dtype, m_blocks.device
    npts, d = grid.num_unknown, m_blocks.shape[-1]
    eye_d = torch.eye(d, dtype=dtype, device=device)
    eye_p = torch.eye(npts, dtype=dtype, device=device)
    # a[c, i, e, j] = delta_ce Dn_NN[i, j] - delta_ij M[i, c, e]
    kron = torch.einsum("ce,ij->ciej", eye_d, grid.dn_nn.to(dtype))
    mhat = torch.einsum("ij,...ice->...ciej", eye_p, m_blocks)
    a = kron - mhat
    return a.reshape(a.shape[:-4] + (d * npts, d * npts))


def solve_ivp_dense(grid: SpectralGrid, m_blocks: torch.Tensor, y0: torch.Tensor,
                    g: torch.Tensor | None = None) -> torch.Tensor:
    """Batched dense solve of the collocation system (``torch.linalg.solve``,
    never an inverse).  Returns ``(..., np, d)``."""
    d = m_blocks.shape[-1]
    a = collocation_matrix(grid, m_blocks)
    rhs = ivp_rhs(grid, y0, g, dtype=m_blocks.dtype)
    flat = torch.linalg.solve(a, to_component_major(rhs).unsqueeze(-1)).squeeze(-1)
    return from_component_major(flat, grid.num_unknown, d)


def _grid_matmul(mat: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``out[i, c] = sum_j mat[i, j] s[j, c]`` over the point axis."""
    return torch.matmul(mat.to(s.dtype), s)


def _apply_point_blocks(m_blocks: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``out[i, c] = sum_e M[i, c, e] s[i, e]``."""
    return torch.einsum("...ice,...ie->...ic", m_blocks, s)


def solve_ivp_picard(grid: SpectralGrid, m_blocks: torch.Tensor, y0=None, g=None,
                     rhs: torch.Tensor | None = None, iters: int = 24) -> torch.Tensor:
    """Preconditioned Picard/Neumann solve of ``(I ⊗ Dn_NN - M_hat) chi = rhs``.

    ``G M_hat`` is the discrete Volterra operator of the ODE, so the
    iteration converges factorially in ``iters``.  Pass ``y0`` (and an
    optional forcing ``g``) or a ready ``rhs``.
    """
    dtype = m_blocks.dtype
    ginv = grid.ginv.to(dtype)
    if rhs is None:
        rhs = ivp_rhs(grid, y0, g, dtype=dtype)
    g_rhs = _grid_matmul(ginv, rhs.to(dtype))
    chi = g_rhs
    for _ in range(iters):
        chi = g_rhs + _grid_matmul(ginv, _apply_point_blocks(m_blocks, chi))
    return chi


def solve_ivp_picard_implicit(grid: SpectralGrid, m_blocks: torch.Tensor,
                              rhs: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """The Picard solve that ``rod_shape(method='picard')`` calls.

    Forward only in this port: the JAX version carries an implicit-function
    tangent rule for the statics Newton, and its ``torch.autograd.Function``
    arrives with the statics layer.  Autograd through this function
    differentiates the unrolled iteration.
    """
    return solve_ivp_picard(grid, m_blocks, rhs=rhs, iters=iters)


def _residual_f64(grid: SpectralGrid, x: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``rhs - (I ⊗ Dn_NN) x`` in float64."""
    return rhs - torch.matmul(grid.dn_nn, x)


def residual_quat_dd(grid: SpectralGrid, k_dd, x_hi, x_lo, rhs_hi, rhs_lo):
    """Rod residual ``rhs - (I ⊗ Dn_NN) x + 1/2 A(K) x`` taken in float64.

    ``k_dd``: the curvature as an f32 pair ``(..., np, 3)``; ``x`` and
    ``rhs`` are f32 pairs ``(..., np, 4)``.  Returns an f32 pair.
    """
    x = dd.join_f64(x_hi, x_lo)
    r = _residual_f64(grid, x, dd.join_f64(rhs_hi, rhs_lo))
    r = r + quat_skew_apply(0.5 * dd.join_f64(*k_dd), x)
    return dd.split_f64(r)


def solve_ivp_refined(grid: SpectralGrid, m_dd, rhs_dd, iters: int = 24,
                      refine_steps: int = 2):
    """f32 Picard solve plus ``refine_steps`` steps of iterative refinement
    against the float64 residual.  ``m_dd``, ``rhs_dd``: f32 pairs.  Returns
    the solution as an f32 pair ``(x_hi, x_lo)``."""
    m_hi = m_dd[0]
    m = dd.join_f64(*m_dd)
    rhs = dd.join_f64(*rhs_dd)
    x = solve_ivp_picard(grid, m_hi, rhs=rhs_dd[0], iters=iters).to(torch.float64)
    for _ in range(refine_steps):
        r = _residual_f64(grid, x, rhs) + _apply_point_blocks(m, x)
        delta = solve_ivp_picard(grid, m_hi, rhs=r.to(torch.float32), iters=iters)
        x = x + delta.to(torch.float64)
    return dd.split_f64(x)


def quadrature_refined(grid: SpectralGrid, rhs_dd, refine_steps: int = 1):
    """Pure quadrature ``Dn_NN x = rhs`` (the position solve) in float64:
    ``x = G rhs`` and ``refine_steps`` refinement steps against the f64
    residual.  ``rhs_dd``: an f32 pair; returns an f32 pair."""
    rhs = dd.join_f64(*rhs_dd)
    x = torch.matmul(grid.ginv, rhs)
    for _ in range(refine_steps):
        x = x + torch.matmul(grid.ginv, _residual_f64(grid, x, rhs))
    return dd.split_f64(x)
