"""Plain rod solve: dense Chebyshev collocation in PyTorch.

The reference's algorithm (``main.cpp:55-172``), written out without any
code of the program under test:

* the descending Chebyshev-Gauss-Lobatto grid ``x_j = (L/2)(1 + cos(pi j/(n-1)))``,
  the tip at ``j = 0`` and the base, which carries the initial values, at
  ``j = n-1``; the differentiation matrix ``D`` with the negative row sum on
  its diagonal;
* the curvature ``K_a(x) = sum_e qe[a, e] P_e(2x/L - 1)`` in Legendre modes,
  ``qe`` mode-major within each component;
* the quaternion ODE ``Q' = 1/2 A(K) Q``, ``Q(0) = (1, 0, 0, 0)``, solved as
  ONE dense system ``(D_NN ⊗ I_4 - blockdiag 1/2 A(K_i)) Q = -D_IN ⊗ q0``
  per rod;
* the centreline ``r' = R(Q) e1`` with the unnormalized rotation of the
  reference (``main.cpp:130-136``), ``r(0) = 0``: ``D_NN r = b``, solved.

Everything runs in the dtype asked for (float64 for the reference, float32
for the control), in blocks of rods so that a batch of 2^20 fits.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cgl_points", "diff_matrix", "legendre_table", "curvature", "quat_skew",
           "tangent", "solve", "rel_linf"]

DEMO_QE = (0.0, 0.0, 0.0, 1.2877691307032, -1.63807499160786, 0.437406679142598,
           0.0, 0.0, 0.0)


def cgl_points(n: int, length: float = 1.0, dtype=torch.float64, device=None) -> torch.Tensor:
    j = torch.arange(n, dtype=torch.float64, device=device)
    return ((length / 2.0) * (1.0 + torch.cos(math.pi * j / (n - 1)))).to(dtype)


def diff_matrix(n: int, length: float = 1.0, dtype=torch.float64, device=None) -> torch.Tensor:
    """``D_ij = (c_i/c_j)/(x_i - x_j)`` off the diagonal, ``c = (2, 1, ..., 1, 2)
    (-1)^i``; ``D_ii = -sum_{j != i} D_ij``.  Built in float64."""
    x = cgl_points(n, length, torch.float64, device)
    c = torch.ones(n, dtype=torch.float64, device=device)
    c[0] = c[-1] = 2.0
    c = c * (-1.0) ** torch.arange(n, dtype=torch.float64, device=device)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    d = (c[:, None] / c[None, :]) / (x[:, None] - x[None, :] + eye)
    d = d * (1.0 - eye)
    d = d - torch.diag(d.sum(dim=1))
    return d.to(dtype)


def legendre_table(points: torch.Tensor, ne: int, length: float = 1.0) -> torch.Tensor:
    """``P_e(2x/L - 1)`` for ``e < ne``: ``(npts, ne)`` (Bonnet's recurrence)."""
    t = 2.0 * points / length - 1.0
    vals = [torch.ones_like(t), t]
    for k in range(1, ne - 1):
        vals.append(((2 * k + 1) * t * vals[k] - k * vals[k - 1]) / (k + 1))
    return torch.stack(vals[:ne], dim=-1)


def curvature(qe: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``(B, na*ne)`` modes and a ``(npts, ne)`` table -> ``(B, npts, na)``."""
    ne = table.shape[-1]
    modes = qe.reshape(qe.shape[0], -1, ne)
    return torch.einsum("bae,pe->bpa", modes, table)


def quat_skew(k: torch.Tensor) -> torch.Tensor:
    """``A(K)`` of ``Q' = 1/2 A(K) Q`` for ``Q = (w, x, y, z)``: ``(..., 4, 4)``."""
    k0, k1, k2 = k.unbind(-1)
    z = torch.zeros_like(k0)
    return torch.stack([
        torch.stack([z, -k0, -k1, -k2], -1),
        torch.stack([k0, z, k2, -k1], -1),
        torch.stack([k1, -k2, z, k0], -1),
        torch.stack([k2, k1, -k0, z], -1)], -2)


def tangent(q: torch.Tensor) -> torch.Tensor:
    """``R(q) e1`` with the unnormalized rotation matrix's first column."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + w * z),
                        2.0 * (x * z - w * y)], -1)


def _operators(n: int, ne: int, length: float, dtype, device):
    d = diff_matrix(n, length, torch.float64, device)
    x = cgl_points(n, length, torch.float64, device)
    return (d[:n - 1, :n - 1].to(dtype), d[:n - 1, n - 1].to(dtype),
            legendre_table(x[:n - 1], ne, length).to(dtype))


def solve(qe: torch.Tensor, n: int = 16, ne: int = 3, length: float = 1.0,
          dtype=torch.float64, block: int = 32768):
    """``qe (B, 3*ne)`` -> ``(Q (B, n-1, 4), r (B, n-1, 3))`` at the unknown
    points, tip first, computed in ``dtype`` in blocks of ``block`` rods."""
    if qe.shape[-1] != 3 * ne:
        raise ValueError(f"the plain rod solve takes 3 curvature components x {ne} modes, "
                         f"got {qe.shape[-1]} strain entries")
    device = qe.device
    n1 = n - 1
    dnn, din, table = _operators(n, ne, length, dtype, device)
    lifted = torch.kron(dnn, torch.eye(4, dtype=dtype, device=device))     # (4 n1, 4 n1)
    rhs = torch.zeros(4 * n1, 1, dtype=dtype, device=device)
    rhs[0::4, 0] = -din                                                    # q0 = (1, 0, 0, 0)
    qs, rs = [], []
    for start in range(0, qe.shape[0], block):
        qb = qe[start:start + block].to(dtype)
        b = qb.shape[0]
        a = 0.5 * quat_skew(curvature(qb, table))                           # (b, n1, 4, 4)
        system = lifted.expand(b, -1, -1).clone()
        for i in range(n1):
            system[:, 4 * i:4 * i + 4, 4 * i:4 * i + 4] -= a[:, i]
        q = torch.linalg.solve(system, rhs.expand(b, -1, -1)).reshape(b, n1, 4)
        r = torch.linalg.solve(dnn.expand(b, -1, -1), tangent(q))
        qs.append(q)
        rs.append(r)
    return torch.cat(qs), torch.cat(rs)


def rel_linf(x: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |x - ref| / max |ref|`` over every entry, in float64 (NaN if
    ``x`` holds one)."""
    x, ref = x.to(torch.float64), ref.to(torch.float64)
    err = (x - ref).abs().max()
    if bool(torch.isnan(x).any()):
        return float("nan")
    return float(err / ref.abs().max())
