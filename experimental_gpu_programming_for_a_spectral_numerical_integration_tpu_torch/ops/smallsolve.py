"""Batched tiny dense solves: the JAX package's Newton-step solver.

Counterpart of the JAX package's ``ops/smallsolve.py``.  The statics Newton
solves one ``nq x nq`` system per rod, ``nq = na*ne`` in {9, 18}.  The JAX
package wrote an unrolled Gauss-Jordan elimination because the TPU's batched
LU was slow on such shapes; this module keeps its semantics (partial
pivoting by one-hot row swaps, the first maximal pivot on ties) as plain
batched torch operations.  ``chip_smoke.py`` times it beside
``torch.linalg.solve`` on ``(B, 9, 9)``: on an H100 the library is ~26x
faster, so the port's statics Newton calls ``torch.linalg.solve_ex`` and
nothing in the port calls this function.
"""

from __future__ import annotations

import torch

__all__ = ["gauss_jordan_solve"]


def gauss_jordan_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for small ``n``, batched over leading axes.

    ``a``: ``(..., n, n)``; ``b``: ``(..., n, m)`` or ``(..., n)``.  Each of
    the ``n`` steps picks the largest ``|a[i, k]|`` over ``i >= k``, swaps it
    into row ``k`` with two rank-1 corrections (exact no-ops when the pivot is
    in place) and eliminates column ``k`` from every other row.
    """
    squeeze = b.ndim == a.ndim - 1
    if squeeze:
        b = b[..., None]
    n = a.shape[-1]
    aug = torch.cat([a, b.to(a.dtype)], dim=-1)
    idx = torch.arange(n, device=a.device)
    below = torch.full((n,), -torch.inf, dtype=a.dtype, device=a.device)
    for k in range(n):
        col = torch.where(idx >= k, aug[..., :, k].abs(), below)
        p = torch.argmax(col, dim=-1)
        sel_p = (idx == p[..., None]).to(a.dtype)                 # (..., n)
        row_p = torch.einsum("...n,...nm->...m", sel_p, aug)
        row_k = aug[..., k, :]
        sel_k = (idx == k).to(a.dtype)
        aug = (aug + sel_k[..., :, None] * (row_p - row_k)[..., None, :]
               + sel_p[..., :, None] * (row_k - row_p)[..., None, :])
        piv_row = aug[..., k, :]
        factor = aug[..., :, k] * (1.0 / piv_row[..., k, None]) * (1.0 - sel_k)
        aug = aug - factor[..., :, None] * piv_row[..., None, :]
    diag = torch.diagonal(aug[..., :, :n], dim1=-2, dim2=-1)
    x = aug[..., :, n:] / diag[..., :, None]
    return x[..., 0] if squeeze else x
