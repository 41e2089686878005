"""Magnetic actuation: a magnetized rod in an applied field.

Counterpart of the JAX package's ``models/magnetics.py``.  A magnetization
density ``m(X)`` (dipole moment per unit arclength, body frame) in an
applied field ``B(r)`` has the potential energy

    U(qe; B) = - int_0^L ( R(q(X)) m(X) ) . B( r(X) ) dX,

evaluated with the Clenshaw-Curtis weights of the rod grid; the load on the
strain modes is ``-dU/dqe``, the distributed torque ``m_world x B`` and the
gradient pull ``grad (m_world . B)`` in one gradient
(``dynamics._mass_and_rhs`` takes it as one more ``(r, q)`` cotangent).

Field spec: a 3-vector ``B0`` (uniform field), a pair ``(B0, G)`` with
``G[i, j] = dB_i/dr_j`` (uniform field plus uniform gradient,
``B(r) = B0 + G r``), or, in ``dynamics.simulate``, a callable of the stage
time returning either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import lie
from ..ops.device import default_device

__all__ = [
    "Magnet",
    "magnetization_table",
    "parse_field",
    "field_at",
    "energy_from_state",
]


@dataclass(frozen=True)
class Magnet:
    """One magnetization distribution along the rod (body frame).

    ``fn``: a hashable callable mapping the normalized global arclength
    ``X (n,)`` (descending, tip to base) to body-frame dipole densities
    ``(n, 3)``; otherwise ``moment``, a constant body-frame density
    (``(m, 0, 0)`` is magnetized along the backbone).  Several magnets on one
    config superpose: their tables sum.
    """

    moment: tuple = (0.0, 0.0, 0.0)
    fn: Callable | None = None

    def table(self, xs: np.ndarray) -> np.ndarray:
        """``(n, 3)`` f64 body-frame dipole density at normalized arclengths."""
        if self.fn is not None:
            t = np.asarray(self.fn(np.asarray(xs, np.float64)), np.float64)
            if t.shape != (len(xs), 3):
                raise ValueError(f"Magnet.fn returned {t.shape}, need ({len(xs)}, 3)")
            return t
        return np.broadcast_to(np.asarray(self.moment, np.float64), (len(xs), 3)).copy()


def magnetization_table(magnets: tuple, xs: np.ndarray) -> np.ndarray:
    """Summed ``(n, 3)`` f64 dipole-density table of ``magnets``."""
    out = np.zeros((len(xs), 3))
    for m in magnets:
        out += m.table(xs)
    return out


def _field_tensor(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.as_tensor(v, dtype=dtype, device=default_device() if device is None else device)


def parse_field(b_field, dtype, device=None):
    """``(b0 (..., 3), g (..., 3, 3) or None)`` from a field spec.

    A 2-element tuple or list is the ``(B0, G)`` pair; anything else is a
    uniform field ``(..., 3)``.  Tensors keep their device; other input goes
    to ``device`` (default: the card).
    """
    if isinstance(b_field, (tuple, list)) and len(b_field) == 2:
        b0, g = b_field
        g = _field_tensor(g, dtype, device)
        if g.shape[-2:] != (3, 3):
            raise ValueError(f"(B0, G) field spec needs a (..., 3, 3) gradient, got "
                             f"{tuple(g.shape)}")
        return _field_tensor(b0, dtype, g.device), g
    return _field_tensor(b_field, dtype, device), None


def field_at(b_field, t):
    """A field protocol at time ``t``: ``None`` passes, a callable is called
    with ``t``, anything else is a constant spec."""
    if b_field is None:
        return None
    if callable(b_field):
        return b_field(t)
    return b_field


def energy_from_state(r, q, w_q, m_table, b0, g=None):
    """``U = -int (R m) . B(r) dX`` from the full-grid state ``r (..., n, 3)``,
    ``q (..., n, 4)`` (tip first, base appended), quadrature weights ``w_q
    (n,)``, the dipole table ``m_table (n, 3)``, a uniform field ``b0 (...,
    3)`` and an optional gradient ``g (..., 3, 3)``."""
    m_world = lie.quat_rotate_normalized(q, m_table.expand(q.shape[:-1] + (3,)))
    b = b0[..., None, :]
    if g is not None:
        b = b + torch.einsum("...ij,...nj->...ni", g, r)
    return -torch.einsum("j,...jc,...jc->...", w_q, m_world, b)
