"""Carry the JAX package's state into the port, without importing jax.

The system has no learned weights: its state is the rod and statics
configurations and the f64 spectral constants.  These functions take plain
attributes and NumPy arrays, so the JAX objects can be handed over as they
are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.cosserat import StaticsConfig
from ..models.rod import RodConfig
from ..ops.collocation import SpectralGrid
from ..ops.device import canonical_device

__all__ = ["rod_config_from_jax", "statics_config_from_jax", "grid_from_numpy"]


def rod_config_from_jax(cfg) -> RodConfig:
    """The port's :class:`RodConfig` from any object with the JAX
    ``RodConfig``'s fields ``n``, ``na``, ``ne``, ``length`` and ``basis``."""
    return RodConfig(n=int(cfg.n), na=int(cfg.na), ne=int(cfg.ne),
                     length=float(cfg.length), basis=str(cfg.basis))


def _floats(v):
    """Nested tuples of floats (a stiffness profile stays ``(n, na)``)."""
    if v is None:
        return None
    return tuple(float(x) if np.ndim(x) == 0 else _floats(x) for x in v)


def statics_config_from_jax(cfg) -> StaticsConfig:
    """The port's :class:`StaticsConfig` from any object with the JAX
    ``StaticsConfig``'s fields ``rod``, ``stiffness``, ``kappa0``,
    ``distributed_force`` and ``follower``."""
    return StaticsConfig(rod=rod_config_from_jax(cfg.rod), stiffness=_floats(cfg.stiffness),
                         kappa0=_floats(cfg.kappa0),
                         distributed_force=_floats(cfg.distributed_force),
                         follower=bool(cfg.follower))


def grid_from_numpy(points, dn, dn_nn, dn_in, ginv, device=None) -> SpectralGrid:
    """A :class:`SpectralGrid` on ``device`` (default: the card) from the JAX
    ``SpectralGrid``'s f64 arrays (``dn_in`` may be ``(n-1,)`` or
    ``(n-1, 1)``)."""
    device = canonical_device(device)

    def dev(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=torch.float64,
                            device=device)

    points = dev(points)
    return SpectralGrid(n=int(points.shape[0]), length=float(points[0]),
                        points=points, dn=dev(dn), dn_nn=dev(dn_nn),
                        dn_in=dev(dn_in).reshape(-1), ginv=dev(ginv))
