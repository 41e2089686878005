"""The double-word ``(hi, lo)`` f32 pair surface of the API.

The JAX package carries f64-grade values on f32-only TPU hardware as
unevaluated sums ``hi + lo`` of two f32 words, and does its refined
arithmetic with error-free transformations (``two_sum``, ``two_prod``,
``dd_mul``, ...).  Hopper has native FP64, so the port computes the refined
residuals, tangents and quadratures in true float64 and does **not** port
that arithmetic.  What stays is the pair format the API exposes: strains
may come in as a pair (``models/rod.split_strain``), and refined solutions
go out as pairs (``RodSolution.quaternions_dd`` / ``positions_dd``).
"""

from __future__ import annotations

import torch

from .device import as_tensor

__all__ = ["split_f64", "join_f64", "as_f64"]


def split_f64(a) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a float64 tensor (or array, taken to the default device) into
    an f32 pair: ``hi = f32(a)``, ``lo = f32(a - hi)``; ``hi + lo`` keeps
    ~48 bits of the mantissa."""
    a = as_tensor(a, torch.float64)
    hi = a.to(torch.float32)
    lo = (a - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def join_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The f64 value ``hi + lo`` of a pair (exact: both words fit in f64)."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def as_f64(v, device) -> torch.Tensor:
    """An f32 pair ``(hi, lo)``, or any tensor or array, as one f64 tensor
    on ``device``."""
    if isinstance(v, tuple):
        return join_f64(torch.as_tensor(v[0], device=device), torch.as_tensor(v[1], device=device))
    return torch.as_tensor(v, device=device).to(torch.float64)
