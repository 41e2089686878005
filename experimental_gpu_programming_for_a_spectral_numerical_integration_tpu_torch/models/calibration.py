"""Differentiable rod calibration: gradients through the spectral solve.

Counterpart of the JAX package's ``models/calibration.py``: learn a linear
map ``W : load features -> strain modes`` such that the rod's spectrally
integrated tip position matches observed targets, fitted by Adam with the
full quaternion + position solve as the forward model.  The backward pass
runs through the Picard solve's ``autograd.Function``
(``ops/collocation.solve_ivp_picard_implicit``, the implicit-function vjp),
plain torch on the device: no kernel, as the JAX path is ``method='picard'``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.device import canonical_device
from . import rod

__all__ = [
    "CalibrationParams",
    "init_params",
    "predict_tips",
    "calibration_loss",
    "make_train_step",
]


class CalibrationParams(NamedTuple):
    """Linear strain decoder: ``qe_i = features_i @ w + b``."""

    w: torch.Tensor  # (num_features, na*ne)
    b: torch.Tensor  # (na*ne,)


def init_params(num_features: int, cfg: rod.RodConfig = rod.RodConfig(), scale: float = 0.1,
                seed: int = 0, device=None) -> CalibrationParams:
    """``w ~ scale N(0, 1)`` (f32, drawn on the host from a
    ``torch.Generator`` seeded with ``seed``), ``b = 0``, on ``device``
    (default: the card)."""
    device = canonical_device(device)
    nq = cfg.na * cfg.ne
    gen = torch.Generator().manual_seed(seed)
    w = scale * torch.randn((num_features, nq), generator=gen, dtype=torch.float32)
    return CalibrationParams(w=w.to(device), b=torch.zeros((nq,), dtype=torch.float32,
                                                           device=device))


def predict_tips(params: CalibrationParams, features, cfg: rod.RodConfig = rod.RodConfig(),
                 iters: int = 24):
    """Forward model: features -> strain -> spectral solve -> tip position."""
    qe = torch.as_tensor(features, dtype=params.w.dtype, device=params.w.device) @ params.w
    sol = rod.rod_shape(qe + params.b, cfg=cfg, method="picard", iters=iters)
    return sol.tip_position


def calibration_loss(params: CalibrationParams, features, targets,
                     cfg: rod.RodConfig = rod.RodConfig(), iters: int = 24):
    tips = predict_tips(params, features, cfg, iters)
    targets = torch.as_tensor(targets, dtype=tips.dtype, device=tips.device)
    return torch.mean(torch.sum((tips - targets) ** 2, dim=-1))


def make_train_step(optimizer=None, cfg: rod.RodConfig = rod.RodConfig(), iters: int = 24):
    """One Adam step through the spectral solve.

    Returns ``(step, optimizer_factory)``: ``optimizer_factory(params)``
    marks the parameters as trainable and builds the optimizer over them
    (``optimizer``, a factory ``params -> torch.optim.Optimizer``; default
    ``torch.optim.Adam(params, lr=1e-2)``), and ``step(params, opt,
    features, targets) -> (params, opt, loss)`` updates them in place.
    """
    build = optimizer if optimizer is not None else (
        lambda params: torch.optim.Adam(params, lr=1e-2))

    def optimizer_factory(params: CalibrationParams):
        for p in params:
            p.requires_grad_(True)
        return build(list(params))

    def step(params: CalibrationParams, opt, features, targets):
        opt.zero_grad()
        loss = calibration_loss(params, features, targets, cfg, iters)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return step, optimizer_factory
