"""Dynamic state estimation: EKF and RTS smoothing of rod motion.

Counterpart of the JAX package's ``models/estimation.py``.  An extended
Kalman filter whose process model is one RK4 step of the strain-space
Lagrangian dynamics (:mod:`.dynamics`) and whose measurement model is the
sensing map (:func:`.sensing.measure`), and the Rauch-Tung-Striebel backward
pass.  The transition Jacobian ``F`` is the forward-mode linearization of
the whole RK4 step (one jvp per unit state direction through its four
``accelerations`` calls), ``H`` that of the sensing map.

State ``x = [qe, qd] (..., 2 nq)``; every operation keeps the leading batch
axes, so B independent filters run together.  The time loops are host
loops with no host sync; covariances take the Joseph-stabilized update.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.device import as_tensor
from . import cosserat
from . import dynamics as dynamics_mod
from . import sensing as sensing_mod

__all__ = [
    "FilterConfig",
    "FilterResult",
    "ekf",
    "rts_smoother",
    "simulate_measurements",
]


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Process and measurement models and their noise levels (frozen).

    ``q_accel``: white modal-acceleration process noise, discretized per
    mode as ``Q = q_accel [[dt^4/4, dt^3/2], [dt^3/2, dt^2]]``.
    ``r_sigma``: i.i.d. measurement noise std in the weighted measurement
    space of :func:`.sensing.measure`.
    """

    dynamics: dynamics_mod.DynamicsConfig
    sensing: sensing_mod.SensingConfig
    dt: float
    q_accel: float = 1e-6
    r_sigma: float = 1e-3
    iters: int = 12

    def __post_init__(self):
        if self.dynamics.rod != self.sensing.rod:
            raise ValueError("dynamics and sensing rod configs differ")

    @property
    def nq(self) -> int:
        return self.dynamics.nq

    @functools.cached_property
    def process_noise(self) -> np.ndarray:
        """(2 nq, 2 nq) discretized white-acceleration covariance."""
        nq, dt = self.nq, self.dt
        eye = np.eye(nq)
        q = np.block([[dt ** 4 / 4.0 * eye, dt ** 3 / 2.0 * eye],
                      [dt ** 3 / 2.0 * eye, dt ** 2 * eye]])
        return self.q_accel * q


class FilterResult(NamedTuple):
    """Stacked filter history, leading time axis: the posterior ``xs (steps,
    ..., 2nq)`` / ``covs``, the priors ``xs_pred`` / ``covs_pred``, the step
    Jacobians ``fs`` (for the RTS pass) and the normalized innovation squared
    ``nis (steps, ...)`` (mean near the measurement dimension when the
    filter is consistent)."""

    xs: torch.Tensor
    covs: torch.Tensor
    xs_pred: torch.Tensor
    covs_pred: torch.Tensor
    fs: torch.Tensor
    nis: torch.Tensor


def _rk4_step(x, t, cfg: FilterConfig, tip_force=None, tip_moment=None):
    """One RK4 step of the strain-space dynamics on the packed state; ``t``
    a 0-d tensor on ``x``'s device (drives are constants or callables of
    it)."""
    nq, dt = cfg.nq, cfg.dt

    def deriv(xx, tt):
        qe, qd = xx[..., :nq], xx[..., nq:]
        qdd = dynamics_mod.accelerations(
            qe, qd, cfg.dynamics, dynamics_mod._load_at(tip_force, tt, xx), cfg.iters,
            tip_moment=dynamics_mod._load_at(tip_moment, tt, xx))
        return torch.cat([qd, qdd], dim=-1)

    k1 = deriv(x, t)
    k2 = deriv(x + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = deriv(x + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = deriv(x + dt * k3, t + dt)
    return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def _measure_state(x, cfg: FilterConfig):
    return sensing_mod.measure(x[..., :cfg.nq], cfg.sensing)


def _jac_columns(fn, x, width: int):
    """``(..., out, width)`` forward-mode Jacobian over the last axis, one jvp
    per unit direction (batch-safe)."""
    if x.shape[-1] != width:
        raise ValueError(f"state width {x.shape[-1]} != {width}")
    return cosserat._per_sample_jacobian(fn, x)


def _solve(a, b):
    """``a^-1 b`` batched, no host sync."""
    return torch.linalg.solve_ex(a, b)[0]


def ekf(ys, cfg: FilterConfig, x0, p0, t0: float = 0.0, tip_force=None,
        tip_moment=None) -> FilterResult:
    """Extended Kalman filter over a measurement sequence.

    ``ys (steps, ..., m)``: one weighted measurement vector per step, taken
    after each process step; ``x0 (..., 2nq)`` / ``p0 (..., 2nq, 2nq)``: the
    prior.  ``tip_force`` / ``tip_moment``: known drives (constants or
    callables of the time), as in :func:`.dynamics.simulate`.  Batched over
    the leading axes; a host loop over the steps.
    """
    sensing_mod._differentiable(cfg.sensing, "ekf")
    x = as_tensor(x0)
    dtype, dev = x.dtype, x.device
    ys = torch.as_tensor(ys, dtype=dtype, device=dev)
    d = 2 * cfg.nq
    p = torch.as_tensor(p0, dtype=dtype, device=dev).expand(x.shape + (d,))
    q_proc = torch.as_tensor(cfg.process_noise, dtype=dtype, device=dev)
    r_var = cfg.r_sigma ** 2
    eye_d = torch.eye(d, dtype=dtype, device=dev)
    eye_m = torch.eye(ys.shape[-1], dtype=dtype, device=dev)
    t = torch.full((), float(t0), dtype=dtype, device=dev)
    hist = []
    for y in ys:
        # predict
        def fstep(xx, t=t):
            return _rk4_step(xx, t, cfg, tip_force, tip_moment)

        x_pred = fstep(x)
        f = _jac_columns(fstep, x, d)                                    # (..., d, d)
        p_pred = torch.einsum("...ij,...jk,...lk->...il", f, p, f) + q_proc
        # update
        hfn = functools.partial(_measure_state, cfg=cfg)
        h = _jac_columns(hfn, x_pred, d)                                 # (..., m, d)
        nu = y - hfn(x_pred)
        s = torch.einsum("...mi,...ij,...kj->...mk", h, p_pred, h) + r_var * eye_m
        k_t = _solve(s, torch.einsum("...mi,...ij->...mj", h, p_pred))   # S^-1 H P
        x = x_pred + torch.einsum("...md,...m->...d", k_t, nu)
        ikh = eye_d - torch.einsum("...md,...mi->...di", k_t, h)
        # Joseph form: PSD-stable under roundoff
        p = (torch.einsum("...di,...ij,...ej->...de", ikh, p_pred, ikh)
             + r_var * torch.einsum("...md,...me->...de", k_t, k_t))
        nis = torch.einsum("...m,...m->...", nu, _solve(s, nu[..., None])[..., 0])
        hist.append((x, p, x_pred, p_pred, f, nis))
        t = t + cfg.dt
    return FilterResult(*(torch.stack(h_) for h_ in zip(*hist)))


def rts_smoother(result: FilterResult, cfg: FilterConfig):
    """Rauch-Tung-Striebel backward pass: smoothed means and covariances
    ``(steps, ..., 2nq)`` / ``(steps, ..., 2nq, 2nq)`` from the filter
    history (gain ``G = P F^T P_pred^-1`` per step), a host loop backwards
    over the transitions ``t -> t+1`` with step ``t+1``'s predictions."""
    xs, ps = result.xs, result.covs
    xp, pp, fs = result.xs_pred, result.covs_pred, result.fs
    x_s, p_s = xs[-1], ps[-1]
    out_x, out_p = [x_s], [p_s]
    for i in range(xs.shape[0] - 2, -1, -1):
        pf = torch.einsum("...ij,...kj->...ik", ps[i], fs[i + 1])            # P F^T
        g = _solve(pp[i + 1], pf.transpose(-1, -2)).transpose(-1, -2)
        x_s = xs[i] + torch.einsum("...ij,...j->...i", g, x_s - xp[i + 1])
        p_s = ps[i] + torch.einsum("...ij,...jk,...lk->...il", g, p_s - pp[i + 1], g)
        out_x.append(x_s)
        out_p.append(p_s)
    return torch.stack(out_x[::-1]), torch.stack(out_p[::-1])


def simulate_measurements(qe0, qd0, cfg: FilterConfig, steps: int, key=None,
                          t0: float = 0.0, tip_force=None, tip_moment=None):
    """Truth trajectory and noisy measurements for filter tests: the filter's
    own process model, plus i.i.d. Gaussian noise of ``cfg.r_sigma`` in the
    weighted measurement space drawn from ``key``, a ``torch.Generator`` on
    the state's device (``None``: torch's default generator).  Returns
    ``(xs_true (steps, ..., 2nq), ys (steps, ..., m))``."""
    qe0 = as_tensor(qe0)
    x = torch.cat([qe0, torch.as_tensor(qd0, dtype=qe0.dtype, device=qe0.device)], dim=-1)
    t = torch.full((), float(t0), dtype=x.dtype, device=x.device)
    xs = []
    for _ in range(steps):
        x = _rk4_step(x, t, cfg, tip_force, tip_moment)
        t = t + cfg.dt
        xs.append(x)
    xs = torch.stack(xs)
    y_clean = _measure_state(xs, cfg)
    noise = torch.randn(y_clean.shape, generator=key, dtype=y_clean.dtype,
                        device=y_clean.device)
    return xs, y_clean + cfg.r_sigma * noise
