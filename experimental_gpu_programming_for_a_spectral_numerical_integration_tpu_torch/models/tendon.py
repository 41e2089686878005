"""Tendon actuation: cables routed along the rod at body-frame offsets.

Counterpart of the JAX package's ``models/tendon.py``.  A tendon routed at
offset ``d(X)`` follows ``p(X) = r(X) + R(q(X)) d(X)``; with tension ``T``
its potential is ``V = T l(qe)``, ``l = int_0^L |p'| dX`` evaluated
spectrally (``p'`` by the full-grid differentiation matrix, the length by
Clenshaw-Curtis quadrature), and the actuation force on the strain modes is
the gradient ``-T dl/dqe``.  ``dynamics._mass_and_rhs`` takes it as one more
cotangent on the full-grid ``(r, q)`` state.

Closed form (``tests/test_tendon.py``): one tendon at constant offset
``delta e_z`` on a Kirchhoff rod has ``|p'| = |1 + kappa_y delta|``, so the
actuated equilibrium is the constant curvature ``kappa_y = -T delta / EI_y``
at every tension.

The routing tables are host f64 (cached per tendon set and rod); their
device copies are cached per device and dtype, so the integrators' hot path
makes no host-to-device copy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import chebyshev, lie
from ..ops.device import as_tensor, cached_constants
from . import cosserat
from . import rod as rod_mod

__all__ = [
    "Tendon",
    "routing_offsets",
    "routing_profiles",
    "routing_capstan_mu",
    "lengths_from_state",
    "tendon_lengths",
    "tendon_generalized_force",
    "tip_sensitivity",
    "tendon_ik",
    "TendonIKSolution",
]


@dataclass(frozen=True)
class Tendon:
    """One routed cable: a body-frame offset field ``d(X)`` along the rod.

    Routing, first match: ``fn`` (a hashable callable, normalized arclength
    ``X (n,)`` descending -> offsets ``(n, 3)``), ``helix = (radius, turns,
    phase)`` (``d = radius (0, cos(2 pi turns X + phase), sin(...))``), else
    the constant ``offset``.

    ``profile``: optional callable ``X (n,) -> (n,)`` tension scale along the
    cable (a prescribed friction profile); the potential becomes ``T int
    profile |p'| dX``.  ``capstan``: Coulomb coefficient ``mu`` of the
    geometric capstan law, a weight ``exp(-mu Theta(X))`` with ``Theta`` the
    cable's turning angle from the base, computed from the current state and
    held frozen in the length integral (no derivative flows through it: the
    virtual work of a tension field is the gradient of the frozen-weight
    length; differentiating ``Theta`` adds a spurious conservative term).
    """

    offset: tuple = (0.0, 0.0, 0.0)
    helix: tuple | None = None
    fn: Callable | None = None
    profile: Callable | None = None
    capstan: float = 0.0

    def profile_at(self, rc: rod_mod.RodConfig) -> np.ndarray:
        """``(n,)`` f64 tension scales at the full grid points."""
        if self.profile is None:
            return np.ones(rc.n)
        xs = np.asarray(rc.points, np.float64) / rc.length
        p = np.asarray(self.profile(xs), np.float64)
        if p.shape != (rc.n,):
            raise ValueError(f"tension profile returned {p.shape}, need ({rc.n},)")
        return p

    def offsets_at(self, rc: rod_mod.RodConfig) -> np.ndarray:
        """``(n, 3)`` f64 offsets at the full grid points."""
        xs = np.asarray(rc.points, np.float64) / rc.length
        if self.fn is not None:
            d = np.asarray(self.fn(xs), np.float64)
            if d.shape != (rc.n, 3):
                raise ValueError(f"custom routing returned {d.shape}, need ({rc.n}, 3)")
            return d
        if self.helix is not None:
            radius, turns, phase = (float(v) for v in self.helix)
            ang = 2.0 * np.pi * turns * xs + phase
            return np.stack([np.zeros_like(xs), radius * np.cos(ang), radius * np.sin(ang)],
                            axis=-1)
        return np.broadcast_to(np.asarray(self.offset, np.float64), (rc.n, 3)).copy()


def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def routing_offsets(tendons: tuple, rc: rod_mod.RodConfig) -> np.ndarray:
    """``(K, n, 3)`` host routing table of a tendon set."""
    return _read_only(np.stack([t.offsets_at(rc) for t in tendons], axis=0))


@functools.lru_cache(maxsize=None)
def routing_profiles(tendons: tuple, rc: rod_mod.RodConfig) -> np.ndarray:
    """``(K, n)`` host tension-scale table (ones without profiles)."""
    return _read_only(np.stack([t.profile_at(rc) for t in tendons], axis=0))


@functools.lru_cache(maxsize=None)
def routing_capstan_mu(tendons: tuple) -> np.ndarray:
    """``(K,)`` capstan friction coefficients of a tendon set."""
    return _read_only(np.asarray([float(t.capstan) for t in tendons], np.float64))


class _Tables(NamedTuple):
    offsets: torch.Tensor        # (K, n, 3)
    diff: torch.Tensor           # (n, n) full-grid differentiation matrix
    wk: torch.Tensor             # (K, n) quadrature weights x tension profile
    mu: torch.Tensor | None      # (K,) capstan coefficients, None without capstan
    antideriv: torch.Tensor | None   # (n, n) int_0^{x_i}, zero at the base


@cached_constants
def _tables(tendons: tuple, rc: rod_mod.RodConfig, weights: tuple | None,
            device: torch.device, dtype: torch.dtype) -> _Tables:
    def dev(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    w = chebyshev.clenshaw_curtis_weights(rc.n, rc.length) if weights is None else weights
    mu = routing_capstan_mu(tendons)
    capstan = bool(np.any(mu != 0.0))
    tail = chebyshev.partial_integral_matrix(rc.n, rc.length)
    return _Tables(offsets=dev(routing_offsets(tendons, rc)),
                   diff=dev(chebyshev.diff_matrix(rc.n, rc.length)),
                   wk=dev(np.asarray(w, np.float64) * routing_profiles(tendons, rc)),
                   mu=dev(mu) if capstan else None,
                   antideriv=dev(tail[-1][None, :] - tail) if capstan else None)


def lengths_from_state(r, q, tendons: tuple, rc: rod_mod.RodConfig, weights=None,
                       theta0=None, return_theta: bool = False):
    """Routed lengths ``(..., K)`` from the full-grid state ``r (..., n, 3)``,
    ``q (..., n, 4)`` (tip first, base appended).

    Capstan tendons get the weight ``exp(-mu Theta)``: the turning rate
    ``|t_hat'|`` differentiated and accumulated spectrally from the base,
    then detached, so no reverse- or forward-mode derivative crosses it.
    ``theta0 (..., K)`` offsets the turning angle (segment chains accumulate
    it across junctions); ``return_theta=True`` also returns the turning
    angle at the segment tip (point 0).  ``weights``: quadrature weights
    ``(n,)`` (default: Clenshaw-Curtis on ``rc``).
    """
    tendons = tuple(tendons)
    wkey = None if weights is None else tuple(np.asarray(weights, np.float64).tolist())
    c = _tables(tendons, rc, wkey, r.device, r.dtype)
    p = r[..., None, :, :] + lie.quat_rotate_normalized(q[..., None, :, :], c.offsets)
    dp = torch.matmul(c.diff, p)                                    # (..., K, n, 3)
    speed = torch.sqrt(torch.sum(dp * dp, dim=-1))                  # (..., K, n)
    wk = c.wk
    theta_tip = None
    if c.mu is not None:
        # Theta = int_0^X |d t_hat/dX|; the 1e-30 guards the 0/0 of a
        # straight path (the whole weight is detached below).
        t_hat = dp / speed[..., None]
        dt = torch.matmul(c.diff, t_hat)
        turn = torch.sqrt(torch.sum(dt * dt, dim=-1) + 1e-30)
        theta = torch.einsum("ij,...j->...i", c.antideriv, turn)
        if theta0 is not None:
            theta = theta + as_tensor(theta0, r.dtype)[..., None]
        theta = theta.detach()
        wk = wk * torch.exp(-c.mu[:, None] * theta)
        theta_tip = theta[..., 0]
    elif theta0 is not None or return_theta:
        theta_tip = (r.new_zeros(p.shape[:-2]) if theta0 is None
                     else as_tensor(theta0, r.dtype))
    lens = torch.einsum("...kj,...kj->...k", wk, speed)
    if return_theta:
        return lens, theta_tip
    return lens


def tendon_lengths(qe, cfg, iters: int = 16):
    """Routed lengths ``(..., K)`` at strain modes ``qe``, differentiable
    through the Picard solve's implicit-function rule."""
    qe = as_tensor(qe)
    r, q = cfg.state_full(qe, iters)
    return cfg.tendon_lengths_from_state(r, q)


def tendon_generalized_force(qe, tension, cfg, iters: int = 16):
    """The actuation force on the strain modes, ``-sum_k T_k dl_k/dqe``, by
    ``torch.func.grad`` (what ``dynamics._mass_and_rhs`` assembles as a
    state cotangent)."""
    qe = as_tensor(qe)
    tension = torch.as_tensor(tension, dtype=qe.dtype, device=qe.device)

    def pot(q_):
        return torch.sum(tension * tendon_lengths(q_, cfg, iters))

    return -torch.func.grad(pot)(qe)


def _tip_of(qe, cfg, iters):
    r, _ = cfg.state_full(qe, iters)
    return r[..., 0, :]


def tip_sensitivity(qe, tension, cfg, tip_force=None, tip_moment=None, iters: int = 16):
    """``(tip (..., 3), dtip/dtension (..., 3, K))`` at an actuated
    equilibrium by the implicit-function rule: ``dqe*/dT = -(dQ/dqe)^{-1}
    dQ/dT`` (``torch.linalg.solve_ex``: no host sync), chained into the tip
    map.  A sample whose ``dQ/dqe`` is singular gets NaN sensitivities, and
    the rest of the batch is unaffected."""
    from . import dynamics as dyn

    qe = as_tensor(qe)
    tension = torch.as_tensor(tension, dtype=qe.dtype, device=qe.device)

    def balance(q_, t_):
        return dyn._mass_and_rhs(q_, torch.zeros_like(q_), cfg, tip_force, iters, tip_moment,
                                 tension=t_, static_only=True)[1]

    j_q = cosserat._per_sample_jacobian(lambda q_: balance(q_, tension), qe)   # (..., nq, nq)
    j_t = cosserat._per_sample_jacobian(lambda t_: balance(qe, t_), tension)   # (..., nq, K)
    sol, info = torch.linalg.solve_ex(j_q, j_t)
    dqe_dt = torch.where((info == 0)[..., None, None], -sol, torch.nan)
    tip = _tip_of(qe, cfg, iters)
    j_tip = torch.func.vmap(lambda d: torch.func.jvp(lambda q_: _tip_of(q_, cfg, iters),
                                                     (qe,), (d,))[1])(
        torch.movedim(dqe_dt, -1, 0))
    return tip, torch.movedim(j_tip, 0, -1)


class TendonIKSolution(NamedTuple):
    tension: torch.Tensor    # (..., K) recovered tensions (>= min_tension)
    qe: torch.Tensor         # (..., nq) equilibrium strain modes
    tip: torch.Tensor        # (..., 3) achieved tip position
    tip_error: torch.Tensor  # (...,) ||tip - target||_2


def tendon_ik(target_tip, cfg, tension0=None, gn_steps: int = 12, lm_damping: float = 1e-8,
              iters: int = 16, statics_tol: float = 1e-9, statics_max_iter: int = 40,
              min_tension: float = 0.0, tip_force=None, tip_moment=None) -> TendonIKSolution:
    """Tensions that put the equilibrium tip at ``target_tip (..., 3)``:
    ``gn_steps`` Gauss-Newton steps on the tip map, each solving the
    actuated equilibrium (``dynamics.solve_contact_statics``, warm started)
    and its sensitivity (:func:`tip_sensitivity`), with Levenberg-Marquardt
    damping and an active set on the bound ``T >= min_tension`` (cables only
    pull).  Batched over the targets' leading axes; the steps are a host
    loop whose only syncs are the equilibrium Newtons' convergence tests.
    A sample whose step cannot be solved (a singular balance Jacobian or
    normal matrix) keeps its tensions for that step, and its ``tip_error``
    shows the miss.
    """
    from . import dynamics as dyn

    target = as_tensor(target_tip)
    dtype, device = target.dtype, target.device
    k_t = len(cfg.tendons)
    if k_t == 0:
        raise ValueError("tendon_ik needs cfg.tendons to be non-empty")
    tension = (torch.zeros(target.shape[:-1] + (k_t,), dtype=dtype, device=device)
               if tension0 is None
               else torch.as_tensor(tension0, dtype=dtype, device=device).clone())
    qe = torch.zeros(tension.shape[:-1] + (cfg.nq,), dtype=dtype, device=device)
    eye = torch.eye(k_t, dtype=dtype, device=device)

    def equilibrium(qe, tension):
        return dyn.solve_contact_statics(cfg, qe0=qe, tip_force=tip_force, tip_moment=tip_moment,
                                         tol=statics_tol, max_iter=statics_max_iter, iters=iters,
                                         tension=tension).qe

    for _ in range(gn_steps):
        qe = equilibrium(qe, tension)
        tip, j_tip = tip_sensitivity(qe, tension, cfg, tip_force, tip_moment, iters)
        g = torch.einsum("...ck,...c->...k", j_tip, tip - target)
        # Coordinates at the bound whose gradient points outward are frozen
        # for this step, so the free ones get the reduced Gauss-Newton step.
        frozen = ((tension <= min_tension + 1e-12) & (g > 0.0)).to(dtype)
        free = 1.0 - frozen
        jtj = torch.einsum("...ck,...cl->...kl", j_tip, j_tip)
        jtj = (free[..., :, None] * free[..., None, :] * jtj
               + (lm_damping * free + frozen)[..., None, :] * eye)
        step, info = torch.linalg.solve_ex(jtj, free * g)
        ok = (info == 0)[..., None] & torch.isfinite(step).all(-1, keepdim=True)
        step = torch.where(ok, step, 0.0)
        tension = torch.clamp(tension - free * step, min=min_tension)
    qe = equilibrium(qe, tension)
    tip = _tip_of(qe, cfg, iters)
    return TendonIKSolution(tension=tension, qe=qe, tip=tip,
                            tip_error=torch.linalg.vector_norm(tip - target, dim=-1))
