"""Trajectory optimization on the differentiable rod dynamics.

Counterpart of the JAX package's ``models/control.py``.  RK4
:func:`~.dynamics.simulate` is a host loop of differentiable torch
operations, so the gradient of a trajectory functional with respect to an
actuation protocol is one reverse-mode pass through the whole rollout.
Direct trajectory optimization (single shooting):

1. parameterize a protocol by knots on a uniform time grid
   (:func:`protocol_from_knots`, linear interpolation);
2. roll out (:func:`rollout`, RK4 or Newmark, any drive channel);
3. score and descend (:func:`optimize_protocol`: Adam over the knots, a
   host loop of rollouts and backward passes).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.device import as_tensor
from . import dynamics as dynamics_mod

__all__ = [
    "protocol_from_knots",
    "rollout",
    "tip_positions",
    "tip_target_cost",
    "ControlSolution",
    "optimize_protocol",
]

# Drive channels of simulate/simulate_implicit a knot protocol may feed.
_CHANNELS = ("tension", "tip_force", "tip_moment", "base_accel", "b_field")


def _float_knots(knots) -> torch.Tensor:
    """Knots as a floating tensor: integer knots would truncate the time
    interpolation (and give ``rollout``'s default ``qe0`` an integer type)."""
    knots = as_tensor(knots)
    return knots if knots.is_floating_point() else knots.to(torch.float32)


def protocol_from_knots(knots, horizon: float, transform: Callable | None = None):
    """``knots (K, m)`` -> protocol ``t -> (m,)``.

    Piecewise-linear interpolation on the uniform knot grid over ``[0,
    horizon]``, clamped at the ends (a query past the horizon, as the last
    RK4 stage at ``t + dt``, holds the terminal knot).  Linear in the knots,
    so their gradients are exact scatter weights; the knot rows are read
    with ``index_select``, so a device time makes no host sync.
    ``transform`` post-composes a pointwise map (``softplus`` keeps tendon
    tensions nonnegative and differentiable).
    """
    knots = _float_knots(knots)
    if knots.ndim != 2 or knots.shape[0] < 2:
        raise ValueError(f"knots must be (K >= 2, m), got {tuple(knots.shape)}")
    k = knots.shape[0]

    def protocol(t):
        t = torch.as_tensor(t, dtype=knots.dtype, device=knots.device)
        s = torch.clamp(t / horizon, 0.0, 1.0) * (k - 1)
        i0 = torch.clamp(torch.floor(s).to(torch.int64), 0, k - 2)
        w = (s - i0.to(knots.dtype))[..., None]
        rows = i0.reshape(-1)
        lo = torch.index_select(knots, 0, rows).reshape(i0.shape + knots.shape[1:])
        hi = torch.index_select(knots, 0, rows + 1).reshape(i0.shape + knots.shape[1:])
        val = (1.0 - w) * lo + w * hi
        return transform(val) if transform is not None else val

    return protocol


def rollout(knots, cfg: dynamics_mod.DynamicsConfig, dt: float, steps: int,
            channel: str = "tension", transform: Callable | None = None, qe0=None, qd0=None,
            implicit: bool = False, iters: int = 16, **sim_kwargs) -> dynamics_mod.Trajectory:
    """Integrate the rod under the knot protocol.

    ``channel`` picks the drive of :func:`~.dynamics.simulate` (or
    ``simulate_implicit`` with ``implicit=True``) the protocol feeds; other
    drives pass through ``sim_kwargs``.  Differentiable in ``knots``;
    batched over the leading axes of ``qe0``/``qd0`` (one protocol, a family
    of initial conditions).  The knot grid spans the simulated window
    ``[t0, t0 + dt steps]``.
    """
    if channel not in _CHANNELS:
        raise ValueError(f"channel {channel!r} not in {_CHANNELS}")
    if channel in sim_kwargs:
        raise ValueError(f"channel {channel!r} also passed in sim_kwargs")
    knots = _float_knots(knots)
    t0 = sim_kwargs.get("t0", 0.0)
    base = protocol_from_knots(knots, dt * steps, transform)
    proto = base if not t0 else (lambda t: base(t - t0))
    record_energy = sim_kwargs.pop("record_energy", False)
    qe0 = (torch.zeros((cfg.nq,), dtype=knots.dtype, device=knots.device) if qe0 is None
           else as_tensor(qe0))
    qd0 = torch.zeros_like(qe0) if qd0 is None else qd0
    sim = dynamics_mod.simulate_implicit if implicit else dynamics_mod.simulate
    return sim(qe0, qd0, cfg, dt=dt, steps=steps, iters=iters, record_energy=record_energy,
               **{channel: proto}, **sim_kwargs)


def tip_positions(qes, cfg: dynamics_mod.DynamicsConfig, iters: int = 16):
    """Tip positions ``(..., 3)`` of strain states ``(..., nq)`` (grid point
    0 of the descending grid)."""
    return dynamics_mod._positions_full(as_tensor(qes), cfg, iters)[..., 0, :]


def tip_target_cost(cfg: dynamics_mod.DynamicsConfig, target, velocity_weight: float = 0.0,
                    effort_weight: float = 0.0, iters: int = 16,
                    transform: Callable | None = None):
    """Terminal cost: the squared tip miss at the final step, plus optional
    penalties on the terminal strain rate and on the effort.  A batched
    ``qe0`` family sums its misses.  ``transform`` must match the
    rollout's when ``effort_weight > 0``: the penalty is on the physical
    drive ``transform(knots)``."""

    def cost(traj: dynamics_mod.Trajectory, knots):
        tip = tip_positions(traj.qes[-1], cfg, iters)
        c = torch.sum((tip - torch.as_tensor(target, dtype=tip.dtype, device=tip.device)) ** 2)
        if velocity_weight:
            c = c + velocity_weight * torch.sum(traj.qds[-1] ** 2)
        if effort_weight:
            drive = transform(knots) if transform is not None else knots
            c = c + effort_weight * torch.mean(torch.square(drive))
        return c

    return cost


class ControlSolution(NamedTuple):
    knots: torch.Tensor      # (K, m) optimized protocol knots
    losses: torch.Tensor     # (iterations,) loss after each optimizer step
    grad_norm: torch.Tensor  # () final gradient norm


def optimize_protocol(cost, knots0, cfg: dynamics_mod.DynamicsConfig, dt: float, steps: int,
                      channel: str = "tension", transform: Callable | None = None, qe0=None,
                      qd0=None, iterations: int = 100, optimizer=None, implicit: bool = False,
                      iters: int = 16, **sim_kwargs) -> ControlSolution:
    """Direct trajectory optimization: descend ``cost(rollout(knots), knots)``.

    Gradients flow through the whole RK4 loop by reverse mode.
    ``optimizer``: a factory ``params -> torch.optim.Optimizer`` (default
    ``torch.optim.Adam(params, lr=0.1)``, whose defaults give optax's
    ``adam(0.1)`` update).  ``losses[i]`` is the loss of the knots after
    step ``i + 1``; ``losses[-1]`` scores the returned knots, whose gradient
    norm is ``grad_norm``.

    RK4 only: ``implicit=True`` raises (reverse mode through Newmark's
    Newton would differentiate the iteration, not the solution), and so
    does ``mass_tier='fused'`` (its kernels have no derivative).
    """
    if implicit:
        raise ValueError(
            "optimize_protocol requires the RK4 integrator (implicit=False): reverse-mode AD "
            "through simulate_implicit would differentiate its Newton iteration; wrap the "
            "Newmark residual in an implicit-function rule if a stiff-implicit control path "
            "is needed")
    if sim_kwargs.get("mass_tier", "xla") == "fused":
        raise ValueError(
            "optimize_protocol differentiates the rollout, and mass_tier='fused' runs the "
            "forward-only K1/K2 kernels; use the default mass_tier='xla'")
    kn = _float_knots(knots0).detach().clone().requires_grad_(True)
    opt = (optimizer if optimizer is not None
           else (lambda params: torch.optim.Adam(params, lr=0.1)))([kn])

    def loss_fn(k):
        traj = rollout(k, cfg, dt, steps, channel=channel, transform=transform, qe0=qe0,
                       qd0=qd0, iters=iters, **sim_kwargs)
        return cost(traj, k)

    losses = []
    for i in range(iterations):
        opt.zero_grad()
        loss = loss_fn(kn)
        loss.backward()
        if i:
            losses.append(loss.detach())
        opt.step()
    loss_f = loss_fn(kn)
    (g_f,) = torch.autograd.grad(loss_f, kn)
    losses.append(loss_f.detach())
    return ControlSolution(knots=kn.detach(), losses=torch.stack(losses),
                           grad_norm=torch.linalg.vector_norm(g_f))
