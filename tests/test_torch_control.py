"""Port parity: trajectory optimization (models/control.py).

The loss that ``optimize_protocol`` descends (a tendon-driven rod,
``tests/test_control.py``'s configuration, carried over by
``utils/convert``; a batched ``qe0`` family with velocity and effort
penalties under a softplus map) is evaluated by the JAX package, compiled as
one ``jax.jit``, and by the port at the same knots: the value within 1e-9
relative, and the port's reverse-mode gradient through the RK4 loop within
1e-9 relative of JAX's.  JAX's gradient is the fourth-order central
difference of that compiled JAX loss: tracing JAX's own reverse-mode
rollout costs ~60 s on a CPU, its forward rollout ~12 s, and the
stencil's error (~1e-12 at h = 1e-3) is far below the gate.  No Adam
trajectories are compared (Adam amplifies near-zero gradient components).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    control as jctl,
    cosserat as jcos,
    dynamics as jdyn,
    rod as jrod,
    tendon as jten,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    control,
    dynamics,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

# tests/test_control.py:16-24: two antagonist cables bend the rod about y
JCFG = jdyn.DynamicsConfig(
    statics=jcos.StaticsConfig(rod=jrod.RodConfig(n=8, ne=2)), rho_a=1.0, rho_i=1e-2,
    damping=0.4, tendons=(jten.Tendon(offset=(0.0, 0.0, 0.06)),
                          jten.Tendon(offset=(0.0, 0.0, -0.06))))
DT, STEPS, ITERS = 0.01, 3, 10
TARGET = np.array([0.0, 0.0, -0.96])
H = 1e-3


def _inputs():
    rng = np.random.default_rng(0)
    qe0 = np.zeros((3, 6))
    qe0[1, 2], qe0[2, 3] = 0.15, -0.1          # tests/test_control.py:97-98
    return dict(knots=rng.uniform(-1.0, 1.0, (3, 2)), qe0=qe0 + 0.02 * rng.standard_normal((3, 6)))


@jax.jit
def _jax_loss(knots, qe0):
    cost = jctl.tip_target_cost(JCFG, jnp.asarray(TARGET), velocity_weight=1e-3,
                                effort_weight=1e-4, transform=jax.nn.softplus)
    traj = jctl.rollout(knots, JCFG, DT, STEPS, transform=jax.nn.softplus, qe0=qe0, iters=ITERS)
    return cost(traj, knots)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's loss at the knots, and its gradient by the fourth-order central
    difference ``(f(-2h) - 8 f(-h) + 8 f(h) - f(2h)) / 12h`` per entry."""
    x = _inputs()
    kn, qe0 = jnp.asarray(x["knots"]), jnp.asarray(x["qe0"])
    grad = np.zeros(kn.shape)
    for idx in np.ndindex(*kn.shape):
        f = {s: float(_jax_loss(kn.at[idx].add(s * H), qe0)) for s in (-2, -1, 1, 2)}
        grad[idx] = (f[-2] - 8.0 * f[-1] + 8.0 * f[1] - f[2]) / (12.0 * H)
    return float(_jax_loss(kn, qe0)), grad


def _port_cfg():
    return convert.dynamics_config_from_jax(JCFG)


def _cost(cfg):
    return control.tip_target_cost(cfg, TARGET, velocity_weight=1e-3, effort_weight=1e-4,
                                   transform=dynamics._softplus)


def test_protocol_from_knots_interpolates_exactly():
    """tests/test_control.py:33-42: exact at the knots, linear between,
    clamped past the horizon; equal to the JAX protocol; integer knots
    become float32 (the JAX rule)."""
    knots = [[0.0, 2.0], [1.0, 1.0], [3.0, -1.0]]
    proto = control.protocol_from_knots(torch.tensor(knots, dtype=torch.float64), horizon=1.0)
    jproto = jctl.protocol_from_knots(jnp.asarray(knots, jnp.float64), horizon=1.0)
    for t, want in ((0.0, [0.0, 2.0]), (0.5, [1.0, 1.0]), (1.0, [3.0, -1.0]),
                    (0.25, [0.5, 1.5]), (1.7, [3.0, -1.0]), (0.61, None)):
        got = proto(t).numpy()
        np.testing.assert_allclose(got, np.asarray(jproto(t)), rtol=0, atol=1e-15)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    ints = control.protocol_from_knots(torch.tensor(knots, dtype=torch.int64), horizon=1.0)
    assert ints(torch.tensor(0.25)).dtype == torch.float32


def test_loss_value_and_grad_match_jax(jax_ref):
    """optimize_protocol's loss and its reverse-mode gradient at the same
    knots within 1e-9 relative of JAX's."""
    loss_j, grad_j = jax_ref
    x = _inputs()
    cfg = _port_cfg()
    kn = torch.tensor(x["knots"], requires_grad=True)
    traj = control.rollout(kn, cfg, DT, STEPS, transform=dynamics._softplus,
                           qe0=torch.tensor(x["qe0"]), iters=ITERS)
    loss = _cost(cfg)(traj, kn)
    (grad,) = torch.autograd.grad(loss, kn)
    assert abs(loss.item() - loss_j) < 1e-9 * abs(loss_j), (loss.item(), loss_j)
    err = float(np.abs(grad.numpy() - grad_j).max())
    assert err < 1e-9 * float(np.abs(grad_j).max()), (err, grad_j)


def test_optimize_protocol_descends_and_refuses_what_it_cannot_differentiate():
    """Two Adam steps on the batched family (2 RK4 steps) lower the loss (the losses
    convention: after each step, the returned knots' last); the rollout
    follows the knots' dtype (f32 knots, f32 trajectory); implicit=True and
    mass_tier='fused' raise before any rollout."""
    x = _inputs()
    cfg = _port_cfg()
    cost = _cost(cfg)
    kn0 = torch.tensor(x["knots"])
    qe0 = torch.tensor(x["qe0"])
    sol = control.optimize_protocol(cost, kn0, cfg, DT, 2, transform=dynamics._softplus,
                                    qe0=qe0, iterations=2, iters=ITERS)
    start = cost(control.rollout(kn0, cfg, DT, 2, transform=dynamics._softplus, qe0=qe0,
                                 iters=ITERS), kn0)
    losses = sol.losses.numpy()
    assert losses.shape == (2,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0] < float(start), (float(start), losses)
    assert float(sol.grad_norm) > 0.0 and sol.knots.shape == (3, 2)
    traj32 = control.rollout(kn0.float(), cfg, DT, 1, transform=dynamics._softplus,
                             iters=ITERS)
    assert traj32.qes.dtype == torch.float32
    for kwargs in (dict(implicit=True), dict(mass_tier="fused")):
        with pytest.raises(ValueError, match="implicit|fused"):
            control.optimize_protocol(cost, kn0, cfg, DT, STEPS, qe0=qe0, **kwargs)
