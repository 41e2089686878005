"""Port parity: tendon actuation (models/tendon.py) and routed tendons in
segment statics.

The JAX reference (one ``jax.jit``) takes the routed lengths of constant,
helix, profile and capstan tendons on the same full-grid state (with
``theta0``/``return_theta``), and the capstan tendon's generalized force
and its forward-mode derivative: the frozen capstan weight must drop both
the reverse- and the forward-mode tangent.  The equilibria are held to the
closed forms of ``tests/test_tendon.py`` and ``tests/test_segment_statics.py``
through the port's own Newtons (no JAX ``solve_contact_statics`` or
``tendon_ik`` here: each costs 10-14 s to compile).
"""

import numpy as np
import torch
import jax

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    cosserat as jcos,
    dynamics as jdyn,
    rod as jrod,
    tendon as jten,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    dynamics,
    rod,
    segment_statics as ss,
    segments,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401


def _taper(xs):
    return 1.0 - 0.5 * xs


JRC = jrod.RodConfig(n=16)
JTENDONS = (jten.Tendon(offset=(0.0, 0.0, 0.05)), jten.Tendon(helix=(0.04, 1.5, 0.3)),
            jten.Tendon(offset=(0.0, 0.03, -0.02), profile=_taper),
            jten.Tendon(offset=(0.0, 0.02, 0.04), capstan=0.8))
JCAPSTAN = jdyn.DynamicsConfig(statics=jcos.StaticsConfig(rod=JRC, stiffness=(1.0, 2.0, 1.0)),
                               tendons=(JTENDONS[3], JTENDONS[1]))


def _inputs():
    rng = np.random.default_rng(7)
    qe = 0.5 * rng.standard_normal((3, 9))
    q, r = cosserat._full_grid_state(rod.RodConfig(n=16), torch.tensor(qe), 30)
    return dict(qe=qe, r=r.numpy(), q=q.numpy(), theta0=rng.uniform(0.0, 1.0, (3, 4)),
                tension=rng.uniform(0.5, 2.0, (3, 2)), v=rng.standard_normal((3, 9)))


@jax.jit
def _jax_reference(x):
    lens, theta = jten.lengths_from_state(x["r"], x["q"], JTENDONS, JRC, theta0=x["theta0"],
                                          return_theta=True)
    force = lambda qe: jten.tendon_generalized_force(qe, x["tension"], JCAPSTAN)
    f, df = jax.jvp(force, (x["qe"],), (x["v"],))
    return dict(lens=lens, theta=theta, lens0=jten.lengths_from_state(x["r"], x["q"], JTENDONS,
                                                                      JRC),
                force=f, dforce=df)


def test_lengths_and_capstan_force_match_jax():
    """``lengths_from_state`` within 1e-12 for constant, helix, profile and
    capstan routing (``theta0`` offsets, ``return_theta``); the capstan
    tendon's ``tendon_generalized_force`` and its jvp within 1e-10."""
    x = _inputs()
    ref = {k: np.asarray(v) for k, v in _jax_reference(x).items()}
    t = {k: torch.tensor(v) for k, v in x.items()}
    tendons = tuple(convert.tendon_from_jax(j) for j in JTENDONS)
    rc = rod.RodConfig(n=16)
    lens, theta = tendon.lengths_from_state(t["r"], t["q"], tendons, rc, theta0=t["theta0"],
                                            return_theta=True)
    np.testing.assert_allclose(lens.numpy(), ref["lens"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(theta.numpy(), ref["theta"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tendon.lengths_from_state(t["r"], t["q"], tendons, rc).numpy(),
                               ref["lens0"], rtol=0, atol=1e-12)
    cfg = convert.dynamics_config_from_jax(JCAPSTAN)
    f, df = torch.func.jvp(lambda qe: tendon.tendon_generalized_force(qe, t["tension"], cfg),
                           (t["qe"],), (t["v"],))
    scale = max(1.0, float(np.abs(ref["force"]).max()))
    assert float(np.abs(f.numpy() - ref["force"]).max()) < 1e-10 * scale
    scale = max(1.0, float(np.abs(ref["dforce"]).max()))
    assert float(np.abs(df.numpy() - ref["dforce"]).max()) < 1e-10 * scale


def _one_tendon(delta, ei_y=1.0, n=16):
    return dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=n, ne=3), stiffness=(1.0, ei_y, 1.0)),
        tendons=(tendon.Tendon(offset=(0.0, 0.0, delta)),))


def test_constant_offset_closed_form_routed_length_and_tip_arc():
    """tests/test_tendon.py:32-70: kappa_y = -T delta / EI_y everywhere
    (rtol 1e-8, other components < 1e-9), its Jacobian streamed three
    directions at a time; the routed length L (1 + kappa delta) (rtol 1e-9)
    and the tip on the circular arc (1e-9)."""
    delta, ei_y = 0.05, 2.0
    tensions = torch.tensor([[2.0], [0.7]], dtype=torch.float64)
    cfg = _one_tendon(delta, ei_y)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros((2, 9), dtype=torch.float64),
                                         tension=tensions, tol=1e-11, jac_chunk=3)
    assert sol.converged.all()
    kappa = rod.curvature_at_points(cfg.rod, sol.qe)
    expected = -tensions * delta / ei_y
    np.testing.assert_allclose(kappa[..., 1].numpy(), expected.expand(2, 15).numpy(), rtol=1e-8)
    assert float(kappa[..., 0].abs().max()) < 1e-9 and float(kappa[..., 2].abs().max()) < 1e-9

    delta, t_mag = 0.1, 1.5
    cfg = _one_tendon(delta)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(9, dtype=torch.float64),
                                         tension=torch.tensor([t_mag], dtype=torch.float64),
                                         tol=1e-11)
    k = -t_mag * delta
    np.testing.assert_allclose(float(tendon.tendon_lengths(sol.qe, cfg)[0]), 1.0 + k * delta,
                               rtol=1e-9)
    tip = rod.rod_shape(sol.qe, cfg=cfg.rod, method="dense",
                        normalize_quaternions=True).tip_position
    np.testing.assert_allclose(tip.numpy(), [np.sin(k) / k, 0.0, (np.cos(k) - 1.0) / k],
                               atol=1e-9)


def test_tip_sensitivity_matches_finite_differences():
    """tests/test_tendon.py:250-267 (rtol 5e-4, atol 1e-8)."""
    cfg = _one_tendon(0.06, n=12)
    t_vec = torch.tensor([1.2], dtype=torch.float64)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(9, dtype=torch.float64),
                                         tension=t_vec, tol=1e-12)
    tip, j_tip = tendon.tip_sensitivity(sol.qe, t_vec, cfg)
    assert j_tip.shape == (3, 1)
    eps, tips = 1e-5, []
    for s in (eps, -eps):
        sp = dynamics.solve_contact_statics(cfg, qe0=sol.qe, tension=t_vec + s, tol=1e-12)
        tips.append(rod.rod_shape(sp.qe, cfg=cfg.rod, method="picard", iters=16).tip_position)
    np.testing.assert_allclose(j_tip[:, 0].numpy(), ((tips[0] - tips[1]) / (2 * eps)).numpy(),
                               rtol=5e-4, atol=1e-8)


def test_tendon_ik_recovers_forward_target():
    """tests/test_tendon.py:232-247: three tendons at 120 degrees; the tip of
    a known tension set's equilibrium is recovered within 1e-6."""
    delta = 0.05
    offs = [(0.0, delta * np.cos(a), delta * np.sin(a)) for a in (0.0, 2 * np.pi / 3,
                                                                   4 * np.pi / 3)]
    cfg = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=12, ne=3)),
                                  tendons=tuple(tendon.Tendon(offset=o) for o in offs))
    t_true = torch.tensor([3.0, 0.5, 1.0], dtype=torch.float64)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros(9, dtype=torch.float64),
                                         tension=t_true, tol=1e-11)
    target = rod.rod_shape(sol.qe, cfg=cfg.rod, method="picard", iters=16).tip_position
    ik = tendon.tendon_ik(target, cfg, gn_steps=20)
    assert ik.tension.shape == (3,) and bool((ik.tension >= 0.0).all())
    assert float(ik.tip_error) < 1e-6


def _straight_helix(mu, turns, a, length, segs):
    """The capstan closed form on a straight rod with a helical routing:
    ``Theta = c X``, weighted length ``|p'| (1 - exp(-mu c L)) / (mu c)``;
    and the value each of ``segs`` segments would give if the angle
    restarted at every junction."""
    w = 2.0 * np.pi * turns / length
    speed = np.sqrt(1.0 + (a * w) ** 2)
    c = a * w ** 2 / speed
    return (speed * (1.0 - np.exp(-mu * c * length)) / (mu * c),
            segs * speed * (1.0 - np.exp(-mu * c * length / segs)) / (mu * c))


def test_segmented_tendons_piecewise_and_capstan_across_junctions():
    """tests/test_segment_statics.py:239-261: a tendon anchored at the first
    junction gives kappa_y = -T delta on the covered segment and a straight
    segment beyond (1e-12); tests/test_tendon.py:362-387: the capstan angle
    accumulates across junctions (1e-9), unlike a per-segment restart."""
    delta, t_mag = 0.05, 2.0
    cfg = ss.SegmentedStaticsConfig(rods=segments.uniform_segments(2, n=14, ne=4),
                                    tendons=(tendon.Tendon(offset=(0.0, 0.0, delta)),),
                                    tendon_end=(0,))
    sol = ss.solve_segmented_statics(torch.zeros(3, dtype=torch.float64), cfg=cfg,
                                     tension=torch.tensor([t_mag], dtype=torch.float64))
    assert bool(sol.converged)
    expected = np.zeros((2, 12))
    expected[0, 4] = -t_mag * delta                 # kappa_y's constant mode
    np.testing.assert_allclose(sol.qe.numpy(), expected, rtol=0, atol=1e-12)

    a, mu = 0.03, 0.8
    cfg = ss.SegmentedStaticsConfig(rods=segments.uniform_segments(2, n=16, ne=3),
                                    tendons=(tendon.Tendon(helix=(a, 1.0, 0.0), capstan=mu),))
    lens = ss.segmented_tendon_lengths(torch.zeros((2, 9), dtype=torch.float64), cfg)
    accumulated, restart = _straight_helix(mu, 2.0, a, 1.0, 2)
    np.testing.assert_allclose(float(lens[0]), accumulated, rtol=1e-9)
    assert abs(float(lens[0]) - restart) > 1e-3
