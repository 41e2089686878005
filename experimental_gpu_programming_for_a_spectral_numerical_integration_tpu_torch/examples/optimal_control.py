"""Trajectory optimization of a two-cable rod, and a Floquet stability
check: the tension knots of a maneuver are recovered by Adam
(``torch.optim``) through the RK4 rollout from its terminal tip alone, then
the Floquet multipliers of a parametrically excited column show the Mathieu
2:1 tongue (unstable) against a detuned drive (stable).  f64 on the
device; ``--smoke``: n=8, ne=2, 4 RK4 steps, 2 Adam steps and no Floquet
study (the JAX example's smoke run, 14 steps, 8 Adam steps and the
tongue's 130-step monodromy by reverse mode, is far too slow for the CPU
check of the examples).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import control, cosserat, dynamics, rod, tendon
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    scfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=8 if smoke else 12, ne=2 if smoke else 3))
    cfg = dynamics.DynamicsConfig(
        statics=scfg, rho_a=1.0, rho_i=1e-2, damping=0.4,
        tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.06)),
                 tendon.Tendon(offset=(0.0, 0.0, -0.06))))
    rest = torch.zeros(scfg.rod.na * scfg.rod.ne, dtype=torch.float64, device=device)
    freqs = np.sort(dynamics.natural_frequencies(cfg, qe0=rest))
    dt = 1.0 / float(freqs.max())
    steps = 4 if smoke else max(20, int(round(0.9 / dt)))
    softplus = torch.nn.functional.softplus

    # target: the terminal tip of a reference maneuver (exactly reachable)
    kn_true = torch.tensor([[0.0, 0.0], [1.4, 0.2], [2.2, 0.0]], dtype=torch.float64,
                           device=device)
    ref = control.rollout(kn_true, cfg, dt, steps, channel="tension", transform=softplus, iters=10)
    target = control.tip_positions(ref.qes[-1], cfg)
    print(f"maneuver target tip: {target.cpu().numpy().round(4)}")

    cost = control.tip_target_cost(cfg, target, effort_weight=1e-5, transform=softplus)
    sol = control.optimize_protocol(cost, torch.full((3, 2), -1.0, dtype=torch.float64,
                                                     device=device),
                                    cfg, dt, steps, channel="tension", transform=softplus,
                                    iterations=2 if smoke else 80, iters=10)
    with torch.no_grad():
        final = control.rollout(sol.knots, cfg, dt, steps, channel="tension", transform=softplus,
                                iters=10)
        miss = float(torch.linalg.vector_norm(control.tip_positions(final.qes[-1], cfg) - target))
    losses = sol.losses.cpu().numpy()
    print(f"loss {losses[0]:.2e} -> {losses[-1]:.2e} in {losses.shape[0]} Adam steps; "
          f"terminal tip miss {miss:.4f}")
    print("optimized tension knots (softplus-transformed):")
    print(softplus(sol.knots).detach().cpu().numpy().round(3))

    # Floquet: the Mathieu 2:1 tongue by the rigorous criterion
    w1, w_max = float(freqs[0]), float(freqs[-1])
    p1 = 0.5 * (np.pi ** 2 / 4.0)
    axial = torch.tensor([-p1, 0.0, 0.0], dtype=torch.float64, device=device)
    cases = () if smoke else (("2:1 tongue", 2.0 * w1), ("detuned", 1.37 * w1))
    mu_max = {}
    for name, om in cases:
        period = 2.0 * np.pi / om
        fsteps = int(np.ceil(period * w_max / 0.4))
        mus = dynamics.floquet_multipliers(cfg, period, fsteps, qe0=rest,
                                           tip_force=lambda t, _om=om: axial * torch.cos(_om * t))
        mu_max[name] = float(np.max(np.abs(mus)))
        print(f"Floquet max|mu| at {name}: {mu_max[name]:.3f} "
              f"({'UNSTABLE' if mu_max[name] > 1 else 'stable'})")
    return {"losses": losses, "miss": miss, "floquet": mu_max}


if __name__ == "__main__":
    main()
