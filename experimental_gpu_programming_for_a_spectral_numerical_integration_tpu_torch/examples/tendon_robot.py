"""A three-tendon continuum robot: actuated statics, a batched workspace
sweep over a grid of tension pairs in one call, the actuated vibration
spectrum about a loaded equilibrium, and tendon inverse kinematics.
f64 on the device; ``--smoke``: n=12, a 3 x 3 grid, 6 Gauss-Newton steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import cosserat, dynamics, rod, tendon
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    n = 12 if smoke else 16
    delta = 0.05
    offsets = [(0.0, delta * np.cos(a), delta * np.sin(a))
               for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3)]
    scfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=n, ne=3))
    cfg = dynamics.DynamicsConfig(statics=scfg,
                                  tendons=tuple(tendon.Tendon(offset=o) for o in offsets))

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    # forward statics: one actuated equilibrium
    t_vec = f64([2.0, 0.0, 0.5])
    sol = dynamics.solve_contact_statics(cfg, tension=t_vec, tol=1e-9)
    tip = rod.rod_shape(sol.qe, cfg=cfg.rod, method="picard", iters=16).tip_position
    print(f"tensions {t_vec.cpu().numpy()} -> tip {tip.cpu().numpy().round(6)} "
          f"(converged={bool(sol.converged)})")

    # batched workspace sweep: a grid of tension pairs in ONE call
    m = 3 if smoke else 7
    t1, t2 = np.meshgrid(np.linspace(0.0, 3.0, m), np.linspace(0.0, 3.0, m), indexing="ij")
    tensions = f64(np.stack([t1.ravel(), t2.ravel(), np.zeros(m * m)], axis=-1))
    sols = dynamics.solve_contact_statics(cfg, qe0=f64(np.zeros((m * m, 9))), tension=tensions,
                                          tol=1e-9)
    tips = rod.rod_shape(sols.qe, cfg=cfg.rod, method="picard", iters=16).tip_position
    reach = torch.linalg.vector_norm(tips[:, 1:], dim=-1).cpu().numpy()
    print(f"workspace sweep ({m}x{m} tension grid): lateral reach "
          f"{reach.min():.4f}..{reach.max():.4f}, all converged={bool(sols.converged.all())}")

    # actuated vibration spectrum about the loaded equilibrium
    omega2 = dynamics.linearized_spectrum(cfg, qe=sol.qe, tension=t_vec)
    print(f"first actuated frequencies {np.sqrt(omega2[:3]).round(4)}")

    # inverse actuation: put the tip back at the target
    ik = tendon.tendon_ik(tip, cfg, gn_steps=6 if smoke else 14)
    print(f"IK to {tip.cpu().numpy().round(6)}: tensions "
          f"{ik.tension.detach().cpu().numpy().round(4)}, tip error {float(ik.tip_error):.2e}")
    return {"tip": tip.cpu().numpy(), "ik_error": float(ik.tip_error)}


if __name__ == "__main__":
    main()
