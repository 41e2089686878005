"""A three-leg parallel continuum robot (Reissner legs, na=6): the
workspace of a grid of lateral platform loads in one batched coupled
solve, and the platform's compliance about the precompressed rest state
from 12 central-difference solves in one call (symmetric to roundoff).
f64 on the device; ``--smoke``: n=8, ne=2, a 2 x 2 grid and 10 Picard
iterations, as in the JAX example.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import constrained, cosserat, dynamics, rod
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    ea, radius = 100.0, 0.3
    s = float(np.sqrt(2) / 2)
    bases = tuple((radius * np.cos(a), radius * np.sin(a), 0.0)
                  for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3))
    cfg = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
        rod=rod.RodConfig(n=8 if smoke else 16, ne=2 if smoke else 4, na=6),
        stiffness=(1.0, 1.0, 1.0, ea, 50.0, 50.0)))
    robot = constrained.PlatformRobot(cfg=cfg, base_positions=bases,
                                      base_quaternions=((s, 0.0, -s, 0.0),) * 3,
                                      attach_points=bases)
    iters = 10 if smoke else 16

    # workspace map: a grid of lateral loads, one batched coupled solve
    m = 2 if smoke else 5
    fx, fy = np.meshgrid(np.linspace(-0.3, 0.3, m), np.linspace(-0.3, 0.3, m))
    loads = torch.tensor(np.stack([fx.ravel(), fy.ravel(), np.full(m * m, -0.2)], -1),
                         dtype=torch.float64, device=device)
    sol = constrained.solve_platform(robot, platform_force=loads, tol=1e-8, max_iter=40,
                                     iters=iters)
    conv = sol.converged.cpu().numpy()
    pos = sol.platform_position.cpu().numpy()
    print(f"workspace: {conv.sum()}/{conv.size} converged")
    print("platform xy displacement range:", np.abs(pos[:, :2]).max(axis=0))
    print("platform sink under Fz=-0.2:", 1.0 - pos[conv, 2].mean(), "(~", 0.2 / (3 * ea),
          "axial)")

    # compliance about the precompressed rest state: 12 difference solves, one call
    h = 1e-5
    w0 = torch.tensor([0.0, 0.0, -0.2, 0.0, 0.0, 0.0], dtype=torch.float64, device=device)
    eye = torch.eye(6, dtype=torch.float64, device=device)
    wr = torch.cat([w0 + h * eye, w0 - h * eye], dim=0)
    sol2 = constrained.solve_platform(robot, platform_force=wr[:, :3], platform_moment=wr[:, 3:],
                                      tol=1e-10, max_iter=60, iters=iters)
    quat = sol2.platform_quaternion.cpu().numpy()
    pose = np.concatenate([sol2.platform_position.cpu().numpy(),
                           2.0 * quat[:, 1:] / quat[:, :1]], axis=-1)
    comp = (pose[:6] - pose[6:]) / (2.0 * h)
    asym = np.abs(comp - comp.T).max() / np.abs(comp).max()
    print("compliance diag:", np.diag(comp))
    print(f"compliance asymmetry (should be ~0): {asym:.2e}")
    return {"converged": conv, "compliance": comp, "asymmetry": asym}


if __name__ == "__main__":
    main()
