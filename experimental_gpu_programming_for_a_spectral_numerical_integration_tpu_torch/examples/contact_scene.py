"""Contact scenes: a rod draped over a sphere (implicit Newmark), friction
against frictionless ringing on a floor (RK4), and two clamped rods
pressed into contact (a rod-rod scene).  The final states are saved as
``.npz`` (``utils/io``) in the temporary directory.  f64 on the device;
``--smoke``: n=8, one Newmark step of the drape, 12 RK4 steps of each
floor run and 9 of the scene (the JAX example's smoke sizes, 30, 120 and
90, are too slow for the CPU check of the examples: each RK4 step of the
port's Lagrangian assembly is tens of small torch calls).
"""

from __future__ import annotations

import pathlib
import tempfile

import numpy as np
import torch

from ..models import cosserat, dynamics as dyn, rod
from ..utils import io
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    scfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=8 if smoke else 12, ne=3))
    steps = 3 if smoke else 240
    nq = scfg.rod.na * scfg.rod.ne
    zero = torch.zeros(nq, dtype=torch.float64, device=device)

    def positions(qe):
        return rod.rod_shape(qe, cfg=scfg.rod, method="picard", iters=24).positions

    # 1. drape over a sphere
    sphere = dyn.ContactSphere(center=(0.6, 0.0, -0.5), radius=0.35, stiffness=1e4,
                               smoothing=1e-3)
    cfg = dyn.DynamicsConfig(statics=scfg, rho_a=1.0, rho_i=1e-2, damping=6.0,
                             gravity=(0.0, 0.0, -8.0), contact=sphere)
    qe_drape = dyn.simulate_implicit(zero, zero, cfg, dt=0.015, steps=1 if smoke else steps,
                                     iters=12, tol=1e-8, record_energy=False).qes[-1]
    pen = float(sphere.gap(positions(qe_drape)).max())
    print(f"sphere drape: max penetration {pen:.4f} "
          f"(compliance-limited; free fall would reach ~0.33)")

    # 2. friction against frictionless ringing on the floor
    amps = {}
    for mu in (0.0, 0.8):
        cfg_f = dyn.DynamicsConfig(
            statics=scfg, rho_a=1.0, rho_i=1e-2, gravity=(0.0, 0.0, -8.0),
            contact=dyn.ContactPlane(normal=(0.0, 0.0, 1.0), offset=-0.02, stiffness=2e3,
                                     smoothing=2e-3, friction=mu))
        kick = zero.clone()
        kick[6] = 2.0
        tr = dyn.simulate(zero, kick, cfg_f, dt=0.002, steps=4 * steps, iters=12,
                          record_energy=False)
        amps[mu] = float(tr.qes[-steps:, 6].abs().max())
    print(f"friction: late lateral amplitude mu=0: {amps[0.0]:.4f}  mu=0.8: {amps[0.8]:.4f}")

    # 3. two-rod scene: clamped 0.08 apart, contact distance 0.1
    rr = dyn.RodRodContact(radius=0.05, stiffness=2e3, smoothing=2e-3)
    bases = np.array([[0.0, 0.0, 0.0], [0.0, 0.08, 0.0]])
    cfg_s = dyn.DynamicsConfig(statics=scfg, rho_a=1.0, rho_i=1e-2, damping=4.0)
    q2 = torch.zeros((2, nq), dtype=torch.float64, device=device)
    tr = dyn.simulate_scene(q2, q2, cfg_s, rr, bases, dt=0.004, steps=3 * steps, iters=12,
                            record_energy=False)
    tips = positions(tr.qes[-1])[:, 0].cpu().numpy() + bases
    tip_sep = float(np.linalg.norm(tips[0] - tips[1]))
    print(f"rod-rod: tip separation {tip_sep:.4f} (clamped at 0.08, contact distance 0.10)")

    path = io.save_results(pathlib.Path(tempfile.gettempdir()) / "contact_scene.npz",
                           qe_drape=qe_drape, scene_qes=tr.qes[-1], bases=bases)
    print(f"saved -> {path}")
    return {"path": path, "penetration": pen, "amplitudes": amps, "tip_separation": tip_sep}


if __name__ == "__main__":
    main()
