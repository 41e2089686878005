"""A magnetically steered catheter: a rod with a tip magnet in applied
fields.  Steered statics, a batched field-workspace sweep (a polar grid of
fields in one call), gradient pulling (a uniform field gradient), the
magnetoelastic buckling of an anti-aligned axial field against the
classical ``B* = pi^2 EI / (4 m L^2)``, and a rotating-field steering
protocol integrated by RK4.  f64 on the device; ``--smoke``: n=12, a 3 x 3
grid, two field levels and 10 RK4 steps (the JAX example's smoke run takes
40, too slow for the CPU check of the examples).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import cosserat, dynamics, magnetics, rod
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    n = 12 if smoke else 16
    m_mag, ei = 0.5, 1.0
    scfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=n, ne=3), stiffness=(1.0, ei, ei))
    cfg = dynamics.DynamicsConfig(statics=scfg,
                                  magnets=(magnetics.Magnet(moment=(m_mag, 0.0, 0.0)),))

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    def tip_of(qe):
        return rod.rod_shape(qe, cfg=cfg.rod, method="picard", iters=16).tip_position

    # forward statics: one steered equilibrium
    b_vec = f64([0.0, 0.0, 0.8])
    sol = dynamics.solve_contact_statics(cfg, b_field=b_vec, tol=1e-9)
    tip = tip_of(sol.qe)
    print(f"field {b_vec.cpu().numpy()} -> tip {tip.cpu().numpy().round(6)} "
          f"(converged={bool(sol.converged)})")

    # batched field-workspace sweep: a polar grid of steering fields
    m = 3 if smoke else 8
    bm, ba = np.meshgrid(np.linspace(0.2, 1.5, m), np.linspace(0.0, 2 * np.pi, m, endpoint=False),
                         indexing="ij")
    fields = f64(np.stack([np.zeros(m * m), (bm * np.sin(ba)).ravel(), (bm * np.cos(ba)).ravel()],
                          axis=-1))
    sols = dynamics.solve_contact_statics(cfg, qe0=f64(np.zeros((m * m, 9))), b_field=fields,
                                          tol=1e-9)
    reach = torch.linalg.vector_norm(tip_of(sols.qe)[:, 1:], dim=-1).cpu().numpy()
    print(f"workspace: {m * m} fields in one call, lateral reach {reach.min():.3f}.."
          f"{reach.max():.3f}, all converged={bool(sols.converged.all())}")

    # gradient pulling: a uniform gradient dB_z/dx
    grad = np.zeros((3, 3))
    grad[2, 0] = 0.5
    sol_g = dynamics.solve_contact_statics(cfg, b_field=(f64(np.zeros(3)), f64(grad)), tol=1e-9)
    print(f"gradient dBz/dx=0.5 -> tip {tip_of(sol_g.qe).cpu().numpy().round(6)}")

    # magnetoelastic buckling: an anti-aligned axial field
    b_star = np.pi ** 2 * ei / (4.0 * m_mag * cfg.rod.length ** 2)
    rest = f64(np.zeros(9))
    stable = {}
    for frac in ([0.8, 1.2] if smoke else [0.5, 0.9, 1.1, 1.5]):
        om2 = dynamics.linearized_spectrum(cfg, qe=rest, b_field=f64([-frac * b_star, 0.0, 0.0]))
        stable[frac] = bool(om2[0] > 0)
        print(f"anti-aligned B = {frac:.1f} B*  ->  min omega^2 = {float(om2[0]):+.3f}  "
              f"({'stable' if stable[frac] else 'BUCKLED'});  classical B* = {b_star:.4f}")

    # rotating-field steering protocol
    steps, omega = (10 if smoke else 400), 2.0

    def b_of_t(t):
        return 0.8 * torch.stack([0.0 * t, torch.sin(omega * t), torch.cos(omega * t)])

    cfg_d = dynamics.DynamicsConfig(statics=scfg, magnets=cfg.magnets, damping=0.5)
    traj = dynamics.simulate(rest, rest, cfg_d, dt=5e-3, steps=steps, b_field=b_of_t,
                             record_energy=False)
    qes = traj.qes.cpu().numpy()
    print(f"rotating field: max |kappa_y modes| {np.abs(qes[:, 3:6]).max():.3f}, "
          f"max |kappa_z modes| {np.abs(qes[:, 6:9]).max():.3f} (out-of-plane sweep)")
    return {"tip": tip.cpu().numpy(), "stable": stable}


if __name__ == "__main__":
    main()
