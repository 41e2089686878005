"""Flutter and divergence of the compressed cantilever: Euler divergence
under a dead load (``pi^2/4``), the frequency coalescence and Beck's flutter
load (~20.05) under a follower load, and Ziegler's destabilization by
Kelvin-Voigt damping (the vanishing-damping limit ~10.94).  f64 on the
device, eigenproblems on the host; ``--smoke``: n=10, ne=3 and a 0.2
bisection tolerance, as in the JAX example.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import cosserat, dynamics, rod
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    n, ne = (10, 3) if smoke else (14, 5)
    tol = 0.2 if smoke else 0.02
    rc = rod.RodConfig(n=n, ne=ne)
    axial = torch.tensor([-1.0, 0.0, 0.0], dtype=torch.float64, device=device)

    # 1. Euler divergence (dead load)
    cfg_dead = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rc), rho_a=1.0,
                                       rho_i=1e-4)
    p_euler = dynamics.critical_load(cfg_dead, direction=axial, load_hi=5.0, bisect_tol=tol)
    print(f"Euler divergence load : {p_euler:8.4f}   (classical pi^2/4 = {np.pi ** 2 / 4:.4f})")

    # 2. Beck flutter (follower load): the coalescence, then the bisection
    scfg_f = cosserat.StaticsConfig(rod=rc, follower=True)
    cfg_beck = dynamics.DynamicsConfig(statics=scfg_f, rho_a=1.0, rho_i=1e-4)
    rest = torch.zeros(rc.na * rc.ne, dtype=torch.float64, device=device)
    print("follower-load frequency coalescence (omega_1^2, omega_2^2):")
    for p in ([0.0, 8.0, 16.0] if smoke else [0.0, 5.0, 10.0, 15.0, 19.0]):
        om2 = np.sort(dynamics.linearized_spectrum(cfg_beck, qe=rest, tip_force=p * axial,
                                                   symmetric=False).real)
        print(f"  P = {p:5.1f}:  {om2[0]:9.3f}  {om2[2]:9.3f}")
    p_beck = dynamics.critical_load(cfg_beck, direction=axial, load_lo=15.0, load_hi=25.0,
                                    bisect_tol=tol)
    print(f"Beck flutter load     : {p_beck:8.4f}   (classical ~20.05)")

    # 3. Ziegler paradox: internal (Kelvin-Voigt) damping destabilizes
    p_z = {}
    for kv in ([1e-3] if smoke else [1e-2, 1e-3]):
        cfg_z = dynamics.DynamicsConfig(statics=scfg_f, rho_a=1.0, rho_i=1e-4, kv_damping=kv)
        p_z[kv] = dynamics.critical_load(cfg_z, direction=axial, load_lo=5.0, load_hi=15.0,
                                         bisect_tol=tol)
        print(f"kv = {kv:7.0e} critical : {p_z[kv]:8.4f}   (vanishing-damping limit ~10.94)")
    print("the paradox: an infinitesimal material damping nearly HALVES the flutter load.")
    return {"euler": p_euler, "beck": p_beck, "ziegler": p_z}


if __name__ == "__main__":
    main()
