"""Buckling and post-buckling of the compressed cantilever: the pencil
buckling loads of the trivial branch, a Riks walk along it with its
stability monitors, the branch point refined by bisection, the two
post-buckling branches switched onto, and (full size only) the Koiter
unfolding of the imperfect column through its fold.  f64 on the device
(host f64 walker and eigenproblems); ``--smoke``: 10 bisection steps and no
Koiter study, as in the JAX example.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import bifurcation, cosserat, rod
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    stiff = (1.0, 1.0, 1.3)          # split y/z bending: simple eigenvalues
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=16), stiffness=stiff)
    axial = torch.tensor([-1.0, 0.0, 0.0], dtype=torch.float64, device=device)
    ne = cfg.rod.ne

    lams = bifurcation.linearized_buckling_loads(axial, cfg=cfg)
    lams = lams[lams > 0]
    print("pencil buckling loads:", np.round(lams[:4], 4))
    print(f"Euler P_cr = pi^2 EI / 4 = {np.pi ** 2 / 4:.4f} (y-plane, EI=1); z-plane at x1.3")

    path = cosserat.arc_length_continuation(axial, cfg=cfg, ds=0.35, steps=9, tol=1e-10)
    stab = bifurcation.path_stability(path, axial, cfg=cfg)
    print("\ntrivial-branch walk: lambda =", np.round(path.lambdas.cpu().numpy(), 3))
    print("unstable eigenvalue count:", stab.n_unstable)

    cp = bifurcation.detect_critical_points(path, axial, cfg=cfg, stability=stab,
                                            bisect_steps=10 if smoke else 48)[0]
    print(f"\ncritical point: kind={cp.kind}, lambda={cp.lam:.6f}, "
          f"left-null coupling={cp.coupling:.2e}")

    print("\npost-buckling branches (amplitude = |qe|):")
    for d in (1.0, -1.0):
        br = bifurcation.switch_branch(cp, axial, cfg=cfg, direction=d, ds=0.35, steps=6,
                                       tol=1e-9)
        amps = torch.linalg.vector_norm(br.qes, dim=1).cpu().numpy()
        print(f"  direction {d:+.0f}: lambda={np.round(br.lambdas.cpu().numpy(), 3)} "
              f"|qe|={np.round(amps, 3)}")
    out = {"buckling_loads": lams, "critical_lambda": cp.lam, "kind": cp.kind}
    if smoke:
        return out   # the smoke run stops before the (slow) Koiter unfolding study

    # Koiter unfolding: walk the complementary branch of the imperfect
    # column down through its fold nose.
    d = 1.0 if float(cp.null_vector[ne]) > 0 else -1.0
    br = bifurcation.switch_branch(cp, axial, cfg=cfg, direction=d, ds=0.4, steps=8, tol=1e-9)
    f_eps = torch.tensor([-1.0, 0.0, 0.01], dtype=torch.float64, device=device)
    lam_hi = float(br.lambdas[-1])
    anchor = cosserat.solve_statics(lam_hi * f_eps, cfg=cfg, qe0=br.qes[-1], tol=1e-10,
                                    max_iter=50)
    walk = cosserat.arc_length_continuation(f_eps, cfg=cfg, qe0=anchor.qe, lambda_start=lam_hi,
                                            ds=0.3, steps=14, tol=1e-9, direction=-1.0)
    pts = bifurcation.detect_critical_points(walk, f_eps, cfg=cfg)
    print("\nimperfect column (eps = 0.01) critical points:")
    for p in pts:
        print(f"  kind={p.kind}, lambda={p.lam:.4f}, coupling={p.coupling:.3f}")
    print("(the fold nose sits at lambda_c + O(eps^(2/3)); the second 'branch' point is "
          "z-plane buckling riding the unstable sheet)")
    out["imperfect"] = [(p.kind, p.lam) for p in pts]
    return out


if __name__ == "__main__":
    main()
