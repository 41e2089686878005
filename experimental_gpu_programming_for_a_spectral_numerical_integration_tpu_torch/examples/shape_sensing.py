"""Shape sensing, load identification and EKF tracking: the inverse loop
of a deployed continuum robot on simulated sensors.

1. a static shape fit (``sensing.fit_strain``): the modal strain from
   noisy markers, a tracked tip frame and two strain stations;
2. its predicted posterior standard deviations
   (``sensing.posterior_covariance``) beside the actual errors;
3. the tip load identified from a measured equilibrium shape
   (``sensing.identify_tip_load``);
4. an EKF tracking a swinging rod, and its RTS smoother.

f64 on the device; ``--smoke``: 4 filter steps and 6 load-identification
iterates (the JAX example's smoke run, 10 steps and up to 25 iterates, is
too slow for the CPU check of the examples).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import cosserat, dynamics, estimation, rod, sensing
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    rng = np.random.default_rng(0)
    rc = rod.RodConfig(n=10, na=3, ne=2)
    nq = rc.na * rc.ne

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    # 1. static shape fit from noisy markers + the tip pose + two strain stations
    scfg = sensing.SensingConfig(rod=rc, marker_fracs=(0.33, 0.66, 1.0), pose_fracs=(1.0,),
                                 strain_fracs=(0.4, 0.8))
    qe_true = f64(0.4 * rng.standard_normal(nq))
    sigma = 1e-3
    y = sensing.measure(qe_true, scfg)
    y_noisy = y + sigma * f64(rng.standard_normal(tuple(y.shape)))
    fit = sensing.fit_strain(y_noisy, scfg, tol=1e-12, max_iter=20)
    err = float(torch.linalg.vector_norm(fit.qe - qe_true))
    print(f"shape fit: |qe_hat - qe_true| = {err:.2e} ({int(fit.iterations)} GN iters, "
          f"noise sigma {sigma:g})")

    # 2. error bars: predicted posterior standard deviations
    cov = sensing.posterior_covariance(fit.qe, scfg, noise_sigma=sigma)
    stds = np.sqrt(np.diag(cov.cpu().numpy()))
    print(f"posterior stds per mode: {stds.round(5)}")
    print(f"   (actual per-mode errors: {(fit.qe - qe_true).abs().cpu().numpy().round(5)})")

    # 3. tip-load identification from an equilibrium shape
    stat_cfg = cosserat.StaticsConfig(rod=rc)
    f_true = f64([0.0, 0.12, -0.3])
    eq = cosserat.solve_statics(f_true, cfg=stat_cfg, tol=1e-11)
    y_eq = sensing.measure(eq.qe, scfg)
    y_eq = y_eq + 1e-4 * f64(rng.standard_normal(tuple(y_eq.shape)))
    theta, _ = sensing.identify_tip_load(y_eq, scfg, statics=stat_cfg,
                                         max_iter=6 if smoke else 25)
    print(f"tip-load id: true {f_true.cpu().numpy()} -> estimated {theta.cpu().numpy().round(4)}")
    print("   (the AXIAL component is the stiff direction: a near-inextensible rod barely "
          "bends under it, so noise amplifies there; the transverse components identify "
          "tightly)")

    # 4. EKF tracking of a swinging rod
    dcfg = dynamics.DynamicsConfig(statics=stat_cfg, rho_a=1.0, rho_i=1e-2)
    fcfg = estimation.FilterConfig(dynamics=dcfg, sensing=scfg, dt=0.01, r_sigma=1e-3)
    d = 2 * nq
    steps = 4 if smoke else 30
    x0_mean = np.zeros(d)
    x0_mean[2] = 0.35                      # bent release
    x0_true = f64(x0_mean + 0.01 * rng.standard_normal(d))
    key = torch.Generator(device=device).manual_seed(2)
    xs, ys = estimation.simulate_measurements(x0_true[:nq], x0_true[nq:], fcfg, steps, key)
    res = estimation.ekf(ys, fcfg, f64(x0_mean), 1e-4 * torch.eye(d, dtype=torch.float64,
                                                                  device=device))
    half = steps // 2
    rmse_qe = float(((res.xs[half:, :nq] - xs[half:, :nq]) ** 2).mean().sqrt())
    nis = float(res.nis.mean())
    m = ys.shape[-1]
    print(f"EKF over {steps} frames: strain rmse {rmse_qe:.2e}, NIS {nis:.1f} (m = {m}) - "
          f"{'consistent' if nis < 2 * m else 'INCONSISTENT'}")
    xs_s, _ = estimation.rts_smoother(res, fcfg)
    rmse_s = float(((xs_s[half:, :nq] - xs[half:, :nq]) ** 2).mean().sqrt())
    print(f"RTS smoother: strain rmse {rmse_s:.2e} "
          f"({'improves' if rmse_s < rmse_qe else 'matches'} the filter)")
    return {"fit_error": err, "nis": nis, "rmse": rmse_qe, "rmse_smoothed": rmse_s}


if __name__ == "__main__":
    main()
