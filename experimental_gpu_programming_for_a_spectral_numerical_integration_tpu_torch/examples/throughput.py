"""Throughput of the rod solve's paths on the device: the torch Picard
solve in f32, the K1 kernel (fused f32), the K3 kernel (refined, within
1e-8 of f64) and the batched statics Newton on K1 + K2.

Strains are ``0.8 N(0, 1)`` in f32 (B=131072; the JAX bench's scale, which
keeps every rod inside the refined path's ``rho <= 5`` domain); loads for
the statics Newton ``U(-0.4, 0.4)`` (B=4096).  ``--smoke``: B=256 and 64.
Each line names the card and its power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import cosserat, rod
from ..ops.kernels import rod_kernel
from ..utils import profiling
from . import card_line, parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    card = card_line(device)
    print(f"device: {device} [{card}]")
    b = 256 if smoke else 131072
    qes = torch.tensor(0.8 * np.random.default_rng(0).standard_normal((b, 9)),
                       dtype=torch.float32, device=device)
    paths = {
        "torch picard f32": lambda q: rod.rod_shape(q, method="picard").positions.sum(),
        "K1 fused f32": lambda q: sum(o.sum() for o in rod_kernel.rod_shape_fused(q)),
        "K3 refined_fused (<=1e-8 gate)": lambda q: rod.rod_shape_refined_fused(
            q, refine_steps=1).positions.sum(),
    }
    rates = {}
    for name, fn in paths.items():
        dt, rate = profiling.throughput(fn, qes, items=b, reps=2 if smoke else 20)
        rates[name] = rate
        print(f"{name:32s}: {dt * 1e3:9.4f} ms  {rate / 1e6:9.4f} M solves/s  B={b} [{card}]")

    # The statics Newton over the whole batch: one K1 and one K2 launch per step.
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=16))
    loads = torch.tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (64 if smoke else 4096, 3)),
                         dtype=torch.float32, device=device)
    dt, rate = profiling.throughput(
        lambda f: cosserat.solve_statics_batched(f, cfg=cfg, tol=1e-5, max_iter=12,
                                                 iters=16).qe.sum(),
        loads, reps=2 if smoke else 5, items=loads.shape[0])
    rates["batched statics BVP"] = rate
    print(f"{'batched statics BVP':32s}: {dt * 1e3:9.4f} ms  {rate:9.1f} BVP solves/s  "
          f"B={loads.shape[0]} [{card}]")
    return rates


if __name__ == "__main__":
    main()
