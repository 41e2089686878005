"""Cosserat statics with load continuation: a tip-force schedule swept
into the strongly nonlinear elastica regime (each Newton solve warm
started from the last), the converged strain modes and tip positions
printed, and the sweep saved as ``.npz`` (``utils/io``) in the temporary
directory.  f64 on the device; ``--smoke``: n=16 and two load levels.
"""

from __future__ import annotations

import pathlib
import tempfile

import numpy as np
import torch

from ..models import cosserat, rod
from ..utils import io
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=16 if smoke else 32))
    alphas = [0.25, 0.5] if smoke else [0.25, 0.5, 1.0, 1.5, 2.0, 3.0]   # F L^2 / EI
    loads = torch.tensor([[0.0, 0.0, a] for a in alphas], dtype=torch.float64, device=device)
    sols = cosserat.load_continuation(loads, cfg=cfg, tol=1e-9)
    tips = []
    for a, s in zip(alphas, sols):
        tips.append(rod.rod_shape(s.qe, cfg=cfg.rod, method="picard").tip_position)
        print(f"alpha={a:4.2f}: converged={bool(s.converged)} iters={int(s.iterations)} "
              f"tip={np.round(tips[-1].cpu().numpy(), 4)}")
    path = io.save_results(pathlib.Path(tempfile.gettempdir()) / "statics_sweep.npz",
                           alphas=np.asarray(alphas), tips=torch.stack(tips),
                           qe=torch.stack([s.qe for s in sols]))
    print(f"saved -> {path}")
    return {"path": path, "tips": torch.stack(tips).cpu().numpy()}


if __name__ == "__main__":
    main()
