"""Differentiable inverse kinematics: fit a load -> strain decoder by Adam.

Gradients flow through the spectral solve (the Picard solve's
implicit-function ``autograd.Function``), so the rod model is the forward
pass of a small learned controller (``models/calibration.py``).  f32 on the
device; ``--smoke``: 32 samples, 5 epochs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import calibration, rod
from . import parse_args


def main(argv=None) -> dict:
    device, smoke = parse_args(argv, __doc__)
    cfg = rod.RodConfig(n=12)
    num_features, batch = 6, (32 if smoke else 512)
    epochs = 5 if smoke else 200
    rng = np.random.default_rng(0)

    # Ground truth: an unknown decoder generates the tip targets.
    true_params = calibration.init_params(num_features, cfg, scale=0.4, seed=7, device=device)
    feats = torch.tensor(rng.standard_normal((batch, num_features)), dtype=torch.float32,
                         device=device)
    targets = calibration.predict_tips(true_params, feats, cfg, iters=12)

    params = calibration.init_params(num_features, cfg, scale=0.0, seed=1, device=device)
    step, optimizer = calibration.make_train_step(cfg=cfg, iters=12)
    opt = optimizer(params)
    losses = []
    for epoch in range(epochs):
        params, opt, loss = step(params, opt, feats, targets)
        losses.append(float(loss))
        if epoch % 40 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch:3d}: loss {losses[-1]:.3e}")
    with torch.no_grad():
        pred = calibration.predict_tips(params, feats[:4], cfg, iters=12)
    print("\nfitted tips   :", pred.cpu().numpy().round(4))
    print("target tips   :", targets[:4].cpu().numpy().round(4))
    return {"losses": losses}


if __name__ == "__main__":
    main()
