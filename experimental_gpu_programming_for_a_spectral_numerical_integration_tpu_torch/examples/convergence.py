"""Spectral convergence: the exponential decay of the tip error with the
grid order for the demo strain (against an n=64 self-reference) and for
two analytic IVPs (against their closed forms), in f64 on the device.
"""

from __future__ import annotations

import torch

from ..models import ivp, rod
from ..utils import diagnostics
from . import parse_args


def main(argv=None) -> dict:
    device, _ = parse_args(argv, __doc__)
    out = {}
    print("rod demo field, tip error vs N=64 reference:")
    out["rod"] = diagnostics.convergence_report(rod.demo_qe(torch.float64, device))
    for n, err in out["rod"].items():
        print(f"  N={n:3d}: {err:.3e}")
    print("y' = -2.5 y:")
    out["exponential"] = ivp.convergence_sweep(ivp.exponential_ivp, lam=-2.5, device=device)
    for n, err in out["exponential"].items():
        print(f"  N={n:3d}: {err:.3e}")
    print("forced oscillator (omega=6, nu=2):")
    out["oscillator"] = ivp.convergence_sweep(ivp.oscillator_ivp, device=device)
    for n, err in out["oscillator"].items():
        print(f"  N={n:3d}: {err:.3e}")
    return out


if __name__ == "__main__":
    main()
