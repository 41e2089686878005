"""Entry ``statics_batched``: the port's batched statics Newton,
``models.cosserat.solve_statics_batched(tip_force, cfg, tol, max_iter, iters,
jac_iters)``, held to the float64 balance residual of
:mod:`rodbench.reference.statics` at the strains it returns.

Inputs: tip forces ``(batch, 3)`` from the mix's generator, rounded to
float32 as users pass them; the reference reads the same float32 values.
Checks: the load cases that the Newton left unconverged (or NaN) in every
call of the window, and the largest float64 residual norm over every load
case of the calls kept for the check.
"""

from __future__ import annotations

import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat as port_statics,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    rod as port_rod,
)

from .. import generator
from ..reference import statics as ref_statics

ITEMS = "load cases"
SYNC_GAP = "newton_iterate_sync"


class Bench:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        self.batch = traffic["batch"]
        rc = port_rod.RodConfig(n=config["n"], na=config["na"], ne=config["ne"],
                                length=config["length"], basis=config["basis"])
        self.cfg = port_statics.StaticsConfig(rod=rc, stiffness=tuple(config["stiffness"]))
        gen = generator.make_generator(seed, device)
        loads, self.redrawn = generator.pool(traffic, 3, gen, device)
        self.loads = [f.to(torch.float32) for f in loads]
        self.converged, self.iterations = [], []
        self.unconverged = 0

    def call(self, slot: int):
        c = self.config
        return port_statics.solve_statics_batched(
            self.loads[slot], cfg=self.cfg, tol=c["tol"], max_iter=c["max_iter"],
            iters=c["iters"], jac_iters=c["jac_iters"])

    def after_call(self, index: int, slot: int, out) -> None:
        self.converged.append(out.converged)
        self.iterations.append(out.iterations)

    def finish(self, calls: int) -> tuple:
        """``(items done, counters)`` once the window has closed."""
        done = torch.stack(self.converged[:calls])
        items = int(done.sum())
        self.unconverged = done.numel() - items
        iters = [int(k) for k in torch.stack(self.iterations[:calls]).tolist()]
        self.converged = self.iterations = None
        return items, {"newton_iterations": iters}

    def check(self, kept: list, limits: dict) -> tuple:
        """``(checks, failed)``: ``checks[name] = (value, limit)``."""
        answers = [(slot, out.qe.to(torch.float64)) for slot, out in kept]
        kept.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        c = self.config
        worst = 0.0
        for slot, qe in answers:
            norms = ref_statics.residual_norm(qe, self.loads[slot].to(torch.float64), n=c["n"],
                                              ne=c["ne"], length=c["length"],
                                              stiffness=c["stiffness"])
            worst = max(worst, float(torch.nan_to_num(norms, nan=float("inf")).max()))
        checks = {"unconverged": (self.unconverged, limits["unconverged"]),
                  "res64_max": (worst, limits["res64_max"])}
        return checks, self.unconverged
