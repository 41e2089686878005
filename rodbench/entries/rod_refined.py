"""Entry ``rod_refined``: the refined rod-shape solve of the port,
``models.rod.rod_shape_refined_fused(split_strain(qe), ...)``, held to the
plain float64 dense collocation solve of :mod:`rodbench.reference.rod`.

Inputs: strains ``(batch, na*ne)`` from the mix's generator, inside the fused
paths' domain ``rho = max_i |K(x_i)| L/2 <= max_rho`` (rows outside are drawn
again).  The benchmark splits each float64 strain into the f32 pair that
the refined path takes, with the program's own ``split_strain``, as a user
does.  Checks, over every rod of the calls kept for the check: the relative
L-inf gap of Q and of r to the reference, and the rods that came back NaN.
"""

from __future__ import annotations

import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    rod as port_rod,
)

from .. import generator
from ..reference import rod as ref_rod

ITEMS = "rods"
SYNC_GAP = "rho_check_sync"


class Bench:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        if config["na"] != 3:
            raise ValueError("the rod_refined entry's reference covers na = 3")
        self.config, self.traffic, self.device = config, traffic, device
        self.batch = traffic["batch"]
        self.cfg = port_rod.RodConfig(n=config["n"], na=config["na"], ne=config["ne"],
                                      length=config["length"], basis=config["basis"])
        gen = generator.make_generator(seed, device)
        self.strains, self.redrawn = generator.pool(traffic, config["na"] * config["ne"],
                                                    gen, device, accept=self.in_domain)
        self.inputs = [port_rod.split_strain(q) for q in self.strains]

    def in_domain(self, qe: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = ref_rod.cgl_points(c["n"], c["length"], torch.float64, qe.device)[:-1]
        k = ref_rod.curvature(qe, ref_rod.legendre_table(x, c["ne"], c["length"]))
        return torch.linalg.vector_norm(k, dim=-1).amax(-1) * c["length"] / 2.0 <= c["max_rho"]

    def call(self, slot: int):
        c = self.config
        return port_rod.rod_shape_refined_fused(
            self.inputs[slot], cfg=self.cfg, iters=c["iters"], refine_steps=c["refine_steps"],
            corr_iters=c["corr_iters"], check_validity=c["check_validity"],
            max_rho=c["max_rho"])

    def after_call(self, index: int, slot: int, out) -> None:
        pass

    def finish(self, calls: int) -> tuple:
        """``(items done, counters)`` once the window has closed."""
        return calls * self.batch, {}

    def check(self, kept: list, limits: dict) -> tuple:
        """``(checks, failed)``: ``checks[name] = (value, limit)``."""
        answers = []
        for slot, out in kept:
            q = out.quaternions_dd[0].to(torch.float64) + out.quaternions_dd[1].to(torch.float64)
            r = out.positions_dd[0].to(torch.float64) + out.positions_dd[1].to(torch.float64)
            answers.append((slot, q, r))
        kept.clear()
        self.inputs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        c = self.config
        nan_rods, q_err, r_err, q_max, r_max = 0, 0.0, 0.0, 0.0, 0.0
        for slot, q, r in answers:
            bad = torch.isnan(q).flatten(1).any(1) | torch.isnan(r).flatten(1).any(1)
            nan_rods += int(bad.sum())
            qr, rr = ref_rod.solve(self.strains[slot], n=c["n"], ne=c["ne"], length=c["length"])
            ok = ~bad
            q_err = max(q_err, float((q[ok] - qr[ok]).abs().max()) if bool(ok.any()) else 0.0)
            r_err = max(r_err, float((r[ok] - rr[ok]).abs().max()) if bool(ok.any()) else 0.0)
            q_max = max(q_max, float(qr.abs().max()))
            r_max = max(r_max, float(rr.abs().max()))
        checks = {"q_rel_linf": (q_err / q_max, limits["q_rel_linf"]),
                  "r_rel_linf": (r_err / r_max, limits["r_rel_linf"]),
                  "nan_rods": (nan_rods, limits["nan_rods"])}
        return checks, nan_rods
