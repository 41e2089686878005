"""A cell's control: the plain reference put in the program's place, computed
in the precision below the configuration's, and run through the harness's own
window and check at the cell's size.  Every limit of the check lies below
what the control reads, so each seed comes out ``correct: false``.

    python3 -m rodbench.control --workload <cell> --seeds 1,2,3 [--seconds 2]

* ``rod_refined``: the dense collocation solve in float32 (TF32 off) in place
  of ``rod_shape_refined_fused``: Q and r in float32, their low halves zero.
* ``statics_batched``: the Newton on the balance residual with TF32 products
  (``reference.statics.control_newton``) in place of ``solve_statics_batched``.

Prints the harness's result line for each seed (the numbers compared beside
their limits under ``checks``) and exits 0 only when every seed came out not
correct.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat as port_statics,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    rod as port_rod,
)
from rodbench import run, window
from rodbench.reference import rod as ref_rod
from rodbench.reference import statics as ref_statics


def rod_control(config: dict):
    def call(qe, **_):
        hi, lo = qe
        q, r = ref_rod.solve(hi.to(torch.float64) + lo.to(torch.float64), n=config["n"],
                             ne=config["ne"], length=config["length"], dtype=torch.float32)
        return port_rod.RodSolution(q, r, (q, torch.zeros_like(q)), (r, torch.zeros_like(r)))

    return call


def statics_control(config: dict):
    def call(tip_force, tol, max_iter, iters, **_):
        qe, norm, steps = ref_statics.control_newton(
            tip_force, n=config["n"], ne=config["ne"], length=config["length"],
            stiffness=config["stiffness"], tol=tol, max_iter=max_iter, iters=iters)
        return port_statics.StaticsSolution(qe=qe, iterations=torch.tensor(steps),
                                            residual_norm=norm, converged=norm <= tol)

    return call


# entry -> (module of the program, the call the entry makes, its control)
CONTROLS = {"rod_refined": (port_rod, "rod_shape_refined_fused", rod_control),
            "statics_batched": (port_statics, "solve_statics_batched", statics_control)}


@contextlib.contextmanager
def in_place(config: dict):
    """The configuration's entry calls the control instead of the program."""
    module, name, control = CONTROLS[config["entry"]]
    real = getattr(module, name)
    setattr(module, name, control(config))
    try:
        yield
    finally:
        setattr(module, name, real)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("rodbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = run.load_manifest()
    cell, config, traffic = run.cell_parts(manifest, args.workload)
    metrics = run.cell_metrics(manifest, args.workload, False)
    device = torch.device("cuda", 0)
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        with in_place(config):
            line, checks = window.measure(cell, config, traffic, metrics, seed, args.seconds,
                                          False, device, time.perf_counter())
        for text in checks:
            print(text, file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": line}), flush=True)
        caught = caught and line["correct"] is False
        torch.cuda.empty_cache()
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
