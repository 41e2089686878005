"""Runnable examples of the port, one module each, counterparts of the
JAX package's ``examples/``.  Run one on the card as

    python -m experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.examples.demo

and on the CPU at small sizes with ``--device cpu --smoke``.  Each module
has ``main(argv=None)``, which prints its results and returns them as a
dict.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

__all__ = ["EXAMPLES", "parse_args", "card_line"]

EXAMPLES = (
    "demo",
    "throughput",
    "convergence",
    "statics_sweep",
    "inverse_kinematics",
    "tendon_robot",
    "magnetic_catheter",
    "contact_scene",
    "bifurcation_diagram",
    "flutter_analysis",
    "parallel_robot",
    "optimal_control",
    "shape_sensing",
)


def parse_args(argv, doc: str):
    """``(device, smoke)`` from ``--device`` (default ``cuda``; no fallback
    to the CPU) and ``--smoke`` (the small sizes of a CPU check)."""
    parser = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; 'cpu' for a CPU run)")
    parser.add_argument("--smoke", action="store_true",
                        help="small sizes, for a quick check on the CPU")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device, args.smoke


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them (the
    device name when it cannot be asked), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index}"], capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
