"""Benchmark of the PyTorch + CUDA port: one run of one cell.

    python3 -m rodbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names a
configuration (``rodbench/configs/<config>.json``, whose ``entry`` names
``rodbench/entries/<entry>.py``) and a traffic mix
(``rodbench/traffic/<mix>.json``); each metric of the cell is read by
``rodbench/metrics/<metric>.py``.  A run makes its inputs on the card from
the seed, warms the cell's shapes, measures for ``--seconds``, checks the
answers against the plain reference and prints one JSON line last on
standard output (the numbers compared, with their limits, also last on
standard error).  It exits non-zero, printing no result, without enough CUDA
devices, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax",
             "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu")
# Build and kernel caches at fixed paths inside the checkout (the port's own
# nvcc cache is its package's _build/).
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_loaded(names=None) -> list:
    """The forbidden top-level packages among ``names`` (default: every
    loaded module), each compared whole: ``jax_foo`` is not ``jax``."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_parts(manifest: dict, workload: str, root: pathlib.Path = ROOT) -> tuple:
    """``(cell, config, traffic)`` of a workload name, each file found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "rodbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones: those
    whose ``workloads`` name it, or, without that key, every cell's (a
    per-layer metric then goes where its end-to-end metric does)."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m["workloads"] or ("workloads" not in m and m["moves"] in moved)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    pin_to_one_core()
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".rodbench_cache" / sub)

    manifest = load_manifest()
    cell, config, traffic = cell_parts(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rodbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    from rodbench import window

    line, checks = window.measure(cell, config, traffic,
                                  cell_metrics(manifest, args.workload, bool(args.trace)),
                                  args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T_START)
    line["device"]["power_limit"] = power_limit()
    found = forbidden_loaded()
    if found:
        print(f"rodbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for text in checks:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


def pin_to_one_core() -> None:
    """Keep this process and the threads it starts on one core of those it may
    use (a middle one, away from the first, which takes most interrupts): the
    host's share of each call then moves less from run to run."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[len(cores) // 2]})


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read: {exc}"
    return out.stdout.strip() or f"not read: {out.stderr.strip()}"


if __name__ == "__main__":
    sys.exit(main())
