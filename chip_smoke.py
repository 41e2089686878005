"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure (exit code != 0, no result lines):

1. environment: versions, the card, its power limit, nvcc and triton;
2. build the CUDA kernels K1-K3 from ``csrc/``;
3. each kernel against its plain PyTorch version on the card
   (B=4096, N in {8, 16, 33}, na in {3, 6});
4. the slice at real size (B=131072, N=16, na=3, strains 0.8*N(0,1)):
   ``rod_shape_refined_fused`` single-kernel (K3) and staged (K2) and
   ``rod_shape(method='fused')`` (K1), with launch counts, NaN checks, the
   f64 dense solve on the card as reference, and the golden demo tip;
5. CUDA-event timings of each kernel and of the headline call beside their
   plain versions.

The last three lines of standard output are a JSON line with the kernels,
the card's name and power limit as nvidia-smi prints them, and the JSON
result line.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    doubledouble as dd,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    build,
    refined_kernel as rfk,
    rod_kernel as rk,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils.profiling import (
    cuda_time_ms,
)

PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch"
JAX_PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu"
B_REAL = 131072
B_CHECK = 4096
F32_TOL = 5e-5     # K1/K2 vs plain: the 'high' gate of tests/test_pallas_kernel.py:26,43
K3_TOL = 1e-9      # K3 vs plain on the joined f64 outputs
GATE = 1e-8        # refined paths vs the f64 dense solve, relative L-inf
GOLDEN_Q = (0.799770, 0.0, 0.600307, 0.0)   # demo tip, SURVEY.md section 4
GOLDEN_R = (0.562673, 0.0, -0.745914)
GOLDEN_TOL = 1e-6

KERNELS = {
    "K1": dict(name="K1 rod_shape_fused", wrapper=rk.rod_shape_fused,
               source=f"{PKG}/csrc/rod_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:395"),
    "K2": dict(name="K2 picard_correction_fused", wrapper=rk.picard_correction_fused,
               source=f"{PKG}/csrc/rod_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:447"),
    "K3": dict(name="K3 rod_shape_refined_kernel", wrapper=rfk.rod_shape_refined_kernel,
               source=f"{PKG}/csrc/refined_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:890"),
}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is false)")
    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as exc:
        print(f"triton does not import: {exc}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60)
    print("nvcc:", [ln for ln in nvcc.stdout.splitlines() if "release" in ln][0].strip())
    return card


def phase_build() -> None:
    for module in (rk, rfk):
        t0 = time.perf_counter()
        lib = module.build_library()
        print(f"built {lib._name.split('/')[-1]}: nvcc {lib.build_seconds:.1f} s, "
              f"load {time.perf_counter() - t0:.1f} s total")
    for log in sorted(build.BUILD_DIR.glob("*.nvcc.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def record(errors: dict, key: str, err: float, tol: float, what: str) -> None:
    print(f"  {what}: max |kernel - plain| = {err:.3e} (bound {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{what}: {err:.3e} > {tol:.0e}")
    errors[key] = max(errors.get(key, 0.0), err)


def joined(outs):
    return dd.join_f64(outs[0], outs[1]), dd.join_f64(outs[2], outs[3])


def compare_k3(errors: dict, outs, plain, what: str) -> None:
    kq, kr = joined(outs)
    pq, pr = joined(plain)
    if not torch.equal(torch.isnan(kq), torch.isnan(pq)):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    if torch.isnan(kq).any():
        raise AssertionError(f"{what}: NaN for in-domain strains")
    record(errors, "K3", max(max_abs(kq, pq), max_abs(kr, pr)), K3_TOL, what)


def phase_kernels_vs_plain(dev: torch.device, errors: dict) -> None:
    rng = np.random.default_rng(0)
    for n in (8, 16, 33):
        for na in (3, 6):
            cfg = rod.RodConfig(n=n, na=na)
            qe64 = torch.tensor(0.8 * rng.standard_normal((B_CHECK, na * 3)), device=dev)
            hi, lo = dd.split_f64(qe64)
            rhs = torch.tensor(0.1 * rng.standard_normal((B_CHECK, n - 1, 4)),
                               dtype=torch.float32, device=dev)
            before = {k: v["wrapper"].launches for k, v in KERNELS.items()}

            q, r = rk.rod_shape_fused(hi, cfg)
            torch.cuda.synchronize()
            qp, rp = rk.rod_shape_fused_plain(hi, cfg)
            record(errors, "K1", max(max_abs(q, qp), max_abs(r, rp)), F32_TOL,
                   f"K1 n={n} na={na}")

            x = rk.picard_correction_fused(hi, rhs, cfg)
            torch.cuda.synchronize()
            record(errors, "K2", max_abs(x, rk.picard_correction_plain(hi, rhs, cfg)), F32_TOL,
                   f"K2 n={n} na={na}")

            outs = rfk.rod_shape_refined_kernel(hi, lo, cfg)
            torch.cuda.synchronize()
            compare_k3(errors, outs, rfk.rod_shape_refined_plain(hi, lo, cfg),
                       f"K3 n={n} na={na}")

            for key, spec in KERNELS.items():
                if spec["wrapper"].launches != before[key] + 1:
                    raise AssertionError(f"{key}: launch counter did not move")


def rel_linf(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def phase_slice(dev: torch.device) -> dict:
    rng = np.random.default_rng(0)
    qe64 = torch.tensor(0.8 * rng.standard_normal((B_REAL, 9)), device=dev)
    qe64[0] = rod.demo_qe(torch.float64, dev)
    qdd = rod.split_strain(qe64)

    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    single = rod.rod_shape_refined_fused(qdd, refine_steps=1)
    staged = rod.rod_shape_refined_fused(qdd, refine_steps=2)
    fused = rod.rod_shape(qdd[0], method="fused")
    torch.cuda.synchronize()
    launches = {k: spec["wrapper"].launches for k, spec in KERNELS.items()}
    print(f"main-path launches: {launches}")
    for key, count in launches.items():
        if count < 1:
            raise AssertionError(f"{key} was not launched by the main path")

    outs = {"K3 single kernel": (single.quaternions_f64(), single.positions_f64()),
            "K2 staged": (staged.quaternions_f64(), staged.positions_f64()),
            "K1 fused": (fused.quaternions, fused.positions)}
    for what, (q, r) in outs.items():
        if q.shape != (B_REAL, 15, 4) or r.shape != (B_REAL, 15, 3):
            raise AssertionError(f"{what}: shapes {tuple(q.shape)}, {tuple(r.shape)}")
        if not (torch.isfinite(q).all() and torch.isfinite(r).all()):
            raise AssertionError(f"{what}: non-finite output for 0.8*N(0,1) strains")

    sample = 1024   # rods solved densely in f64 on the card; rod 0 is the demo strain
    ref = rod.rod_shape(qe64[:sample], method="dense")
    for what, (q, r) in outs.items():
        bound = GATE if what != "K1 fused" else F32_TOL
        demo = max(rel_linf(q[0], ref.quaternions[0]), rel_linf(r[0], ref.positions[0]))
        worst = max(float((q[:sample] - ref.quaternions).abs().max()),
                    float((r[:sample] - ref.positions).abs().max()))
        print(f"  {what}: demo rel L-inf {demo:.3e}, max abs over {sample} rods "
              f"{worst:.3e} vs f64 dense (bound {bound:.0e})")
        if not (demo <= bound and worst <= bound):
            raise AssertionError(f"{what}: outside {bound:.0e} of the f64 dense solve")

    tip_q, tip_r = outs["K3 single kernel"][0][0, 0], outs["K3 single kernel"][1][0, 0]
    dq = float((tip_q.cpu() - torch.tensor(GOLDEN_Q, dtype=torch.float64)).abs().max())
    dr = float((tip_r.cpu() - torch.tensor(GOLDEN_R, dtype=torch.float64)).abs().max())
    print(f"  golden demo tip: Q {tip_q.tolist()}, r {tip_r.tolist()} "
          f"(|dQ| {dq:.2e}, |dr| {dr:.2e}, bound {GOLDEN_TOL:.0e})")
    if not (dq <= GOLDEN_TOL and dr <= GOLDEN_TOL):
        raise AssertionError("golden demo tip off")
    return launches


def phase_timing(dev: torch.device, card: str, errors: dict) -> dict:
    cfg = rod.RodConfig()
    rng = np.random.default_rng(1)
    qe64 = torch.tensor(0.8 * rng.standard_normal((B_REAL, 9)), device=dev)
    hi, lo = dd.split_f64(qe64)
    rhs = torch.zeros((B_REAL, 15, 4), dtype=torch.float32, device=dev)
    rhs[..., 0] = -cfg.grid(dev).dn_in.float()   # the staged path's base solve

    def headline_plain():
        if rod.strain_rho((hi, lo), cfg) > 5.0:     # the call's validity check
            raise ValueError("strain outside the validity domain")
        return rfk.rod_shape_refined_plain(hi, lo, cfg)

    pairs = {
        "K1": (lambda: rk.rod_shape_fused(hi, cfg), lambda: rk.rod_shape_fused_plain(hi, cfg)),
        "K2": (lambda: rk.picard_correction_fused(hi, rhs, cfg),
               lambda: rk.picard_correction_plain(hi, rhs, cfg)),
        "K3": (lambda: rfk.rod_shape_refined_kernel(hi, lo, cfg),
               lambda: rfk.rod_shape_refined_plain(hi, lo, cfg)),
        "headline": (lambda: rod.rod_shape_refined_fused((hi, lo), refine_steps=1),
                     headline_plain),
    }
    # Same inputs through kernel and plain version once more, at the real size.
    q, r = pairs["K1"][0]()
    qp, rp = pairs["K1"][1]()
    record(errors, "K1", max(max_abs(q, qp), max_abs(r, rp)), F32_TOL, f"K1 B={B_REAL}")
    record(errors, "K2", max_abs(pairs["K2"][0](), pairs["K2"][1]()), F32_TOL,
           f"K2 B={B_REAL}")
    compare_k3(errors, pairs["K3"][0](), pairs["K3"][1](), f"K3 B={B_REAL}")

    times = {}
    for key, (kernel, plain) in pairs.items():
        # plain, kernel, kernel, plain: both sides see the same card state
        p1 = cuda_time_ms(plain)
        k1 = cuda_time_ms(kernel)
        k2 = cuda_time_ms(kernel)
        p2 = cuda_time_ms(plain)
        times[key] = (min(k1, k2), min(p1, p2))
        print(f"  {key}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms at "
              f"B={B_REAL}, N=16 -> {B_REAL / min(k1, k2) * 1e3:.4g} vs "
              f"{B_REAL / min(p1, p2) * 1e3:.4g} solves/s [{card}]")
    return times


def main() -> None:
    print("== 1. environment")
    card = phase_environment()
    dev = torch.device("cuda", 0)
    print("== 2. build")
    phase_build()
    print("== 3. kernels vs plain versions on the card")
    errors = {}
    phase_kernels_vs_plain(dev, errors)
    print("== 4. the slice at B=131072, N=16")
    launches = phase_slice(dev)
    print("== 5. timing (CUDA events, median of 10 after 3 warm-up calls)")
    times = phase_timing(dev, card, errors)
    kernels = [
        {"name": spec["name"], "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "launches": launches[key],
         "max_abs_err": errors[key], "ms": times[key][0], "plain_ms": times[key][1]}
        for key, spec in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
