"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure (exit code != 0, no result lines):

1. environment: versions, the card, its power limit, nvcc and triton;
2. build the CUDA kernels from ``csrc/``, one nvcc per source, all at once:
   K1-K5 narrow (n-1 <= 32) and K1-K5 wide (32 < n-1 <= 512); registers and
   spills per kernel, and whether each library's SASS holds tensor-core
   instructions: HMMA in every one, and DMMA (FP64) in the refined narrow
   one, whose FP64 products run there; a probe of how ``mma.sync`` rounds
   its FP32 tile sum and reads an f32 operand;
3. each kernel against its plain PyTorch version on the card: narrow at
   N in {8, 16, 32, 33} and a ragged batch, wide at n-1 in
   {33, 63, 64, 65, 128, 255, 512} and a ragged batch, na in {3, 6}; K4 and
   K5 with random unit q0 and r0 ~ U(-1, 1) per rod;
4. the paths at real size, each with the launch counts set to 0 just before
   it and read just after, NaN checks, and the port's f64 dense solve on the
   card as reference: the N=16 slice at B=131072 (``rod_shape_refined_fused``
   single-kernel and staged, ``rod_shape(method='fused')``, golden demo tip);
   refined n=64 (B=32768) and n=256 (B=8192) on K3 wide, staged n=64 on
   K2 wide, Reissner na=6 n=64 (B=8192), fused n=64 on K1 wide; the statics
   Newton ``solve_statics_batched`` at N=16 (B=16384) and n=64 (B=4096)
   against the per-sample ``solve_statics`` on 64 loads; the multi-segment
   paths: ``rod_shape(method='fused')`` with per-rod inits on K4 (B=131072),
   the chains 3 x n=16 (B=131072) and 2 x n=64 (B=32768) on K4/K4 wide and
   K5/K5 wide against the f64 dense chain, and the segmented statics Newton
   (B=8192; dd residual B=1024) against the per-sample Newton on the CPU;
4b. the statics layer: the dd Newton ``solve_statics_batched(dd_residual=True,
   tol=1e-9)`` at N=16 (B=16384; K1, K2, K3) and n=64 (B=4096; K1, K2, K3
   paired), held to the f64 dense residual and the per-sample f64 Newton;
   the batched Riks walk ``arc_length_continuation_batched`` at N=16 over
   4096 load rays (f32: K1 and K2, no K3) and its dd tier over 1024 (K3
   too), held to the host f64 Riks walker on 4 rays;
4c. the dynamics layer at the JAX bench's sizes: ``mass_matrix_fused`` (one
   K1 and one K2 launch; K1w/K2w at n=64) against ``mass_matrix`` at N=16
   (B=16384), na=6 (B=4096) and n=64 (B=2048); RK4 ``simulate`` at N=16,
   B=2048, 25 steps, in the fused tier (exactly 100 K1 and 100 K2 launches)
   and the default one, held to each other and, on 64 rods, to the f64
   default tier; the actuated statics Newton (three tendons, B=2048, every
   sample converged, each one's f64 balance residual), the one-tendon
   closed form kappa_y = -T delta / EI_y (B=2048, rtol 1e-8) and tendon IK
   over 64 reachable targets (tip error < 1e-6); RK4 in both tiers under
   every load given as host data makes no host sync per step (torch's sync
   debug mode);
4d. the rest of the dynamics layer, plain torch on the card (no kernel; 0
   launches expected and printed per call): implicit Newmark
   ``simulate_implicit`` (B=2048, 20 steps, within 5e-4 of RK4 at dt/4 on
   64 rods, energy drift < 1e-3; the stiff case at 50x RK4's step, energy
   under 2x its start), one host sync per Newton convergence test; the
   rod-rod scene ``simulate_scene`` (R=128, broad phase budget 6, no
   overflow, energy within 5e-4, no host sync per step; budget R-2 equals
   all pairs at R=8) and the rod-on-rod scene statics; the spectra
   (``natural_frequencies`` against the cantilever series, Beck's column,
   Floquet multipliers against exp(lambda T), ``critical_load`` at pi^2/4);
   segmented dynamics 3 x n=16 (B=2048 RK4 and Newmark energy drifts, the
   frequencies against the series); each call timed (CUDA events), the
   Newmark Jacobian's reverse and forward modes, and a profiler breakdown
   of four calls;
4e. the inverse and constrained layers at N=16 (the platforms at n=12,
   na=6): the fused ``sensing.measure`` (B=131072, markers and the tip
   frame; exactly one K1 launch and no other kernel) against the f64
   picard measure; ``fit_strain`` (B=4096) recovering noise-free strains,
   ``posterior_covariance`` (B=4096), ``identify_tip_load`` (B=256); the
   EKF and RTS smoother over 256 filters and 16 steps against the NEES and
   NIS gates; the pinned-tip Newton (B=1024), a six-leg platform's
   equilibria and stability over 64 wrenches, the portal's buckling load
   against 2 pi^2 EI/L^2, platform IK (B=16); ``optimize_protocol`` (B=64,
   5 Adam steps of 10 RK4 steps; ``mass_tier='fused'`` refused) and the
   calibration trainer (B=4096, 20 steps); each call timed (CUDA events)
   with its host syncs and launch counts, and a profiler breakdown of the
   fused measure and of three ``fit_strain`` iterates;
4f. concentric tubes, utils and examples (no kernel in the CTR layer; 0
   launches expected): ``solve_ctr`` over a 16^3 grid of base angles of a
   three-tube robot (n=16, B=4096, tol 1e-10; every sample converged, 16
   samples against the per-sample CPU solve within 1e-10), one host sync
   per Newton iterate (three iterates sync twice more than one), the
   closed forms of tests/test_ctr.py (twist-rigid aligned pair, mean twist,
   the snap threshold and the post-snap bistability, the telescoping
   two-arc tip) and the implicit-function Jacobian in reverse and forward
   mode against central differences; ``solve_ctr``, ``ctr_shape``
   (picard, dense), ``ctr_stability`` and the differentiable telescoping
   gradient timed, a profiler breakdown of ``solve_ctr``; the diagnostics
   of the demo solve; the thirteen examples of the package's ``examples/``
   (demo, throughput and convergence at full size, the rest with
   ``--smoke``; the demo's tip against the golden values, throughput
   launching K1 and K3);
4g. multi-device rod batches (``parallel/mesh.py``) on ``make_mesh()``
   (every visible card; with more than one, a 1-shard mesh beside it) and
   on the first card repeated 8 times: ``sharded_rod_shape`` fused and
   refined (B=131072, exactly one K1/K3 launch per shard, equal to the
   unsharded call), ``sharded_solve_statics`` (B=16384),
   ``sharded_simulate`` (RK4 fused, B=2048, 5 steps, 20 K1 and 20 K2 per
   shard), ``sharded_ctr_workspace`` (B=4096), ``sharded_riks_walk``
   (B=512) and ``sharded_segmented_statics`` (B=1024), each against its
   unsharded call at the JAX tests' gates, with its launches per shard and
   whole-call ms (CUDA events); 1 shard against the others for statics,
   RK4 and CTR with the device-busy share;
5. CUDA-event timings of each kernel (one call at a time, and back to back)
   beside its plain version, its bound
   (CUDA-core FP32, and with the f32 matrix products as 3xTF32 on the tensor
   cores) and (K2) the batched ``torch.linalg.solve`` of the same systems, of
   each path
   as a whole call (the N=16 fused and staged calls among them); a
   torch.profiler breakdown (device busy,
   idle share, top kernels) of the N=16 headline, refined n=256, staged
   n=64, statics N=16, refined 3 x n=16 chain, segmented statics, dd
   statics N=16 and f32 Riks calls; each dynamics-layer call (median of 3
   after a warm-up), rod-steps/s of both RK4 tiers, and a breakdown of the
   fused RK4 call.

The last three lines of standard output are a JSON line with the kernels,
the card's name and power limit as nvidia-smi prints them, and the JSON
result line.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib
import io
import json
import subprocess
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    calibration,
    constrained,
    control,
    cosserat,
    ctr,
    dynamics,
    estimation,
    magnetics,
    rod,
    segment_statics,
    segments,
    sensing,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch import examples
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    chebyshev,
    collocation as coll,
    doubledouble as dd,
    lie,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    build,
    refined_kernel as rfk,
    rod_kernel as rk,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.parallel import (
    mesh as parallel_mesh,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    diagnostics,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils.profiling import (
    cuda_time_ms,
    device_breakdown,
)

PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch"
JAX_PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu"
B_REAL = 131072
B_CHECK = 4096
F32_TOL = 5e-5     # K1/K2/K4 vs plain: the 'high' gate of tests/test_pallas_kernel.py:26,43
K3_TOL = 1e-9      # K3/K5 vs plain on the joined f64 outputs (tests/test_refined_kernel.py:27)
CHAIN_TOL = 2e-4   # fused chain vs the f64 dense chain (tests/test_segments.py:196-199)
GATE = 1e-8        # refined paths vs the f64 dense solve, relative L-inf
QE_TOL = 2e-5      # batched vs per-sample statics Newton (tests/test_cosserat_statics.py:207)
DD_RES_ERR = 1e-11  # the K5 chain's residual vs the f64 dense residual, absolute
GOLDEN_Q = (0.799770, 0.0, 0.600307, 0.0)   # demo tip, SURVEY.md section 4
GOLDEN_R = (0.562673, 0.0, -0.745914)
GOLDEN_TOL = 1e-6
# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores; FP64 on the tensor cores (DMMA), the higher of the card's two FP64
# rates, since K3's FP64 work is matrix products; HBM3 bandwidth.  The
# tensor-core bound runs the f32 matrix products as 3xTF32 at the dense TF32
# peak, three passes for an f32-accurate product.
F32_PEAK, F64_PEAK, HBM_RATE = 67e12, 67e12, 3.35e12
TF32X3_PEAK = 495e12 / 3

# How each kernel runs on the card, printed beside its timing.
NARROW_TC = "3xTF32 mma.sync Picard steps, the state in registers (narrow_tc.cuh)"
WIDE_TC = "3xTF32 mma.sync Picard steps, G^T and T in shared memory (tc_picard.cuh)"
REFINED_DMMA = NARROW_TC + "; FP64 residual and position on DMMA (mma.sync.m8n8k4.f64)"
REFINED_FMA = WIDE_TC + "; FP64 residual and position on the FMA units"

KERNELS = {
    "K1": dict(name="K1 rod_shape_fused", wrapper=rk.rod_shape_fused,
               source=f"{PKG}/csrc/rod_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:395",
               design=NARROW_TC),
    "K2": dict(name="K2 picard_correction_fused", wrapper=rk.picard_correction_fused,
               source=f"{PKG}/csrc/rod_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:447",
               design=NARROW_TC),
    "K3": dict(name="K3 rod_shape_refined_kernel", wrapper=rfk.rod_shape_refined_kernel,
               source=f"{PKG}/csrc/refined_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:890",
               design=REFINED_DMMA),
    "K1w": dict(name="K1 wide rod_shape_fused_wide", wrapper=rk.rod_shape_fused_wide,
                source=f"{PKG}/csrc/rod_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:738; "
                         f"{JAX_PKG}/ops/pallas/rod_kernel.py:997",
                design=WIDE_TC),
    "K2w": dict(name="K2 wide picard_correction_fused_wide",
                wrapper=rk.picard_correction_fused_wide,
                source=f"{PKG}/csrc/rod_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:738; "
                         f"{JAX_PKG}/ops/pallas/rod_kernel.py:997",
                design=WIDE_TC),
    "K3w": dict(name="K3 wide rod_shape_refined_kernel_wide",
                wrapper=rfk.rod_shape_refined_kernel_wide,
                source=f"{PKG}/csrc/refined_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:540; "
                         f"{JAX_PKG}/ops/pallas/refined_kernel.py:1195",
                design=REFINED_FMA),
    "K4": dict(name="K4 rod_shape_fused_bc", wrapper=rk.rod_shape_fused_bc,
               source=f"{PKG}/csrc/rod_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:508",
               design=NARROW_TC),
    "K4w": dict(name="K4 wide rod_shape_fused_bc_wide", wrapper=rk.rod_shape_fused_bc_wide,
                source=f"{PKG}/csrc/rod_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:738; "
                         f"{JAX_PKG}/ops/pallas/rod_kernel.py:997",
                design=WIDE_TC),
    "K5": dict(name="K5 rod_shape_refined_kernel_bc", wrapper=rfk.rod_shape_refined_kernel_bc,
               source=f"{PKG}/csrc/refined_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:792",
               design=REFINED_DMMA),
    "K5w": dict(name="K5 wide rod_shape_refined_kernel_bc_wide",
                wrapper=rfk.rod_shape_refined_kernel_bc_wide,
                source=f"{PKG}/csrc/refined_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:635; "
                         f"{JAX_PKG}/ops/pallas/refined_kernel.py:1195",
                design=REFINED_FMA),
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
    build_fns = (rk.build_library, rk.build_wide_library, rfk.build_library,
                 rfk.build_wide_library)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build_fns)) as pool:
        libs = list(pool.map(lambda f: f(), build_fns))
    cuobjdump = str(Path(build.nvcc_path()).with_name("cuobjdump"))
    for lib in libs:
        sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        hmma, dmma = sass.count("HMMA"), sass.count("DMMA")
        print(f"built {lib._name.split('/')[-1]}: nvcc {lib.build_seconds:.1f} s; tensor-core "
              f"instructions in its SASS: HMMA {hmma}, DMMA {dmma}")
        if not hmma:
            raise AssertionError(f"{lib._name}: its kernels run on the tensor cores but its "
                                 "SASS holds no HMMA instruction")
        if "refined_kernel-" in lib._name and not dmma:
            raise AssertionError(f"{lib._name}: K3/K5 narrow form their FP64 products on the "
                                 "FP64 tensor cores but the SASS holds no DMMA instruction")
    print(f"all built in {time.perf_counter() - t0:.1f} s (parallel)")
    rows = []   # (library, mangled kernel, ptxas line)
    for log in sorted(build.BUILD_DIR.glob("*.nvcc.log")):
        kernel = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                rows.append((log.stem, kernel, line.split(":", 1)[-1].strip()))
    mangled = sorted({k for _, k, _ in rows})
    cufilt = str(Path(build.nvcc_path()).with_name("cu++filt"))
    names = dict(zip(mangled, subprocess.run([cufilt, "-p", *mangled], capture_output=True,
                                             text=True, check=True, timeout=60).stdout.splitlines()))
    for lib, kernel, text in rows:
        print(f"  {lib} {names[kernel]}: {text}")


# One m16n8k8 TF32 tile per warp through tc_picard.cuh's own mma_tf32, on
# row-major a (16 x 8), b (8 x 8) and c (16 x 8): c += a b.
PROBE_CU = r"""
#include "tc_picard.cuh"
__global__ void probe(const float* a, const float* b, float* c, int tiles) {
    const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32, g = threadIdx.x % 32 / 4,
              t = threadIdx.x % 4;
    if (w >= tiles) return;
    a += w * 128; b += w * 64; c += w * 128;
    const uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[g * 8 + 64 + t]),
                            __float_as_uint(a[g * 8 + t + 4]), __float_as_uint(a[g * 8 + 68 + t])};
    float* cr[4] = {c + g * 8 + 2 * t, c + g * 8 + 2 * t + 1, c + g * 8 + 64 + 2 * t,
                    c + g * 8 + 65 + 2 * t};
    float cf[4] = {*cr[0], *cr[1], *cr[2], *cr[3]};
    tc::mma_tf32(cf, af, __float_as_uint(b[t * 8 + g]), __float_as_uint(b[t * 8 + 32 + g]));
    for (int q = 0; q < 4; ++q) *cr[q] = cf[q];
}
extern "C" int tc_probe(const float* a, const float* b, float* c, int tiles) {
    probe<<<(tiles + 7) / 8, 256>>>(a, b, c, tiles);
    return (int)cudaGetLastError();
}
"""


def phase_accumulation_probe(dev: torch.device) -> None:
    """How the tensor cores round the FP32 sum of an ``mma.sync`` tile:
    ``c + a b`` for TF32-exact ``a``, ``b`` against the f64 sum rounded to
    the nearest f32.  The kernels sum each k-step's products in a fresh
    tile and add it to the state in FP32 because this sum is not rounded
    to nearest.  And how they read an f32 ``a`` that is not TF32-exact:
    the narrow kernels pass the lo part of their split so, counting on the
    low 13 bits being ignored (truncated); raises if they are not."""
    src, so = build.BUILD_DIR / "tc_probe.cu", build.BUILD_DIR / "libtc_probe.so"
    src.write_text(PROBE_CU)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
                    str(src)], capture_output=True, text=True, check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    rng, tiles = np.random.default_rng(0), 4096

    def tf32(x):
        return ((x.astype(np.float32).view(np.int32) + 0x1000) & -0x2000).view(np.float32)

    for what, scale in (("c = 0", 0.0), ("|c| ~ 16 |a b|", 16.0)):
        a, b = tf32(rng.standard_normal((tiles, 16, 8))), tf32(rng.standard_normal((tiles, 8, 8)))
        c = (scale * np.sqrt(8) * rng.standard_normal((tiles, 16, 8))).astype(np.float32)
        exact = np.einsum("tik,tkj->tij", a.astype(np.float64), b.astype(np.float64)) + c
        ta, tb, tcc = (torch.tensor(v, device=dev) for v in (a, b, c))
        build.check_launch(lib.tc_probe(*(ctypes.c_void_p(v.data_ptr()) for v in (ta, tb, tcc)),
                                        tiles), "tc_probe")
        out = tcc.cpu().numpy().astype(np.float64)
        rn = exact.astype(np.float32)
        rz = np.where(np.abs(rn) > np.abs(exact), np.nextafter(rn, np.float32(0)), rn)
        ulps = (out - exact) * np.sign(exact) / np.spacing(np.abs(rn)).astype(np.float64)
        print(f"  tensor-core FP32 accumulation ({what}): {(out == rn).mean():.1%} of sums "
              f"rounded to nearest, {(out == rz).mean():.1%} toward zero; mean error "
              f"{ulps.mean():+.3f} ulp (toward zero < 0)")

    def product(a, b):
        ta, tb = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
        tcc = torch.zeros((tiles, 16, 8), dtype=torch.float32, device=dev)
        build.check_launch(lib.tc_probe(*(ctypes.c_void_p(v.data_ptr()) for v in (ta, tb, tcc)),
                                        tiles), "tc_probe")
        return tcc.cpu().numpy()

    a = rng.standard_normal((tiles, 16, 8)).astype(np.float32)
    b = tf32(rng.standard_normal((tiles, 8, 8)))
    raw = product(a, b)
    trunc = product((a.view(np.int32) & -0x2000).view(np.float32), b)
    same = float((raw == trunc).all(axis=(1, 2)).mean())
    print(f"  tensor-core f32 operand: {same:.1%} of tiles with raw f32 a equal those with a "
          f"truncated to TF32, {float((raw == product(tf32(a), b)).all(axis=(1, 2)).mean()):.1%} "
          f"those with a rounded")
    if same != 1.0:
        raise AssertionError("mma.sync does not truncate an f32 operand to TF32: the narrow "
                             "kernels' lo split (tf32_mma.cuh split_tf32_raw_lo) needs cvt.rna")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def record(errors: dict, key: str, err: float, tol: float, what: str) -> None:
    print(f"  {what}: max |kernel - plain| = {err:.3e} (bound {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{what}: {err:.3e} > {tol:.0e}")
    errors[key] = max(errors.get(key, 0.0), err)


def joined(outs):
    return dd.join_f64(outs[0], outs[1]), dd.join_f64(outs[2], outs[3])


def compare_k3(errors: dict, key: str, outs, plain, what: str) -> None:
    kq, kr = joined(outs)
    pq, pr = joined(plain)
    if not torch.equal(torch.isnan(kq), torch.isnan(pq)):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    if torch.isnan(kq).any():
        raise AssertionError(f"{what}: NaN for in-domain strains")
    record(errors, key, max(max_abs(kq, pq), max_abs(kr, pr)), K3_TOL, what)


def random_inits(rng, batch: int, dev):
    """Per-rod boundary values as f32 pairs: unit q0, r0 ~ U(-1, 1)."""
    q0 = rng.standard_normal((batch, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    return (dd.split_f64(torch.tensor(q0, device=dev)),
            dd.split_f64(torch.tensor(rng.uniform(-1.0, 1.0, (batch, 3)), device=dev)))


def compare_kernels(dev, errors: dict, rng, n: int, na: int, batch: int) -> None:
    """K1-K5 (narrow or wide, as the grid routes them) against their plain
    versions on one batch; each wrapper must launch once."""
    cfg = rod.RodConfig(n=n, na=na)
    wide = rk.is_wide(n - 1)
    keys = ("K1w", "K2w", "K3w", "K4w", "K5w") if wide else ("K1", "K2", "K3", "K4", "K5")
    qe64 = torch.tensor(0.8 * rng.standard_normal((batch, na * 3)), device=dev)
    hi, lo = dd.split_f64(qe64)
    rhs = torch.tensor(0.1 * rng.standard_normal((batch, n - 1, 4)), dtype=torch.float32,
                       device=dev)
    # a generator of their own, so K1-K3 see the same strains as before K4/K5
    (q0h, q0l), (r0h, r0l) = random_inits(np.random.default_rng((n, na, batch)), batch, dev)
    before = {k: KERNELS[k]["wrapper"].launches for k in keys}
    tag = f"n-1={n - 1} na={na} B={batch}"

    q, r = rk.rod_shape_fused(hi, cfg)
    torch.cuda.synchronize()
    qp, rp = rk.rod_shape_fused_plain(hi, cfg)
    record(errors, keys[0], max(max_abs(q, qp), max_abs(r, rp)), F32_TOL, f"{keys[0]} {tag}")
    x = rk.picard_correction_fused(hi, rhs, cfg)
    torch.cuda.synchronize()
    record(errors, keys[1], max_abs(x, rk.picard_correction_plain(hi, rhs, cfg)), F32_TOL,
           f"{keys[1]} {tag}")
    outs = rfk.rod_shape_refined_kernel(hi, lo, cfg)
    torch.cuda.synchronize()
    compare_k3(errors, keys[2], outs, rfk.rod_shape_refined_plain(hi, lo, cfg), f"{keys[2]} {tag}")
    q, r = rk.rod_shape_fused_bc(hi, q0h, r0h, cfg)
    torch.cuda.synchronize()
    qp, rp = rk.rod_shape_fused_bc_plain(hi, q0h, r0h, cfg)
    record(errors, keys[3], max(max_abs(q, qp), max_abs(r, rp)), F32_TOL, f"{keys[3]} {tag}")
    outs = rfk.rod_shape_refined_kernel_bc(hi, q0h, r0h, lo, q0l, r0l, cfg=cfg)
    torch.cuda.synchronize()
    compare_k3(errors, keys[4], outs,
               rfk.rod_shape_refined_bc_plain(hi, q0h, r0h, lo, q0l, r0l, cfg=cfg),
               f"{keys[4]} {tag}")
    for k in keys:
        if KERNELS[k]["wrapper"].launches != before[k] + 1:
            raise AssertionError(f"{k}: launch counter did not move ({tag})")


def phase_kernels_vs_plain(dev: torch.device, errors: dict) -> None:
    rng = np.random.default_rng(0)
    for n in (8, 16, 33):
        for na in (3, 6):
            compare_kernels(dev, errors, rng, n, na, B_CHECK)
    for npts in (33, 63, 64, 65, 128, 255, 512):
        for na in (3, 6):
            compare_kernels(dev, errors, rng, npts + 1, na, B_CHECK if npts <= 128 else 512)
    compare_kernels(dev, errors, rng, 66, 6, 1001)     # ragged against every block shape
    for na in (3, 6):                                  # n-1 = 31: P = 32 with a padded point
        compare_kernels(dev, errors, rng, 32, na, B_CHECK)
    compare_kernels(dev, errors, rng, 16, 6, 1001)     # ragged narrow: a warp part-filled


def counted(what: str, fn, needs: tuple) -> tuple:
    """Run one path with every launch count set to 0 just before it; the
    kernels in ``needs`` must have launched.  Returns (result, counts)."""
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {k: spec["wrapper"].launches for k, spec in KERNELS.items()
              if spec["wrapper"].launches}
    print(f"  {what}: launches {counts}")
    for k in needs:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"{what}: {k} was not launched")
    return out, counts


def rel_linf(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def check_outputs(what: str, q, r, shape: tuple) -> None:
    if q.shape != shape + (4,) or r.shape != shape + (3,):
        raise AssertionError(f"{what}: shapes {tuple(q.shape)}, {tuple(r.shape)}")
    if not (torch.isfinite(q).all() and torch.isfinite(r).all()):
        raise AssertionError(f"{what}: non-finite output")


def check_vs_dense(what: str, q, r, qe64, cfg, sample: int, bound: float) -> float:
    """Relative L-inf against the port's f64 dense solve on the card, over
    the first ``sample`` rods."""
    ref = rod.rod_shape(qe64[:sample], cfg=cfg, method="dense")
    err = max(rel_linf(q[:sample].double(), ref.quaternions),
              rel_linf(r[:sample].double(), ref.positions))
    print(f"  {what}: rel L-inf {err:.3e} vs f64 dense over {sample} rods (bound {bound:.0e})")
    if not err <= bound:
        raise AssertionError(f"{what}: outside {bound:.0e} of the f64 dense solve")
    return err


def phase_narrow_slice(dev: torch.device, launches: dict) -> None:
    """The narrow slice: N=16, na=3, B=131072, strains 0.8 N(0,1)."""
    rng = np.random.default_rng(0)
    qe64 = torch.tensor(0.8 * rng.standard_normal((B_REAL, 9)), device=dev)
    qe64[0] = rod.demo_qe(torch.float64, dev)
    qdd = rod.split_strain(qe64)

    paths = {"K3 single kernel": (lambda: rod.rod_shape_refined_fused(qdd, refine_steps=1), ("K3",)),
             "K2 staged": (lambda: rod.rod_shape_refined_fused(qdd, refine_steps=2), ("K2",)),
             "K1 fused": (lambda: rod.rod_shape(qdd[0], method="fused"), ("K1",))}
    outs = {}
    for what, (fn, needs) in paths.items():
        sol, counts = counted(f"N=16 {what}", fn, needs)
        add_counts(launches, counts)
        outs[what] = ((sol.quaternions, sol.positions) if what == "K1 fused"
                      else (sol.quaternions_f64(), sol.positions_f64()))
        check_outputs(what, *outs[what], (B_REAL, 15))

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


def add_counts(launches: dict, counts: dict) -> None:
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def wide_inputs(dev):
    """The wide paths' inputs, bench.py's own sizes: strains 0.8 N(0,1)
    (seed 0) for n=64 (B=32768) and n=256 (B=8192); Reissner
    (0.5 N, 0.15 N) at B=8192; statics loads U(-0.4, 0.4) (seed 1)."""
    base = 0.8 * np.random.default_rng(0).standard_normal((32768, 9))
    qe64 = torch.tensor(base, device=dev)
    qe6 = torch.tensor(np.concatenate([0.5 * base[:8192], 0.15 * base[:8192]], axis=1),
                       device=dev)
    return qe64, qe6, statics_loads(dev)


def statics_loads(dev):
    """The statics users' tip loads: U(-0.4, 0.4), seed 1, B=16384 (bench.py:179-206)."""
    return torch.tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (16384, 3)),
                        dtype=torch.float32, device=dev)


CFG64, CFG256, CFG64_6 = rod.RodConfig(n=64), rod.RodConfig(n=256), rod.RodConfig(n=64, na=6)
STATICS = dict(tol=1e-5, max_iter=12, iters=16)


def wide_paths(qe64, qe6, loads):
    """Each wide path as one call: (callable, kernels it must launch)."""
    q64, q256 = rod.split_strain(qe64), rod.split_strain(qe64[:8192])
    s16 = cosserat.StaticsConfig(rod=rod.RodConfig(n=16))
    s64 = cosserat.StaticsConfig(rod=CFG64)
    return {
        "refined n=64 single kernel": (lambda: rod.rod_shape_refined_fused(
            q64, cfg=CFG64, refine_steps=1, iters="auto"), ("K3w",)),
        "refined n=256 single kernel": (lambda: rod.rod_shape_refined_fused(
            q256, cfg=CFG256, refine_steps=1, iters="auto"), ("K3w",)),
        "refined n=64 staged": (lambda: rod.rod_shape_refined_fused(
            q64, cfg=CFG64, refine_steps=2), ("K2w",)),
        "Reissner na=6 n=64": (lambda: rod.rod_shape_refined_fused(
            rod.split_strain(qe6), cfg=CFG64_6, refine_steps=1, iters=24, corr_iters=24),
            ("K3w",)),
        "fused n=64": (lambda: rod.rod_shape(q64[0], cfg=CFG64, method="fused"), ("K1w",)),
        "statics N=16 B=16384": (lambda: cosserat.solve_statics_batched(
            loads, cfg=s16, **STATICS), ("K1", "K2")),
        "statics n=64 B=4096": (lambda: cosserat.solve_statics_batched(
            loads[:4096], cfg=s64, **STATICS), ("K1w", "K2w")),
    }


def phase_wide_paths(dev: torch.device, launches: dict) -> dict:
    qe64, qe6, loads = wide_inputs(dev)
    paths = wide_paths(qe64, qe6, loads)
    results = {}
    for what, (fn, needs) in paths.items():
        results[what], counts = counted(what, fn, needs)
        add_counts(launches, counts)

    refs = {"refined n=64 single kernel": (qe64, CFG64, 256),
            "refined n=256 single kernel": (qe64[:8192], CFG256, 32),
            "refined n=64 staged": (qe64, CFG64, 256),
            "Reissner na=6 n=64": (qe6, CFG64_6, 256)}
    for what, (qe, cfg, sample) in refs.items():
        sol = results[what]
        q, r = sol.quaternions_f64(), sol.positions_f64()
        check_outputs(what, q, r, (qe.shape[0], cfg.n - 1))
        check_vs_dense(what, q, r, qe, cfg, sample, GATE)
    sol = results["fused n=64"]
    check_outputs("fused n=64", sol.quaternions, sol.positions, (32768, 63))
    check_vs_dense("fused n=64", sol.quaternions, sol.positions, qe64, CFG64, 256, F32_TOL)

    for what, cfg, b in (("statics N=16 B=16384", rod.RodConfig(n=16), 16384),
                         ("statics n=64 B=4096", CFG64, 4096)):
        sol = results[what]
        if sol.qe.shape != (b, 9) or not bool(sol.converged.all()):
            raise AssertionError(f"{what}: {int((~sol.converged).sum())} loads did not converge")
        ref = cosserat.solve_statics(loads[:64], cfg=cosserat.StaticsConfig(rod=cfg), **STATICS)
        err = max_abs(sol.qe[:64], ref.qe)
        print(f"  {what}: all converged in {int(sol.iterations)} steps, max residual "
              f"{float(sol.residual_norm.max()):.2e}; |qe - per-sample Newton| {err:.2e} "
              f"over 64 loads (bound {QE_TOL:.0e})")
        if not (bool(ref.converged.all()) and err <= QE_TOL):
            raise AssertionError(f"{what}: outside {QE_TOL:.0e} of solve_statics")
    return results


SEG16, SEG64 = segments.uniform_segments(3, n=16), segments.uniform_segments(2, n=64)
SEG_STATICS = segment_statics.SegmentedStaticsConfig(      # bench.py:230-242
    rods=segments.uniform_segments(2, n=16), stiffness=((1.0, 2.0, 2.0), (1.0, 1.0, 1.0)))
SEG_NEWTON = dict(tol=1e-5, max_iter=10, iters=16, jac_iters=8)
SEG_DD_NEWTON = dict(tol=1e-9, max_iter=14, iters=20, jac_iters=10, dd_residual=True,
                     dd_iters=22)
B_SEG64, B_SEG_NEWTON, B_SEG_DD = 32768, 8192, 1024   # bench.py:134-160,233-234


def segment_inputs(dev):
    """The multi-segment paths' inputs: strains 0.8 N(0,1) per segment
    (seed 3) for 3 x n=16 (B=131072) and 2 x n=64 (B=32768); one strain per
    rod with a random unit q0 and r0 ~ U(-1, 1) for the single fused solve;
    statics loads U(-0.4, 0.4) (seed 1, as the wide paths')."""
    rng = np.random.default_rng(3)
    qe16 = torch.tensor(0.8 * rng.standard_normal((B_REAL, 3, 9)), device=dev)
    qe64 = torch.tensor(0.8 * rng.standard_normal((B_SEG64, 2, 9)), device=dev)
    qe_bc = torch.tensor(0.8 * rng.standard_normal((B_REAL, 9)), device=dev)
    (q0, _), (r0, _) = random_inits(rng, B_REAL, dev)
    loads = wide_inputs(dev)[2]
    return dict(qe16=qe16, qe64=qe64, qe_bc=qe_bc, q0=q0, r0=r0, loads=loads,
                dd16=rod.split_strain(qe16), dd64=rod.split_strain(qe64))


def segment_paths(inp):
    """Each multi-segment path as one call: (callable, kernels it must launch)."""
    return {
        "fused N=16 with inits": (lambda: rod.rod_shape(
            inp["qe_bc"].float(), q_init=inp["q0"], r_init=inp["r0"], method="fused"),
            ("K4",)),
        "chain 3 x n=16 fused": (lambda: segments.segmented_rod_shape(
            inp["qe16"].float(), SEG16, method="fused", iters=20), ("K4",)),
        "chain 3 x n=16 refined_fused": (lambda: segments.segmented_rod_shape(
            inp["dd16"], SEG16, method="refined_fused"), ("K5",)),
        "chain 2 x n=64 fused": (lambda: segments.segmented_rod_shape(
            inp["qe64"].float(), SEG64, method="fused", iters=22), ("K4w",)),
        "chain 2 x n=64 refined_fused": (lambda: segments.segmented_rod_shape(
            inp["dd64"], SEG64, method="refined_fused", iters=22, corr_iters=22), ("K5w",)),
        "segmented statics": (lambda: segment_statics.solve_segmented_statics_batched(
            inp["loads"][:B_SEG_NEWTON], cfg=SEG_STATICS, **SEG_NEWTON), ("K4", "K2")),
        "segmented dd statics": (lambda: segment_statics.solve_segmented_statics_batched(
            inp["loads"][:B_SEG_DD], cfg=SEG_STATICS, **SEG_DD_NEWTON), ("K4", "K2", "K5")),
    }


def phase_segment_paths(dev, launches: dict) -> None:
    inp = segment_inputs(dev)
    results = {}
    for what, (fn, needs) in segment_paths(inp).items():
        results[what], counts = counted(what, fn, needs)
        add_counts(launches, counts)
        if what.startswith("segmented"):
            evals = int(results[what].iterations) + 1    # res_jac calls: one per step + 1
            print(f"    {int(results[what].iterations)} Newton steps; launches per "
                  f"residual-and-Jacobian evaluation: "
                  f"{ {k: v / evals for k, v in counts.items()} }")

    sample = 4096
    sol = results["fused N=16 with inits"]
    check_outputs("fused N=16 with inits", sol.quaternions, sol.positions, (B_REAL, 15))
    ref = rod.rod_shape(inp["qe_bc"][:sample], q_init=inp["q0"][:sample].double(),
                        r_init=inp["r0"][:sample].double(), method="dense")
    err = max(max_abs(sol.quaternions[:sample], ref.quaternions),
              max_abs(sol.positions[:sample], ref.positions))
    print(f"  fused N=16 with inits: max abs {err:.3e} vs f64 dense with the same inits over "
          f"{sample} rods (bound {F32_TOL:.0e})")
    if not err <= F32_TOL:
        raise AssertionError("fused N=16 with inits: outside the f32 gate of the dense solve")

    for cfg, key, sample in ((SEG16, "qe16", 4096), (SEG64, "qe64", 1024)):
        tag = f"{cfg.num_segments} x n={cfg.segments[0].n}"
        ref = segments.segmented_rod_shape(inp[key][:sample], cfg, method="dense")
        fused = results[f"chain {tag} fused"]
        check_outputs(f"chain {tag} fused", fused.quaternions[-1], fused.positions[-1],
                      (inp[key].shape[0], cfg.segments[0].n - 1))
        err = max(max_abs(fused.junction_quaternions[:sample], ref.junction_quaternions),
                  max_abs(fused.junction_positions[:sample], ref.junction_positions))
        print(f"  chain {tag} fused: max abs {err:.3e} at every junction vs the f64 dense "
              f"chain over {sample} rods (bound {CHAIN_TOL:.0e})")
        refined = results[f"chain {tag} refined_fused"]
        jq, jr = (dd.join_f64(*pair) for pair in refined.junction_dd)
        check_outputs(f"chain {tag} refined_fused", jq, jr, (inp[key].shape[0], cfg.num_segments))
        rel = max(rel_linf(jq[:sample], ref.junction_quaternions),
                  rel_linf(jr[:sample], ref.junction_positions))
        print(f"  chain {tag} refined_fused: rel L-inf {rel:.3e} at every junction vs the f64 "
              f"dense chain over {sample} rods (bound {GATE:.0e})")
        if not (err <= CHAIN_TOL and rel <= GATE):
            raise AssertionError(f"chain {tag}: outside its gate of the f64 dense chain")

    what, picks = "segmented statics", 8
    sol = results[what]
    if sol.qe.shape != (B_SEG_NEWTON, 2, 9) or not bool(sol.converged.all()):
        raise AssertionError(f"{what}: {int((~sol.converged).sum())} loads did not converge")
    idx = torch.linspace(0, B_SEG_NEWTON - 1, picks, device=dev).long()
    ref = segment_statics.solve_segmented_statics(inp["loads"][idx].double().cpu(),
                                                  cfg=SEG_STATICS, tol=1e-11)
    err = max_abs(sol.qe[idx].double().cpu(), ref.qe)
    print(f"  {what}: all converged, max residual {float(sol.residual_norm.max()):.2e}; "
          f"|qe - per-sample f64 Newton| {err:.2e} over {picks} loads (bound {QE_TOL:.0e})")
    if not (bool(ref.converged.all()) and err <= QE_TOL):
        raise AssertionError(f"{what}: outside {QE_TOL:.0e} of solve_segmented_statics")
    check_segmented_dd(results["segmented dd statics"], inp["loads"][:B_SEG_DD])


def check_segmented_dd(sol, loads) -> None:
    what, tol = "segmented dd statics", SEG_DD_NEWTON["tol"]
    b, s_count, nq = sol.qe.shape
    if sol.qe_lo is None or (b, s_count, nq) != (B_SEG_DD, 2, 9) or not bool(sol.converged.all()):
        raise AssertionError(f"{what}: {int((~sol.converged).sum())} loads did not converge")
    print(f"  {what}: all converged, max residual {float(sol.residual_norm.max()):.3e}")
    zero = torch.zeros(3)

    def dense_residual(q, f):
        return segment_statics.segmented_equilibrium_residual(
            q.reshape(-1, s_count, nq), f.to(q.device).double(), zero.to(q), SEG_STATICS,
            method="dense").reshape(q.shape[0], -1)

    def newton(f):
        ref = segment_statics.solve_segmented_statics(f.double().cpu(), cfg=SEG_STATICS,
                                                      tol=1e-12, max_iter=40, method="dense")
        return ref.qe.reshape(f.shape[0], -1), ref.residual_norm, ref.converged

    res_dd = segment_statics.segmented_equilibrium_residual_dd(
        (sol.qe, sol.qe_lo), loads, zero.to(loads), SEG_STATICS,
        iters=SEG_DD_NEWTON["dd_iters"]).reshape(b, -1)
    check_dd_newton(what, dd.join_f64(sol.qe, sol.qe_lo).reshape(b, -1), res_dd, loads, tol,
                    dense_residual, newton)


S16, S64 = cosserat.StaticsConfig(rod=rod.RodConfig(n=16)), cosserat.StaticsConfig(rod=CFG64)
# tests/test_cosserat_statics.py:228 for the dd Newton, :333 and :357 for the Riks walks
DD_NEWTON = dict(tol=1e-9, max_iter=25, iters=16, dd_residual=True)
DD_TRUE_RES = 1e-9   # the f64 dense residual at the dd strains, max abs (:228-244)
B_DD16, B_DD64, B_RIKS, B_RIKS_DD = 16384, 4096, 4096, 1024
RIKS = dict(ds=0.25, steps=8, tol=2e-5, iters=16)
RIKS_DD = dict(ds=0.25, steps=5, tol=1e-8, max_corrector=20, iters=16, dd_residual=True)
RIKS_F32_TOL = (5e-3, 2e-2)   # lambda, qe against the host f64 walker (:351-354)
RIKS_DD_TOL, RIKS_DD_RES = 1e-6, 1e-8
RAYS_CHECKED = 4


def load_rays(dev):
    """Riks load rays: uniform directions, magnitudes U(0.4, 0.6) (the JAX
    test's rays have 0.5-0.6), seed 4, B=4096."""
    rng = np.random.default_rng(4)
    d = rng.standard_normal((B_RIKS, 3))
    d *= rng.uniform(0.4, 0.6, (B_RIKS, 1)) / np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(d, dtype=torch.float32, device=dev)


def statics_layer_paths(loads, rays):
    """Each statics-layer path as one call: (callable, kernels it must launch)."""
    return {
        "dd statics N=16 B=16384": (lambda: cosserat.solve_statics_batched(
            loads, cfg=S16, **DD_NEWTON), ("K1", "K2", "K3")),
        "dd statics n=64 B=4096": (lambda: cosserat.solve_statics_batched(
            loads[:B_DD64], cfg=S64, **DD_NEWTON), ("K1w", "K2w", "K3w")),
        "Riks N=16 B=4096": (lambda: cosserat.arc_length_continuation_batched(
            rays, cfg=S16, **RIKS), ("K1", "K2")),
        "dd Riks N=16 B=1024": (lambda: cosserat.arc_length_continuation_batched(
            rays[:B_RIKS_DD], cfg=S16, **RIKS_DD), ("K1", "K2", "K3")),
    }


def phase_statics_layer(dev, launches: dict) -> None:
    """The dd Newton (N=16, n=64) and the batched Riks walker (f32, dd),
    held to the f64 dense residual, the per-sample f64 Newton and the host
    f64 Riks walker on the card."""
    loads, rays = statics_loads(dev), load_rays(dev)
    results = {}
    for what, (fn, needs) in statics_layer_paths(loads, rays).items():
        results[what], counts = counted(what, fn, needs)
        add_counts(launches, counts)
        if not what.startswith("dd") and counts.get("K3", 0):
            raise AssertionError(f"{what}: the f32 walk launched K3")
        if what.startswith("dd statics"):
            evals = int(results[what].iterations) + 1
            print(f"    {evals - 1} Newton steps; launches per residual-and-Jacobian "
                  f"evaluation: { {k: v / evals for k, v in counts.items()} }")
        else:
            k1 = counts.get("K1", 0)
            print(f"    {k1} K1+K2 evaluations (anchor Newton, Keller tangent, corrector "
                  f"iterates); launches per evaluation: "
                  f"{ {k: v / k1 for k, v in counts.items()} }")
    for what, cfg, b in (("dd statics N=16 B=16384", S16, B_DD16),
                         ("dd statics n=64 B=4096", S64, B_DD64)):
        check_statics_dd(what, results[what], loads[:b], cfg)
    check_riks("Riks N=16 B=4096", results["Riks N=16 B=4096"], rays, False)
    check_riks("dd Riks N=16 B=1024", results["dd Riks N=16 B=1024"], rays[:B_RIKS_DD], True)


def check_statics_dd(what: str, sol, loads, cfg) -> None:
    b, nq = sol.qe.shape
    if sol.qe_lo is None or not bool(sol.converged.all()):
        raise AssertionError(f"{what}: {int((~sol.converged).sum())} loads did not converge")
    print(f"  {what}: all converged in {int(sol.iterations)} steps, max residual "
          f"{float(sol.residual_norm.max()):.3e}")
    zero = torch.zeros(3)

    def dense_residual(q, f):
        return cosserat.equilibrium_residual(q, f.to(q.device).double()[:, None, :], zero.to(q),
                                             cfg, method="dense")

    def newton(f):
        ref = cosserat.solve_statics(f.double(), cfg=cfg, tol=1e-12, max_iter=40,
                                     method="dense")
        return ref.qe, ref.residual_norm, ref.converged

    res_dd = cosserat.equilibrium_residual_dd((sol.qe, sol.qe_lo), loads, zero.to(loads), cfg)
    picked = check_dd_newton(what, dd.join_f64(sol.qe, sol.qe_lo), res_dd, loads,
                             DD_NEWTON["tol"], dense_residual, newton)
    worst = float(picked.abs().max())
    print(f"    f64 dense residual at 16 spread picks: max abs {worst:.3e} (bound "
          f"{DD_TRUE_RES:.0e})")
    if not worst < DD_TRUE_RES:
        raise AssertionError(f"{what}: the f64 dense residual is not below {DD_TRUE_RES:.0e}")


def check_riks(what: str, walk, rays, dd_tier: bool) -> None:
    """Every ray converged at every step; RAYS_CHECKED spread rays against
    the host f64 Riks walker (dense kinematics) on the card; in the dd tier
    the last point of every ray an equilibrium of the f64 dense residual at
    its own load factor."""
    steps, b = walk.lambdas.shape
    if not bool(walk.converged.all()):
        raise AssertionError(f"{what}: {int((~walk.converged).sum())} steps did not converge")
    lam, qes = walk.lambdas.double(), walk.qes.double()
    kw = dict(RIKS_DD if dd_tier else RIKS)
    if dd_tier:
        lam, qes = lam + walk.lambdas_lo.double(), qes + walk.qes_lo.double()
        host_kw, (lam_tol, qe_tol) = dict(tol=1e-11), (RIKS_DD_TOL, RIKS_DD_TOL)
    else:
        host_kw, (lam_tol, qe_tol) = dict(tol=1e-9), RIKS_F32_TOL
    err_lam = err_qe = 0.0
    for s in torch.linspace(0, b - 1, RAYS_CHECKED).long().tolist():
        host = cosserat.arc_length_continuation(rays[s].double(), cfg=S16, ds=kw["ds"],
                                                steps=kw["steps"], method="dense", **host_kw)
        if not bool(host.converged.all()):
            raise AssertionError(f"{what}: the host walker did not converge on ray {s}")
        err_lam = max(err_lam, float((lam[:, s] - host.lambdas).abs().max()))
        err_qe = max(err_qe, float((qes[:, s] - host.qes).abs().max()))
    print(f"  {what}: all {b} rays converged at all {steps} steps (lambda reached "
          f"{float(lam[-1].min()):.3f}..{float(lam[-1].max()):.3f}); against the host f64 walker "
          f"over {RAYS_CHECKED} rays: |lambda| {err_lam:.3e} (bound {lam_tol:.0e}), |qe| "
          f"{err_qe:.3e} (bound {qe_tol:.0e})")
    if not (err_lam <= lam_tol and err_qe <= qe_tol):
        raise AssertionError(f"{what}: outside its gate of the host walker")
    if dd_tier:
        loads = lam[-1][:, None, None] * rays.double()[:, None, :]
        res = cosserat.equilibrium_residual(qes[-1], loads, loads.new_zeros(3), S16,
                                            method="dense")
        worst = float(torch.linalg.vector_norm(res, dim=-1).max())
        print(f"    last point's f64 dense residual at its dd load factor: max over {b} rays "
              f"{worst:.3e} (bound {RIKS_DD_RES:.0e})")
        if not worst < RIKS_DD_RES:
            raise AssertionError(f"{what}: the last point is not an f64 equilibrium")


def phase_statics_layer_timing(dev: torch.device, card: str) -> None:
    """Each statics-layer path as a whole call, and a profiler breakdown of
    the dd Newton N=16 and the f32 Riks walk."""
    paths = statics_layer_paths(statics_loads(dev), load_rays(dev))
    batch = {"dd statics N=16 B=16384": B_DD16, "dd statics n=64 B=4096": B_DD64,
             "Riks N=16 B=4096": B_RIKS, "dd Riks N=16 B=1024": B_RIKS_DD}
    for what, (fn, _) in paths.items():
        ms = cuda_time_ms(fn, warmup=1, reps=3)
        print(f"  {what}: {ms:.4f} ms per call -> {batch[what] / ms * 1e3:.4g} "
              f"{'solves' if 'statics' in what else 'walks'}/s [{card}]")
    for what in ("dd statics N=16 B=16384", "Riks N=16 B=4096"):
        prof = device_breakdown(paths[what][0], warmup=1, reps=2)
        print(f"  profile {what}: host {prof['host_ms']:.4f} ms per call, device busy "
              f"{prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, {prof['events']:.0f} "
              f"device events per call [{card}]")
        for name, ms, count in prof["top"]:
            print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


def check_dd_newton(what: str, qe, res_dd, loads, tol: float, dense_residual, newton,
                    picks: int = 16):
    """What a dd Newton's tolerance bounds.  ``qe (B, m)``: its f64 strains;
    ``res_dd (B, m)``: the FP64 residual it converged on, at ``qe``;
    ``dense_residual(q, loads)``: the f64 dense residual ``(P, m)`` on q's
    device; ``newton(loads)``: the per-sample f64 Newton's ``(qe (P, m),
    residual norm, converged)``.  Every load: the dd residual agrees with
    the f64 dense residual within DD_RES_ERR, so the dense residual is
    <= tol + DD_RES_ERR.  ``picks`` loads: the strains lie within the
    first-order bound 2 (tol + DD_RES_ERR + |res(ref)|) / sigma_min(J) of
    the per-sample f64 Newton's, with J the dense residual's Jacobian there
    (sigma_min ~ 0.1 for the segmented rod, so tol = 1e-9 allows ~2e-8).
    Returns the dense residual at the picks."""
    b = qe.shape[0]
    dense = dense_residual(qe, loads)
    dd_err = float((res_dd.double() - dense).abs().max())
    dense_norm = torch.linalg.vector_norm(dense, dim=-1)
    print(f"  {what}: |dd residual - f64 dense residual| {dd_err:.3e} (bound {DD_RES_ERR:.0e}), "
          f"max f64 dense residual {float(dense_norm.max()):.3e} (bound tol + {DD_RES_ERR:.0e}) "
          f"over all {b} loads")
    if not (dd_err <= DD_RES_ERR and float(dense_norm.max()) <= tol + DD_RES_ERR):
        raise AssertionError(f"{what}: the f64 dense residual is outside the tolerance")

    idx = torch.linspace(0, b - 1, picks, device=qe.device).long()
    q_ref, ref_norm, ref_converged = newton(loads[idx])
    f_ref = loads[idx].to(q_ref.device)
    jac = torch.func.jacfwd(lambda d: dense_residual(q_ref + d, f_ref))(
        q_ref.new_zeros(q_ref.shape[1]))
    sigma_min = torch.linalg.svdvals(jac)[:, -1]
    limit = 2 * (tol + DD_RES_ERR + ref_norm) / sigma_min
    err = (qe[idx].to(q_ref.device) - q_ref).abs().max(dim=-1).values
    print(f"    |qe - per-sample f64 Newton| max {float(err.max()):.3e} over {picks} loads; "
          f"sigma_min(J) {float(sigma_min.min()):.4f}..{float(sigma_min.max()):.4f}; "
          f"largest share of the first-order bound {float((err / limit).max()):.3e} "
          f"(bound >= {float(limit.min()):.3e})")
    if not (bool(ref_converged.all()) and bool((err <= limit).all())):
        raise AssertionError(f"{what}: strains outside what the tolerance bounds")
    return dense[idx]


# Phase 4c, the dynamics layer, at the JAX bench's sizes (bench.py:244-304).
B_MASS16, B_MASS6, B_MASS64 = 16384, 4096, 2048
B_DYN, DYN_STEPS, DYN_DT, DYN_ITERS = 2048, 25, 0.002, 10
B_DYN_REF = 64     # rods of the f32 trajectories held to an f64 one
B_ACT, B_IK = 2048, 64
MASS_GAP, MASS_GAP_NA6, MASS_SYM = 2e-3, 3e-3, 1e-6   # tests/test_mass_fused.py:33-36,51
SIM_QE_TOL, SIM_QD_TOL = 5e-4, 5e-3                   # tests/test_mass_fused.py:65-68
ACTUATED = dict(tol=2e-5, max_iter=12, iters=12, jac_chunk=3)   # bench.py:297-300
ACT_RES = 1e-4     # f64 balance residual of the f32 actuated equilibria
CLOSED_FORM_RTOL, IK_TOL = 1e-8, 1e-6                 # tests/test_tendon.py:43,240
DYN_CFG = dynamics.DynamicsConfig(statics=S16, rho_a=1.0, rho_i=1e-2)
MASS6_CFG = dynamics.DynamicsConfig(
    statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16, na=6, ne=2)), rho_a=1.0, rho_i=1e-2)
MASS64_CFG = dynamics.DynamicsConfig(statics=S64, rho_a=1.0, rho_i=1e-2)
ACT_CFG = dynamics.DynamicsConfig(statics=S16, tendons=(
    tendon.Tendon(offset=(0.0, 0.0, 0.05)), tendon.Tendon(offset=(0.0, 0.043, -0.025)),
    tendon.Tendon(offset=(0.0, -0.043, -0.025))))
ONE_TENDON = (0.05, 2.0)    # offset delta, EI_y
ONE_CFG = dynamics.DynamicsConfig(
    statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16), stiffness=(1.0, ONE_TENDON[1], 1.0)),
    tendons=(tendon.Tendon(offset=(0.0, 0.0, ONE_TENDON[0])),))
LOADED_CFG = dynamics.DynamicsConfig(statics=S16, rho_a=1.0, rho_i=1e-2, gravity=(0.0, 0.0, -9.81),
                                     tendons=ACT_CFG.tendons,
                                     magnets=(magnetics.Magnet(moment=(1.0, 0.0, 0.0)),))
HOST_LOADS = dict(tip_force=(0.0, 0.0, -0.1), tip_moment=[0.01, 0.0, 0.0],
                  base_accel=np.array([0.0, 0.1, 0.0]), tension=(0.5, 0.0, 0.3),
                  b_field=((0.0, 0.0, 0.01), 1e-3 * np.eye(3)))
IK_CFG = dynamics.DynamicsConfig(statics=S16, tendons=tuple(
    tendon.Tendon(offset=(0.0, 0.05 * np.cos(a), 0.05 * np.sin(a)))
    for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3)))     # tests/test_tendon.py:232-247


def dynamics_inputs(dev):
    """The dynamics layer's inputs: mass-matrix strains 0.5 N(0,1) (na=6:
    0.4 N, 0.1 N; seeds 3, 4, 5, tests/test_mass_fused.py); RK4 from 0.3 x
    the headline's strains at rest (bench.py:251-260); tensions U(0, 2)
    (seed 2, bench.py:293-295) for the three-tendon and (seed 6) the
    one-tendon batch; IK targets the tips of equilibria at tensions
    U(0, 3) (seed 8)."""
    rng6 = np.random.default_rng(4)
    return dict(
        mass16=torch.tensor(0.5 * np.random.default_rng(3).standard_normal((B_MASS16, 9)),
                            device=dev),
        mass6=torch.tensor(np.concatenate([0.4 * rng6.standard_normal((B_MASS6, 6)),
                                           0.1 * rng6.standard_normal((B_MASS6, 6))], axis=1),
                           device=dev),
        mass64=torch.tensor(0.5 * np.random.default_rng(5).standard_normal((B_MASS64, 9)),
                            device=dev),
        qe_dyn=rk4_strains(dev),
        tension=torch.tensor(np.random.default_rng(2).uniform(0.0, 2.0, (B_ACT, 3)),
                             dtype=torch.float32, device=dev),
        tension1=torch.tensor(np.random.default_rng(6).uniform(0.0, 2.0, (B_ACT, 1)), device=dev),
        targets=ik_targets(torch.tensor(np.random.default_rng(8).uniform(0.0, 3.0, (B_IK, 3)),
                                        device=dev)))


def rk4_strains(dev):
    """0.3 x the headline's first B_DYN strains, f32 (bench.py:251-260)."""
    head = 0.8 * np.random.default_rng(0).standard_normal((B_REAL, 9))
    head[0] = rod.demo_qe(torch.float64, "cpu").numpy()
    return torch.tensor(0.3 * head[:B_DYN], dtype=torch.float32, device=dev)


def rk4(qe0, tier: str):
    return dynamics.simulate(qe0, torch.zeros_like(qe0), DYN_CFG, dt=DYN_DT, steps=DYN_STEPS,
                             iters=DYN_ITERS, record_energy=False, mass_tier=tier)


def dynamics_paths(inp):
    """Each dynamics-layer path as one call: (callable, kernels it must launch)."""
    zeros = torch.zeros((B_ACT, 9), dtype=torch.float32, device=inp["tension"].device)
    return {
        "mass_matrix_fused N=16 B=16384": (lambda: dynamics.mass_matrix_fused(
            inp["mass16"], DYN_CFG, iters=20), ("K1", "K2")),
        "mass_matrix_fused na=6 B=4096": (lambda: dynamics.mass_matrix_fused(
            inp["mass6"], MASS6_CFG, iters=20), ("K1", "K2")),
        "mass_matrix_fused n=64 B=2048": (lambda: dynamics.mass_matrix_fused(
            inp["mass64"], MASS64_CFG, iters=20), ("K1w", "K2w")),
        "RK4 fused N=16 B=2048": (lambda: rk4(inp["qe_dyn"], "fused"), ("K1", "K2")),
        "RK4 default N=16 B=2048": (lambda: rk4(inp["qe_dyn"], "xla"), ()),
        "actuated statics B=2048": (lambda: dynamics.solve_contact_statics(
            ACT_CFG, qe0=zeros, tension=inp["tension"], **ACTUATED), ()),
        "one-tendon statics B=2048": (lambda: dynamics.solve_contact_statics(
            ONE_CFG, qe0=zeros.double(), tension=inp["tension1"], tol=1e-11), ()),
        "tendon_ik B=64": (lambda: tendon.tendon_ik(inp["targets"], IK_CFG, gn_steps=20), ()),
    }


def ik_targets(tension):
    """The tips of the three-tendon equilibria at ``tension``: reachable
    targets by construction."""
    sol = dynamics.solve_contact_statics(IK_CFG, qe0=torch.zeros(
        (tension.shape[0], 9), dtype=torch.float64, device=tension.device), tension=tension,
        tol=1e-11)
    if not bool(sol.converged.all()):
        raise AssertionError("the IK targets' forward equilibria did not converge")
    return rod.rod_shape(sol.qe, cfg=IK_CFG.rod, method="picard", iters=16).tip_position


def phase_dynamics_layer(dev, launches: dict) -> None:
    """The fused mass lane against ``mass_matrix``, the two RK4 tiers against
    each other (and an f64 trajectory), the actuated statics Newton, the
    one-tendon closed form and tendon IK."""
    inp = dynamics_inputs(dev)
    results = {}
    for what, (fn, needs) in dynamics_paths(inp).items():
        results[what], counts = counted(what, fn, needs)
        add_counts(launches, counts)
        if what.startswith("RK4 fused"):
            calls = 4 * DYN_STEPS
            if counts != {"K1": calls, "K2": calls}:
                raise AssertionError(f"{what}: launches {counts}, expected {calls} K1 and K2 "
                                     "(one of each per RK4 stage)")
    check_mass(inp, results)
    check_rk4(inp, results["RK4 fused N=16 B=2048"], results["RK4 default N=16 B=2048"])
    check_loaded_rk4_syncs_not(inp["qe_dyn"])
    check_actuated(inp, results["actuated statics B=2048"], results["one-tendon statics B=2048"])
    ik = results["tendon_ik B=64"]
    worst = float(ik.tip_error.max())
    print(f"  tendon_ik over {B_IK} reachable targets: max tip error {worst:.3e} (bound "
          f"{IK_TOL:.0e}); tensions {float(ik.tension.min()):.3f}..{float(ik.tension.max()):.3f}")
    if not (ik.tip_error.shape == (B_IK,) and worst < IK_TOL):
        raise AssertionError("tendon_ik: a target was not reached")


def check_mass(inp, results) -> None:
    """tests/test_mass_fused.py's gates against ``mass_matrix`` on the card
    (f64 input, iters 20)."""
    for (what, cfg, qe, gap_tol, per_sample) in (
            ("mass_matrix_fused N=16 B=16384", DYN_CFG, inp["mass16"], MASS_GAP, True),
            ("mass_matrix_fused na=6 B=4096", MASS6_CFG, inp["mass6"], MASS_GAP_NA6, False),
            ("mass_matrix_fused n=64 B=2048", MASS64_CFG, inp["mass64"], MASS_GAP, True)):
        m_f = results[what]
        ref = dynamics.mass_matrix(qe, cfg, iters=20)
        if m_f.shape != ref.shape or not bool(torch.isfinite(m_f).all()):
            raise AssertionError(f"{what}: shape {tuple(m_f.shape)} or non-finite output")
        if per_sample:
            gap = float((torch.linalg.matrix_norm(m_f - ref) / torch.linalg.matrix_norm(ref)).max())
        else:
            gap = float(torch.linalg.vector_norm(m_f - ref) / torch.linalg.vector_norm(ref))
        sym = float((m_f - m_f.transpose(-1, -2)).abs().max())
        eig = float(torch.linalg.eigvalsh(m_f).min())
        print(f"  {what}: relative Frobenius gap to mass_matrix {gap:.3e} (bound {gap_tol:.0e}"
              f"{', worst sample' if per_sample else ', whole batch'}), asymmetry {sym:.3e} "
              f"(bound {MASS_SYM:.0e}), smallest eigenvalue {eig:.3e} (> 0)")
        if not (gap < gap_tol and sym < MASS_SYM and eig > 0.0):
            raise AssertionError(f"{what}: outside tests/test_mass_fused.py's gates")


def check_rk4(inp, fused, default) -> None:
    """Both tiers finite and of shape (steps, B, 9), within
    tests/test_mass_fused.py:65-68 of each other; B_DYN_REF rods of each
    within the same bounds of the f64 default tier."""
    shape = (DYN_STEPS, B_DYN, 9)
    for what, traj in (("fused", fused), ("default", default)):
        if traj.qes.shape != shape or not bool(torch.isfinite(traj.qes).all() &
                                               torch.isfinite(traj.qds).all()):
            raise AssertionError(f"RK4 {what}: shape {tuple(traj.qes.shape)} or non-finite")
    ref = rk4(inp["qe_dyn"][:B_DYN_REF].double(), "xla")
    gaps = {"fused - default": (fused.qes - default.qes, fused.qds - default.qds),
            "fused - f64": (fused.qes[:, :B_DYN_REF] - ref.qes, fused.qds[:, :B_DYN_REF] - ref.qds),
            "default - f64": (default.qes[:, :B_DYN_REF] - ref.qes,
                              default.qds[:, :B_DYN_REF] - ref.qds)}
    moved = float((default.qes[-1] - inp["qe_dyn"]).abs().max())
    for what, (dqe, dqd) in gaps.items():
        eq, ed = float(dqe.abs().max()), float(dqd.abs().max())
        print(f"  RK4 {what}: max |qe| {eq:.3e} (bound {SIM_QE_TOL:.0e}), max |qd| {ed:.3e} "
              f"(bound {SIM_QD_TOL:.0e}); the strains moved up to {moved:.3e} in "
              f"{DYN_STEPS} steps")
        if not (eq < SIM_QE_TOL and ed < SIM_QD_TOL):
            raise AssertionError(f"RK4 {what}: outside tests/test_mass_fused.py:65-68")


def host_syncs(fn):
    """``(fn(), the host syncs torch's sync debug mode saw in it)``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def check_loaded_rk4_syncs_not(qe0) -> None:
    """RK4 in both tiers with every constant load given as host data
    (tuples, lists, numpy): they are copied to the card once per call, so
    the loop, the energy record included, makes no host sync: three steps
    sync as often as one under torch's sync debug mode."""
    for tier in dynamics.MASS_TIERS:
        def run(steps):
            return dynamics.simulate(qe0, torch.zeros_like(qe0), LOADED_CFG, dt=DYN_DT,
                                     steps=steps, iters=DYN_ITERS, mass_tier=tier, **HOST_LOADS)

        run(1)
        _, once = host_syncs(lambda: run(1))
        traj, thrice = host_syncs(lambda: run(3))
        ok = bool(torch.isfinite(traj.qes).all() & torch.isfinite(traj.energies).all())
        print(f"  RK4 {tier} tier, B={qe0.shape[0]}, every load constant host data, with the "
              f"energy record: host syncs {once} in 1 step, {thrice} in 3; finite {ok}")
        if not (ok and thrice == once and traj.qes.shape == (3,) + tuple(qe0.shape)):
            raise AssertionError(f"RK4 {tier} with host loads: a host sync per step, or "
                                 f"shape {tuple(traj.qes.shape)} or non-finite output")


def check_actuated(inp, act, one) -> None:
    """Every three-tendon sample converged, each one's f64 balance residual
    (24 Picard steps) below ACT_RES; the one-tendon batch on the closed form
    kappa_y = -T delta / EI_y."""
    conv = int(act.converged.sum())
    res = dynamics._balance_residual_fn(ACT_CFG, None, None, 24,
                                        tension=inp["tension"].double())(act.qe.double())
    worst = float(torch.linalg.vector_norm(res, dim=-1).max())
    print(f"  actuated statics: {conv} of {B_ACT} converged in {int(act.iterations)} Newton "
          f"steps (tol {ACTUATED['tol']:.0e}); f64 balance residual max {worst:.3e} (bound "
          f"{ACT_RES:.0e})")
    if conv != B_ACT or not worst < ACT_RES:
        raise AssertionError("actuated statics: a sample did not converge or balance")
    delta, ei_y = ONE_TENDON
    kappa = rod.curvature_at_points(ONE_CFG.rod, one.qe)
    expected = -inp["tension1"] * delta / ei_y                         # (B, 1)
    rel = float(((kappa[..., 1] - expected) / expected).abs().max())
    off = float(kappa[..., [0, 2]].abs().max())
    print(f"  one-tendon statics: {int(one.converged.sum())} of {B_ACT} converged (tol 1e-11) in "
          f"{int(one.iterations)} steps; kappa_y vs -T delta/EI_y: max relative error {rel:.3e} "
          f"(bound {CLOSED_FORM_RTOL:.0e}), other components {off:.3e}")
    if not (bool(one.converged.all()) and rel < CLOSED_FORM_RTOL and off < 1e-9):
        raise AssertionError("one-tendon statics: off the closed form")


def phase_dynamics_layer_timing(dev: torch.device, card: str) -> None:
    """Each dynamics-layer call (CUDA events, median of 3 after a warm-up),
    rod-steps/s of both RK4 tiers, and a profiler breakdown of the fused RK4
    call at 5 of its steps (the per-step work is the same)."""
    inp = dynamics_inputs(dev)
    for what, (fn, _) in dynamics_paths(inp).items():
        ms = cuda_time_ms(fn, warmup=1, reps=3)
        if what.startswith("RK4"):
            rate = f"{B_DYN * DYN_STEPS / ms * 1e3:.4g} rod-steps/s"
        elif what.startswith("mass"):
            rate = f"{int(what.split('B=')[1]) / ms * 1e3:.4g} mass matrices/s"
        else:
            rate = f"{int(what.split('B=')[1]) / ms * 1e3:.4g} solves/s"
        print(f"  {what}: {ms:.4f} ms per call -> {rate} [{card}]")
    short = inp["qe_dyn"]
    prof = device_breakdown(lambda: dynamics.simulate(
        short, torch.zeros_like(short), DYN_CFG, dt=DYN_DT, steps=5, iters=DYN_ITERS,
        record_energy=False, mass_tier="fused"), warmup=1, reps=1)
    print(f"  profile RK4 fused N=16 B=2048 (5 steps): host {prof['host_ms']:.4f} ms per call, "
          f"device busy {prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, "
          f"{prof['events']:.0f} device events per call [{card}]")
    for name, ms, count in prof["top"]:
        print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


# Phase 4d, the rest of the dynamics layer: plain torch on the card (no
# kernel), at the main path's width N=16, na=3, ne=3 (nq=9), f64 unless
# stated.  The gates are the JAX tests', cited per constant.
B_NM, NM_STEPS, NM_DT, NM_TOL = 2048, 20, 2e-3, 1e-9   # tests/test_dynamics.py:105-122
B_NM_REF, NM_GAP, NM_DRIFT = 64, 5e-4, 1e-3
STIFF_STEPS, STIFF_GROWTH = 25, 2.0                    # tests/test_dynamics.py:124-147
R_SCENE, SCENE_STEPS, SCENE_DT, SCENE_DRIFT = 128, 10, 0.004, 5e-4  # test_broadphase.py:133-151
R_PAIRS = 8                                            # tests/test_broadphase.py:41-54
B_SEG_DYN, SEG_STEPS, SEG_DT, SEG_DRIFT = 2048, 25, 5e-4, 1e-4    # test_segment_dynamics.py:35-44
SEG_NM_STEPS, SEG_NM_DT, SEG_NM_DRIFT = 4, 0.02, 1e-2              # test_segment_dynamics.py:47-57
FLOQUET_PERIOD = 0.025                                 # tests/test_floquet.py:27 at a tenth
EB = (1.875104 ** 2, 4.694091 ** 2)                    # tests/test_dynamics.py:14-25
STIFF_CFG = dynamics.DynamicsConfig(statics=S16, rho_a=1.0, rho_i=1e-4)
SCENE_RR = dynamics.RodRodContact(radius=0.08, stiffness=100.0, smoothing=5e-3, budget=6)
PAIR_RR = dynamics.RodRodContact(radius=0.05, stiffness=2e3, smoothing=2e-3)   # :730-758
PAIR_BASES = np.array([[0.0, 0.0, 0.0], [0.0, 0.08, 0.0]])
EB_CFG = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16, ne=5)),
                                 rho_a=1.0, rho_i=1e-4)
BECK_CFG = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
    rod=rod.RodConfig(n=14, ne=5), follower=True), rho_a=1.0, rho_i=1e-4)   # :893-917
FLOQUET_CFG = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
    rod=rod.RodConfig(n=8, ne=2)), rho_a=1.0, rho_i=1e-2, damping=0.5, kv_damping=2e-3)
EULER_CFG = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
    rod=rod.RodConfig(n=12, ne=4)), rho_a=1.0, rho_i=1e-4)   # :942-953
SEG_CFG = dynamics.SegmentedDynamicsConfig(
    statics=segment_statics.SegmentedStaticsConfig(rods=segments.uniform_segments(3, n=16, ne=3)),
    rho_a=1.0, rho_i=1e-3)
SEG_EB_CFG = dynamics.SegmentedDynamicsConfig(statics=SEG_CFG.statics, rho_a=1.0, rho_i=1e-4)


def rest_inputs(dev):
    """Newmark: B_NM_REF rods of the test's state (tests/test_dynamics.py:110:
    the constant k_y mode bent), qe_4 ~ U(0.25, 0.35) (seed 14), then phase
    4c's RK4 strains (0.3 x the headline's), at rest, f64;
    the stiff case about the test's state (qe_4 = 0.3, torsion rate 0.1),
    qe_4 ~ U(0.25, 0.35) and the rate ~ U(0.05, 0.15) (seed 13): from the
    RK4 strains, or the test's state plus 0.02 N(0,1), some rods' Newton
    fails at this dt and their energy blows up, in the JAX package too
    (PERF.md); the scene 0.2 N(0,1) on bases 0.12 apart (seed 5);
    the segmented rods bent as the test's (tests/test_segment_dynamics.py:38:
    the first two segments' constant k_y), k_y ~ U(0.25, 0.35) and
    U(0.15, 0.25) (seed 7)."""
    qe = rk4_strains(dev).double()
    qe[:B_NM_REF] = 0.0
    qe[:B_NM_REF, 4] = torch.tensor(np.random.default_rng(14).uniform(0.25, 0.35, B_NM_REF),
                                    device=dev)
    rng = np.random.default_rng(13)
    qe_stiff = torch.zeros_like(qe)
    qe_stiff[:, 4] = torch.tensor(rng.uniform(0.25, 0.35, B_NM), device=dev)
    qd_stiff = torch.zeros_like(qe)
    qd_stiff[:, 0] = torch.tensor(rng.uniform(0.05, 0.15, B_NM), device=dev)
    base = torch.zeros((R_SCENE, 3), dtype=torch.float64, device=dev)
    base[:, 1] = 0.12 * torch.arange(R_SCENE, dtype=torch.float64, device=dev)
    seg = torch.zeros((B_SEG_DYN, SEG_CFG.nq), dtype=torch.float64, device=dev)
    rng = np.random.default_rng(7)
    seg[:, 3] = torch.tensor(rng.uniform(0.25, 0.35, B_SEG_DYN), device=dev)
    seg[:, 12] = torch.tensor(rng.uniform(0.15, 0.25, B_SEG_DYN), device=dev)
    w_max = float(dynamics.natural_frequencies(STIFF_CFG, torch.zeros(9, dtype=torch.float64,
                                                                       device=dev)).max())
    return dict(
        qe=qe, qe_stiff=qe_stiff, qd_stiff=qd_stiff, dt_stiff=50 * 2.8 / w_max,
        scene=torch.tensor(0.2 * np.random.default_rng(5).standard_normal((R_SCENE, 9)),
                           device=dev), base=base, seg=seg)


def rest_calls(inp):
    """Each call of phase 4d: (callable, its check)."""
    dev = inp["qe"].device
    z = lambda cfg: torch.zeros(cfg.nq, dtype=torch.float64, device=dev)  # noqa: E731
    d = torch.tensor([-1.0, 0.0, 0.0], dtype=torch.float64, device=dev)
    qe, seg = inp["qe"], inp["seg"]
    return {
        f"Newmark B={B_NM} {NM_STEPS} steps": (lambda: dynamics.simulate_implicit(
            qe, torch.zeros_like(qe), DYN_CFG, dt=NM_DT, steps=NM_STEPS, tol=NM_TOL),
            lambda tr: check_newmark(qe, tr)),
        f"Newmark stiff B={B_NM} {STIFF_STEPS} steps": (lambda: dynamics.simulate_implicit(
            inp["qe_stiff"], inp["qd_stiff"], STIFF_CFG, dt=inp["dt_stiff"], steps=STIFF_STEPS,
            tol=NM_TOL),
            check_stiff),
        f"simulate_scene R={R_SCENE} budget {SCENE_RR.budget} {SCENE_STEPS} steps": (
            lambda: dynamics.simulate_scene(inp["scene"], torch.zeros_like(inp["scene"]), DYN_CFG,
                                            SCENE_RR, inp["base"], dt=SCENE_DT, steps=SCENE_STEPS),
            lambda tr: check_scene(inp, tr)),
        "scene statics rod on rod": (lambda: dynamics.solve_contact_statics(
            DYN_CFG, qe0=torch.zeros((2, 9), dtype=torch.float64, device=dev), rr=PAIR_RR,
            base_positions=PAIR_BASES, tol=1e-10, max_iter=60), check_pair_statics),
        "natural_frequencies n=16 ne=5": (lambda: dynamics.natural_frequencies(EB_CFG, z(EB_CFG)),
                                          lambda f: check_series("single rod", f)),
        "Beck column n=14 ne=5": (lambda: [dynamics.linearized_spectrum(
            BECK_CFG, z(BECK_CFG), tip_force=p * d, symmetric=False) for p in (19.5, 21.0)],
            check_beck),
        "floquet_multipliers n=8 ne=2": (lambda: floquet(z(FLOQUET_CFG)), check_floquet),
        "critical_load Euler n=12 ne=4": (lambda: dynamics.critical_load(
            EULER_CFG, direction=d, load_hi=5.0, bisect_tol=0.02), check_euler),
        f"segmented RK4 3 x n=16 B={B_SEG_DYN} {SEG_STEPS} steps": (lambda: dynamics.simulate(
            seg, torch.zeros_like(seg), SEG_CFG, dt=SEG_DT, steps=SEG_STEPS),
            lambda tr: check_drift("segmented RK4", tr, SEG_DRIFT)),
        f"segmented Newmark 3 x n=16 B={B_SEG_DYN} {SEG_NM_STEPS} steps": (
            lambda: dynamics.simulate_implicit(seg, torch.zeros_like(seg), SEG_CFG, dt=SEG_NM_DT,
                                               steps=SEG_NM_STEPS, iters=12, tol=NM_TOL),
            lambda tr: check_drift("segmented Newmark", tr, SEG_NM_DRIFT)),
        "segmented natural_frequencies 3 x n=16": (
            lambda: dynamics.natural_frequencies(SEG_EB_CFG, z(SEG_EB_CFG)),
            lambda f: check_series("segmented", f)),
    }


def floquet(qe0):
    """tests/test_floquet.py:14-36 over FLOQUET_PERIOD (the test's 0.25 took
    56.7 s on the card: 95 RK4 steps under jacrev; this one 10), at its dt
    |lambda|_max <= 0.15."""
    poles = dynamics.damped_spectrum(FLOQUET_CFG, qe0)
    steps = int(np.ceil(FLOQUET_PERIOD * float(np.abs(poles).max()) / 0.15))
    return poles, dynamics.floquet_multipliers(FLOQUET_CFG, FLOQUET_PERIOD, steps, qe0=qe0)


def check_newmark(qe, tr) -> None:
    """Gate 1: the test's B_NM_REF rods within NM_GAP of RK4 at dt/4; gate 2:
    every rod's energy within NM_DRIFT of its first step's.  The next
    B_NM_REF rods, from the headline's strains, run beside them against
    RK4 ungated: they excite the torsion branch, where the trapezoidal
    rule's O((omega dt)^2) phase error at this dt is above NM_GAP."""
    two = 2 * B_NM_REF
    ref = dynamics.simulate(qe[:two], torch.zeros_like(qe[:two]), DYN_CFG,
                            dt=NM_DT / 4, steps=4 * NM_STEPS, record_energy=False)
    gaps = (tr.qes[-1, :two] - ref.qes[-1]).abs().amax(-1)
    gap, gap_head = float(gaps[:B_NM_REF].max()), float(gaps[B_NM_REF:].max())
    moved = [float((tr.qes[-1, rows] - qe[rows]).abs().max())
             for rows in (slice(0, B_NM_REF), slice(B_NM_REF, None))]
    drift = float(((tr.energies[-1] - tr.energies[0]) / tr.energies[0]).abs().max())
    print(f"    Newmark vs RK4 at dt/4: the test's {B_NM_REF} rods max |qe| {gap:.3e} (bound "
          f"{NM_GAP:.0e}), moved {moved[0]:.3e}; {B_NM_REF} headline rods max |qe| "
          f"{gap_head:.3e} (ungated), moved {moved[1]:.3e}; worst relative energy drift of all "
          f"{B_NM} {drift:.3e} (bound {NM_DRIFT:.0e})")
    if not (tr.qes.shape == (NM_STEPS, B_NM, 9) and gap < NM_GAP and drift < NM_DRIFT):
        raise AssertionError("Newmark: outside tests/test_dynamics.py:105-122")


def check_stiff(tr) -> None:
    e = tr.energies
    growth = float((e[-1] / e[0]).max())
    print(f"    stiff Newmark: energies finite {bool(torch.isfinite(e).all())}, worst e[-1]/e[0] "
          f"{growth:.4f} (bound {STIFF_GROWTH})")
    if not (bool(torch.isfinite(e).all()) and growth < STIFF_GROWTH):
        raise AssertionError("stiff Newmark: outside tests/test_dynamics.py:124-147")


def check_scene(inp, tr) -> None:
    """No overflow at the start or the end, the energy within SCENE_DRIFT,
    and budget R-2 against all pairs at R=8 (rtol 1e-12)."""
    r0 = dynamics._scene_positions(inp["scene"], DYN_CFG, inp["base"], 16)
    r1 = dynamics._scene_positions(tr.qes[-1], DYN_CFG, inp["base"], 16)
    overflow = bool(SCENE_RR.broadphase_overflow(r0)) or bool(SCENE_RR.broadphase_overflow(r1))
    e = tr.energies
    drift = float((e[-1] - e[0]).abs() / max(float(e[0].abs()), 1.0))
    w_q = DYN_CFG.quad_weights_full
    dense, full = (float(dataclasses.replace(SCENE_RR, budget=b).pair_potential(r0[:R_PAIRS], w_q))
                   for b in (None, R_PAIRS - 2))
    rel = abs(full - dense) / dense
    print(f"    scene: overflow {overflow}; energy {float(e[0]):.6f} -> {float(e[-1]):.6f}, drift "
          f"{drift:.3e} (bound {SCENE_DRIFT:.0e}); budget R-2 vs all pairs at R={R_PAIRS}: "
          f"potential {dense:.6e}, relative gap {rel:.3e} (bound 1e-12)")
    if overflow or not (drift < SCENE_DRIFT and dense > 0.0 and rel < 1e-12):
        raise AssertionError("scene: outside tests/test_broadphase.py's gates")


def check_pair_statics(sol) -> None:
    """tests/test_dynamics.py:730-758 at N=16."""
    r = dynamics._scene_positions(sol.qe, DYN_CFG, PAIR_BASES, 24)
    tip_sep = float(torch.linalg.vector_norm(r[0, 0] - r[1, 0]))
    qdd = float(dynamics.scene_accelerations(sol.qe, torch.zeros_like(sol.qe), DYN_CFG, PAIR_RR,
                                             PAIR_BASES).abs().max())
    om2 = dynamics.linearized_spectrum(DYN_CFG, qe=sol.qe, rr=PAIR_RR, base_positions=PAIR_BASES)
    print(f"    rod on rod: converged {bool(sol.converged)} in {int(sol.iterations)} steps, tip "
          f"separation {tip_sep:.4f} (in (0.11, 0.15)), max |qdd| {qdd:.3e} (bound 1e-7), "
          f"smallest scene omega^2 {om2[0]:.4f} (> 0)")
    if not (bool(sol.converged) and 0.11 < tip_sep < 0.15 and qdd < 1e-7 and om2[0] > 0):
        raise AssertionError("scene statics: outside tests/test_dynamics.py:730-758")


def check_series(what: str, freqs) -> None:
    f = np.sort(freqs)
    rel = [abs(f[i] / EB[i // 2] - 1.0) for i in range(4 if what == "single rod" else 3)]
    print(f"    {what} natural frequencies {f[:4].round(6).tolist()}: relative gaps to the "
          f"cantilever series {np.round(rel, 6).tolist()} (bounds 2e-3, 2e-3, 5e-3, 5e-3)")
    if not all(r < b for r, b in zip(rel, (2e-3, 2e-3, 5e-3, 5e-3))):
        raise AssertionError(f"{what}: off the Euler-Bernoulli series")


def check_beck(spectra) -> None:
    lo, hi = spectra
    print(f"    Beck: P=19.5 max |Im| {np.max(np.abs(lo.imag)):.3e}, min Re {np.min(lo.real):.4f}; "
          f"P=21 max |Im| {np.max(np.abs(hi.imag)):.4f} (> 10), min Re {np.min(hi.real):.4f}")
    if not (np.max(np.abs(lo.imag)) < 1e-6 * np.max(np.abs(lo.real)) and np.min(lo.real) > 0
            and np.max(np.abs(hi.imag)) > 10.0 and np.min(hi.real) > 0):
        raise AssertionError("Beck column: outside tests/test_dynamics.py:893-917")


def check_floquet(out) -> None:
    poles, mus = out
    expected = np.exp(poles * FLOQUET_PERIOD)
    gap = max(float(np.min(np.abs(a[:, None] - b[None, :]) / (1e-8 + np.abs(a)[:, None]), axis=1)
                    .max()) for a, b in ((mus, expected), (expected, mus)))
    print(f"    Floquet: max |mu| {np.abs(mus).max():.6f} (< 1); worst relative gap to "
          f"exp(lambda T) {gap:.3e} (bound 2e-4)")
    if not (mus.shape == expected.shape and gap < 2e-4 and np.abs(mus).max() < 1.0):
        raise AssertionError("Floquet: outside tests/test_floquet.py:14-36")


def check_euler(p) -> None:
    rel = abs(p / (np.pi ** 2 / 4.0) - 1.0)
    print(f"    critical_load dead load: {p:.6f} against pi^2/4, relative gap {rel:.3e} "
          "(bound 1e-2)")
    if not rel < 1e-2:
        raise AssertionError("critical_load: outside tests/test_dynamics.py:942-953")


def check_drift(what: str, tr, bound: float) -> None:
    e = tr.energies
    drift = float(((e[-1] - e[0]) / e[0]).abs().max())
    print(f"    {what}: finite {bool(torch.isfinite(e).all())}, worst relative energy drift "
          f"{drift:.3e} (bound {bound:.0e})")
    if not (bool(torch.isfinite(e).all()) and drift < bound):
        raise AssertionError(f"{what}: outside tests/test_segment_dynamics.py's gate")


def newton_iterates(fn):
    """``(fn(), the Newton iterates of simulate_implicit in it)``: its steps
    go through ``cosserat._newton_step``, counted here."""
    count = [0]
    newton_step = cosserat._newton_step

    def counted(jac, res):
        count[0] += 1
        return newton_step(jac, res)

    cosserat._newton_step = counted
    try:
        return fn(), count[0]
    finally:
        cosserat._newton_step = newton_step


def check_rest_syncs(inp) -> None:
    """Newmark: one host sync per Newton convergence test (each iterate's
    and each step's first), none else per step; simulate_scene: none per
    step.  One step against three under torch's sync debug mode."""
    qe = inp["qe"]

    def newmark(steps):
        return host_syncs(lambda: newton_iterates(lambda: dynamics.simulate_implicit(
            qe, torch.zeros_like(qe), DYN_CFG, dt=NM_DT, steps=steps, tol=NM_TOL)))

    (_, it1), syncs1 = newmark(1)
    (_, it3), syncs3 = newmark(3)
    print(f"    Newmark B={B_NM}: host syncs {syncs1} in 1 step ({it1} Newton iterates), {syncs3} "
          f"in 3 ({it3}); expected {syncs1} + {it3 - it1} + 2")
    if syncs3 - syncs1 != (it3 - it1) + 2:
        raise AssertionError("Newmark: host syncs other than one per Newton test")

    def scene(steps):
        return host_syncs(lambda: dynamics.simulate_scene(
            inp["scene"], torch.zeros_like(inp["scene"]), DYN_CFG, SCENE_RR,
            inp["base"].cpu().numpy(), dt=SCENE_DT, steps=steps))[1]

    once, thrice = scene(1), scene(3)
    print(f"    simulate_scene R={R_SCENE}, bases as host data: host syncs {once} in 1 step, "
          f"{thrice} in 3")
    if once != thrice:
        raise AssertionError("simulate_scene: a host sync per step")


def phase_rest_of_dynamics(dev, card: str, launches: dict) -> None:
    """Phase 4d: each call with the launch counts set to 0 around it (0
    expected: no kernel on these paths), its gates, its time (CUDA events:
    a call over 10 s is timed once, as its gated call, to keep the phase
    near its budget; a shorter one by the median of 3 after the gated call
    as warm-up), the host-sync counts, each Jacobian's two modes, and a
    profiler breakdown of four calls at a few steps."""
    inp = rest_inputs(dev)
    for what, (fn, check) in rest_calls(inp).items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out, counts = counted(what, fn, ())
        end.record()
        end.synchronize()
        add_counts(launches, counts)
        check(out)
        ms, how = start.elapsed_time(end), "the gated call, timed once"
        if ms <= 10e3:
            ms, how = cuda_time_ms(fn, warmup=0, reps=3), "median of 3 after the gated call"
        print(f"    {what}: {ms:.4f} ms per call ({how}; launches {counts or 0}) [{card}]")
    check_rest_syncs(inp)
    jacobian_modes(inp, card)
    qe, seg = inp["qe"], inp["seg"]
    profiled = {
        f"Newmark B={B_NM} 2 steps": lambda: dynamics.simulate_implicit(
            qe, torch.zeros_like(qe), DYN_CFG, dt=NM_DT, steps=2, tol=NM_TOL),
        f"simulate_scene R={R_SCENE} 2 steps": lambda: dynamics.simulate_scene(
            inp["scene"], torch.zeros_like(inp["scene"]), DYN_CFG, SCENE_RR, inp["base"],
            dt=SCENE_DT, steps=2),
        f"segmented RK4 B={B_SEG_DYN} 2 steps": lambda: dynamics.simulate(
            seg, torch.zeros_like(seg), SEG_CFG, dt=SEG_DT, steps=2),
        "critical_load Euler": lambda: dynamics.critical_load(
            EULER_CFG, direction=torch.tensor([-1.0, 0.0, 0.0], dtype=torch.float64, device=dev),
            load_hi=5.0, bisect_tol=0.02),
    }
    for what, fn in profiled.items():
        prof = device_breakdown(fn, warmup=0, reps=1)
        print(f"  profile {what}: host {prof['host_ms']:.4f} ms per call, device busy "
              f"{prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, {prof['events']:.0f} "
              f"device events per call [{card}]")
        for name, ms, count in prof["top"][:4]:
            print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


def jacobian_modes(inp, card: str) -> None:
    """Each Jacobian of this layer two ways, the same matrix: the Newmark
    step's per-sample Jacobian at B=2048 by forward-mode columns
    (``cosserat._per_sample_jacobian``, what ``simulate_implicit`` runs) and
    by reverse-mode rows; the monodromy over 3 RK4 steps by
    ``torch.func.jacrev`` (what ``floquet_multipliers`` runs) and by
    ``jacfwd``."""
    qe = inp["qe"]
    a0 = dynamics.accelerations(qe, torch.zeros_like(qe), DYN_CFG)
    inv = 1.0 / (0.25 * NM_DT * NM_DT)

    def residual(q1):
        a1 = (q1 - qe) * inv - a0
        v1 = 0.5 * NM_DT * (a0 + a1)
        m, rhs = dynamics._mass_and_rhs(q1, v1, DYN_CFG)
        return torch.einsum("...ij,...j->...i", m, a1) - rhs

    def rows(q):
        _, pull = torch.func.vjp(residual, q)
        eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
        return torch.movedim(torch.func.vmap(lambda e: pull(e.expand(q.shape))[0])(eye), 0, -2)

    nq = FLOQUET_CFG.nq

    def flow(z):
        traj = dynamics.simulate(z[:nq], z[nq:], FLOQUET_CFG, dt=0.25 / 95, steps=3,
                                 record_energy=False)
        return torch.cat([traj.qes[-1], traj.qds[-1]])

    z0 = torch.zeros(2 * nq, dtype=torch.float64, device=qe.device)
    for what, (port, other) in {
            f"Newmark Jacobian B={B_NM}": (lambda: cosserat._per_sample_jacobian(residual, qe),
                                           lambda: rows(qe)),
            "monodromy n=8 ne=2, 3 RK4 steps": (lambda: torch.func.jacrev(flow)(z0),
                                                lambda: torch.func.jacfwd(flow)(z0))}.items():
        a, b = port(), other()
        gap = float((a - b).abs().max() / b.abs().max())
        ms_port, ms_other = (cuda_time_ms(f, warmup=0, reps=3) for f in (port, other))
        modes = ("forward columns", "reverse rows") if "Newmark" in what else ("jacrev", "jacfwd")
        print(f"    {what}: {modes[0]} (the port's) {ms_port:.4f} ms, {modes[1]} "
              f"{ms_other:.4f} ms, relative gap {gap:.3e} [{card}]")
        if not gap < 1e-10:
            raise AssertionError(f"{what}: the two modes disagree")


# Phase 4e, the inverse and constrained layers, at the main path's width N=16
# (the platforms at the JAX tests' n=12, na=6), f64 unless stated.  The gates
# are the JAX tests', cited per constant.
SENSE = dict(measure=131072, fit=4096, cov=4096, load=256, filters=256, tip=1024,
             wrenches=64, ik=16, control=64, train=4096)
SENSE_CFG = sensing.SensingConfig(use_tip_quaternion=True)         # markers 1/4 .. 1
FIT_CFG = sensing.SensingConfig(marker_fracs=(), pose_fracs=(1 / 3, 2 / 3, 1.0))
FIT_TOL, FIT_QE, FIT_RES = 1e-12, 1e-8, 1e-10             # tests/test_sensing.py:109-123
LOAD_CFG = sensing.SensingConfig(marker_fracs=(0.5, 1.0))  # tests/test_sensing.py:216-233
LOAD_TOL = 1e-5
EKF_STEPS, EKF_TAIL = 16, 6       # tests/test_estimation.py:45-71 runs 30, tail from 10
EKF_CFG = estimation.FilterConfig(
    dynamics=dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
        rod=rod.RodConfig(n=16, ne=2)), rho_a=1.0, rho_i=1e-2),
    sensing=sensing.SensingConfig(rod=rod.RodConfig(n=16, ne=2), marker_fracs=(),
                                  pose_fracs=(0.5, 1.0)),
    dt=0.01, q_accel=1e-10, r_sigma=1e-3)
TIP_CFG = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16, ne=4)))
TIP_TOL = 1e-10                                         # tests/test_constrained.py:89-105
QV = (float(np.sqrt(0.5)), 0.0, -float(np.sqrt(0.5)), 0.0)        # local e1 -> world z
HEX_BASES = tuple((0.3 * np.cos(a), 0.3 * np.sin(a), 0.0) for a in np.arange(6) * np.pi / 3)
HEX_EA = 100.0
HEXAPOD = constrained.PlatformRobot(
    cfg=dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
        rod=rod.RodConfig(n=12, ne=3, na=6), stiffness=(1.0, 1.0, 1.0, HEX_EA, 50.0, 50.0))),
    base_positions=HEX_BASES, base_quaternions=(QV,) * 6, attach_points=HEX_BASES)
PORTAL_BASES = ((-0.25, 0.0, 0.0), (0.25, 0.0, 0.0))      # tests/test_constrained.py:251-278
PORTAL = constrained.PlatformRobot(
    cfg=dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
        rod=rod.RodConfig(n=12, ne=4, na=6), stiffness=(1.0, 1.0, 50.0, 1e6, 1e4, 1e4))),
    base_positions=PORTAL_BASES, base_quaternions=(QV,) * 2, attach_points=PORTAL_BASES)
IK_BASES = tuple((0.25 * np.cos(a), 0.25 * np.sin(a), 0.0) for a in np.arange(3) * 2 * np.pi / 3)
IK_ROBOT = constrained.PlatformRobot(                   # tests/test_constrained.py:281-300
    cfg=dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
        rod=rod.RodConfig(n=12, ne=2, na=6), stiffness=(1.0, 1.0, 1.0, 100.0, 50.0, 50.0)),
        tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.04)),)),
    base_positions=IK_BASES, base_quaternions=(QV,) * 3, attach_points=IK_BASES)
CONTROL_CFG = dynamics.DynamicsConfig(                  # tests/test_control.py:16-24 at n=16
    statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16, ne=2)), rho_a=1.0, rho_i=1e-2,
    damping=0.4, tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.06)),
                          tendon.Tendon(offset=(0.0, 0.0, -0.06))))
CONTROL_STEPS, CONTROL_ITERATIONS = 10, 5
TRAIN_STEPS = 20


def sense_inputs(dev, sizes=SENSE):
    """Phase 4e's inputs: sensing strains 0.8 N(0,1) (the headline's, seed
    0), fit strains 0.6 N(0,1) (tests/test_sensing.py:155, seed 3), tip
    loads 0.15 N(0,1) (:222, seed 11), filter priors about the test's state
    (tests/test_estimation.py:34-41, seed 7), pin targets about the batched
    test's three (tests/test_constrained.py:95-97, seed 9), platform
    wrenches (seed 10; wrench 0 the uniform compression), IK tensions U(0,
    1) (seed 12), control strains 0.05 N(0,1) (seed 13), calibration
    features N(0,1) with targets from a hidden decoder (seed 14)."""
    def t(a, dtype=torch.float64):
        return torch.tensor(a, dtype=dtype, device=dev)

    nq_f = EKF_CFG.nq
    x0_mean = np.zeros(2 * nq_f)
    x0_mean[2], x0_mean[nq_f + 3] = 0.4, 0.3
    rng = np.random.default_rng(7)
    x0_true = x0_mean + 1e-2 * rng.standard_normal((sizes["filters"], 2 * nq_f))
    rng = np.random.default_rng(9)
    tips = np.stack([rng.uniform(0.93, 0.97, sizes["tip"]), rng.uniform(-0.08, 0.05, sizes["tip"]),
                     rng.uniform(0.06, 0.18, sizes["tip"])], axis=-1)
    rng = np.random.default_rng(10)
    wrench = np.concatenate([0.1 * rng.standard_normal((sizes["wrenches"], 3)) - [0, 0, 0.3],
                             0.02 * rng.standard_normal((sizes["wrenches"], 3))], axis=-1)
    wrench[0] = [0.0, 0.0, -0.6, 0.0, 0.0, 0.0]
    rng = np.random.default_rng(14)
    feats = rng.standard_normal((sizes["train"], 8))
    w_true = 0.2 * rng.standard_normal((8, 9))
    sense = 0.8 * np.random.default_rng(0).standard_normal((sizes["measure"], 9))
    return dict(
        sense=t(sense), fit=t(0.6 * np.random.default_rng(3).standard_normal((sizes["fit"], 9))),
        loads=t(0.15 * np.random.default_rng(11).standard_normal((sizes["load"], 3))),
        x0_mean=t(x0_mean), x0_true=t(x0_true),
        noise=torch.Generator(device=dev).manual_seed(7), tips=t(tips), wrench=t(wrench),
        ik_tension=t(np.random.default_rng(12).uniform(0.0, 1.0, (sizes["ik"], 3, 1))),
        control=t(0.05 * np.random.default_rng(13).standard_normal((sizes["control"], 6))),
        feats=t(feats, torch.float32),
        train_targets=rod.rod_shape(t(feats @ w_true, torch.float32), method="picard").tip_position)


def sense_calls(inp, sizes=SENSE):
    """Each call of phase 4e: (callable, kernels it must launch, its check)."""
    dev = inp["sense"].device
    b_fit, b_load = sizes["fit"], sizes["load"]
    y_fit = sensing.measure(inp["fit"], FIT_CFG)
    sc = cosserat.StaticsConfig(rod=LOAD_CFG.rod)
    qe_star = cosserat.solve_statics(inp["loads"], torch.zeros_like(inp["loads"]), sc,
                                     tol=1e-12).qe
    y_load = sensing.measure(qe_star, LOAD_CFG)
    truth = estimation.simulate_measurements(inp["x0_true"][:, :EKF_CFG.nq],
                                             inp["x0_true"][:, EKF_CFG.nq:], EKF_CFG,
                                             EKF_STEPS, inp["noise"])
    ik_fwd = constrained.solve_platform(IK_ROBOT, tension=inp["ik_tension"], tol=1e-11)
    if not bool(ik_fwd.converged.all()):
        raise AssertionError("the IK targets' forward platform solves did not converge")
    w_max = float(dynamics.natural_frequencies(CONTROL_CFG, torch.zeros(
        CONTROL_CFG.nq, dtype=torch.float64, device=dev)).max())
    control_dt = 1.0 / w_max                                    # tests/test_control.py:27-28
    control_cost = control.tip_target_cost(CONTROL_CFG, (0.0, 0.0, -0.96), velocity_weight=1e-3)
    return {
        f"measure fused N=16 B={sizes['measure']}": (
            lambda: sensing.measure(inp["sense"], dataclasses.replace(SENSE_CFG, method="fused")),
            ("K1",), lambda y: check_fused_measure(inp, y)),
        f"fit_strain pose stations B={b_fit}": (
            lambda: sensing.fit_strain(y_fit, FIT_CFG, tol=FIT_TOL, max_iter=30), (),
            lambda sol: check_fit(inp, sol)),
        f"posterior_covariance B={sizes['cov']}": (
            lambda: sensing.posterior_covariance(inp["fit"][:sizes["cov"]], FIT_CFG, 1e-5), (),
            check_covariance),
        f"identify_tip_load B={b_load}": (
            lambda: sensing.identify_tip_load(y_load, LOAD_CFG, statics=sc, tol=1e-11,
                                              max_iter=20, statics_tol=1e-11), (),
            lambda out: check_loads(inp, out)),
        f"ekf + rts_smoother N=16 B={sizes['filters']} {EKF_STEPS} steps": (
            lambda: ekf_and_smoother(inp, truth[1]), (), lambda out: check_ekf(truth[0], out)),
        f"solve_tip_constrained N=16 B={sizes['tip']}": (
            lambda: constrained.solve_tip_constrained(TIP_CFG, tip_position=inp["tips"],
                                                      tip_axes=(1, 2), tol=TIP_TOL),
            (), lambda sol: check_pinned(inp, sol)),
        f"solve_platform hexapod n=12 B={sizes['wrenches']}": (
            lambda: constrained.solve_platform(HEXAPOD, platform_force=inp["wrench"][:, :3],
                                               platform_moment=inp["wrench"][:, 3:], tol=1e-10),
            (), check_hexapod),
        f"platform_stability hexapod n=12 B={sizes['wrenches']}": (
            lambda: constrained.platform_stability(
                HEXAPOD, platform_force=inp["wrench"][:, :3],
                platform_moment=inp["wrench"][:, 3:], tol=1e-10), (), check_hexapod_stability),
        "platform_critical_load portal n=12, 9 bisection steps": (
            lambda: constrained.platform_critical_load(
                PORTAL, unit_force=(0.0, 0.0, -1.0), lam_lo=10.0, lam_hi=26.0, bisect_steps=9,
                tol=1e-9, device=dev), (), check_portal),
        f"platform_ik B={sizes['ik']}": (
            lambda: constrained.platform_ik(IK_ROBOT, target_position=ik_fwd.platform_position,
                                            gn_steps=8, tol=1e-11), (), check_ik),
        f"optimize_protocol N=16 B={sizes['control']} {CONTROL_ITERATIONS} x {CONTROL_STEPS} "
        "steps": (
            lambda: control.optimize_protocol(
                control_cost, torch.zeros((3, 2), dtype=torch.float64, device=dev), CONTROL_CFG,
                control_dt, CONTROL_STEPS, transform=dynamics._softplus, qe0=inp["control"],
                iterations=CONTROL_ITERATIONS, iters=10), (),
            lambda sol: check_control(sol, control_cost, control_dt, inp)),
        f"make_train_step B={sizes['train']} {TRAIN_STEPS} steps": (
            lambda: train(inp), (), check_train),
    }


def check_fused_measure(inp, y) -> None:
    """y finite, in the strains' dtype, within F32_TOL of the f64 picard
    measurement (tests/test_pallas_kernel.py's 'high' gate)."""
    ref = sensing.measure(inp["sense"], SENSE_CFG)
    gap = float((y - ref).abs().max())
    print(f"    fused vs f64 picard: max abs {gap:.3e} over {y.shape[0]} rods, "
          f"{y.shape[1]} numbers each (bound {F32_TOL:.0e})")
    if not (y.dtype == torch.float64 and bool(torch.isfinite(y).all()) and gap <= F32_TOL):
        raise AssertionError("fused measure: outside the f32 gate of the picard measure")


def check_fit(inp, sol) -> None:
    err = float((sol.qe - inp["fit"]).abs().max())
    res = float(sol.residual_norm.max())
    print(f"    {int(sol.iterations)} iterates; max |qe - truth| {err:.3e} (bound {FIT_QE:.0e}), "
          f"max residual {res:.3e} (bound {FIT_RES:.0e})")
    if not (err < FIT_QE and res < FIT_RES):
        raise AssertionError("fit_strain: outside tests/test_sensing.py:121-123")


def check_covariance(cov) -> None:
    sym = float((cov - cov.transpose(-1, -2)).abs().max() / cov.abs().max())
    eig = torch.linalg.eigvalsh(0.5 * (cov + cov.transpose(-1, -2)))
    print(f"    relative asymmetry {sym:.3e}; smallest eigenvalue {float(eig.min()):.3e}, "
          f"largest {float(eig.max()):.3e}")
    if not (bool(torch.isfinite(cov).all()) and sym < 1e-8 and float(eig.min()) > 0.0):
        raise AssertionError("posterior_covariance: not a symmetric positive definite matrix")


def check_loads(inp, out) -> None:
    theta, sol = out
    err = float((theta - inp["loads"]).abs().max())
    print(f"    {int(sol.iterations)} iterates; max |theta - f| {err:.3e} (bound {LOAD_TOL:.0e})")
    if not err < LOAD_TOL:
        raise AssertionError("identify_tip_load: outside tests/test_sensing.py:231-233")


def ekf_and_smoother(inp, ys):
    d = 2 * EKF_CFG.nq
    x0 = inp["x0_mean"].expand(inp["x0_true"].shape)
    res = estimation.ekf(ys, EKF_CFG, x0, 1e-4 * torch.eye(d, dtype=torch.float64,
                                                           device=x0.device))
    return res, estimation.rts_smoother(res, EKF_CFG)


def check_ekf(xs, out) -> None:
    """tests/test_estimation.py:45-71: the tail's mean NEES within (0.3, 3)
    of d and mean NIS within (0.3, 3) of m; the smoothed covariances
    symmetric and PSD (:107-120), the smoother's RMSE printed beside the
    filter's."""
    res, (xs_s, ps_s) = out
    d, m = xs.shape[-1], sensing.measurement_size(EKF_CFG.sensing)
    e, p = (res.xs - xs)[EKF_TAIL:], res.covs[EKF_TAIL:]
    nees = float(torch.einsum("sbi,sbi->sb", e, torch.linalg.solve(p, e[..., None])[..., 0])
                 .mean())
    nis = float(res.nis[EKF_TAIL:].mean())
    rmse_f = float(((res.xs - xs) ** 2).mean().sqrt())
    rmse_s = float(((xs_s - xs) ** 2).mean().sqrt())
    sym = float((ps_s - ps_s.transpose(-1, -2)).abs().max())
    low = float(torch.linalg.eigvalsh(ps_s).min())
    print(f"    mean NEES {nees:.4f} (d = {d}, gate ({0.3 * d:.1f}, {3 * d:.1f})), mean NIS "
          f"{nis:.4f} (m = {m}, gate ({0.3 * m:.1f}, {3 * m:.1f})); RMSE filter {rmse_f:.3e}, "
          f"smoother {rmse_s:.3e}; smoothed covariances asymmetry {sym:.1e}, smallest "
          f"eigenvalue {low:.1e}")
    if not (0.3 * d < nees < 3.0 * d and 0.3 * m < nis < 3.0 * m and sym < 1e-10
            and low > -1e-12):
        raise AssertionError("ekf / rts_smoother: outside tests/test_estimation.py's gates")


def check_pinned(inp, sol) -> None:
    """tests/test_constrained.py:89-105: every sample converged, the tips on
    their targets' transverse coordinates within 1e-9, and the balance
    residual with the reaction as tip load below 1e-9."""
    r = TIP_CFG.state_full(sol.qe, 16)[0]
    miss = float((r[:, 0, 1:] - inp["tips"][:, 1:]).abs().max())
    res = dynamics._balance_residual_fn(TIP_CFG, sol.reaction_force, None, 16)(sol.qe)
    bal = float(torch.linalg.vector_norm(res, dim=-1).max())
    conv = int(sol.converged.sum())
    print(f"    {int(sol.iterations)} Newton steps, {conv}/{sol.qe.shape[0]} converged; tip miss "
          f"{miss:.3e}, balance residual {bal:.3e} (bounds 1e-9)")
    if not (conv == sol.qe.shape[0] and miss < 1e-9 and bal < 1e-9):
        raise AssertionError("solve_tip_constrained: outside tests/test_constrained.py:98-105")


def check_hexapod(sol) -> None:
    """Every wrench converged; wrench 0, the uniform compression, sinks the
    platform by F L / (6 EA) with each leg carrying F/6
    (tests/test_constrained.py:136-158 with six legs)."""
    conv = int(sol.converged.sum())
    sink = float(sol.platform_position[0, 2]) - (1.0 - 0.6 / (6 * HEX_EA))
    share = float((sol.reaction_force[0, :, 2] + 0.1).abs().max())
    print(f"    {int(sol.iterations)} Newton steps, {conv}/{sol.qe.shape[0]} converged; "
          f"compression: sink off by {sink:.3e}, leg force off by {share:.3e} (bounds 1e-10)")
    if not (conv == sol.qe.shape[0] and abs(sink) < 1e-10 and share < 1e-10):
        raise AssertionError("solve_platform: outside tests/test_constrained.py:148-158")


def check_hexapod_stability(st) -> None:
    check_hexapod(st.solution)
    print(f"    eig_max from {float(st.eig_max.min()):.6f} to {float(st.eig_max.max()):.6f}; "
          f"{int(st.stable.sum())}/{st.stable.shape[0]} stable")
    if not bool(st.stable.all()):
        raise AssertionError("platform_stability: a stable hexapod load read as unstable")


def check_portal(lam) -> None:
    want = 2.0 * np.pi ** 2
    print(f"    lambda_cr {lam:.6f} against 2 pi^2 EI / L^2 = {want:.6f} (rtol 1e-2)")
    if not abs(lam - want) < 1e-2 * want:
        raise AssertionError("platform_critical_load: outside tests/test_constrained.py:277")


def check_ik(ik) -> None:
    err = float(ik.pose_error.max())
    print(f"    max pose error {err:.3e} (bound 1e-6), min tension {float(ik.tension.min()):.3e}")
    if not (err < 1e-6 and float(ik.tension.min()) >= 0.0):
        raise AssertionError("platform_ik: outside tests/test_constrained.py:298-300")


def check_control(sol, cost, dt, inp) -> None:
    """The loss falls (tests/test_control.py:111-113); mass_tier='fused'
    is refused before any rollout."""
    losses = sol.losses.cpu().numpy()
    print(f"    losses {losses.tolist()}, final gradient norm {float(sol.grad_norm):.3e}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("optimize_protocol: the loss did not fall")
    try:
        control.optimize_protocol(cost, sol.knots, CONTROL_CFG, dt, 1, qe0=inp["control"],
                                  mass_tier="fused")
    except ValueError as e:
        print(f"    mass_tier='fused' refused: {e}")
    else:
        raise AssertionError("optimize_protocol accepted mass_tier='fused'")


def train(inp):
    cfg = rod.RodConfig()
    params = calibration.init_params(8, cfg, device=inp["feats"].device)
    step, make_opt = calibration.make_train_step(cfg=cfg)
    opt = make_opt(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt, loss = step(params, opt, inp["feats"], inp["train_targets"])
        losses.append(loss)
    return torch.stack(losses)


def check_train(losses) -> None:
    losses = losses.cpu().numpy()
    print(f"    loss {losses[0]:.6e} -> {losses[-1]:.6e} over {len(losses)} Adam steps")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("make_train_step: the loss did not fall")


def phase_inverse_layers(dev, card: str, launches: dict) -> None:
    """Phase 4e: each call with the launch counts set to 0 around it (the
    fused measure: exactly one K1 and no other kernel; the rest none), its
    host syncs (torch's sync debug mode, on the gated call), its gate and
    its CUDA-event time (the gated call; a call under 3 s also by the median
    of 3 after it); a profiler breakdown of the fused measure and of three
    fit_strain iterates."""
    inp = sense_inputs(dev)
    for what, (fn, needs, check) in sense_calls(inp).items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        (out, syncs), counts = counted(what, lambda: host_syncs(fn), needs)
        end.record()
        end.synchronize()
        add_counts(launches, counts)
        if needs and counts != {k: 1 for k in needs}:
            raise AssertionError(f"{what}: launches {counts}, expected one of each of {needs}")
        check(out)
        ms, how = start.elapsed_time(end), "the gated call"
        if ms <= 3e3:
            ms, how = cuda_time_ms(fn, warmup=0, reps=3), "median of 3 after the gated call"
        print(f"    {what}: {ms:.4f} ms per call ({how}); host syncs {syncs} in the gated call; "
              f"launches {counts or 0} [{card}]")
    y = sensing.measure(inp["fit"], FIT_CFG)
    profiled = {
        f"measure fused B={SENSE['measure']}": lambda: sensing.measure(
            inp["sense"], dataclasses.replace(SENSE_CFG, method="fused")),
        f"fit_strain B={SENSE['fit']}, 3 iterates": lambda: sensing.fit_strain(
            y, FIT_CFG, tol=0.0, max_iter=3),
    }
    for what, fn in profiled.items():
        prof = device_breakdown(fn, warmup=1, reps=3)
        print(f"  profile {what}: host {prof['host_ms']:.4f} ms per call, device busy "
              f"{prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, {prof['events']:.0f} "
              f"device events per call [{card}]")
        for name, ms, count in prof["top"][:4]:
            print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


G_OVER_K = 1.0 / 1.3                                      # g = k / (1 + nu), nu = 0.3
CTR_KAPPA = float(np.sqrt(1.44 * G_OVER_K))               # every pair: c = 1.44 < (pi/2)^2
CTR_CFG = ctr.CTRConfig(tubes=(                           # tests/test_ctr.py:20-31, three tubes
    ctr.Tube(CTR_KAPPA, 2.0, 2.0 * G_OVER_K), ctr.Tube(CTR_KAPPA, 1.0, G_OVER_K),
    ctr.Tube(CTR_KAPPA, 0.5, 0.5 * G_OVER_K)), n=16)
CTR_ANGLES = 16                                           # per tube: B = 16^3 = 4096
CTR_TOL = 1e-10
CTR_CHECKED = 16                                          # samples re-solved on the CPU
EXAMPLES_FULL = ("demo", "throughput", "convergence")     # the rest run with --smoke


def ctr_pair(kappa, stiff_ratio=1.0, n=24):
    """tests/test_ctr.py's two-tube pair: tube 1 scaled by ``stiff_ratio``."""
    return ctr.CTRConfig(tubes=(ctr.Tube(kappa, stiff_ratio, stiff_ratio * G_OVER_K),
                                ctr.Tube(kappa, 1.0, G_OVER_K)), n=n)


def ctr_pair_with_c(c, n=24):
    return ctr_pair(float(np.sqrt(c * G_OVER_K)), n=n)


def ctr_workspace(dev):
    """The base angles of a CTR_ANGLES^3 grid over [-pi, pi)^3, (B, 3) f64."""
    a = np.linspace(-np.pi, np.pi, CTR_ANGLES, endpoint=False)
    return torch.tensor(np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(-1, 3),
                        device=dev)


def check_ctr_workspace(alphas, sol) -> None:
    """Every sample converged to CTR_TOL; CTR_CHECKED samples within 1e-10
    of the port's per-sample f64 solve on the CPU."""
    worst = float(sol.residual.norm(dim=-1).max())
    pick = np.linspace(0, alphas.shape[0] - 1, CTR_CHECKED).astype(int)
    err = max(float((ctr.solve_ctr(alphas[i].cpu(), CTR_CFG, tol=CTR_TOL).theta
                     - sol.theta[i].cpu()).abs().max()) for i in pick)
    print(f"    workspace B={alphas.shape[0]}: {int(sol.iterations)} Newton iterates, largest "
          f"residual norm {worst:.3e} (tol {CTR_TOL:.0e}); {CTR_CHECKED} samples vs the "
          f"per-sample CPU solve {err:.3e} (bound 1e-10)")
    if not (worst <= CTR_TOL and err <= 1e-10):
        raise AssertionError("CTR workspace: a sample did not converge or disagrees with the CPU")


def ctr_sync_counts(alphas) -> None:
    """One host sync per Newton iterate and none else per iterate: three
    iterates (tol 0) sync twice more than one, counted as phase 4c counts."""
    def solve(k):
        return ctr.solve_ctr(alphas, CTR_CFG, tol=0.0, max_iter=k)

    (_, it1), once = host_syncs(lambda: newton_iterates(lambda: solve(1)))
    (_, it3), thrice = host_syncs(lambda: newton_iterates(lambda: solve(3)))
    print(f"    solve_ctr B={alphas.shape[0]}: host syncs {once} in {it1} Newton iterate, "
          f"{thrice} in {it3}; expected {once} + {it3 - it1}")
    if (it1, it3) != (1, 3) or thrice - once != it3 - it1:
        raise AssertionError("solve_ctr: host syncs other than one per Newton iterate")


def ctr_closed_forms(dev) -> None:
    """tests/test_ctr.py's closed forms on the card, at its bounds."""
    def t(a):
        return torch.tensor(a, dtype=torch.float64, device=dev)

    cfg = ctr_pair(2.0, stiff_ratio=3.0)
    sol = ctr.solve_ctr(t([0.7, 0.7]), cfg)
    rigid = float((sol.theta - 0.7).abs().max())
    sol = ctr.solve_ctr(t([1.3, 0.1]), ctr_pair_with_c(1.44, n=20), tol=1e-13)
    mean = float((0.5 * (sol.theta[0] + sol.theta[1]) - 0.7).abs().max())
    print(f"    aligned pair twist-rigid {rigid:.3e} (bound 1e-12); mean twist {mean:.3e} "
          f"(bound 1e-11)")
    if not (rigid <= 1e-12 and mean <= 1e-11):
        raise AssertionError("CTR: aligned pair or mean twist outside tests/test_ctr.py")

    anti = t([np.pi / 2, -np.pi / 2])
    lams = {}
    for margin in (0.9, 1.1):
        cfg = ctr_pair_with_c((margin * np.pi / 2) ** 2)
        sol = ctr.solve_ctr(anti, cfg)
        lams[margin] = float(ctr.ctr_stability(sol.theta, anti, cfg))
        if not np.isclose(ctr.two_tube_snap_parameter(cfg), margin * np.pi / 2, rtol=1e-12):
            raise AssertionError("CTR: snap parameter")
    c = (1.15 * np.pi / 2) ** 2
    cfg = ctr_pair_with_c(c)
    s = chebyshev.cgl_points(24)
    branches = []
    for sign in (1.0, -1.0):
        pert = sign * np.sin(np.sqrt(c) * s)
        sol = ctr.solve_ctr(anti, cfg, theta0=t(np.stack([np.pi / 2 + pert / 2,
                                                          -np.pi / 2 - pert / 2])), tol=1e-12)
        if not float(ctr.ctr_stability(sol.theta, anti, cfg)) > 0.0:
            raise AssertionError("CTR: a post-snap branch is not stable")
        branches.append(float(sol.theta[0, 0] - sol.theta[1, 0]))
    lo, hi = sorted(branches)
    sym = abs((hi - np.pi) - (np.pi - lo)) / (hi - np.pi)
    print(f"    snap sqrt(c) L = 0.9 pi/2: lambda_min {lams[0.9]:+.4e}; 1.1 pi/2: "
          f"{lams[1.1]:+.4e}; post-snap branches pi{hi - np.pi:+.6f} and pi{lo - np.pi:+.6f}, "
          f"asymmetry {sym:.3e} (bound 1e-6)")
    if not (lams[0.9] > 0 > lams[1.1] and hi - np.pi > 0.05 and sym <= 1e-6):
        raise AssertionError("CTR: snap threshold or bistability outside tests/test_ctr.py")

    alpha, rho, ext, kap = 0.25, 0.6, 0.5, 1.5
    tel = ctr.solve_ctr_telescoping(t([alpha, alpha]), rho, ext, ctr_pair(kap, n=16),
                                    method="dense", tol=1e-12)
    a_cross_e1 = np.array([0.0, np.sin(alpha), -np.cos(alpha)])

    def arc(x):
        return (np.sin(kap * x) / kap) * np.array([1.0, 0, 0]) + (
            (1 - np.cos(kap * x)) / kap) * a_cross_e1

    axis, ang, v = np.array([0.0, np.cos(alpha), np.sin(alpha)]), kap * rho, arc(ext)
    exact = arc(rho) + (v * np.cos(ang) + np.cross(axis, v) * np.sin(ang)
                        + axis * np.dot(axis, v) * (1 - np.cos(ang)))
    err = float(np.abs(tel.tip.cpu().numpy() - exact).max())
    print(f"    telescoping two-arc closed form {err:.3e} (bound 1e-10)")
    if not err <= 1e-10:
        raise AssertionError("CTR: telescoping closed form")


def ctr_tip(cfg):
    def tip(a, length):
        theta = ctr.solve_ctr_differentiable(a, cfg, length=length, tol=1e-12)
        return ctr.ctr_shape(theta, cfg, length=length, method="dense").positions[0]

    return tip


def ctr_ift_gate(dev) -> None:
    """The implicit-function Jacobian of the tip in alphas and length, in
    reverse and forward mode, against central differences (rtol 2e-5,
    tests/test_ctr.py:236-260)."""
    tip = ctr_tip(ctr_pair_with_c(1.44, n=16))
    a = torch.tensor([0.9, -0.7], dtype=torch.float64, device=dev)
    ell, eps = torch.tensor(1.0, dtype=torch.float64, device=dev), 1e-6
    fd = torch.stack([(tip(a + eps * e, ell) - tip(a - eps * e, ell)) / (2 * eps)
                      for e in torch.eye(2, dtype=torch.float64, device=dev)]
                     + [(tip(a, ell + eps) - tip(a, ell - eps)) / (2 * eps)], dim=-1)
    for mode, jac in (("reverse", torch.func.jacrev), ("forward", torch.func.jacfwd)):
        ja, jl = jac(tip, argnums=(0, 1))(a, ell)
        j = torch.cat([ja, jl[:, None]], dim=-1)
        rel = float(((j - fd).abs() / (2e-5 * fd.abs() + 1e-8)).max())
        print(f"    IFT Jacobian ({mode}): max |J - FD| {float((j - fd).abs().max()):.3e}, "
              f"{rel:.3f} of the rtol 2e-5 / atol 1e-8 bound")
        if not rel <= 1.0:
            raise AssertionError(f"CTR: IFT Jacobian ({mode}) off the central differences")


def ctr_timings(dev, alphas, sol, card: str) -> None:
    """ms per call (CUDA events, median of 3 after one warm-up) of the
    workspace calls and of the differentiable telescoping gradient; one
    device breakdown of solve_ctr."""
    tcfg = ctr_pair(1.2, n=16)
    a2 = torch.tensor([0.8, -0.5], dtype=torch.float64, device=dev)

    def tel_grad():
        rho = torch.tensor(0.7, dtype=torch.float64, device=dev)
        return torch.func.grad(lambda r: ctr.solve_ctr_telescoping(
            a2, r, 0.4, tcfg, differentiable=True, tol=1e-12).tip[0])(rho)

    b = alphas.shape[0]
    calls = {f"solve_ctr B={b}": lambda: ctr.solve_ctr(alphas, CTR_CFG, tol=CTR_TOL),
             f"ctr_shape picard B={b}": lambda: ctr.ctr_shape(sol.theta, CTR_CFG),
             f"ctr_shape dense B={b}": lambda: ctr.ctr_shape(sol.theta, CTR_CFG, method="dense"),
             f"ctr_stability B={b}": lambda: ctr.ctr_stability(sol.theta, alphas, CTR_CFG),
             f"its Hessian alone B={b}": lambda: ctr.torsion_hessian(sol.theta, alphas, CTR_CFG),
             "telescoping d tip_x / d overlap": tel_grad}
    for what, fn in calls.items():
        _, counts = counted(what, fn, ())
        if counts:
            raise AssertionError(f"{what}: launched {counts}; the CTR layer has no kernel")
        ms = cuda_time_ms(fn, warmup=0, reps=3)
        print(f"    {what}: {ms:.4f} ms per call (median of 3) [{card}]")
    prof = device_breakdown(calls[f"solve_ctr B={b}"], warmup=0, reps=1)
    print(f"  profile solve_ctr B={b}: host {prof['host_ms']:.4f} ms, device busy "
          f"{prof['device_ms']:.4f} ms ({1 - prof['idle']:.1%} busy, idle {prof['idle']:.1%}), "
          f"{prof['events']:.0f} device events [{card}]")
    for name, ms, count in prof["top"][:4]:
        print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


def utils_on_card(dev) -> None:
    """The diagnostics of the demo strain on the card (tests/test_diagnostics.py)."""
    qe = rod.demo_qe(torch.float64, dev)
    sol = rod.rod_shape(qe, method="dense")
    cond = diagnostics.condition_number(qe)
    drift = diagnostics.quaternion_norm_drift(sol)
    res = diagnostics.solution_residual_norm(qe, sol)
    print(f"    demo strain: cond(A_NN) {cond:.4f} (~186), |q| drift {drift:.3e}, collocation "
          f"residual {res:.3e} (bounds 1e-11)")
    if not (abs(cond / 186 - 1) < 0.2 and drift < 1e-11 and res < 1e-11):
        raise AssertionError("diagnostics of the demo solve outside tests/test_diagnostics.py")


def run_examples(launches: dict, card: str) -> None:
    """Each example's main() on the card: demo, throughput and convergence at
    full size, the others with --smoke; results saved under a temporary
    directory in the checkout.  The demo's tip against the golden values;
    throughput must launch K1 and K3."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        saved, tempfile.tempdir = tempfile.tempdir, tmp
        try:
            for name in examples.EXAMPLES:
                argv = ["--device", "cuda"] + ([] if name in EXAMPLES_FULL else ["--smoke"])
                module = importlib.import_module(f"{PKG}.examples.{name}")
                buf = io.StringIO()

                def run(module=module, argv=argv, buf=buf):
                    with contextlib.redirect_stdout(buf):
                        return module.main(argv)

                t0 = time.perf_counter()
                out, counts = counted(f"example {name}", run,
                                      ("K1", "K3") if name == "throughput" else ())
                seconds = time.perf_counter() - t0
                add_counts(launches, counts)
                lines = buf.getvalue().strip().splitlines()
                if not (lines and out):
                    raise AssertionError(f"example {name}: no output")
                print(f"  example {name} {' '.join(argv)}: {seconds:.1f} s, launches "
                      f"{counts or 0} [{card}]")
                for line in lines[-4:] if name != "throughput" else lines:
                    print(f"    | {line}")
                if name == "demo":
                    dq = float(np.abs(out["tip_quaternion"] - np.asarray(GOLDEN_Q)).max())
                    dr = float(np.abs(out["tip_position"] - np.asarray(GOLDEN_R)).max())
                    if not (dq <= GOLDEN_TOL and dr <= GOLDEN_TOL):
                        raise AssertionError(f"example demo: tip off the golden values "
                                             f"({dq:.2e}, {dr:.2e})")
        finally:
            tempfile.tempdir = saved


def phase_ctr_utils_examples(dev, card: str, launches: dict) -> None:
    """Phase 4f: the three-tube workspace (B=4096, its gates, host syncs and
    0 launches), the closed forms and the IFT Jacobian of tests/test_ctr.py
    on the card, each CTR call timed, the diagnostics on the card, and the
    thirteen examples."""
    alphas = ctr_workspace(dev)
    (sol, syncs), counts = counted(f"solve_ctr workspace B={alphas.shape[0]}",
                                   lambda: host_syncs(lambda: ctr.solve_ctr(alphas, CTR_CFG,
                                                                            tol=CTR_TOL)), ())
    if counts:
        raise AssertionError(f"solve_ctr launched {counts}; the CTR layer has no kernel")
    print(f"    host syncs in the gated call: {syncs} (the first call of the phase: the "
          f"cached constants' copies to the card included)")
    check_ctr_workspace(alphas, sol)
    ctr_sync_counts(alphas)
    ctr_closed_forms(dev)
    ctr_ift_gate(dev)
    ctr_timings(dev, alphas, sol, card)
    utils_on_card(dev)
    run_examples(launches, card)


# Phase 4g, multi-device rod batches (parallel/mesh.py) at the main path's
# width N=16, na=3, ne=3: every visible card (make_mesh()), and the first
# card repeated 8 times (the JAX tests' 8-way mesh).  The Riks walk and the
# segmented Newton at phase 4b's and phase 4's batches divided by 8.
B_SHARD_STATICS, B_SHARD_RK4, RK4_SHARD_STEPS = 16384, 2048, 5
B_SHARD_RIKS, B_SHARD_SEG = B_RIKS // 8, B_SEG_NEWTON // 8
SIM_RTOL, SIM_ATOL, ENERGY_RTOL = 2e-5, 2e-6, 2e-4    # tests/test_parallel.py:189-193


def shard_call_ms(mesh, fn):
    """``(fn(), whole-call ms)``: CUDA events recorded on every card of the
    mesh just before and after the call; the call's ms is the largest
    card's."""
    cards = sorted(set(mesh.devices), key=str)
    marks = {d: (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for d in cards}
    for d in cards:
        marks[d][0].record(torch.cuda.current_stream(d))
    out = fn()
    for d in cards:
        marks[d][1].record(torch.cuda.current_stream(d))
    for d in cards:
        marks[d][1].synchronize()
    return out, max(start.elapsed_time(end) for start, end in marks.values())


def sharded(what: str, mesh, fn, needs: tuple, per_shard: dict | None = None) -> tuple:
    """One sharded call with the launch counts set to 0 around it: its
    per-shard launches (each kernel in ``needs`` launched on every shard,
    exactly ``per_shard[k]`` times where given) and whole-call ms.
    Returns (result, counts, ms)."""
    (out, ms), counts = counted(f"{what} [{mesh.size} shards]",
                                lambda: shard_call_ms(mesh, fn), needs)
    by_wrapper = {spec["wrapper"].__name__: k for k, spec in KERNELS.items()}
    shards = [{by_wrapper[w]: n for w, n in tally.items()} for tally in mesh.shard_launches]
    print(f"    launches per shard: {shards}; whole call {ms:.4f} ms")
    for k in needs:
        if any(s.get(k, 0) < 1 for s in shards):
            raise AssertionError(f"{what}: {k} was not launched on every shard")
    for k, n in (per_shard or {}).items():
        if any(s.get(k, 0) != n for s in shards):
            raise AssertionError(f"{what}: expected {n} {k} launches on every shard")
    return out, counts, ms


def mesh_inputs(dev):
    """The main path's N=16 strains (B=131072, 0.8 N(0,1), seed 0), the
    statics loads, the RK4 strains, the Riks rays, the CTR workspace."""
    qe = torch.tensor(0.8 * np.random.default_rng(0).standard_normal((B_REAL, 9)), device=dev)
    hi, lo = dd.split_f64(qe)
    return dict(hi=hi, lo=lo, loads=statics_loads(dev), qe_dyn=rk4_strains(dev),
                rays=load_rays(dev)[:B_SHARD_RIKS], alphas=ctr_workspace(dev))


def mesh_references(inp) -> dict:
    """The unsharded calls the sharded ones are held to (their launches do
    not count)."""
    q_hi, q_lo, r_hi, r_lo = rfk.rod_shape_refined_kernel(inp["hi"])
    return dict(
        fused=rk.rod_shape_fused(inp["hi"]),
        refined=(q_hi + q_lo, r_hi + r_lo),
        statics=cosserat.solve_statics_batched(inp["loads"], cfg=S16, **STATICS),
        rk4=dynamics.simulate(inp["qe_dyn"], torch.zeros_like(inp["qe_dyn"]), DYN_CFG, dt=DYN_DT,
                              steps=RK4_SHARD_STEPS, iters=DYN_ITERS, mass_tier="fused"),
        ctr=ctr.solve_ctr(inp["alphas"], CTR_CFG, tol=CTR_TOL),
        riks=cosserat.arc_length_continuation_batched(inp["rays"], cfg=S16, **RIKS),
        segmented=segment_statics.solve_segmented_statics_batched(
            inp["loads"][:B_SHARD_SEG], cfg=SEG_STATICS, **SEG_NEWTON))


def mesh_calls(mesh, inp) -> dict:
    """Each sharded entry point of the phase as one call: key -> (label,
    callable, kernels it must launch on every shard, exact launches per
    shard or None)."""
    qd0 = torch.zeros_like(inp["qe_dyn"])
    per_stage = 4 * RK4_SHARD_STEPS
    return {
        "fused": (f"sharded_rod_shape fused B={B_REAL}", lambda: parallel_mesh.sharded_rod_shape(
            mesh, method="fused")(inp["hi"]), ("K1",), {"K1": 1}),
        "refined": (f"sharded_rod_shape refined B={B_REAL}",
                    lambda: parallel_mesh.sharded_rod_shape(mesh, method="refined")(inp["hi"]),
                    ("K3",), {"K3": 1}),
        "statics": (f"sharded_solve_statics B={B_SHARD_STATICS}",
                    lambda: parallel_mesh.sharded_solve_statics(mesh, cfg=S16, **STATICS)(
                        inp["loads"]), ("K1", "K2"), None),
        "rk4": (f"sharded_simulate RK4 fused B={B_SHARD_RK4} {RK4_SHARD_STEPS} steps",
                lambda: parallel_mesh.sharded_simulate(
                    mesh, DYN_CFG, dt=DYN_DT, steps=RK4_SHARD_STEPS, iters=DYN_ITERS,
                    mass_tier="fused")(inp["qe_dyn"], qd0),
                ("K1", "K2"), {"K1": per_stage, "K2": per_stage}),
        "ctr": (f"sharded_ctr_workspace B={inp['alphas'].shape[0]}",
                lambda: parallel_mesh.sharded_ctr_workspace(mesh, CTR_CFG, tol=CTR_TOL)(
                    inp["alphas"]), (), None),
        "riks": (f"sharded_riks_walk B={B_SHARD_RIKS}",
                 lambda: parallel_mesh.sharded_riks_walk(mesh, cfg=S16, **RIKS)(inp["rays"]),
                 ("K1", "K2"), None),
        "segmented": (f"sharded_segmented_statics B={B_SHARD_SEG}",
                      lambda: parallel_mesh.sharded_segmented_statics(
                          mesh, cfg=SEG_STATICS, **SEG_NEWTON)(inp["loads"][:B_SHARD_SEG]),
                      ("K4", "K2"), None),
    }


def check_close(what: str, got, ref, atol: float, rtol: float = 0.0) -> None:
    diff = (got.double() - ref.double()).abs()
    print(f"    {what}: max |sharded - unsharded| {float(diff.max()):.3e} (atol {atol:.0e}, "
          f"rtol {rtol:.0e})")
    if not bool((diff <= atol + rtol * ref.double().abs()).all()):
        raise AssertionError(f"{what}: outside atol {atol:.0e} + rtol {rtol:.0e} of the "
                             "unsharded call")


def check_mesh_results(out: dict, refs: dict, mesh) -> None:
    """Each sharded result against its unsharded call: K1 and K3 exactly,
    the Newtons and walks at the JAX tests' gates, the CTR workspace to
    1e-10 with every sample converged; every field sharded over the mesh."""
    for key, res in out.items():
        for f in res:
            if isinstance(f, parallel_mesh.ShardedBatch) and len(f.shards) != mesh.size:
                raise AssertionError(f"{key}: a field has {len(f.shards)} shards, not {mesh.size}")
    for key in ("fused", "refined"):
        (q, r), ref = out[key], refs[key]
        err = max(max_abs(q.gather(), ref[0]), max_abs(r.gather(), ref[1]))
        print(f"    {key}: max |sharded - unsharded| {err:.3e} (K1 and K3 per rod do not "
              "depend on the batch: must be 0)")
        if err != 0.0:
            raise AssertionError(f"sharded_rod_shape {key}: differs from the unsharded call")
    for key in ("statics", "riks", "segmented"):
        if not bool(out[key].converged.gather().all()):
            raise AssertionError(f"{key}: a sample did not converge")
    print(f"    statics: Newton steps per shard "
          f"{[int(s[0]) for s in out['statics'].iterations.shards]}, unsharded "
          f"{int(refs['statics'].iterations)}")
    check_close("statics qe", out["statics"].qe.gather(), refs["statics"].qe, QE_TOL)
    check_close("RK4 qes", out["rk4"].qes.gather(), refs["rk4"].qes, SIM_ATOL, SIM_RTOL)
    check_close("RK4 energies", out["rk4"].energies.gather(), refs["rk4"].energies, 0.0,
                ENERGY_RTOL)
    theta, _, _, rnorm = out["ctr"]
    worst = float(rnorm.gather().max())
    print(f"    CTR: largest residual norm {worst:.3e} (tol {CTR_TOL:.0e})")
    if not worst <= CTR_TOL:
        raise AssertionError("sharded_ctr_workspace: a sample did not converge")
    check_close("CTR theta", theta.gather(), refs["ctr"].theta, 1e-10)
    check_close("Riks lambdas", out["riks"].lambdas.gather(), refs["riks"].lambdas, QE_TOL)
    check_close("Riks qes", out["riks"].qes.gather(), refs["riks"].qes, QE_TOL)
    check_close("segmented qe", out["segmented"].qe.gather(), refs["segmented"].qe, QE_TOL)


def phase_multi_device(dev, card: str, launches: dict) -> dict:
    """Phase 4g: every sharded entry point of the main path on make_mesh()
    (every visible card) and on the first card repeated 8 times, each held
    to its unsharded call, its launches per shard counted and its whole
    call timed; 1 shard against 8 for statics, RK4 and CTR with the
    device-busy share (a profiled call).  Returns {mesh: {key: ms}}."""
    inp = mesh_inputs(dev)
    refs = mesh_references(inp)
    torch.cuda.synchronize()
    meshes = {"make_mesh()": parallel_mesh.make_mesh(),
              f"{dev} x 8": parallel_mesh.make_mesh(devices=[dev] * 8)}
    if meshes["make_mesh()"].size > 1:       # the 1-shard baseline beside every card
        meshes = {str(dev): parallel_mesh.make_mesh(devices=[dev]), **meshes}
    timings, busy = {}, {}
    for label, mesh in meshes.items():
        with mesh:
            print(f"  mesh {label}: {mesh.size} shards on {sorted({str(d) for d in mesh.devices})}")
            out, timings[label] = {}, {}
            calls = mesh_calls(mesh, inp)
            if len(set(mesh.devices)) > 1:       # the other cards' first calls set them up
                for _, fn, _, _ in calls.values():
                    fn()
                for d in set(mesh.devices):
                    torch.cuda.synchronize(d)
            for key, (what, fn, needs, per_shard) in calls.items():
                out[key], counts, timings[label][key] = sharded(what, mesh, fn, needs, per_shard)
                add_counts(launches, counts)
            check_mesh_results(out, refs, mesh)
            del out
            for key in ("statics", "rk4", "ctr"):
                prof = device_breakdown(calls[key][1], warmup=0, reps=1)
                busy[label, key] = prof["device_ms"] / prof["host_ms"] / len(set(mesh.devices))
                print(f"    profile {calls[key][0]} [{mesh.size} shards]: host "
                      f"{prof['host_ms']:.4f} ms, device busy {prof['device_ms']:.4f} ms "
                      f"({busy[label, key]:.1%} per card), {prof['events']:.0f} device events "
                      f"[{card}]")
            torch.cuda.empty_cache()
    one, *others = meshes
    for key in ("statics", "rk4", "ctr"):
        base = timings[one][key]
        for label in others:
            m = meshes[label]
            print(f"  {key}: 1 shard {base:.4f} ms (device busy {busy[one, key]:.1%}); "
                  f"{m.size} shards on {len(set(m.devices))} card(s) {timings[label][key]:.4f} ms "
                  f"(busy {busy[label, key]:.1%} per card): {timings[label][key] / base:.2f}x "
                  f"[{card}]")
    return timings


def bound(mat_fma: float, f32_fma: float, f64_fma: float, nbytes: float) -> dict:
    """Least ms on the card and what bounds it: operations at the published
    peaks (an FMA is 2 FLOP) against bytes at the HBM rate.  ``mat_fma`` are
    the f32 matrix products' FMAs (G or Dn against a panel), ``f32_fma`` the
    other f32 ones: ``bound_ms`` takes both at the FP32 peak, ``bound_tc_ms``
    the matrix products as 3xTF32 on the tensor cores."""
    t_mem = nbytes / HBM_RATE
    t_f64 = 2 * f64_fma / F64_PEAK
    t_ops = 2 * (mat_fma + f32_fma) / F32_PEAK + t_f64
    t_tc = 2 * mat_fma / TF32X3_PEAK + 2 * f32_fma / F32_PEAK + t_f64
    return dict(bound_ms=max(t_ops, t_mem) * 1e3,
                bound_by="operations" if t_ops >= t_mem else "bytes",
                bound_tc_ms=max(t_tc, t_mem) * 1e3)


def picard_fma(n1: int, iters: int) -> tuple:
    """(matrix, other) FP32 FMAs of ``iters`` Picard steps for one rod: G
    (4 columns), and the 12-FMA A(K/2) action per point."""
    return iters * 4 * n1 * n1, iters * 12 * n1


def k1_bound(b, n1, na, ne, iters):
    mat, other = picard_fma(n1, iters)
    return bound(b * (mat + 3 * n1 * n1), b * (na * ne * n1 + other), 0,
                 4 * b * (na * ne + 7 * n1))


def k2_bound(b, n1, nq, ne, iters):
    mat, other = picard_fma(n1, iters)
    return bound(b * (mat + 4 * n1 * n1), b * (3 * ne * n1 + other), 0, 4 * b * (nq + 8 * n1))


def k3_bound(b, n1, na, ne, iters, corr_iters):
    mat, other = picard_fma(n1, iters + corr_iters)
    f64 = b * (na * ne * n1 + 4 * n1 * n1 + 12 * n1 + 3 * n1 * n1)
    return bound(b * (mat + 4 * n1 * n1), b * other, f64, 4 * b * (2 * na * ne + 14 * n1))


def k4_bound(b, n1, na, ne, iters):
    """K1's work plus the boundary outer products gvec ⊗ q0 and gvec ⊗ r0,
    and 7 more floats in per rod."""
    mat, other = picard_fma(n1, iters)
    return bound(b * (mat + 3 * n1 * n1), b * (na * ne * n1 + other + 7 * n1), 0,
                 4 * b * (na * ne + 7 + 7 * n1))


def k5_bound(b, n1, na, ne, iters, corr_iters):
    """K3's work plus the outer products gvec32 ⊗ q0_hi (FP32), dn_in ⊗ q0
    and gvec64 ⊗ r0 (FP64), and the boundary pairs (14 floats) in per rod."""
    mat, other = picard_fma(n1, iters + corr_iters)
    f64 = b * (na * ne * n1 + 4 * n1 * n1 + 12 * n1 + 3 * n1 * n1 + 7 * n1)
    return bound(b * (mat + 4 * n1 * n1), b * (other + 4 * n1), f64,
                 4 * b * (2 * na * ne + 14 + 14 * n1))


def collocation_system(cfg: rod.RodConfig, qes: torch.Tensor, rhs: torch.Tensor):
    """K2's systems assembled for one library call: ``(I ⊗ Dn_NN - 1/2 A_hat)``
    ``(B, 4(n-1), 4(n-1))`` and the component-major right-hand side."""
    k = rod.curvature_at_points(cfg, qes)[..., :3]          # f32, as the kernel's
    a = coll.collocation_matrix(cfg.grid(qes.device), 0.5 * lie.quat_skew(k))
    return a, coll.to_component_major(rhs).unsqueeze(-1)


def print_bounds(what: str, ms: float, b: dict) -> None:
    print(f"  {what}: bound {b['bound_ms']:.4f} ms ({b['bound_by']}), kernel at "
          f"{b['bound_ms'] / ms:.1%} of it; tensor-core bound {b['bound_tc_ms']:.4f} ms, "
          f"kernel at {b['bound_tc_ms'] / ms:.1%} of it")


def timed(card: str, what: str, kernel, plain, batch: int, warmup: int = 3,
          reps: int = 10) -> tuple:
    """plain, kernel, kernel, plain: both sides see the same card state."""
    p1 = cuda_time_ms(plain, warmup=warmup, reps=reps)
    k1 = cuda_time_ms(kernel, warmup=warmup, reps=reps)
    k2 = cuda_time_ms(kernel, warmup=warmup, reps=reps)
    p2 = cuda_time_ms(plain, warmup=warmup, reps=reps)
    k, p = min(k1, k2), min(p1, p2)
    print(f"  {what}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms -> "
          f"{batch / k * 1e3:.4g} vs {batch / p * 1e3:.4g} solves/s [{card}]")
    return k, p


def back_to_back_ms(fn, calls: int = 20) -> float:
    """ms per call over ``calls`` calls launched back to back: each call's
    host work overlaps the device work of the one before, so where that
    device work is the longer this is the kernel's own time.  (``timed``
    brackets single calls, host work before the launch included.)"""
    def run():
        for _ in range(calls):
            fn()
    return cuda_time_ms(run, warmup=1, reps=5) / calls


def phase_timing(dev: torch.device, card: str, errors: dict) -> dict:
    """Each kernel at the shape its main path gives it, beside its plain
    version, its bound and (K2) one library call; the N=16 headline call."""
    times = {}
    cfg = rod.RodConfig()
    rng = np.random.default_rng(1)
    hi, lo = dd.split_f64(torch.tensor(0.8 * rng.standard_normal((B_REAL, 9)), device=dev))
    rhs = torch.zeros((B_REAL, 15, 4), dtype=torch.float32, device=dev)
    rhs[..., 0] = -cfg.grid(dev).dn_in.float()   # the staged path's base solve

    base64 = torch.tensor(0.8 * np.random.default_rng(0).standard_normal((32768, 9)), device=dev)
    h64, l64 = dd.split_f64(base64)
    h256, l256 = h64[:8192].contiguous(), l64[:8192].contiguous()
    it256 = rod.auto_picard_iters((h256, l256), CFG256, tol=1e-5)
    rhs64 = torch.zeros((32768, 63, 4), dtype=torch.float32, device=dev)
    rhs64[..., 0] = -CFG64.grid(dev).dn_in.float()
    # K4/K5 at their chains' shapes: per-rod unit q0 and r0 ~ U(-1, 1)
    (q0h, q0l), (r0h, r0l) = random_inits(rng, B_REAL, dev)
    q0h64, q0l64, r0h64, r0l64 = (v[:32768] for v in (q0h, q0l, r0h, r0l))

    runs = {   # key: (kernel, plain, batch, shape note, (bound ms, bound_by), library call)
        "K1": (lambda: rk.rod_shape_fused(hi, cfg), lambda: rk.rod_shape_fused_plain(hi, cfg),
               B_REAL, "N=16 iters 20", k1_bound(B_REAL, 15, 3, 3, 20), None),
        "K2": (lambda: rk.picard_correction_fused(hi, rhs, cfg),
               lambda: rk.picard_correction_plain(hi, rhs, cfg), B_REAL, "N=16 iters 20",
               k2_bound(B_REAL, 15, 9, 3, 20), (cfg, hi, rhs)),
        "K3": (lambda: rfk.rod_shape_refined_kernel(hi, lo, cfg),
               lambda: rfk.rod_shape_refined_plain(hi, lo, cfg), B_REAL, "N=16 iters 20/20",
               k3_bound(B_REAL, 15, 3, 3, 20, 20), None),
        "K1w": (lambda: rk.rod_shape_fused(h64, CFG64, iters=24),
                lambda: rk.rod_shape_fused_plain(h64, CFG64, iters=24), 32768,
                "n=64 iters 24", k1_bound(32768, 63, 3, 3, 24), None),
        "K2w": (lambda: rk.picard_correction_fused(h64, rhs64, CFG64),
                lambda: rk.picard_correction_plain(h64, rhs64, CFG64), 32768,
                "n=64 iters 20", k2_bound(32768, 63, 9, 3, 20), (CFG64, h64, rhs64)),
        "K3w": (lambda: rfk.rod_shape_refined_kernel(h256, l256, CFG256, it256, it256),
                lambda: rfk.rod_shape_refined_plain(h256, l256, CFG256, it256, it256), 8192,
                f"n=256 iters {it256}/{it256}", k3_bound(8192, 255, 3, 3, it256, it256), None),
        "K4": (lambda: rk.rod_shape_fused_bc(hi, q0h, r0h, cfg),
               lambda: rk.rod_shape_fused_bc_plain(hi, q0h, r0h, cfg), B_REAL,
               "N=16 iters 20", k4_bound(B_REAL, 15, 3, 3, 20), None),
        "K4w": (lambda: rk.rod_shape_fused_bc(h64, q0h64, r0h64, CFG64, iters=22),
                lambda: rk.rod_shape_fused_bc_plain(h64, q0h64, r0h64, CFG64, iters=22), 32768,
                "n=64 iters 22", k4_bound(32768, 63, 3, 3, 22), None),
        "K5": (lambda: rfk.rod_shape_refined_kernel_bc(hi, q0h, r0h, lo, q0l, r0l, cfg=cfg),
               lambda: rfk.rod_shape_refined_bc_plain(hi, q0h, r0h, lo, q0l, r0l, cfg=cfg),
               B_REAL, "N=16 iters 20/20", k5_bound(B_REAL, 15, 3, 3, 20, 20), None),
        "K5w": (lambda: rfk.rod_shape_refined_kernel_bc(h64, q0h64, r0h64, l64, q0l64, r0l64,
                                                        cfg=CFG64, iters=22, corr_iters=22),
                lambda: rfk.rod_shape_refined_bc_plain(h64, q0h64, r0h64, l64, q0l64, r0l64,
                                                       cfg=CFG64, iters=22, corr_iters=22),
                32768, "n=64 iters 22/22", k5_bound(32768, 63, 3, 3, 22, 22), None),
    }
    for key, (kernel, plain, batch, shape, bounds, library) in runs.items():
        out, ref = kernel(), plain()
        if key.startswith(("K3", "K5")):
            compare_k3(errors, key, out, ref, f"{key} {shape} B={batch}")
        elif key.startswith(("K1", "K4")):
            record(errors, key, max(max_abs(out[0], ref[0]), max_abs(out[1], ref[1])), F32_TOL,
                   f"{key} {shape} B={batch}")
        else:
            record(errors, key, max_abs(out, ref), F32_TOL, f"{key} {shape} B={batch}")
        del out, ref
        print(f"  {key}: {KERNELS[key]['design']}")
        k, p = timed(card, f"{key} {shape} B={batch}", kernel, plain, batch)
        print(f"  {key}: kernel {back_to_back_ms(kernel):.4f} ms a call back to back [{card}]")
        lib_ms = None
        if library is not None:
            a, b = collocation_system(*library)
            lib_ms = cuda_time_ms(torch.linalg.solve, a, b, warmup=1, reps=3)
            print(f"  {key}: batched torch.linalg.solve of the assembled "
                  f"{tuple(a.shape)} f32 systems {lib_ms:.4f} ms [{card}]")
            del a, b
        print_bounds(key, k, bounds)
        times[key] = dict(ms=k, plain_ms=p, bound_ms=bounds["bound_ms"],
                          bound_by=bounds["bound_by"], library_ms=lib_ms)
        torch.cuda.empty_cache()

    # the wide kernels' other width: n-1 = 63 is the TPU's paired range,
    # n-1 = 255 its plain-wide range
    it64 = rod.auto_picard_iters((h64, l64), CFG64, tol=1e-5)
    rhs256 = torch.zeros((8192, 255, 4), dtype=torch.float32, device=dev)
    rhs256[..., 0] = -CFG256.grid(dev).dn_in.float()
    others = {
        f"K3w n=64 iters {it64}/{it64} B=32768": (
            lambda: rfk.rod_shape_refined_kernel(h64, l64, CFG64, it64, it64),
            lambda: rfk.rod_shape_refined_plain(h64, l64, CFG64, it64, it64), 32768,
            k3_bound(32768, 63, 3, 3, it64, it64)),
        "K1w n=256 iters 24 B=8192": (
            lambda: rk.rod_shape_fused(h256, CFG256, iters=24),
            lambda: rk.rod_shape_fused_plain(h256, CFG256, iters=24), 8192,
            k1_bound(8192, 255, 3, 3, 24)),
        "K2w n=256 iters 20 B=8192": (
            lambda: rk.picard_correction_fused(h256, rhs256, CFG256),
            lambda: rk.picard_correction_plain(h256, rhs256, CFG256), 8192,
            k2_bound(8192, 255, 9, 3, 20)),
    }
    for what, (kernel, plain, batch, bounds) in others.items():
        k, _ = timed(card, what, kernel, plain, batch)
        print_bounds(what, k, bounds)
    # K2 wide at n=256 beside its library call: the full (8192, 1020, 1020)
    # f32 systems take 34 GB, so both run at B=1024.
    h1k, rhs1k = h256[:1024].contiguous(), rhs256[:1024].contiguous()
    k = cuda_time_ms(lambda: rk.picard_correction_fused(h1k, rhs1k, CFG256))
    a, b = collocation_system(CFG256, h1k, rhs1k)
    lib_ms = cuda_time_ms(torch.linalg.solve, a, b, warmup=1, reps=3)
    print(f"  K2w n=256 iters 20 B=1024: kernel {k:.4f} ms; batched torch.linalg.solve of the "
          f"assembled {tuple(a.shape)} f32 systems {lib_ms:.4f} ms [{card}]")
    del a, b
    torch.cuda.empty_cache()

    def headline_plain():
        if rod.strain_rho((hi, lo), cfg) > 5.0:     # the call's validity check
            raise ValueError("strain outside the validity domain")
        return rfk.rod_shape_refined_plain(hi, lo, cfg)

    timed(card, "headline N=16 rod_shape_refined_fused", lambda: rod.rod_shape_refined_fused(
        (hi, lo), refine_steps=1), headline_plain, B_REAL)
    return times


def phase_path_timing(dev: torch.device, card: str) -> None:
    """The N=16 fused and staged calls and each wide path as a whole call
    (CUDA events around the call, host syncs included), and a profiler
    breakdown of four of them."""
    qe64, qe6, loads = wide_inputs(dev)
    batches = {"fused N=16": B_REAL, "staged N=16": B_REAL,
               "refined n=64 single kernel": 32768, "refined n=256 single kernel": 8192,
               "refined n=64 staged": 32768, "Reissner na=6 n=64": 8192, "fused n=64": 32768,
               "statics N=16 B=16384": 16384, "statics n=64 B=4096": 4096}
    qe16 = torch.tensor(0.8 * np.random.default_rng(0).standard_normal((B_REAL, 9)), device=dev)
    qe16[0] = rod.demo_qe(torch.float64, dev)        # phase 4's N=16 slice
    q16 = rod.split_strain(qe16)
    calls = {"fused N=16": (lambda: rod.rod_shape(q16[0], method="fused"), None),
             "staged N=16": (lambda: rod.rod_shape_refined_fused(q16, refine_steps=2), None),
             **wide_paths(qe64, qe6, loads)}
    for what, (fn, _) in calls.items():
        slow = what.startswith("statics") or "staged" in what
        ms = cuda_time_ms(fn, warmup=1 if slow else 3, reps=3 if slow else 10)
        print(f"  {what}: {ms:.4f} ms per call -> {batches[what] / ms * 1e3:.4g} solves/s "
              f"[{card}]")
    paths = wide_paths(qe64, qe6, loads)
    hi, lo = rod.split_strain(qe64[:8192].repeat(16, 1))      # the N=16 headline's B=131072
    profiled = {"headline N=16 B=131072": (lambda: rod.rod_shape_refined_fused(
                    (hi, lo), refine_steps=1), 10),
                "refined n=256 single kernel": (paths["refined n=256 single kernel"][0], 10),
                "refined n=64 staged": (paths["refined n=64 staged"][0], 3),
                "statics N=16 B=16384": (paths["statics N=16 B=16384"][0], 3)}
    for what, (fn, reps) in profiled.items():
        prof = device_breakdown(fn, warmup=1, reps=reps)
        print(f"  profile {what}: host {prof['host_ms']:.4f} ms per call, device busy "
              f"{prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, {prof['events']:.0f} "
              f"device events per call [{card}]")
        for name, ms, count in prof["top"]:
            print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


def phase_segment_timing(dev: torch.device, card: str) -> None:
    """Each multi-segment path as a whole call, and a profiler breakdown of
    the refined 3 x n=16 chain and the segmented Newton."""
    paths = segment_paths(segment_inputs(dev))
    batch = {"segmented statics": B_SEG_NEWTON, "segmented dd statics": B_SEG_DD}
    for what, (fn, _) in paths.items():
        slow = "statics" in what
        ms = cuda_time_ms(fn, warmup=1 if slow else 3, reps=3 if slow else 10)
        b = batch.get(what, B_SEG64 if "n=64" in what else B_REAL)
        print(f"  {what} B={b}: {ms:.4f} ms per call -> {b / ms * 1e3:.4g} solves/s [{card}]")
    for what, reps in (("chain 3 x n=16 refined_fused", 10), ("segmented statics", 3)):
        prof = device_breakdown(paths[what][0], warmup=1, reps=reps)
        print(f"  profile {what}: host {prof['host_ms']:.4f} ms per call, device busy "
              f"{prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, {prof['events']:.0f} "
              f"device events per call [{card}]")
        for name, ms, count in prof["top"]:
            print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")


def main() -> None:
    t_start = time.perf_counter()
    print("== 1. environment")
    card = phase_environment()
    dev = torch.device("cuda", 0)
    print("== 2. build")
    phase_build()
    phase_accumulation_probe(dev)
    print("== 3. kernels vs plain versions on the card")
    errors = {}
    phase_kernels_vs_plain(dev, errors)
    print("== 4. the paths at real size")
    launches = {}
    phase_narrow_slice(dev, launches)
    phase_wide_paths(dev, launches)
    phase_segment_paths(dev, launches)
    print("== 4b. the statics layer")
    phase_statics_layer(dev, launches)
    print("== 4c. the dynamics layer")
    phase_dynamics_layer(dev, launches)
    print("== 4d. the rest of the dynamics layer (plain torch, no kernel)")
    phase_rest_of_dynamics(dev, card, launches)
    print("== 4e. the inverse and constrained layers (the fused measure on K1)")
    phase_inverse_layers(dev, card, launches)
    print("== 4f. concentric tubes, utils and examples")
    t4f = time.perf_counter()
    phase_ctr_utils_examples(dev, card, launches)
    print(f"  phase 4f {time.perf_counter() - t4f:.1f} s")
    print("== 4g. multi-device rod batches (parallel/mesh.py)")
    t4g = time.perf_counter()
    mesh_ms = phase_multi_device(dev, card, launches)
    if len(mesh_ms) < 2 or not all(len(calls) == 7 for calls in mesh_ms.values()):
        raise AssertionError(f"phase 4g did not run every sharded call on both meshes: {mesh_ms}")
    print(f"  phase 4g {time.perf_counter() - t4g:.1f} s")
    print(f"main-path launches: {launches}")
    print("== 5. timing (CUDA events, median of 10 after 3 warm-up calls)")
    times = phase_timing(dev, card, errors)
    phase_path_timing(dev, card)
    phase_segment_timing(dev, card)
    phase_statics_layer_timing(dev, card)
    phase_dynamics_layer_timing(dev, card)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {"name": spec["name"], "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "launches": launches[key],
         "max_abs_err": errors[key], **times[key]}
        for key, spec in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
