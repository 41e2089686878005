"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure (exit code != 0, no result lines):

1. environment: versions, the card, its power limit, nvcc and triton;
2. build the CUDA kernels from ``csrc/``, one nvcc per source, all at once:
   K1-K5 narrow (n-1 <= 32) and K1-K5 wide (32 < n-1 <= 512); registers and
   spills per kernel, and whether each library's SASS holds tensor-core
   (HMMA) instructions (both wide ones must);
3. each kernel against its plain PyTorch version on the card: narrow at
   N in {8, 16, 33}, wide at n-1 in {33, 63, 64, 65, 128, 255, 512} and a
   ragged batch, na in {3, 6}; K4 and K5 with random unit q0 and
   r0 ~ U(-1, 1) per rod;
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
5. CUDA-event timings of each kernel beside its plain version, its bound
   (CUDA-core FP32, and with the f32 matrix products as 3xTF32 on the tensor
   cores) and (K2) the batched ``torch.linalg.solve`` of the same systems, of
   each path
   as a whole call; a torch.profiler breakdown (device busy,
   idle share, top kernels) of the N=16 headline, refined n=256, staged
   n=64, statics N=16, refined 3 x n=16 chain and segmented statics calls.

The last three lines of standard output are a JSON line with the kernels,
the card's name and power limit as nvidia-smi prints them, and the JSON
result line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    rod,
    segment_statics,
    segments,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    collocation as coll,
    doubledouble as dd,
    lie,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    build,
    refined_kernel as rfk,
    rod_kernel as rk,
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
    "K1w": dict(name="K1 wide rod_shape_fused_wide", wrapper=rk.rod_shape_fused_wide,
                source=f"{PKG}/csrc/rod_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:738; "
                         f"{JAX_PKG}/ops/pallas/rod_kernel.py:997"),
    "K2w": dict(name="K2 wide picard_correction_fused_wide",
                wrapper=rk.picard_correction_fused_wide,
                source=f"{PKG}/csrc/rod_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:738; "
                         f"{JAX_PKG}/ops/pallas/rod_kernel.py:997"),
    "K3w": dict(name="K3 wide rod_shape_refined_kernel_wide",
                wrapper=rfk.rod_shape_refined_kernel_wide,
                source=f"{PKG}/csrc/refined_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:540; "
                         f"{JAX_PKG}/ops/pallas/refined_kernel.py:1195"),
    "K4": dict(name="K4 rod_shape_fused_bc", wrapper=rk.rod_shape_fused_bc,
               source=f"{PKG}/csrc/rod_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:508"),
    "K4w": dict(name="K4 wide rod_shape_fused_bc_wide", wrapper=rk.rod_shape_fused_bc_wide,
                source=f"{PKG}/csrc/rod_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/rod_kernel.py:738; "
                         f"{JAX_PKG}/ops/pallas/rod_kernel.py:997"),
    "K5": dict(name="K5 rod_shape_refined_kernel_bc", wrapper=rfk.rod_shape_refined_kernel_bc,
               source=f"{PKG}/csrc/refined_kernel.cu",
               replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:792"),
    "K5w": dict(name="K5 wide rod_shape_refined_kernel_bc_wide",
                wrapper=rfk.rod_shape_refined_kernel_bc_wide,
                source=f"{PKG}/csrc/refined_wide_kernel.cu",
                replaces=f"{JAX_PKG}/ops/pallas/refined_kernel.py:635; "
                         f"{JAX_PKG}/ops/pallas/refined_kernel.py:1195"),
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
        hmma = sass.count("HMMA")
        print(f"built {lib._name.split('/')[-1]}: nvcc {lib.build_seconds:.1f} s; tensor-core "
              f"(HMMA) instructions in its SASS: {'yes' if hmma else 'no'} ({hmma})")
        if "wide_kernel" in lib._name and not hmma:
            raise AssertionError(f"{lib._name}: the wide kernels hold no HMMA instruction")
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
    the nearest f32.  The wide kernels sum each k-step's products in a
    fresh tile and add it to the state in FP32 because this sum is not
    rounded to nearest."""
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
    loads = torch.tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (16384, 3)),
                         dtype=torch.float32, device=dev)
    return qe64, qe6, loads


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
    check_dd_newton(results["segmented dd statics"], inp["loads"][:B_SEG_DD], dev)


def check_dd_newton(sol, loads, dev, picks: int = 16) -> None:
    """What the dd Newton's tolerance bounds.  Every load: the K5 chain's
    residual agrees with the f64 dense residual at the solution within
    DD_RES_ERR, so the dense residual is <= tol + DD_RES_ERR.  ``picks``
    loads: the strains lie within the first-order bound
    2 (tol + DD_RES_ERR + |res(ref)|) / sigma_min(J) of the per-sample f64
    Newton's, with J the dense residual's Jacobian there (sigma_min ~ 0.1
    here, so tol = 1e-9 allows ~2e-8)."""
    what, tol = "segmented dd statics", SEG_DD_NEWTON["tol"]
    b, s_count, nq = sol.qe.shape
    if sol.qe_lo is None or (b, s_count, nq) != (B_SEG_DD, 2, 9) or not bool(sol.converged.all()):
        raise AssertionError(f"{what}: {int((~sol.converged).sum())} loads did not converge")
    qe = dd.join_f64(sol.qe, sol.qe_lo)
    zero = torch.zeros(3, dtype=torch.float64, device=dev)
    dense = segment_statics.segmented_equilibrium_residual(
        qe, loads.double(), zero, SEG_STATICS, method="dense").reshape(b, -1)
    res_dd = segment_statics.segmented_equilibrium_residual_dd(
        (sol.qe, sol.qe_lo), loads, zero.float(), SEG_STATICS,
        iters=SEG_DD_NEWTON["dd_iters"]).reshape(b, -1).double()
    dd_err = float((res_dd - dense).abs().max())
    dense_norm = torch.linalg.vector_norm(dense, dim=-1)
    print(f"  {what}: all converged, max residual {float(sol.residual_norm.max()):.3e}; "
          f"|dd residual - f64 dense residual| {dd_err:.3e} (bound {DD_RES_ERR:.0e}), max "
          f"f64 dense residual {float(dense_norm.max()):.3e} (bound tol + {DD_RES_ERR:.0e}) "
          f"over all {b} loads")
    if not (dd_err <= DD_RES_ERR and float(dense_norm.max()) <= tol + DD_RES_ERR):
        raise AssertionError(f"{what}: the f64 dense residual is outside the tolerance")

    idx = torch.linspace(0, b - 1, picks, device=dev).long()
    tf = loads[idx].double().cpu()
    ref = segment_statics.solve_segmented_statics(tf, cfg=SEG_STATICS, tol=1e-12, max_iter=40,
                                                  method="dense")
    q_ref = ref.qe.reshape(picks, -1)

    def residual(q):
        return segment_statics.segmented_equilibrium_residual(
            q.reshape(picks, s_count, nq), tf, zero.cpu(), SEG_STATICS,
            method="dense").reshape(picks, -1)

    jac = torch.func.jacfwd(lambda d: residual(q_ref + d))(q_ref.new_zeros(s_count * nq))
    sigma_min = torch.linalg.svdvals(jac)[:, -1]
    limit = 2 * (tol + DD_RES_ERR + ref.residual_norm) / sigma_min
    err = (qe[idx].reshape(picks, -1).cpu() - q_ref).abs().max(dim=-1).values
    print(f"    |qe - per-sample f64 Newton| max {float(err.max()):.3e} over {picks} loads; "
          f"sigma_min(J) {float(sigma_min.min()):.4f}..{float(sigma_min.max()):.4f}; "
          f"largest share of the first-order bound {float((err / limit).max()):.3e} "
          f"(bound >= {float(limit.min()):.3e})")
    if not (bool(ref.converged.all()) and bool((err <= limit).all())):
        raise AssertionError(f"{what}: strains outside what the tolerance bounds")


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
        k, p = timed(card, f"{key} {shape} B={batch}", kernel, plain, batch)
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
    """Each wide path as a whole call (CUDA events around the call, host
    syncs included), and a profiler breakdown of four of them."""
    qe64, qe6, loads = wide_inputs(dev)
    batches = {"refined n=64 single kernel": 32768, "refined n=256 single kernel": 8192,
               "refined n=64 staged": 32768, "Reissner na=6 n=64": 8192, "fused n=64": 32768,
               "statics N=16 B=16384": 16384, "statics n=64 B=4096": 4096}
    for what, (fn, _) in wide_paths(qe64, qe6, loads).items():
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
    print(f"main-path launches: {launches}")
    print("== 5. timing (CUDA events, median of 10 after 3 warm-up calls)")
    times = phase_timing(dev, card, errors)
    phase_path_timing(dev, card)
    phase_segment_timing(dev, card)
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
