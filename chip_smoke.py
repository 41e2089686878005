"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure (exit code != 0, no result lines):

1. environment: versions, the card, its power limit, nvcc and triton;
2. build the CUDA kernels from ``csrc/``, one nvcc per source, all at once:
   K1-K3 narrow (n-1 <= 32) and K1-K3 wide (32 < n-1 <= 512);
3. each kernel against its plain PyTorch version on the card: narrow at
   N in {8, 16, 33}, wide at n-1 in {33, 63, 64, 65, 128, 255, 512} and a
   ragged batch, na in {3, 6};
4. the paths at real size, each with the launch counts set to 0 just before
   it and read just after, NaN checks, and the port's f64 dense solve on the
   card as reference: the N=16 slice at B=131072 (``rod_shape_refined_fused``
   single-kernel and staged, ``rod_shape(method='fused')``, golden demo tip);
   refined n=64 (B=32768) and n=256 (B=8192) on K3 wide, staged n=64 on
   K2 wide, Reissner na=6 n=64 (B=8192), fused n=64 on K1 wide; the statics
   Newton ``solve_statics_batched`` at N=16 (B=16384) and n=64 (B=4096)
   against the per-sample ``solve_statics`` on 64 loads;
5. CUDA-event timings of each kernel beside its plain version, its bound and
   (K2) the batched ``torch.linalg.solve`` of the same systems, of each path
   as a whole call, and of ``gauss_jordan_solve`` beside the library solve
   that the Newton step calls; a torch.profiler breakdown (device busy,
   idle share, top kernels) of the N=16 headline, refined n=256 and
   statics N=16 calls.

The last three lines of standard output are a JSON line with the kernels,
the card's name and power limit as nvidia-smi prints them, and the JSON
result line.
"""

from __future__ import annotations

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    collocation as coll,
    doubledouble as dd,
    lie,
    smallsolve,
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
F32_TOL = 5e-5     # K1/K2 vs plain: the 'high' gate of tests/test_pallas_kernel.py:26,43
K3_TOL = 1e-9      # K3 vs plain on the joined f64 outputs
GATE = 1e-8        # refined paths vs the f64 dense solve, relative L-inf
QE_TOL = 2e-5      # batched vs per-sample statics Newton (tests/test_cosserat_statics.py:207)
GOLDEN_Q = (0.799770, 0.0, 0.600307, 0.0)   # demo tip, SURVEY.md section 4
GOLDEN_R = (0.562673, 0.0, -0.745914)
GOLDEN_TOL = 1e-6
# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores; FP64 on the tensor cores (DMMA), the higher of the card's two FP64
# rates, since K3's FP64 work is matrix products; HBM3 bandwidth.
F32_PEAK, F64_PEAK, HBM_RATE = 67e12, 67e12, 3.35e12

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
    for lib in libs:
        print(f"built {lib._name.split('/')[-1]}: nvcc {lib.build_seconds:.1f} s")
    print(f"all built in {time.perf_counter() - t0:.1f} s (parallel)")
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


def compare_k3(errors: dict, key: str, outs, plain, what: str) -> None:
    kq, kr = joined(outs)
    pq, pr = joined(plain)
    if not torch.equal(torch.isnan(kq), torch.isnan(pq)):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    if torch.isnan(kq).any():
        raise AssertionError(f"{what}: NaN for in-domain strains")
    record(errors, key, max(max_abs(kq, pq), max_abs(kr, pr)), K3_TOL, what)


def compare_kernels(dev, errors: dict, rng, n: int, na: int, batch: int) -> None:
    """K1, K2 and K3 (narrow or wide, as the grid routes them) against
    their plain versions on one batch; each wrapper must launch once."""
    cfg = rod.RodConfig(n=n, na=na)
    wide = rk.is_wide(n - 1)
    keys = ("K1w", "K2w", "K3w") if wide else ("K1", "K2", "K3")
    qe64 = torch.tensor(0.8 * rng.standard_normal((batch, na * 3)), device=dev)
    hi, lo = dd.split_f64(qe64)
    rhs = torch.tensor(0.1 * rng.standard_normal((batch, n - 1, 4)), dtype=torch.float32,
                       device=dev)
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


def picard_fma(n1: int, iters: int) -> int:
    """FP32 FMAs of ``iters`` Picard steps for one rod: G (4 columns) plus
    the 12-FMA A(K/2) action per point."""
    return iters * (4 * n1 * n1 + 12 * n1)


def bound(f32_fma: float, f64_fma: float, nbytes: float) -> tuple:
    """(least ms on the card, what bounds it): operations at the published
    peaks (an FMA is 2 FLOP) against bytes at the HBM rate."""
    t_ops = 2 * f32_fma / F32_PEAK + 2 * f64_fma / F64_PEAK
    t_mem = nbytes / HBM_RATE
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def k1_bound(b, n1, na, ne, iters):
    return bound(b * (na * ne * n1 + picard_fma(n1, iters) + 3 * n1 * n1), 0,
                 4 * b * (na * ne + 7 * n1))


def k2_bound(b, n1, nq, ne, iters):
    return bound(b * (3 * ne * n1 + 4 * n1 * n1 + picard_fma(n1, iters)), 0,
                 4 * b * (nq + 8 * n1))


def k3_bound(b, n1, na, ne, iters, corr_iters):
    f32 = b * (picard_fma(n1, iters) + picard_fma(n1, corr_iters) + 4 * n1 * n1)
    f64 = b * (na * ne * n1 + 4 * n1 * n1 + 12 * n1 + 3 * n1 * n1)
    return bound(f32, f64, 4 * b * (2 * na * ne + 14 * n1))


def collocation_system(cfg: rod.RodConfig, qes: torch.Tensor, rhs: torch.Tensor):
    """K2's systems assembled for one library call: ``(I ⊗ Dn_NN - 1/2 A_hat)``
    ``(B, 4(n-1), 4(n-1))`` and the component-major right-hand side."""
    k = rod.curvature_at_points(cfg, qes)[..., :3]          # f32, as the kernel's
    a = coll.collocation_matrix(cfg.grid(qes.device), 0.5 * lie.quat_skew(k))
    return a, coll.to_component_major(rhs).unsqueeze(-1)


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
    }
    for key, (kernel, plain, batch, shape, (bound_ms, bound_by), library) in runs.items():
        out, ref = kernel(), plain()
        if key.startswith("K3"):
            compare_k3(errors, key, out, ref, f"{key} {shape} B={batch}")
        elif key.startswith("K1"):
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
        print(f"  {key}: bound {bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / k:.1%} of it")
        times[key] = dict(ms=k, plain_ms=p, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
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
    for what, (kernel, plain, batch, (bound_ms, bound_by)) in others.items():
        k, _ = timed(card, what, kernel, plain, batch)
        print(f"  {what}: bound {bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / k:.1%} "
              "of it")

    def headline_plain():
        if rod.strain_rho((hi, lo), cfg) > 5.0:     # the call's validity check
            raise ValueError("strain outside the validity domain")
        return rfk.rod_shape_refined_plain(hi, lo, cfg)

    timed(card, "headline N=16 rod_shape_refined_fused", lambda: rod.rod_shape_refined_fused(
        (hi, lo), refine_steps=1), headline_plain, B_REAL)
    return times


def phase_path_timing(dev: torch.device, card: str) -> None:
    """Each wide path as a whole call (CUDA events around the call, host
    syncs included), and ``gauss_jordan_solve`` beside the library solve."""
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
                "statics N=16 B=16384": (paths["statics N=16 B=16384"][0], 3)}
    for what, (fn, reps) in profiled.items():
        prof = device_breakdown(fn, warmup=1, reps=reps)
        print(f"  profile {what}: host {prof['host_ms']:.4f} ms per call, device busy "
              f"{prof['device_ms']:.4f} ms, idle {prof['idle']:.1%}, {prof['events']:.0f} "
              f"device events per call [{card}]")
        for name, ms, count in prof["top"]:
            print(f"    {ms:.4f} ms in {count:.0f} x {name[:90]}")
    rng = np.random.default_rng(2)
    a = torch.tensor(3.0 * np.eye(9) + 0.3 * rng.standard_normal((16384, 9, 9)),
                     dtype=torch.float32, device=dev)
    b = torch.tensor(rng.standard_normal((16384, 9)), dtype=torch.float32, device=dev)
    gj = cuda_time_ms(smallsolve.gauss_jordan_solve, a, b)
    lib = cuda_time_ms(lambda: torch.linalg.solve(a, b.unsqueeze(-1)))
    err = max_abs(smallsolve.gauss_jordan_solve(a, b), torch.linalg.solve(a, b.unsqueeze(-1))[..., 0])
    print(f"  gauss_jordan_solve (16384, 9, 9) f32: {gj:.4f} ms; torch.linalg.solve "
          f"{lib:.4f} ms; max |difference| {err:.2e} [{card}]")


def main() -> None:
    t_start = time.perf_counter()
    print("== 1. environment")
    card = phase_environment()
    dev = torch.device("cuda", 0)
    print("== 2. build")
    phase_build()
    print("== 3. kernels vs plain versions on the card")
    errors = {}
    phase_kernels_vs_plain(dev, errors)
    print("== 4. the paths at real size")
    launches = {}
    phase_narrow_slice(dev, launches)
    phase_wide_paths(dev, launches)
    print(f"main-path launches: {launches}")
    print("== 5. timing (CUDA events, median of 10 after 3 warm-up calls)")
    times = phase_timing(dev, card, errors)
    phase_path_timing(dev, card)
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
