"""K1, K2 and K4: the fused f32 rod solve, its general right-hand-side solve,
and the fused solve with per-rod boundary values.

Sources: ``csrc/rod_kernel.cu`` (narrow grids, n-1 <= 32) and
``csrc/rod_wide_kernel.cu`` (wide grids, 32 < n-1 <= 512), both on
``csrc/tf32_mma.cuh``.  They replace the
JAX package's Pallas TPU kernels in ``ops/pallas/rod_kernel.py``, whose
narrow, wide and paired bodies differ only in how they pack rods onto the
TPU's tiles:

* K1 ``rod_shape_fused`` (body ``_kernel``): ``qe -> K = Phi qe`` -> f32
  Picard fixed point ``s = G rhs + G (1/2 A(K)) s`` with the demo boundary
  conditions ``q0 = (1,0,0,0)``, ``r0 = 0`` -> unnormalized tangent
  ``R(s) e1`` (``R(s)(e1 + gamma)`` for na=6) -> position ``r = G b``;
* K2 ``picard_correction_fused`` (body ``_corr_kernel``): the same Picard
  operator for a per-rod right-hand side, ``(I ⊗ Dn_NN - 1/2 A_hat) x = rhs``,
  reading only the 3 curvature components of ``qe``;
* K4 ``rod_shape_fused_bc`` (body ``_kernel_bc``): K1 with per-rod boundary
  values ``q0 (B, 4)`` and ``r0 (B, 3)``, the building block of the fused
  multi-segment chains.  ``G (-dn_in ⊗ q0) = gvec ⊗ q0`` with K1's constant
  ``gvec = G (-dn_in)``, so K4 is K1 started from ``gvec ⊗ q0`` whose
  position ends with ``+ gvec ⊗ r0``; one CUDA body serves both;
* K1 wide ``rod_shape_fused_wide``, K2 wide ``picard_correction_fused_wide``
  and K4 wide ``rod_shape_fused_bc_wide`` (bodies ``_kernel_wide``/
  ``_kernel_pair``, ``_corr_kernel_wide``/``_corr_kernel_pair`` and
  ``_kernel_wide_bc``/``_kernel_pair_bc``): the same functions on wide
  grids.  The public ``rod_shape_fused``, ``picard_correction_fused`` and
  ``rod_shape_fused_bc`` route there.

What bounds them on an H100: at N=16 a rod costs about 20 x (15*15*4 +
15*12) = 21,600 FP32 FMAs against ~456 bytes of device traffic (9 floats
in, 15 x 7 floats out), about 47 FMAs per byte, far above the card's
~10 FP32 FLOP per byte of HBM bandwidth: they are operations bound.  The
kernels keep every operand on chip and run the products with G on the
tensor cores (``mma.sync``).  Narrow grids (P = 8, 16 or 32 points, the next
power of two >= n-1): each Picard step of a warp's 8 or 16 rods is one
transposed GEMM ``S^T = base^T + T^T G^T`` held entirely in registers, the
rods' four components as M, the points as N and K; the accumulator of one
step is the A operand of the next once G^T's rows are permuted to the
``mma.sync`` k order (:func:`mma_k_order`), so there is no shared memory and
no barrier.  Wide grids: the points as M, the rods' four components as N,
G^T and ``A(K/2) s`` in shared memory, the state in the MMA accumulators
(``csrc/tc_picard.cuh``, shared with the refined wide kernels).  The TPU
layout (128-sublane rod packing, the bf16x3 matmul emulation) does not
carry over.

Arithmetic is FP32 for every ``precision`` value the JAX API accepts
('float32', 'high', 'default', 'highest'): the TPU's bf16 pass count has
no Hopper counterpart.  The kernels form their products with G as 3xTF32
tensor-core products, as accurate as FP32 FMAs here
(``tests/test_torch_wide.py``).

Beside each kernel: a plain PyTorch version with the same math (the wrapper
takes it for CPU tensors only; a CUDA tensor launches the kernel or raises)
and a launch count on the wrapper (``rod_shape_fused.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import basis as basis_ops
from ..device import as_tensor, canonical_device
from ..lie import quat_skew_apply, rod_tangent
from ...models.rod import RodConfig
from . import build

__all__ = ["rod_shape_fused", "rod_shape_fused_plain", "rod_shape_fused_wide",
           "rod_shape_fused_bc", "rod_shape_fused_bc_plain", "rod_shape_fused_bc_wide",
           "picard_correction_fused", "picard_correction_plain",
           "picard_correction_fused_wide", "PRECISIONS", "MAX_POINTS",
           "NARROW_POINTS", "build_library", "build_wide_library"]

PRECISIONS = ("float32", "high", "default", "highest")
NARROW_POINTS = 32   # n-1 of the narrow kernels; wide kernels above
MAX_POINTS = 512     # the JAX package's WIDE_MAX_PTS

_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    # qes, B, npts, P, na, ne, gtp, ptab, gvec, iters, q_out, r_out, stream
    "rod_shape_fused_f32": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    # qes, B, npts, P, nq, ne, gtp, ptab, rhs, iters, x_out, stream
    "picard_correction_f32": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    # qes, q0, r0, B, npts, P, na, ne, gtp, ptab, gvec, iters, q_out, r_out, stream
    "rod_shape_fused_bc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P],
}
# Same arguments, with the wide kernels' G^T planes (gt) in place of gtp.
_WIDE_SIGNATURES = {
    "rod_shape_fused_wide_f32": _SIGNATURES["rod_shape_fused_f32"],
    "picard_correction_wide_f32": _SIGNATURES["picard_correction_f32"],
    "rod_shape_fused_bc_wide_f32": _SIGNATURES["rod_shape_fused_bc_f32"],
}


@functools.lru_cache(maxsize=None)
def build_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/rod_kernel.cu``."""
    return build.load_library("rod_kernel", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def build_wide_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/rod_wide_kernel.cu``."""
    return build.load_library("rod_wide_kernel", _WIDE_SIGNATURES)


def lanes_per_rod(npts: int) -> int:
    """P, the padded width of a rod: the next power of two >= n-1, at
    least 8 (narrow kernels) or 64 (wide kernels)."""
    for p in (8, 16, 32, 64, 128, 256, 512):
        if npts <= p:
            return p
    raise ValueError(
        f"the CUDA rod kernels cover n-1 <= {MAX_POINTS} points (got "
        f"{npts}), as the JAX package's Pallas kernels do; use "
        "rod_shape(method='picard' or 'dense') beyond that")


def is_wide(npts: int) -> bool:
    """Grids the wide kernels take: 32 < n-1 <= 512."""
    return NARROW_POINTS < npts <= MAX_POINTS


@dataclass(frozen=True, eq=False)
class KernelConstants:
    """f32 operators zero-padded to ``P`` points (padding keeps every
    padded point at exactly zero through the whole solve)."""

    npts: int
    p: int
    g: torch.Tensor        # (P, P) G = Dn_NN^{-1}
    ptab: torch.Tensor     # (P, ne) basis table at the unknown points
    gvec: torch.Tensor     # (P,) G (-dn_in): G rhs for q0 = (1,0,0,0)
    gt: torch.Tensor | None   # (3, P, P) G^T, its TF32 hi and lo parts; wide grids only
    # (3, P, P) G^T with its rows in mma_k_order, its TF32 hi and lo parts;
    # narrow grids only
    gtp: torch.Tensor | None


def host_operators(cfg: RodConfig):
    """f64 host constants of the rod's grid: ``(G, Dn_NN, dn_in, P table)``."""
    from .. import chebyshev

    dn = chebyshev.diff_matrix(cfg.n, cfg.length)
    dn_nn, dn_in = chebyshev.split_endpoint(dn, "last")
    ginv = chebyshev.integration_matrix(cfg.n, cfg.length)
    return ginv, dn_nn, dn_in[:, 0], cfg.basis_table


def tf32_planes(a: torch.Tensor) -> torch.Tensor:
    """f32 ``a`` stacked with its split into TF32 parts, ``(a, hi, lo)``:
    ``hi = tf32(a)``, ``lo = tf32(a - hi)``, each rounded to nearest with
    ties away from zero as the tensor cores' ``cvt.rna.tf32.f32`` rounds.
    The kernels read a constant operand split from here instead of splitting
    it at every product."""
    def tf32(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hi = tf32(a)
    return torch.stack([a, hi, tf32(a - hi)])


def mma_k_order(p: int) -> np.ndarray:
    """The point of each k row of the narrow kernels' ``mma.sync`` products:
    in every 8-deep k-block, rows t and t + 4 (t < 4) stand for points 2t
    and 2t + 1 of the block, where the previous product's accumulator left
    them, so that accumulator serves as the next A operand unchanged."""
    k = np.arange(p)
    j = k % 8
    return k - j + 2 * (j % 4) + j // 4


def padded(a: np.ndarray, shape, dtype, device) -> torch.Tensor:
    out = np.zeros(shape, np.float64)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return torch.tensor(out, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _constants(cfg: RodConfig, device: torch.device) -> KernelConstants:
    ginv, _, dn_in, table = host_operators(cfg)
    npts = cfg.n - 1
    p = lanes_per_rod(npts)
    f32, wide = torch.float32, is_wide(npts)
    gt = np.pad(ginv.T, (0, p - npts))
    return KernelConstants(
        npts=npts, p=p,
        g=padded(ginv, (p, p), f32, device),
        ptab=padded(table, (p, cfg.ne), f32, device),
        gvec=padded(-(ginv @ dn_in), (p,), f32, device),
        gt=tf32_planes(padded(gt, (p, p), f32, device)) if wide else None,
        gtp=None if wide else tf32_planes(padded(gt[mma_k_order(p)], (p, p), f32, device)),
    )


def constants(cfg: RodConfig, device) -> KernelConstants:
    return _constants(cfg, canonical_device(device))


def check_qes(qes, cfg: RodConfig, precision: str = "high") -> torch.Tensor:
    """Validate a strain batch for the kernels: 2-D ``(B, na*ne)``, B > 0,
    n-1 <= 512; returns it as a contiguous f32 tensor (a tensor keeps its
    device, other input goes to the default device)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    qes = as_tensor(qes).to(torch.float32).contiguous()
    if qes.ndim != 2 or qes.shape[1] != cfg.na * cfg.ne:
        raise ValueError(f"qes must be (B, {cfg.na * cfg.ne}), got {tuple(qes.shape)}")
    if qes.shape[0] == 0:
        raise ValueError("fused kernels need a non-empty batch (got B=0); the "
                         "dense and picard paths handle empty batches")
    if cfg.na < 3:
        raise ValueError(f"the rod kernels need na >= 3 (got {cfg.na})")
    lanes_per_rod(cfg.n - 1)
    return qes


def picard_plain(g: torch.Tensor, khalf: torch.Tensor, g_rhs: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """``s = g_rhs + G (1/2 A(K)) s``, ``iters`` steps from ``s = g_rhs``;
    ``khalf`` already holds ``K/2``."""
    s = g_rhs
    for _ in range(iters):
        s = g_rhs + torch.matmul(g, quat_skew_apply(khalf, s))
    return s


def demo_g_rhs(gvec: torch.Tensor, batch: int) -> torch.Tensor:
    g_rhs = gvec.new_zeros((batch, gvec.shape[0], 4))
    g_rhs[..., 0] = gvec
    return g_rhs


def rod_shape_fused_bc_plain(qes: torch.Tensor, q_init: torch.Tensor | None,
                             r_init: torch.Tensor | None, cfg: RodConfig = RodConfig(),
                             iters: int = 20):
    """Plain PyTorch version of K4 (same math, any device): the Picard
    solve from ``G rhs = gvec ⊗ q0`` and the position ``G b + gvec ⊗ r0``.
    ``None`` stands for the demo values ``q0 = (1,0,0,0)``, ``r0 = 0``."""
    c = constants(cfg, qes.device)
    n1 = c.npts
    g, gvec = c.g[:n1, :n1], c.gvec[:n1]
    k = basis_ops.strain_at_points(qes, c.ptab[:n1])
    g_rhs = (demo_g_rhs(gvec, qes.shape[0]) if q_init is None
             else gvec[:, None] * q_init[:, None, :])
    s = picard_plain(g, 0.5 * k[..., :3], g_rhs, iters)
    b = rod_tangent(s, k[..., 3:6] if cfg.na == 6 else None)
    r = torch.matmul(g, b)
    return s, r if r_init is None else r + gvec[:, None] * r_init[:, None, :]


def rod_shape_fused_plain(qes: torch.Tensor, cfg: RodConfig = RodConfig(),
                          iters: int = 20):
    """Plain PyTorch version of K1: K4's with the demo boundary values."""
    return rod_shape_fused_bc_plain(qes, None, None, cfg, iters)


def picard_correction_plain(qes: torch.Tensor, rhs: torch.Tensor,
                            cfg: RodConfig = RodConfig(), iters: int = 20):
    """Plain PyTorch version of K2 (same math, any device)."""
    c = constants(cfg, qes.device)
    n1 = c.npts
    g = c.g[:n1, :n1]
    k = basis_ops.strain_at_points(qes[:, :3 * cfg.ne], c.ptab[:n1])
    return picard_plain(g, 0.5 * k, torch.matmul(g, rhs), iters)


def on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, "
                     f"got {t.device}")


def _check_width(cfg: RodConfig, wide: bool, what: str) -> None:
    if is_wide(cfg.n - 1) != wide:
        raise ValueError(f"{what} takes {'32 < n-1 <= 512' if wide else 'n-1 <= 32'} "
                         f"points, got n-1 = {cfg.n - 1}")


def _launch_fused(entry, gmat, qes: torch.Tensor, cfg: RodConfig, c: KernelConstants,
                  iters: int, what: str, bc: tuple = ()):
    """One K1 launch, or K4 with ``bc = (q0, r0)`` passed after ``qes``."""
    b = qes.shape[0]
    q = torch.empty((b, c.npts, 4), dtype=torch.float32, device=qes.device)
    r = torch.empty((b, c.npts, 3), dtype=torch.float32, device=qes.device)
    with torch.cuda.device(qes.device):
        err = entry(build.ptr(qes), *map(build.ptr, bc), b, c.npts, c.p, cfg.na, cfg.ne,
                    build.ptr(gmat), build.ptr(c.ptab), build.ptr(c.gvec), int(iters),
                    build.ptr(q), build.ptr(r), build.stream_of(qes))
    build.check_launch(err, what)
    return q, r


def rod_shape_fused(qes, cfg: RodConfig = RodConfig(), iters: int = 20,
                    precision: str = "high"):
    """Batched fused rod solve (K1): ``qes (B, na*ne) -> (Q (B, n-1, 4), r (B, n-1, 3))``.

    Same semantics as ``rod_shape(..., method='picard')`` with the demo
    boundary conditions; f32 throughout.  CUDA tensors run the kernel, CPU
    tensors its plain version.  Grids with 32 < n-1 <= 512 go to K1 wide
    (:func:`rod_shape_fused_wide`).
    """
    if cfg.na not in (3, 6):
        raise ValueError("rod_shape_fused supports na in (3, 6)")
    qes = check_qes(qes, cfg, precision)
    if is_wide(cfg.n - 1):
        return rod_shape_fused_wide(qes, cfg, iters, precision)
    if not on_cuda(qes, "rod_shape_fused"):
        return rod_shape_fused_plain(qes, cfg, iters)
    c = constants(cfg, qes.device)
    q, r = _launch_fused(build_library().rod_shape_fused_f32, c.gtp, qes, cfg, c, iters,
                         "rod_shape_fused")
    rod_shape_fused.launches += 1
    return q, r


rod_shape_fused.launches = 0


def rod_shape_fused_wide(qes, cfg: RodConfig = RodConfig(n=64), iters: int = 20,
                         precision: str = "high"):
    """K1 wide: :func:`rod_shape_fused` on grids with 32 < n-1 <= 512
    (``csrc/rod_wide_kernel.cu``)."""
    if cfg.na not in (3, 6):
        raise ValueError("rod_shape_fused supports na in (3, 6)")
    _check_width(cfg, True, "rod_shape_fused_wide")
    qes = check_qes(qes, cfg, precision)
    if not on_cuda(qes, "rod_shape_fused_wide"):
        return rod_shape_fused_plain(qes, cfg, iters)
    c = constants(cfg, qes.device)
    q, r = _launch_fused(build_wide_library().rod_shape_fused_wide_f32, c.gt, qes, cfg, c,
                         iters, "rod_shape_fused_wide")
    rod_shape_fused_wide.launches += 1
    return q, r


rod_shape_fused_wide.launches = 0


def check_state(v, like: torch.Tensor, dim: int, what: str) -> torch.Tensor:
    """A per-rod boundary value ``(B, dim)`` as a contiguous f32 tensor on
    ``like``'s device (16-byte aligned for the kernels' vector loads)."""
    v = torch.as_tensor(v).to(device=like.device, dtype=torch.float32).contiguous()
    if tuple(v.shape) != (like.shape[0], dim):
        raise ValueError(f"{what} must be ({like.shape[0]}, {dim}), got {tuple(v.shape)}")
    if like.device.type == "cuda" and v.data_ptr() % 16:
        v = v.clone()
    return v


def _check_bc(qes, q_init, r_init, cfg: RodConfig, precision: str):
    if cfg.na not in (3, 6):
        raise ValueError("rod_shape_fused_bc supports na in (3, 6)")
    qes = check_qes(qes, cfg, precision)
    return (qes, check_state(q_init, qes, 4, "q_init"),
            check_state(r_init, qes, 3, "r_init"))


def rod_shape_fused_bc(qes, q_init, r_init, cfg: RodConfig = RodConfig(),
                       iters: int = 20, precision: str = "high"):
    """Fused rod solve with per-rod boundary conditions (K4).

    ``qes (B, na*ne)``, ``q_init (B, 4)``, ``r_init (B, 3)`` ->
    ``(Q (B, n-1, 4), r (B, n-1, 3))``, f32.  Same semantics as
    ``rod_shape(..., method='picard')`` with arbitrary initial states (``q0``
    is not normalised): the building block of the fused multi-segment chains.
    CUDA tensors run the kernel, CPU tensors its plain version.  Grids with
    32 < n-1 <= 512 go to K4 wide (:func:`rod_shape_fused_bc_wide`).
    """
    qes, q0, r0 = _check_bc(qes, q_init, r_init, cfg, precision)
    if is_wide(cfg.n - 1):
        return rod_shape_fused_bc_wide(qes, q0, r0, cfg, iters, precision)
    if not on_cuda(qes, "rod_shape_fused_bc"):
        return rod_shape_fused_bc_plain(qes, q0, r0, cfg, iters)
    c = constants(cfg, qes.device)
    q, r = _launch_fused(build_library().rod_shape_fused_bc_f32, c.gtp, qes, cfg, c, iters,
                         "rod_shape_fused_bc", (q0, r0))
    rod_shape_fused_bc.launches += 1
    return q, r


rod_shape_fused_bc.launches = 0


def rod_shape_fused_bc_wide(qes, q_init, r_init, cfg: RodConfig = RodConfig(n=64),
                            iters: int = 20, precision: str = "high"):
    """K4 wide: :func:`rod_shape_fused_bc` on grids with 32 < n-1 <= 512
    (``csrc/rod_wide_kernel.cu``)."""
    _check_width(cfg, True, "rod_shape_fused_bc_wide")
    qes, q0, r0 = _check_bc(qes, q_init, r_init, cfg, precision)
    if not on_cuda(qes, "rod_shape_fused_bc_wide"):
        return rod_shape_fused_bc_plain(qes, q0, r0, cfg, iters)
    c = constants(cfg, qes.device)
    q, r = _launch_fused(build_wide_library().rod_shape_fused_bc_wide_f32, c.gt, qes, cfg, c,
                         iters, "rod_shape_fused_bc_wide", (q0, r0))
    rod_shape_fused_bc_wide.launches += 1
    return q, r


rod_shape_fused_bc_wide.launches = 0


def _check_rhs(qes: torch.Tensor, rhs, cfg: RodConfig, what: str) -> torch.Tensor:
    rhs = torch.as_tensor(rhs).to(device=qes.device, dtype=torch.float32).contiguous()
    npts = cfg.n - 1
    if tuple(rhs.shape) != (qes.shape[0], npts, 4):
        raise ValueError(f"rhs must be ({qes.shape[0]}, {npts}, 4), got "
                         f"{tuple(rhs.shape)}")
    if qes.device.type == "cuda" and rhs.data_ptr() % 16:
        raise ValueError(f"{what}: rhs must be 16-byte aligned")
    return rhs


def _launch_correction(entry, gmat, qes: torch.Tensor, rhs: torch.Tensor,
                       cfg: RodConfig, c: KernelConstants, iters: int, what: str):
    x = torch.empty_like(rhs)
    with torch.cuda.device(qes.device):
        err = entry(build.ptr(qes), qes.shape[0], c.npts, c.p, cfg.na * cfg.ne, cfg.ne,
                    build.ptr(gmat), build.ptr(c.ptab), build.ptr(rhs), int(iters),
                    build.ptr(x), build.stream_of(qes))
    build.check_launch(err, what)
    return x


def picard_correction_fused(qes, rhs, cfg: RodConfig = RodConfig(),
                            iters: int = 20, precision: str = "high"):
    """Fused solve of ``(I ⊗ Dn_NN - 1/2 A_hat(qe)) x = rhs`` per rod (K2).

    ``qes (B, na*ne)``, ``rhs (B, n-1, 4)`` -> ``x (B, n-1, 4)``, f32.  The
    inner solver of iterative refinement.  Grids with 32 < n-1 <= 512 go to
    K2 wide (:func:`picard_correction_fused_wide`).
    """
    qes = check_qes(qes, cfg, precision)
    if is_wide(cfg.n - 1):
        return picard_correction_fused_wide(qes, rhs, cfg, iters, precision)
    rhs = _check_rhs(qes, rhs, cfg, "picard_correction_fused")
    if not on_cuda(qes, "picard_correction_fused"):
        return picard_correction_plain(qes, rhs, cfg, iters)
    c = constants(cfg, qes.device)
    x = _launch_correction(build_library().picard_correction_f32, c.gtp, qes, rhs, cfg, c,
                           iters, "picard_correction_fused")
    picard_correction_fused.launches += 1
    return x


picard_correction_fused.launches = 0


def picard_correction_fused_wide(qes, rhs, cfg: RodConfig = RodConfig(n=64),
                                 iters: int = 20, precision: str = "high"):
    """K2 wide: :func:`picard_correction_fused` on grids with
    32 < n-1 <= 512 (``csrc/rod_wide_kernel.cu``)."""
    _check_width(cfg, True, "picard_correction_fused_wide")
    qes = check_qes(qes, cfg, precision)
    rhs = _check_rhs(qes, rhs, cfg, "picard_correction_fused_wide")
    if not on_cuda(qes, "picard_correction_fused_wide"):
        return picard_correction_plain(qes, rhs, cfg, iters)
    c = constants(cfg, qes.device)
    x = _launch_correction(build_wide_library().picard_correction_wide_f32, c.gt, qes, rhs,
                           cfg, c, iters, "picard_correction_fused_wide")
    picard_correction_fused_wide.launches += 1
    return x


picard_correction_fused_wide.launches = 0
