"""K3: the whole refined rod solve in one kernel.

Sources: ``csrc/refined_kernel.cu`` (narrow grids, n-1 <= 32) and
``csrc/refined_wide_kernel.cu`` (K3 wide, 32 < n-1 <= 512).  They replace
the JAX package's Pallas TPU kernel ``ops/pallas/refined_kernel.py``
``rod_shape_refined_kernel`` (bodies ``_kernel``, ``_kernel_wide_refined``
and ``_kernel_pair_refined``, which differ only in how they pack rods onto
the TPU's tiles), the headline path of ``rod_shape_refined_fused``:

1. ``K = Phi (qe_hi + qe_lo)`` in FP64 from the f64 basis table;
2. f32 Picard base solve ``s`` (as K1, with ``K/2`` rounded to f32);
3. the residual ``rhs - Dn_NN s + 1/2 A(K) s`` in FP64;
4. an f32 Picard correction ``delta`` of that residual;
5. ``x = s + delta`` in FP64 (exact), the FP64 unnormalized tangent
   (``R(x) e1``, or ``R(x)(e1 + gamma)`` for na=6) and the FP64 position
   ``r = G b``;
6. outputs split into f32 pairs ``(hi, lo)``; a rod whose
   ``max_i |K_i| L/2`` exceeds ``check_rho`` comes back NaN in all four.

On the TPU steps 3 and 5 needed int8 Ozaki planes and double-word EFTs,
and the kernel NaN-poisoned states outside the int8 windows (``|s| >= 3.96``,
``|b| >= 7.92``).  With native FP64 neither the planes nor those window
tests exist here; the rho sentinel stays.

What bounds it on an H100: the two f32 Picard loops are K1's FP32-FMA work
(~2 x 21,600 FMAs per rod at N=16); the FP64 residual and position add
15*15*4 + 15*15*3 = 1,575 FP64 FMAs per rod at half the FP32 rate, and the
traffic is ~ 72 bytes in and 15 x 14 x 4 = 840 bytes out per rod; it is
FMA bound.  Same design as K1 (one P-lane group per rod, a lane per point,
G's f32 row in registers), plus ``Dn_NN`` and ``G`` in FP64 in shared
memory, stored transposed so that a column read is one conflict-free
row of doubles.  K3 wide runs the f32 loops as K1 wide does (a rod spans
several warps, G^T streamed through L1/L2 against a shared-memory panel),
reads ``Dn_NN^T`` and ``G^T`` in FP64 from device memory for the two FP64
products, and takes the rho sentinel's max with a shared-memory atomic.

Beside the kernel: its plain PyTorch version (CPU tensors only in the
wrapper; a CUDA tensor launches the kernel or raises) and a launch count
(``rod_shape_refined_kernel.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import basis as basis_ops
from .. import doubledouble as dd
from ..device import canonical_device
from ..lie import quat_skew_apply, rod_tangent
from ...models.rod import RodConfig
from . import build
from . import rod_kernel as rk

__all__ = ["rod_shape_refined_kernel", "rod_shape_refined_kernel_wide",
           "rod_shape_refined_plain", "build_library", "build_wide_library"]

_I, _P, _D = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
_SIGNATURES = {
    # qes_hi, qes_lo, B, npts, P, na, ne, g32, gvec32, g64, dn64, ptab64,
    # din64, iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo, stream
    "rod_shape_refined": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _I, _I, _D, _P, _P, _P, _P, _P],
}
# Same arguments, with the transposed operators G^T (f32, f64) and Dn_NN^T.
_WIDE_SIGNATURES = {"rod_shape_refined_wide": _SIGNATURES["rod_shape_refined"]}


@functools.lru_cache(maxsize=None)
def build_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/refined_kernel.cu``."""
    return build.load_library("refined_kernel", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def build_wide_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/refined_wide_kernel.cu``."""
    return build.load_library("refined_wide_kernel", _WIDE_SIGNATURES)


@dataclass(frozen=True, eq=False)
class RefinedConstants:
    """K1's f32 operators plus the f64 ones, zero-padded to ``P`` points."""

    f32: rk.KernelConstants
    g64: torch.Tensor      # (P, P) G
    dn64: torch.Tensor     # (P, P) Dn_NN
    ptab64: torch.Tensor   # (P, ne) basis table
    din64: torch.Tensor    # (P,) dn_in
    g64t: torch.Tensor | None    # (P, P) G^T, wide grids only
    dn64t: torch.Tensor | None   # (P, P) Dn_NN^T, wide grids only


@functools.lru_cache(maxsize=None)
def _constants(cfg: RodConfig, device: torch.device) -> RefinedConstants:
    ginv, dn_nn, dn_in, table = rk.host_operators(cfg)
    c32 = rk.constants(cfg, device)
    p, f64 = c32.p, torch.float64
    wide = rk.is_wide(c32.npts)
    return RefinedConstants(
        f32=c32,
        g64=rk.padded(ginv, (p, p), f64, device),
        dn64=rk.padded(dn_nn, (p, p), f64, device),
        ptab64=rk.padded(table, (p, cfg.ne), f64, device),
        din64=rk.padded(dn_in, (p,), f64, device),
        g64t=rk.padded(ginv.T, (p, p), f64, device) if wide else None,
        dn64t=rk.padded(dn_nn.T, (p, p), f64, device) if wide else None,
    )


def constants(cfg: RodConfig, device) -> RefinedConstants:
    return _constants(cfg, canonical_device(device))


def _rho2_limit(check_rho: float | None, cfg: RodConfig) -> float:
    """``(check_rho / L)^2``, compared with ``max_i |K_i / 2|^2``; -1 disables."""
    return -1.0 if check_rho is None else float((check_rho / cfg.length) ** 2)


def rod_shape_refined_plain(qes: torch.Tensor, qes_lo: torch.Tensor | None = None,
                            cfg: RodConfig = RodConfig(), iters: int = 20,
                            corr_iters: int = 20, check_rho: float | None = 5.0):
    """Plain PyTorch version of K3 (same math, any device)."""
    c = constants(cfg, qes.device)
    n1 = c.f32.npts
    g32 = c.f32.g[:n1, :n1]
    qe64 = qes.to(torch.float64)
    if qes_lo is not None:
        qe64 = qe64 + qes_lo.to(torch.float64)
    k64 = basis_ops.strain_at_points(qe64, c.ptab64[:n1])
    kh64 = 0.5 * k64[..., :3]
    kh32 = kh64.to(torch.float32)

    s = rk.picard_plain(g32, kh32, rk.demo_g_rhs(c.f32.gvec[:n1], qes.shape[0]), iters)
    limit = _rho2_limit(check_rho, cfg)
    bad = (kh32 * kh32).sum(-1).amax(-1) > limit if limit >= 0 else None

    s64 = s.to(torch.float64)
    rhs64 = torch.zeros_like(s64)
    rhs64[..., 0] = -c.din64[:n1]
    res = rhs64 - torch.matmul(c.dn64[:n1, :n1], s64) + quat_skew_apply(kh64, s64)
    delta = rk.picard_plain(g32, kh32, torch.matmul(g32, res.to(torch.float32)), corr_iters)
    x64 = s64 + delta.to(torch.float64)

    b64 = rod_tangent(x64, k64[..., 3:6] if cfg.na == 6 else None)
    r64 = torch.matmul(c.g64[:n1, :n1], b64)
    outs = [*dd.split_f64(x64), *dd.split_f64(r64)]
    if bad is not None:
        outs = [o.masked_fill(bad[:, None, None], float("nan")) for o in outs]
    return tuple(outs)


def _check_inputs(qes, qes_lo, cfg: RodConfig):
    if cfg.na not in (3, 6):
        raise ValueError("the refined kernel supports na in (3, 6)")
    qes = rk.check_qes(qes, cfg)
    if qes_lo is not None:
        qes_lo = torch.as_tensor(qes_lo).to(device=qes.device, dtype=torch.float32)
        qes_lo = qes_lo.contiguous()
        if qes_lo.shape != qes.shape:
            raise ValueError(f"qes_lo must match qes {tuple(qes.shape)}, got "
                             f"{tuple(qes_lo.shape)}")
    return qes, qes_lo


def _launch(entry, qes, qes_lo, cfg: RodConfig, iters: int, corr_iters: int,
            check_rho: float | None, what: str):
    c = constants(cfg, qes.device)
    b, n1 = qes.shape[0], c.f32.npts
    q = torch.empty((2, b, n1, 4), dtype=torch.float32, device=qes.device)
    r = torch.empty((2, b, n1, 3), dtype=torch.float32, device=qes.device)
    if rk.is_wide(n1):   # the wide kernel reads the operators' columns
        g32, g64, dn64 = c.f32.gt, c.g64t, c.dn64t
    else:
        g32, g64, dn64 = c.f32.g, c.g64, c.dn64
    p = build.ptr
    with torch.cuda.device(qes.device):
        err = entry(
            p(qes), p(qes_lo), b, n1, c.f32.p, cfg.na, cfg.ne, p(g32),
            p(c.f32.gvec), p(g64), p(dn64), p(c.ptab64), p(c.din64),
            int(iters), int(corr_iters), _rho2_limit(check_rho, cfg),
            p(q[0]), p(q[1]), p(r[0]), p(r[1]), build.stream_of(qes))
    build.check_launch(err, what)
    return q[0], q[1], r[0], r[1]


def rod_shape_refined_kernel(qes, qes_lo=None, cfg: RodConfig = RodConfig(),
                             iters: int = 20, corr_iters: int = 20,
                             check_rho: float | None = 5.0):
    """Fully fused refined solve (K3).

    ``qes (B, na*ne)`` (+ optional low word ``qes_lo`` from
    ``rod.split_strain``) -> ``(q_hi, q_lo, r_hi, r_lo)``, each
    ``(B, n-1, dim)`` f32: pairs whose f64 sum is the refined solution.
    Rods with ``max|K| L/2 > check_rho`` come back NaN (``None``: no check).
    Grids with 32 < n-1 <= 512 go to K3 wide
    (:func:`rod_shape_refined_kernel_wide`).
    """
    qes, qes_lo = _check_inputs(qes, qes_lo, cfg)
    if rk.is_wide(cfg.n - 1):
        return rod_shape_refined_kernel_wide(qes, qes_lo, cfg, iters, corr_iters, check_rho)
    if not rk.on_cuda(qes, "rod_shape_refined_kernel"):
        return rod_shape_refined_plain(qes, qes_lo, cfg, iters, corr_iters, check_rho)
    outs = _launch(build_library().rod_shape_refined, qes, qes_lo, cfg, iters, corr_iters,
                   check_rho, "rod_shape_refined_kernel")
    rod_shape_refined_kernel.launches += 1
    return outs


rod_shape_refined_kernel.launches = 0


def rod_shape_refined_kernel_wide(qes, qes_lo=None, cfg: RodConfig = RodConfig(n=64),
                                  iters: int = 20, corr_iters: int = 20,
                                  check_rho: float | None = 5.0):
    """K3 wide: :func:`rod_shape_refined_kernel` on grids with
    32 < n-1 <= 512 (``csrc/refined_wide_kernel.cu``)."""
    rk._check_width(cfg, True, "rod_shape_refined_kernel_wide")
    qes, qes_lo = _check_inputs(qes, qes_lo, cfg)
    if not rk.on_cuda(qes, "rod_shape_refined_kernel_wide"):
        return rod_shape_refined_plain(qes, qes_lo, cfg, iters, corr_iters, check_rho)
    outs = _launch(build_wide_library().rod_shape_refined_wide, qes, qes_lo, cfg, iters,
                   corr_iters, check_rho, "rod_shape_refined_kernel_wide")
    rod_shape_refined_kernel_wide.launches += 1
    return outs


rod_shape_refined_kernel_wide.launches = 0
