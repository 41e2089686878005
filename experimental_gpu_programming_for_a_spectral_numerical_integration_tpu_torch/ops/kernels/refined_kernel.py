"""K3 and K5: the whole refined rod solve in one kernel.

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

K5 ``rod_shape_refined_kernel_bc`` (the same bodies with ``bc=True``) is K3
with per-rod boundary values given as f32 pairs, ``q0 = q0_hi + q0_lo`` and
``r0 = r0_hi + r0_lo``: the f32 base solve starts from ``gvec32 ⊗ q0_hi``,
the FP64 residual's right-hand side is ``-dn_in ⊗ q0`` and the FP64 position
is ``G b + gvec64 ⊗ r0`` (``gvec64 = -G dn_in``), so the multi-segment
accuracy chain (``models/segments.py``, ``method='refined_fused'``) never
drops a junction to f32.

On the TPU steps 3 and 5 needed int8 Ozaki planes and double-word EFTs,
and the kernel NaN-poisoned states outside the int8 windows (``|s| >= 3.96``,
``|b| >= 7.92``).  With native FP64 neither the planes nor those window
tests exist here; the rho sentinel stays.

What bounds them on an H100: at N=16 a rod costs two f32 Picard loops and
``G res`` (41 products with G of 15*15*4 multiply-adds at 20/20 iterations,
and 12 per point and step in ``A(K/2)``), ~1,600 FP64 multiply-adds in the
residual's ``Dn_NN s`` and the position's ``G b``, against ~72 bytes in and
15 x 14 x 4 = 840 bytes out: operations bound.  The narrow kernels run on
the narrow tensor-core core of K1/K2/K4 (``csrc/narrow_tc.cuh``): the base
solve is K1's loop and the correction K2's, each step of a warp's 8 or 16
rods one transposed 3xTF32 ``mma.sync`` product whose state stays in the
registers (G^T's rows in :func:`rod_kernel.mma_k_order`, the same
``KernelConstants.gtp`` planes).  Their FP64 products run on the FP64 tensor
cores (DMMA, ``mma.sync.m8n8k4.f64``) in the same layout, so that a thread's
own state values are its A fragments and its C fragments its own points:
``Dn_NN`` and ``G`` are passed in :func:`dmma_order`.  K3 wide and K5 wide
run the f32 products on the wide core (``csrc/tc_picard.cuh``): 3xTF32
``mma.sync`` tiles, G^T and the panel in shared memory, each operand split
as ``hi = tf32(x)``, ``lo = tf32(x - hi)`` and the product summed as
``G_lo T_hi + G_hi T_lo + G_hi T_hi`` (one TF32 pass would miss the 1e-8
gate), each 16-deep step in a fresh tile added to the state in FP32 (the
tensor cores' own FP32 sum truncates).  They read ``Dn_NN^T`` and ``G^T`` in
FP64 from device memory for the two FP64 products, and take the rho
sentinel's max with a shared-memory atomic.

Beside each kernel: its plain PyTorch version (CPU tensors only in the
wrapper; a CUDA tensor launches the kernel or raises) and a launch count
(``rod_shape_refined_kernel.launches``, ``rod_shape_refined_kernel_bc.launches``
and their wide twins).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import basis as basis_ops
from .. import doubledouble as dd
from ..device import canonical_device
from ..lie import quat_skew_apply, rod_tangent
from ...models.rod import RodConfig
from . import build
from . import rod_kernel as rk

__all__ = ["rod_shape_refined_kernel", "rod_shape_refined_kernel_wide",
           "rod_shape_refined_plain", "rod_shape_refined_kernel_bc",
           "rod_shape_refined_kernel_bc_wide", "rod_shape_refined_bc_plain",
           "dmma_order", "build_library", "build_wide_library"]

_I, _P, _D = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
_SIGNATURES = {
    # qes_hi, qes_lo, B, npts, P, na, ne, gtp, gvec32, g64, dn64, ptab64,
    # din64, iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo, stream
    "rod_shape_refined": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _I, _I, _D, _P, _P, _P, _P, _P],
    # qes_hi, qes_lo, q0_hi, q0_lo, r0_hi, r0_lo, B, npts, P, na, ne, gtp,
    # gvec32, g64, dn64, ptab64, din64, gvec64, iters, corr_iters,
    # rho2_limit, q_hi, q_lo, r_hi, r_lo, stream
    "rod_shape_refined_bc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P, _P, _I, _I, _D, _P, _P, _P, _P, _P],
}
# Same arguments, with the transposed operators G^T (f32, f64) and Dn_NN^T
# in place of gtp, g64 and dn64.
_WIDE_SIGNATURES = {"rod_shape_refined_wide": _SIGNATURES["rod_shape_refined"],
                    "rod_shape_refined_bc_wide": _SIGNATURES["rod_shape_refined_bc"]}


@functools.lru_cache(maxsize=None)
def build_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/refined_kernel.cu``."""
    return build.load_library("refined_kernel", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def build_wide_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/refined_wide_kernel.cu``."""
    return build.load_library("refined_wide_kernel", _WIDE_SIGNATURES)


def dmma_order(a: np.ndarray) -> np.ndarray:
    """A ``(P, P)`` operator in the order the narrow refined kernels read it
    as the B operand of their FP64 tensor-core products: entry
    ``((n * P/8 + k) * 32 + 4 g + t) * 2 + e`` is ``a[8n + g, 8k + 2t + e]``,
    so that thread ``(g, t)`` of a warp finds its two values of each
    (k-block, n-tile) side by side and the warp's 16-byte loads are
    consecutive."""
    nb = a.shape[0] // 8
    return a.reshape(nb, 8, nb, 4, 2).transpose(0, 2, 1, 3, 4).reshape(a.shape)


@dataclass(frozen=True, eq=False)
class RefinedConstants:
    """K1's f32 operators plus the f64 ones, zero-padded to ``P`` points."""

    f32: rk.KernelConstants
    g64: torch.Tensor      # (P, P) G
    dn64: torch.Tensor     # (P, P) Dn_NN
    ptab64: torch.Tensor   # (P, ne) basis table
    din64: torch.Tensor    # (P,) dn_in
    gvec64: torch.Tensor   # (P,) -G dn_in: G rhs for q0 = (1,0,0,0) (K5's r0 term)
    # (P, P) the FP64 operators as the kernel reads them: G^T and Dn_NN^T on
    # wide grids, G and Dn_NN in dmma_order on narrow ones
    g64k: torch.Tensor
    dn64k: torch.Tensor


@functools.lru_cache(maxsize=None)
def _constants(cfg: RodConfig, device: torch.device) -> RefinedConstants:
    ginv, dn_nn, dn_in, table = rk.host_operators(cfg)
    c32 = rk.constants(cfg, device)
    p, f64 = c32.p, torch.float64
    npts = c32.npts

    def kernel_layout(a):
        if rk.is_wide(npts):
            return rk.padded(a.T, (p, p), f64, device)
        return torch.tensor(dmma_order(np.pad(a, (0, p - npts))), dtype=f64, device=device)

    return RefinedConstants(
        f32=c32,
        g64=rk.padded(ginv, (p, p), f64, device),
        dn64=rk.padded(dn_nn, (p, p), f64, device),
        ptab64=rk.padded(table, (p, cfg.ne), f64, device),
        din64=rk.padded(dn_in, (p,), f64, device),
        gvec64=rk.padded(-(ginv @ dn_in), (p,), f64, device),
        g64k=kernel_layout(ginv),
        dn64k=kernel_layout(dn_nn),
    )


def constants(cfg: RodConfig, device) -> RefinedConstants:
    return _constants(cfg, canonical_device(device))


def _rho2_limit(check_rho: float | None, cfg: RodConfig) -> float:
    """``(check_rho / L)^2``, compared with ``max_i |K_i / 2|^2``; -1 disables."""
    return -1.0 if check_rho is None else float((check_rho / cfg.length) ** 2)


def _pair64(hi: torch.Tensor, lo: torch.Tensor | None) -> torch.Tensor:
    return hi.to(torch.float64) if lo is None else dd.join_f64(hi, lo)


def rod_shape_refined_bc_plain(qes: torch.Tensor, q_init: torch.Tensor | None,
                               r_init: torch.Tensor | None,
                               qes_lo: torch.Tensor | None = None,
                               q_init_lo: torch.Tensor | None = None,
                               r_init_lo: torch.Tensor | None = None,
                               cfg: RodConfig = RodConfig(), iters: int = 20,
                               corr_iters: int = 20, check_rho: float | None = 5.0):
    """Plain PyTorch version of K5 (same math, any device).  ``None`` for
    ``q_init``/``r_init`` stands for the demo values ``(1,0,0,0)``/``0``."""
    c = constants(cfg, qes.device)
    n1 = c.f32.npts
    g32, gvec32 = c.f32.g[:n1, :n1], c.f32.gvec[:n1]
    k64 = basis_ops.strain_at_points(_pair64(qes, qes_lo), c.ptab64[:n1])
    kh64 = 0.5 * k64[..., :3]
    kh32 = kh64.to(torch.float32)

    g_rhs = (rk.demo_g_rhs(gvec32, qes.shape[0]) if q_init is None
             else gvec32[:, None] * q_init[:, None, :])
    s = rk.picard_plain(g32, kh32, g_rhs, iters)
    limit = _rho2_limit(check_rho, cfg)
    bad = (kh32 * kh32).sum(-1).amax(-1) > limit if limit >= 0 else None

    s64 = s.to(torch.float64)
    if q_init is None:
        rhs64 = torch.zeros_like(s64)
        rhs64[..., 0] = -c.din64[:n1]
    else:
        rhs64 = -c.din64[:n1, None] * _pair64(q_init, q_init_lo)[:, None, :]
    res = rhs64 - torch.matmul(c.dn64[:n1, :n1], s64) + quat_skew_apply(kh64, s64)
    delta = rk.picard_plain(g32, kh32, torch.matmul(g32, res.to(torch.float32)), corr_iters)
    x64 = s64 + delta.to(torch.float64)

    b64 = rod_tangent(x64, k64[..., 3:6] if cfg.na == 6 else None)
    r64 = torch.matmul(c.g64[:n1, :n1], b64)
    if r_init is not None:
        r64 = r64 + c.gvec64[:n1, None] * _pair64(r_init, r_init_lo)[:, None, :]
    outs = [*dd.split_f64(x64), *dd.split_f64(r64)]
    if bad is not None:
        outs = [o.masked_fill(bad[:, None, None], float("nan")) for o in outs]
    return tuple(outs)


def rod_shape_refined_plain(qes: torch.Tensor, qes_lo: torch.Tensor | None = None,
                            cfg: RodConfig = RodConfig(), iters: int = 20,
                            corr_iters: int = 20, check_rho: float | None = 5.0):
    """Plain PyTorch version of K3: K5's with the demo boundary values."""
    return rod_shape_refined_bc_plain(qes, None, None, qes_lo, cfg=cfg, iters=iters,
                                      corr_iters=corr_iters, check_rho=check_rho)


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


def _check_bc(qes, q_init, r_init, qes_lo, q_init_lo, r_init_lo, cfg: RodConfig):
    """Validated K5 inputs: the strain pair, then the boundary pairs ``(q0_hi,
    q0_lo, r0_hi, r0_lo)`` as ``(B, 4)``/``(B, 3)`` f32 (low words may be
    ``None``)."""
    qes, qes_lo = _check_inputs(qes, qes_lo, cfg)
    bc = tuple(None if v is None else rk.check_state(v, qes, dim, what)
               for v, dim, what in ((q_init, 4, "q_init"), (q_init_lo, 4, "q_init_lo"),
                                    (r_init, 3, "r_init"), (r_init_lo, 3, "r_init_lo")))
    if bc[0] is None or bc[2] is None:
        raise ValueError("rod_shape_refined_kernel_bc needs q_init and r_init")
    return qes, qes_lo, bc


def _launch(entry, qes, qes_lo, cfg: RodConfig, iters: int, corr_iters: int,
            check_rho: float | None, what: str, bc: tuple | None = None):
    """One K3 launch, or K5 with ``bc = (q0_hi, q0_lo, r0_hi, r0_lo)``."""
    c = constants(cfg, qes.device)
    b, n1 = qes.shape[0], c.f32.npts
    q = torch.empty((2, b, n1, 4), dtype=torch.float32, device=qes.device)
    r = torch.empty((2, b, n1, 3), dtype=torch.float32, device=qes.device)
    g32 = c.f32.gt if rk.is_wide(n1) else c.f32.gtp
    p = build.ptr
    states = () if bc is None else tuple(map(p, bc))
    gvec64 = () if bc is None else (p(c.gvec64),)
    with torch.cuda.device(qes.device):
        err = entry(
            p(qes), p(qes_lo), *states, b, n1, c.f32.p, cfg.na, cfg.ne, p(g32),
            p(c.f32.gvec), p(c.g64k), p(c.dn64k), p(c.ptab64), p(c.din64), *gvec64,
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


def rod_shape_refined_kernel_bc(qes, q_init, r_init, qes_lo=None, q_init_lo=None,
                                r_init_lo=None, cfg: RodConfig = RodConfig(),
                                iters: int = 20, corr_iters: int = 20,
                                tile: int | None = None, check_rho: float | None = 5.0):
    """Fully fused refined solve with per-rod boundary conditions (K5).

    ``qes (B, na*ne)``, ``q_init (B, 4)``, ``r_init (B, 3)``, each with an
    optional f32 low word carrying f64-grade input (junction states of a
    chain) -> ``(q_hi, q_lo, r_hi, r_lo)``, each ``(B, n-1, dim)`` f32.  As
    :func:`rod_shape_refined_kernel`, with the rho limit ``check_rho / L``
    of this grid's length.  ``tile`` is accepted so that calls written for
    the JAX package run unchanged, and ignored.  Grids with
    32 < n-1 <= 512 go to K5 wide (:func:`rod_shape_refined_kernel_bc_wide`).
    """
    if tile is not None and int(tile) <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    qes, qes_lo, bc = _check_bc(qes, q_init, r_init, qes_lo, q_init_lo, r_init_lo, cfg)
    if rk.is_wide(cfg.n - 1):
        return rod_shape_refined_kernel_bc_wide(qes, *bc[::2], qes_lo, *bc[1::2], cfg=cfg,
                                                iters=iters, corr_iters=corr_iters,
                                                check_rho=check_rho)
    if not rk.on_cuda(qes, "rod_shape_refined_kernel_bc"):
        return rod_shape_refined_bc_plain(qes, *bc[::2], qes_lo, *bc[1::2], cfg=cfg,
                                          iters=iters, corr_iters=corr_iters,
                                          check_rho=check_rho)
    outs = _launch(build_library().rod_shape_refined_bc, qes, qes_lo, cfg, iters, corr_iters,
                   check_rho, "rod_shape_refined_kernel_bc", bc)
    rod_shape_refined_kernel_bc.launches += 1
    return outs


rod_shape_refined_kernel_bc.launches = 0


def rod_shape_refined_kernel_bc_wide(qes, q_init, r_init, qes_lo=None, q_init_lo=None,
                                     r_init_lo=None, cfg: RodConfig = RodConfig(n=64),
                                     iters: int = 20, corr_iters: int = 20,
                                     check_rho: float | None = 5.0):
    """K5 wide: :func:`rod_shape_refined_kernel_bc` on grids with
    32 < n-1 <= 512 (``csrc/refined_wide_kernel.cu``)."""
    rk._check_width(cfg, True, "rod_shape_refined_kernel_bc_wide")
    qes, qes_lo, bc = _check_bc(qes, q_init, r_init, qes_lo, q_init_lo, r_init_lo, cfg)
    if not rk.on_cuda(qes, "rod_shape_refined_kernel_bc_wide"):
        return rod_shape_refined_bc_plain(qes, *bc[::2], qes_lo, *bc[1::2], cfg=cfg,
                                          iters=iters, corr_iters=corr_iters,
                                          check_rho=check_rho)
    outs = _launch(build_wide_library().rod_shape_refined_bc_wide, qes, qes_lo, cfg, iters,
                   corr_iters, check_rho, "rod_shape_refined_kernel_bc_wide", bc)
    rod_shape_refined_kernel_bc_wide.launches += 1
    return outs


rod_shape_refined_kernel_bc_wide.launches = 0
