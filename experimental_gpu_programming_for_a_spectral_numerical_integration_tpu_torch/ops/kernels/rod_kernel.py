"""K1 and K2: the fused f32 rod solve and its general right-hand-side solve.

Source: ``csrc/rod_kernel.cu``.  They replace the JAX package's Pallas TPU
kernels in ``ops/pallas/rod_kernel.py``:

* K1 ``rod_shape_fused`` (body ``_kernel``): ``qe -> K = Phi qe`` -> f32
  Picard fixed point ``s = G rhs + G (1/2 A(K)) s`` with the demo boundary
  conditions ``q0 = (1,0,0,0)``, ``r0 = 0`` -> unnormalized tangent
  ``R(s) e1`` (``R(s)(e1 + gamma)`` for na=6) -> position ``r = G b``;
* K2 ``picard_correction_fused`` (body ``_corr_kernel``): the same Picard
  operator for a per-rod right-hand side, ``(I ⊗ Dn_NN - 1/2 A_hat) x = rhs``,
  reading only the 3 curvature components of ``qe``.

What bounds them on an H100: at N=16 a rod costs about 20 x (15*15*4 +
15*12) = 21,600 FP32 FMAs against ~456 bytes of device traffic (9 floats
in, 15 x 7 floats out), about 47 FMAs per byte, far above the card's
~10 FP32 FLOP per byte of HBM bandwidth: they are FP32-FMA bound.  The
design therefore keeps every operand on chip: one group of P = 8, 16 or
32 lanes per rod (P the next power of two >= n-1; 2 rods per warp at
N=16), lane i owns point i's quaternion, its curvature and row i of G in
registers; each Picard step exchanges the 4-vector ``A(K) s`` through a
per-rod shared-memory slot (one broadcast 16-byte load per column j), so
the inner loop is 4 FMAs per shared load and device memory sees only ``qe``
in and the result out.  The TPU layout (128-sublane rod packing, the
bf16x3 matmul emulation) does not carry over.

Arithmetic is plain FP32 FMA for every ``precision`` value the JAX API
accepts ('float32', 'high', 'default', 'highest'): the TPU's bf16 pass
count has no Hopper counterpart.  Tensor cores for the G products are
later work.

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
from ..collocation import canonical_device
from ..lie import quat_skew_apply, rod_tangent
from ...models.rod import RodConfig
from . import build

__all__ = ["rod_shape_fused", "rod_shape_fused_plain",
           "picard_correction_fused", "picard_correction_plain",
           "PRECISIONS", "MAX_POINTS", "build_library"]

PRECISIONS = ("float32", "high", "default", "highest")
MAX_POINTS = 32

_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    # qes, B, npts, P, na, ne, g, ptab, gvec, iters, q_out, r_out, stream
    "rod_shape_fused_f32": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    # qes, B, npts, P, nq, ne, g, ptab, rhs, iters, x_out, stream
    "picard_correction_f32": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def build_library() -> ctypes.CDLL:
    """Compile (once per process) and load ``csrc/rod_kernel.cu``."""
    return build.load_library("rod_kernel", _SIGNATURES)


def lanes_per_rod(npts: int) -> int:
    """P: the next power of two >= n-1 (8, 16 or 32 lanes per rod)."""
    for p in (8, 16, 32):
        if npts <= p:
            return p
    raise ValueError(
        f"the CUDA rod kernels cover n-1 <= {MAX_POINTS} points (got "
        f"{npts}); larger grids wait for the wide-grid kernels "
        "(ROADMAP.md Queue 2, K1-K3 wide and paired)")


@dataclass(frozen=True, eq=False)
class KernelConstants:
    """f32 operators zero-padded to ``P`` points (padding keeps every
    padded point at exactly zero through the whole solve)."""

    npts: int
    p: int
    g: torch.Tensor        # (P, P) G = Dn_NN^{-1}
    ptab: torch.Tensor     # (P, ne) basis table at the unknown points
    gvec: torch.Tensor     # (P,) G (-dn_in): G rhs for q0 = (1,0,0,0)


def host_operators(cfg: RodConfig):
    """f64 host constants of the rod's grid: ``(G, Dn_NN, dn_in, P table)``."""
    from .. import chebyshev

    dn = chebyshev.diff_matrix(cfg.n, cfg.length)
    dn_nn, dn_in = chebyshev.split_endpoint(dn, "last")
    ginv = chebyshev.integration_matrix(cfg.n, cfg.length)
    return ginv, dn_nn, dn_in[:, 0], cfg.basis_table


def padded(a: np.ndarray, shape, dtype, device) -> torch.Tensor:
    out = np.zeros(shape, np.float64)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return torch.tensor(out, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _constants(cfg: RodConfig, device: torch.device) -> KernelConstants:
    ginv, _, dn_in, table = host_operators(cfg)
    npts = cfg.n - 1
    p = lanes_per_rod(npts)
    f32 = torch.float32
    return KernelConstants(
        npts=npts, p=p,
        g=padded(ginv, (p, p), f32, device),
        ptab=padded(table, (p, cfg.ne), f32, device),
        gvec=padded(-(ginv @ dn_in), (p,), f32, device),
    )


def constants(cfg: RodConfig, device) -> KernelConstants:
    return _constants(cfg, canonical_device(device))


def check_qes(qes, cfg: RodConfig, precision: str = "high") -> torch.Tensor:
    """Validate a strain batch for the kernels: 2-D ``(B, na*ne)``, B > 0,
    n-1 <= 32; returns it as a contiguous f32 tensor."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    qes = torch.as_tensor(qes).to(torch.float32).contiguous()
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


def rod_shape_fused_plain(qes: torch.Tensor, cfg: RodConfig = RodConfig(),
                          iters: int = 20):
    """Plain PyTorch version of K1 (same math, any device)."""
    c = constants(cfg, qes.device)
    n1 = c.npts
    g = c.g[:n1, :n1]
    k = basis_ops.strain_at_points(qes, c.ptab[:n1])
    s = picard_plain(g, 0.5 * k[..., :3], demo_g_rhs(c.gvec[:n1], qes.shape[0]), iters)
    b = rod_tangent(s, k[..., 3:6] if cfg.na == 6 else None)
    return s, torch.matmul(g, b)


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


def rod_shape_fused(qes, cfg: RodConfig = RodConfig(), iters: int = 20,
                    precision: str = "high"):
    """Batched fused rod solve (K1): ``qes (B, na*ne) -> (Q (B, n-1, 4), r (B, n-1, 3))``.

    Same semantics as ``rod_shape(..., method='picard')`` with the demo
    boundary conditions; f32 throughout.  CUDA tensors run the kernel, CPU
    tensors its plain version.
    """
    if cfg.na not in (3, 6):
        raise ValueError("rod_shape_fused supports na in (3, 6)")
    qes = check_qes(qes, cfg, precision)
    if not on_cuda(qes, "rod_shape_fused"):
        return rod_shape_fused_plain(qes, cfg, iters)
    c = constants(cfg, qes.device)
    lib = build_library()
    b = qes.shape[0]
    q = torch.empty((b, c.npts, 4), dtype=torch.float32, device=qes.device)
    r = torch.empty((b, c.npts, 3), dtype=torch.float32, device=qes.device)
    with torch.cuda.device(qes.device):
        err = lib.rod_shape_fused_f32(
            build.ptr(qes), b, c.npts, c.p, cfg.na, cfg.ne, build.ptr(c.g),
            build.ptr(c.ptab), build.ptr(c.gvec), int(iters), build.ptr(q),
            build.ptr(r), build.stream_of(qes))
    build.check_launch(err, "rod_shape_fused")
    rod_shape_fused.launches += 1
    return q, r


rod_shape_fused.launches = 0


def picard_correction_fused(qes, rhs, cfg: RodConfig = RodConfig(),
                            iters: int = 20, precision: str = "high"):
    """Fused solve of ``(I ⊗ Dn_NN - 1/2 A_hat(qe)) x = rhs`` per rod (K2).

    ``qes (B, na*ne)``, ``rhs (B, n-1, 4)`` -> ``x (B, n-1, 4)``, f32.  The
    inner solver of iterative refinement.
    """
    qes = check_qes(qes, cfg, precision)
    rhs = torch.as_tensor(rhs).to(device=qes.device, dtype=torch.float32).contiguous()
    npts = cfg.n - 1
    if tuple(rhs.shape) != (qes.shape[0], npts, 4):
        raise ValueError(f"rhs must be ({qes.shape[0]}, {npts}, 4), got "
                         f"{tuple(rhs.shape)}")
    if not on_cuda(qes, "picard_correction_fused"):
        return picard_correction_plain(qes, rhs, cfg, iters)
    if rhs.data_ptr() % 16:
        raise ValueError("picard_correction_fused: rhs must be 16-byte aligned")
    c = constants(cfg, qes.device)
    lib = build_library()
    x = torch.empty_like(rhs)
    with torch.cuda.device(qes.device):
        err = lib.picard_correction_f32(
            build.ptr(qes), qes.shape[0], npts, c.p, cfg.na * cfg.ne, cfg.ne,
            build.ptr(c.g), build.ptr(c.ptab), build.ptr(rhs), int(iters),
            build.ptr(x), build.stream_of(qes))
    build.check_launch(err, "picard_correction_fused")
    picard_correction_fused.launches += 1
    return x


picard_correction_fused.launches = 0
