"""Roofline arithmetic of the port's narrow kernels K1, K2 and K3.

The work of one launch is counted from its shapes and the solver settings
that the configuration fixes (the counts of ``chip_smoke.py``'s ``k1_bound``,
``k2_bound`` and ``k3_bound``):

* ``mat``: float32 multiply-adds of the matrix products (``G`` or ``Dn``
  against a panel), which the kernels run on the tensor cores;
* ``f32``: the other float32 multiply-adds (the strain field, ``A(K/2)``);
* ``f64``: float64 multiply-adds (K3's residual and position);
* ``bytes``: each input read once and each output written once.

Each class is priced at the published peak of the unit that can run it on
one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit): the
matrix products at the TF32 tensor-core rate (495 TFLOP/s; any f32-accurate
scheme does at least this work), the float64 work at the FP64 tensor-core
rate (67 TFLOP/s), the other float32 work at the FP32 rate (67 TFLOP/s),
bytes at 3.35 TB/s; an FMA is 2 FLOP.  An implementation may run any two
classes on different units at once (the FP64 products on the FMA pipes
beside TF32 products on the tensor cores, say), so the least time is the
largest of the four times, not their sum: no implementation of the same
work can run faster than this bound.
"""

from __future__ import annotations

from typing import NamedTuple

TF32_PEAK = 495e12
FP32_PEAK = 67e12
FP64_PEAK = 67e12
HBM_RATE = 3.35e12


class Work(NamedTuple):
    mat: float
    f32: float
    f64: float
    bytes: float

    def __add__(self, other):
        return Work(*(a + b for a, b in zip(self, other)))

    def __mul__(self, k):
        return Work(*(a * k for a in self))


def picard_fma(n1: int, iters: int) -> tuple:
    """(matrix, other) float32 FMAs of ``iters`` Picard steps of one rod: G
    against 4 columns, and the 12-FMA ``A(K/2)`` action per point."""
    return iters * 4 * n1 * n1, iters * 12 * n1


def k1(b: int, n1: int, na: int, ne: int, iters: int) -> Work:
    """K1 ``rod_shape_fused``: ``b`` rods, ``n1 = n-1`` unknown points."""
    mat, other = picard_fma(n1, iters)
    return Work(b * (mat + 3 * n1 * n1), b * (na * ne * n1 + other), 0.0,
                4 * b * (na * ne + 7 * n1))


def k2(b: int, n1: int, nq: int, ne: int, iters: int) -> Work:
    """K2 ``picard_correction_fused``: ``b`` right-hand sides."""
    mat, other = picard_fma(n1, iters)
    return Work(b * (mat + 4 * n1 * n1), b * (3 * ne * n1 + other), 0.0,
                4 * b * (nq + 8 * n1))


def k3(b: int, n1: int, na: int, ne: int, iters: int, corr_iters: int) -> Work:
    """K3 ``rod_shape_refined_kernel``: ``b`` rods, base and correction solves."""
    mat, other = picard_fma(n1, iters + corr_iters)
    f64 = b * (na * ne * n1 + 4 * n1 * n1 + 12 * n1 + 3 * n1 * n1)
    return Work(b * (mat + 4 * n1 * n1), b * other, f64, 4 * b * (2 * na * ne + 14 * n1))


def ops_seconds(w: Work) -> float:
    """Least time of the operations alone: the slowest class at its peak."""
    return max(2 * w.mat / TF32_PEAK, 2 * w.f32 / FP32_PEAK, 2 * w.f64 / FP64_PEAK)


def bound_seconds(w: Work) -> float:
    """Least time of the work on the card: operations or bytes."""
    return max(ops_seconds(w), w.bytes / HBM_RATE)


def share_pct(w: Work, seconds: float) -> float | None:
    """The bound as a share of a measured time, in %; None without a time."""
    if not seconds > 0:
        return None
    return 100.0 * bound_seconds(w) / seconds
