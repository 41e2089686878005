"""Multi-segment rods: chained spectral solves with junction continuity.

Counterpart of the JAX package's ``models/segments.py``.  A segmented rod is
a sequence of :class:`~.rod.RodConfig` segments, base to tip, each with its
own grid order and length.  Continuity is enforced by construction: segment
``s`` starts from segment ``s-1``'s tip state (both are IVPs), so the
junction condition ``q_s(0) = q_{s-1}(L)``, ``r_s(0) = r_{s-1}(L)`` holds
exactly.  The tip of a segment is its point 0: the grid descends tip first.

:func:`segmented_rod_shape` chains every method of :func:`.rod.rod_shape`
('picard', 'dense', 'refined'), the fused f32 kernel with per-rod boundary
values ('fused', K4 narrow or wide) and the refined kernel with per-rod
boundary pairs ('refined_fused', K5 narrow or wide), whose junction states
stay f32 pairs (f64-grade) end to end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import basis as basis_ops
from ..ops import doubledouble as dd
from ..ops.device import as_tensor
from . import rod

__all__ = [
    "SegmentedRodConfig",
    "SegmentedSolution",
    "uniform_segments",
    "project_global_strain",
    "segmented_rod_shape",
    "high_order_shape",
]


@dataclass(frozen=True)
class SegmentedRodConfig:
    """An ordered tuple of :class:`~.rod.RodConfig` segments, base to tip.

    ``boundaries[s] = (begin, end)`` of segment ``s`` in arc length from
    the base.
    """

    segments: tuple

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def total_length(self) -> float:
        return float(sum(s.length for s in self.segments))

    @property
    def boundaries(self) -> tuple:
        out, start = [], 0.0
        for s in self.segments:
            out.append((start, start + s.length))
            start += s.length
        return tuple(out)


def uniform_segments(num_segments: int, n: int = 16, na: int = 3, ne: int = 3,
                     total_length: float = 1.0, basis: str = "legendre") -> SegmentedRodConfig:
    """``num_segments`` equal segments of ``total_length / num_segments``."""
    seg = rod.RodConfig(n=n, na=na, ne=ne, length=total_length / num_segments, basis=basis)
    return SegmentedRodConfig(segments=(seg,) * num_segments)


def project_global_strain(qe_global, cfg: SegmentedRodConfig,
                          global_ne: int | None = None,
                          basis: str = "legendre") -> np.ndarray:
    """Re-express a global modal strain field as per-segment modal strains.

    The global field ``K_a(X) = sum_e qe[a*ne+e] P_e(2X-1)`` on ``[0, 1]``
    is sampled on each segment's CGL nodes and fitted by least squares in
    the segment's own basis (exact whenever the segment's ``ne`` is at least
    the global one).  Host f64 NumPy: returns ``(..., S, na*ne_s)``.
    """
    qe_global = np.asarray(qe_global, np.float64)
    total = cfg.total_length
    out = []
    for seg, (begin, _) in zip(cfg.segments, cfg.boundaries):
        gne = global_ne or qe_global.shape[-1] // seg.na
        x_local = seg.points / seg.length
        x_global = (begin + x_local * seg.length) / total
        pg = basis_ops._BASES[basis](basis_ops.to_reference_domain(x_global), gne)
        k = np.einsum("pe,...ae->...pa", pg,
                      qe_global.reshape(qe_global.shape[:-1] + (seg.na, gne)))
        ps = basis_ops._BASES[basis](basis_ops.to_reference_domain(x_local), seg.ne)
        coef = np.einsum("ep,...pa->...ae", np.linalg.pinv(ps), k)
        out.append(coef.reshape(k.shape[:-2] + (seg.na * seg.ne,)))
    return np.stack(out, axis=-2)


@dataclass
class SegmentedSolution:
    """Per-segment point-major states (tip first within each segment) and
    the junction trace (each segment's tip, the last one the rod's tip).

    ``method='refined_fused'`` also fills the f32 pairs: ``quaternions_dd``
    and ``positions_dd`` per segment and ``junction_dd = ((q_hi, q_lo),
    (r_hi, r_lo))``; the chain's 1e-8-grade state is the pair, joined by
    :meth:`tip_quaternion_f64` / :meth:`tip_position_f64`.
    """

    quaternions: list              # S x (..., n_s - 1, 4)
    positions: list                # S x (..., n_s - 1, 3)
    junction_quaternions: torch.Tensor   # (..., S, 4)
    junction_positions: torch.Tensor     # (..., S, 3)
    quaternions_dd: list | None = None
    positions_dd: list | None = None
    junction_dd: tuple | None = None

    @property
    def tip_quaternion(self) -> torch.Tensor:
        return self.junction_quaternions[..., -1, :]

    @property
    def tip_position(self) -> torch.Tensor:
        return self.junction_positions[..., -1, :]

    def tip_position_f64(self) -> torch.Tensor:
        _, (r_hi, r_lo) = self.junction_dd
        return dd.join_f64(r_hi[..., -1, :], r_lo[..., -1, :])

    def tip_quaternion_f64(self) -> torch.Tensor:
        (q_hi, q_lo), _ = self.junction_dd
        return dd.join_f64(q_hi[..., -1, :], q_lo[..., -1, :])


def segmented_rod_shape(qe_segments, cfg: SegmentedRodConfig, q_init=None, r_init=None,
                        method: str = "picard", iters: int = 24,
                        **method_kwargs) -> SegmentedSolution:
    """Chained spectral solve over all segments.

    ``qe_segments (..., S, na*ne)``: per-segment strain modes (see
    :func:`project_global_strain`).  ``method='fused'`` chains the segments
    through K4 (``rod_shape_fused_bc``); ``method='refined_fused'`` through
    K5 (``rod_shape_refined_kernel_bc``) with f32-pair junction states, and
    ``qe_segments`` may then be an f32 pair ``(hi, lo)`` from
    ``rod.split_strain``.  Other methods go through :func:`.rod.rod_shape`.
    """
    if method == "refined_fused":
        return _segmented_refined_fused(qe_segments, cfg, q_init, r_init, iters=iters,
                                        **method_kwargs)
    qe_segments = as_tensor(qe_segments)
    q = rod.initial_state(q_init, rod.DEFAULT_Q_INIT, qe_segments[..., 0, :], 4)
    r = rod.initial_state(r_init, rod.DEFAULT_R_INIT, qe_segments[..., 0, :], 3)
    qs, rs, jq, jr = [], [], [], []
    for s, seg in enumerate(cfg.segments):
        # With inits given, rod_shape(method='fused') runs K4.
        sol = rod.rod_shape(qe_segments[..., s, :], q_init=q, r_init=r, cfg=seg,
                            method=method, iters=iters, **method_kwargs)
        qs.append(sol.quaternions)
        rs.append(sol.positions)
        q, r = sol.tip_quaternion, sol.tip_position
        jq.append(q)
        jr.append(r)
    return SegmentedSolution(quaternions=qs, positions=rs,
                             junction_quaternions=torch.stack(jq, dim=-2),
                             junction_positions=torch.stack(jr, dim=-2))


def _segmented_refined_fused(qe_segments, cfg: SegmentedRodConfig, q_init, r_init,
                             iters: int = 20, **kernel_kwargs) -> SegmentedSolution:
    """The chain through K5: f32-pair junction states from segment to segment."""
    from ..ops.kernels import refined_kernel as rfk

    if isinstance(qe_segments, tuple):
        qe_hi = as_tensor(qe_segments[0]).to(torch.float32)
        qe_lo = torch.as_tensor(qe_segments[1]).to(device=qe_hi.device, dtype=torch.float32)
    else:
        qe_hi, qe_lo = as_tensor(qe_segments).to(torch.float32), None
    lead, nq = qe_hi.shape[:-2], qe_hi.shape[-1]
    q_hi = rod.initial_state(q_init, rod.DEFAULT_Q_INIT, qe_hi[..., 0, :], 4).reshape(-1, 4)
    r_hi = rod.initial_state(r_init, rod.DEFAULT_R_INIT, qe_hi[..., 0, :], 3).reshape(-1, 3)
    q_lo = r_lo = None

    qs_dd, rs_dd, jq_dd, jr_dd = [], [], [], []
    for s, seg in enumerate(cfg.segments):
        outs = rfk.rod_shape_refined_kernel_bc(
            qe_hi[..., s, :].reshape(-1, nq), q_hi, r_hi,
            qes_lo=None if qe_lo is None else qe_lo[..., s, :].reshape(-1, nq),
            q_init_lo=q_lo, r_init_lo=r_lo, cfg=seg, iters=iters, **kernel_kwargs)
        sq_hi, sq_lo, sr_hi, sr_lo = (o.reshape(lead + o.shape[1:]) for o in outs)
        qs_dd.append((sq_hi, sq_lo))
        rs_dd.append((sr_hi, sr_lo))
        # Junction = the segment's tip, point 0 of the descending grid.
        q_hi, q_lo, r_hi, r_lo = (o[:, 0, :] for o in outs)
        jq_dd.append((sq_hi[..., 0, :], sq_lo[..., 0, :]))
        jr_dd.append((sr_hi[..., 0, :], sr_lo[..., 0, :]))

    def stack(pairs):
        return (torch.stack([p[0] for p in pairs], dim=-2),
                torch.stack([p[1] for p in pairs], dim=-2))

    junction_dd = (stack(jq_dd), stack(jr_dd))
    return SegmentedSolution(
        quaternions=[h + lo for h, lo in qs_dd], positions=[h + lo for h, lo in rs_dd],
        junction_quaternions=junction_dd[0][0] + junction_dd[0][1],
        junction_positions=junction_dd[1][0] + junction_dd[1][1],
        quaternions_dd=qs_dd, positions_dd=rs_dd, junction_dd=junction_dd)


def high_order_shape(qe, n: int = 256, method: str = "picard", iters: int = 48, **kwargs):
    """Named entry point of the N=256 high-order configuration: one segment,
    a ``4 (n-1)``-unknown collocation solve through :func:`.rod.rod_shape`."""
    return rod.rod_shape(qe, cfg=rod.RodConfig(n=n), method=method, iters=iters, **kwargs)
