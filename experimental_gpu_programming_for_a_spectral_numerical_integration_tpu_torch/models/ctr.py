"""Concentric-tube continuum robots: the torsionally compliant multi-tube BVP.

Counterpart of the JAX package's ``models/ctr.py``.  ``T`` precurved tubes
are nested concentrically; they share one backbone and differ by twist
angles ``theta_t(X)`` about the common tangent.  In a zero-twist backbone
frame tube ``t`` contributes the bending-plane curvature
``v_t = kappa_t (cos theta_t, sin theta_t)``; the backbone curvature is the
stiffness-weighted blend ``u_b = sum_t k_t v_t / sum_t k_t``, and the twists
minimize the elastic energy

    E[theta] = int_0^L [ 1/2 sum_t g_t (theta_t')^2 + 1/2 sum_t k_t |v_t - u_b|^2 ] dX,
    theta_t(0) = alpha_t (base actuation),    theta_t'(L) = 0 (free tip).

Discretization is spectral Ritz-Galerkin on the descending CGL grid:
``theta' = D theta`` exactly and the integral is the exact Gram quadrature
of the grid interpolants (:func:`..ops.chebyshev.gram_matrix`), so the free
tip is a natural boundary condition and only the base values are pinned.
The Newton residual is the energy's gradient (``torch.func.grad``), solved
by the shared batched :func:`.dynamics.damped_newton` (per-sample Jacobians
forward over reverse, one host sync per iterate); stability is the smallest
eigenvalue of the second variation.  For two tubes the relative angle obeys
``phi'' = c sin phi``, and the antagonist state ``phi = pi`` loses stability
at ``sqrt(c) L = pi/2`` (:func:`two_tube_snap_parameter`).

Lengths are tensors: every solve runs on the unit grid with the scalings
``theta' = D theta / ell`` and ``dX = ell w``, and the backbone integrates
``Q' = 1/2 A(ell K) Q`` on the unit domain, so overlap lengths batch and are
differentiable (:func:`solve_ctr_differentiable`, an implicit-function
``torch.autograd.Function``).  Everything is f64 on the inputs' device
(``device=`` where no input is a tensor; neither: the card).  No kernel
runs here: the JAX model has no fused path either.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import chebyshev
from ..ops import collocation as coll
from ..ops import lie
from ..ops.device import cached_constants, canonical_device
from . import rod

__all__ = [
    "Tube",
    "CTRConfig",
    "CTRSolution",
    "tube_curvatures",
    "torsion_energy",
    "torsion_residual",
    "torsion_hessian",
    "backbone_curvature",
    "solve_ctr",
    "solve_ctr_differentiable",
    "ctr_stability",
    "ctr_shape",
    "two_tube_snap_parameter",
    "solve_ctr_telescoping",
    "TelescopingShape",
]


@dataclass(frozen=True)
class Tube:
    """One precurved tube: precurvature magnitude ``curvature`` (bending
    about the tube's body-y at ``theta = 0``), bending stiffness ``k = EI``
    and torsional stiffness ``g = GJ`` (circular section: ``g = k/(1+nu)``)."""

    curvature: float
    bending_stiffness: float = 1.0
    torsional_stiffness: float = 1.0


@dataclass(frozen=True)
class CTRConfig:
    """The tube set, the grid order ``n`` and the default shared length
    (each call may override it with a tensor)."""

    tubes: tuple
    n: int = 16
    length: float = 1.0

    @property
    def num_tubes(self) -> int:
        return len(self.tubes)

    def grid(self, device=None) -> coll.SpectralGrid:
        """The UNIT reference grid: lengths enter as scalings."""
        return coll.make_grid(self.n, 1.0, device=device)

    @functools.cached_property
    def kappas(self) -> np.ndarray:
        return np.asarray([t.curvature for t in self.tubes], np.float64)

    @functools.cached_property
    def bending(self) -> np.ndarray:
        return np.asarray([t.bending_stiffness for t in self.tubes], np.float64)

    @functools.cached_property
    def torsion(self) -> np.ndarray:
        return np.asarray([t.torsional_stiffness for t in self.tubes], np.float64)

    @property
    def d1(self) -> np.ndarray:
        """Unit-length differentiation matrix ``(n, n)``, descending CGL."""
        return chebyshev.diff_matrix(self.n, 1.0)

    @property
    def q1(self) -> np.ndarray:
        """Unit-length exact Gram quadrature ``(n, n)``."""
        return chebyshev.gram_matrix(self.n, 1.0)


class _Constants(NamedTuple):
    d1t: torch.Tensor      # (n, n) D^T: theta @ d1t differentiates along the last axis
    q1: torch.Tensor       # (n, n)
    kappas: torch.Tensor   # (T,)
    bending: torch.Tensor  # (T,)
    torsion: torch.Tensor  # (T,)


@cached_constants
def _constants_on(cfg: CTRConfig, device: torch.device, dtype: torch.dtype) -> _Constants:
    def dev(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return _Constants(d1t=dev(cfg.d1.T), q1=dev(cfg.q1), kappas=dev(cfg.kappas),
                      bending=dev(cfg.bending), torsion=dev(cfg.torsion))


def _constants(cfg: CTRConfig, like: torch.Tensor) -> _Constants:
    """``cfg``'s operators and tube tables on ``like``'s device, in its
    dtype, made once per (config, device, dtype)."""
    return _constants_on(cfg, canonical_device(like.device), like.dtype)


class CTRSolution(NamedTuple):
    """``theta (..., T, n)``: twist angles on the full descending grid (tip
    first, the base actuation angles last); ``iterations``: Newton steps
    taken; ``residual (..., T*(n-1))``: the energy gradient at the solution
    on the flat unknowns."""

    theta: torch.Tensor
    iterations: torch.Tensor
    residual: torch.Tensor


def _f64(x, device=None) -> torch.Tensor:
    """``x`` in f64: a tensor keeps its device, anything else goes to
    ``device`` (default: the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=canonical_device(device))


def _theta_full(theta_u: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """Append the pinned base values: ``(..., T, n-1)`` and ``(..., T)`` ->
    ``(..., T, n)`` (the base is the LAST point of the descending grid).
    ``alphas`` broadcasts against extra leading axes of ``theta_u`` (the
    line search's candidate stack)."""
    base = alphas[..., None].expand(theta_u.shape[:-1] + (1,))
    return torch.cat([theta_u, base], dim=-1)


def _ell(cfg: CTRConfig, length, like: torch.Tensor):
    """The length: ``cfg.length`` as a Python float (no device constant to
    copy) or the caller's value as a tensor in ``like``'s dtype and device."""
    if length is None:
        return float(cfg.length)
    if isinstance(length, torch.Tensor):
        return length.to(dtype=like.dtype, device=like.device)
    if np.ndim(length) == 0:
        return float(length)
    return torch.as_tensor(length, dtype=like.dtype, device=like.device)


def _trailing(ell, dims: int):
    """``ell`` with ``dims`` trailing unit axes (a float stays a float)."""
    return ell if not isinstance(ell, torch.Tensor) else ell.reshape(ell.shape + (1,) * dims)


def tube_curvatures(theta: torch.Tensor, cfg: CTRConfig) -> torch.Tensor:
    """Per-tube bending-plane curvatures ``v_t = kappa_t (cos theta_t,
    sin theta_t)``: ``(..., T, n_pts) -> (..., T, n_pts, 2)``."""
    kap = _constants(cfg, theta).kappas
    return kap[:, None, None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def backbone_curvature(theta: torch.Tensor, cfg: CTRConfig) -> torch.Tensor:
    """Stiffness-weighted backbone curvature ``u_b = sum k_t v_t / sum k_t``
    in the zero-twist frame: ``(..., n_pts, 2)``."""
    kb = _constants(cfg, theta).bending
    v = tube_curvatures(theta, cfg)
    return torch.einsum("t,...tnc->...nc", kb, v) / kb.sum()


def torsion_energy(theta_u, alphas, cfg: CTRConfig, length=None) -> torch.Tensor:
    """Discrete elastic energy ``(...,)`` of the unknowns ``(..., T, n-1)``
    at base angles ``(..., T)``; ``length`` may be a tensor ``(...,)``."""
    theta_u = _f64(theta_u)
    alphas = _f64(alphas).to(dtype=theta_u.dtype, device=theta_u.device)
    c = _constants(cfg, theta_u)
    ell = _ell(cfg, length, theta_u)
    theta = _theta_full(theta_u, alphas)                       # (..., T, n)
    dtheta = torch.matmul(theta, c.d1t)                        # unit-domain derivative
    v = tube_curvatures(theta, cfg)
    u = torch.einsum("t,...tnc->...nc", c.bending, v) / c.bending.sum()
    dev = v - u[..., None, :, :]                               # (..., T, n, 2)
    # Both terms are value products of grid interpolants, which the Gram
    # quadrature integrates exactly.
    q_dev = torch.einsum("ij,...tjc->...tic", c.q1, dev)
    e_bend = 0.5 * torch.einsum("t,...tic,...tic->...", c.bending, dev, q_dev)
    q_dth = torch.matmul(dtheta, c.q1)                         # Q symmetric
    e_tors = 0.5 * torch.einsum("t,...ti,...ti->...", c.torsion, dtheta, q_dth)
    return ell * e_bend + e_tors / ell


def torsion_residual(z, alphas, cfg: CTRConfig, length=None) -> torch.Tensor:
    """Per-sample energy gradient on the flat unknowns ``(..., T*(n-1))``,
    the Newton residual: ``torch.func.grad`` of the summed energy, which is
    the batch of gradients since the samples' energies are separate."""
    z = _f64(z)
    t, nu = cfg.num_tubes, cfg.n - 1

    def e_sum(zz):
        return torsion_energy(zz.reshape(zz.shape[:-1] + (t, nu)), alphas, cfg, length).sum()

    return torch.func.grad(e_sum)(z)


def _unknowns(theta: torch.Tensor, cfg: CTRConfig) -> torch.Tensor:
    """The flat unknowns ``(..., T*(n-1))`` of a full-grid ``theta (..., T, n)``."""
    return theta[..., :, :-1].reshape(theta.shape[:-2] + (cfg.num_tubes * (cfg.n - 1),))


def torsion_hessian(theta, alphas, cfg: CTRConfig, length=None) -> torch.Tensor:
    """Discrete second variation with respect to the unknowns, ``(..., m,
    m)`` with ``m = T*(n-1)``: reverse-over-reverse rows (one vjp of the
    gradient per unit direction, shared by the batch), symmetrized against
    AD roundoff as the JAX model does with its forward-over-reverse
    columns."""
    theta = _f64(theta)
    z = _unknowns(theta, cfg)
    _, pull = torch.func.vjp(lambda zz: torsion_residual(zz, alphas, cfg, length), z)
    eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    rows = torch.func.vmap(lambda e: pull(e.expand(z.shape))[0])(eye)   # (m, ..., m)
    h = torch.movedim(rows, 0, -2)
    return 0.5 * (h + h.transpose(-1, -2))


def _initial_unknowns(alphas: torch.Tensor, theta0, cfg: CTRConfig) -> torch.Tensor:
    nu = cfg.n - 1
    if theta0 is None:
        return alphas[..., None].expand(alphas.shape + (nu,))
    theta0 = torch.as_tensor(theta0, dtype=alphas.dtype, device=alphas.device)
    theta_u0 = theta0[..., :nu] if theta0.shape[-1] == cfg.n else theta0
    return theta_u0.expand(alphas.shape + (nu,))


def solve_ctr(alphas, cfg: CTRConfig, length=None, theta0=None, tol: float = 1e-8,
              max_iter: int = 40, line_search: bool = True, device=None) -> CTRSolution:
    """Batched damped Newton on the torsion BVP.

    ``alphas (..., T)``: base actuation angles; ``length``: optional
    override, a float or a tensor ``(...,)``; ``theta0``: optional initial
    guess on the full grid ``(..., T, n)`` or on the unknowns ``(..., T,
    n-1)``, broadcast over the batch (default: the twist-rigid profile
    ``theta == alpha``; a perturbed guess lands on a chosen branch in the
    bistable post-snap regime).  One host sync per Newton iterate (the
    stop test of :func:`.dynamics.damped_newton`) and no other.
    """
    from . import dynamics  # deferred, as in the JAX model: a heavy import

    alphas = _f64(alphas, device)
    t, nu = cfg.num_tubes, cfg.n - 1
    if alphas.shape[-1] != t:
        raise ValueError(f"alphas has {alphas.shape[-1]} entries, config has {t} tubes")
    length = _ell(cfg, length, alphas)               # on the device once, not per residual
    theta_u0 = _initial_unknowns(alphas, theta0, cfg)
    z0 = theta_u0.reshape(theta_u0.shape[:-2] + (t * nu,))
    z, k, res = dynamics.damped_newton(
        lambda zz: torsion_residual(zz, alphas, cfg, length),
        z0, tol=tol, max_iter=max_iter, line_search=line_search)
    theta_u = z.reshape(z.shape[:-1] + (t, nu))
    return CTRSolution(theta=_theta_full(theta_u, alphas), iterations=k, residual=res)


def ctr_stability(theta, alphas, cfg: CTRConfig, length=None) -> torch.Tensor:
    """Smallest eigenvalue of the discrete second variation ``(...,)``:
    positive at stable equilibria; its zero crossing along an actuation
    path is the snapping bifurcation."""
    h = torsion_hessian(theta, alphas, cfg, length)
    return torch.linalg.eigvalsh(h).amin(dim=-1)


def two_tube_snap_parameter(cfg: CTRConfig, length=None) -> float:
    """Host ``sqrt(c) L`` of a two-tube pair: the antagonist state
    ``alpha_1 - alpha_2 = pi`` is bistable (snaps) iff it exceeds ``pi/2``."""
    if cfg.num_tubes != 2:
        raise ValueError("snap parameter is defined for exactly 2 tubes")
    k1, k2 = cfg.bending
    g1, g2 = cfg.torsion
    kap1, kap2 = cfg.kappas
    c = kap1 * kap2 * (k1 * k2 / (k1 + k2)) * (1.0 / g1 + 1.0 / g2)
    ell = float(cfg.length if length is None else length)
    return float(math.sqrt(c) * ell)


def _shape_from_curvature(k: torch.Tensor, ell, grid: coll.SpectralGrid, method: str,
                          iters: int, q_init, r_init) -> rod.RodSolution:
    """Quaternion and position chain of a pointwise strain ``k (..., n-1,
    3)`` on the UNIT grid scaled by ``ell`` (a float or a tensor ``(...,)``).
    The 1/2 of ``Q' = 1/2 A(K) Q`` is explicit here: ``quat_skew`` is
    ``A(K)``."""
    dtype = k.dtype
    q0 = rod.initial_state(q_init, rod.DEFAULT_Q_INIT, k[..., 0, :], 4)
    r0 = rod.initial_state(r_init, rod.DEFAULT_R_INIT, k[..., 0, :], 3)
    m = 0.5 * _trailing(ell, 3) * lie.quat_skew(k)
    if method == "dense":
        q = coll.solve_ivp_dense(grid, m, q0)
    elif method == "picard":
        q = coll.solve_ivp_picard_implicit(grid, m, coll.ivp_rhs(grid, q0), iters)
    else:
        raise ValueError(f"unknown method {method!r}")
    b = lie.quat_tangent(q) * _trailing(ell, 2)
    rhs = coll.ivp_rhs(grid, r0, g=b)
    if method == "dense":
        dn_nn = grid.dn_nn.to(dtype)
        r = torch.linalg.solve_ex(dn_nn.expand(rhs.shape[:-2] + dn_nn.shape), rhs)[0]
    else:
        r = coll._grid_matmul(grid.ginv.to(dtype), rhs)
    return rod.RodSolution(quaternions=q, positions=r)


def ctr_shape(theta, cfg: CTRConfig, length=None, method: str = "picard", iters: int = 24,
              q_init=None, r_init=None) -> rod.RodSolution:
    """Backbone shape of solved twist profiles ``theta (..., T, n)``.

    The zero-twist backbone frame carries the strain ``K = (0, u_b)``
    (torsion-free: the tubes spin about the shared tangent without moving
    the centerline), integrated as the single rod is, on the unit grid
    scaled by the length.  Point 0 is the tip, as in
    :class:`.rod.RodSolution`.  ``method``: ``'picard'`` (the
    implicit-function Picard solve) or ``'dense'`` (batched ``solve_ex``).
    """
    theta = _f64(theta)
    u = backbone_curvature(theta[..., :, :-1], cfg)           # at the unknown points
    k = torch.cat([torch.zeros_like(u[..., :1]), u], dim=-1)
    return _shape_from_curvature(k, _ell(cfg, length, theta), cfg.grid(theta.device), method,
                                 iters, q_init, r_init)


class _SolveThetaIFT(torch.autograd.Function):
    """``theta`` of :func:`solve_ctr` with implicit-function derivatives (JAX:
    a ``custom_jvp``).  At ``grad E(z*; a, l) = 0``: ``jvp``, ``dz = -H^-1
    (dR/da da + dR/dl dl)`` and the base column ``da``; ``backward``, its
    transpose: ``H lam = theta_bar_u`` (``H`` symmetric), then ``a_bar =
    -vjp_a(lam) + theta_bar_base`` and ``l_bar = -vjp_l(lam)``.  One Hessian
    and one ``solve_ex`` per rule instead of differentiating the Newton
    loop."""

    generate_vmap_rule = True

    @staticmethod
    def forward(alphas, length, cfg, tol, max_iter, line_search):
        return solve_ctr(alphas, cfg, length=length, tol=tol, max_iter=max_iter,
                         line_search=line_search).theta

    @staticmethod
    def setup_context(ctx, inputs, output):
        alphas, length, cfg, *_ = inputs
        ctx.cfg = cfg
        ctx.save_for_backward(alphas, length, output)
        ctx.save_for_forward(alphas, length, output)

    @staticmethod
    def jvp(ctx, da, dl, *_):
        alphas, length, theta = ctx.saved_tensors
        cfg = ctx.cfg
        da = torch.zeros_like(alphas) if da is None else da
        dl = torch.zeros_like(length) if dl is None else dl
        z = _unknowns(theta, cfg)
        _, rhs_t = torch.func.jvp(lambda aa, ll: torsion_residual(z, aa, cfg, ll),
                                  (alphas, length), (da, dl))
        h = torsion_hessian(theta, alphas, cfg, length)
        dz = -torch.linalg.solve_ex(h, rhs_t.unsqueeze(-1))[0][..., 0]
        dtheta_u = dz.reshape(dz.shape[:-1] + (cfg.num_tubes, cfg.n - 1))
        return torch.cat([dtheta_u, da.expand(dtheta_u.shape[:-1])[..., None]], dim=-1)

    @staticmethod
    def backward(ctx, theta_bar):
        alphas, length, theta = ctx.saved_tensors
        cfg = ctx.cfg
        z = _unknowns(theta, cfg)
        h = torsion_hessian(theta, alphas, cfg, length)
        lam = torch.linalg.solve_ex(h, _unknowns(theta_bar, cfg).unsqueeze(-1))[0][..., 0]
        _, pull = torch.func.vjp(lambda aa, ll: torsion_residual(z, aa, cfg, ll), alphas, length)
        a_bar, l_bar = pull(lam)
        a_bar = (theta_bar[..., -1] - a_bar).sum_to_size(alphas.shape)
        return a_bar, (-l_bar).sum_to_size(length.shape), None, None, None, None


def solve_ctr_differentiable(alphas, cfg: CTRConfig, length=None, tol: float = 1e-8,
                             max_iter: int = 40, line_search: bool = True, device=None):
    """:func:`solve_ctr`'s ``theta`` alone, differentiable with respect to
    ``alphas`` (rotational actuation) and ``length`` (translational) by
    implicit-function tangents: the entry point of CTR inverse kinematics
    and workspace Jacobians.  Works under ``torch.autograd``,
    ``torch.func.grad``/``jacrev``/``jacfwd``/``jvp``, with at most one
    forward-mode level: the jvp rule runs with forward-mode AD off, so a
    jvp of a jvp would get a zero second-order tangent, and raises instead."""
    alphas = _f64(alphas, device)
    ell = _ell(cfg, length, alphas)
    if not isinstance(ell, torch.Tensor):
        ell = torch.full((), ell, dtype=alphas.dtype, device=alphas.device)
    if coll._forward_levels(alphas, ell) > 1:
        raise RuntimeError(
            "solve_ctr_differentiable under nested forward-mode transforms (a torch.func.jvp "
            "of a jvp, jacfwd of jacfwd) would return a zero second-order tangent; take the "
            "outer or the inner derivative in reverse mode (jacfwd(jacrev(f)), jacrev(jacrev(f)))")
    return _SolveThetaIFT.apply(alphas, ell, cfg, tol, max_iter, line_search)


class TelescopingShape(NamedTuple):
    """Two-section telescoping shape: ``proximal`` covers the two-tube
    overlap (the section's tip first), ``distal`` the inner tube's
    extension; ``tip`` is the robot's tip position and ``theta`` the
    overlap's twist profiles."""

    theta: torch.Tensor
    proximal: rod.RodSolution
    distal: rod.RodSolution
    tip: torch.Tensor


def solve_ctr_telescoping(alphas, overlap, extension, cfg: CTRConfig, method: str = "picard",
                          iters: int = 24, tol: float = 1e-8, max_iter: int = 40,
                          differentiable: bool = False, theta0=None,
                          device=None) -> TelescopingShape:
    """Two-tube telescoping robot: ``tubes = (inner, outer)``, the inner tube
    protruding ``extension`` beyond the overlap of length ``overlap`` (both
    floats or tensors ``(...,)``).

    In the inner-only distal section ``g_1 theta_1'' = 0`` with a free tip,
    so ``theta_1' == 0`` there, and by torque continuity the overlap is the
    full-overlap BVP with a free end.  The distal backbone is the inner
    tube's own constant precurvature ``(0, kappa_1 cos th_1, kappa_1 sin
    th_1)`` at the junction twist ``th_1``, chained from the proximal tip's
    quaternion and position.  ``differentiable=True`` solves the overlap
    with :func:`solve_ctr_differentiable`.
    """
    if cfg.num_tubes != 2:
        raise ValueError("telescoping solver covers the two-tube robot")
    alphas = _f64(alphas, device)
    ell_o = _ell(cfg, overlap, alphas)
    ell_d = _ell(cfg, extension, alphas)
    if differentiable:
        theta = solve_ctr_differentiable(alphas, cfg, length=ell_o, tol=tol, max_iter=max_iter)
    else:
        theta = solve_ctr(alphas, cfg, length=ell_o, tol=tol, max_iter=max_iter,
                          theta0=theta0).theta
    prox = ctr_shape(theta, cfg, length=ell_o, method=method, iters=iters)
    q_j = prox.quaternions[..., 0, :]
    r_j = prox.positions[..., 0, :]
    th1 = theta[..., 0, 0]                                   # inner tube's junction twist
    kap1 = float(cfg.kappas[0])
    k_d = torch.stack([torch.zeros_like(th1), kap1 * torch.cos(th1), kap1 * torch.sin(th1)],
                      dim=-1)
    k_d = k_d[..., None, :].expand(th1.shape + (cfg.n - 1, 3))
    if isinstance(ell_d, torch.Tensor):
        ell_d = ell_d.expand(th1.shape)
    distal = _shape_from_curvature(k_d, ell_d, cfg.grid(alphas.device), method, iters,
                                   q_init=q_j, r_init=r_j)
    return TelescopingShape(theta=theta, proximal=prox, distal=distal,
                            tip=distal.positions[..., 0, :])
