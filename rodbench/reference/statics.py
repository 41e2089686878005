"""Plain Cosserat statics under tip loads: the balance residual, and the
lower-precision Newton that serves as the control.

At every cross section the constitutive moment balances the tip force ``F``
carried to that section (``materials/rod_modeling.pdf``, statics):

    H K(X) = R(X)^T [ (r(L) - r(X)) x F ],

with ``R`` the rotation of the normalized quaternion.  Projected on the
strain modes with Clenshaw-Curtis quadrature over the whole grid, the base
included (identity, origin), the residual is

    res[a, e] = sum_j w_j P_e(x_j) (H K(x_j) - tau(x_j))[a],

flattened mode-major (``a * ne + e``), as the strain vector.  The kinematics
come from the dense solve of :mod:`.rod`.  Nothing here takes anything that
the program under test computes.
"""

from __future__ import annotations

import math

import torch

from . import rod

__all__ = ["cc_weights", "residual", "residual_norm", "tf32_round", "picard_shape",
           "control_newton"]


def cc_weights(n: int, length: float = 1.0, dtype=torch.float64, device=None) -> torch.Tensor:
    """Clenshaw-Curtis weights of the descending CGL grid on ``[0, L]``, in
    closed form: ``w_j = (c_j / N)(1 - sum_k b_k cos(2 pi j k / N) / (4k^2 - 1))``,
    ``N = n - 1``, ``c_j = 1`` at the ends and 2 inside, ``b_k = 1`` at
    ``k = N/2`` and 2 below it; scaled by ``L/2``."""
    big_n = n - 1
    j = torch.arange(n, dtype=torch.float64, device=device)
    total = torch.zeros(n, dtype=torch.float64, device=device)
    for k in range(1, big_n // 2 + 1):
        b = 1.0 if 2 * k == big_n else 2.0
        total += b * torch.cos(2.0 * math.pi * j * k / big_n) / (4.0 * k * k - 1.0)
    c = torch.full((n,), 2.0, dtype=torch.float64, device=device)
    c[0] = c[-1] = 1.0
    return ((c / big_n) * (1.0 - total) * (length / 2.0)).to(dtype)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _rotate_inv(q, v):
    """``R(q/|q|)^T v``."""
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    return v + (2.0 / (q * q).sum(-1, keepdim=True)) * (-w * uv + _cross(u, uv))


def _balance(qe, q, r, tip_force, n, ne, length, stiffness):
    """The residual from the kinematics at the unknown points."""
    dtype, device = q.dtype, q.device
    b = q.shape[0]
    base_q = torch.zeros(b, 1, 4, dtype=dtype, device=device)
    base_q[..., 0] = 1.0
    q = torch.cat([q, base_q], 1)
    r = torch.cat([r, torch.zeros(b, 1, 3, dtype=dtype, device=device)], 1)
    x = rod.cgl_points(n, length, torch.float64, device)
    table = rod.legendre_table(x, ne, length).to(dtype)                   # (n, ne)
    kappa = rod.curvature(qe.to(dtype), table)                            # (b, n, 3)
    arm = r[:, :1, :] - r
    tau = _rotate_inv(q, _cross(arm, tip_force.to(dtype)[:, None, :].expand_as(arm)))
    h = torch.as_tensor(stiffness, dtype=dtype, device=device)
    mr = h * kappa - tau
    w = cc_weights(n, length, dtype, device)
    res = torch.einsum("j,je,bja->bae", w, table, mr)
    return res.reshape(b, -1)


def residual(qe: torch.Tensor, tip_force: torch.Tensor, n: int = 16, ne: int = 3,
             length: float = 1.0, stiffness=(1.0, 1.0, 1.0), block: int = 32768) -> torch.Tensor:
    """The float64 balance residual ``(B, 3 ne)`` at the strains ``qe (B, 3 ne)``
    under the tip forces ``(B, 3)``, with the dense float64 kinematics."""
    out = []
    for start in range(0, qe.shape[0], block):
        qb = qe[start:start + block].to(torch.float64)
        q, r = rod.solve(qb, n=n, ne=ne, length=length, dtype=torch.float64, block=block)
        out.append(_balance(qb, q, r, tip_force[start:start + block], n, ne, length, stiffness))
    return torch.cat(out)


def residual_norm(qe, tip_force, **kw) -> torch.Tensor:
    """``||res||_2`` per load case, float64."""
    return torch.linalg.vector_norm(residual(qe, tip_force, **kw), dim=-1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the tensor cores' ``cvt.rna.tf32`` does; the same bits on every
    device.  Tangents pass through unchanged."""
    bits = x.detach().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def _tf32_matmul(a, b):
    return torch.matmul(tf32_round(a), tf32_round(b))


def picard_shape(qe: torch.Tensor, n: int, ne: int, length: float, iters: int):
    """The collocation system of :func:`rod.solve` by Picard iteration in float32
    with every product against ``G = D_NN^-1`` taken in TF32:
    ``Q <- G (1/2 A(K) Q - D_IN q0)``, then ``r = G R(Q) e1``."""
    device = qe.device
    n1 = n - 1
    d = rod.diff_matrix(n, length, torch.float64, device)
    g = torch.linalg.solve(d[:n1, :n1], torch.eye(n1, dtype=torch.float64, device=device))
    din = d[:n1, n1]
    x = rod.cgl_points(n, length, torch.float64, device)
    table = rod.legendre_table(x[:n1], ne, length).to(torch.float32)
    g32 = g.to(torch.float32)
    a = 0.5 * rod.quat_skew(rod.curvature(qe.to(torch.float32), table))   # (b, n1, 4, 4)
    base = torch.zeros(n1, 4, dtype=torch.float32, device=device)
    base[:, 0] = (-(g @ din)).to(torch.float32)                           # G (-D_IN q0)
    q = base.expand(qe.shape[0], -1, -1)
    for _ in range(iters):
        q = _tf32_matmul(g32, torch.einsum("bpij,bpj->bpi", a, q)) + base
    return q, _tf32_matmul(g32, rod.tangent(q))


def control_newton(tip_force: torch.Tensor, n: int = 16, ne: int = 3, length: float = 1.0,
                   stiffness=(1.0, 1.0, 1.0), tol: float = 1e-5, max_iter: int = 12,
                   iters: int = 16):
    """The control: Newton over the batch on the balance residual computed in
    float32 with TF32 products (:func:`picard_shape`), its per-sample Jacobian
    by forward mode through the same computation, the iterate kept in
    float64; a sample whose residual norm is ``<= tol`` stops moving.
    Returns ``(qe float32 (B, 3 ne), residual norm (B,), Newton steps taken)``."""
    b, nq = tip_force.shape[0], 3 * ne
    f32 = tip_force.to(torch.float32)

    def res_fn(q32):
        q, r = picard_shape(q32, n, ne, length, iters)
        return _balance(q32, q, r, f32, n, ne, length, stiffness)

    qe = torch.zeros(b, nq, dtype=torch.float64, device=tip_force.device)
    eye = torch.eye(nq, dtype=torch.float32, device=tip_force.device)
    res = res_fn(qe.to(torch.float32))
    steps = 0
    while steps < max_iter:
        active = torch.linalg.vector_norm(res, dim=-1) > tol
        if not bool(active.any()):
            break
        steps += 1
        q32 = qe.to(torch.float32)
        cols = [torch.func.jvp(res_fn, (q32,), (eye[j].expand(b, nq),))[1] for j in range(nq)]
        step = torch.linalg.solve(torch.stack(cols, -1), res.unsqueeze(-1))[..., 0]
        qe = qe - torch.where(active[:, None], step, 0.0).to(torch.float64)
        res = res_fn(qe.to(torch.float32))
    return qe.to(torch.float32), torch.linalg.vector_norm(res, dim=-1), steps
