"""Quaternion and rotation operators on batched tensors.

Counterpart of the JAX package's ``ops/lie.py``.  Everything broadcasts over
leading batch axes and keeps the input's device and dtype.
:func:`quat_to_rot` and :func:`quat_tangent` keep the reference's
**unnormalized** semantics: Eigen's unit-quaternion formula applied to a
quaternion that is not exactly unit, as ``main.cpp:130-136`` does.
"""

from __future__ import annotations

import torch

__all__ = [
    "skew",
    "quat_skew",
    "quat_skew_apply",
    "quat_to_rot",
    "quat_tangent",
    "rod_tangent",
    "cross",
    "quat_rotate_normalized",
    "quat_rotate_inv_normalized",
    "quat_normalize",
    "quat_multiply",
    "quat_conjugate",
]


def skew(v: torch.Tensor) -> torch.Tensor:
    """Hat map ``(..., 3) -> (..., 3, 3)``."""
    z = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_skew(k: torch.Tensor) -> torch.Tensor:
    """The ``4 x 4`` operator ``A(K)`` of ``Q' = 1/2 A(K) Q``, ``(..., 3) -> (..., 4, 4)``::

        [  0, -K0, -K1, -K2 ]
        [ K0,   0,  K2, -K1 ]
        [ K1, -K2,   0,  K0 ]
        [ K2,  K1, -K0,   0 ]
    """
    k0, k1, k2 = k[..., 0], k[..., 1], k[..., 2]
    z = torch.zeros_like(k0)
    rows = [
        torch.stack([z, -k0, -k1, -k2], dim=-1),
        torch.stack([k0, z, k2, -k1], dim=-1),
        torch.stack([k1, -k2, z, k0], dim=-1),
        torch.stack([k2, k1, -k0, z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_skew_apply(k: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``A(K) s`` without building the ``4 x 4`` block: 12 products per
    point.  ``k (..., 3)``, ``s (..., 4)``; the kernels do the same sums."""
    k0, k1, k2 = k[..., 0], k[..., 1], k[..., 2]
    sw, sx, sy, sz = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    return torch.stack(
        [
            -k0 * sx - k1 * sy - k2 * sz,
            k0 * sw + k2 * sy - k1 * sz,
            k1 * sw - k2 * sx + k0 * sz,
            k2 * sw + k1 * sx - k0 * sy,
        ],
        dim=-1,
    )


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``(w, x, y, z)`` to rotation matrix, **without normalizing**."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    one = torch.ones_like(w)
    rows = [
        torch.stack([one - (tyy + tzz), txy - twz, txz + twy], dim=-1),
        torch.stack([txy + twz, one - (txx + tzz), tyz - twx], dim=-1),
        torch.stack([txz - twy, tyz + twx, one - (txx + tyy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_tangent(q: torch.Tensor) -> torch.Tensor:
    """First column of :func:`quat_to_rot`, ``R(q) e1``: ``(..., 4) -> (..., 3)``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z),
            2.0 * (x * y + w * z),
            2.0 * (x * z - w * y),
        ],
        dim=-1,
    )


def rod_tangent(q: torch.Tensor, gamma: torch.Tensor | None = None) -> torch.Tensor:
    """Centerline tangent ``R(q)(e1 + gamma)`` with the unnormalized ``R``.

    ``gamma=None`` gives the Kirchhoff tangent ``R(q) e1``; a ``(..., 3)``
    shear/extension ``gamma`` gives the Reissner (6-DoF) tangent.
    """
    if gamma is None:
        return quat_tangent(q)
    e1 = torch.zeros_like(gamma)
    e1[..., 0] = 1.0
    return torch.einsum("...ij,...j->...i", quat_to_rot(q), e1 + gamma)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis, broadcasting the leading axes."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_rotate_normalized(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R(q/|q|) v`` without the 3x3 matrix:
    ``v + (2/|q|^2) [s (u x v) + u x (u x v)]`` with ``q = (s, u)``."""
    s, u = q[..., :1], q[..., 1:]
    uv = cross(u, v)
    return v + (2.0 / torch.sum(q * q, dim=-1, keepdim=True)) * (s * uv + cross(u, uv))


def quat_rotate_inv_normalized(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R(q/|q|)^T v`` (the inverse rotation), vector form."""
    s, u = q[..., :1], q[..., 1:]
    uv = cross(u, v)
    return v + (2.0 / torch.sum(q * q, dim=-1, keepdim=True)) * (-s * uv + cross(u, uv))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of ``(w, x, y, z)`` quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
