"""Analytic-solution IVP suite (BASELINE.json config #2).

Counterpart of the JAX package's ``models/ivp.py``: closed-form linear IVPs
driven through the collocation core of the rod solve, for convergence
sweeps (exponential error decay in N) and as examples of the general
``y' = M(X) y + g(X)`` API with state dimensions other than the rod's 4:

* :func:`exponential_ivp`: ``y' = lam y`` (d=1), solution ``y0 e^{lam X}``;
* :func:`oscillator_ivp`: the forced oscillator ``u'' + w^2 u = A sin(nu X)``
  as a d=2 system, non-resonant (``nu != w``);
* :func:`rotating_frame_ivp`: ``q' = 1/2 A(k) q`` with constant curvature,
  whose exact solution is the quaternion exponential;
* :func:`convergence_sweep`: error against N for any of them.

Each returns ``(numeric, exact)`` at the n-1 unknown CGL points, tip first,
as ``dtype`` (f64 by default) tensors on ``device`` (default: the card).
No kernel runs here: ``method`` is ``'dense'`` (``torch.linalg.solve``) or
``'picard'``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chebyshev
from ..ops import collocation as coll
from ..ops import lie
from ..ops.device import canonical_device

__all__ = [
    "exponential_ivp",
    "oscillator_ivp",
    "rotating_frame_ivp",
    "convergence_sweep",
]


def _solve(grid, m_blocks, y0, g=None, method="dense", iters=40):
    if method == "dense":
        return coll.solve_ivp_dense(grid, m_blocks, y0, g=g)
    if method == "picard":
        return coll.solve_ivp_picard(grid, m_blocks, y0, g=g, iters=iters)
    raise ValueError(f"method must be 'dense' or 'picard', got {method!r}")


def _setup(n: int, length: float, device):
    device = canonical_device(device)
    grid = coll.make_grid(n, length, device=device)
    return grid, chebyshev.cgl_points(n, length)[:n - 1], device


def exponential_ivp(lam: float = -2.5, y0: float = 1.0, n: int = 16,
                    length: float = 1.0, method: str = "dense",
                    dtype: torch.dtype = torch.float64, device=None):
    """``y' = lam y, y(0) = y0`` on ``[0, length]``; ``(numeric, exact)``
    of shape ``(n-1,)``."""
    grid, x, device = _setup(n, length, device)
    m = torch.full((grid.num_unknown, 1, 1), lam, dtype=dtype, device=device)
    sol = _solve(grid, m, torch.tensor([y0], dtype=dtype, device=device), method=method)
    exact = torch.tensor(y0 * np.exp(lam * x), dtype=dtype, device=device)
    return sol[..., 0], exact


def oscillator_ivp(omega: float = 6.0, forcing_amp: float = 1.0,
                   forcing_freq: float = 2.0, u0: float = 1.0, v0: float = 0.0,
                   n: int = 16, length: float = 1.0, method: str = "dense",
                   dtype: torch.dtype = torch.float64, device=None):
    """Forced oscillator ``u'' + omega^2 u = A sin(nu X)``, ``u(0) = u0``,
    ``u'(0) = v0``, as ``(u, v)' = [[0, 1], [-w^2, 0]] (u, v) + (0, A sin(nu
    X))``.  Non-resonant closed form: ``u = u0 cos(wX) + (v0 - nu c)/w
    sin(wX) + c sin(nu X)`` with ``c = A / (w^2 - nu^2)``.  Returns
    ``(numeric (n-1, 2), exact (n-1, 2))``."""
    if abs(omega - forcing_freq) < 1e-9:
        raise ValueError("resonant forcing_freq == omega not supported")
    grid, x, device = _setup(n, length, device)
    npts = grid.num_unknown
    m_one = np.array([[0.0, 1.0], [-(omega ** 2), 0.0]])
    m = torch.tensor(np.broadcast_to(m_one, (npts, 2, 2)).copy(), dtype=dtype, device=device)
    g = torch.tensor(np.stack([np.zeros(npts), forcing_amp * np.sin(forcing_freq * x)], -1),
                     dtype=dtype, device=device)
    sol = _solve(grid, m, torch.tensor([u0, v0], dtype=dtype, device=device), g=g,
                 method=method)

    c_p = forcing_amp / (omega ** 2 - forcing_freq ** 2)
    b = (v0 - forcing_freq * c_p) / omega
    u = u0 * np.cos(omega * x) + b * np.sin(omega * x) + c_p * np.sin(forcing_freq * x)
    v = (-u0 * omega * np.sin(omega * x) + b * omega * np.cos(omega * x)
         + c_p * forcing_freq * np.cos(forcing_freq * x))
    return sol, torch.tensor(np.stack([u, v], -1), dtype=dtype, device=device)


def rotating_frame_ivp(k=(0.0, 2.0, 0.0), q0=(1.0, 0.0, 0.0, 0.0), n: int = 16,
                       length: float = 1.0, method: str = "dense",
                       dtype: torch.dtype = torch.float64, device=None):
    """Constant-curvature quaternion kinematics ``q' = 1/2 A(k) q``.

    ``A(k) q = q (x) (0, k)`` multiplies by the body rate on the right, so
    ``q(X) = q0 (x) exp(X k / 2)`` with ``exp(theta u / 2) = (cos(theta/2),
    u sin(theta/2))``, ``theta = |k| X``: the rod solve of
    the reference's ``main.cpp:91-118`` for one constant mode, in closed
    form.  Returns ``(numeric (n-1, 4), exact (n-1, 4))``."""
    grid, x, device = _setup(n, length, device)
    k = np.asarray(k, np.float64)
    m_one = 0.5 * lie.quat_skew(torch.tensor(k, dtype=dtype, device=device))
    m = m_one.expand(grid.num_unknown, 4, 4)
    sol = _solve(grid, m, torch.tensor(q0, dtype=dtype, device=device), method=method)

    norm = np.linalg.norm(k)
    theta = norm * x
    if norm < 1e-300:
        exp_q = np.stack([np.ones_like(x), 0 * x, 0 * x, 0 * x], axis=-1)
    else:
        u = k / norm
        exp_q = np.stack([np.cos(theta / 2)] + [u[i] * np.sin(theta / 2) for i in range(3)],
                         axis=-1)
    exp_q = torch.tensor(exp_q, dtype=torch.float64, device=device)
    q0t = torch.tensor(q0, dtype=torch.float64, device=device).expand(exp_q.shape)
    return sol, lie.quat_multiply(q0t, exp_q).to(dtype)


def convergence_sweep(problem, ns=(6, 8, 12, 16, 24, 32), **kwargs) -> dict:
    """Max-abs error at the unknown points against N: ``{n: error}`` for one
    of the suite's problems (expected: exponential decay)."""
    errors = {}
    for n in ns:
        numeric, exact = problem(n=n, **kwargs)
        errors[n] = float((numeric - exact).abs().max())
    return errors
