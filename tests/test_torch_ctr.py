"""Port parity: concentric-tube robots (models/ctr.py), the Gram quadrature
and the rest of ops/lie.

One ``jax.jit`` holds every JAX reference (a batched ``solve_ctr`` at
B=5, both ``ctr_shape`` methods, ``ctr_stability`` and two telescoping
tips; ~7 s to compile on a CPU): the port matches them within 1e-10.  The
closed-form gates of ``tests/test_ctr.py`` run on the port alone at that
file's tolerances, and the implicit-function derivatives in reverse and
forward mode are held to the port's own central differences.  No gradient
is taken through JAX.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.integrate import solve_ivp
from scipy.optimize import brentq

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    ctr as jctr,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    chebyshev as jcheb,
    lie as jlie,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    ctr,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    chebyshev,
    lie,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

G_OVER_K = 1.0 / 1.3
F64 = torch.float64


def _pair(mod, kappa, stiff_ratio=1.0, n=24, length=1.0):
    """tests/test_ctr.py's two-tube pair: tube 1 scaled by ``stiff_ratio``,
    ``g = k / 1.3``."""
    return mod.CTRConfig(
        tubes=(mod.Tube(kappa, stiff_ratio, stiff_ratio * G_OVER_K),
               mod.Tube(kappa, 1.0, G_OVER_K)), n=n, length=length)


def _pair_with_c(c, n=24, mod=ctr):
    """Identical tubes whose relative angle obeys phi'' = c sin phi."""
    return _pair(mod, float(np.sqrt(c * G_OVER_K)), n=n)


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


PHIS = np.linspace(0.3, 2.4, 5)
ALPHAS = np.stack([PHIS / 2, -PHIS / 2], axis=-1)          # (5, 2)
OVERLAP, EXTENSION = np.array([0.7, 0.6]), np.array([0.4, 0.5])
JCFG = _pair_with_c(1.0, n=16, mod=jctr)
JTEL = _pair(jctr, 1.5, n=16)


@pytest.fixture(scope="module")
def jax_ref():
    @jax.jit
    def ref(al):
        sol = jctr.solve_ctr(al, JCFG, tol=1e-12)
        pic = jctr.ctr_shape(sol.theta, JCFG, method="picard")
        den = jctr.ctr_shape(sol.theta, JCFG, method="dense")
        tel = jctr.solve_ctr_telescoping(al[:2], jnp.asarray(OVERLAP), jnp.asarray(EXTENSION),
                                         JTEL, method="dense", tol=1e-12)
        return dict(theta=sol.theta, residual=sol.residual, picard_q=pic.quaternions,
                    picard_r=pic.positions, dense_q=den.quaternions, dense_r=den.positions,
                    stability=jctr.ctr_stability(sol.theta, al, JCFG), tip=tel.tip)

    return {k: np.asarray(v) for k, v in ref(jnp.asarray(ALPHAS)).items()}


@pytest.fixture(scope="module")
def port_sol():
    return ctr.solve_ctr(t64(ALPHAS), convert.ctr_config_from_jax(JCFG), tol=1e-12)


def test_batched_solve_matches_jax(jax_ref, port_sol):
    cfg = convert.ctr_config_from_jax(_pair(jctr, 1.2, stiff_ratio=3.0, n=12, length=0.8))
    assert cfg == _pair(ctr, 1.2, stiff_ratio=3.0, n=12, length=0.8)
    assert all(type(v) is float for t in cfg.tubes for v in vars(t).values())
    np.testing.assert_allclose(port_sol.theta.numpy(), jax_ref["theta"], rtol=0, atol=1e-10)
    assert float(port_sol.residual.norm(dim=-1).max()) <= 1e-12
    cfg = convert.ctr_config_from_jax(JCFG)
    for b in (0, 4):                                   # batched == per sample
        single = ctr.solve_ctr(t64(ALPHAS[b]), cfg, tol=1e-12)
        np.testing.assert_allclose(port_sol.theta[b].numpy(), single.theta.numpy(), atol=1e-10)


def test_shape_stability_and_telescoping_match_jax(jax_ref, port_sol):
    cfg = convert.ctr_config_from_jax(JCFG)
    for method in ("picard", "dense"):
        shape = ctr.ctr_shape(port_sol.theta, cfg, method=method)
        assert shape.positions.shape == (5, 15, 3)
        np.testing.assert_allclose(shape.quaternions.numpy(), jax_ref[f"{method}_q"], atol=1e-10)
        np.testing.assert_allclose(shape.positions.numpy(), jax_ref[f"{method}_r"], atol=1e-10)
    lam = ctr.ctr_stability(port_sol.theta, t64(ALPHAS), cfg)
    np.testing.assert_allclose(lam.numpy(), jax_ref["stability"], rtol=1e-10, atol=1e-10)
    tel = ctr.solve_ctr_telescoping(t64(ALPHAS[:2]), t64(OVERLAP), t64(EXTENSION),
                                    convert.ctr_config_from_jax(JTEL), method="dense", tol=1e-12)
    np.testing.assert_allclose(tel.tip.numpy(), jax_ref["tip"], atol=1e-10)


def test_gram_matrix_and_lie_match_jax():
    for n, length in ((9, 1.0), (16, 0.7)):
        q = chebyshev.gram_matrix(n, length)
        np.testing.assert_allclose(q, np.asarray(jcheb.gram_matrix(n, length)), rtol=0,
                                   atol=1e-14)
        np.testing.assert_allclose(q.sum(axis=1), chebyshev.clenshaw_curtis_weights(n, length),
                                   atol=1e-14)
        assert not q.flags.writeable
    rng = np.random.default_rng(3)
    cases = {"unskew": (rng.standard_normal((4, 3, 3)),),
             "ad": (rng.standard_normal((4, 6)),),
             "Ad": (rng.standard_normal((4, 3, 3)), rng.standard_normal((4, 3))),
             "quat_to_rot_normalized": (rng.standard_normal((4, 4)),)}
    for name, args in cases.items():
        out = getattr(lie, name)(*(t64(a) for a in args))
        ref = np.asarray(getattr(jlie, name)(*(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-14, err_msg=name)
    np.testing.assert_allclose((out @ out.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), (4, 3, 3)), atol=1e-14)


def _shooting(c, alpha, s):
    """f64 shooting oracle of phi'' = c sin(phi), phi(0) = alpha, phi'(1) =
    0, read at the arclengths ``s``."""
    def run(p):
        return solve_ivp(lambda x, y: [y[1], c * np.sin(y[0])], (0.0, 1.0), [alpha, p],
                         method="DOP853", rtol=1e-13, atol=1e-14, dense_output=True)

    p = brentq(lambda p: run(p).y[1, -1], -20.0, 0.0, xtol=1e-15, rtol=1e-15)
    return run(p).sol(s)[0]


def _gate_aligned_pair():
    cfg = _pair(ctr, 2.0, stiff_ratio=3.0)
    alphas = t64([0.7, 0.7])
    sol = ctr.solve_ctr(alphas, cfg)
    np.testing.assert_allclose(sol.theta.numpy(), 0.7, rtol=0, atol=1e-12)
    assert int(sol.iterations) == 0
    assert float(ctr.ctr_stability(sol.theta, alphas, cfg)) > 0.0


def _gate_cosh():
    c, phi0 = 1.44, 1e-3
    cfg = _pair_with_c(c)
    theta = ctr.solve_ctr(t64([phi0 / 2, -phi0 / 2]), cfg, tol=1e-13).theta.numpy()
    s = chebyshev.cgl_points(24)
    exact = phi0 * np.cosh(np.sqrt(c) * (1.0 - s)) / np.cosh(np.sqrt(c))
    np.testing.assert_allclose(theta[0] - theta[1], exact, rtol=5e-8)


def _gate_shooting():
    c, alpha = 1.44, 2.4
    theta = ctr.solve_ctr(t64([alpha / 2, -alpha / 2]), _pair_with_c(c), tol=1e-13).theta.numpy()
    exact = _shooting(c, alpha, chebyshev.cgl_points(24))
    np.testing.assert_allclose(theta[0] - theta[1], exact, rtol=2e-8, atol=2e-9)


def _gate_spectral():
    tips = {}
    for n in (10, 14, 28):
        th = ctr.solve_ctr(t64([1.0, -1.0]), _pair_with_c(2.25, n=n), tol=1e-13).theta.numpy()
        tips[n] = th[0, 0] - th[1, 0]
    e10, e14 = abs(tips[10] - tips[28]), abs(tips[14] - tips[28])
    assert e14 < 1e-9, e14
    assert e14 < e10 * 0.2 or e10 < 1e-12


def _gate_snap():
    alphas = t64([np.pi / 2, -np.pi / 2])
    for margin, stable in ((0.9, True), (1.1, False)):
        cfg = _pair_with_c((margin * np.pi / 2) ** 2)
        assert np.isclose(ctr.two_tube_snap_parameter(cfg), margin * np.pi / 2, rtol=1e-12)
        sol = ctr.solve_ctr(alphas, cfg)
        np.testing.assert_allclose((sol.theta[0] - sol.theta[1]).numpy(), np.pi, atol=1e-12)
        lam = float(ctr.ctr_stability(sol.theta, alphas, cfg))
        assert (lam > 0) == stable, (margin, lam)


def _gate_bistability():
    c = (1.15 * np.pi / 2) ** 2
    cfg = _pair_with_c(c)
    alphas = t64([np.pi / 2, -np.pi / 2])
    s = chebyshev.cgl_points(24)
    branches = []
    for sign in (1.0, -1.0):
        pert = sign * np.sin(np.sqrt(c) * s)      # the unstable mode, finite amplitude
        theta0 = t64(np.stack([np.pi / 2 + pert / 2, -np.pi / 2 - pert / 2]))
        sol = ctr.solve_ctr(alphas, cfg, theta0=theta0, tol=1e-12)
        assert float(sol.residual.norm()) < 1e-10
        assert float(ctr.ctr_stability(sol.theta, alphas, cfg)) > 0.0
        branches.append(float(sol.theta[0, 0] - sol.theta[1, 0]))
    lo, hi = sorted(branches)
    assert hi - np.pi > 0.05 and np.pi - lo > 0.05
    np.testing.assert_allclose(hi - np.pi, np.pi - lo, rtol=1e-6)


def _gate_circle():
    """Aligned tubes bend on a circle of the blended curvature; the same
    shape from the modal rod solver.  Pins the explicit 1/2 of the ODE."""
    kap1, kap2, k1, alpha = 2.0, 1.0, 3.0, 0.3
    cfg = ctr.CTRConfig(tubes=(ctr.Tube(kap1, k1, k1 / 1.3), ctr.Tube(kap2, 1.0, 1.0 / 1.3)),
                        n=16)
    sol = ctr.solve_ctr(t64([alpha, alpha]), cfg)
    shape = ctr.ctr_shape(sol.theta, cfg, method="dense")
    kc = (k1 * kap1 + kap2) / (k1 + 1.0)
    s = chebyshev.cgl_points(16)[:-1]
    a_cross_e1 = np.array([0.0, np.sin(alpha), -np.cos(alpha)])
    exact = ((np.sin(kc * s) / kc)[:, None] * np.array([1.0, 0.0, 0.0])
             + ((1 - np.cos(kc * s)) / kc)[:, None] * a_cross_e1)
    np.testing.assert_allclose(shape.positions.numpy(), exact, atol=1e-11)
    ref = rod.rod_shape(t64([0.0, kc * np.cos(alpha), kc * np.sin(alpha)]),
                        cfg=rod.RodConfig(n=16, na=3, ne=1), method="dense")
    np.testing.assert_allclose(shape.positions.numpy(), ref.positions.numpy(), atol=1e-12)
    np.testing.assert_allclose(shape.quaternions.numpy(), ref.quaternions.numpy(), atol=1e-12)


def _gate_mean_twist():
    sol = ctr.solve_ctr(t64([1.3, 0.1]), _pair_with_c(1.44, n=20), tol=1e-13)
    np.testing.assert_allclose((0.5 * (sol.theta[0] + sol.theta[1])).numpy(), 0.7, rtol=0,
                               atol=1e-11)


def _gate_telescoping():
    """extension -> 0 is the plain robot; aligned tubes give two arcs."""
    cfg = _pair(ctr, 1.5, n=16)
    alphas = t64([0.6, -0.4])
    tel = ctr.solve_ctr_telescoping(alphas, 1.0, 1e-9, cfg, method="dense", tol=1e-12)
    plain = ctr.solve_ctr(alphas, cfg, tol=1e-12)
    base_tip = ctr.ctr_shape(plain.theta, cfg, method="dense").positions[0]
    np.testing.assert_allclose(tel.tip.numpy(), base_tip.numpy(), atol=1e-8)
    alpha, rho, ext, kap = 0.25, 0.6, 0.5, 1.5
    tel = ctr.solve_ctr_telescoping(t64([alpha, alpha]), rho, ext, cfg, method="dense",
                                    tol=1e-12)
    a_cross_e1 = np.array([0.0, np.sin(alpha), -np.cos(alpha)])
    e1 = np.array([1.0, 0.0, 0.0])

    def arc(s):
        return (np.sin(kap * s) / kap) * e1 + ((1 - np.cos(kap * s)) / kap) * a_cross_e1

    axis, ang, v = np.array([0.0, np.cos(alpha), np.sin(alpha)]), kap * rho, arc(ext)
    rotated = (v * np.cos(ang) + np.cross(axis, v) * np.sin(ang)
               + axis * np.dot(axis, v) * (1 - np.cos(ang)))
    np.testing.assert_allclose(tel.tip.numpy(), arc(rho) + rotated, atol=1e-10)


GATES = {"aligned_pair": _gate_aligned_pair, "cosh": _gate_cosh, "shooting": _gate_shooting,
         "spectral": _gate_spectral, "snap": _gate_snap, "bistability": _gate_bistability,
         "circle": _gate_circle, "mean_twist": _gate_mean_twist,
         "telescoping": _gate_telescoping}


@pytest.mark.parametrize("gate", list(GATES))
def test_closed_form_gates(gate):
    GATES[gate]()


IFT_CFG = _pair_with_c(1.44, n=16)
IFT_ALPHAS, EPS = np.array([0.9, -0.7]), 1e-6


def _tip(a, length):
    theta = ctr.solve_ctr_differentiable(a, IFT_CFG, length=length, tol=1e-12)
    return ctr.ctr_shape(theta, IFT_CFG, length=length, method="dense").positions[0]


def _tel_tip_x(rho):
    return ctr.solve_ctr_telescoping(t64([0.8, -0.5]), rho, 0.4, _pair(ctr, 1.2, n=16),
                                     differentiable=True, tol=1e-12).tip[0]


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_ift_jacobian_matches_central_differences(mode):
    jac = torch.func.jacrev if mode == "reverse" else torch.func.jacfwd
    a, ell = t64(IFT_ALPHAS), torch.tensor(1.0, dtype=F64)
    jac_a, jac_l = jac(_tip, argnums=(0, 1))(a, ell)
    for j in range(2):
        da = torch.zeros(2, dtype=F64)
        da[j] = EPS
        fd = (_tip(a + da, ell) - _tip(a - da, ell)) / (2 * EPS)
        np.testing.assert_allclose(jac_a[:, j].numpy(), fd.numpy(), rtol=2e-5, atol=1e-8)
    fd_l = (_tip(a, ell + EPS) - _tip(a, ell - EPS)) / (2 * EPS)
    np.testing.assert_allclose(jac_l.numpy(), fd_l.numpy(), rtol=2e-5, atol=1e-8)
    if mode == "reverse":                  # torch.autograd's backward is the same rule
        a_req, ell_req = a.clone().requires_grad_(), ell.clone().requires_grad_()
        _tip(a_req, ell_req)[2].backward()
        np.testing.assert_allclose(a_req.grad.numpy(), jac_a[2].numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(ell_req.grad), float(jac_l[2]), rtol=1e-12)
    # telescoping: d tip_x / d overlap
    rho = torch.tensor(0.7, dtype=F64)
    g = (torch.func.grad if mode == "reverse" else torch.func.jacfwd)(_tel_tip_x)(rho)
    fd = (_tel_tip_x(rho + EPS) - _tel_tip_x(rho - EPS)) / (2 * EPS)
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-5, atol=1e-8)


def test_wrong_tube_count_and_nested_forward_mode_raise():
    with pytest.raises(ValueError, match="tubes"):
        ctr.solve_ctr(t64([0.1, 0.2, 0.3]), IFT_CFG)
    with pytest.raises(ValueError, match="two-tube"):
        three = ctr.CTRConfig(tubes=IFT_CFG.tubes + IFT_CFG.tubes[:1], n=8)
        ctr.solve_ctr_telescoping(t64([0.1, 0.2, 0.3]), 0.5, 0.5, three)
    a, ell = t64(IFT_ALPHAS), torch.tensor(1.0, dtype=F64)
    with pytest.raises(RuntimeError, match="reverse mode"):
        torch.func.jacfwd(torch.func.jacfwd(lambda aa: _tip(aa, ell)[2]))(a)
