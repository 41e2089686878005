"""Port parity: shape sensing (models/sensing.py), calibration
(models/calibration.py) and ``ops/chebyshev.interpolation_matrix``.

The same numpy ``default_rng`` inputs and one JAX ``SensingConfig`` (carried
over by ``utils/convert``) go through the JAX package's ``measure``,
``fit_strain``, ``posterior_covariance`` and the ``value_and_grad`` of
``calibration_loss``, compiled as one ``jax.jit``, and through the port, at
f64: the measurement map within 1e-10, converged strains within 1e-8 (both
sides to tol 1e-11), gradients within 1e-9 relative.  The port is also held
to ``tests/test_sensing.py``'s gates (noise-free recovery, batched equals
looped, tip-load identification) at n=12, and the fused measurement (K1,
its plain version on the CPU) is held to the picard one and refused by the
differentiated calls.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    calibration as jcal,
    rod as jrod,
    sensing as jsen,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    chebyshev as jcheb,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    calibration,
    cosserat,
    rod,
    sensing,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    chebyshev,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

N = 12
JROD = jrod.RodConfig(n=N)
# every channel: markers, a strain station, pose stations, the tip frame
JALL = jsen.SensingConfig(rod=JROD, marker_fracs=(0.3, 0.6), strain_fracs=(0.2, 0.7),
                          pose_fracs=(0.5, 1.0), use_tip_quaternion=True, quat_weight=0.5)
# tests/test_sensing.py:150-163 (batched fit) at n=12
JFIT = jsen.SensingConfig(rod=JROD, marker_fracs=(0.3, 0.6), pose_fracs=(0.5, 1.0))
TOL = 1e-11


def _inputs():
    rng = np.random.default_rng(3)
    return dict(qes=0.6 * rng.standard_normal((3, 9)),
                w=0.3 * rng.standard_normal((4, 9)), b=0.1 * rng.standard_normal(9),
                features=rng.standard_normal((4, 4)),
                targets=np.array([0.8, 0.0, 0.0]) + 0.3 * rng.standard_normal((4, 3)))


@jax.jit
def _jax_reference(x):
    ys = jsen.measure(x["qes"], JFIT)
    fit = jsen.fit_strain(ys, JFIT, tol=TOL, max_iter=30)
    loss, grads = jax.value_and_grad(jcal.calibration_loss)(
        jcal.CalibrationParams(w=x["w"], b=x["b"]), x["features"], x["targets"], JROD)
    return dict(y_all=jsen.measure(x["qes"], JALL), ys=ys, fit=fit.qe,
                cov=jsen.posterior_covariance(x["qes"][0], JFIT, 1e-5),
                loss=loss, grad_w=grads.w, grad_b=grads.b)


@pytest.fixture(scope="module")
def jax_ref():
    return {k: np.asarray(v) for k, v in _jax_reference(_inputs()).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(mine, theirs, tol, what):
    err = float(np.abs(mine.detach().numpy() - theirs).max())
    assert err < tol, (what, err)


def test_interpolation_matrix_matches_jax():
    """Within 1e-14 of the JAX rows (off-grid and on a node); exact at the
    nodes and for polynomials of degree <= n-1 (tests/test_sensing.py:34-51);
    a target off the rod raises."""
    xs = (0.05, 0.31, 0.5, 0.77, float(chebyshev.cgl_points(N)[3]), 1.0)
    p = chebyshev.interpolation_matrix(N, xs)
    assert np.abs(p - jcheb.interpolation_matrix(N, xs)).max() < 1e-14
    x = chebyshev.cgl_points(N)
    np.testing.assert_allclose(chebyshev.interpolation_matrix(N, tuple(x.tolist())), np.eye(N),
                               atol=1e-13)
    for deg in range(N):
        np.testing.assert_allclose(p @ x ** deg, np.asarray(xs) ** deg, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        chebyshev.interpolation_matrix(8, (1.2,))


def test_measure_matches_jax(jax_ref):
    """Markers, strain stations, pose stations and the tip frame, batched,
    within 1e-10 of JAX; the tip quaternion's w is canonicalized >= 0."""
    cfg = convert.sensing_config_from_jax(JALL)
    y = sensing.measure(_t(_inputs()["qes"]), cfg)
    assert y.shape == (3, sensing.measurement_size(cfg)) == jax_ref["y_all"].shape
    _close(y, jax_ref["y_all"], 1e-10, "measure")
    assert bool((y[:, -4] >= 0).all())
    _close(sensing.measure(_t(_inputs()["qes"]), convert.sensing_config_from_jax(JFIT)),
           jax_ref["ys"], 1e-10, "measure (markers + pose)")


def test_fused_measure_matches_picard_and_is_refused_by_the_estimators():
    """method='fused' (K1; its plain version on the CPU) within the f32 gate
    5e-5 of the picard measurement, in qe's dtype; the calls that
    differentiate measure raise a ValueError up front."""
    fused = sensing.SensingConfig(rod=rod.RodConfig(n=N), use_tip_quaternion=True,
                                  method="fused")
    qes = _t(_inputs()["qes"])
    y = sensing.measure(qes, fused)
    assert y.dtype == torch.float64
    ref = sensing.measure(qes, sensing.SensingConfig(rod=rod.RodConfig(n=N),
                                                     use_tip_quaternion=True))
    assert float((y - ref).abs().max()) < 5e-5
    for call in (lambda: sensing.fit_strain(y, fused),
                 lambda: sensing.posterior_covariance(qes[0], fused),
                 lambda: sensing.identify_tip_load(y[0, :12], fused)):
        with pytest.raises(ValueError, match="fused"):
            call()


def test_fit_strain_matches_jax_and_recovers_the_batch(jax_ref):
    """The batched fit to tol 1e-11 within 1e-8 of JAX's; the truth within
    1e-7 and each sample's own fit equal to the batched one
    (tests/test_sensing.py:150-163); posterior covariance within 1e-9
    relative."""
    cfg = convert.sensing_config_from_jax(JFIT)
    qes = _t(_inputs()["qes"])
    ys = sensing.measure(qes, cfg)
    sol = sensing.fit_strain(ys, cfg, tol=TOL, max_iter=30)
    _close(sol.qe, jax_ref["fit"], 1e-8, "fit_strain vs JAX")
    _close(sol.qe, qes.numpy(), 1e-7, "fit_strain vs truth")
    single = sensing.fit_strain(ys[1], cfg, tol=1e-12, max_iter=30)
    _close(single.qe, sol.qe[1].numpy(), 1e-7, "single vs batched")
    cov = sensing.posterior_covariance(qes[0], cfg, 1e-5)
    _close(cov, jax_ref["cov"], 1e-9 * float(np.abs(jax_ref["cov"]).max()), "covariance")


def test_fit_strain_recovers_exactly_from_pose_stations():
    """tests/test_sensing.py:109-123 at n=12: noise-free pose stations pin
    every mode, qe within 1e-8 and the residual below 1e-10."""
    cfg = sensing.SensingConfig(rod=rod.RodConfig(n=N), marker_fracs=(),
                                pose_fracs=(1 / 3, 2 / 3, 1.0))
    qe_true = torch.tensor([0.35, -0.2, 0.1, 1.0, -0.5, 0.2, -0.6, 0.3, -0.1],
                           dtype=torch.float64)
    sol = sensing.fit_strain(sensing.measure(qe_true, cfg), cfg, tol=1e-12, max_iter=30)
    _close(sol.qe, qe_true.numpy(), 1e-8, "recovery")
    assert float(sol.residual_norm) < 1e-10


def test_identify_tip_load_recovers_the_force():
    """tests/test_sensing.py:199-214 at n=12: the tip force within 1e-7 and
    the residual below 1e-9."""
    rc = rod.RodConfig(n=N)
    cfg, sc = sensing.SensingConfig(rod=rc), cosserat.StaticsConfig(rod=rc)
    f_true = torch.tensor([0.12, -0.08, 0.2], dtype=torch.float64)
    qe_star = cosserat.solve_statics(f_true, torch.zeros(3, dtype=torch.float64), sc,
                                     tol=1e-12).qe
    theta, sol = sensing.identify_tip_load(sensing.measure(qe_star, cfg), cfg, statics=sc,
                                           tol=1e-12, max_iter=20, statics_tol=1e-12)
    _close(theta, f_true.numpy(), 1e-7, "tip force")
    assert float(sol.residual_norm) < 1e-9


def test_calibration_value_and_grad_match_jax_and_training_descends(jax_ref):
    """calibration_loss and its gradient (the backward pass through the
    Picard autograd.Function) within 1e-9 relative of JAX's value_and_grad
    at the same params; five Adam steps of make_train_step lower the loss."""
    x = _inputs()
    params = convert.calibration_params_from_jax(jcal.CalibrationParams(w=x["w"], b=x["b"]),
                                                 "cpu")
    for p in params:
        p.requires_grad_(True)
    rc = rod.RodConfig(n=N)
    loss = calibration.calibration_loss(params, _t(x["features"]), _t(x["targets"]), rc)
    g_w, g_b = torch.autograd.grad(loss, list(params))
    assert abs(loss.item() - float(jax_ref["loss"])) < 1e-9 * abs(float(jax_ref["loss"]))
    scale = max(np.abs(jax_ref["grad_w"]).max(), np.abs(jax_ref["grad_b"]).max())
    _close(g_w, jax_ref["grad_w"], 1e-9 * scale, "grad w")
    _close(g_b, jax_ref["grad_b"], 1e-9 * scale, "grad b")

    p0 = calibration.init_params(4, rc, device="cpu")
    assert p0.w.shape == (4, 9) and p0.w.dtype == torch.float32 and not bool(p0.b.any())
    torch.testing.assert_close(p0.w, calibration.init_params(4, rc, device="cpu").w)
    step, make_opt = calibration.make_train_step(cfg=rc)
    opt = make_opt(p0)
    feats, tgts = (torch.tensor(x[k], dtype=torch.float32) for k in ("features", "targets"))
    losses = []
    for _ in range(5):
        p0, opt, loss = step(p0, opt, feats, tgts)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
