"""Port parity: the EKF / RTS estimation layer (models/estimation.py).

One filter step and the RTS pass, at the same ``(x, P, y)`` (numpy
``default_rng`` inputs, one JAX ``FilterConfig`` carried over by
``utils/convert``, ``tests/test_estimation.py``'s configuration), within
1e-9 relative of JAX.  The JAX step is the JAX package's own ``ekf``, its
process model replaced by the affine map ``x -> x_pred + F (x - x0)`` built
from JAX's ``_rk4_step`` (one ``jax.jit``: the prediction and ``F`` by a
fourth-order central difference, error ~1e-12): linearizing JAX's RK4 step
by forward mode costs ~40 s to trace and compile on a CPU, its forward step
~10 s.  The measurement update (``measure``, its Jacobian, the Joseph form,
the NIS) is JAX's own (the filter and the inputs' ``measure`` each under
one ``jax.jit``).  ``simulate_measurements`` and the smoothed
covariances are held to the JAX test's symmetric-PSD gate; the NEES gate
runs on the card (``chip_smoke.py`` phase 4e).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    cosserat as jcos,
    dynamics as jdyn,
    estimation as jest,
    rod as jrod,
    sensing as jsen,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    estimation,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

# tests/test_estimation.py:20-28
RC = jrod.RodConfig(n=10, na=3, ne=2)
JCFG = jest.FilterConfig(
    dynamics=jdyn.DynamicsConfig(statics=jcos.StaticsConfig(rod=RC), rho_a=1.0, rho_i=1e-2),
    sensing=jsen.SensingConfig(rod=RC, marker_fracs=(), pose_fracs=(0.5, 1.0)), dt=0.01,
    q_accel=1e-10, r_sigma=1e-3)
B, D, H = 2, 12, 1e-3


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    x = np.zeros((B, D))
    x[:, 2], x[:, 9] = 0.4, 0.3                     # tests/test_estimation.py:34-36
    x += 0.01 * rng.standard_normal((B, D))
    a = 1e-2 * rng.standard_normal((B, D, D))
    p = a @ np.swapaxes(a, 1, 2) + 1e-4 * np.eye(D)
    y = np.asarray(jax.jit(jsen.measure, static_argnums=1)(jnp.asarray(x[:, :6] + 1e-3),
                                                            JCFG.sensing))[None]
    y = y + 1e-3 * rng.standard_normal(y.shape)
    return dict(x=x, p=p, y=y)


@jax.jit
def _jax_step(xs):
    """JAX's RK4 step at the stencil states ``xs (4 D + 1, B, D)``."""
    return jest._rk4_step(xs, 0.0, JCFG)


def _jax_prediction(x):
    """``(x_pred, F)`` of JAX's RK4 step at ``x (B, D)``, ``F`` by the central
    difference ``(f(-2h) - 8 f(-h) + 8 f(h) - f(2h)) / 12h`` per column."""
    shifts = np.array([-2.0, -1.0, 1.0, 2.0])
    xs = x[None, None] + H * shifts[:, None, None, None] * np.eye(D)[None, :, None, :]
    out = np.asarray(_jax_step(jnp.asarray(np.concatenate([x[None], xs.reshape(-1, B, D)]))))
    f = out[1:].reshape(4, D, B, D)
    cols = (f[0] - 8.0 * f[1] + 8.0 * f[2] - f[3]) / (12.0 * H)       # (D dir, B, D out)
    return out[0], np.moveaxis(cols, 0, -1)


@pytest.fixture(scope="module")
def jax_ref(monkeypatch_module):
    x = _inputs()
    x_pred, f = _jax_prediction(x["x"])
    x0, xp, fj = jnp.asarray(x["x"]), jnp.asarray(x_pred), jnp.asarray(f)
    monkeypatch_module.setattr(
        jest, "_rk4_step",
        lambda xx, t, cfg, *a: xp + jnp.einsum("...ij,...j->...i", fj, xx - x0))
    res = jax.jit(jest.ekf, static_argnums=1)(jnp.asarray(x["y"]), JCFG, x0, jnp.asarray(x["p"]))
    return {k: np.asarray(v) for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _rel(mine, theirs):
    return float(np.abs(mine.numpy() - theirs).max() / np.abs(theirs).max())


def test_ekf_step_matches_jax(jax_ref):
    """Prior, transition Jacobian, posterior (Joseph form) and NIS of one
    step within 1e-9 relative of JAX's."""
    x = _inputs()
    cfg = convert.filter_config_from_jax(JCFG)
    res = estimation.ekf(torch.tensor(x["y"]), cfg, torch.tensor(x["x"]), torch.tensor(x["p"]))
    for name in res._fields:
        assert getattr(res, name).shape == jax_ref[name].shape, name
        assert _rel(getattr(res, name), jax_ref[name]) < 1e-9, (name, _rel(getattr(res, name),
                                                                            jax_ref[name]))


def test_rts_step_matches_jax_and_smoothed_covariances_stay_psd():
    """Two steps of measurements from simulate_measurements (noise from a
    seeded torch.Generator), the port's filter history smoothed
    by the port and by JAX's rts_smoother within 1e-9 relative; the
    smoothed covariances symmetric to 1e-10 and PSD to -1e-12
    (tests/test_estimation.py:107-120)."""
    x = _inputs()
    cfg = convert.filter_config_from_jax(JCFG)
    x0 = torch.tensor(x["x"])
    gen = torch.Generator().manual_seed(11)
    xs, ys = estimation.simulate_measurements(x0[:, :6], x0[:, 6:], cfg, 2, gen)
    assert xs.shape == (2, B, D) and ys.shape == (2, B, 14)
    res = estimation.ekf(ys, cfg, x0, 1e-3 * torch.eye(D, dtype=torch.float64))
    xs_s, ps_s = estimation.rts_smoother(res, cfg)
    j_xs, j_ps = jest.rts_smoother(jest.FilterResult(*(jnp.asarray(v.numpy()) for v in res)),
                                   JCFG)
    assert _rel(xs_s, np.asarray(j_xs)) < 1e-9 and _rel(ps_s, np.asarray(j_ps)) < 1e-9
    assert float((ps_s - ps_s.transpose(-1, -2)).abs().max()) < 1e-10
    assert float(torch.linalg.eigvalsh(ps_s).min()) > -1e-12
    torch.testing.assert_close(xs_s[-1], res.xs[-1], rtol=0, atol=0)
