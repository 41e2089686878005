"""Port parity: load and arc-length continuation (models/cosserat.py).

The port's host Riks walker is held to the JAX package's on the same load
ray (f64, Picard kinematics); ``load_continuation`` retraces that path; the
batched walker (K1 + K2 per corrector iterate, K3 too in its dd tier; their
plain versions on the CPU) is held to the port's host walker with the gates
of ``tests/test_cosserat_statics.py:333-390``, and its determinant monitors
to NumPy's ``slogdet`` of the path's f64 Jacobians.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    cosserat as jcos,
    rod as jrod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    bifurcation,
    cosserat,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

CFG = cosserat.StaticsConfig(rod=rod.RodConfig(n=16))
LOAD_REFS = np.asarray([[0.0, 0.0, 0.6], [0.3, 0.0, 0.4], [0.0, 0.2, -0.5]], np.float32)  # :337
ZERO = torch.zeros(3, dtype=torch.float64)


def _ref(s):
    """Ray ``s`` in f64: the f32 values the batched walker sees."""
    return torch.tensor(LOAD_REFS[s], dtype=torch.float64)


@pytest.fixture(scope="module")
def host_paths():
    """The JAX host walker and the port's on ray 0 (8 steps, tol 1e-9)."""
    kw = dict(ds=0.25, steps=8, tol=1e-9, method="picard")
    jpath = jcos.arc_length_continuation(jnp.asarray(LOAD_REFS[0], jnp.float64),
                                         cfg=jcos.StaticsConfig(rod=jrod.RodConfig(n=16)), **kw)
    return jpath, cosserat.arc_length_continuation(_ref(0), cfg=CFG, **kw)


def test_host_riks_matches_jax(host_paths):
    jpath, path = host_paths
    assert path.converged.all() and path.qes.dtype == torch.float64
    np.testing.assert_allclose(path.lambdas.numpy(), np.asarray(jpath.lambdas), rtol=0, atol=1e-10)
    np.testing.assert_allclose(path.qes.numpy(), np.asarray(jpath.qes), rtol=0, atol=1e-10)
    # the JAX path through the converter: the same equilibria to the port
    mine = convert.continuation_path_from_jax(jpath, device="cpu")
    res = cosserat.equilibrium_residual(mine.qes, mine.lambdas[:, None, None] * _ref(0), ZERO, CFG)
    assert mine.converged.all() and float(res.abs().max()) < 1e-9


def test_load_continuation_retraces_the_path(host_paths):
    """Warm-started Newton over the path's own load factors (monotone on
    this ray) lands on the path's equilibria."""
    _, path = host_paths
    sols = cosserat.load_continuation(path.lambdas[:, None] * _ref(0), cfg=CFG, tol=1e-11)
    assert len(sols) == path.lambdas.shape[0] and all(bool(s.converged) for s in sols)
    np.testing.assert_allclose(torch.stack([s.qe for s in sols]).numpy(), path.qes.numpy(),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("tier", ["f32", "dd"])
def test_batched_riks_matches_host_walker(tier):
    """:333 (f32: lambda within 5e-3, qe within 2e-2 of the host walker
    after 8 steps) and :357 (dd: within 1e-6 of the host f64 dense walker,
    and the last point a true equilibrium at its dd load factor to 1e-8)."""
    if tier == "f32":
        rays, kw, host_kw = 3, dict(steps=8, tol=2e-5), dict(steps=8, tol=1e-9, method="picard")
        lam_tol, qe_tol = 5e-3, 2e-2
    else:
        rays, kw = 2, dict(steps=5, tol=1e-8, max_corrector=20, dd_residual=True)
        host_kw, lam_tol, qe_tol = dict(steps=5, tol=1e-11, method="dense"), 1e-6, 1e-6
    walk = cosserat.arc_length_continuation_batched(torch.tensor(LOAD_REFS[:rays]), cfg=CFG,
                                                    ds=0.25, iters=16, **kw)
    assert walk.converged.all() and walk.qes.shape == (kw["steps"], rays, 9)
    lam, qes = walk.lambdas.double(), walk.qes.double()
    if tier == "dd":
        lam, qes = lam + walk.lambdas_lo.double(), qes + walk.qes_lo.double()
    for s in range(rays):
        host = cosserat.arc_length_continuation(_ref(s), cfg=CFG, ds=0.25, **host_kw)
        assert host.converged.all()
        np.testing.assert_allclose(lam[:, s].numpy(), host.lambdas.numpy(), rtol=0, atol=lam_tol)
        np.testing.assert_allclose(qes[:, s].numpy(), host.qes.numpy(), rtol=0, atol=qe_tol)
        if tier == "dd":
            r = cosserat.equilibrium_residual(qes[-1, s], lam[-1, s] * _ref(s), ZERO, CFG,
                                              method="dense")
            assert float(torch.linalg.vector_norm(r)) < 1e-8


def test_batched_monitors_match_numpy_slogdet():
    """:511: the walker's det_sign/log_abs_det at each point against
    NumPy's slogdet of the f64 equilibrium Jacobian there (f32 Jacobians
    from the kernels' tangents: the log within 1e-3)."""
    walk = cosserat.arc_length_continuation_batched(torch.tensor(LOAD_REFS[:2]), cfg=CFG,
                                                    ds=0.25, steps=4, tol=2e-5, iters=16,
                                                    monitor_stability=True)
    assert walk.converged.all() and walk.det_sign.shape == (4, 2)
    for s in range(2):
        jacs = bifurcation.path_jacobians(walk.qes[:, s].double(), walk.lambdas[:, s].double(),
                                          _ref(s), CFG).numpy()
        sign, logabs = np.linalg.slogdet(jacs)
        np.testing.assert_array_equal(walk.det_sign[:, s].numpy(), sign)
        np.testing.assert_allclose(walk.log_abs_det[:, s].numpy(), logabs, rtol=0, atol=1e-3)
