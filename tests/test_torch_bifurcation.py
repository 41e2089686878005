"""Port parity: the bifurcation tools (models/bifurcation.py).

The gates of ``tests/test_bifurcation.py`` on the port: Euler buckling of
the axially compressed cantilever (the pencil eigenvalue against the JAX
package's on the same discretization, and against ``pi^2 EI / (4 L^2)``),
its detection and classification along the host Riks path, the walks onto
the post-buckling branch (host, and batched on K1 + K2, their plain
versions on the CPU), the determinant monitor of the batched walker, and
the imperfection fold.  JAX critical points reach the port through
``utils/convert``.
"""

import numpy as np
import pytest
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    bifurcation as jbif,
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

AXIAL = torch.tensor((-1.0, 0.0, 0.0), dtype=torch.float64)   # compressive dead tip force
EULER_CANTILEVER = np.pi ** 2 / 4.0                           # EI = 1, L = 1
ISO = cosserat.StaticsConfig(rod=rod.RodConfig(n=16))
ANISO = cosserat.StaticsConfig(rod=rod.RodConfig(n=16), stiffness=(1.0, 1.0, 1.3))


def _positive(lams):
    return lams[lams > 0]


@pytest.mark.parametrize("ne", [3, 5])
def test_linearized_buckling_matches_jax_and_euler(ne):
    """The smallest positive pencil eigenvalue is Euler's load up to the
    Legendre basis' Galerkin error (2% at ne=3, 2e-4 at ne=5, from above),
    and the JAX package's on the same discretization."""
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=16, ne=ne))
    lams = _positive(bifurcation.linearized_buckling_loads(AXIAL, cfg=cfg))
    ref = _positive(jbif.linearized_buckling_loads(
        tuple(AXIAL.tolist()), cfg=jcos.StaticsConfig(rod=jrod.RodConfig(n=16, ne=ne))))
    np.testing.assert_allclose(lams, ref, rtol=1e-10)
    assert abs(lams[0] - EULER_CANTILEVER) < {3: 0.02, 5: 2e-4}[ne] * EULER_CANTILEVER
    assert lams[0] >= EULER_CANTILEVER
    with pytest.raises(ValueError, match="trivial branch"):
        bifurcation.linearized_buckling_loads(torch.tensor((0.0, 0.0, -1.0),
                                                           dtype=torch.float64), cfg=cfg)


@pytest.fixture(scope="module")
def pitchfork():
    """The trivial branch walked through the isotropic column's buckling
    load, its stability monitors and its critical points."""
    path = cosserat.arc_length_continuation(AXIAL, cfg=ISO, ds=0.35, steps=9, tol=1e-10)
    stab = bifurcation.path_stability(path, AXIAL, cfg=ISO)
    return path, stab, bifurcation.detect_critical_points(path, AXIAL, cfg=ISO, stability=stab)


def test_detect_and_classify_pitchfork(pitchfork):
    path, stab, points = pitchfork
    assert path.converged.all() and float(path.qes.abs().max()) < 1e-8
    assert float(path.lambdas[-1]) > EULER_CANTILEVER
    assert (stab.det_sign != 0).all() and stab.n_unstable[0] == 0 and stab.n_unstable[-1] >= 1
    cp = points[0]
    lam_pencil = _positive(bifurcation.linearized_buckling_loads(AXIAL, cfg=ISO))[0]
    assert cp.kind == "branch" and abs(cp.lam - lam_pencil) < 1e-6 * lam_pencil
    assert float(cp.qe.norm()) < 1e-8
    assert float(cp.null_vector[:ISO.rod.ne].norm()) < 1e-6     # bends, does not twist


def test_switch_branch_walks_supercritical_postbuckling(pitchfork):
    cp = pitchfork[2][0]
    branch = bifurcation.switch_branch(cp, AXIAL, cfg=ISO, ds=0.25, steps=6, tol=1e-9)
    assert branch.converged.all()
    amp = branch.qes.norm(dim=1)
    assert amp[0] > 1e-3 and amp[-1] > amp[0]
    assert (branch.lambdas > cp.lam - 1e-6).all() and branch.lambdas[-1] > cp.lam + 1e-3
    mirror = bifurcation.switch_branch(cp, AXIAL, cfg=ISO, direction=-1.0, ds=0.25, steps=6,
                                       tol=1e-9)
    torch.testing.assert_close(mirror.qes, -branch.qes, rtol=0, atol=1e-6)
    torch.testing.assert_close(mirror.lambdas, branch.lambdas, rtol=0, atol=1e-6)
    res = cosserat.equilibrium_residual(branch.qes[-1], branch.lambdas[-1] * AXIAL,
                                        torch.zeros(3, dtype=torch.float64), ISO)
    assert float(res.norm()) < 1e-8


@pytest.fixture(scope="module")
def aniso_branch_point():
    path = cosserat.arc_length_continuation(AXIAL, cfg=ANISO, ds=0.35, steps=9, tol=1e-10)
    cp = bifurcation.detect_critical_points(path, AXIAL, cfg=ANISO)[0]
    assert cp.kind == "branch"
    return cp


def test_batched_detsign_monitor_brackets_buckling():
    """The batched walker's det(J) flips exactly once, in the segment that
    holds the (simple) buckling eigenvalue of the anisotropic column."""
    lam_c = _positive(bifurcation.linearized_buckling_loads(AXIAL, cfg=ANISO))[0]
    walk = cosserat.arc_length_continuation_batched(AXIAL.float().expand(2, 3), cfg=ANISO,
                                                    ds=0.35, steps=9, tol=1e-4, iters=16,
                                                    monitor_stability=True)
    assert walk.converged.all() and torch.isfinite(walk.log_abs_det).all()
    for s in range(2):
        flips = np.nonzero(np.diff(walk.det_sign[:, s].numpy()) != 0)[0]
        assert flips.size == 1
        assert walk.lambdas[flips[0], s] < lam_c < walk.lambdas[flips[0] + 1, s]


def test_switch_branch_batched_matches_host_walks(aniso_branch_point):
    """Both pitchfork branches in one batched walk, each within 1e-4 of its
    host walk, mirror images of each other.  The critical point goes
    through ``critical_point_from_jax`` and back unchanged."""
    cp = aniso_branch_point
    jcp = jbif.CriticalPoint(segment=cp.segment, kind=cp.kind, lam=cp.lam,
                             qe=cp.qe.numpy(), null_vector=cp.null_vector.numpy(),
                             coupling=cp.coupling)
    back = convert.critical_point_from_jax(jcp, device="cpu")
    assert (back.segment, back.kind, back.lam, back.coupling) == \
        (cp.segment, cp.kind, cp.lam, cp.coupling)
    assert torch.equal(back.qe, cp.qe) and torch.equal(back.null_vector, cp.null_vector)
    walk = bifurcation.switch_branch_batched(
        back.qe.float().expand(2, 9), back.lam, back.null_vector.float().expand(2, 9),
        AXIAL.float().expand(2, 3), cfg=ANISO, directions=torch.tensor([1.0, -1.0]), ds=0.4,
        steps=6, tol=2e-5, max_corrector=15, iters=16)
    assert walk.converged.all()
    for d, s in ((1.0, 0), (-1.0, 1)):
        host = bifurcation.switch_branch(back, AXIAL, cfg=ANISO, direction=d, ds=0.4, steps=6,
                                         tol=1e-9)
        assert host.converged.all()
        np.testing.assert_allclose(walk.lambdas[:, s].numpy(), host.lambdas.numpy(), atol=1e-4)
        np.testing.assert_allclose(walk.qes[:, s].numpy(), host.qes.numpy(), atol=1e-4)
    torch.testing.assert_close(walk.qes[:, 0], -walk.qes[:, 1], rtol=0, atol=1e-5)


def test_imperfection_unfolds_pitchfork_into_fold(aniso_branch_point):
    """A small transverse load component unfolds the pitchfork: walking the
    complementary branch down from a high anchor, the nose classifies as a
    fold just above the perfect buckling load, and the z-plane pitchfork
    at 1.3 x that load as a branch point with zero coupling."""
    cp = aniso_branch_point
    lam_c = _positive(bifurcation.linearized_buckling_loads(AXIAL, cfg=ANISO))[0]
    d = 1.0 if cp.null_vector[ANISO.rod.ne] > 0 else -1.0        # +kappa_y side
    branch = bifurcation.switch_branch(cp, AXIAL, cfg=ANISO, direction=d, ds=0.4, steps=8,
                                       tol=1e-9)
    f_eps = torch.tensor((-1.0, 0.0, 0.01), dtype=torch.float64)
    lam_hi = float(branch.lambdas[-1])
    anchor = cosserat.solve_statics(lam_hi * f_eps, cfg=ANISO, qe0=branch.qes[-1], tol=1e-10,
                                    max_iter=50)
    assert bool(anchor.converged)
    walk = cosserat.arc_length_continuation(f_eps, cfg=ANISO, qe0=anchor.qe, lambda_start=lam_hi,
                                            ds=0.3, steps=14, tol=1e-9, direction=-1.0)
    assert walk.converged.all()
    assert walk.lambdas.min() > lam_c and (walk.lambdas.diff() > 0).any()
    points = bifurcation.detect_critical_points(walk, f_eps, cfg=ANISO)
    folds = [p for p in points if p.kind == "fold"]
    branches = [p for p in points if p.kind == "branch"]
    assert folds and branches, [p.kind for p in points]
    assert lam_c < folds[0].lam < lam_c + 0.35 and folds[0].coupling > 0.3
    assert abs(branches[0].lam - 1.3 * lam_c) < 1e-3 * lam_c and branches[0].coupling < 1e-6
