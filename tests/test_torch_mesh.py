"""The port's multi-device rod batches (``parallel/mesh.py``) on an 8-shard
CPU mesh, ``make_mesh(devices=[cpu] * 8)``: the counterpart of the JAX
tests' 8 virtual CPU devices (tests/conftest.py:13), each shard in a host
thread of its own.

``sharded_rod_shape('picard')`` is held to JAX's own sharded solve on the
conftest's 8-device mesh (the file's one JAX call).  Every other sharded
entry point is held to the port's unsharded call, which the test file named
per case holds to JAX, at the JAX tests' tolerances (tests/test_parallel.py,
cited per case); the fused and refined rod shapes (their plain twins here)
equal the unsharded call exactly.  Then the semantics the JAX tests pin:
each shard stops on its own test, a batch that does not split evenly
raises, outputs stay sharded 8 ways; the locks that keep threads apart
(forward-mode transforms, launch counts); and that no module of the port
imports JAX.
"""

import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    rod as jrod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.parallel import (
    mesh as jmesh,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    constrained,
    cosserat,
    ctr,
    dynamics,
    estimation,
    magnetics,
    rod,
    segment_statics,
    segments,
    sensing,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    device as device_ops,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    build,
    refined_kernel as rfk,
    rod_kernel as rk,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.parallel import (
    mesh as pm,
)
from torch_threads import one_cpu_thread  # noqa: F401

CPU = torch.device("cpu")
SHARDS = 8
F32, F64 = torch.float32, torch.float64
ROOT = Path(__file__).resolve().parents[1]
PORT = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch"
JAX_PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu"

S8 = cosserat.StaticsConfig(rod=rod.RodConfig(n=8))
SEG = segment_statics.SegmentedStaticsConfig(rods=segments.uniform_segments(2, n=8))
DYN = dynamics.DynamicsConfig(statics=S8, rho_a=1.0, rho_i=1e-2)


@pytest.fixture(scope="module")
def mesh():
    with pm.make_mesh(devices=[CPU] * SHARDS) as m:
        yield m


def _uniform(seed, shape, lo, hi, dtype=F32):
    return torch.tensor(np.random.default_rng(seed).uniform(lo, hi, shape), dtype=dtype)


def _sharded_8_ways(*batches):
    for b in batches:
        assert isinstance(b, pm.ShardedBatch)
        assert len(b.shards) == SHARDS and len(b.devices) == SHARDS


def test_picard_rod_shape_matches_jax_sharded_solve(mesh):
    """tests/test_parallel.py:23-36: B=64, n=8, rtol 1e-5, atol 1e-6."""
    qes = np.random.default_rng(0).standard_normal((64, 9)).astype(np.float32)
    jm = jmesh.make_mesh(8)
    jq, jr = jmesh.sharded_rod_shape(jm, method="picard", cfg=jrod.RodConfig(n=8))(
        jmesh.shard_rods(jm, jnp.asarray(qes)))
    q, r = pm.sharded_rod_shape(mesh, method="picard", cfg=rod.RodConfig(n=8))(
        pm.shard_rods(mesh, torch.tensor(qes)))
    _sharded_8_ways(q, r)
    np.testing.assert_allclose(q.gather().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r.gather().numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)


def _refined(qes, cfg):
    q_hi, q_lo, r_hi, r_lo = rfk.rod_shape_refined_kernel(qes, cfg=cfg)
    return q_hi + q_lo, r_hi + r_lo


@pytest.mark.parametrize("method,unsharded", [
    ("fused", lambda qes, cfg: rk.rod_shape_fused(qes, cfg)),   # tests/test_torch_rod_kernel.py
    ("refined", _refined),                                      # tests/test_torch_refined_kernel.py
])
def test_kernel_rod_shapes_equal_unsharded_call(mesh, method, unsharded):
    """K1 and K3 per rod do not depend on the batch (tests/test_parallel.py:
    122-134 runs the fused kernel sharded), so the sharded call equals the
    unsharded one exactly."""
    cfg = rod.RodConfig()
    qes = torch.tensor(0.8 * np.random.default_rng(3).standard_normal((64, 9)), dtype=F32)
    q, r = pm.sharded_rod_shape(mesh, method=method, cfg=cfg)(qes)
    _sharded_8_ways(q, r)
    q_ref, r_ref = unsharded(qes, cfg)
    assert torch.equal(q.gather(), q_ref) and torch.equal(r.gather(), r_ref)


def _platform_robot():
    """tests/test_parallel.py:311-318."""
    s = float(np.sqrt(2) / 2)
    cfg = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
        rod=rod.RodConfig(n=8, ne=2, na=6), stiffness=(1.0, 1.0, 1.0, 50.0, 25.0, 25.0)))
    bases = ((-0.2, 0.0, 0.0), (0.2, 0.0, 0.0))
    return constrained.PlatformRobot(cfg=cfg, base_positions=bases,
                                     base_quaternions=((s, 0.0, -s, 0.0),) * 2,
                                     attach_points=bases)


def _tendon_cfg():
    return dynamics.DynamicsConfig(statics=S8, tendons=(
        tendon.Tendon(offset=(0.0, 0.0, 0.05)), tendon.Tendon(offset=(0.0, 0.05, 0.0))))


def _magnet_cfg():
    return dynamics.DynamicsConfig(statics=S8, magnets=(magnetics.Magnet(moment=(0.5, 0.0, 0.0)),))


def _statics_case(name):
    """(sharded entry point, unsharded call, input, fields, atol)."""
    if name.startswith("segmented"):   # the statics gate (:160-161), tests/test_torch_segment_statics.py
        kw = dict(tol=1e-5, max_iter=10, iters=8, jac_iters=4)
        if name == "segmented dd":
            kw.update(tol=1e-9, max_iter=14, iters=10, jac_iters=6, dd_iters=10, dd_residual=True)
        return (lambda m: pm.sharded_segmented_statics(m, cfg=SEG, **kw),
                lambda x: segment_statics.solve_segmented_statics_batched(x, cfg=SEG, **kw),
                _uniform(5, (16, 3), -0.3, 0.3),
                ("qe", "qe_lo") if "dd" in name else ("qe",), 2e-5)
    kw = dict(tol=1e-5, max_iter=10, iters=10)
    if name == "actuated":       # tests/test_parallel.py:195-226, tests/test_torch_tendon.py
        cfg, u = _tendon_cfg(), _uniform(11, (16, 2), 0.0, 1.5)
        return (lambda m: pm.sharded_actuated_statics(m, cfg=cfg, **kw),
                lambda x: dynamics.solve_contact_statics(cfg, qe0=torch.zeros((16, 9)),
                                                         tension=x, **kw), u, ("qe",), 3e-5)
    if name == "magnetic":       # tests/test_parallel.py:229-258, tests/test_torch_magnetics.py
        cfg, u = _magnet_cfg(), _uniform(13, (16, 3), -0.3, 0.3)
        return (lambda m: pm.sharded_magnetic_statics(m, cfg=cfg, **kw),
                lambda x: dynamics.solve_contact_statics(cfg, qe0=torch.zeros((16, 9)),
                                                         b_field=x, **kw), u, ("qe",), 3e-5)
    # platform: tests/test_parallel.py:297-333, tests/test_torch_constrained.py
    robot, kw = _platform_robot(), dict(tol=1e-8, max_iter=25, iters=10)
    return (lambda m: pm.sharded_platform_statics(m, robot, **kw),
            lambda x: constrained.solve_platform(robot, platform_force=x[:, :3],
                                                 platform_moment=x[:, 3:], **kw),
            _uniform(7, (16, 6), -0.02, 0.02, F64), ("qe", "platform_position"), 1e-8)


@pytest.mark.parametrize("name", ["segmented", "segmented dd", "actuated", "magnetic",
                                  "platform"])
def test_newton_statics_match_unsharded(mesh, name):
    sharded, unsharded, u, fields, atol = _statics_case(name)
    ref = unsharded(u)                      # first: the shards find the constants cached
    sol = sharded(mesh)(pm.shard_rods(mesh, u))
    assert type(sol) is type(ref)
    assert bool(sol.converged.gather().all())
    _sharded_8_ways(sol.converged, sol.iterations, *(getattr(sol, f) for f in fields))
    for f in fields:
        torch.testing.assert_close(getattr(sol, f).gather(), getattr(ref, f), rtol=0, atol=atol)


def _dynamics_case(name):
    rng = np.random.default_rng(7 if name != "segmented rk4" else 11)
    if name == "segmented rk4":
        cfg = dynamics.SegmentedDynamicsConfig(statics=SEG, rho_a=1.0, rho_i=1e-2)
        tol = dict(rtol=1e-4, atol=2e-5)           # tests/test_parallel.py:288-292
    else:
        cfg, tol = DYN, dict(rtol=2e-5, atol=2e-6)  # tests/test_parallel.py:189-190
    # Newmark in f64, from a state its Newton solves in few iterates
    dtype, scale = (F64, 0.05) if name == "newmark" else (F32, 0.2)
    qe0, qd0 = (torch.tensor(rng.uniform(-scale, scale, (16, cfg.nq)), dtype=dtype)
                for _ in range(2))
    return cfg, qe0, qd0, tol


@pytest.mark.parametrize("name", ["rk4", "newmark", "segmented rk4"])
def test_integrators_match_unsharded(mesh, name):
    """RK4 (tests/test_torch_dynamics.py), Newmark (tests/test_torch_implicit.py:
    each shard's Newton stops on its own slab's norm, the unsharded one on the
    whole batch's) and segmented RK4 (tests/test_torch_segment_dynamics.py),
    dt 0.01 (tests/test_parallel.py:164-193, 261-294), one step of the JAX
    tests' three: each shard's call costs the whole batch's host work."""
    cfg, qe0, qd0, tol = _dynamics_case(name)
    implicit = name == "newmark"
    integrate = dynamics.simulate_implicit if implicit else dynamics.simulate
    kw = dict(dt=0.01, steps=1, iters=8, **(dict(tol=1e-7) if implicit else {}))
    ref = integrate(qe0, qd0, cfg, **kw)
    traj = pm.sharded_simulate(mesh, cfg=cfg, implicit=implicit, **kw)(pm.shard_rods(mesh, qe0),
                                                                        qd0)
    assert isinstance(traj.times, torch.Tensor) and torch.equal(traj.times, ref.times)
    assert traj.qes.shape == (1, 16, cfg.nq)
    _sharded_8_ways(traj.qes, traj.qds, traj.energies)
    torch.testing.assert_close(traj.qes.gather(), ref.qes, **tol)
    torch.testing.assert_close(traj.energies.gather(), ref.energies, rtol=2e-4, atol=0)


def test_riks_walk_with_monitor_and_dd_matches_unsharded(mesh):
    """The batched Riks walk (tests/test_torch_continuation.py) with the
    determinant monitor and the dd corrector: paths are per sample, so the
    sharded walk is the unsharded one (the statics gate, :160-161)."""
    d = np.random.default_rng(2).standard_normal((16, 3))
    refs = torch.tensor(0.5 * d / np.linalg.norm(d, axis=1, keepdims=True), dtype=F32)
    kw = dict(cfg=S8, ds=0.1, steps=1, tol=1e-8, max_corrector=20, iters=8,
              monitor_stability=True, dd_residual=True)
    ref = cosserat.arc_length_continuation_batched(refs, **kw)
    path = pm.sharded_riks_walk(mesh, **kw)(refs)
    for f in ref._fields:
        _sharded_8_ways(getattr(path, f))
        assert getattr(path, f).shape == getattr(ref, f).shape
        torch.testing.assert_close(getattr(path, f).gather(), getattr(ref, f), rtol=0, atol=2e-5)


def test_ctr_workspace_matches_unsharded(mesh):
    """A two-tube workspace (tests/test_torch_ctr.py), forward over reverse
    in every shard's thread at once, within 1e-10 of the unsharded solve."""
    k = float(np.sqrt(1.0 / 1.3))
    cfg = ctr.CTRConfig(tubes=(ctr.Tube(k, 1.0, 1.0 / 1.3), ctr.Tube(k, 1.0, 1.0 / 1.3)), n=16)
    phis = np.linspace(0.3, 2.4, 16)
    alphas = torch.tensor(np.stack([phis / 2, -phis / 2], axis=-1))
    sol = ctr.solve_ctr(alphas, cfg, tol=1e-10)
    theta, tips, iters, rnorm = pm.sharded_ctr_workspace(mesh, cfg, tol=1e-10)(alphas)
    _sharded_8_ways(theta, tips, iters, rnorm)
    torch.testing.assert_close(theta.gather(), sol.theta, rtol=0, atol=1e-10)
    torch.testing.assert_close(tips.gather(), ctr.ctr_shape(sol.theta, cfg).positions[..., 0, :],
                               rtol=0, atol=1e-10)
    assert float(rnorm.gather().max()) <= 1e-10


def test_ekf_fleet_matches_unsharded(mesh):
    """16 filters, one step, of tests/test_torch_estimation.py's sensor
    layout on a one-element rod (relative 1e-9 there), ``ys`` split on
    axis 1 and ``p0`` replicated."""
    rc = rod.RodConfig(n=6, na=3, ne=1)
    cfg = estimation.FilterConfig(
        dynamics=dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rc), rho_a=1.0,
                                         rho_i=1e-2),
        sensing=sensing.SensingConfig(rod=rc, marker_fracs=(), pose_fracs=(0.5, 1.0)),
        dt=0.01, q_accel=1e-10, r_sigma=1e-3, iters=6)
    rng = np.random.default_rng(0)
    x0 = np.zeros((16, 6))
    x0[:, 1], x0[:, 4] = 0.4, 0.3
    x0 = torch.tensor(x0 + 0.01 * rng.standard_normal((16, 6)))
    p0 = 1e-4 * torch.eye(6, dtype=F64)
    y = sensing.measure(x0[:, :3] + 1e-3, cfg.sensing)
    ys = (y + 1e-3 * torch.tensor(rng.standard_normal(y.shape)))[None]
    ref = estimation.ekf(ys, cfg, x0, p0)
    xs, covs, nis = pm.sharded_ekf(mesh, cfg)(ys, pm.shard_rods(mesh, x0),
                                              pm.replicate(mesh, p0))
    _sharded_8_ways(xs, covs, nis)
    for mine, theirs in ((xs, ref.xs), (covs, ref.covs), (nis, ref.nis)):
        assert mine.axis == 1
        rel = float((mine.gather() - theirs).abs().max() / theirs.abs().max())
        assert rel < 1e-9


def test_each_shard_stops_on_its_own_test(mesh):
    """The batched statics Newton (tests/test_parallel.py:137-161 at n=16,
    atol 2e-5; tests/test_torch_statics.py).  Under shard_map a Newton tests
    its local slab's residual: a slab of large loads needs more iterates,
    and the others report fewer."""
    loads = _uniform(1, (64, 3), -0.02, 0.02)
    loads[24:32] = _uniform(2, (8, 3), 0.35, 0.4)      # shard 3
    kw = dict(cfg=cosserat.StaticsConfig(rod=rod.RodConfig(n=16)), tol=1e-5, max_iter=12)
    ref = cosserat.solve_statics_batched(loads, **kw)
    sol = pm.sharded_solve_statics(mesh, **kw)(loads)
    assert bool(sol.converged.gather().all()) and sol.qe_lo is None
    _sharded_8_ways(sol.qe, sol.iterations, sol.residual_norm, sol.converged)
    per_shard = [int(s[0]) for s in sol.iterations.shards]
    assert all(bool((s == s[0]).all()) for s in sol.iterations.shards)
    assert per_shard[3] == int(ref.iterations) == max(per_shard)
    assert max(per_shard[:3] + per_shard[4:]) < per_shard[3]
    torch.testing.assert_close(sol.qe.gather(), ref.qe, rtol=0, atol=2e-5)


@pytest.mark.parametrize("what", ["uneven batch", "no tendons", "no magnets", "no cuda",
                                  "shard error"])
def test_refusals_raise(mesh, monkeypatch, what):
    """shard_map refuses an uneven split; parallel/mesh.py:166 and :206;
    make_mesh() without CUDA; a shard's exception reaches the caller."""
    if what == "uneven batch":
        with pytest.raises(ValueError, match="does not split evenly"):
            pm.sharded_rod_shape(mesh, cfg=rod.RodConfig(n=8))(torch.zeros((12, 9)))
    elif what == "no tendons":
        with pytest.raises(ValueError, match="needs cfg.tendons"):
            pm.sharded_actuated_statics(mesh, DYN)
    elif what == "no magnets":
        with pytest.raises(ValueError, match="needs cfg.magnets"):
            pm.sharded_magnetic_statics(mesh, DYN)
    elif what == "no cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.make_mesh()
    else:
        with pytest.raises(ValueError, match="jac_precision"):
            pm.sharded_solve_statics(mesh, cfg=S8, jac_precision="bf16")(torch.zeros((8, 3)))


def test_forward_mode_and_launch_counts_hold_across_threads():
    """More threads than cores at a short switch interval: per-sample
    forward-mode Jacobians (``locked_jvp``) equal the serial ones, and no
    launch count is lost."""
    def res(q):
        return torch.sin(q) * q.sum(-1, keepdim=True) + q.cumsum(-1)

    qs = [torch.linspace(-1, 1, 12, dtype=F64).reshape(4, 3) + i for i in range(16)]
    serial = [cosserat._per_sample_jacobian(res, q) for q in qs]

    def counter():
        pass
    counter.launches = 0
    out = [None] * len(qs)

    def work(i):
        for _ in range(20):
            out[i] = cosserat._per_sample_jacobian(res, qs[i])
            build.count_launch(counter)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == 20 * len(qs)
    for mine, ref in zip(out, serial):
        assert torch.equal(mine, ref)
    assert device_ops.locked_jacfwd(res)(qs[0][0]).shape == (3, 3)


@pytest.fixture(scope="module", autouse=True)
def import_check():
    """Import every module of the port, parallel/mesh.py included, in a fresh
    interpreter started with the module, so that it runs beside the other
    tests; prints the count of modules and any ``jax*`` module or module of
    the JAX package it found loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PORT} as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"assert '{PORT}.parallel.mesh' in sys.modules\n"
        "bad = sorted(k for k in sys.modules\n"
        f"             if k.split('.')[0].startswith('jax') or k.split('.')[0] == '{JAX_PKG}')\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    proc.kill()
    proc.communicate()


def test_no_module_of_the_port_imports_jax(import_check):
    out, err = import_check.communicate(timeout=300)
    assert import_check.returncode == 0, out + err
    assert out.split()[-1] == "[]" and int(out.split()[0]) > 40
