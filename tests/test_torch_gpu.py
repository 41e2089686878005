"""On-card checks of the CUDA kernels against their plain versions: K1-K5
narrow and wide, and the statics Newtons (single rod and segmented), the
FP64 statics residual on K3, and the dynamics layer's fused mass lane (K1 +
K2) that run on them; and, with no kernel, the layers that run plain torch
on the card: implicit Newmark (its host syncs), the rod-rod broad phase and
scenes, segmented dynamics, and the nested-forward-mode guard of the
implicit Picard solve under the card's torch; and the inverse layers:
the fused sensing measurement on K1, the Gauss-Newton strain fit's host
syncs, and a platform solve against the same solve on the CPU; the dense
collocation solves' and the concentric-tube Newton's host syncs.

Marked ``gpu``: they skip without a CUDA device.  This file imports no jax,
so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    constrained,
    cosserat,
    ctr,
    dynamics,
    magnetics,
    rod,
    segment_statics,
    segments,
    sensing,
    tendon,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    chebyshev,
    collocation as coll,
    doubledouble as dd,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    refined_kernel as rfk,
    rod_kernel as rk,
)

pytestmark = pytest.mark.gpu

B = 1000            # ragged against every launch shape
F32_TOL = 5e-5      # the 'high' gate of tests/test_pallas_kernel.py:26,43
K3_TOL = 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _qes(cuda, na, seed):
    qe64 = 0.8 * np.random.default_rng(seed).standard_normal((B, 3 * na))
    return dd.split_f64(torch.tensor(qe64, device=cuda))


@pytest.mark.parametrize("n,na", [(8, 3), (16, 3), (16, 6), (33, 6)])
def test_k1_k2_kernels_match_plain(cuda, n, na):
    cfg = rod.RodConfig(n=n, na=na)
    hi, _ = _qes(cuda, na, n)
    before = (rk.rod_shape_fused.launches, rk.picard_correction_fused.launches)
    q, r = rk.rod_shape_fused(hi, cfg)
    qp, rp = rk.rod_shape_fused_plain(hi, cfg)
    torch.testing.assert_close(q, qp, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(r, rp, atol=F32_TOL, rtol=0)
    rhs = torch.randn((B, n - 1, 4), device=cuda, generator=torch.Generator(cuda).manual_seed(n))
    x = rk.picard_correction_fused(hi, rhs, cfg)
    torch.testing.assert_close(x, rk.picard_correction_plain(hi, rhs, cfg),
                               atol=F32_TOL, rtol=0)
    assert (rk.rod_shape_fused.launches, rk.picard_correction_fused.launches) == (
        before[0] + 1, before[1] + 1)


NARROW = [(n, na, 1001, 20) for n in (8, 9, 16, 17, 32, 33) for na in (3, 6)]


@pytest.mark.parametrize("n,na,b,iters", NARROW + [(16, 3, 1, 20), (17, 6, 1, 0),
                                                   (33, 3, 1001, 0), (16, 6, 1001, 0)])
def test_narrow_f32_kernels_match_plain(cuda, n, na, b, iters):
    """K1, K4 and K2 narrow (the tensor-core kernels of csrc/rod_kernel.cu)
    at n-1 in {7, 8, 15, 16, 31, 32}: the edges of each padded width P = 8,
    16, 32; ragged batches of 1001 and 1 rods; iters = 0 (K1/K4: the base
    and one position product; K2: x = G rhs alone); K2 also with a
    residual-scale rhs (1e-7), to which its gate scales, as K2 is linear."""
    cfg = rod.RodConfig(n=n, na=na)
    qe64 = 0.8 * np.random.default_rng(400 + n).standard_normal((b, 3 * na))
    hi = torch.tensor(qe64, dtype=torch.float32, device=cuda)
    (q0, _), (r0, _) = _inits(cuda, b, 500 + n)
    rhs = torch.randn((b, n - 1, 4), device=cuda, generator=torch.Generator(cuda).manual_seed(n))
    kernels = (rk.rod_shape_fused, rk.rod_shape_fused_bc, rk.picard_correction_fused)
    before = [k.launches for k in kernels]
    q, r = rk.rod_shape_fused(hi, cfg, iters=iters)
    qp, rp = rk.rod_shape_fused_plain(hi, cfg, iters=iters)
    torch.testing.assert_close(q, qp, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(r, rp, atol=F32_TOL, rtol=0)
    q, r = rk.rod_shape_fused_bc(hi, q0, r0, cfg, iters=iters)
    qp, rp = rk.rod_shape_fused_bc_plain(hi, q0, r0, cfg, iters=iters)
    torch.testing.assert_close(q, qp, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(r, rp, atol=F32_TOL, rtol=0)
    for scale in (1.0, 1e-7):
        x = rk.picard_correction_fused(hi, scale * rhs, cfg, iters=iters)
        torch.testing.assert_close(x, rk.picard_correction_plain(hi, scale * rhs, cfg, iters=iters),
                                   atol=F32_TOL * scale, rtol=0)
    assert [k.launches for k in kernels] == [before[0] + 1, before[1] + 1, before[2] + 2]


@pytest.mark.parametrize("n,na", [(8, 3), (16, 3), (16, 6), (33, 6)])
def test_k3_kernel_matches_plain(cuda, n, na):
    cfg = rod.RodConfig(n=n, na=na)
    hi, lo = _qes(cuda, na, 100 + n)
    hi[3], lo[3] = 0.0, 0.0
    hi[3, 3] = 16.0             # K_1 = 16, rho = 8: NaN in kernel and plain alike
    before = rfk.rod_shape_refined_kernel.launches
    outs = rfk.rod_shape_refined_kernel(hi, lo, cfg)
    plain = rfk.rod_shape_refined_plain(hi, lo, cfg)
    assert rfk.rod_shape_refined_kernel.launches == before + 1
    for a, b in ((outs[:2], plain[:2]), (outs[2:], plain[2:])):
        ja, jb = dd.join_f64(*a), dd.join_f64(*b)
        assert torch.equal(torch.isnan(ja), torch.isnan(jb))
        assert torch.isnan(ja[3]).all() and not torch.isnan(ja[4:]).any()
        torch.testing.assert_close(ja, jb, atol=K3_TOL, rtol=0, equal_nan=True)


def _joined_close(outs, plain, tol, bad):
    """The f64 joins of a refined kernel's outputs against the plain
    version's: the same NaN pattern, NaN exactly in rod ``bad`` (if any),
    and within ``tol`` elsewhere."""
    for a, p in ((outs[:2], plain[:2]), (outs[2:], plain[2:])):
        ja, jp = dd.join_f64(*a), dd.join_f64(*p)
        nan = torch.isnan(ja).flatten(1).all(1)
        assert torch.equal(torch.isnan(ja), torch.isnan(jp))
        assert nan.tolist() == [i == bad for i in range(ja.shape[0])]
        torch.testing.assert_close(ja, jp, atol=tol, rtol=0, equal_nan=True)


REFINED_NARROW = ([(n, na, 1001, 20, 20) for n in (9, 16, 32, 33) for na in (3, 6)]
                  + [(16, 3, 1, 20, 20), (16, 6, 1001, 20, 0), (17, 3, 1001, 0, 0),
                     (33, 6, 1001, 0, 0)])


@pytest.mark.parametrize("n,na,b,iters,corr_iters", REFINED_NARROW)
def test_refined_narrow_kernels_match_plain(cuda, n, na, b, iters, corr_iters):
    """K3 and K5 narrow (csrc/refined_kernel.cu: 3xTF32 Picard loops in the
    mma.sync registers, FP64 products on DMMA) at n-1 in {8, 15, 31, 32},
    the edges of P = 8, 16, 32; a ragged batch of 1001 rods (strains
    0.5 N(0,1), all inside the rho limit) with rod 5 above it, NaN alone in
    its warp of healthy rods; one rod; with the low words of qe, q0 and r0
    and without them (None): the joined outputs within 1e-9 of the plain
    versions.  With either loop cut to zero steps the correction does not
    converge, so the result keeps f32 rounding to first order (iters = 0:
    an O(1) correction formed in f32; corr_iters = 0: one step G res, which
    leaves the base solve's rounding scaled by the loop's contraction) in
    the kernel and in the plain version alike: the f32 gate holds there."""
    cfg = rod.RodConfig(n=n, na=na)
    qe64 = 0.5 * np.random.default_rng(700 + n).standard_normal((b, 3 * na))
    bad = 5 if b > 5 else None
    if bad is not None:
        qe64[bad] = 0.0
        qe64[bad, 3] = 16.0                  # K_1 = 16: rho = 8
    hi, lo = dd.split_f64(torch.tensor(qe64, device=cuda))
    (q0h, q0l), (r0h, r0l) = _inits(cuda, b, 800 + n)
    tol = K3_TOL if iters and corr_iters else F32_TOL
    kernels = (rfk.rod_shape_refined_kernel, rfk.rod_shape_refined_kernel_bc)
    before = [k.launches for k in kernels]
    for lows in ((lo, q0l, r0l), (None, None, None)):
        _joined_close(rfk.rod_shape_refined_kernel(hi, lows[0], cfg, iters, corr_iters),
                      rfk.rod_shape_refined_plain(hi, lows[0], cfg, iters, corr_iters), tol, bad)
        _joined_close(rfk.rod_shape_refined_kernel_bc(hi, q0h, r0h, *lows, cfg=cfg, iters=iters,
                                                      corr_iters=corr_iters),
                      rfk.rod_shape_refined_bc_plain(hi, q0h, r0h, *lows, cfg=cfg, iters=iters,
                                                     corr_iters=corr_iters), tol, bad)
    assert [k.launches for k in kernels] == [c + 2 for c in before]


@pytest.mark.parametrize("n,na", [(34, 3), (65, 6), (66, 3), (130, 3), (256, 6), (513, 3)])
def test_wide_kernels_match_plain(cuda, n, na):
    """K1, K2 and K3 wide at the edges of the wide range: n-1 = 33, 64,
    65, 255 and the cap 512, and n-1 = 129 (P = 256, the refined kernel's
    last G slab ragged); a ragged batch."""
    b = B if n < 200 else 203
    cfg = rod.RodConfig(n=n, na=na)
    hi, lo = _qes(cuda, na, n)
    hi, lo = hi[:b].contiguous(), lo[:b].contiguous()
    hi[3], lo[3] = 0.0, 0.0
    hi[3, 3] = 16.0             # rho = 8: NaN in the refined kernel and plain alike
    ok = torch.ones(b, dtype=torch.bool, device=cuda)
    ok[3] = False               # and no fixed point for the f32 Picard solves
    wide = (rk.rod_shape_fused_wide, rk.picard_correction_fused_wide,
            rfk.rod_shape_refined_kernel_wide)
    before = [fn.launches for fn in wide]
    q, r = rk.rod_shape_fused(hi, cfg)
    qp, rp = rk.rod_shape_fused_plain(hi, cfg)
    torch.testing.assert_close(q[ok], qp[ok], atol=F32_TOL, rtol=0)
    torch.testing.assert_close(r[ok], rp[ok], atol=F32_TOL, rtol=0)
    rhs = torch.randn((b, n - 1, 4), device=cuda, generator=torch.Generator(cuda).manual_seed(n))
    x = rk.picard_correction_fused(hi, rhs, cfg)
    torch.testing.assert_close(x[ok], rk.picard_correction_plain(hi, rhs, cfg)[ok],
                               atol=F32_TOL, rtol=0)
    outs = rfk.rod_shape_refined_kernel(hi, lo, cfg)
    plain = rfk.rod_shape_refined_plain(hi, lo, cfg)
    assert [fn.launches for fn in wide] == [c + 1 for c in before]
    for a, p in ((outs[:2], plain[:2]), (outs[2:], plain[2:])):
        ja, jp = dd.join_f64(*a), dd.join_f64(*p)
        assert torch.isnan(ja[3]).all() and not torch.isnan(ja[ok]).any()
        torch.testing.assert_close(ja, jp, atol=K3_TOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("n,iters,scale", [(64, 0, 1.0), (256, 0, 1.0), (64, 20, 1e-7),
                                           (256, 20, 1e-7)])
def test_k2_wide_matches_plain(cuda, n, iters, scale):
    """K2 wide with iters=0 (x = G rhs alone, one GEMM) and with a
    residual-scale rhs, as the staged refined path gives it.  K2 is linear
    in rhs, so the f32 gate scales with it."""
    b = B if n < 200 else 203
    cfg = rod.RodConfig(n=n)
    hi, _ = _qes(cuda, 3, 300 + n)
    rhs = scale * torch.randn((b, n - 1, 4), device=cuda,
                              generator=torch.Generator(cuda).manual_seed(n))
    before = rk.picard_correction_fused_wide.launches
    x = rk.picard_correction_fused(hi[:b].contiguous(), rhs, cfg, iters=iters)
    assert rk.picard_correction_fused_wide.launches == before + 1
    torch.testing.assert_close(x, rk.picard_correction_plain(hi[:b], rhs, cfg, iters=iters),
                               atol=F32_TOL * scale, rtol=0)


@pytest.mark.parametrize("n", [16, 64])
def test_statics_batched_matches_per_sample(cuda, n):
    """The batched Newton on the kernels against the per-sample Newton on
    the torch path (tests/test_cosserat_statics.py:195-208)."""
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=n))
    loads = torch.tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (64, 3)),
                         dtype=torch.float32, device=cuda)
    counts = (rk.rod_shape_fused.launches + rk.rod_shape_fused_wide.launches,
              rk.picard_correction_fused.launches + rk.picard_correction_fused_wide.launches)
    new = cosserat.solve_statics_batched(loads, cfg=cfg, tol=1e-5, max_iter=12, iters=16)
    assert new.converged.all()
    assert counts[0] < rk.rod_shape_fused.launches + rk.rod_shape_fused_wide.launches
    assert counts[1] < (rk.picard_correction_fused.launches
                        + rk.picard_correction_fused_wide.launches)
    ref = cosserat.solve_statics(loads, cfg=cfg, tol=1e-5, max_iter=12, iters=16)
    torch.testing.assert_close(new.qe, ref.qe, atol=2e-5, rtol=0)


def _inits(cuda, b, seed):
    rng = np.random.default_rng(seed)
    q0 = rng.standard_normal((b, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    return (dd.split_f64(torch.tensor(q0, device=cuda)),
            dd.split_f64(torch.tensor(rng.uniform(-1.0, 1.0, (b, 3)), device=cuda)))


@pytest.mark.parametrize("n,na", [(8, 3), (16, 6), (33, 3), (34, 6), (65, 3), (130, 6),
                                  (256, 3), (513, 6)])
def test_bc_kernels_match_plain(cuda, n, na):
    """K4 and K5, narrow and wide, with random unit q0 and r0 ~ U(-1, 1)."""
    b = B if n < 200 else 203
    cfg = rod.RodConfig(n=n, na=na)
    hi, lo = _qes(cuda, na, 200 + n)
    hi, lo = hi[:b].contiguous(), lo[:b].contiguous()
    (qh, ql), (rh, rl) = _inits(cuda, b, n)
    wide = rk.is_wide(n - 1)
    k4 = rk.rod_shape_fused_bc_wide if wide else rk.rod_shape_fused_bc
    k5 = rfk.rod_shape_refined_kernel_bc_wide if wide else rfk.rod_shape_refined_kernel_bc
    before = (k4.launches, k5.launches)
    q, r = rk.rod_shape_fused_bc(hi, qh, rh, cfg)
    qp, rp = rk.rod_shape_fused_bc_plain(hi, qh, rh, cfg)
    torch.testing.assert_close(q, qp, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(r, rp, atol=F32_TOL, rtol=0)
    outs = rfk.rod_shape_refined_kernel_bc(hi, qh, rh, lo, ql, rl, cfg=cfg)
    plain = rfk.rod_shape_refined_bc_plain(hi, qh, rh, lo, ql, rl, cfg=cfg)
    assert (k4.launches, k5.launches) == (before[0] + 1, before[1] + 1)
    for a, p in ((outs[:2], plain[:2]), (outs[2:], plain[2:])):
        torch.testing.assert_close(dd.join_f64(*a), dd.join_f64(*p), atol=K3_TOL, rtol=0)


def test_segmented_statics_batched_matches_per_sample(cuda):
    """The segmented Newton on K4/K2 against the per-sample jacfwd Newton
    (tests/test_segment_statics.py:154-170), and its dd-residual form on K5
    with the configuration and loads of tests/test_segment_statics.py:213-236."""
    cfg = segment_statics.SegmentedStaticsConfig(rods=segments.uniform_segments(2, n=16),
                                                 stiffness=((1.0, 2.0, 2.0), (1.0, 1.0, 1.0)))
    loads = torch.tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (32, 3)),
                         dtype=torch.float32, device=cuda)
    before = (rk.rod_shape_fused_bc.launches, rk.picard_correction_fused.launches)
    new = segment_statics.solve_segmented_statics_batched(loads, cfg=cfg, tol=1e-5,
                                                          max_iter=10, iters=16, jac_iters=8)
    assert new.converged.all()
    assert before[0] < rk.rod_shape_fused_bc.launches
    assert before[1] < rk.picard_correction_fused.launches
    ref = segment_statics.solve_segmented_statics(loads[:8].double(), cfg=cfg, tol=1e-11)
    torch.testing.assert_close(new.qe[:8].double(), ref.qe, atol=2e-5, rtol=0)
    k5 = rfk.rod_shape_refined_kernel_bc.launches
    cfg = segment_statics.SegmentedStaticsConfig(rods=segments.uniform_segments(2, n=16),
                                                 stiffness=((1.0, 1.0, 1.3), (1.0, 0.7, 1.0)))
    loads = torch.tensor([[0.0, 0.0, 0.5], [0.2, 0.0, 0.3]], device=cuda)
    dd_sol = segment_statics.solve_segmented_statics_batched(
        loads, cfg=cfg, tol=1e-9, max_iter=14, iters=20, jac_iters=10, dd_residual=True,
        dd_iters=22)
    assert dd_sol.converged.all() and rfk.rod_shape_refined_kernel_bc.launches > k5
    ref = segment_statics.solve_segmented_statics(loads.double(), cfg=cfg, tol=1e-12,
                                                  max_iter=40)
    torch.testing.assert_close(dd_sol.qe.double() + dd_sol.qe_lo.double(), ref.qe, atol=1e-10,
                               rtol=0)


@pytest.mark.parametrize("n,follower", [(16, False), (16, True), (64, False)])
def test_dd_residual_on_k3_matches_plain(cuda, n, follower):
    """The FP64 statics residual around K3 (narrow, and paired at n=64) on
    the card against its evaluation on the CPU, where K3 runs its plain
    version, at B=8 (the gate of tests/test_cosserat_statics.py:261)."""
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=n), follower=follower,
                                 distributed_force=(0.0, 0.0, -0.6))
    rng = np.random.default_rng(n)
    qe = dd.split_f64(torch.tensor(0.2 * rng.standard_normal((8, 9)), device=cuda))
    loads = torch.tensor(rng.uniform(-0.3, 0.3, (8, 3)), dtype=torch.float32, device=cuda)
    k3 = rfk.rod_shape_refined_kernel if n <= 33 else rfk.rod_shape_refined_kernel_wide
    before = k3.launches
    res = cosserat.equilibrium_residual_dd(qe, loads, torch.zeros(3, device=cuda), cfg)
    assert k3.launches == before + 1
    ref = cosserat.equilibrium_residual_dd(tuple(w.cpu() for w in qe), loads.cpu(),
                                           torch.zeros(3), cfg)
    gate = 1e-7 * max(float(ref.abs().max()), 1.0)
    torch.testing.assert_close(res.cpu(), ref, atol=gate, rtol=0)


def test_dd_newton_rod_outside_k3_domain_is_not_converged(cuda):
    """K3's rho sentinel inside the dd Newton on the card: a rod started
    beyond rho = 5 gets a NaN residual and comes back converged=False; its
    neighbours converge as they would alone, and nothing syncs to raise."""
    cfg = cosserat.StaticsConfig(rod=rod.RodConfig(n=16))
    loads = torch.tensor(np.random.default_rng(7).uniform(-0.3, 0.3, (64, 3)),
                         dtype=torch.float32, device=cuda)
    newton = dict(cfg=cfg, tol=1e-9, max_iter=25, iters=16, dd_residual=True)
    clean = cosserat.solve_statics_batched(loads, **newton)
    qe0 = torch.zeros((64, 9), device=cuda)
    qe0[5, 3] = 14.0                                   # rho = |K| L/2 = 7 > 5
    k3 = rfk.rod_shape_refined_kernel.launches
    sol = cosserat.solve_statics_batched(loads, qe0=qe0, **newton)
    assert rfk.rod_shape_refined_kernel.launches > k3
    expect = torch.ones(64, dtype=torch.bool, device=cuda)
    expect[5] = False
    assert torch.equal(sol.converged, expect) and torch.isnan(sol.residual_norm[5])
    keep = expect.nonzero()[:, 0]
    torch.testing.assert_close(sol.qe[keep], clean.qe[keep], rtol=0, atol=0)
    torch.testing.assert_close(sol.qe_lo[keep], clean.qe_lo[keep], rtol=0, atol=0)


def _dyn_cfg(n):
    return dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=n)),
                                   rho_a=1.0, rho_i=1e-2)


@pytest.mark.parametrize("n,b", [(16, 1001), (64, 33)])
def test_mass_matrix_fused_matches_mass_matrix(cuda, n, b):
    """The fused mass lane on K1 + K2 (wide at n=64) against ``mass_matrix``
    on the card (tests/test_mass_fused.py:33-36), one launch of each."""
    cfg = _dyn_cfg(n)
    qe = torch.tensor(0.5 * np.random.default_rng(n).standard_normal((b, 9)), device=cuda)
    k1, k2 = ((rk.rod_shape_fused, rk.picard_correction_fused) if n <= 33
              else (rk.rod_shape_fused_wide, rk.picard_correction_fused_wide))
    before = (k1.launches, k2.launches)
    m_f = dynamics.mass_matrix_fused(qe, cfg, iters=20)
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)
    ref = dynamics.mass_matrix(qe, cfg, iters=20)
    assert float((torch.linalg.matrix_norm(m_f - ref) / torch.linalg.matrix_norm(ref)).max()) < 2e-3
    assert float((m_f - m_f.transpose(-1, -2)).abs().max()) < 1e-6
    assert float(torch.linalg.eigvalsh(m_f).min()) > 0.0


def test_rk4_fused_tier_matches_default(cuda):
    """tests/test_mass_fused.py:55-68 on the card: 12 steps, one K1 and one K2
    launch per RK4 stage."""
    qe0 = torch.zeros((8, 9), dtype=torch.float64, device=cuda)
    qe0[:, 4] = 0.25
    qe0[1, 2] = 0.1
    kw = dict(dt=0.004, steps=12, iters=14, record_energy=False)
    ref = dynamics.simulate(qe0, torch.zeros_like(qe0), _dyn_cfg(16), **kw)
    before = rk.rod_shape_fused.launches
    fus = dynamics.simulate(qe0, torch.zeros_like(qe0), _dyn_cfg(16), mass_tier="fused", **kw)
    assert rk.rod_shape_fused.launches == before + 48
    torch.testing.assert_close(fus.qes, ref.qes, atol=5e-4, rtol=0)
    torch.testing.assert_close(fus.qds, ref.qds, atol=5e-3, rtol=0)


def _host_syncs(fn):
    """``(fn(), the host syncs torch's sync debug mode saw in it)``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)


@pytest.mark.parametrize("tier", ["xla", "fused"])
def test_simulate_constant_loads_make_no_host_sync_per_step(cuda, tier):
    """Constant loads given as host data (tuples, lists, numpy) are copied to
    the card once per call, so the RK4 loop, the energy record included,
    makes no host sync: three steps sync as often as one."""
    cfg = dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16)), rho_a=1.0, rho_i=1e-2,
        gravity=(0.0, 0.0, -9.81), tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.05)),),
        magnets=(magnetics.Magnet(moment=(1.0, 0.0, 0.0)),))
    qe0 = torch.tensor(0.2 * np.random.default_rng(9).standard_normal((8, 9)), device=cuda)
    loads = dict(tip_force=(0.0, 0.0, -0.1), tip_moment=[0.01, 0.0, 0.0],
                 base_accel=np.array([0.0, 0.1, 0.0]), tension=(0.5,),
                 b_field=((0.0, 0.0, 0.01), 1e-3 * np.eye(3)))

    def run(steps):
        return dynamics.simulate(qe0, torch.zeros_like(qe0), cfg, dt=0.002, steps=steps,
                                 iters=12, mass_tier=tier, **loads)

    run(1)                                      # fills the caches
    _, once = _host_syncs(lambda: run(1))
    traj, thrice = _host_syncs(lambda: run(3))
    assert thrice == once                       # the loads are copied once per call
    assert traj.qes.shape == (3, 8, 9)
    assert bool(torch.isfinite(traj.qes).all() & torch.isfinite(traj.energies).all())


def test_actuated_statics_closed_form(cuda):
    """tests/test_tendon.py:32-46 on the card: one tendon at offset delta,
    kappa_y = -T delta / EI_y at rtol 1e-8 for 64 tensions."""
    cfg = dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16), stiffness=(1.0, 2.0, 1.0)),
        tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.05)),))
    t = torch.tensor(np.random.default_rng(6).uniform(0.1, 2.0, (64, 1)), device=cuda)
    sol = dynamics.solve_contact_statics(cfg, qe0=torch.zeros((64, 9), dtype=torch.float64,
                                                              device=cuda), tension=t, tol=1e-11)
    assert sol.converged.all()
    kappa = rod.curvature_at_points(cfg.rod, sol.qe)
    torch.testing.assert_close(kappa[..., 1], (-t * 0.05 / 2.0).expand(64, 15), rtol=1e-8, atol=0)
    assert float(kappa[..., [0, 2]].abs().max()) < 1e-9


def test_implicit_picard_nested_forward_mode_raises(cuda):
    """tests/test_torch_ivp.py::test_implicit_picard_nested_forward_mode_raises
    on CUDA tensors: a jvp of a jvp and jacfwd of jacfwd through the solve
    raise (the guard reads torch's private functorch state), and the three
    second derivatives with a reverse-mode level agree with a central
    difference of the first (rtol 1e-6)."""
    n, d, iters = 10, 4, 16
    rng = np.random.default_rng(0)
    m = torch.tensor(0.5 * rng.standard_normal((n - 1, d, d)), device=cuda)
    rhs = torch.tensor(rng.standard_normal((n - 1, d)), device=cuda)
    dm = torch.tensor(rng.standard_normal((n - 1, d, d)), device=cuda)
    g = torch.tensor(rng.standard_normal((n - 1, d)), device=cuda)
    grid = coll.make_grid(n, device=cuda)

    def f(s):
        return torch.sum(g * coll.solve_ivp_picard_implicit(grid, m + s * dm, rhs, iters))

    s0 = torch.tensor(0.0, dtype=torch.float64, device=cuda)
    one = torch.tensor(1.0, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="nested forward-mode"):
        torch.func.jvp(lambda s: torch.func.jvp(f, (s,), (one,))[1], (s0,), (one,))
    with pytest.raises(RuntimeError, match="nested forward-mode"):
        torch.func.jacfwd(torch.func.jacfwd(f))(s0)
    h = 1e-4
    fd = (torch.func.jvp(f, (s0 + h,), (one,))[1]
          - torch.func.jvp(f, (s0 - h,), (one,))[1]) / (2 * h)
    assert abs(float(fd)) > 1e-3
    for d2 in (torch.func.jacfwd(torch.func.jacrev(f))(s0),
               torch.func.jacrev(torch.func.jacfwd(f))(s0),
               torch.func.jacrev(torch.func.jacrev(f))(s0)):
        np.testing.assert_allclose(float(d2), float(fd), rtol=1e-6)


def test_newmark_syncs_once_per_newton_iterate(cuda, monkeypatch):
    """``simulate_implicit`` on the card, B=8, constant loads given as host
    data: one host sync per Newton convergence test (each iterate's and each
    step's first) and no other per step; within 5e-4 of RK4 at dt/4
    (tests/test_dynamics.py:105-122)."""
    cfg = dynamics.DynamicsConfig(
        statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=16)), rho_a=1.0, rho_i=1e-2,
        gravity=(0.0, 0.0, -1.0), tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.05)),))
    qe0 = torch.tensor(0.2 * np.random.default_rng(11).standard_normal((8, 9)), device=cuda)
    loads = dict(tip_force=(0.0, 0.0, -0.1), tension=(0.5,))
    counts = [0]
    newton_step = cosserat._newton_step

    def counted(jac, res):
        counts[0] += 1
        return newton_step(jac, res)

    monkeypatch.setattr(cosserat, "_newton_step", counted)

    def run(steps):
        counts[0] = 0
        traj, syncs = _host_syncs(lambda: dynamics.simulate_implicit(
            qe0, torch.zeros_like(qe0), cfg, dt=2e-3, steps=steps, tol=1e-9, **loads))
        return traj, syncs, counts[0]

    run(1)                                      # fills the caches
    _, syncs1, newton1 = run(1)
    traj, syncs3, newton3 = run(3)
    assert syncs3 - syncs1 == (newton3 - newton1) + 2, (syncs1, newton1, syncs3, newton3)
    ref = dynamics.simulate(qe0, torch.zeros_like(qe0), cfg, dt=5e-4, steps=12,
                            record_energy=False, **loads)
    torch.testing.assert_close(traj.qes[-1], ref.qes[-1], rtol=0, atol=5e-4)
    assert bool(torch.isfinite(traj.energies).all())


def test_broadphase_matches_all_pairs_and_scene_syncs_not(cuda):
    """tests/test_broadphase.py:41-79 on the card at R=16, n=16: budget R-2
    equals all pairs (rtol 1e-12), an adequate budget equals them in the
    potential, its force and friction; a broad-phase ``simulate_scene``
    makes no host sync per step."""
    nr, n = 16, 16
    cfg = dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(rod=rod.RodConfig(n=n, ne=2)),
                                  rho_i=1e-2)
    qe = torch.tensor(0.4 * np.random.default_rng(0).standard_normal((nr, 6)), device=cuda)
    base = torch.zeros((nr, 3), dtype=torch.float64, device=cuda)
    base[:, 1] = 0.15 * torch.arange(nr, dtype=torch.float64, device=cuda)
    r_all = dynamics._scene_positions(qe, cfg, base, 16)
    w_q = torch.tensor(chebyshev.clenshaw_curtis_weights(n, 1.0), device=cuda)
    kw = dict(radius=0.09, stiffness=50.0, smoothing=5e-3, friction=0.4)
    dense = dynamics.RodRodContact(**kw)
    v_d = float(dense.pair_potential(r_all, w_q))
    assert v_d > 0.0
    np.testing.assert_allclose(float(dynamics.RodRodContact(**kw, budget=nr - 2).pair_potential(
        r_all, w_q)), v_d, rtol=1e-12)
    bp = dynamics.RodRodContact(**kw, budget=4)
    assert not bool(bp.broadphase_overflow(r_all, margin=0.0))
    np.testing.assert_allclose(float(bp.pair_potential(r_all, w_q)), v_d, rtol=1e-10)
    g_d, g_b = (torch.func.grad(lambda r: c.pair_potential(r, w_q))(r_all) for c in (dense, bp))
    torch.testing.assert_close(g_b, g_d, rtol=1e-8, atol=1e-12)
    v_all = torch.tensor(0.3 * np.random.default_rng(1).standard_normal(tuple(r_all.shape)),
                         device=cuda)
    torch.testing.assert_close(bp.friction_force(r_all, v_all, w_q),
                               dense.friction_force(r_all, v_all, w_q), rtol=1e-8, atol=1e-12)

    def run(steps):
        return dynamics.simulate_scene(qe, torch.zeros_like(qe), cfg, bp, base.cpu().numpy(),
                                       dt=0.004, steps=steps)

    run(1)
    _, once = _host_syncs(lambda: run(1))
    traj, thrice = _host_syncs(lambda: run(3))
    assert thrice == once
    e = traj.energies
    assert bool(torch.isfinite(traj.qes).all()) and float((e[-1] - e[0]).abs()) < 5e-4 * max(
        float(e[0].abs()), 1.0)


def test_segmented_mass_and_rhs_matches_cpu(cuda):
    """The chained Euler-Lagrange assembly (a terminated tendon, gravity, a
    tip wrench) on the card against the same call on the CPU, within
    1e-10 max(1, |ref|)."""
    cfg = dynamics.SegmentedDynamicsConfig(
        statics=segment_statics.SegmentedStaticsConfig(
            rods=segments.uniform_segments(3, n=12, ne=3),
            tendons=(tendon.Tendon(offset=(0.0, 0.0, 0.05)),
                     tendon.Tendon(offset=(0.0, 0.03, 0.0), capstan=0.5)), tendon_end=(0, 2)),
        rho_a=1.0, rho_i=1e-2, gravity=(0.0, 0.0, -1.0))
    rng = np.random.default_rng(2)
    args = [0.3 * rng.standard_normal((8, 27)), rng.standard_normal((8, 27)),
            0.3 * rng.standard_normal((8, 3)), 0.1 * rng.standard_normal((8, 3)),
            rng.uniform(0.0, 2.0, (8, 2))]

    def call(device):
        qe, qd, tf, tm, ten = (torch.tensor(a, device=device) for a in args)
        return dynamics._mass_and_rhs(qe, qd, cfg, tf, 16, tm, tension=ten)

    for mine, ref in zip(call(cuda), call("cpu")):
        torch.testing.assert_close(mine.cpu(), ref, rtol=0,
                                   atol=1e-10 * max(1.0, float(ref.abs().max())))


def test_fused_measure_launches_one_k1_and_matches_picard(cuda):
    """measure(method='fused') on the card: exactly one K1 launch and no
    other kernel, within 5e-5 of the f64 picard measurement (markers and
    the tip frame)."""
    qes = torch.tensor(0.8 * np.random.default_rng(5).standard_normal((B, 9)), device=cuda)
    fused = sensing.SensingConfig(use_tip_quaternion=True, method="fused")
    wrappers = (rk.rod_shape_fused, rk.picard_correction_fused, rk.rod_shape_fused_bc,
                rfk.rod_shape_refined_kernel, rfk.rod_shape_refined_kernel_bc)
    for w in wrappers:
        w.launches = 0
    y = sensing.measure(qes, fused)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [1, 0, 0, 0, 0]
    ref = sensing.measure(qes, dataclasses.replace(fused, method="picard"))
    assert y.dtype == torch.float64 and y.shape == (B, 16)
    assert float((y - ref).abs().max()) < F32_TOL


def test_fit_strain_syncs_once_per_iterate(cuda):
    """fit_strain's Gauss-Newton loop on the card: one host sync per
    iterate (its stop test on the batch's largest residual), none other
    per iterate: three iterates sync twice more than one."""
    cfg = sensing.SensingConfig(marker_fracs=(0.3, 0.6), pose_fracs=(0.5, 1.0))
    qes = torch.tensor(0.6 * np.random.default_rng(3).standard_normal((64, 9)), device=cuda)
    ys = sensing.measure(qes, cfg)

    def fit(k):
        return sensing.fit_strain(ys, cfg, tol=0.0, max_iter=k)

    fit(1)
    sol1, once = _host_syncs(lambda: fit(1))
    sol3, thrice = _host_syncs(lambda: fit(3))
    assert int(sol1.iterations) == 1 and int(sol3.iterations) == 3
    assert thrice - once == 2, (once, thrice)


def test_platform_solve_on_card_matches_cpu(cuda):
    """solve_platform of the three-leg vertical PCR (tests/test_constrained.py:
    106-116) over two platform wrenches on the card within 1e-9 of the same
    solve on the CPU, every sample converged."""
    s = float(np.sqrt(2) / 2)
    bases = tuple((0.3 * np.cos(a), 0.3 * np.sin(a), 0.0)
                  for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3))
    robot = constrained.PlatformRobot(
        cfg=dynamics.DynamicsConfig(statics=cosserat.StaticsConfig(
            rod=rod.RodConfig(n=12, ne=3, na=6), stiffness=(1.0, 1.0, 1.0, 100.0, 50.0, 50.0))),
        base_positions=bases, base_quaternions=((s, 0.0, -s, 0.0),) * 3, attach_points=bases)
    f = torch.tensor([[0.0, 0.0, -0.6], [0.05, -0.02, -0.3]], dtype=torch.float64)
    sols = [constrained.solve_platform(robot, platform_force=f.to(dev), tol=1e-11)
            for dev in (cuda, torch.device("cpu"))]
    for sol in sols:
        assert bool(sol.converged.all())
    for name in ("qe", "platform_position", "platform_quaternion", "reaction_force"):
        a, b = (getattr(sol, name) for sol in sols)
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) < 1e-9, name


def test_dense_solves_make_no_host_sync(cuda):
    """solve_ivp_dense and rod_shape(method='dense') solve through
    torch.linalg.solve_ex, which leaves the singularity check to the caller:
    no host sync, against an f64 Picard solve of the same rods."""
    qes = torch.tensor(0.8 * np.random.default_rng(5).standard_normal((64, 9)), device=cuda)
    cfg = rod.RodConfig()
    m = rod._ode_blocks(rod.curvature_at_points(cfg, qes)[..., :3])
    q0 = torch.zeros(64, 4, dtype=torch.float64, device=cuda)
    q0[:, 0] = 1.0
    grid = cfg.grid(cuda)
    rod.rod_shape(qes, cfg=cfg, method="dense")
    q, syncs_ivp = _host_syncs(lambda: coll.solve_ivp_dense(grid, m, q0))
    sol, syncs_rod = _host_syncs(lambda: rod.rod_shape(qes, cfg=cfg, method="dense"))
    assert (syncs_ivp, syncs_rod) == (0, 0)
    ref = rod.rod_shape(qes, cfg=cfg, method="picard", iters=40)
    assert float((q - ref.quaternions).abs().max()) < 1e-12
    assert float((sol.positions - ref.positions).abs().max()) < 1e-12


def test_ctr_newton_syncs_once_per_iterate(cuda):
    """solve_ctr on the card: one host sync per Newton iterate (the stop
    test of damped_newton), none other per iterate, and no kernel launch:
    three iterates sync twice more than one."""
    g = 1.0 / 1.3
    kap = float(np.sqrt(1.44 * g))
    cfg = ctr.CTRConfig(tubes=(ctr.Tube(kap, 2.0, 2.0 * g), ctr.Tube(kap, 1.0, g),
                               ctr.Tube(kap, 0.5, 0.5 * g)), n=16)
    alphas = torch.tensor(np.random.default_rng(6).uniform(-np.pi, np.pi, (256, 3)),
                          device=cuda)

    def solve(k):
        return ctr.solve_ctr(alphas, cfg, tol=0.0, max_iter=k)

    solve(1)
    wrappers = (rk.rod_shape_fused, rk.picard_correction_fused, rk.rod_shape_fused_bc,
                rfk.rod_shape_refined_kernel, rfk.rod_shape_refined_kernel_bc)
    before = [w.launches for w in wrappers]
    sol1, once = _host_syncs(lambda: solve(1))
    sol3, thrice = _host_syncs(lambda: solve(3))
    assert [w.launches for w in wrappers] == before
    assert int(sol1.iterations) == 1 and int(sol3.iterations) == 3
    assert thrice - once == 2, (once, thrice)
    assert float(sol3.residual.norm(dim=-1).max()) < float(sol1.residual.norm(dim=-1).max())
