"""On-card checks of the CUDA kernels against their plain versions: K1-K5
narrow and wide, and the statics Newtons (single rod and segmented) that run
on them.

Marked ``gpu``: they skip without a CUDA device.  This file imports no jax,
so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat,
    rod,
    segment_statics,
    segments,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
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
