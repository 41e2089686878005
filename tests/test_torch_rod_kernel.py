"""Port parity: K1, K2 and K4 (ops/kernels/rod_kernel.py) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; K1 and K2 are
held to the JAX Pallas kernels run in interpret mode at
``precision='highest'`` (full f32 products), as ``tests/test_pallas_kernel.py``
runs them.  K4 is held to the JAX picard solve with the same boundary values
(its Pallas kernel carries bf16x3 error even in interpret mode).  The CUDA
kernels themselves are compared with these plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import rod as jrod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops.pallas import (
    rod_kernel as jrk,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import oracle
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    rod_kernel as rk,
)
from torch_threads import one_cpu_thread  # noqa: F401

B = 64
F32_TOL = 2e-6     # 'highest' gate, tests/test_pallas_kernel.py:26
GOLDEN_TOL = 5e-6  # tests/test_pallas_kernel.py:50-55


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    qes = rng.standard_normal((B, 9)).astype(np.float32)
    rhs = (0.1 * rng.standard_normal((B, 15, 4))).astype(np.float32)
    qes6 = (0.4 * rng.standard_normal((B, 18))).astype(np.float32)
    kw = dict(tile=B, interpret=True, precision="highest")
    q, r = jrk.rod_shape_fused(jnp.asarray(qes), **kw)
    x = jrk.picard_correction_fused(jnp.asarray(qes), jnp.asarray(rhs), **kw)
    q6, r6 = jrk.rod_shape_fused(jnp.asarray(qes6), cfg=jrod.RodConfig(na=6), **kw)
    return dict(qes=qes, rhs=rhs, qes6=qes6, q=np.asarray(q), r=np.asarray(r),
                x=np.asarray(x), q6=np.asarray(q6), r6=np.asarray(r6))


def test_k1_plain_matches_jax_fused(ref):
    q, r = rk.rod_shape_fused(torch.tensor(ref["qes"]))
    assert q.dtype == r.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), ref["q"], atol=F32_TOL)
    np.testing.assert_allclose(r.numpy(), ref["r"], atol=F32_TOL)


def test_k2_plain_matches_jax_correction(ref):
    x = rk.picard_correction_fused(torch.tensor(ref["qes"]), torch.tensor(ref["rhs"]))
    np.testing.assert_allclose(x.numpy(), ref["x"], atol=F32_TOL)


def test_k1_plain_na6_matches_jax_fused(ref):
    cfg = rod.RodConfig(na=6)
    q, r = rk.rod_shape_fused(torch.tensor(ref["qes6"]), cfg=cfg)
    np.testing.assert_allclose(q.numpy(), ref["q6"], atol=F32_TOL)
    np.testing.assert_allclose(r.numpy(), ref["r6"], atol=F32_TOL)


def test_k2_reads_only_curvature(ref):
    """na=6: the shear/extension modes must not enter the correction solve
    (rod_kernel._corr_kernel reads the 3 curvature components only)."""
    cfg = rod.RodConfig(na=6)
    qes6 = torch.tensor(ref["qes6"][:8])
    other = qes6.clone()
    other[:, 9:] = 7.0
    rhs = torch.tensor(ref["rhs"][:8])
    a = rk.picard_correction_fused(qes6, rhs, cfg=cfg)
    assert torch.equal(a, rk.picard_correction_fused(other, rhs, cfg=cfg))
    assert torch.equal(a, rk.picard_correction_fused(qes6[:, :9], rhs))


def test_k1_golden_demo_tip():
    q, r = rk.rod_shape_fused(rod.demo_qe(device="cpu")[None, :].repeat(4, 1))
    np.testing.assert_allclose(r[0, 0].numpy(), [0.562673, 0.0, -0.745914], atol=GOLDEN_TOL)
    np.testing.assert_allclose(q[0, 0].numpy(), [0.799770, 0.0, 0.600307, 0.0],
                               atol=GOLDEN_TOL)


def test_k1_ragged_batch(ref):
    """A batch of 37 rods: shapes follow B, and no rod depends on its
    neighbours (each equals the JAX row of the same strain)."""
    q, r = rk.rod_shape_fused(torch.tensor(ref["qes"][:37]))
    assert q.shape == (37, 15, 4) and r.shape == (37, 15, 3)
    np.testing.assert_allclose(r.numpy(), ref["r"][:37], atol=F32_TOL)
    q1, r1 = rk.rod_shape_fused(torch.tensor(ref["qes"][36:37]))
    np.testing.assert_allclose(q1[0].numpy(), q[36].numpy(), atol=1e-7)


def test_k1_rod_independence():
    """Regression of tests/test_pallas_kernel.py:58-70: big strains on even
    rods, zero strain (a straight rod) on odd rods."""
    rng = np.random.default_rng(2)
    qes = np.zeros((16, 9), np.float32)
    qes[::2] = rng.standard_normal((8, 9)) * 3.0
    _, r = rk.rod_shape_fused(torch.tensor(qes))
    x = rod.RodConfig().points[:-1]
    straight = np.stack([x, 0 * x, 0 * x], axis=-1)
    np.testing.assert_allclose(r[1::2].numpy(), np.broadcast_to(straight, (8, 15, 3)),
                               atol=2e-6)


@pytest.mark.parametrize("n", [8, 24, 33])
def test_k1_plain_other_grids_match_oracle(n):
    """Every narrow grid (n-1 <= 32), against the f64 oracle at the f32
    fused gate of tests/test_pallas_kernel.py:91."""
    qes = (0.8 * np.random.default_rng(7).standard_normal((3, 9))).astype(np.float32)
    q, r = rk.rod_shape_fused(torch.tensor(qes), cfg=rod.RodConfig(n=n))
    for i in range(3):
        q_ref, r_ref = oracle.integrate_position(qes[i].astype(np.float64), n=n)
        np.testing.assert_allclose(q[i].numpy().T.reshape(-1), q_ref, atol=5e-5)
        np.testing.assert_allclose(r[i].numpy(), r_ref, atol=5e-5)


def test_empty_batch_and_bad_inputs_raise():
    with pytest.raises(ValueError, match="non-empty"):
        rk.rod_shape_fused(torch.zeros((0, 9)))
    with pytest.raises(ValueError, match="non-empty"):
        rk.picard_correction_fused(torch.zeros((0, 9)), torch.zeros((0, 15, 4)))
    with pytest.raises(ValueError, match="512"):
        rk.rod_shape_fused(torch.zeros((4, 9)), cfg=rod.RodConfig(n=514))
    with pytest.raises(ValueError, match="precision"):
        rk.rod_shape_fused(torch.zeros((4, 9)), precision="bf16")
    with pytest.raises(ValueError, match="rhs"):
        rk.picard_correction_fused(torch.zeros((4, 9)), torch.zeros((4, 14, 4)))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        rk.rod_shape_fused(torch.zeros((4, 9), device="meta"))


def test_every_precision_is_fp32():
    """The TPU's bf16 pass counts have no Hopper counterpart: every
    precision value runs the same f32 arithmetic."""
    qes = torch.tensor(np.random.default_rng(3).standard_normal((4, 9)), dtype=torch.float32)
    outs = [rk.rod_shape_fused(qes, precision=p)[1] for p in rk.PRECISIONS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@jax.jit
def _jax_picard_bc(qe16, qe48, q0, r0):
    """The JAX picard solve with per-rod inits on a narrow and a wide grid."""
    return [(sol.quaternions, sol.positions) for sol in (
        jrod.rod_shape(qe, q0, r0, cfg=jrod.RodConfig(n=n), method="picard", iters=24)
        for qe, n in ((qe16, 16), (qe48, 48)))]


def test_k4_plain_matches_jax_picard_general_inits():
    """K4 and K4 wide (n=48) with random unit q0 and r0 ~ U(-1, 1) at the
    f32 fused gate (tests/test_pallas_kernel.py:91); the per-rod values do
    not leak between rods; at the demo values K4 is K1 exactly."""
    rng = np.random.default_rng(4)
    qe16, qe48 = (rng.standard_normal((5, 9)).astype(np.float32) for _ in range(2))
    q0 = rng.standard_normal((5, 4))
    q0 = (q0 / np.linalg.norm(q0, axis=-1, keepdims=True)).astype(np.float32)
    r0 = rng.uniform(-1.0, 1.0, (5, 3)).astype(np.float32)
    refs = _jax_picard_bc(*map(jnp.asarray, (qe16, qe48, q0, r0)))
    for qe, n, (jq, jr) in zip((qe16, qe48), (16, 48), refs):
        cfg = rod.RodConfig(n=n)
        q, r = rk.rod_shape_fused_bc(torch.tensor(qe), torch.tensor(q0), torch.tensor(r0), cfg,
                                     iters=24)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=5e-5)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=5e-5)
        q2, r2 = rk.rod_shape_fused_bc(torch.tensor(qe[2:3]), torch.tensor(q0[2:3]),
                                       torch.tensor(r0[2:3]), cfg, iters=24)
        torch.testing.assert_close(q2[0], q[2], atol=1e-7, rtol=0)
        torch.testing.assert_close(r2[0], r[2], atol=1e-7, rtol=0)
        demo = rk.rod_shape_fused_bc(torch.tensor(qe), torch.tensor([[1.0, 0, 0, 0]] * 5),
                                     torch.zeros((5, 3)), cfg)
        for a, b in zip(demo, rk.rod_shape_fused(torch.tensor(qe), cfg)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="q_init"):
        rk.rod_shape_fused_bc(torch.zeros((4, 9)), torch.zeros((3, 4)), torch.zeros((4, 3)))


@pytest.mark.parametrize("n", [8, 16, 24, 33])
def test_narrow_operator_planes(n):
    """The narrow kernels' G^T planes: rows permuted to the mma.sync k
    order (undone, the padded G^T exactly), split into TF32 hi + lo within
    2^-22 relative of it, and zero in every padded row and column."""
    c = rk.constants(rod.RodConfig(n=n), "cpu")
    npts, p = n - 1, c.p
    assert c.gtp.shape == (3, p, p) and c.gt is None
    order = rk.mma_k_order(p)
    assert sorted(order) == list(range(p))
    gt = torch.zeros((p, p))
    gt[:npts, :npts] = c.g[:npts, :npts].T
    torch.testing.assert_close(c.gtp[0][np.argsort(order)], gt, atol=0, rtol=0)
    assert not (c.gtp[1:].view(torch.int32) & 0x1FFF).any()   # TF32: 10 mantissa bits
    a, hi, lo = c.gtp.double()
    assert ((hi + lo - a).abs() <= 2.0**-22 * a.abs()).all()
    padded = torch.tensor(order >= npts)
    for plane in c.gtp:
        assert not plane[padded].any() and not plane[:, npts:].any()
