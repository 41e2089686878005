"""Port parity on wide grids (32 < n-1 <= 512): K1, K2 and K3 wide.

On the CPU the wrappers run their plain PyTorch versions; they are held to
the JAX package's XLA paths (jitted once per module, never a Pallas kernel
in interpret mode) and to the f64 NumPy oracle, at the tolerances of the
JAX package's own wide-layout tests.  The CUDA kernels are held to these
plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import rod as jrod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops import (
    collocation as jcoll,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import oracle
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    doubledouble as dd,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    refined_kernel as rfk,
    rod_kernel as rk,
)

B = 4
F32_TOL = 5e-5     # tests/test_pallas_kernel.py:137-140,177
K2_TOL = 5e-6      # tests/test_pallas_kernel.py:168
GATE = 1e-8        # tests/test_pallas_kernel.py:192, tests/test_refined_kernel.py:252
CFG64, CFG64_6, CFG256 = rod.RodConfig(n=64), rod.RodConfig(n=64, na=6), rod.RodConfig(n=256)


def _jax_picard(cfg, iters=24):
    jcfg = jrod.RodConfig(n=cfg.n, na=cfg.na)

    def f(q):
        sol = jrod.rod_shape(q, cfg=jcfg, method="picard", iters=iters)
        return sol.quaternions, sol.positions
    return jax.jit(f)


@jax.jit
def _jax_correction64(qes, rhs):
    jcfg = jrod.RodConfig(n=64)
    m = jrod._ode_blocks(jrod.curvature_at_points(jcfg, qes)[..., :3].astype(jnp.float32))
    return jcoll.solve_ivp_picard(jcfg.grid, m, rhs=rhs, iters=24)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(41)
    out = dict(
        q64=(0.5 * rng.standard_normal((B, 9))).astype(np.float32),
        q6=(0.4 * rng.standard_normal((2, 18))).astype(np.float32),
        rhs=(0.1 * rng.standard_normal((B, 63, 4))).astype(np.float32),
        q256=(0.5 * rng.standard_normal((2, 9))).astype(np.float32))
    for key, cfg in (("q64", CFG64), ("q6", CFG64_6), ("q256", CFG256)):
        q, r = _jax_picard(cfg)(jnp.asarray(out[key]))
        out[key + "_picard"] = np.asarray(q), np.asarray(r)
    out["x64"] = np.asarray(_jax_correction64(jnp.asarray(out["q64"]), jnp.asarray(out["rhs"])))
    return out


@pytest.mark.parametrize("key,cfg", [("q64", CFG64), ("q6", CFG64_6), ("q256", CFG256)])
def test_k1_wide_matches_jax_picard(ref, key, cfg):
    q, r = rk.rod_shape_fused(torch.tensor(ref[key]), cfg=cfg, iters=24)
    jq, jr = ref[key + "_picard"]
    np.testing.assert_allclose(q.numpy(), jq, atol=F32_TOL)
    np.testing.assert_allclose(r.numpy(), jr, atol=F32_TOL)
    via_rod = rod.rod_shape(torch.tensor(ref[key]), cfg=cfg, method="fused", iters=24)
    assert torch.equal(via_rod.positions, r)


def test_k2_wide_matches_jax_picard(ref):
    x = rk.picard_correction_fused(torch.tensor(ref["q64"]), torch.tensor(ref["rhs"]),
                                   cfg=CFG64, iters=24)
    np.testing.assert_allclose(x.numpy(), ref["x64"], atol=K2_TOL)


def _rel(x, y):
    return np.abs(np.asarray(x) - y).max() / np.abs(y).max()


@pytest.mark.parametrize("n,refine_steps", [(64, 1), (64, 2), (256, 1)])
def test_refined_wide_matches_oracle(n, refine_steps):
    """The single kernel (K3 wide) and the staged path (K2 wide) within the
    1e-8 gate of the f64 oracle; rod 0 is the demo strain as an f64 pair."""
    rng = np.random.default_rng(n)
    qe64 = 0.5 * rng.standard_normal((2, 9))
    qe64[0] = oracle.demo_qe()
    sol = rod.rod_shape_refined_fused(rod.split_strain(torch.tensor(qe64)),
                                      cfg=rod.RodConfig(n=n), refine_steps=refine_steps,
                                      iters=28, corr_iters=28)
    for i in range(2):
        q_ref, r_ref = oracle.integrate_position(qe64[i], n=n)
        assert _rel(sol.quaternions_f64()[i].numpy().T.reshape(-1), q_ref) < GATE
        assert _rel(sol.positions_f64()[i].numpy(), r_ref) < GATE


def test_refined_wide_6dof_matches_dense(ref):
    """na=6 on the single kernel, against the f64 dense solve (the dense
    path is held to the JAX dense solve in tests/test_torch_rod.py)."""
    qe6 = torch.tensor(ref["q6"], dtype=torch.float64)
    sol = rod.rod_shape_refined_fused(rod.split_strain(qe6), cfg=CFG64_6, refine_steps=1,
                                      iters=24, corr_iters=24)
    dense = rod.rod_shape(qe6, cfg=CFG64_6, method="dense")
    assert _rel(sol.quaternions_f64(), dense.quaternions.numpy()) < GATE
    assert _rel(sol.positions_f64(), dense.positions.numpy()) < GATE


@pytest.mark.parametrize("n", [34, 65, 66, 513])
def test_k1_edges_match_oracle(n):
    """The first wide grid (n-1 = 33), the top of the paired range and the
    first plain-wide grid of the TPU layouts (64, 65), and the cap (512)."""
    qes = (0.5 * np.random.default_rng(n).standard_normal((1, 9))).astype(np.float32)
    q, r = rk.rod_shape_fused(torch.tensor(qes), cfg=rod.RodConfig(n=n), iters=24)
    q_ref, r_ref = oracle.integrate_position(qes[0].astype(np.float64), n=n)
    np.testing.assert_allclose(q[0].numpy().T.reshape(-1), q_ref, atol=F32_TOL)
    np.testing.assert_allclose(r[0].numpy(), r_ref, atol=F32_TOL)


def test_wide_routing_and_limits():
    """Every wrapper takes 32 < n-1 <= 512 (the wide entry points only
    that), raises beyond 512 as the JAX package does, and CPU tensors
    launch no kernel."""
    wide = (rk.rod_shape_fused_wide, rk.picard_correction_fused_wide,
            rfk.rod_shape_refined_kernel_wide)
    for fn in wide:
        fn.launches = 0
    qes = torch.zeros((2, 9))
    for n in (34, 513):
        cfg = rod.RodConfig(n=n)
        assert rk.lanes_per_rod(n - 1) >= n - 1
        assert rk.rod_shape_fused_wide(qes, cfg, iters=2)[0].shape == (2, n - 1, 4)
        assert rk.picard_correction_fused_wide(qes, torch.zeros((2, n - 1, 4)), cfg,
                                               iters=2).shape == (2, n - 1, 4)
        assert rfk.rod_shape_refined_kernel_wide(qes, None, cfg, 2, 2)[3].shape == (2, n - 1, 3)
    assert [fn.launches for fn in wide] == [0, 0, 0]
    big = rod.RodConfig(n=514)
    for call in (lambda: rk.rod_shape_fused(qes, cfg=big),
                 lambda: rk.picard_correction_fused(qes, torch.zeros((2, 513, 4)), cfg=big),
                 lambda: rfk.rod_shape_refined_kernel(qes, cfg=big),
                 lambda: rod.rod_shape(qes, cfg=big, method="fused")):
        with pytest.raises(ValueError, match="512"):
            call()
    with pytest.raises(ValueError, match="32 < n-1 <= 512"):
        rk.rod_shape_fused_wide(qes, rod.RodConfig(n=33))


def _tf32(x):
    """f32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as the tensor cores' ``cvt.rna.tf32.f32``."""
    rounded = ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _tf32_matmul(passes):
    """``torch.matmul`` with its f32 products formed as the wide refined
    kernels form them on the tensor cores: ``a_lo b_hi + a_hi b_lo +
    a_hi b_hi`` with ``x_hi = tf32(x)``, ``x_lo = tf32(x - x_hi)``
    (``passes=3``), or ``a_hi b_hi`` alone (``passes=1``).  FP64 products
    stay FP64, as in the kernels."""
    matmul = torch.matmul

    def product(a, b):
        if a.dtype != torch.float32:
            return matmul(a, b)
        a_hi, b_hi = _tf32(a), _tf32(b)
        if passes == 1:
            return matmul(a_hi, b_hi)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        return matmul(a_lo, b_hi) + matmul(a_hi, b_lo) + matmul(a_hi, b_hi)
    return product


@pytest.mark.parametrize("n", [64, 256])
def test_refined_wide_3xtf32_products_meet_the_gate(n, monkeypatch):
    """The wide kernels form every f32 product with G as three TF32
    products: the plain refined arithmetic with its G products rounded so
    stays within the 1e-8 gate of the f64 oracle, and one TF32 pass does
    not, which is why the kernels take three."""
    x = torch.tensor([1 + 2**-11, -(1 + 3 * 2**-11), 1 + 2**-12], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + 2**-10, -(1 + 2**-9), 1.0]   # ties away from zero
    rng = np.random.default_rng(n)
    qe64 = 0.5 * rng.standard_normal((2, 9))
    qe64[0] = oracle.demo_qe()
    hi, lo = rod.split_strain(torch.tensor(qe64))
    errs = {}
    for passes in (3, 1):
        with monkeypatch.context() as m:
            m.setattr(torch, "matmul", _tf32_matmul(passes))
            out = rfk.rod_shape_refined_plain(hi, lo, rod.RodConfig(n=n), 28, 28)
        q, r = dd.join_f64(out[0], out[1]), dd.join_f64(out[2], out[3])
        errs[passes] = 0.0
        for i in range(2):
            q_ref, r_ref = oracle.integrate_position(qe64[i], n=n)
            errs[passes] = max(errs[passes], _rel(q[i].numpy().T.reshape(-1), q_ref),
                               _rel(r[i].numpy(), r_ref))
    assert errs[3] < GATE < errs[1]


@pytest.mark.parametrize("what,n", [("K1", 64), ("K1", 256), ("staged", 64)])
def test_wide_f32_3xtf32_products_meet_the_gates(what, n, monkeypatch):
    """K1/K4 wide and K2 wide form their f32 products with G (G T in the
    Picard loop, G rhs and G b) as three TF32 products.  The plain versions
    with those products so rounded stay within 2x of their FP32 error
    against the f64 oracle and inside the 5e-5 gate (K1), and inside the
    1e-8 gate on the staged refined path, whose K2 solves carry it (its
    residual and quadrature are FP64, which the rounding leaves alone).
    One TF32 pass is at least 20x worse on K1."""
    rng = np.random.default_rng(n)
    qe64 = 0.5 * rng.standard_normal((2, 9))
    qe64[0] = oracle.demo_qe()
    cfg = rod.RodConfig(n=n)
    refs = [oracle.integrate_position(qe, n=n) for qe in qe64]

    def error(passes):
        with monkeypatch.context() as m:
            if passes:
                m.setattr(torch, "matmul", _tf32_matmul(passes))
            if what == "K1":
                q, r = rk.rod_shape_fused_plain(torch.tensor(qe64, dtype=torch.float32), cfg, 24)
            else:
                sol = rod.rod_shape_refined_fused(rod.split_strain(torch.tensor(qe64)), cfg=cfg,
                                                  refine_steps=2, iters=24)
                q, r = sol.quaternions_f64(), sol.positions_f64()
        if what == "K1":
            return max(max(np.abs(q[i].numpy().T.reshape(-1) - q_ref).max(),
                           np.abs(r[i].numpy() - r_ref).max())
                       for i, (q_ref, r_ref) in enumerate(refs))
        return max(max(_rel(q[i].numpy().T.reshape(-1), q_ref), _rel(r[i].numpy(), r_ref))
                   for i, (q_ref, r_ref) in enumerate(refs))

    fp32, three = error(None), error(3)
    if what == "K1":
        assert three <= 2 * fp32 and three < F32_TOL
        assert error(1) >= 20 * fp32
    else:
        assert three < GATE
