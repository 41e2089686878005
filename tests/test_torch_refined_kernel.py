"""Port parity: K3 and K5 (ops/kernels/refined_kernel.py) against the JAX package.

One batch of 16 rods goes through the JAX Pallas kernel in interpret mode
(as ``tests/test_refined_kernel.py`` runs it) and through the port's plain
version: rods 0-5 exact f32 strains ``0.8 N(0,1)``, rod 6 the demo strain
as an f64 pair, rod 7 at the rho = 5 edge of the validity domain, rods 8-9
far outside it (rho = 8), the rest random again.  K5 (per-rod boundary
pairs) is held to the f64 oracle with the same inits, as
``tests/test_segments.py:118-150`` holds the JAX one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import rod as jrod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.ops.pallas import (
    refined_kernel as jrfk,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import oracle
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    doubledouble as dd,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    refined_kernel as rfk,
)
from torch_threads import one_cpu_thread  # noqa: F401

B = 16
EXACT, DEMO, RHO5, BAD = range(6), 6, 7, (8, 9)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(21)
    qe64 = 0.8 * rng.standard_normal((B, 9))
    qe64[:6] = qe64[:6].astype(np.float32)
    qe64[DEMO] = oracle.demo_qe()
    qe64[RHO5] = 0.0
    qe64[RHO5, 3] = 10.0          # constant |K| = 10: rho = 5
    for i in BAD:
        qe64[i] = 0.0
        qe64[i, 3] = 16.0         # rho = 8
    hi, lo = jrod.split_strain(qe64)
    outs = jrfk.rod_shape_refined_kernel(jnp.asarray(hi), jnp.asarray(lo), tile=B,
                                         interpret=True)
    jq = np.asarray(outs[0], np.float64) + np.asarray(outs[1], np.float64)
    jr = np.asarray(outs[2], np.float64) + np.asarray(outs[3], np.float64)
    mine = rfk.rod_shape_refined_kernel(torch.tensor(hi), torch.tensor(lo))
    return dict(qe64=qe64, jq=jq, jr=jr, q=dd.join_f64(*mine[:2]).numpy(),
                r=dd.join_f64(*mine[2:]).numpy(), outs=mine)


def _oracle(qe):
    q, r = oracle.integrate_position(qe)
    return q.reshape(4, 15).T, r


def test_exact_inputs_match_oracle_and_jax(ref):
    for i in EXACT:
        q_ref, r_ref = _oracle(ref["qe64"][i])
        # tests/test_refined_kernel.py:27-28
        assert np.abs(ref["q"][i] - q_ref).max() < 1e-9
        assert np.abs(ref["r"][i] - r_ref).max() < 1e-9
        assert np.abs(ref["q"][i] - ref["jq"][i]).max() < 1e-9
        assert np.abs(ref["r"][i] - ref["jr"][i]).max() < 1e-9


def test_dd_input_hits_gate(ref):
    _, r_ref = _oracle(ref["qe64"][DEMO])
    rel = np.abs(ref["r"][DEMO] - r_ref).max() / np.abs(r_ref).max()
    assert rel < 1e-10, rel      # tests/test_refined_kernel.py:38


def test_rho5_within_gate(ref):
    _, r_ref = _oracle(ref["qe64"][RHO5])
    rel = np.abs(ref["r"][RHO5] - r_ref).max() / np.abs(r_ref).max()
    assert rel < 1e-8, rel       # tests/test_refined_kernel.py:77


def test_sentinel_poisons_only_bad_rods(ref):
    """tests/test_refined_kernel.py:119-142: the same rods are NaN in the
    port and in the JAX kernel, in all four outputs, and only those."""
    bad = np.zeros(B, bool)
    bad[list(BAD)] = True
    for o in ref["outs"]:
        per_rod = np.isnan(o.numpy()).reshape(B, -1)
        assert (per_rod.all(1) == bad).all() and not per_rod[~bad].any()
    assert (np.isnan(ref["jq"]).reshape(B, -1).all(1) == bad).all()
    assert np.isfinite(ref["r"][~bad]).all()


def test_sentinel_off_and_guard():
    """check_rho=None keeps every rod; the entry point refuses a concrete
    rho > 5 loudly and lets check_validity=False through."""
    qe = np.zeros((4, 9), np.float32)
    qe[:, 3] = 12.0               # rho = 6
    qes = torch.tensor(qe)
    assert rod.strain_rho(qes, rod.RodConfig()) == pytest.approx(6.0)
    outs = rfk.rod_shape_refined_kernel(qes, check_rho=None, iters=40, corr_iters=40)
    assert all(torch.isfinite(o).all() for o in outs)
    with pytest.raises(ValueError, match="rho"):
        rod.rod_shape_refined_fused(qes, refine_steps=1)
    sol = rod.rod_shape_refined_fused(qes, refine_steps=1, check_validity=False,
                                      iters=40, corr_iters=40)
    assert torch.isfinite(sol.positions).all()


def test_precision_routing():
    """tests/test_refined_kernel.py:145-155: precision != 'high' must not
    route to the single kernel; forcing it raises."""
    qes = torch.zeros((4, 9))
    sol = rod.rod_shape_refined_fused(qes, refine_steps=1, precision="highest")
    assert sol.positions_dd is not None
    with pytest.raises(ValueError, match="high"):
        rod.rod_shape_refined_fused(qes, refine_steps=1, single_kernel=True,
                                    precision="highest")
    with pytest.raises(ValueError, match="exactly one refinement"):
        rod.rod_shape_refined_fused(qes, refine_steps=2, single_kernel=True)


def test_auto_iters_match_jax():
    qe = 0.4 * oracle.demo_qe()
    hi, lo = rod.split_strain(torch.tensor(np.tile(qe, (4, 1))))
    k = rod.auto_picard_iters((hi, lo), rod.RodConfig())
    assert k == jrod.auto_picard_iters((jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy())),
                                       jrod.RodConfig())
    assert 6 <= k < 20
    sol = rod.rod_shape_refined_fused((hi, lo), refine_steps=1, iters="auto")
    _, r_ref = _oracle(qe)
    rel = np.abs(sol.positions_f64()[0].numpy() - r_ref).max() / np.abs(r_ref).max()
    assert rel < 1e-8, rel


@pytest.mark.parametrize("n", [16, 48])
def test_k5_matches_oracle_general_inits(n):
    """K5 and K5 wide at random junction states given as f32 pairs: 1e-9
    absolute of the oracle with the same inits (tests/test_segments.py:145-150);
    at the demo values K5 is K3 exactly."""
    rng = np.random.default_rng(21)
    qes64 = (1.0 if n == 16 else 0.5) * rng.standard_normal((4, 9))
    q064 = rng.standard_normal((4, 4))
    q064 /= np.linalg.norm(q064, axis=-1, keepdims=True)
    r064 = rng.standard_normal((4, 3))
    cfg = rod.RodConfig(n=n)
    (qh, ql), (q0h, q0l), (r0h, r0l) = (dd.split_f64(torch.tensor(v))
                                        for v in (qes64, q064, r064))
    outs = rfk.rod_shape_refined_kernel_bc(qh, q0h, r0h, qes_lo=ql, q_init_lo=q0l,
                                           r_init_lo=r0l, cfg=cfg, tile=64)
    q, r = dd.join_f64(*outs[:2]).numpy(), dd.join_f64(*outs[2:]).numpy()
    for i in range(4):
        q_ref, r_ref = oracle.integrate_position(qes64[i], q_init=q064[i], r_init=r064[i], n=n)
        assert np.abs(q[i].T.reshape(-1) - q_ref).max() < 1e-9
        assert np.abs(r[i] - r_ref).max() < 1e-9
    demo = rfk.rod_shape_refined_kernel_bc(qh, torch.tensor([[1.0, 0, 0, 0]] * 4),
                                           torch.zeros((4, 3)), qes_lo=ql, cfg=cfg)
    for a, b in zip(demo, rfk.rod_shape_refined_kernel(qh, ql, cfg)):
        assert torch.equal(a, b)


def test_k5_rho_limit_is_per_segment():
    """|K| = 16 is rho = 8 on a unit rod (NaN) but rho = 4 on a segment of
    length 1/2 (kept): the limit is check_rho / L of the kernel's grid."""
    qe = torch.zeros((2, 9))
    qe[:, 3] = 16.0
    q0, r0 = torch.tensor([[1.0, 0, 0, 0]] * 2), torch.zeros((2, 3))
    long_rod = rfk.rod_shape_refined_kernel_bc(qe, q0, r0)
    half = rfk.rod_shape_refined_kernel_bc(qe, q0, r0, cfg=rod.RodConfig(length=0.5),
                                           iters=30, corr_iters=30)
    assert all(torch.isnan(o).all() for o in long_rod)
    assert all(torch.isfinite(o).all() for o in half)


@pytest.mark.parametrize("n", [8, 16, 24, 33, 64])
def test_fp64_operators_in_kernel_layout(n):
    """The FP64 operators as the refined kernels read them.  Narrow grids:
    G and Dn_NN zero-padded to P and permuted to dmma_order, where thread
    (g, t) of a warp finds a[8 nb + g, 8 kb + 2t + e] at
    ((nb * P/8 + kb) * 32 + 4g + t) * 2 + e; undone, the padded operators
    exactly.  Wide grids: G^T and Dn_NN^T."""
    c = rfk.constants(rod.RodConfig(n=n), "cpu")
    npts, p = n - 1, c.f32.p
    for kernel, plain in ((c.g64k, c.g64), (c.dn64k, c.dn64)):
        assert kernel.shape == (p, p) and kernel.dtype == torch.float64
        assert not plain[npts:].any() and not plain[:, npts:].any()
        if p > 32:
            torch.testing.assert_close(kernel, plain.T, atol=0, rtol=0)
            continue
        flat, nb = kernel.reshape(-1), p // 8
        for lane in (0, 5, 31):
            g, t = divmod(lane, 4)
            for n_tile, kb, e in ((0, 0, 0), (nb - 1, 0, 1), (0, nb - 1, 1), (nb - 1, nb - 1, 0)):
                at = ((n_tile * nb + kb) * 32 + lane) * 2 + e
                assert flat[at] == plain[8 * n_tile + g, 8 * kb + 2 * t + e]
        order = torch.tensor(rfk.dmma_order(np.arange(p * p).reshape(p, p))).reshape(-1)
        assert sorted(order.tolist()) == list(range(p * p))
        torch.testing.assert_close(flat[torch.argsort(order)].reshape(p, p), plain, atol=0, rtol=0)
