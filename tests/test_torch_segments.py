"""Port parity: the multi-segment chains (models/segments.py).

The same numpy ``default_rng`` strains and junction states go through the
JAX package's picard chain (one ``jax.jit`` program, 30 Picard steps: at
these strains a segment's rho stays below ~0.6, so the chain is converged to
f64 rounding) and through the port's chains: 'dense' and 'picard' at f64,
'fused' (K4's plain version on the CPU) at the f32 fused gate; the refined
chains against the f64 oracle chained solve, 'refined_fused' (K5's plain
version) at the 1e-8 gate (``tests/test_segments.py:99-220``).  Narrow
segments n=16 and one wide chain, 2 x n=48.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import (
    segments as jseg,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import oracle
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    rod,
    segments,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    doubledouble as dd,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    convert,
)
from torch_threads import one_cpu_thread  # noqa: F401

B = 4
F32_TOL = 2e-4     # fused chain vs picard chain, tests/test_segments.py:196-199
GATE = 1e-8        # refined chains vs the oracle chain, tests/test_segments.py:167-172
JCFG = jseg.uniform_segments(3, n=16)
JCFG48 = jseg.uniform_segments(2, n=48)


@jax.jit
def _jax_chains(qe, q0, r0, qe48):
    """The JAX picard chains of this file, compiled as one program."""
    out = {}
    for key, cfg, args in (("picard", JCFG, (qe, q0, r0)), ("picard48", JCFG48, (qe48,))):
        sol = jseg.segmented_rod_shape(*args[:1], cfg, *args[1:], method="picard", iters=30)
        out[key] = (sol.junction_quaternions, sol.junction_positions, sol.positions[-1])
    return out


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(3)
    qe = 0.8 * rng.standard_normal((B, 3, 9))
    q0 = rng.standard_normal((B, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    r0 = rng.uniform(-1.0, 1.0, (B, 3))
    qe48 = 0.5 * rng.standard_normal((B, 2, 9))
    out = _jax_chains(jnp.asarray(qe), jnp.asarray(q0), jnp.asarray(r0), jnp.asarray(qe48))
    return dict(qe=qe, q0=q0, r0=r0, qe48=qe48,
                **{k: tuple(np.asarray(a) for a in v) for k, v in out.items()})


def _oracle_chain(seg_qe64, cfg, q=(1.0, 0.0, 0.0, 0.0), r=(0.0, 0.0, 0.0)):
    """f64 chained oracle solve: each segment from the previous one's tip
    (tests/test_segments.py:99-115)."""
    q, r = np.asarray(q, np.float64), np.asarray(r, np.float64)
    tips_q, tips_r = [], []
    for s, seg in enumerate(cfg.segments):
        q_stack, r_stack = oracle.integrate_position(seg_qe64[s], q_init=q, r_init=r,
                                                     n=seg.n, length=seg.length)
        npts = seg.n - 1
        q = q_stack[::npts][:4]
        r = r_stack[0]
        tips_q.append(q)
        tips_r.append(r)
    return np.stack(tips_q), np.stack(tips_r)


def test_project_global_strain_matches_jax():
    rng = np.random.default_rng(0)
    qe = rng.standard_normal((2, 12))
    jcfg = jseg.uniform_segments(4, n=12, ne=4)
    mine = segments.project_global_strain(qe, convert.segmented_rod_config_from_jax(jcfg))
    assert mine.shape == (2, 4, 12)
    np.testing.assert_allclose(mine, jseg.project_global_strain(qe, jcfg), rtol=0, atol=1e-14)
    # the demo field on 4 segments gives the single rod's tip (tests/test_segments.py:38-50)
    cfg4 = segments.uniform_segments(4, n=16)
    seg_qe = segments.project_global_strain(oracle.demo_qe(), cfg4)
    sol = segments.segmented_rod_shape(torch.tensor(seg_qe), cfg4, method="dense")
    single = rod.rod_shape(torch.tensor(oracle.demo_qe()), method="dense")
    torch.testing.assert_close(sol.tip_position, single.tip_position, atol=1e-9, rtol=0)


@pytest.mark.parametrize("method", ["dense", "picard"])
def test_chains_match_jax(ref, method):
    cfg = convert.segmented_rod_config_from_jax(JCFG)
    assert cfg == segments.uniform_segments(3, n=16)
    sol = segments.segmented_rod_shape(torch.tensor(ref["qe"]), cfg, q_init=torch.tensor(ref["q0"]),
                                       r_init=torch.tensor(ref["r0"]), method=method, iters=30)
    jq, jr, last = ref["picard"]
    assert sol.junction_positions.dtype == torch.float64
    for mine, theirs in ((sol.junction_quaternions, jq), (sol.junction_positions, jr),
                         (sol.positions[-1], last)):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0, atol=1e-10)
    # continuity by construction: each junction is its segment's point 0
    for s in range(3):
        assert torch.equal(sol.junction_quaternions[:, s], sol.quaternions[s][:, 0])


@pytest.mark.parametrize("wide", [False, True])
def test_fused_chain_matches_jax_picard(ref, wide):
    """K4 (narrow n=16 x 3, wide n=48 x 2) chained against the JAX picard chain."""
    if wide:
        cfg, qe, key, kw = segments.uniform_segments(2, n=48), ref["qe48"], "picard48", {}
    else:
        cfg, qe, key = segments.uniform_segments(3, n=16), ref["qe"], "picard"
        kw = dict(q_init=torch.tensor(ref["q0"]), r_init=torch.tensor(ref["r0"]))
    sol = segments.segmented_rod_shape(torch.tensor(qe, dtype=torch.float32), cfg,
                                       method="fused", iters=24 if wide else 20, **kw)
    assert sol.junction_positions.dtype == torch.float32
    jq, jr, last = ref[key]
    for mine, theirs in ((sol.junction_quaternions, jq), (sol.junction_positions, jr),
                         (sol.positions[-1], last)):
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("wide", [False, True])
def test_refined_fused_chain_hits_gate_vs_oracle_chain(wide):
    """K5 chains with f32-pair junctions: every junction within 1e-8 of the
    f64 oracle chain, narrow (3 x n=16, total length 3: |r| ~ 2) and wide
    (2 x n=48); f32-pair strain input."""
    rng = np.random.default_rng(13)
    cfg = (segments.uniform_segments(2, n=48) if wide
           else segments.uniform_segments(3, n=16, total_length=3.0))
    qe64 = (0.5 if wide else 1.0) * rng.standard_normal((cfg.num_segments, 9))
    tips_q, tips_r = _oracle_chain(qe64, cfg)
    sol = segments.segmented_rod_shape(rod.split_strain(torch.tensor(qe64[None])), cfg,
                                       method="refined_fused", iters=22, corr_iters=22)
    scale = np.abs(tips_r).max()
    (q_hi, q_lo), (r_hi, r_lo) = sol.junction_dd
    assert np.abs(sol.tip_position_f64()[0].numpy() - tips_r[-1]).max() / scale < GATE
    assert np.abs(sol.tip_quaternion_f64()[0].numpy() - tips_q[-1]).max() < GATE
    np.testing.assert_allclose((r_hi.double() + r_lo.double())[0].numpy(), tips_r,
                               rtol=0, atol=GATE * scale)
    assert len(sol.quaternions_dd) == cfg.num_segments


def test_refined_chains_with_inits(ref):
    """General inits, both refined chains against the oracle chain:
    'refined_fused' (K5) at the gate; 'refined' rounds each junction state
    to f32, as the JAX package's 'refined' does, and returns one f32 word,
    so it is held at 5e-7."""
    cfg = segments.uniform_segments(3, n=16)
    qe, q0, r0 = (torch.tensor(ref[k]) for k in ("qe", "q0", "r0"))
    fused = segments.segmented_rod_shape(qe.float(), cfg, q_init=q0, r_init=r0,
                                         method="refined_fused")
    plain = segments.segmented_rod_shape(qe, cfg, q_init=q0, r_init=r0, method="refined")
    # the K5 chain's input words: f32 strains and f32 initial states
    f32 = {k: ref[k].astype(np.float32).astype(np.float64) for k in ("qe", "q0", "r0")}
    r_fused = dd.join_f64(*fused.junction_dd[1]).numpy()
    for i in range(B):
        tips_q, tips_r = _oracle_chain(f32["qe"][i], cfg, f32["q0"][i], f32["r0"][i])
        assert np.abs(r_fused[i] - tips_r).max() < GATE
        assert np.abs(fused.tip_quaternion_f64()[i].numpy() - tips_q[-1]).max() < GATE
        tips_q, tips_r = _oracle_chain(ref["qe"][i], cfg, ref["q0"][i], ref["r0"][i])
        assert np.abs(plain.junction_positions[i].numpy() - tips_r).max() < 5e-7
        assert np.abs(plain.junction_quaternions[i].numpy() - tips_q).max() < 5e-7


def test_high_order_shape_is_rod_shape():
    qe = torch.tensor(oracle.demo_qe())
    sol = segments.high_order_shape(qe, n=64, method="dense")
    torch.testing.assert_close(sol.positions, rod.rod_shape(qe, cfg=rod.RodConfig(n=64),
                                                            method="dense").positions)
