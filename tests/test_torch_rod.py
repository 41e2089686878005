"""Port parity: the slice as a whole, through the entry points a user calls.

``rod_shape_refined_fused`` (single-kernel and staged branches) and
``rod_shape`` (methods dense, picard, refined, fused) against the JAX
package and the f64 oracle, N=16, B=8, strains ``0.8 N(0,1)`` with rod 0
the demo strain.  Also: no file of the port imports jax, and CPU tensors
never launch a CUDA kernel.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.models import rod as jrod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import oracle
import experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch as port
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import rod
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops import (
    collocation as coll,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.ops.kernels import (
    refined_kernel as rfk,
    rod_kernel as rk,
)
from torch_threads import one_cpu_thread  # noqa: F401

B = 8
GATE = 1e-8        # refined relative L-inf gate (tests/test_refined_kernel.py:77)
F32_TOL = 5e-5     # fused / picard f32 gate (tests/test_pallas_kernel.py:43,91)
REPO = Path(__file__).resolve().parents[1]


@jax.jit
def _jax_refs(hi, lo, qe6):
    """The JAX references, compiled as one program."""
    jref = jrod.rod_shape((hi, lo), method="refined")
    jpic = jrod.rod_shape(hi, method="picard", iters=20)
    jdense6 = jrod.rod_shape(qe6, cfg=jrod.RodConfig(na=6), method="dense")
    return (jref.quaternions_dd, jref.positions_dd, jpic.quaternions, jpic.positions,
            jdense6.quaternions, jdense6.positions)


def _joined(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(31)
    qe64 = 0.8 * rng.standard_normal((B, 9))
    qe64[0] = oracle.demo_qe()
    hi, lo = jrod.split_strain(qe64)
    orc = [oracle.integrate_position(q) for q in qe64]
    qe6 = 0.4 * rng.standard_normal((4, 18))
    jq, jr, pic_q, pic_r, d6_q, d6_r = _jax_refs(jnp.asarray(hi), jnp.asarray(lo),
                                                 jnp.asarray(qe6))
    return dict(
        qe64=qe64, hi=torch.tensor(hi), lo=torch.tensor(lo),
        jq=_joined(jq), jr=_joined(jr),
        pic_q=np.asarray(pic_q), pic_r=np.asarray(pic_r),
        oq=np.stack([q.reshape(4, 15).T for q, _ in orc]),
        orr=np.stack([r for _, r in orc]),
        qe6=qe6, d6_q=np.asarray(d6_q), d6_r=np.asarray(d6_r))


def _rel(x, y):
    return np.abs(np.asarray(x) - y).max() / np.abs(y).max()


@pytest.mark.parametrize("refine_steps", [1, 2])
def test_refined_fused_matches_jax_and_oracle(ref, refine_steps):
    """refine_steps=1 takes the single kernel (K3), 2 the staged K2 path."""
    sol = rod.rod_shape_refined_fused((ref["hi"], ref["lo"]), refine_steps=refine_steps)
    q, r = sol.quaternions_f64().numpy(), sol.positions_f64().numpy()
    for a, b in ((q, ref["oq"]), (r, ref["orr"]), (q, ref["jq"]), (r, ref["jr"])):
        assert _rel(a, b) < GATE
    assert sol.tip_position.shape == (B, 3) and sol.q_stack.shape == (B, 60)
    np.testing.assert_allclose(sol.q_stack[0].numpy(), oracle.integrate_position(
        oracle.demo_qe())[0], atol=1e-7)


@pytest.mark.parametrize("method", ["dense", "picard", "refined", "fused"])
def test_rod_shape_methods_match_jax_and_oracle(ref, method):
    if method == "dense":
        sol = rod.rod_shape(torch.tensor(ref["qe64"]), method="dense")
        assert sol.positions.dtype == torch.float64
        assert _rel(sol.quaternions, ref["oq"]) < 1e-12
        assert _rel(sol.positions, ref["orr"]) < 1e-12
        return
    if method == "refined":
        sol = rod.rod_shape((ref["hi"], ref["lo"]), method="refined")
        for a, b in ((sol.quaternions_f64(), ref["oq"]), (sol.positions_f64(), ref["orr"]),
                     (sol.quaternions_f64(), ref["jq"]), (sol.positions_f64(), ref["jr"])):
            assert _rel(a, b) < GATE
        return
    sol = rod.rod_shape(ref["hi"], method=method, iters=20)
    assert sol.positions.dtype == torch.float32 and sol.quaternions_dd is None
    np.testing.assert_allclose(sol.quaternions.numpy(), ref["pic_q"], atol=F32_TOL)
    np.testing.assert_allclose(sol.positions.numpy(), ref["pic_r"], atol=F32_TOL)
    np.testing.assert_allclose(sol.positions.numpy(), ref["orr"], atol=F32_TOL)


def test_six_dof_paths_match_jax_dense(ref):
    """na=6 Reissner strains on every path, against the JAX f64 dense solve."""
    cfg = rod.RodConfig(na=6)
    qe6 = torch.tensor(ref["qe6"])
    dense = rod.rod_shape(qe6, cfg=cfg, method="dense")
    assert _rel(dense.positions, ref["d6_r"]) < 1e-12
    for kw in (dict(refine_steps=1), dict(refine_steps=2)):
        sol = rod.rod_shape_refined_fused(rod.split_strain(qe6), cfg=cfg, **kw)
        assert _rel(sol.quaternions_f64(), ref["d6_q"]) < GATE
        assert _rel(sol.positions_f64(), ref["d6_r"]) < GATE
    sol = rod.rod_shape(rod.split_strain(qe6), cfg=cfg, method="refined")
    assert _rel(sol.positions_f64(), ref["d6_r"]) < GATE
    for method in ("picard", "fused"):
        sol = rod.rod_shape(qe6.float(), cfg=cfg, method=method, iters=24)
        np.testing.assert_allclose(sol.positions.numpy(), ref["d6_r"], atol=F32_TOL)


def test_quaternion_kinematics_and_demo_match_jax(ref):
    assert torch.equal(rod.demo_qe(device="cpu"), torch.tensor(np.asarray(jrod.demo_qe())))
    hi, lo = rod.split_strain(torch.tensor(ref["qe64"]))
    assert torch.equal(hi, ref["hi"]) and torch.equal(lo, ref["lo"])
    q = rod.quaternion_kinematics((hi, lo), method="refined")
    assert _rel(q.double(), ref["oq"]) < 1e-7      # one f32 word: ~3e-8
    q_hi, q_lo = rod.quaternion_kinematics((hi, lo), method="refined", return_dd=True)
    assert _rel(q_hi.double() + q_lo.double(), ref["oq"]) < GATE
    with pytest.raises(ValueError, match="unknown method"):
        rod.quaternion_kinematics(hi, method="lu")


def test_fused_guards():
    """The fused path keeps the unnormalized semantics; custom boundary
    values (broadcast over the batch) run through K4: a straight rod from
    r0 = (1, 1, 1)."""
    qes = torch.zeros((4, 9))
    with pytest.raises(NotImplementedError, match="unnormalized"):
        rod.rod_shape(qes, method="fused", normalize_quaternions=True)
    sol = rod.rod_shape(qes, method="fused", r_init=torch.ones(3))
    x = torch.tensor(rod.RodConfig().points[:-1], dtype=torch.float32)
    straight = torch.stack([x + 1.0, torch.ones_like(x), torch.ones_like(x)], dim=-1)
    torch.testing.assert_close(sol.positions, straight.expand(4, 15, 3), atol=2e-6, rtol=0)
    with pytest.raises(ValueError, match="512"):
        rod.rod_shape_refined_fused(torch.zeros((4, 9)), cfg=rod.RodConfig(n=514),
                                    refine_steps=1)


def test_cpu_tensors_launch_no_kernel(ref):
    """On CPU tensors every wrapper takes its plain version: the launch
    counts stay at 0 through the whole slice."""
    counted = (rk.rod_shape_fused, rk.picard_correction_fused,
               rfk.rod_shape_refined_kernel)
    for fn in counted:
        fn.launches = 0
    pair = (ref["hi"], ref["lo"])
    port.rod_shape_refined_fused(pair, refine_steps=1)
    port.rod_shape_refined_fused(pair, refine_steps=2)
    port.rod_shape(ref["hi"], method="fused")
    assert [fn.launches for fn in counted] == [0, 0, 0]


def test_default_device_is_the_card():
    """Factories and non-tensor input go to the card; without CUDA they
    raise and name the way to the CPU.  device='cpu' and CPU tensors run."""
    on_card = (rod.demo_qe, lambda: coll.make_grid(16),
               lambda: rod.rod_shape(np.zeros((2, 9)), method="picard"),
               lambda: rod.split_strain(np.zeros(9)))
    if torch.cuda.is_available():
        for call in on_card:
            call()
        assert rod.demo_qe().device.type == "cuda"
    else:
        for call in on_card:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert rod.demo_qe(device="cpu").device.type == "cpu"
    assert coll.make_grid(16, device="cpu").ginv.device.type == "cpu"
    sol = rod.rod_shape(torch.zeros((2, 9)), method="picard")
    assert sol.positions.device.type == "cpu"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    pkg = REPO / "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    jax_pkg = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu"
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", jax_pkg), f"{path}: imports {name}"
