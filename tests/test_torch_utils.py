"""Port parity: utils/diagnostics, utils/profiling and utils/io.

The diagnostics of the demo strain against the JAX package's (the
condition number of the collocation matrix, ~186 at N=16, to 1e-9
relative; the unit-norm drift and the collocation residual of the f64
dense solve below 1e-11; the convergence report decaying),
the profiling helpers' contracts, the ``.npz`` round trip (a file written
by the JAX package's ``save_results`` included) and a training-state
checkpoint of the port's calibration parameters with ``torch.optim.Adam``
state. Last, the root ``conftest.py``'s list of slow tests names real JAX
tests and never one of the port's, and its per-test time limit fails a
hanging test and lets the rest of its file run.
"""

import ast
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import tomllib
from xml.etree import ElementTree

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu.utils import (
    diagnostics as jdiag,
    io as jio,
    oracle,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    calibration,
    rod,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.utils import (
    diagnostics,
    io,
    profiling,
)
from torch_threads import one_cpu_thread  # noqa: F401

DEMO = rod.demo_qe(torch.float64, "cpu")


def test_condition_number_matches_jax():
    cond = diagnostics.condition_number(DEMO)
    assert cond == pytest.approx(186, rel=0.2)
    assert cond == pytest.approx(jdiag.condition_number(oracle.demo_qe()), rel=1e-9)


@pytest.mark.parametrize("method", ["dense", "refined"])
def test_drift_and_residual_of_the_demo_solve(method):
    qe = DEMO if method == "dense" else rod.split_strain(DEMO)
    sol = rod.rod_shape(qe, method=method)
    assert diagnostics.quaternion_norm_drift(sol) < 1e-11
    assert diagnostics.solution_residual_norm(DEMO, sol) < 1e-11
    batch = rod.rod_shape(DEMO.expand(3, 9), method="dense")
    assert diagnostics.solution_residual_norm(DEMO.expand(3, 9), batch) < 1e-11


def test_convergence_report_decays():
    rep = diagnostics.convergence_report(DEMO, ns=(8, 12, 16))
    assert rep[16] < rep[12] < rep[8]
    assert rep[16] < 1e-9


def test_throughput_rejects_nonscalar_and_times_a_scalar():
    with pytest.raises(ValueError, match="scalar"):
        profiling.throughput(lambda x: x * 2, torch.ones(4))
    with pytest.raises(ValueError, match="scalar"):
        profiling.throughput(lambda x: float(x.sum()), torch.ones(4))
    dt, rate = profiling.throughput(lambda x: (x * 2).sum(), torch.ones(1024), reps=3,
                                    items=1024)
    assert dt > 0 and rate > 0
    assert profiling.throughput(lambda x: x.sum(), torch.ones(4), reps=1)[1] is None


def test_timer_laps():
    t = profiling.Timer()
    assert t.lap("a") >= 0
    t.lap("b")
    rep = t.report()
    assert set(rep) == {"a", "b"} and all(v >= 0 for v in rep.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as path:
        rod.rod_shape(DEMO, method="dense")
    events = json.loads(path.read_text())["traceEvents"]
    assert path.parent == tmp_path / "trace" and len(events) > 0


def test_results_roundtrip_and_jax_files(tmp_path):
    q = torch.ones((4, 15, 4), dtype=torch.float32)
    r = np.arange(12.0).reshape(4, 3)
    back = io.load_results(io.save_results(tmp_path / "sub" / "sweep.npz", quaternions=q,
                                           tips=r, alphas=[0.25, 0.5]))
    np.testing.assert_array_equal(back["quaternions"], q.numpy())
    assert back["quaternions"].dtype == np.float32
    np.testing.assert_array_equal(back["tips"], r)
    np.testing.assert_array_equal(back["alphas"], [0.25, 0.5])
    jio.save_results(tmp_path / "jax.npz", quaternions=jnp.ones((2, 3)), tips=r)
    back = io.load_results(tmp_path / "jax.npz")
    np.testing.assert_array_equal(back["quaternions"], np.ones((2, 3)))
    np.testing.assert_array_equal(back["tips"], r)


def test_train_state_roundtrip(tmp_path):
    cfg = rod.RodConfig(n=8)
    params = calibration.init_params(4, cfg, seed=3, device="cpu")
    step, optimizer = calibration.make_train_step(cfg=cfg, iters=8)
    opt = optimizer(params)
    rng = np.random.default_rng(0)
    feats = torch.tensor(rng.standard_normal((4, 4)), dtype=torch.float32)
    targets = torch.tensor(rng.standard_normal((4, 3)), dtype=torch.float32)
    for _ in range(2):
        step(params, opt, feats, targets)
    io.save_train_state(tmp_path / "ckpt.pt", {"params": params, "optimizer": opt.state_dict()})

    blank = calibration.init_params(4, cfg, seed=99, device="cpu")
    opt2 = optimizer(blank)
    back = io.restore_train_state(tmp_path / "ckpt.pt",
                                  {"params": blank, "optimizer": opt2.state_dict()})
    assert isinstance(back["params"], calibration.CalibrationParams)
    torch.testing.assert_close(back["params"].w, params.w.detach(), rtol=0, atol=0)
    torch.testing.assert_close(back["params"].b, params.b.detach(), rtol=0, atol=0)
    opt2.load_state_dict(back["optimizer"])
    for k in ("exp_avg", "exp_avg_sq", "step"):
        torch.testing.assert_close(opt2.state_dict()["state"][0][k], opt.state_dict()["state"][0][k],
                                   rtol=0, atol=0)
    with pytest.raises(TypeError, match="pickles no other object"):
        io.save_train_state(tmp_path / "bad.pt", {"params": params, "hook": object()})


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _parametrize_ids(func, module):
    """The string ids of ``func``'s ``pytest.mark.parametrize`` values, a
    literal or a module-level name bound to one."""
    names = {t.id: node.value for node in module.body if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name)}
    ids = set()
    for dec in func.decorator_list:
        if isinstance(dec, ast.Call) and getattr(dec.func, "attr", None) == "parametrize":
            values = dec.args[1]
            values = names.get(values.id, values) if isinstance(values, ast.Name) else values
            ids.update(str(v) for v in ast.literal_eval(values))
    return ids


def test_slow_list_names_jax_tests_with_seconds():
    """Each ``SLOW`` key is ``tests/<file>::<function>[<id>]`` of a JAX test
    file (never ``test_torch_*.py``) that defines the function and, with a
    suffix, the parametrize id; each reason gives its junit seconds; and
    ``slow`` is a registered marker."""
    spec = importlib.util.spec_from_file_location("_root_conftest", ROOT / "conftest.py")
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    assert root_conftest.SLOW
    for nodeid, reason in root_conftest.SLOW.items():
        m = re.fullmatch(r"(tests/test_\w+\.py)::(\w+)(?:\[(.+)\])?", nodeid)
        assert m, nodeid
        path, name, param = m.groups()
        assert (ROOT / path).is_file() and not path.startswith("tests/test_torch_"), nodeid
        module = ast.parse((ROOT / path).read_text())
        funcs = [f for f in module.body if isinstance(f, ast.FunctionDef) and f.name == name]
        assert len(funcs) == 1, nodeid
        if param is not None:
            assert param in _parametrize_ids(funcs[0], module), nodeid
        assert re.search(r"\b\d+(\.\d+)? s\b", reason), (nodeid, reason)
    with open(ROOT / "pyproject.toml", "rb") as f:
        markers = tomllib.load(f)["tool"]["pytest"]["ini_options"]["markers"]
    assert any(m.startswith("slow:") for m in markers), markers


_HANGING_FILE = '''
import subprocess, sys, time

def test_sleeps():
    time.sleep(30)

def test_waits_on_a_sleeping_child():
    code = "import os, sys, time; open(sys.argv[1], 'w').write(str(os.getpid())); time.sleep(30)"
    subprocess.run([sys.executable, "-c", code, {pidfile!r}])

def test_passes():
    pass
'''

_LIMITED_CONFTEST = '''
import importlib.util

spec = importlib.util.spec_from_file_location("_root_conftest", {conftest!r})
root_conftest = importlib.util.module_from_spec(spec)
spec.loader.exec_module(root_conftest)
root_conftest.LIMIT, root_conftest.STACKS_AT = 1, 0.5
pytest_runtest_protocol = root_conftest.pytest_runtest_protocol
'''


def test_time_limit_fails_a_hanging_test_and_the_file_runs_on(tmp_path):
    """The root ``conftest.py``'s per-test limit, cut to 1 s in a child
    pytest: a test asleep and a test waiting in ``subprocess.run`` on a
    sleeping child each fail at the limit with every thread's stack dumped
    first, the child is killed, and the file's next test passes."""
    pidfile = tmp_path / "child.pid"
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "conftest.py").write_text(
        _LIMITED_CONFTEST.format(conftest=str(ROOT / "conftest.py")))
    (tmp_path / "test_hangs.py").write_text(_HANGING_FILE.format(pidfile=str(pidfile)))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--junitxml=junit.xml",
         "test_hangs.py"],
        cwd=tmp_path, env={**os.environ, "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"},
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 1, run.stdout + run.stderr
    cases = ElementTree.parse(tmp_path / "junit.xml").getroot().iter("testcase")
    failures = {case.get("name"): [f.get("message") for f in case.iter("failure")] for case in cases}
    limit_hit = ["_root_conftest.TimeLimitExceeded: the test ran past its 1 s time limit"]
    assert failures == {"test_sleeps": limit_hit, "test_waits_on_a_sleeping_child": limit_hit,
                        "test_passes": []}, failures
    assert run.stderr.count("Timeout (0:00:00.500000)!") == 2, run.stderr
    with pytest.raises(ProcessLookupError):
        os.kill(int(pidfile.read_text()), 0)
