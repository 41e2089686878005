"""The harness on the CPU: the manifest's names and units, finding a new
configuration, mix and metric by name alone, the import check, and a run
without a card."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from rodbench import run, window
from rodbench.metrics import readers

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch"
JAX_PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu"


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest()


def test_names_and_units_use_allowed_characters(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [w["name"] for w in manifest["workloads"]] + [c["name"] for c in manifest["configs"]]
    names += [w["config"] for w in manifest["workloads"]] + [w["traffic"] for w in manifest["workloads"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for section in ("end_to_end", "per_layer", "workloads", "configs"):
        got = [e["name"] for e in manifest[section]]
        assert len(got) == len(set(got)), section
    texts = [w["why"] for w in manifest["workloads"] + manifest["configs"]]
    texts += [m["layer"] for m in manifest["per_layer"]] + [c["source"] for c in manifest["configs"]]
    texts += manifest["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_manifest_is_consistent(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (ROOT / "rodbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        found, config, traffic = run.cell_parts(manifest, cell)
        assert (ROOT / "rodbench" / "entries" / f"{config['entry']}.py").is_file()
        assert found["chips"] in (1, 4) and traffic["batch"] > 0
        assert config["name"] == found["config"]
    for c in manifest["configs"]:
        assert c["file"].startswith("rodbench/")


def test_import_check_compares_whole_top_level_names():
    loaded = ["jax.numpy", "jaxlib.xla_client", "flax.linen", f"{JAX_PKG}.models.rod",
              f"{PORT}.models.rod", "jax_extra", "flaxen", f"{JAX_PKG}_other", "torch"]
    assert run.forbidden_loaded(loaded) == sorted(["flax", JAX_PKG, "jax", "jaxlib"])
    assert run.forbidden_loaded([f"{PORT}.models.rod", "jax_extra", "torch"]) == []


def test_nothing_forbidden_is_loaded_by_the_harness():
    code = ("import sys; from rodbench import run, window, control; "
            "from rodbench.entries import rod_refined, statics_batched; "
            "print(run.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "rodbench.run", "--workload",
                          "statics_n16.sweep_128k", "--seed", "2147483999", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout


NEW_FILES = {
    "configs/rod_refined_n8.json": None,          # a copy of rod_refined_n16 at n=8
    "traffic/tiny_mix.json": {"why": "a tiny mix", "batch": 16, "pool": 2,
                              "inputs": {"dist": "normal", "scale": 0.5},
                              "warm_calls": 1, "check_calls": 1, "trace_after_calls": 1,
                              "trace_calls": 1},
    "metrics/calls_seen.py": "def read(rec):\n    return float(len(rec.calls))\n",
}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """Files dropped into a copy of the benchmark, and entries added to its
    manifest, run with no edit of any file that was there."""
    shutil.copytree(ROOT / "rodbench", tmp_path / "rodbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / PORT).symlink_to(ROOT / PORT)
    manifest = run.load_manifest()
    config = json.loads((ROOT / "rodbench/configs/rod_refined_n16.json").read_text())
    config.update(name="rod_refined_n8", n=8)
    for rel, content in NEW_FILES.items():
        path = tmp_path / "rodbench" / rel
        if content is None:
            content = config
        path.write_text(content if isinstance(content, str) else json.dumps(content))
    manifest["configs"].append({"name": "rod_refined_n8", "source": "a test",
                                "file": "rodbench/configs/rod_refined_n8.json",
                                "reduced": ["n"], "why": "a test"})
    manifest["workloads"].append({"name": "rod_refined_n8.tiny_mix", "config": "rod_refined_n8",
                                  "traffic": "tiny_mix", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "calls_seen", "unit": "count", "better": "higher",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["rod_refined_n8.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (
        "import json, time, torch\n"
        "torch.set_num_threads(1)\n"
        "from rodbench import run, window\n"
        "m = run.load_manifest()\n"
        "cell, config, traffic = run.cell_parts(m, 'rod_refined_n8.tiny_mix')\n"
        "line, _ = window.measure(cell, config, traffic,\n"
        "    run.cell_metrics(m, 'rod_refined_n8.tiny_mix', False), 7, 0.3, False,\n"
        "    torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"calls_seen", "setup_s"}
    assert line["metrics"]["calls_seen"]["value"] >= 1
    assert list(line)[-1] == "checks"


def test_readers_without_a_trace_return_nothing():
    rec = window.Records(cell={}, config={"n": 16, "na": 3, "ne": 3, "iters": 20,
                                          "corr_iters": 20, "jac_iters": 8},
                         traffic={"batch": 8}, setup_s=1.0, window_s=1.0,
                         calls=[(0.0, 0.1, 0.2)], latencies_ms=[0.2], items=8, counters={},
                         profiled=range(0), trace=None)
    for name in ("k3_roofline", "k1k2_roofline", "device_idle_pct.rod", "step_mfu.rod",
                 "step_mfu.statics", "statics_events_per_call", "newton_iters"):
        assert window.load_reader(name).read(rec) is None, name
    assert readers.idle_pct(None) is None


def test_trace_reduction_helpers():
    assert window._short("void (anonymous namespace)::rod_shape_refined_kernel<16, 3, false>"
                         "(float const*, int)") == "rod_shape_refined_kernel<16, 3, false>"
    assert window._short("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert window._union([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]
    batches, calls, syncs = [(0.0, 1.0), (1.1, 2.0)], [(0.1, 0.6), (1.2, 1.7)], [0.3]
    assert window._gap_kind(0.9, 1.3, batches, calls, syncs, "sync") == "between_batches"
    assert window._gap_kind(0.3, 0.35, batches, calls, syncs, "sync") == "sync"
    assert window._gap_kind(1.3, 1.4, batches, calls, syncs, "sync") == "host_enqueue"


def test_reservoir_is_a_seeded_uniform_sample():
    picks = []
    for seed in range(400):
        r = window.Reservoir(2, seed)
        for i in range(10):
            r.offer(i, i)
        picks += r.items
    counts = [picks.count(i) for i in range(10)]
    assert min(counts) > 40 and max(counts) < 120
    r1, r2 = window.Reservoir(2, 9), window.Reservoir(2, 9)
    for i in range(50):
        r1.offer(i, i)
        r2.offer(i, i)
    assert r1.items == r2.items
