"""The port's thirteen examples run in-process on the CPU at their smoke
sizes (``--device cpu --smoke``), so that none can rot unseen; the demo's
tip matches the golden values of ``SURVEY.md`` section 4."""

import importlib
import tempfile

import numpy as np
import pytest

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.examples import (
    EXAMPLES,
)
from torch_threads import one_cpu_thread  # noqa: F401

PKG = "experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.examples"
GOLDEN_Q = (0.799770, 0.0, 0.600307, 0.0)
GOLDEN_R = (0.562673, 0.0, -0.745914)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))   # where results are saved
    out = importlib.import_module(f"{PKG}.{name}").main(["--device", "cpu", "--smoke"])
    printed = capsys.readouterr().out
    assert printed.strip() and out, name
    if name == "demo":
        np.testing.assert_allclose(out["tip_quaternion"], GOLDEN_Q, atol=1e-6)
        np.testing.assert_allclose(out["tip_position"], GOLDEN_R, atol=1e-6)
        assert "0.799770, 0, 0.600307, 0" in printed
    if "path" in out:
        assert out["path"].parent == tmp_path and out["path"].exists()
