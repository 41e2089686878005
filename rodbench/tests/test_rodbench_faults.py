"""A run with the timed path broken underneath comes out not correct, once for
each fault a cell can have, and so does a run with the cell's control (the
plain reference one precision lower) in the program's place; a sound run
comes out correct.  The run skips the
look for a card and drives the rest of the harness on the CPU at a small
batch.  Both cells run on one chip, so the fault of an exchange between chips
left out cannot occur."""

import time

import pytest
import torch

from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    cosserat as port_statics,
)
from experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch.models import (
    rod as port_rod,
)
from rodbench import control, run, window

SMALL = {"batch": 32, "pool": 2, "warm_calls": 1, "check_calls": 2}
ROD, STATICS = "rod_refined_n16.sweep_1m", "statics_n16.sweep_128k"
STATICS_CONTROL_BATCH = 256


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def measure(workload, **small):
    manifest = run.load_manifest()
    cell, config, traffic = run.cell_parts(manifest, workload)
    line, _ = window.measure(cell, config, dict(traffic, **dict(SMALL, **small)),
                             run.cell_metrics(manifest, workload, False), 2147483711, 0.3,
                             False, torch.device("cpu"), time.perf_counter())
    return line


def broken_rod(fault):
    real = port_rod.rod_shape_refined_fused

    def call(qe, **kw):
        sol = real(qe, **kw)
        q_hi, q_lo = sol.quaternions_dd
        r_hi, r_lo = sol.positions_dd
        if fault == "state_unchanged":        # the initial state, never integrated
            q_hi = torch.zeros_like(q_hi)
            q_hi[..., 0] = 1.0
            q_lo, r_hi, r_lo = (torch.zeros_like(t) for t in (q_lo, r_hi, r_lo))
        elif fault == "half_batch":           # the second half of the rods left out
            half = q_hi.shape[0] // 2
            for t in (q_hi, q_lo, r_hi, r_lo):
                t[half:] = 0.0
        elif fault == "answer_altered":       # one rod's answer off where it is made
            q_hi[3, 7, 2] *= 1.0 + 1e-6
        return port_rod.RodSolution(q_hi + q_lo, r_hi + r_lo, (q_hi, q_lo), (r_hi, r_lo))

    return call


def broken_statics(fault):
    real = port_statics.solve_statics_batched

    def call(tip_force, **kw):
        sol = real(tip_force, **kw)
        qe = sol.qe.clone()
        if fault == "state_unchanged":        # the Newton returns its start, claims success
            qe.zero_()
        elif fault == "half_batch":           # the second half of the loads left out
            qe[qe.shape[0] // 2:] = 0.0
        elif fault == "answer_altered":       # one load's strains off where they are made
            qe[5, 4] += 1e-3
        return sol._replace(qe=qe)

    return call


def test_sound_runs_are_correct():
    for workload in (ROD, STATICS):
        line = measure(workload)
        assert line["correct"] is True, line["checks"]
        assert line["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_rod_faults_are_caught(monkeypatch, fault):
    monkeypatch.setattr(port_rod, "rod_shape_refined_fused", broken_rod(fault))
    line = measure(ROD)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_statics_faults_are_caught(monkeypatch, fault):
    monkeypatch.setattr(port_statics, "solve_statics_batched", broken_statics(fault))
    line = measure(STATICS)
    assert line["correct"] is False, line["checks"]


def test_rod_control_fails_the_limit():
    """The float32 reference in the program's place reads far above the 1e-8 limit."""
    config = run.cell_parts(run.load_manifest(), ROD)[1]
    with control.in_place(config):
        line = measure(ROD)
    assert line["correct"] is False
    assert line["checks"]["q_rel_linf"]["value"] > 10 * line["checks"]["q_rel_linf"]["limit"]
    assert line["checks"]["r_rel_linf"]["value"] > 10 * line["checks"]["r_rel_linf"]["limit"]


def test_statics_control_fails_the_check():
    """The TF32 Newton in the program's place fails one of the cell's numbers:
    loads it leaves unconverged, or a float64 residual above the limit."""
    config = run.cell_parts(run.load_manifest(), STATICS)[1]
    with control.in_place(config):
        line = measure(STATICS, batch=STATICS_CONTROL_BATCH)
    assert line["correct"] is False, line["checks"]
