"""Suite-wide pytest hooks, loaded before ``tests/conftest.py``.

``SLOW`` names the JAX-only tests that the tier-1 run deselects with
``-m 'not slow'`` so that it ends inside its time limit. Each reason gives
the test's junit seconds (six xdist workers, ``--dist loadfile``, on an
8-core CPU) and the test that still covers its code on every run. Port
tests (``test_torch_*.py``) are never listed; ``-m slow`` runs the list.

``LIMIT`` is every test's own time limit, its setup, call and teardown
together: past it the test fails, and the rest of its file runs, so a hang
costs one test and not the whole run. Every thread's stack is dumped to
stderr at ``STACKS_AT``, also for a hang inside C code that the alarm cannot
interrupt.

This file imports neither JAX nor either package: ``tests/conftest.py``
sets ``XLA_FLAGS`` before JAX is first imported.
"""

import faulthandler
import os
import pathlib
import signal
import subprocess

import pytest

SLOW = {
    "tests/test_parallel.py::test_dryrun_multichip_entrypoint":
        "484.6 s; test_dryrun_multichip_self_provisions runs the same _dryrun_body(8)",
    "tests/test_examples_smoke.py::test_example_runs[optimal_control.py]":
        "356.5 s; test_torch_examples.py::test_example_runs[optimal_control], "
        "test_control.py::test_optimize_protocol_batched_initial_conditions",
    "tests/test_control.py::test_rollout_gradient_matches_finite_differences":
        "177.8 s; test_torch_control.py::test_loss_value_and_grad_match_jax takes JAX's gradient",
    "tests/test_examples_smoke.py::test_example_runs[shape_sensing.py]":
        "163.5 s; test_torch_examples.py::test_example_runs[shape_sensing], test_sensing.py",
    "tests/test_constrained.py::test_platform_portal_sway_buckling_two_modes":
        "135.7 s; test_constrained.py::test_platform_stability_single_leg_euler_column, "
        "test_torch_constrained.py::test_solutions_and_platform_stability_match_jax",
    "tests/test_control.py::test_optimize_protocol_reaches_reachable_maneuver_target":
        "130.6 s; test_control.py::test_optimize_protocol_batched_initial_conditions, "
        "test_torch_control.py::test_loss_value_and_grad_match_jax",
    "tests/test_cosserat_statics.py::test_batched_riks_dd_residual_tight_tol":
        "130.4 s; test_cosserat_statics.py::test_batched_riks_matches_host_paths, "
        "test_torch_continuation.py::test_batched_riks_matches_host_walker[dd]",
    "tests/test_estimation.py::test_nees_consistency_monte_carlo":
        "107.6 s; test_estimation.py::test_tracks_known_driven_motion, "
        "test_torch_estimation.py::test_ekf_step_matches_jax",
    "tests/test_dynamics.py::test_frequency_response_closed_form_and_time_domain":
        "76.5 s; test_fluid.py::test_frequency_response_resonance_damped_by_drag, "
        "test_torch_spectra.py::test_frequency_response_matches_modal_closed_form",
    "tests/test_dynamics.py::test_self_contact_holds_coiling_rod_open":
        "75.0 s; test_torch_scenes.py::test_rod_rod_contact_matches_jax (the coil), "
        "test_torch_scenes.py::test_self_window_rides_broadphase_unchanged",
    "tests/test_dynamics.py::test_contact_bounce_energy_conserved_at_rk4_order":
        "74.5 s; test_dynamics.py::test_energy_conserved_at_rk4_order, "
        "test_dynamics.py::test_contact_plane_supports_drooping_rod",
    "tests/test_dynamics.py::test_contact_sphere_drape":
        "74.5 s; test_dynamics.py::test_contact_statics_drapes_on_floor_and_sphere, "
        "test_torch_dynamics.py::test_mass_and_rhs_every_branch_matches_jax",
    "tests/test_dynamics.py::test_critical_load_classical_boundaries":
        "70.3 s; test_examples_smoke.py::test_example_runs[flutter_analysis.py], "
        "test_torch_spectra.py::test_critical_load_classical_boundaries",
    "tests/test_dynamics.py::test_rod_rod_friction_dissipates_scene_energy":
        "67.7 s; test_dynamics.py::test_rod_rod_friction_force_properties, "
        "test_torch_scenes.py::test_rod_rod_contact_matches_jax",
    "tests/test_floquet.py::test_floquet_locates_mathieu_tongue_boundary_sharply":
        "158.5 s; test_floquet.py::test_floquet_multipliers_equal_exp_of_damped_poles, "
        "test_dynamics.py::test_parametric_stability_map_locates_tongue",
    "tests/test_examples_smoke.py::test_example_runs[contact_scene.py]":
        "120.6 s; test_torch_examples.py::test_example_runs[contact_scene], "
        "test_dynamics.py::test_rod_rod_contact_separates_overlapping_pair",
    "tests/test_estimation.py::test_filter_beats_per_frame_static_fit":
        "104.4 s; test_estimation.py::test_tracks_known_driven_motion, "
        "test_torch_estimation.py::test_ekf_step_matches_jax",
    "tests/test_examples_smoke.py::test_example_runs[magnetic_catheter.py]":
        "93.9 s; test_torch_examples.py::test_example_runs[magnetic_catheter], "
        "test_magnetics.py::test_strong_field_aligns_tip_tangent",
    "tests/test_estimation.py::test_rts_smoother_improves_on_filter":
        "81.2 s; test_torch_estimation.py::"
        "test_rts_step_matches_jax_and_smoothed_covariances_stay_psd runs JAX's rts_smoother",
    "tests/test_dynamics.py::test_contact_cylinder_drape":
        "74.7 s; test_torch_dynamics.py::test_mass_and_rhs_every_branch_matches_jax "
        "(a ContactCylinder among its obstacles)",
    "tests/test_dynamics.py::test_implicit_newmark_matches_rk4_in_stable_regime":
        "71.8 s; test_dynamics.py::test_implicit_newmark_stable_far_beyond_rk4_limit, "
        "test_torch_implicit.py::test_newmark_matches_rk4_and_conserves_energy",
    "tests/test_cosserat_statics.py::test_solve_statics_differentiable_compliance":
        "71.0 s; test_torch_statics_dd.py::test_solve_statics_differentiable_matches_jax_grad "
        "takes jax.grad through the same solve",
    "tests/test_cosserat_statics.py::test_batched_riks_traverses_fold_family":
        "70.2 s; test_cosserat_statics.py::test_batched_riks_matches_host_paths, "
        "test_torch_continuation.py::test_batched_riks_matches_host_walker",
}

LIMIT = 600
STACKS_AT = LIMIT - 30


class TimeLimitExceeded(BaseException):
    """A test ran past ``LIMIT``. Not an ``Exception``, so that the test's
    own ``except Exception`` does not swallow it; ``subprocess.run`` kills
    the child it was waiting on."""


def _time_limit_exceeded(signum, frame):
    raise TimeLimitExceeded(f"the test ran past its {LIMIT} s time limit")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    # Output capture is off between the phases, so fd 2 is the real stderr
    # here; during the phases it is the capture's file, which a test that
    # never ends would never show.
    stderr = os.dup(2)
    previous = signal.signal(signal.SIGALRM, _time_limit_exceeded)
    faulthandler.dump_traceback_later(STACKS_AT, exit=False, file=stderr)
    signal.alarm(LIMIT)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
        os.close(stderr)


_NATIVE = pathlib.Path(__file__).resolve().parent / "native"


def pytest_configure(config):
    """Build the native oracle once, in the controller, before any xdist
    worker starts; the workers would otherwise each run ``make`` while they
    collect and could load a half-written library. A failed build is left
    to ``tests/test_native_oracle.py``, which then skips."""
    if hasattr(config, "workerinput") or (_NATIVE / "build" / "libspectral_oracle.so").exists():
        return
    try:
        subprocess.run(["make", "-C", str(_NATIVE)], check=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        pass


def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
