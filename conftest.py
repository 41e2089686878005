"""Suite-wide pytest hooks, loaded before ``tests/conftest.py``.

``SLOW`` names the JAX-only tests that the tier-1 run deselects with
``-m 'not slow'`` so that it ends inside its time limit. Each reason gives
the test's junit seconds (six xdist workers, ``--dist loadfile``, on an
8-core CPU) and the test that still covers its code on every run. Port
tests (``test_torch_*.py``) are never listed; ``-m slow`` runs the list.

This file imports neither JAX nor either package: ``tests/conftest.py``
sets ``XLA_FLAGS`` before JAX is first imported.
"""

import pathlib
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
}

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
