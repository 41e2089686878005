"""PyTorch + CUDA port of the spectral rod-integration framework.

The JAX package ``experimental_gpu_programming_for_a_spectral_numerical_integration_tpu``
beside this one is the reference.  This package ports its main path, the
batched rod-shape solve ``qe (B, na*ne) -> (Q (B, n-1, 4), r (B, n-1, 3))``
on grids up to n-1 = 512, with hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``) in place of the Pallas TPU kernels, and the layers built on it:
the collocation core with its implicit-function derivatives and the
analytic IVP suite (``models/ivp.py``); the statics layer
(``models/cosserat.py``: per-sample and batched Newton, the FP64 residual
on K3 for 1e-9 tolerances, the Armijo line search, load sensitivities,
load and arc-length continuation, host and batched); the bifurcation
tools (``models/bifurcation.py``); the multi-segment rod chains and
their statics Newton (routed tendons included); tendon and magnetic
actuation (``models/tendon.py``, ``models/magnetics.py``) and the
Lagrangian dynamics (``models/dynamics.py``: the mass matrix, also from
K1 + K2, RK4 ``simulate`` and implicit Newmark ``simulate_implicit``, the
damped-Newton contact and actuated statics with tendon inverse kinematics,
rod-rod scenes with a top-k broad phase, segmented rods, and the spectrum
and stability tools); the inverse and constrained layers on top:
tip-constrained rods and parallel platforms (``models/constrained.py``),
trajectory optimization (``models/control.py``), shape sensing and load
identification (``models/sensing.py``, its fused measurement on K1), the
EKF/RTS estimator (``models/estimation.py``) and calibration
(``models/calibration.py``); concentric-tube robots (``models/ctr.py``:
the torsion BVP, stability, backbone shapes and implicit-function
derivatives); the diagnostics, profiling and persistence helpers
(``utils/``) and thirteen runnable examples (``examples/``).  It runs on the card
unless the caller passes CPU tensors or ``device='cpu'``
(``ops/device.py``).  It imports torch and numpy, never jax.

Suggested import alias::

    import experimental_gpu_programming_for_a_spectral_numerical_integration_tpu_torch as spectral_torch
"""

import torch

# A TF32 matrix product keeps ~3 decimal digits and would break the 1e-8
# gate of the refined paths, so f32 products run in full f32.  Set here,
# explicitly, for the whole process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .ops.collocation import SpectralGrid, make_grid  # noqa: E402
from .ops.device import default_device  # noqa: E402
from .models.bifurcation import (  # noqa: E402
    CriticalPoint,
    StabilityInfo,
    detect_critical_points,
    linearized_buckling_loads,
    path_stability,
    switch_branch,
    switch_branch_batched,
)
from .models.calibration import (  # noqa: E402
    CalibrationParams,
    calibration_loss,
    init_params,
    make_train_step,
    predict_tips,
)
from .models.constrained import (  # noqa: E402
    PlatformIKSolution,
    PlatformRobot,
    PlatformSolution,
    PlatformStability,
    TipConstrainedSolution,
    platform_critical_load,
    platform_ik,
    platform_stability,
    solve_platform,
    solve_tip_constrained,
)
from .models.control import (  # noqa: E402
    ControlSolution,
    optimize_protocol,
    protocol_from_knots,
    rollout,
    tip_positions,
    tip_target_cost,
)
from .models.cosserat import (  # noqa: E402
    BatchedContinuationPath,
    ContinuationPath,
    StaticsConfig,
    StaticsSolution,
    arc_length_continuation,
    arc_length_continuation_batched,
    equilibrium_residual,
    equilibrium_residual_dd,
    load_continuation,
    solve_statics,
    solve_statics_batched,
    solve_statics_differentiable,
    stiffness_profile,
)
from .models.ctr import (  # noqa: E402
    CTRConfig,
    CTRSolution,
    TelescopingShape,
    Tube,
    ctr_shape,
    ctr_stability,
    solve_ctr,
    solve_ctr_differentiable,
    solve_ctr_telescoping,
    two_tube_snap_parameter,
)
from .models.dynamics import (  # noqa: E402
    ContactCylinder,
    ContactPlane,
    ContactSphere,
    ContactStaticsSolution,
    DynamicsConfig,
    RodRodContact,
    SegmentedDynamicsConfig,
    Trajectory,
    accelerations,
    critical_load,
    damped_newton,
    damped_spectrum,
    floquet_multipliers,
    frequency_response,
    kinetic_energy,
    linearized_spectrum,
    mass_matrix,
    mass_matrix_fused,
    natural_frequencies,
    parametric_stability_map,
    potential_energy,
    scene_accelerations,
    scene_energy,
    simulate,
    simulate_implicit,
    simulate_scene,
    solve_contact_statics,
    total_energy,
)
from .models.estimation import (  # noqa: E402
    FilterConfig,
    FilterResult,
    ekf,
    rts_smoother,
    simulate_measurements,
)
from .models.magnetics import Magnet  # noqa: E402
from .models.rod import (  # noqa: E402
    RodConfig,
    RodSolution,
    demo_qe,
    quaternion_kinematics,
    rod_shape,
    rod_shape_refined_fused,
    split_strain,
)
from .models.sensing import (  # noqa: E402
    SensingConfig,
    SensingSolution,
    fit_strain,
    identify_tip_load,
    measure,
    measurement_size,
    posterior_covariance,
)
from .models.segment_statics import (  # noqa: E402
    SegmentedStaticsConfig,
    SegmentedStaticsSolution,
    segmented_equilibrium_residual,
    segmented_tendon_lengths,
    solve_segmented_statics,
    solve_segmented_statics_batched,
)
from .models.segments import (  # noqa: E402
    SegmentedRodConfig,
    SegmentedSolution,
    project_global_strain,
    segmented_rod_shape,
    uniform_segments,
)
from .models.tendon import (  # noqa: E402
    Tendon,
    TendonIKSolution,
    tendon_generalized_force,
    tendon_ik,
    tendon_lengths,
    tip_sensitivity,
)

__version__ = "0.1.0"

__all__ = [
    "RodConfig",
    "RodSolution",
    "rod_shape",
    "rod_shape_refined_fused",
    "quaternion_kinematics",
    "split_strain",
    "demo_qe",
    "make_grid",
    "SpectralGrid",
    "default_device",
    "StaticsConfig",
    "StaticsSolution",
    "stiffness_profile",
    "equilibrium_residual",
    "equilibrium_residual_dd",
    "solve_statics",
    "solve_statics_batched",
    "solve_statics_differentiable",
    "load_continuation",
    "ContinuationPath",
    "BatchedContinuationPath",
    "arc_length_continuation",
    "arc_length_continuation_batched",
    "StabilityInfo",
    "CriticalPoint",
    "path_stability",
    "detect_critical_points",
    "linearized_buckling_loads",
    "switch_branch",
    "switch_branch_batched",
    "SegmentedRodConfig",
    "SegmentedSolution",
    "uniform_segments",
    "project_global_strain",
    "segmented_rod_shape",
    "SegmentedStaticsConfig",
    "SegmentedStaticsSolution",
    "segmented_equilibrium_residual",
    "segmented_tendon_lengths",
    "solve_segmented_statics",
    "solve_segmented_statics_batched",
    "Tendon",
    "TendonIKSolution",
    "tendon_lengths",
    "tendon_generalized_force",
    "tip_sensitivity",
    "tendon_ik",
    "Magnet",
    "ContactPlane",
    "ContactSphere",
    "ContactCylinder",
    "DynamicsConfig",
    "Trajectory",
    "ContactStaticsSolution",
    "mass_matrix",
    "mass_matrix_fused",
    "kinetic_energy",
    "potential_energy",
    "total_energy",
    "accelerations",
    "simulate",
    "simulate_implicit",
    "damped_newton",
    "solve_contact_statics",
    "SegmentedDynamicsConfig",
    "RodRodContact",
    "scene_energy",
    "scene_accelerations",
    "simulate_scene",
    "natural_frequencies",
    "linearized_spectrum",
    "damped_spectrum",
    "frequency_response",
    "critical_load",
    "floquet_multipliers",
    "parametric_stability_map",
    "TipConstrainedSolution",
    "solve_tip_constrained",
    "PlatformRobot",
    "PlatformSolution",
    "solve_platform",
    "PlatformStability",
    "platform_stability",
    "platform_critical_load",
    "PlatformIKSolution",
    "platform_ik",
    "protocol_from_knots",
    "rollout",
    "tip_positions",
    "tip_target_cost",
    "ControlSolution",
    "optimize_protocol",
    "SensingConfig",
    "SensingSolution",
    "measure",
    "measurement_size",
    "fit_strain",
    "posterior_covariance",
    "identify_tip_load",
    "FilterConfig",
    "FilterResult",
    "ekf",
    "rts_smoother",
    "simulate_measurements",
    "CalibrationParams",
    "init_params",
    "predict_tips",
    "calibration_loss",
    "make_train_step",
    "Tube",
    "CTRConfig",
    "CTRSolution",
    "solve_ctr",
    "solve_ctr_differentiable",
    "ctr_stability",
    "ctr_shape",
    "two_tube_snap_parameter",
    "TelescopingShape",
    "solve_ctr_telescoping",
]
