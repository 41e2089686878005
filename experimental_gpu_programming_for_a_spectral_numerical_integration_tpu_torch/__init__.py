"""PyTorch + CUDA port of the spectral rod-integration framework.

The JAX package ``experimental_gpu_programming_for_a_spectral_numerical_integration_tpu``
beside this one is the reference.  This package ports its main path, the
batched rod-shape solve ``qe (B, na*ne) -> (Q (B, n-1, 4), r (B, n-1, 3))``
on grids up to n-1 = 512, the batched statics Newton built on it, and the
multi-segment rod chains and their statics Newton, with hand-written CUDA
kernels for NVIDIA Hopper (``csrc/``) in place of the Pallas TPU kernels.  It runs on the card unless the caller passes CPU
tensors or ``device='cpu'`` (``ops/device.py``).  It imports torch and
numpy, never jax.

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
from .models.cosserat import (  # noqa: E402
    StaticsConfig,
    StaticsSolution,
    equilibrium_residual,
    solve_statics,
    solve_statics_batched,
)
from .models.rod import (  # noqa: E402
    RodConfig,
    RodSolution,
    demo_qe,
    quaternion_kinematics,
    rod_shape,
    rod_shape_refined_fused,
    split_strain,
)

from .models.segment_statics import (  # noqa: E402
    SegmentedStaticsConfig,
    SegmentedStaticsSolution,
    segmented_equilibrium_residual,
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
    "equilibrium_residual",
    "solve_statics",
    "solve_statics_batched",
    "SegmentedRodConfig",
    "SegmentedSolution",
    "uniform_segments",
    "project_global_strain",
    "segmented_rod_shape",
    "SegmentedStaticsConfig",
    "SegmentedStaticsSolution",
    "segmented_equilibrium_residual",
    "solve_segmented_statics",
    "solve_segmented_statics_batched",
]
