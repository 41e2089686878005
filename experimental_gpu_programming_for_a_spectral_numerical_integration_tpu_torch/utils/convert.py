"""Carry the JAX package's state into the port, without importing jax.

The system has no learned weights: its state is the rod and statics
configurations and the f64 spectral constants.  These functions take plain
attributes and NumPy arrays, so the JAX objects can be handed over as they
are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import dynamics, magnetics, tendon
from ..models.bifurcation import CriticalPoint
from ..models.calibration import CalibrationParams
from ..models.constrained import PlatformRobot
from ..models.cosserat import ContinuationPath, StaticsConfig
from ..models.ctr import CTRConfig, Tube
from ..models.estimation import FilterConfig
from ..models.rod import RodConfig
from ..models.sensing import SensingConfig
from ..models.segment_statics import SegmentedStaticsConfig
from ..models.segments import SegmentedRodConfig
from ..ops.collocation import SpectralGrid
from ..ops.device import canonical_device

__all__ = ["rod_config_from_jax", "statics_config_from_jax", "segmented_rod_config_from_jax",
           "segmented_statics_config_from_jax", "tendon_from_jax", "magnet_from_jax",
           "dynamics_config_from_jax", "rod_rod_contact_from_jax", "grid_from_numpy",
           "continuation_path_from_jax", "critical_point_from_jax", "sensing_config_from_jax",
           "filter_config_from_jax", "platform_robot_from_jax", "calibration_params_from_jax",
           "ctr_config_from_jax"]


def rod_config_from_jax(cfg) -> RodConfig:
    """The port's :class:`RodConfig` from any object with the JAX
    ``RodConfig``'s fields ``n``, ``na``, ``ne``, ``length`` and ``basis``."""
    return RodConfig(n=int(cfg.n), na=int(cfg.na), ne=int(cfg.ne),
                     length=float(cfg.length), basis=str(cfg.basis))


def _floats(v):
    """Nested tuples of floats (a stiffness profile stays ``(n, na)``)."""
    if v is None:
        return None
    return tuple(float(x) if np.ndim(x) == 0 else _floats(x) for x in v)


def statics_config_from_jax(cfg) -> StaticsConfig:
    """The port's :class:`StaticsConfig` from any object with the JAX
    ``StaticsConfig``'s fields ``rod``, ``stiffness``, ``kappa0``,
    ``distributed_force`` and ``follower``."""
    return StaticsConfig(rod=rod_config_from_jax(cfg.rod), stiffness=_floats(cfg.stiffness),
                         kappa0=_floats(cfg.kappa0),
                         distributed_force=_floats(cfg.distributed_force),
                         follower=bool(cfg.follower))


def segmented_rod_config_from_jax(cfg) -> SegmentedRodConfig:
    """The port's :class:`SegmentedRodConfig` from any object with the JAX
    ``SegmentedRodConfig``'s field ``segments`` (rod configurations)."""
    return SegmentedRodConfig(segments=tuple(rod_config_from_jax(s) for s in cfg.segments))


def tendon_from_jax(t) -> tendon.Tendon:
    """The port's :class:`~..models.tendon.Tendon` from any object with the
    JAX ``Tendon``'s fields (``fn`` and ``profile`` are host callables,
    carried as they are)."""
    return tendon.Tendon(offset=_floats(t.offset), helix=_floats(t.helix), fn=t.fn,
                         profile=t.profile, capstan=float(t.capstan))


def magnet_from_jax(m) -> magnetics.Magnet:
    """The port's :class:`~..models.magnetics.Magnet` from any object with
    the JAX ``Magnet``'s fields ``moment`` and ``fn``."""
    return magnetics.Magnet(moment=_floats(m.moment), fn=m.fn)


def segmented_statics_config_from_jax(cfg) -> SegmentedStaticsConfig:
    """The port's :class:`SegmentedStaticsConfig` from any object with the
    JAX ``SegmentedStaticsConfig``'s fields ``rods``, ``stiffness``,
    ``kappa0``, ``follower``, ``tendons`` and ``tendon_end``."""
    return SegmentedStaticsConfig(
        rods=segmented_rod_config_from_jax(cfg.rods), stiffness=_floats(cfg.stiffness),
        kappa0=_floats(cfg.kappa0), follower=bool(cfg.follower),
        tendons=tuple(tendon_from_jax(t) for t in cfg.tendons),
        tendon_end=None if cfg.tendon_end is None else tuple(int(e) for e in cfg.tendon_end))


def _obstacle_from_jax(ob):
    """The port's obstacle of the same class name and fields."""
    cls = getattr(dynamics, type(ob).__name__)
    return cls(**{f.name: (_floats(getattr(ob, f.name)) if isinstance(getattr(ob, f.name), tuple)
                           else getattr(ob, f.name))
                  for f in dataclasses.fields(cls)})


def dynamics_config_from_jax(cfg) -> dynamics.DynamicsConfig:
    """The port's :class:`~..models.dynamics.DynamicsConfig` from any object
    with the JAX ``DynamicsConfig``'s fields: the statics configuration,
    ``rho_a``, ``rho_i``, ``damping``, ``kv_damping``, ``gravity``, the
    obstacles (``contact``), ``tendons``, ``magnets`` and ``fluid_drag``.  A
    JAX ``SegmentedDynamicsConfig`` becomes the port's, its segmented
    statics configuration carried by :func:`segmented_statics_config_from_jax`."""
    segmented = type(cfg).__name__ == "SegmentedDynamicsConfig"
    contact = cfg.contact
    if contact is not None:
        contact = (tuple(_obstacle_from_jax(ob) for ob in contact) if isinstance(contact, tuple)
                   else _obstacle_from_jax(contact))
    cls = dynamics.SegmentedDynamicsConfig if segmented else dynamics.DynamicsConfig
    statics = (segmented_statics_config_from_jax if segmented else statics_config_from_jax)(
        cfg.statics)
    return cls(
        statics=statics, rho_a=float(cfg.rho_a),
        rho_i=float(cfg.rho_i), damping=float(cfg.damping), kv_damping=float(cfg.kv_damping),
        gravity=_floats(cfg.gravity), contact=contact,
        tendons=tuple(tendon_from_jax(t) for t in cfg.tendons),
        magnets=tuple(magnet_from_jax(m) for m in cfg.magnets),
        fluid_drag=_floats(cfg.fluid_drag))


def rod_rod_contact_from_jax(rr) -> dynamics.RodRodContact:
    """The port's :class:`~..models.dynamics.RodRodContact` from any object
    with the JAX ``RodRodContact``'s fields."""
    return dynamics.RodRodContact(
        radius=float(rr.radius), stiffness=float(rr.stiffness), smoothing=float(rr.smoothing),
        self_window=None if rr.self_window is None else float(rr.self_window),
        friction=float(rr.friction), friction_vel=float(rr.friction_vel),
        budget=None if rr.budget is None else int(rr.budget))


def grid_from_numpy(points, dn, dn_nn, dn_in, ginv, device=None) -> SpectralGrid:
    """A :class:`SpectralGrid` on ``device`` (default: the card) from the JAX
    ``SpectralGrid``'s f64 arrays (``dn_in`` may be ``(n-1,)`` or
    ``(n-1, 1)``)."""
    device = canonical_device(device)

    def dev(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=torch.float64,
                            device=device)

    points = dev(points)
    return SpectralGrid(n=int(points.shape[0]), length=float(points[0]),
                        points=points, dn=dev(dn), dn_nn=dev(dn_nn),
                        dn_in=dev(dn_in).reshape(-1), ginv=dev(ginv))


def continuation_path_from_jax(path, device=None) -> ContinuationPath:
    """The port's :class:`ContinuationPath` on ``device`` (default: the card)
    from any object with the JAX ``ContinuationPath``'s arrays ``lambdas``,
    ``qes`` and ``converged`` (f64 stays f64)."""
    device = canonical_device(device)
    return ContinuationPath(lambdas=torch.tensor(np.asarray(path.lambdas), device=device),
                            qes=torch.tensor(np.asarray(path.qes), device=device),
                            converged=torch.tensor(np.asarray(path.converged, bool),
                                                   device=device))


def critical_point_from_jax(point, device=None) -> CriticalPoint:
    """The port's :class:`CriticalPoint` on ``device`` (default: the card)
    from any object with the JAX ``CriticalPoint``'s fields (``qe`` and
    ``null_vector`` as f64 tensors)."""
    device = canonical_device(device)

    def f64(a):
        return torch.tensor(np.asarray(a, np.float64), device=device)

    return CriticalPoint(segment=int(point.segment), kind=str(point.kind), lam=float(point.lam),
                         qe=f64(point.qe), null_vector=f64(point.null_vector),
                         coupling=float(point.coupling))


def sensing_config_from_jax(cfg) -> SensingConfig:
    """The port's :class:`SensingConfig` from any object with the JAX
    ``SensingConfig``'s fields (the sensor fractions, weights, ``reg``,
    ``iters`` and ``method``)."""
    return SensingConfig(
        rod=rod_config_from_jax(cfg.rod), marker_fracs=_floats(cfg.marker_fracs),
        strain_fracs=_floats(cfg.strain_fracs), pose_fracs=_floats(cfg.pose_fracs),
        use_tip_quaternion=bool(cfg.use_tip_quaternion),
        marker_weight=float(cfg.marker_weight), strain_weight=float(cfg.strain_weight),
        quat_weight=float(cfg.quat_weight), reg=float(cfg.reg), iters=int(cfg.iters),
        method=str(cfg.method))


def filter_config_from_jax(cfg) -> FilterConfig:
    """The port's :class:`FilterConfig` from any object with the JAX
    ``FilterConfig``'s fields ``dynamics``, ``sensing``, ``dt``,
    ``q_accel``, ``r_sigma`` and ``iters``."""
    return FilterConfig(dynamics=dynamics_config_from_jax(cfg.dynamics),
                        sensing=sensing_config_from_jax(cfg.sensing), dt=float(cfg.dt),
                        q_accel=float(cfg.q_accel), r_sigma=float(cfg.r_sigma),
                        iters=int(cfg.iters))


def platform_robot_from_jax(robot) -> PlatformRobot:
    """The port's :class:`PlatformRobot` from any object with the JAX
    ``PlatformRobot``'s fields (the leg configuration, base poses, grips,
    ``gravity`` and ``platform_mass``)."""
    return PlatformRobot(
        cfg=dynamics_config_from_jax(robot.cfg), base_positions=_floats(robot.base_positions),
        base_quaternions=_floats(robot.base_quaternions),
        attach_points=_floats(robot.attach_points),
        attach_quaternions=_floats(robot.attach_quaternions), gravity=_floats(robot.gravity),
        platform_mass=float(robot.platform_mass))


def calibration_params_from_jax(params, device=None) -> CalibrationParams:
    """The port's :class:`CalibrationParams` on ``device`` (default: the
    card) from the JAX ``CalibrationParams``' arrays ``w`` and ``b``, in
    their own dtype."""
    device = canonical_device(device)
    return CalibrationParams(w=torch.tensor(np.asarray(params.w), device=device),
                             b=torch.tensor(np.asarray(params.b), device=device))


def ctr_config_from_jax(cfg) -> CTRConfig:
    """The port's :class:`~..models.ctr.CTRConfig` from any object with the
    JAX ``CTRConfig``'s fields ``tubes`` (each with ``curvature``,
    ``bending_stiffness`` and ``torsional_stiffness``), ``n`` and ``length``."""
    return CTRConfig(tubes=tuple(Tube(curvature=float(t.curvature),
                                      bending_stiffness=float(t.bending_stiffness),
                                      torsional_stiffness=float(t.torsional_stiffness))
                                 for t in cfg.tubes),
                     n=int(cfg.n), length=float(cfg.length))
