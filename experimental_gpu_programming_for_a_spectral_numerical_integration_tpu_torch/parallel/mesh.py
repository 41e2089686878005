"""Multi-device rod batches: data parallelism over the rod axis.

The counterpart of the JAX package's ``parallel/mesh.py``.  Rods are
independent, so every sharded entry point splits its batch into one slab
per device of a :class:`Mesh` (axis ``"rods"``) and runs one layer's batched
solve on each slab, with no collectives: the fused and refined rod kernels
(K1, K3), the statics Newton (K1 + K2 per evaluation), the segmented Newton
(K4 + K2, K5 with the dd residual), the batched Riks walk (K1 + K2, K3 with
the dd residual), RK4 in the fused mass tier (K1 + K2 per stage), and the
plain-torch layers (Newmark, actuated and magnetic statics, the CTR
workspace, the EKF, parallel platforms).

Execution.  Under JAX's ``shard_map`` one dispatch runs every device's
program.  Here each slab runs in a host thread of its own, from a pool the
mesh owns, under ``torch.cuda.device(shard_device)`` (so that
``default_device()`` names the shard's card) and on that device's current
stream: no side streams.  The Newton layers sync the host once per
iterate, so a Python loop over the shards would run them one after
another; in threads, one shard's device work runs while another shard's
host work is issued.  The threads share the interpreter lock, so the host
work itself overlaps little.  Shards that share a card (a device repeated
in the mesh, as the tests' ``[cpu] * 8`` mesh repeats the CPU) queue on its
one stream.  Forward-mode transforms run one at a time in the process
(``ops/device.locked_jvp``): torch keeps their state per process.

Semantics kept from ``shard_map``:

* each shard stops on its own test: a Newton or Newmark iteration tests
  the residual of its local slab, so a sharded solve's iteration counts
  (and, for Newmark, its iterates) can differ from the unsharded call's;
  ``iterations`` comes back per rod, each rod carrying its shard's count;
* a batch that does not divide by the number of shards raises a
  ``ValueError``;
* every entry point takes a plain tensor, which it splits, or a
  :class:`ShardedBatch` already on the mesh; outputs stay on the devices
  that computed them, as :class:`ShardedBatch` fields of the layer's own
  solution type (``ShardedBatch.gather`` joins them).

A shard's exception reaches the caller once every shard has ended.
``Mesh.shard_launches`` holds each shard's kernel launches in the mesh's
last call.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import torch

from ..models import constrained, cosserat, ctr, dynamics, estimation, rod, segment_statics
from ..ops.device import canonical_device
from ..ops.kernels import build
from ..ops.kernels import refined_kernel as rfk
from ..ops.kernels import rod_kernel as rk

__all__ = [
    "Mesh",
    "ShardedBatch",
    "make_mesh",
    "shard_rods",
    "replicate",
    "sharded_rod_shape",
    "sharded_solve_statics",
    "sharded_segmented_statics",
    "sharded_riks_walk",
    "sharded_simulate",
    "sharded_actuated_statics",
    "sharded_magnetic_statics",
    "sharded_platform_statics",
    "sharded_ctr_workspace",
    "sharded_ekf",
]

RODS_AXIS = "rods"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh over the rod-batch axis: ``devices[i]`` holds shard ``i``
    (a device may repeat).  Owns one host thread per shard; ``close()`` (or
    leaving a ``with`` block) stops them."""

    devices: tuple[torch.device, ...]
    axis_name: str = RODS_AXIS
    shard_launches: list = field(default_factory=list, repr=False)
    _pool: ThreadPoolExecutor = field(init=False, repr=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "_pool", ThreadPoolExecutor(
            len(self.devices), thread_name_prefix="rod-shard"))

    @property
    def size(self) -> int:
        return len(self.devices)

    def run(self, fn, *slabs) -> list:
        """``fn(*(s[i] for s in slabs))`` for every shard ``i``, each in its
        own thread on its own device; the results in shard order.  Every
        shard runs to its end before the first failing shard's exception
        reaches the caller."""
        def work(i):
            dev = self.devices[i]
            on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with on_card, build.launch_tally() as tally:
                return fn(*(s[i] for s in slabs)), tally

        futures = [self._pool.submit(work, i) for i in range(self.size)]
        wait(futures)
        results = [f.result() for f in futures]
        self.shard_launches[:] = [tally for _, tally in results]
        return [out for out, _ in results]

    def close(self) -> None:
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass(frozen=True)
class ShardedBatch:
    """A tensor split over a mesh: ``shards[i]`` lives on the mesh's
    ``i``-th device, the slabs cut along ``axis``; ``axis=None``: every
    shard holds the whole tensor (:func:`replicate`)."""

    shards: tuple[torch.Tensor, ...]
    axis: int | None = 0

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.shards[0].shape)
        if self.axis is not None:
            shape[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's)."""
        device = self.shards[0].device if device is None else device
        if self.axis is None:
            return self.shards[0].to(device)
        return torch.cat([s.to(device) for s in self.shards], dim=self.axis)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D device mesh over the rod-batch axis: every visible CUDA device,
    or ``devices`` (which may repeat one); the first ``n_devices`` of
    them.  Raises without CUDA when no ``devices`` are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] (e.g. "
                               "[torch.device('cpu')] * 8) to shard over other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def _split(mesh: Mesh, x, axis: int) -> tuple:
    """``x``'s slabs along ``axis``, one on each of the mesh's devices."""
    if isinstance(x, ShardedBatch):
        if x.axis == axis and x.devices == mesh.devices:
            return x.shards
        x = x.gather()
    x = torch.as_tensor(x)
    if x.shape[axis] % mesh.size:
        raise ValueError(f"a batch of {x.shape[axis]} along axis {axis} does not split "
                         f"evenly over {mesh.size} shards")
    return tuple(s.to(d) for s, d in zip(torch.tensor_split(x, mesh.size, dim=axis),
                                         mesh.devices))


def _replicas(mesh: Mesh, x) -> tuple:
    if isinstance(x, ShardedBatch):
        if x.axis is None and x.devices == mesh.devices:
            return x.shards
        x = x.gather()
    x = torch.as_tensor(x)
    return tuple(x.to(d) for d in mesh.devices)


def shard_rods(mesh: Mesh, arr) -> ShardedBatch:
    """Place a ``(B, ...)`` batch with its leading axis split over the mesh."""
    return ShardedBatch(_split(mesh, arr, 0), 0)


def replicate(mesh: Mesh, arr) -> ShardedBatch:
    """One copy of ``arr`` on each of the mesh's devices."""
    return ShardedBatch(_replicas(mesh, arr), None)


def _map(mesh: Mesh, local, inputs, out_axis: int = 0):
    """``local`` on every shard's slabs of ``inputs`` (``(value, axis)``
    pairs, axis ``None``: replicated); its outputs, a tuple or NamedTuple
    of tensors, come back as one of the same kind whose fields are
    :class:`ShardedBatch` split along ``out_axis`` (``None`` stays
    ``None``)."""
    slabs = [_replicas(mesh, x) if axis is None else _split(mesh, x, axis)
             for x, axis in inputs]
    outs = mesh.run(local, *slabs)
    fields = [None if col[0] is None else ShardedBatch(tuple(col), out_axis)
              for col in zip(*outs)]
    kind = type(outs[0])
    return kind(*fields) if hasattr(kind, "_fields") else tuple(fields)


def _per_rod(iterations, batch: torch.Tensor) -> torch.Tensor:
    """A shard's iteration count given to each of its rods."""
    return torch.as_tensor(iterations, device=batch.device).expand(batch.shape[:1])


def sharded_rod_shape(mesh: Mesh, method: str = "picard", **kwargs):
    """Batched rod solve with the batch sharded over the mesh: returns a
    function ``qes (B, na*ne) -> (quaternions, positions)``, each a
    :class:`ShardedBatch` ``(B, n-1, dim)``.

    ``method='fused'`` launches K1 (``rod_kernel.rod_shape_fused``) once per
    shard; ``method='refined'`` launches K3
    (``refined_kernel.rod_shape_refined_kernel``) once per shard and returns
    the pair sums ``hi + lo``; other methods run ``rod.rod_shape``.
    ``kwargs`` go to the callee."""
    if method == "fused":
        def local(qes):
            return rk.rod_shape_fused(qes, **kwargs)
    elif method == "refined":
        def local(qes):
            q_hi, q_lo, r_hi, r_lo = rfk.rod_shape_refined_kernel(qes, **kwargs)
            return q_hi + q_lo, r_hi + r_lo
    else:
        def local(qes):
            sol = rod.rod_shape(qes, method=method, **kwargs)
            return sol.quaternions, sol.positions

    return lambda qes: _map(mesh, local, [(qes, 0)])


def sharded_solve_statics(mesh: Mesh, cfg=None, **kwargs):
    """Batched statics per shard: ``loads (B, 3) ->`` :class:`~.cosserat.StaticsSolution`.

    Each shard runs the fused-path Newton (``solve_statics_batched``) on its
    slab and stops on its own residual; ``iterations`` per rod is its
    shard's count.  As in the JAX package, the solution carries no
    ``qe_lo``."""
    cfg = cosserat.StaticsConfig() if cfg is None else cfg

    def local(loads):
        sol = cosserat.solve_statics_batched(loads, cfg=cfg, **kwargs)
        return sol._replace(iterations=_per_rod(sol.iterations, loads), qe_lo=None)

    return lambda loads: _map(mesh, local, [(loads, 0)])


def _contact_statics(mesh: Mesh, cfg, nq: int, command: str, kwargs: dict):
    def local(u):
        qe0 = torch.zeros(u.shape[:-1] + (nq,), dtype=u.dtype, device=u.device)
        sol = dynamics.solve_contact_statics(cfg, qe0=qe0, **{command: u}, **kwargs)
        return sol._replace(iterations=_per_rod(sol.iterations, u))

    return lambda u: _map(mesh, local, [(u, 0)])


def sharded_actuated_statics(mesh: Mesh, cfg, **kwargs):
    """Tendon-actuated equilibria per shard: ``tension (B, K) ->``
    :class:`~.dynamics.ContactStaticsSolution` (``cfg.tendons`` required),
    each shard's slab Newton-solved from ``qe0 = 0``."""
    if not cfg.tendons:
        raise ValueError("sharded_actuated_statics needs cfg.tendons")
    return _contact_statics(mesh, cfg, cfg.rod.na * cfg.rod.ne, "tension", kwargs)


def sharded_magnetic_statics(mesh: Mesh, cfg, **kwargs):
    """Magnetically actuated equilibria per shard: uniform applied fields
    ``b (B, 3) ->`` :class:`~.dynamics.ContactStaticsSolution`
    (``cfg.magnets`` required), each shard's slab Newton-solved from
    ``qe0 = 0``."""
    if not cfg.magnets:
        raise ValueError("sharded_magnetic_statics needs cfg.magnets")
    return _contact_statics(mesh, cfg, cfg.nq, "b_field", kwargs)


def sharded_ctr_workspace(mesh: Mesh, cfg, **kwargs):
    """Concentric-tube workspace per shard: ``alphas (B, T) -> (theta (B,
    T, n), tips (B, 3), iterations (B,), residual_norm (B,))``, each a
    :class:`ShardedBatch`: ``solve_ctr`` on each slab, then ``ctr_shape``
    (``method`` and ``iters`` in ``kwargs`` go to it, the rest to
    ``solve_ctr``)."""
    shape_kwargs = {k: kwargs.pop(k) for k in ("method", "iters") if k in kwargs}

    def local(alphas):
        sol = ctr.solve_ctr(alphas, cfg, **kwargs)
        shp = ctr.ctr_shape(sol.theta, cfg, **shape_kwargs)
        return (sol.theta, shp.positions[..., 0, :], _per_rod(sol.iterations, alphas),
                torch.linalg.vector_norm(sol.residual, dim=-1))

    return lambda alphas: _map(mesh, local, [(alphas, 0)])


def sharded_ekf(mesh: Mesh, cfg, **kwargs):
    """A fleet of independent EKFs per shard: ``(ys (steps, B, m), x0 (B,
    2nq), p0 (2nq, 2nq) replicated) -> (xs (steps, B, 2nq), covs, nis)``,
    split on axis 1."""
    def local(ys, x0, p0):
        res = estimation.ekf(ys, cfg, x0, p0, **kwargs)
        return res.xs, res.covs, res.nis

    return lambda ys, x0, p0: _map(mesh, local, [(ys, 1), (x0, 0), (p0, None)], out_axis=1)


def sharded_segmented_statics(mesh: Mesh, cfg=None, **kwargs):
    """Batched multi-segment statics per shard: ``loads (B, 3) ->``
    :class:`~.segment_statics.SegmentedStaticsSolution` with ``qe (B, S,
    nq)``; the segments chain within a shard.  With ``dd_residual=True``
    the ``qe_lo`` words come back sharded too."""
    cfg = segment_statics.SegmentedStaticsConfig() if cfg is None else cfg

    def local(loads):
        sol = segment_statics.solve_segmented_statics_batched(loads, cfg=cfg, **kwargs)
        return sol._replace(iterations=_per_rod(sol.iterations, loads))

    return lambda loads: _map(mesh, local, [(loads, 0)])


def sharded_riks_walk(mesh: Mesh, cfg=None, dd_residual: bool = False,
                      monitor_stability: bool = False, **kwargs):
    """Batched Riks continuation per shard: ``load_refs (B, 3) ->``
    :class:`~.cosserat.BatchedContinuationPath` with the sample axis (axis 1
    of every ``(steps, B, ...)`` field) sharded, the determinant monitors
    with ``monitor_stability`` and the low words with ``dd_residual``."""
    cfg = cosserat.StaticsConfig() if cfg is None else cfg

    def local(load_refs):
        return cosserat.arc_length_continuation_batched(
            load_refs, cfg=cfg, dd_residual=dd_residual,
            monitor_stability=monitor_stability, **kwargs)

    return lambda load_refs: _map(mesh, local, [(load_refs, 0)], out_axis=1)


def sharded_simulate(mesh: Mesh, cfg=None, implicit: bool = False, **kwargs):
    """Rod dynamics per shard: ``(qe0, qd0) (B, nq) ->``
    :class:`~.dynamics.Trajectory` with ``qes``/``qds``/``energies`` sharded
    on axis 1 and ``times`` (one tensor) from the first shard.  RK4
    (``dynamics.simulate``) or, with ``implicit=True``, Newmark
    (``simulate_implicit``), whose Newton stops on each shard's own norm;
    ``kwargs`` go to the integrator.  Callables of ``t`` run per shard, so a
    per-sample drive must index only the local slab."""
    cfg = dynamics.DynamicsConfig() if cfg is None else cfg
    integrate = dynamics.simulate_implicit if implicit else dynamics.simulate

    def run(qe0, qd0):
        traj = _map(mesh, lambda q, v: integrate(q, v, cfg, **kwargs), [(qe0, 0), (qd0, 0)],
                    out_axis=1)
        return traj._replace(times=traj.times.shards[0])

    return run


def sharded_platform_statics(mesh: Mesh, robot, **kwargs):
    """Parallel-continuum-robot equilibria per shard: platform wrenches
    ``(B, 6)`` (world force, then moment) ->
    :class:`~.constrained.PlatformSolution`."""
    def local(wrench):
        sol = constrained.solve_platform(robot, platform_force=wrench[..., :3],
                                         platform_moment=wrench[..., 3:], **kwargs)
        return sol._replace(iterations=_per_rod(sol.iterations, wrench))

    return lambda wrench: _map(mesh, local, [(wrench, 0)])
