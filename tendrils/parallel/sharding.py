"""Data-parallel particle sharding over a `jax.sharding.Mesh`.

Layout:
  particles / previous / targets / per-particle constants: sharded on the
  particle axis (`P(None, "dp")`);
  flow / view / color_map / params: replicated.

Collectives: one `psum` of splat partial sums per draw pass. The logic step
is collective-free (particles only read replicated grids). The mesh is a
plain 1-D device list: every card of a host reaches every other at the
same rate, so the mesh follows the algorithm alone.

Multi-host: `make_multihost_mesh` builds a `(hosts, devices)` mesh —
particles shard over BOTH axes flattened (`P(None, ("host", "dp"))`), and
the splat `psum` runs over `("host", "dp")`, which XLA stages as a reduce
within each host first, then the already-reduced partials across hosts (the
device axis is innermost). On a single host the same code path is validated
by reshaping local devices into `(hosts, devices)` — the collective/spec
composition is identical, only the transport differs.
Call `initialize_distributed()` (a guarded `jax.distributed.initialize`)
before any jax use in a true multi-process launch.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import state as state_mod
from ..engine import EngineConfig, draw_sim, step_sim

AXIS = "dp"
HOST_AXIS = "host"


def make_mesh(devices=None, axis=AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def initialize_distributed(**kw):
    """Guarded `jax.distributed.initialize` for multi-host launches: no-op
    when the process is already initialised or single-process with no
    coordinator configured. Safe to call unconditionally at
    program start."""
    import os
    if jax.process_count() > 1:
        return  # already initialised by the launcher
    if "JAX_COORDINATOR_ADDRESS" in os.environ or "coordinator_address" in kw:
        try:
            jax.distributed.initialize(**kw)
        except RuntimeError:
            pass  # already initialised


def make_multihost_mesh(devices=None, hosts=None) -> Mesh:
    """`(hosts, devices)` mesh. With a real multi-process launch, `hosts`
    defaults to `jax.process_count()` and devices enumerate globally
    (host-major, so each host's devices are mesh-contiguous and the inner
    `dp` axis stays within a host). On one host, pass `hosts` explicitly to
    validate the composition on local (virtual) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    hosts = hosts if hosts is not None else max(jax.process_count(), 1)
    if devices.size % hosts:
        raise ValueError(f"{devices.size} devices not divisible by "
                         f"{hosts} hosts")
    return Mesh(devices.reshape(hosts, -1), (HOST_AXIS, AXIS))


def _axes(mesh: Mesh):
    """The particle-sharding axis name(s) of a DP mesh: `"dp"` for the
    single-axis mesh, `("host", "dp")` for the multi-host mesh."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def _sim_specs(axes=AXIS):
    return state_mod.SimState(
        particles=P(None, axes),
        previous=P(None, axes),
        targets=P(None, axes),
        flow=P(),
        view=P(),
        color_map=P(),
        key=P(),
        idx=P(axes),
    )


def shard_sim(sim: state_mod.SimState, mesh: Mesh) -> state_mod.SimState:
    """Place a SimState on the mesh with the standard layout."""
    specs = _sim_specs(axes=_axes(mesh))
    kw = {f.name: jax.device_put(getattr(sim, f.name),
                                 NamedSharding(mesh, getattr(specs, f.name)))
          for f in dataclasses.fields(sim)}
    return dataclasses.replace(sim, **kw)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"),
                   donate_argnums=(0,))
def parallel_frame(sim, params, time, dt, cfg: EngineConfig, view_size,
                   mesh: Mesh):
    """One full step+draw frame, shard_map'd over the particle axis (or
    both axes of a multi-host mesh).

    Grids stay replicated; each shard computes its particles' splat partial
    sums, which are `psum`'d before the blend resolve (see
    `engine.draw_sim(reduce=...)`). Per-particle constants derive from the
    sharded `sim.idx`."""
    axes = _axes(mesh)
    specs = _sim_specs(axes=axes)

    def body(sim, params, time, dt, view_size):
        sim = step_sim(sim, params, time, dt, cfg, view_size)
        return draw_sim(sim, params, time, cfg, view_size,
                        reduce=functools.partial(jax.lax.psum,
                                                 axis_name=axes))

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(specs, P(), P(), P(), P()),
        out_specs=specs,
        check_vma=False)
    return fn(sim, params, time, dt, view_size)


class ParallelTendrils:
    """Multi-device engine facade: same API shape as `engine.Tendrils`, with
    the frame dispatched through `parallel_frame` over a device mesh."""

    def __init__(self, engine, mesh: Mesh | None = None):
        from ..engine import Tendrils
        assert isinstance(engine, Tendrils)
        self.engine = engine
        self.mesh = mesh or make_mesh()
        n_dev = self.mesh.devices.size
        n = engine.config.n
        if n % n_dev:
            raise ValueError(
                f"particle count {n} not divisible by {n_dev} devices")
        engine.sim = shard_sim(engine.sim, self.mesh)

    def frame(self):
        eng = self.engine
        eng.timer.tick()
        if eng.timer.paused:
            return self
        eng.sim = parallel_frame(
            eng.sim, eng.params(),
            jax.numpy.float32(eng.timer.time), jax.numpy.float32(eng.timer.dt),
            eng.config, eng._view_size, self.mesh)
        return self
