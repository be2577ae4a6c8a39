"""Spatially partitioned grids: row slabs + reduce-scatter (SURVEY §2.9).

The default data-parallel layout (`parallel.sharding`) replicates the flow
and view grids on every device and `psum`s full-grid splat partials — fine
at 1080p, but at 4K+ each device then holds every grid and the all-reduce
moves `2·(D-1)/D · C·H·W·4` bytes per frame. This module keeps particles
data-parallel but shards the GRIDS by row slabs:

  - each shard still accumulates its own particles' full-grid splat
    partials (deposits are unconstrained — a particle may land anywhere),
  - the partials are `psum_scatter`'d over rows, so each device reduces,
    RESOLVES and STORES only its `H/D`-row slab (collective: one
    reduce-scatter = half an all-reduce's bytes),
  - the next step's flow read `all_gather`s only the 3 channels the logic
    samples (velocity and stamp; not the weight channel).

Bytes each device moves per frame, counted from the compiled program's
collectives with the ring model (`tests/test_parallel.py`): the 12 splat
channels (2 passes × (4 + wsum + logt)) all-reduced cost `2·(D-1)/D · 12`
grid planes; the slab frame's reduce-scatter plus 3-channel all-gather cost
`(D-1)/D · (12 + 3)`, which is 0.625 of it at any D. Grids held per device
drop to 1/D and the blend resolve runs on 1/D of the pixels. The reference
has no multi-device analogue (SURVEY §2.9).

The frame computes exactly what the single-device frame computes: the step
reads the same flow texels and the draw resolves the same sums, only
partitioned.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import state as state_mod
from ..engine import EngineConfig, draw_sim, step_sim
from .sharding import AXIS, make_mesh  # noqa: F401  (re-export make_mesh)


def _sim_specs():
    return state_mod.SimState(
        particles=P(None, AXIS),
        previous=P(None, AXIS),
        targets=P(None, AXIS),
        flow=P(None, AXIS, None),   # row slabs
        view=P(None, None, AXIS, None),
        color_map=P(),
        key=P(),
        idx=P(AXIS),
    )


def shard_sim_spatial(sim: state_mod.SimState, mesh: Mesh):
    """Place a SimState with row-slab grids on the mesh."""
    specs = _sim_specs()
    kw = {f.name: jax.device_put(getattr(sim, f.name),
                                 NamedSharding(mesh, getattr(specs, f.name)))
          for f in dataclasses.fields(sim)}
    return dataclasses.replace(sim, **kw)


def _scatter_rows(parts):
    """Reduce `(num, wsum, logt)` splat partials over the mesh, keeping
    this device's row slab of each."""
    num, wsum, logt = parts
    return (jax.lax.psum_scatter(num, AXIS, scatter_dimension=1, tiled=True),
            jax.lax.psum_scatter(wsum, AXIS, scatter_dimension=0,
                                 tiled=True),
            jax.lax.psum_scatter(logt, AXIS, scatter_dimension=0,
                                 tiled=True))


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"),
                   donate_argnums=(0,))
def spatial_frame(sim, params, time, dt, cfg: EngineConfig, view_size,
                  mesh: Mesh):
    """One step+draw frame with row-slab grids (see module docstring).

    Constraints: `flow_res == view_res`, H divisible by the mesh size,
    one view buffer, one flow LOD (the slab all-gather covers level 0)."""
    n_dev = mesh.devices.size
    h, _ = cfg.view_res
    if cfg.flow_shape != cfg.view_res:
        raise ValueError("slab mode shares one grid shape for flow and view")
    if h % n_dev:
        raise ValueError(f"H={h} not divisible by {n_dev} devices")
    if cfg.num_view_buffers != 1 or cfg.flow_levels != 1:
        raise ValueError("slab mode supports one view buffer and one flow "
                         "LOD")
    specs = _sim_specs()

    def body(sim, params, time, dt, view_size):
        # Step (ref src/index.js:248-272) against the whole flow grid's
        # sampled channels; the slab itself is kept for the draw.
        flow_read = jax.lax.all_gather(sim.flow[:3], AXIS, axis=1,
                                       tiled=True)
        stepped = step_sim(dataclasses.replace(sim, flow=flow_read), params,
                           time, dt, cfg, view_size)
        sim = dataclasses.replace(stepped, flow=sim.flow)
        # Draw (ref src/index.js:278-340), slab-resolved.
        return draw_sim(sim, params, time, cfg, view_size,
                        reduce=_scatter_rows)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(specs, P(), P(), P(), P()),
        out_specs=specs,
        check_vma=False)
    return fn(sim, params, time, dt, view_size)


class SpatialTendrils:
    """Multi-device facade with row-slab grids (`spatial_frame`)."""

    def __init__(self, engine, mesh: Mesh | None = None):
        self.engine = engine
        self.mesh = mesh or make_mesh()
        n_dev = self.mesh.devices.size
        h, _ = engine.config.view_res
        if engine.config.n % n_dev or h % n_dev:
            raise ValueError("particles and grid rows must divide the mesh")
        engine.sim = shard_sim_spatial(engine.sim, self.mesh)

    def frame(self):
        eng = self.engine
        eng.timer.tick()
        if eng.timer.paused:
            return self
        eng.sim = spatial_frame(
            eng.sim, eng.params(), jnp.float32(eng.timer.time),
            jnp.float32(eng.timer.dt), eng.config, eng._view_size,
            self.mesh)
        return self
