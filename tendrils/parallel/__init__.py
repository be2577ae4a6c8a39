"""Multi-device scale-out (SURVEY §2.9).

The reference has no distributed execution — its only parallelism is the
WebGL rasteriser's implicit SIMD over fragments. The scaling axis here is
particle count × grid resolution:

  - particles are pure data-parallel (the logic step has no cross-particle
    dependency — each one only reads replicated grids), sharded over a 1-D
    device mesh with zero collectives in the map phase;
  - the flow/view grids are replicated, and each shard's splat partial sums
    are reduced with one `psum` per pass — the counterpart of the
    rasteriser's blending acting as scatter-reduce;
  - at high resolution the grids shard by ROW SLABS instead
    (`parallel.spatial`): splat partials are `psum_scatter`'d so each
    device resolves and stores only its slab, and the step's flow read
    all-gathers the 3 channels it samples — fewer collective bytes and 1/D
    of the grid memory of replicate+psum.

Multi-host mapping: the mesh extends to `(hosts, devices)` via
`make_multihost_mesh` (+ `initialize_distributed`, a guarded
`jax.distributed.initialize`). Particles shard over the flattened
`("host", "dp")` axes (collective-free map phase); the splat `psum` runs
over both axes, which XLA stages as a reduce within each host first, then
across hosts. The composition (specs + collectives) is exactly what a
single-axis mesh runs, validated on local devices reshaped `(2, 4)` in
`tests/test_parallel.py` and `__graft_entry__.dryrun_multichip`.
"""

from .sharding import (initialize_distributed, make_mesh,
                       make_multihost_mesh, parallel_frame, shard_sim)
from .spatial import shard_sim_spatial, spatial_frame

__all__ = ["initialize_distributed", "make_mesh", "make_multihost_mesh",
           "parallel_frame", "shard_sim", "shard_sim_spatial",
           "spatial_frame"]
