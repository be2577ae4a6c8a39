"""tendrils — a JAX particle flow-field framework.

A from-scratch JAX rebuild of the capabilities of the WebGL GPGPU
particle system `keeffEoghan/tendrils` (the "Trust" interactive music video):
self-advecting particles that rasterise their velocities into a flow field
they are in turn advected by, plus spawn systems, optical flow, audio
reactivity, a keyframe animation engine, post-processing and a preset library.

Architecture (not a port — see SURVEY.md §7):
  - state as arrays (`f32[4, N]` particles, `f32[4, H, W]` grids), not
    textures;
  - the frame as a pure jitted function with every live parameter traced;
  - GL line rasterisation replaced by an explicit segment scatter-add with an
    order-independent alpha-blend resolve;
  - scale-out via `jax.sharding` data-parallel particles + psum'd flow grids.
"""

from .const import INERT, PI, TAU
from .engine import EngineConfig, Tendrils, default_params
from .state import SimState, default_state, make_state
from .timer import Timer

__all__ = [
    "EngineConfig", "INERT", "PI", "SimState", "TAU", "Tendrils", "Timer",
    "default_params", "default_state", "make_state",
]

__version__ = "0.1.0"
