"""Flow-field payload, decay-on-read and multi-level sampling.

The flow field is the heart of the system: every step, particles rasterise
their velocity into it, and the next step samples it back as a force — the
self-advection feedback loop (reference `src/index.js:296-303` writes,
`src/logic.frag:71-75` reads).

Payload format (one flow texel, `f32[4]`) — exactly
`src/flow/apply/state.glsl:5-17`:
    (vel.x, vel.y, stamp=time, weight=min(|vel| / speedLimit, 1))

Decay-on-read — `src/flow/get.glsl:3-5`:
    vel_effective = vel * max(0, 1 - (time - stamp) * decay)

Multi-level sampling — `src/flow/flow-at-screen-pos.glsl:13-27`: samples
`levels` LODs with weight 1/(level+1) and normalises. The reference compiles
with `levels = 1.0, stride = 1.0` (`src/logic.frag:39`) and its mipmap
generation is disabled (`src/index.js:305-312`), so level 0 is the only live
level; we keep the level loop for parity (grids per level are provided by the
caller — the engine keeps a flow pyramid only when `flow_levels > 1`).
"""

import jax.numpy as jnp

from . import coords, sample


def flow_payload(vel, time, speed_limit):
    """Build flow payload channels from velocities.

    `vel: f32[2, N]` -> `f32[4, N]` of (vx, vy, stamp, weight).
    Ref `src/flow/apply/state.glsl:5-17`.
    """
    speed = jnp.sqrt(vel[0] * vel[0] + vel[1] * vel[1])
    weight = jnp.minimum(speed / speed_limit, 1.0)
    stamp = jnp.full_like(weight, time)
    return jnp.stack([vel[0], vel[1], stamp, weight])


def flow_decayed(data, time, decay):
    """Apply decay-on-read to sampled payload.

    `data: f32[4, ...]` -> effective velocity `f32[2, ...]`.
    Ref `src/flow/get.glsl:3-5`.
    """
    age = jnp.maximum(0.0, 1.0 - (time - data[2]) * decay)
    return data[:2] * age


def flow_at_screen_pos(pos_screen, flows, time, flow_decay, sample_fn=None):
    """Flow force at screen positions — ref `src/flow/flow-at-screen-pos.glsl`.

    `pos_screen: f32[N, 2]` in clip space (already `pos * viewSize`);
    `flows`: list of flow grids `f32[4, H, W]`, one per LOD level (stride
    handled by the caller supplying the right pyramid levels).
    `sample_fn(grid, uv) -> f32[4, N]` is the gather (defaults to the XLA
    bilinear gather, `sample.sample_uv`). Returns `f32[2, N]`.
    """
    if sample_fn is None:
        sample_fn = sample.sample_uv
    uv = coords.pos_to_uv(pos_screen)
    force = 0.0
    total = 0.0
    for level, grid in enumerate(flows):
        data = sample_fn(grid, uv)
        factor = 1.0 / (level + 1.0)
        force = force + flow_decayed(data, time, flow_decay) * factor
        total = total + factor
    return force / total
