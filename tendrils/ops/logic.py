"""The particle logic step — the sim's core kernel.

A faithful JAX re-derivation of `src/logic.frag:45-101`: per particle,
  1. simplex-noise wander force at `(pos * noiseScale, uv + time * noiseSpeed)`
  2. flow-field force sampled at the particle's screen position, decayed by age
  3. weighted accumulation with damping: `vel*damping*dt + forceWeight*(...)`
  4. target-seek force `(target - pos) * target`
  5. speed clamp to `speedLimit`, Euler integrate `pos += vel`
with per-particle variance `vary(base, i, variance) = base + i*variance*base`
(`src/logic.frag:41-43`) and the inert-sentinel mask (`src/logic.frag:55`).

In the reference this runs as one fragment shader over the state texture
(`src/particles.js:123-145`); here it is one fused XLA kernel over `f32[4, N]`
— all elementwise math plus one bilinear flow gather. Everything is
`jit`-traced with params as arguments, so no value change recompiles.
"""

import jax.numpy as jnp

from ..const import INERT
from . import flow as flow_ops
from .noise import snoise3_xyz


def vary(base, offset, variance):
    """Per-particle parameter variance — ref `src/logic.frag:41-43`."""
    return base + (offset * variance * base)


def wander_force(pos, uv, index01, params, time):
    """Simplex wander force — ref `src/logic.frag:60-68`. Returns `f32[2, N]`."""
    noise_scale = vary(params["noiseScale"], index01, params["varyNoiseScale"])
    noise_speed = vary(params["noiseSpeed"], index01, params["varyNoiseSpeed"])
    noise_pos = pos * noise_scale  # [2, N]
    noise_time = time * noise_speed

    # noise(vec3(noisePos, uv.x + noiseTime)), and the same with
    # uv.y + noiseTime + 1234.5678 for the second component. Component-wise
    # so every intermediate is a flat [N] vector.
    za = uv[0] + noise_time
    zb = uv[1] + noise_time + 1234.5678
    return jnp.stack([snoise3_xyz(noise_pos[0], noise_pos[1], za),
                      snoise3_xyz(noise_pos[0], noise_pos[1], zb)])


def step_particles(particles, flows, targets, params, uv, index01, view_size,
                   time, dt, sample_fn=None, flow_force_fn=None):
    """One logic step: `f32[4, N]` -> `f32[4, N]`. Ref `src/logic.frag:45-101`.

    `flows`: list of flow grids `f32[4, H, W]` (LOD pyramid; usually one).
    `targets`: `f32[4, N]` (only xy read — ref `src/logic.frag:85`).
    `view_size`: `f32[2]` cover-aspect scale (ref `src/index.js:398`).
    `sample_fn`: flow gather backend (see `flow.flow_at_screen_pos`);
    `flow_force_fn(pos_screen [N,2]) -> f32[2, N]` overrides the whole flow
    -force evaluation (the engine's `flow_off` path returns zero).
    """
    pos = particles[:2]
    vel = particles[2:]

    alive = (pos[0] != INERT) | (pos[1] != INERT)

    wander = wander_force(pos, uv, index01, params, time)

    # Flow force — sampled at pos*viewSize, from *last* frame's flow (the
    # caller guarantees ordering: step before the new flow is splatted,
    # ref `src/index.js:296-298`).
    pos_screen = jnp.stack([pos[0] * view_size[0], pos[1] * view_size[1]],
                           axis=-1)
    if flow_force_fn is not None:
        flow_force = flow_force_fn(pos_screen)
    else:
        flow_force = flow_ops.flow_at_screen_pos(
            pos_screen, flows, time, params["flowDecay"], sample_fn)

    force_w = vary(params["forceWeight"], index01, params["varyForce"])
    flow_w = vary(params["flowWeight"], index01, params["varyFlow"])
    noise_w = vary(params["noiseWeight"], index01, params["varyNoise"])

    new_vel = (vel * params["damping"] * dt
               + force_w * (flow_force * dt * flow_w
                            + wander * dt * noise_w))

    # Tend towards targets — ref `src/logic.frag:85`.
    target_w = vary(params["target"], index01, params["varyTarget"])
    new_vel = new_vel + (targets[:2] - pos) * target_w

    # Speed clamp — ref `src/logic.frag:92-94`. (Guard the 0/0 the GLSL
    # leaves undefined: zero velocity stays zero.)
    speed = jnp.sqrt(new_vel[0] ** 2 + new_vel[1] ** 2)
    scale = jnp.minimum(speed, params["speedLimit"]) / jnp.maximum(speed,
                                                                   1e-12)
    new_vel = new_vel * scale

    new_pos = pos + new_vel

    new_pos = jnp.where(alive, new_pos, pos)
    new_vel = jnp.where(alive, new_vel, vel)
    return jnp.concatenate([new_pos, new_vel])
