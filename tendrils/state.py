"""Parameter schema and simulation state pytrees.

Mirrors the reference's `defaults()` state schema (`src/index.js:28-75`) with
identical field names and values, so presets transfer verbatim. Design pillar
(SURVEY §7 pillar 3): every one of these is a *traced* argument of the jitted
step/draw functions — never baked into the compilation — so live tweaking,
timeline animation and presets never trigger a recompile, exactly like the
reference re-uploading uniforms wholesale each frame (`src/index.js:255-263`).

State layout (SURVEY §7 pillar 1): particle state is channel-major
`f32[4, N]` with rows (pos.x, pos.y, vel.x, vel.y) — the RGBA float texture of
`src/particles.js:84-85` turned into an array whose big extent is the
contiguous minor axis. Grids ("FBOs") are `f32[4, H, W]`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .const import INERT


def default_state() -> dict[str, Any]:
    """Engine parameter schema — ref `src/index.js:29-66`, same values."""
    return {
        "rootNum": 2 ** 9,

        "autoClearView": False,
        "autoFade": True,

        "damping": 0.043,
        "speedLimit": 0.01,

        "forceWeight": 0.016,
        "varyForce": -0.1,

        "flowWeight": 1.0,
        "varyFlow": 0.2,

        "noiseWeight": 0.002,
        "varyNoise": 0.3,

        "flowDecay": 0.005,
        "flowWidth": 5.0,

        "noiseScale": 2.125,
        "varyNoiseScale": 0.5,

        "noiseSpeed": 0.00025,
        "varyNoiseSpeed": 0.1,

        "target": 0.0,
        "varyTarget": 1.0,

        "lineWidth": 1.0,
        "speedAlpha": 0.000001,
        "colorMapAlpha": 0.4,

        "baseColor": [1.0, 1.0, 1.0, 0.5],
        "flowColor": [1.0, 1.0, 1.0, 0.04],
        "fadeColor": [0.1333, 0.1333, 0.1333, 0.0],
    }


# Parameters that are structural (affect shapes / compiled control flow) and
# are therefore static engine config rather than traced scalars.
_STATIC_KEYS = ("rootNum", "autoClearView", "autoFade")


def params_from_state(state: dict[str, Any]) -> dict[str, Any]:
    """Split the traced-parameter view out of a state dict.

    Everything except `_STATIC_KEYS` is turned into f32 scalars/vectors ready
    to be passed (and traced) through jitted functions.
    """
    out = {}
    for k, v in state.items():
        if k in _STATIC_KEYS:
            continue
        out[k] = jnp.asarray(v, jnp.float32)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """The full mutable sim state, as one functional pytree.

    Fields mirror the reference's GPU-resident buffers:
      particles: `f32[4, N]` current particle state — `particles.buffers[0]`
      previous:  `f32[4, N]` previous step's state — `particles.buffers[1]`
                 (ping-pong pair, `src/particles.js:81-92,123-129`)
      targets:   `f32[4, N]` seek targets — `src/index.js:105`
      flow:      `f32[4, H, W]` flow field — `src/index.js:102`
      view:      `f32[B, 4, H, W]` view/trail buffers — `src/index.js:109`
      color_map: `f32[4, ch, cw]` colour map — `src/index.js:94-96`
      key:       threefry key for stochastic ops (spawns)
      idx:       `i32[N]` original particle index per row; per-particle
                 constants (uv, variance index, colour-map uv) are computed
                 from it (`particle_coords_from_idx`). The engine keeps rows
                 in identity order.
    """
    particles: jax.Array
    previous: jax.Array
    targets: jax.Array
    flow: jax.Array
    view: jax.Array
    color_map: jax.Array
    key: jax.Array
    idx: jax.Array


def make_state(root_num: int = 512, view_res=(720, 1280), num_view_buffers=1,
               color_map_res=(1, 1), seed: int = 0,
               flow_res=None) -> SimState:
    """Allocate a fresh SimState.

    All particles start inert (ref `src/spawn/init/cpu.js:1-8`), grids zero
    (GL clears to 0). `view_res` is (H, W); `flow_res` defaults to `view_res`
    (ref `src/index.js:405` sizes the flow FBO to the view).
    """
    n = int(root_num) * int(root_num)
    h, w = view_res
    fh, fw = (flow_res if flow_res is not None else view_res)
    ch, cw = color_map_res

    particles = jnp.concatenate([
        jnp.full((2, n), INERT, jnp.float32),
        jnp.zeros((2, n), jnp.float32),
    ])
    return SimState(
        particles=particles,
        previous=particles,
        targets=jnp.zeros((4, n), jnp.float32),
        flow=jnp.zeros((4, fh, fw), jnp.float32),
        view=jnp.zeros((num_view_buffers, 4, h, w), jnp.float32),
        color_map=jnp.zeros((4, ch, cw), jnp.float32),
        key=jax.random.PRNGKey(seed),
        idx=jnp.arange(n, dtype=jnp.int32),
    )


def particle_coords_from_idx(idx, root_num):
    """Per-particle constants from original indices (traced).

    Returns (uv `f32[2, N]`, index01 `f32[N]`, colormap_uv `f32[2, N]`) —
    the traced twins of `particle_uv`/`particle_index01` and the engine's
    colour-map UV, so a row keeps its identity wherever it is placed.
    """
    r = root_num
    idx = idx.astype(jnp.float32)
    ix = jnp.mod(idx, r)
    iy = jnp.floor(idx / r)
    uv = jnp.stack([(ix + 0.5) / r, (iy + 0.5) / r])
    index01 = ((ix + 0.5) + (iy + 0.5) * r) / (r * r)
    cm_x = ix / max(r - 1, 1)
    cm_y = jnp.minimum(iy * 2.0 / max(2 * r - 1, 1) * 2.0, 1.0)
    colormap_uv = jnp.stack([cm_x, cm_y])
    return uv, index01, colormap_uv


def particle_uv(root_num: int) -> jax.Array:
    """Per-particle data-texture UVs, `f32[2, N]` (identity-order host twin
    of `particle_coords_from_idx`; kept as the numpy oracle).

    The logic shader's `uv = gl_FragCoord.xy / dataRes` (`src/logic.frag:46`)
    with x fastest (`i = x + y*W`, `src/logic.frag:57`).
    """
    w = h = int(root_num)
    idx = np.arange(w * h, dtype=np.int64)
    ix = (idx % w).astype(np.float32)
    iy = (idx // w).astype(np.float32)
    uv = np.stack([(ix + 0.5) / w, (iy + 0.5) / h])
    return jnp.asarray(uv)


def particle_index01(root_num: int) -> jax.Array:
    """The per-particle 1D variance index `i` — ref `src/logic.frag:57-58`.

    `i = (fragX + fragY * W) / (W * H)` with frag coords at texel centres.
    Returns `f32[N]` in (0, 1).
    """
    w = h = int(root_num)
    idx = np.arange(w * h, dtype=np.int64)
    fx = (idx % w).astype(np.float64) + 0.5
    fy = (idx // w).astype(np.float64) + 0.5
    return jnp.asarray((fx + fy * w) / (w * h), jnp.float32)
