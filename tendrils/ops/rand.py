"""Hash randoms.

The reference uses `glsl-random` for its GPU spawn shaders
(`src/spawn/ball/index.frag:6-14`) and pixel-spawn UV jitter
(`src/spawn/pixels/frag/head.frag:28-37`). The npm package it requires —
verified against the shader text glslify inlined into the reference's own
shipped bundle (`docs/js/demo-run.js`) — reduces the dot product with
`mod(dt, 3.14)` BEFORE the sine (a numerical-stability guard the package
added over the classic shadertoy one-liner):

    dt = dot(co, vec2(12.9898, 78.233));
    sn = mod(dt, 3.14);
    return fract(sin(sn) * 43758.5453);

We keep the same hash (`glsl_random`) for behavioural parity of the spawn
distributions, and additionally expose counter-based `threefry` helpers via
`jax.random` for callers who want reproducible high-quality streams
(determinism design pillar, see SURVEY §7 pillar 5). The sine hash is a pure
elementwise op, so it fuses into spawn kernels the same way the GLSL
version folds into fragment shaders.
"""

import jax
import jax.numpy as jnp


def glsl_random(co):
    """`glsl-random` hash: `co: f32[..., 2] -> f32[...]` in [0, 1).

    Includes the package's `mod(dt, 3.14)` argument reduction (see module
    docstring) — omitting it yields a *different* random stream than the
    reference's spawn shaders."""
    co = jnp.asarray(co, jnp.float32)
    d = co[..., 0] * 12.9898 + co[..., 1] * 78.233
    d = jnp.mod(d, 3.14)
    s = jnp.sin(d) * 43758.5453
    return s - jnp.floor(s)


def glsl_random2(co):
    """Two decorrelated hashes of one `f32[..., 2]` coordinate."""
    return glsl_random(co), glsl_random(co + 1.2345)


def uniform(key, shape, lo=0.0, hi=1.0):
    """Threefry uniform, `f32[shape]` in [lo, hi)."""
    return jax.random.uniform(key, shape, jnp.float32, lo, hi)
