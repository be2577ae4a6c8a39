"""Texture-style sampling of grid arrays (the stand-in for `texture2D`).

The reference leans on the GL sampler for: flow-force lookup
(`src/logic.frag:75`), target lookup (`src/logic.frag:85`), colour-map lookup
(`src/render/index.vert:65`), and spawn-data lookup
(`src/spawn/pixels/frag/*.frag`). Here a "texture" is `f32[C, H, W]` (channel
-major so the big H*W extent is contiguous) and sampling is an XLA gather +
bilinear interpolation, `CLAMP_TO_EDGE` semantics.
"""

import jax.numpy as jnp


def _gather_cn(grid_flat, idx):
    """`grid_flat: f32[C, H*W]`, `idx: i32[N]` -> `f32[C, N]`."""
    return jnp.take(grid_flat, idx, axis=1)


def bilinear_sample(grid, x, y):
    """Bilinearly sample `grid: f32[C, H, W]` at texel coords.

    `x`, `y`: `f32[N]` in *texel* units where (0.5, 0.5) is the centre of
    texel [0, 0] — i.e. `uv * (W, H)`, exactly GL's bilinear footprint.
    Returns `f32[C, N]`. Clamp-to-edge addressing.
    """
    c, h, w = grid.shape
    # CLAMP_TO_EDGE: clamp the sample position into the texel-centre span, so
    # edge samples read the edge texel (GL semantics).
    gx = jnp.clip(x, 0.5, w - 0.5) - 0.5
    gy = jnp.clip(y, 0.5, h - 0.5) - 0.5
    x0 = jnp.floor(gx)
    y0 = jnp.floor(gy)
    fx = gx - x0
    fy = gy - y0

    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)

    flat = grid.reshape(c, h * w)
    v00 = _gather_cn(flat, y0i * w + x0i)
    v01 = _gather_cn(flat, y0i * w + x1i)
    v10 = _gather_cn(flat, y1i * w + x0i)
    v11 = _gather_cn(flat, y1i * w + x1i)

    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def nearest_sample(grid, x, y):
    """Nearest-texel sample of `grid: f32[C, H, W]` at texel coords -> [C, N]."""
    c, h, w = grid.shape
    xi = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 1)
    return _gather_cn(grid.reshape(c, h * w), yi * w + xi)


def sample_uv(grid, uv, bilinear=True):
    """Sample `grid: f32[C, H, W]` at `uv: f32[N, 2]` in [0,1] -> `f32[C, N]`."""
    _, h, w = grid.shape
    x = uv[..., 0] * w
    y = uv[..., 1] * h
    return (bilinear_sample if bilinear else nearest_sample)(grid, x, y)
