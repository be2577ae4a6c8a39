"""Optical flow from video frames — ref `src/optical-flow/index.frag:55-81`.

Lucas–Kanade-style flow between the current and last frames: central
-difference x/y gradients summed over both frames, then

    vec = (diff·gradX/|grad|, diff·gradY/|grad|) · speed
    out = flow_payload(bezier((0,0,1), |vec|/speedLimit) · vec, speedLimit)

operating on grayscale (`src/utils/gray-scale.glsl` luma weights). The GLSL
samples at `st ± offset` in UV; here the offset is a traced fractional-pixel
translation implemented with a dynamic roll + linear blend (wrap artefacts
touch only the outermost offset-band of camera pixels).

The double-buffered frame rotation (`optical-flow/index.js:32-73`) lives in
the `OpticalFlow` wrapper in `tendrils/media.py`.
"""

import jax
import jax.numpy as jnp

from . import flow as flow_ops


def gray_scale(img):
    """Luma — ref `src/utils/gray-scale.glsl` (0.3, 0.59, 0.11 weights).

    `img: f32[4, H, W]` -> `f32[H, W]`.
    """
    return 0.3 * img[0] + 0.59 * img[1] + 0.11 * img[2]


def _translate(img, dx, dy):
    """Translate `f32[H, W]` by traced fractional pixels (+x right, +y up in
    texel space ⇒ array shifts are negative)."""
    ix = jnp.floor(dx).astype(jnp.int32)
    iy = jnp.floor(dy).astype(jnp.int32)
    fx = dx - ix
    fy = dy - iy

    def roll2(a, sx, sy):
        return jnp.roll(jnp.roll(a, -sx, axis=1), -sy, axis=0)

    a = roll2(img, ix, iy)
    b = roll2(img, ix + 1, iy)
    c = roll2(img, ix, iy + 1)
    d = roll2(img, ix + 1, iy + 1)
    top = a + (b - a) * fx
    bot = c + (d - c) * fx
    return top + (bot - top) * fy


@jax.jit
def optical_flow(view, last, time, offset=0.1, lambda_=0.001, speed=1.0,
                 speed_limit=1.0):
    """Flow payload grid from two frames.

    `view`, `last`: `f32[4, H, W]` current/previous frames.
    `offset`: central-difference half-step in UV units (traced) — ref demo
    default 0.1 (`demo.main.js:527-530`); `lambda_` regularises the gradient
    magnitude. Returns `f32[4, H, W]` in the standard flow-payload format.

    uint8 frames are accepted and normalised to [0, 1] ON DEVICE — the
    feed then uploads a quarter of the f32 bytes (the hot transfer of the
    camera path, ref `demo.main.js:1131-1160`).
    """
    if view.dtype == jnp.uint8:
        view = view.astype(jnp.float32) * (1.0 / 255.0)
    if last.dtype == jnp.uint8:
        last = last.astype(jnp.float32) * (1.0 / 255.0)
    _, h, w = view.shape
    gv = gray_scale(view)
    gl = gray_scale(last)

    ox = offset * w
    oy = offset * h

    def grad(img_a, img_b, dx, dy):
        return (_translate(img_a, dx, dy) - _translate(img_a, -dx, -dy)
                + _translate(img_b, dx, dy) - _translate(img_b, -dx, -dy))

    grad_x = grad(gv, gl, ox, 0.0)
    grad_y = grad(gv, gl, 0.0, oy)
    grad_mag = jnp.sqrt(grad_x * grad_x + grad_y * grad_y + lambda_)

    diff = gv - gl
    vx = diff * grad_x / grad_mag * speed
    vy = diff * grad_y / grad_mag * speed

    # bezier((0,0,1), t) = t² falloff — ref index.frag:80 + utils/bezier.glsl.
    # The reference's t is unclamped: motion faster than speedLimit
    # extrapolates t² > 1 (the payload's weight clamps later).
    mag = jnp.sqrt(vx * vx + vy * vy)
    t = mag / jnp.maximum(speed_limit, 1e-12)
    fall = t * t
    vel = jnp.stack([vx * fall, vy * fall])

    return flow_ops.flow_payload(vel.reshape(2, -1), time,
                                 speed_limit).reshape(4, h, w)


@jax.jit
def composite_flow(flow_grid, payload):
    """Alpha-blend an optical-flow payload over the engine flow grid — the
    reference renders the optical-flow quad into the flow FBO with
    `SRC_ALPHA, ONE_MINUS_SRC_ALPHA` (`demo.main.js:1150-1156`)."""
    a = payload[3:4]
    return payload * a + flow_grid * (1.0 - a)
