"""Exact numpy twins of the reference's blur/bokeh post passes.

The production `ops/post.py` passes approximate these per-pixel multi-tap
GLSL blurs with a static blur stack (documented deviation). These oracles
transcribe the EXACT shipped algorithms so the approximation error can be
*measured* (tests/test_post_oracle.py asserts bounds; scripts/acceptance.py
renders side-by-sides):

  - `hash_blur_exact`: the vignette hash blur, `src/screen/blur.frag`
    composed with its `glsl-hash-blur` dependency. The dependency is not
    vendored in the reference repo; its tap pattern is transcribed from the
    shader text glslify inlined into the reference's own shipped bundle
    (`docs/js/demo-run.js`, the "A vignette hash blur" module): 20 taps on
    a hash-seeded uniform disc, re-hashed per tap with
    `r = fract(r * vec2(12.9898, 78.233));
     d = sqrt(r.x + .001) * vec2(sin(r.y*TAU), cos(r.y*TAU))`.
  - `bokeh_exact`: the vignette bokeh, `src/screen/bokeh.frag` +
    `libs/bokeh/index.glsl` (David Hoskins' golden-angle disc): 20 taps at
    `uv + texel*(r-1)*angle`, `r += 1/r`, `angle = rot(2.39996323)·angle`,
    weights `pow(col², 9)·(amount + radius·500) + 0.4` after the
    `col·col·1.5` contrast boost.

Sampling is bilinear, clamp-to-edge (WebGL texture defaults in the
reference's FBO setup). All math fp32, matching GLSL highp.
"""

import numpy as np

F = np.float32
TAU = F(6.28318530718)


def _hash32(x, y):
    """glsl-random (incl. mod(dt, 3.14)), strictly fp32 — the blur's seed
    hash as inlined in the bundle."""
    d = F(x) * F(12.9898) + F(y) * F(78.233)
    d = np.mod(d, F(3.14))
    s = np.sin(d, dtype=F) * F(43758.5453)
    return s - np.floor(s)


def _bezier3(cp, t):
    ut = F(1.0) - t
    return (F(cp[0]) * ut + F(cp[1]) * t) * ut \
        + (F(cp[1]) * ut + F(cp[2]) * t) * t


def _bezier4(cp, t):
    ut = F(1.0) - t
    a1 = F(cp[1]) * ut + F(cp[2]) * t
    return ((F(cp[0]) * ut + F(cp[1]) * t) * ut + a1 * t) * ut \
        + (a1 * ut + (F(cp[2]) * ut + F(cp[3]) * t) * t) * t


def _vignette(uv, mid, limit, curve):
    d = np.sqrt(((uv - F(mid)) ** 2).sum(-1, dtype=F))
    amt = np.minimum(F(1.0) - d / F(limit), F(1.0))
    bez = _bezier3(curve, amt) if len(curve) == 3 else _bezier4(curve, amt)
    return np.maximum(F(0.0), bez)


def _sample_bilinear(img, u, v):
    """Bilinear clamp-to-edge sample of `f32[C, H, W]` at uv in [0,1]².

    WebGL texel convention: uv·size - 0.5 is the texel-centre coordinate.
    `u`/`v`: f32[H, W] arrays of sample positions."""
    c, h, w = img.shape
    x = u * F(w) - F(0.5)
    y = v * F(h) - F(0.5)
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0)[None]
    fy = (y - y0)[None]
    x0 = np.clip(x0.astype(np.int64), 0, w - 1)
    y0 = np.clip(y0.astype(np.int64), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    p00 = img[:, y0, x0]
    p01 = img[:, y0, x1]
    p10 = img[:, y1, x0]
    p11 = img[:, y1, x1]
    top = p00 + (p01 - p00) * fx
    bot = p10 + (p11 - p10) * fx
    return top + (bot - top) * fy


def _uv_grid(h, w):
    """gl_FragCoord.xy / resolution — texel centres."""
    x = (np.arange(w, dtype=F) + F(0.5)) / F(w)
    y = (np.arange(h, dtype=F) + F(0.5)) / F(h)
    return np.meshgrid(x, y)


def hash_blur_exact(view, radius, limit, time=0.0):
    """`src/screen/blur.frag` exactly, numpy fp32.

    `view`: f32[4, H, W]; returns f32[4, H, W]. `radius`/`limit` are the
    shader uniforms; `time` drives the per-frame jitter (`mod(time, 20)`).

    NOTE the shipped shader's anisotropy: `circle.x *= aspect` on a UV-space
    radius makes the pixel-space x-extent aspect² times the y-extent (for
    square frames they agree). The production pass is isotropic at the
    y-extent; quantify on square frames, document on wide ones.
    """
    view = np.asarray(view, F)
    _, h, w = view.shape
    ux, uy = _uv_grid(h, w)
    uv = np.stack([ux, uy], -1)
    texel = F(1.0) / F(min(h, w))
    amount = (F(1.0) - _vignette(uv, 0.5, limit, (0.0, 1.0, 1.0))) * texel
    aspect = F(w) / F(h)
    jitter = np.mod(F(time), F(20.0))

    rad = F(radius) * amount  # UV-space disc radius per pixel
    cx = rad * aspect
    cy = rad
    # rnd = vec2(random(uv + offset)) — both lanes seeded with the same hash.
    seed = _hash32(ux + jitter, uy + jitter)
    r0 = seed.copy()
    r1 = seed.copy()
    acc = np.zeros((3, h, w), F)
    for _ in range(20):
        # mult(inout r): r = fract(r * vec2(12.9898, 78.233))
        r0 = r0 * F(12.9898)
        r0 -= np.floor(r0)
        r1 = r1 * F(78.233)
        r1 -= np.floor(r1)
        mag = np.sqrt(r0 + F(0.001))
        dx = mag * np.sin(r1 * TAU, dtype=F)
        dy = mag * np.cos(r1 * TAU, dtype=F)
        acc += _sample_bilinear(view[:3], ux + cx * dx, uy + cy * dy)
    out = acc / F(20.0)
    return np.concatenate([out, view[3:4]])


_GOLDEN = F(2.39996323)
_ROT = np.array([[np.cos(_GOLDEN), np.sin(_GOLDEN)],
                 [-np.sin(_GOLDEN), np.cos(_GOLDEN)]], F)


def bokeh_exact(view, radius, amount):
    """`src/screen/bokeh.frag` + `libs/bokeh/index.glsl` exactly, numpy fp32.

    `radius`/`amount` are the shader uniforms (UV-texel-scaled radius,
    per-pixel scaled by the vignette power as in the shader)."""
    view = np.asarray(view, F)
    _, h, w = view.shape
    ux, uy = _uv_grid(h, w)
    uv = np.stack([ux, uy], -1)
    power = F(1.0) - _vignette(uv, 0.5, 0.6, (0.0, 1.0, 1.0, 1.0))
    rad = F(radius) * power      # per-pixel bokeh radius
    amt = F(amount) * power + rad * F(500.0)
    tx = F(1.0) / F(w)           # texel = 1/resolution (per axis)
    ty = F(1.0) / F(h)

    acc = np.zeros((3, h, w), F)
    div = np.zeros((3, h, w), F)
    r = F(1.0)
    ang = np.array([0.0, 1.0], F)  # unit; scaled by per-pixel rad below
    for _ in range(20):
        r = r + F(1.0) / r
        ang = _ROT @ ang
        ox = tx * (r - F(1.0)) * ang[0] * rad
        oy = ty * (r - F(1.0)) * ang[1] * rad
        col = _sample_bilinear(view[:3], ux + ox, uy + oy)
        col = col * col * F(1.5)
        wgt = col ** 9 * amt[None] + F(0.4)
        acc += col * wgt
        div += wgt
    out = acc / div
    return np.concatenate([out, view[3:4]])


def box_stack_reference(img, radii):
    """The blur stack as sequential edge-replicated box blurs, in float64:
    each level applies a box of radius `max(1, (r - prev) // 2 + 1)` twice
    along rows and columns to the previous level. The operator
    `ops/post.blur_stack` must reproduce with its dense matrices. Returns
    `[img, level_1, ..., level_L]`."""

    def box_axis(x, r, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r + 1, r)
        c = np.cumsum(np.pad(x, pad, mode="edge"), axis=axis)
        n = x.shape[axis]
        hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
        lo = np.take(c, np.arange(n), axis=axis)
        return (hi - lo) / (2 * r + 1)

    def box(x, r):
        return box_axis(box_axis(x, r, 1), r, 2)

    cur = np.asarray(img, np.float64)
    stack = [cur]
    prev = 0
    for r in radii:
        rr = max(1, (r - prev) // 2 + 1)
        cur = box(box(cur, rr), rr)
        stack.append(cur)
        prev = r
    return stack
