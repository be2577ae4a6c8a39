"""Post-processing: fade, copy, blend compositing, vignette blur, bokeh.

Re-derivations of the reference's screen-space passes (SURVEY §2.6):

  - Blend (`src/screen/blend/index.js` + `blend/main.frag`): N-texture
    weighted premultiplied sum. Pure elementwise — XLA fuses it.
  - Blur (`src/screen/blur.frag`): vignette-masked hash blur, strongest at
    the edges. The reference averages 20 hash-jittered taps on a uniform
    disc per pixel; this build computes a blur *stack* at static radii
    (repeated box blurs, each level one pair of dense matrix products) and
    lerps per pixel between levels. The per-pixel level is NOT
    ad hoc: `_level_lut` solves, offline per static radii tuple, the
    least-squares match between each lerped stack kernel and the exact
    expected disc kernel of the reference's tap pattern (transcribed in
    `tests/post_oracles.py` from the shipped bundle) — measured ≤ ~6% rel
    RMS from the exact shader on trail-like frames
    (`tests/test_post_oracle.py`). The hash grain is approximated by
    jittering the level (documented deviation).
  - Bokeh (`src/screen/bokeh.frag` + `libs/bokeh/index.glsl`): brightness-
    weighted disc blur (weights `pow(col², 9)·amount + 0.4` after the
    contrast boost `col·col·1.5`). The weighting is linear in the blur, so
    it is computed exactly as blur(col·w)/blur(w) over the same static
    stack; the disc (20 deterministic golden-angle taps out to
    ≈5.4·radius px) is kernel-matched by the same LUT machinery.

All radii in the stack are static config; the *strength* params stay traced.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import coords
from .filters import bezier, vignette

# Reference constants: blur.frag:21-22, bokeh.frag:23-25.
BLUR_FALLOFF = (0.0, 1.0, 1.0)
BOKEH_FALLOFF = (0.0, 1.0, 1.0, 1.0)
MID = 0.5
BOKEH_LIMIT = 0.6


def copy(view):
    """FBO blit — ref `src/screen/copy.frag` (FXAA disabled there too)."""
    return view


def blend(views, alphas):
    """Premultiplied weighted sum of views — ref `screen/blend/main.frag:17-29`
    + `src/blend/sum.glsl`. `views`: list of `f32[4, H, W]`; `alphas`: f32[N]
    traced."""
    out = jnp.zeros_like(views[0])
    for i, v in enumerate(views):
        a = v[3] * alphas[i]
        out = out + jnp.concatenate([v[:3] * a[None], a[None]])
    return out


def blend_multiply(views, alphas):
    """`src/blend/multiply.glsl` variant: running premultiplied product."""
    out = None
    for i, v in enumerate(views):
        a = v[3] * alphas[i]
        pre = jnp.concatenate([v[:3] * a[None], a[None]])
        out = pre if out is None else out * pre
    return out


# --- Blur stack as dense matrix products ------------------------------------
#
# Each stack level is a LINEAR operator, so level_l = A_l @ img @ B_l^T with
# A_l/B_l the composed edge-replicated box matrices. On an H100 at
# 2160x3840 (bokeh's 4 channels, 3 levels) the products take 7.1 ms in the
# GPU's default matmul precision (TF32), against 11.5 ms for the same stack
# as sequential cumsum boxes and 37.6 ms for the products in float32
# (`chip_smoke.py` phase 4, NVIDIA H100 80GB HBM3 at 700 W). TF32 moves the
# output by at most 1.8e-4 from the float32 stack there, far inside the
# stack's own deviation from the reference shaders
# (`tests/test_post_oracle.py`). The matrices are built banded in numpy
# (exactly the product of the clamped box matrices). At 4K they hold
# ~233 MB per radii tuple, so callers at that size pass them as jit
# ARGUMENTS (`mats`); embedded as constants they bloat the compiled
# program by as much.


def _band_box(n, r):
    """Edge-replicated box blur as a banded matrix.

    Band layout: `band[d + r, i] = M[i, i + d]` (zero where out of range);
    `out[i] = sum_d band[d + r, i] * x[i + d]`.
    """
    band = np.zeros((2 * r + 1, n), np.float64)
    inv = 1.0 / (2 * r + 1)
    idx = np.arange(n)
    for d in range(-r, r + 1):
        valid = (idx + d >= 0) & (idx + d < n)
        band[d + r, valid] += inv
    for i in range(min(r, n)):
        # Rows near the top: taps d < -i clamp to column 0 (offset -i).
        band[-i + r, i] += (r - i) * inv
        # Mirror rows near the bottom clamp to column n-1 (offset +i).
        band[i + r, n - 1 - i] += (r - i) * inv
    return band, r


def _band_mul(a, ra, b, rb, n):
    """Banded product C = A @ B (C[i,j] = sum_k A[i,k] B[k,j])."""
    rc = ra + rb
    c = np.zeros((2 * rc + 1, n), np.float64)
    i = np.arange(n)
    for e in range(-ra, ra + 1):
        ae = a[e + ra]
        for f in range(-rb, rb + 1):
            d = e + f
            k = i + e
            valid = (k >= 0) & (k < n) & (i + d >= 0) & (i + d < n)
            c[d + rc, valid] += ae[valid] * b[f + rb, k[valid]]
    return c, rc


def _band_dense(band, r, n):
    m = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for d in range(-r, r + 1):
        valid = (i + d >= 0) & (i + d < n)
        m[i[valid], (i + d)[valid]] = band[d + r, valid]
    return m


@functools.lru_cache(maxsize=8)
def _axis_matrices_np(n, radii):
    """Per-level cumulative blur matrices along one axis, `[(n, n)] * L`.

    Row i of M_l holds the level-l kernel for output index i — exactly the
    product of the sequential clamped box matrices `blur_stack` applies.
    """
    mats = []
    cur, rc = None, 0
    prev = 0
    for r in radii:
        rr = max(1, (r - prev) // 2 + 1)
        b, rb = _band_box(n, rr)
        step, rs = _band_mul(b, rb, b, rb, n)
        if cur is None:
            cur, rc = step, rs
        else:
            cur, rc = _band_mul(step, rs, cur, rc, n)
        mats.append(_band_dense(cur, rc, n))
        prev = r
    return mats


def blur_stack_matrices(shape_hw, radii=(2, 6, 16)):
    """Device operator pair for `blur_stack(..., mats=...)`.

    Returns `(A, Bt)`: `A[l]` is `f32[H, H]` (left multiply), `Bt[l]` is
    `f32[W, W]` already transposed for the natural-orientation right
    multiply `img @ Bt`.
    """
    h, w = shape_hw
    a = tuple(jnp.asarray(m) for m in _axis_matrices_np(h, tuple(radii)))
    bt = tuple(jnp.asarray(m.T) for m in _axis_matrices_np(w, tuple(radii)))
    return a, bt


def blur_stack(img, radii=(2, 6, 16), mats=None):
    """Progressively blurred copies of `img: f32[C, H, W]` (repeated boxes
    ≈ gaussian): `[img, level_1, ..., level_L]`.

    Each level is two dense matrix products over the SOURCE image (the
    per-level matrices are cumulative). `mats` is `blur_stack_matrices`'
    output for this shape and radii; without it the matrices are built
    here and become compile-time constants (fine for small views)."""
    if mats is None:
        mats = blur_stack_matrices(img.shape[1:], radii)
    a, bt = mats
    stack = [img]
    for a_l, bt_l in zip(a, bt):
        hp = jnp.einsum("Hh,chw->cHw", a_l, img,
                        preferred_element_type=jnp.float32)
        stack.append(jnp.einsum("chw,wW->chW", hp, bt_l,
                                preferred_element_type=jnp.float32))
    return stack


def _stack_lerp(stack, level):
    """Blend between stack levels by a per-pixel fractional level `[H, W]`."""
    n = len(stack) - 1
    level = jnp.clip(level, 0.0, n)
    out = stack[0]
    for i in range(n):
        t = jnp.clip(level - i, 0.0, 1.0)[None]
        out = out + (stack[i + 1] - out) * t
    return out


# --- kernel-matched level calibration (static, per radii tuple) --------------


def _stack_kernels_1d(radii):
    """1D separable kernel of each stack level (level 0 = identity)."""
    ks = [np.array([1.0])]
    cur = np.array([1.0])
    prev = 0
    for r in radii:
        rr = max(1, (r - prev) // 2 + 1)
        box = np.full(2 * rr + 1, 1.0 / (2 * rr + 1))
        cur = np.convolve(np.convolve(cur, box), box)
        ks.append(cur)
        prev = r
    return ks


def _centered(k1d, size):
    out = np.zeros(size)
    c = size // 2
    h = len(k1d) // 2
    out[c - h:c + h + 1] = k1d
    return out


def _splat_taps(x, y, w, size):
    """Bilinear-splat tap offsets (px) into a size×size kernel."""
    c = size // 2
    K = np.zeros((size, size))
    xi = np.floor(x).astype(int)
    yi = np.floor(y).astype(int)
    fx, fy = x - xi, y - yi
    for dx, wx in ((0, 1 - fx), (1, fx)):
        for dy, wy in ((0, 1 - fy), (1, fy)):
            np.add.at(K, (np.clip(c + yi + dy, 0, size - 1),
                          np.clip(c + xi + dx, 0, size - 1)), w * wx * wy)
    return K / w.sum()


def _disc_taps(strength):
    """Expected tap density of the reference hash blur: 20 samples uniform
    on a disc of radius `strength` px (`sqrt(u)·(sin, cos)(v·τ)` — the
    bundle-inlined `glsl-hash-blur` `mult()`), Monte-Carlo with a fixed
    seed (the expectation over the per-pixel hash streams)."""
    rng = np.random.RandomState(0)
    n = 20000
    rad = np.sqrt(rng.rand(n) + 0.001) * strength
    th = rng.rand(n) * 2.0 * np.pi
    return rad * np.sin(th), rad * np.cos(th), np.full(n, 1.0)


_GOLDEN = 2.39996323


def _bokeh_taps(strength):
    """The 20 deterministic golden-angle taps of `libs/bokeh/index.glsl`
    at disc parameter `strength` px (offset `(r-1)·R(golden)^j·(0, s)`)."""
    xs, ys = [], []
    r = 1.0
    ang = np.array([0.0, strength])
    rot = np.array([[np.cos(_GOLDEN), np.sin(_GOLDEN)],
                    [-np.sin(_GOLDEN), np.cos(_GOLDEN)]])
    for _ in range(20):
        r += 1.0 / r
        ang = rot @ ang
        xs.append((r - 1.0) * ang[0])
        ys.append((r - 1.0) * ang[1])
    return np.asarray(xs), np.asarray(ys), np.full(20, 1.0)


@functools.lru_cache(maxsize=None)
def _level_lut(radii, kind):
    """Offline least-squares match: for a grid of per-pixel strengths,
    the fractional stack level whose lerped kernel best matches the exact
    tap kernel (`kind`: "disc" hash blur | "bokeh" golden-angle disc).
    Returns (strengths, levels) as float32 tuples for `jnp.interp`."""
    taps_of = _disc_taps if kind == "disc" else _bokeh_taps
    extent = 1.0 if kind == "disc" else 5.5  # max tap offset per strength
    k1d = _stack_kernels_1d(radii)
    top = max(len(k) for k in k1d) // 2
    smax = radii[-1] * (2.5 if kind == "disc" else 1.0)
    size = 2 * int(np.ceil(max(top, smax * extent))) + 3
    K2 = [np.outer(_centered(k, size), _centered(k, size)) for k in k1d]
    grid = np.linspace(0.0, smax, 17)
    levels = [0.0]
    for s in grid[1:]:
        x, y, w = taps_of(s)
        D = _splat_taps(x, y, w, size)
        best = (np.inf, 0.0)
        for i in range(len(K2) - 1):
            d = K2[i + 1] - K2[i]
            t = float(np.clip(((D - K2[i]) * d).sum()
                              / max((d * d).sum(), 1e-12), 0.0, 1.0))
            e = float(((K2[i] + t * d - D) ** 2).sum())
            if e < best[0]:
                best = (e, i + t)
        levels.append(best[1])
    # enforce monotonicity (ties between adjacent segments can wobble)
    levels = np.maximum.accumulate(np.asarray(levels))
    return (tuple(np.float32(v) for v in grid),
            tuple(np.float32(v) for v in levels))


def _matched_level(strength, radii, kind):
    s, l = _level_lut(tuple(radii), kind)
    return jnp.interp(strength, jnp.asarray(s), jnp.asarray(l))


@functools.partial(jax.jit, static_argnames=("radii", "grain"))
def vignette_blur(view, radius, limit, radii=(1, 3, 8), grain=0.75,
                  mats=None):
    """Edge blur — ref `src/screen/blur.frag:24-32`.

    Per-pixel disc radius = `radius * (1 - vignette(uv, mid, limit,
    falloff))` px (the shader's `radius*amount` with `texel` folded out);
    mapped onto the static blur stack through the kernel-matched LUT.
    `radius`/`limit` stay traced.

    The reference's `glsl-hash-blur` jitters its 20 tap directions with a
    per-pixel sine hash, leaving a characteristic NOISE GRAIN in the
    blurred zones; the stack has no per-pixel taps, so the grain is
    reproduced by hash-jittering the per-pixel stack LEVEL with
    the same `fract(sin)` hash (`grain` scales it; 0 = smooth). Crisp
    (level-0) pixels stay untouched, like the reference's unjittered
    centre."""
    _, h, w = view.shape
    uv = coords.uv_grid((h, w))
    amount = 1.0 - vignette(uv, jnp.full((2,), MID), limit,
                            jnp.asarray(BLUR_FALLOFF, jnp.float32))
    strength = radius * amount  # in pixels of disc radius
    level = _matched_level(strength, radii, "disc")
    if grain:
        from .rand import glsl_random
        jitter = glsl_random(uv * jnp.asarray([w, h], jnp.float32)) - 0.5
        level = level + jitter * grain * jnp.minimum(level, 1.0)
    stack = blur_stack(view, radii, mats=mats)
    blurred = _stack_lerp(stack, level)
    # Alpha passes through unblurred — ref blur.frag:30-31 keeps view alpha.
    return jnp.concatenate([blurred[:3], view[3:4]])


@functools.partial(jax.jit, static_argnames=("radii",))
def bokeh(view, radius, amount, radii=(2, 6, 16), mats=None):
    """Vignette bokeh — ref `src/screen/bokeh.frag:27-34` +
    `libs/bokeh/index.glsl`.

    Exact weighting (blur of col·w over blur of w with the reference's
    highlight weights), disc kernel (20 golden-angle taps out to
    ≈5.4·radius px) kernel-matched onto the blur stack, scaled per pixel
    by the vignette power.
    """
    _, h, w = view.shape
    uv = coords.uv_grid((h, w))
    power = 1.0 - vignette(uv, jnp.full((2,), MID), BOKEH_LIMIT,
                           jnp.asarray(BOKEH_FALLOFF, jnp.float32))

    col = view[:3]
    # Contrast boost for highlights — libs/bokeh/index.glsl:34.
    col2 = col * col * 1.5
    # libs/bokeh/index.glsl:27: `amount += radius*500` — the shader's
    # radius uniform is in px (its offsets are `texel·(r-1)·angle` UV).
    amt = amount * power + (radius * power) * 500.0
    # pow(x, 9) by squarings: XLA lowers float-exponent `pow` to exp·log —
    # 3 multiplies are cheaper at 4K×3ch and exact for the integer
    # exponent.
    c4 = col2 * col2
    c4 = c4 * c4
    wgt = c4 * c4 * col2 * amt[None] + 0.4

    num = blur_stack(jnp.concatenate([col2 * wgt, wgt]), radii, mats=mats)
    level = _matched_level(radius * power, radii, "bokeh")
    blurred = _stack_lerp(num, level)
    out = blurred[:3] / jnp.maximum(blurred[3:], 1e-6)
    return jnp.concatenate([out, view[3:4]])
