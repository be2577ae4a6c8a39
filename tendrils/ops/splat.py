"""Line-segment splatting — the replacement for GL line rasterisation.

The reference's scatter-reduce primitive is the rasteriser: each particle is
drawn as a GL_LINES segment from previous to current position, alpha-blended
into the flow FBO (`src/index.js:300-303`, `src/flow/vert/main.vert:10-18`)
and into the view/trail buffer (`src/index.js:335-337`). Here this becomes
an explicit scatter-add of sample points along each segment, followed by an
order-independent resolve of GL `SRC_ALPHA, ONE_MINUS_SRC_ALPHA` blending.

Blending semantics: GL alpha-blends fragments in submission order, which is
nondeterministic for overlapping fragments even on the reference (SURVEY §7
"hard parts"). We resolve order-independently:

    T      = prod_i (1 - a_i)                 (total transmittance)
    out_c  = dst_c * T + (sum_i c_i*a_i) / max(sum_i a_i, eps) * (1 - T)

which is exact for non-overlapping fragments (the common case) and the
standard weighted-blended approximation for overlaps.

Segment coverage: GL deposits src alpha once per covered pixel (~max(L,1)
pixels for a segment of length L px, times `lineWidth` rows). We place
`samples` points along the segment (static count), each bilinearly splatted
with alpha scaled by max(L,1)/samples, and `rows` perpendicular offsets to
emulate `lineWidth`/`flowWidth` (`src/index.js:302,336`).

The accumulation is XLA's `grid.at[idx].add()` scatter. On a GPU it lowers
to atomic adds, so the float summation order (and the last bits of each
accumulated texel) can change from run to run; on the CPU it is fixed.
"""

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-6


def segment_samples(p0_pix, p1_pix, alpha, samples, rows, width):
    """Expand segments into weighted sample points.

    `p0_pix`, `p1_pix`: `f32[N, 2]` endpoint pixel coords (window space).
    `alpha`: `f32[N]` per-segment source alpha.
    `samples`, `rows`: static ints. `width`: traced scalar (pixels).
    Returns (x `f32[M]`, y `f32[M]`, a `f32[M]`) with M = N*samples*rows.
    """
    d = p1_pix - p0_pix
    length = jnp.sqrt(jnp.sum(d * d, axis=-1))  # [N]
    inv_len = 1.0 / jnp.maximum(length, _EPS)
    # Perpendicular unit vector for line width rows.
    perp = jnp.stack([-d[:, 1], d[:, 0]], axis=-1) * inv_len[:, None]

    # Per-sample alpha so total deposit matches GL's alpha-per-covered-pixel:
    # GL's DDA lights one fragment per MAJOR-AXIS pixel (GL 2.0 §3.4.2), so
    # the deposit mass scales with the major extent, not euclidean length —
    # a diagonal line is ~1/√2 dimmer than an axis-aligned one of the same
    # length, and the flow feedback inherits that (measured:
    # tests/test_splat_oracle.py).
    major = jnp.maximum(jnp.abs(d[:, 0]), jnp.abs(d[:, 1]))
    a_s = alpha * jnp.maximum(major, 1.0) / samples  # [N]

    ts = (jnp.arange(samples, dtype=jnp.float32) + 0.5) / samples  # [samples]
    pts = p0_pix[:, None, :] + d[:, None, :] * ts[None, :, None]  # [N, S, 2]

    if rows > 1:
        # Rows span the line width; each row deposits over its own pixels.
        offs = (jnp.arange(rows, dtype=jnp.float32) - (rows - 1) / 2.0)
        offs = offs * (width / rows)  # [rows]
        pts = pts[:, :, None, :] + perp[:, None, None, :] * offs[None, None, :,
                                                                 None]
        a = jnp.broadcast_to(a_s[:, None, None], pts.shape[:3])
        # Mask rows beyond the (traced) width so narrow lines stay narrow.
        row_live = (jnp.abs(offs) * 2.0 <= jnp.maximum(width, 1.0)).astype(
            jnp.float32)
        a = a * row_live[None, None, :]
        pts = pts.reshape(-1, 2)
        a = a.reshape(-1)
    else:
        a = jnp.broadcast_to(a_s[:, None], pts.shape[:2]).reshape(-1)
        pts = pts.reshape(-1, 2)

    return pts[:, 0], pts[:, 1], a


def _bilinear_corners(x, y, h, w):
    """Bilinear splat footprint: 4 corner indices + weights + validity.

    Sample at window coords (x, y); pixel centres are at integer+0.5.
    Returns (flat_idx `i32[4, M]`, wgt `f32[4, M]`, valid `f32[4, M]`).
    """
    gx = x - 0.5
    gy = y - 0.5
    x0 = jnp.floor(gx)
    y0 = jnp.floor(gy)
    fx = gx - x0
    fy = gy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    wgt = jnp.stack([
        (1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy])
    xs = jnp.stack([x0i, x0i + 1, x0i, x0i + 1])
    ys = jnp.stack([y0i, y0i, y0i + 1, y0i + 1])
    valid = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h))
    xs = jnp.clip(xs, 0, w - 1)
    ys = jnp.clip(ys, 0, h - 1)
    return ys * w + xs, wgt, valid.astype(jnp.float32)


def splat_accumulate_xla(grid_hw, x, y, values, alpha):
    """Scatter-accumulate weighted samples.

    `values`: `f32[C, M]` payload channels; `alpha`: `f32[M]`.
    Returns (num `f32[C, H, W]` = sum val*a, wsum `f32[H, W]` = sum a,
    logt `f32[H, W]` = sum log(1-a)).
    """
    h, w = grid_hw
    idx, wgt, valid = _bilinear_corners(x, y, h, w)  # [4, M]
    a4 = (alpha[None, :] * wgt * valid).reshape(-1)  # [4*M]
    idxf = idx.reshape(-1)

    wsum = jnp.zeros((h * w,), jnp.float32).at[idxf].add(a4)
    # Transmittance accumulates as the bilinear-weighted log: a sample with
    # footprint weight w on a pixel contributes (1-alpha)^w — exact for
    # full-weight fragments, fractional-coverage semantics for partial ones.
    log1a = jnp.log1p(-jnp.minimum(alpha, 1.0 - 1e-4))
    logt = jnp.zeros((h * w,), jnp.float32).at[idxf].add(
        (log1a[None, :] * wgt * valid).reshape(-1))

    c = values.shape[0]
    vals4 = (values[:, None, :] * (alpha[None, None, :] * wgt * valid)[None]
             ).reshape(c, -1)
    num = jnp.zeros((c, h * w), jnp.float32).at[:, idxf].add(vals4)
    return (num.reshape(c, h, w), wsum.reshape(h, w), logt.reshape(h, w))


def composite_over(dst, num, wsum, logt):
    """Resolve accumulated splats over `dst: f32[C, H, W]` (order-independent
    GL `SRC_ALPHA, ONE_MINUS_SRC_ALPHA` — see module docstring)."""
    t = jnp.exp(logt)
    src = num / jnp.maximum(wsum, _EPS)
    return dst * t + src * (1.0 - t)


def composite_premultiplied(dst, num, wsum, logt):
    """Resolve for premultiplied-alpha accumulation targets: dst*T + sum(c*a).

    Used when the target holds premultiplied colour (the render/view pass
    sums premultiplied colours, `src/render/index.vert:84-90`)."""
    del wsum
    t = jnp.exp(logt)
    return dst * t + num


def splat_segments_accumulate(p0_pix, p1_pix, values, alpha, *, grid_hw,
                              width=1.0, samples=4, rows=1):
    """Accumulation half of the segment splat: expand segments into samples
    and scatter-add. Returns `(num, wsum, logt)` partial sums — these are
    linear in the particle set, so a data-parallel mesh `psum`s them across
    shards before the resolve (SURVEY §2.9: the flow scatter reduction is the
    sim's only cross-chip collective)."""
    x, y, a = segment_samples(p0_pix, p1_pix, alpha, samples, rows, width)
    reps = samples * rows
    vals = jnp.repeat(values, reps, axis=1)
    return splat_accumulate_xla(grid_hw, x, y, vals, a)


@functools.partial(
    jax.jit,
    static_argnames=("samples", "rows", "grid_hw", "premultiplied"))
def splat_segments(dst, p0_pix, p1_pix, values, alpha, *, grid_hw, width=1.0,
                   samples=4, rows=1, premultiplied=False):
    """Full segment-splat-and-blend op (accumulate + resolve in one call).

    `dst`: `f32[C, H, W]` target grid (blended over, NOT cleared — the flow
    FBO accumulates across frames, ref `src/index.js:300-303`).
    `p0_pix`/`p1_pix`: `f32[N, 2]` segment endpoints in window pixels.
    `values`: `f32[C, N]` payload; `alpha`: `f32[N]` source alpha.
    """
    num, wsum, logt = splat_segments_accumulate(
        p0_pix, p1_pix, values, alpha, grid_hw=grid_hw, width=width,
        samples=samples, rows=rows)
    resolve = composite_premultiplied if premultiplied else composite_over
    return resolve(dst, num, wsum, logt)
