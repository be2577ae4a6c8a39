"""Measured acceptance of the segment splat against the exact GL_LINES
rasteriser (tests/gl_line_oracle.py — the reference's draw primitive,
`src/index.js:300-303,335-337`, with its SRC_ALPHA/ONE_MINUS_SRC_ALPHA
blending).

Pins the deposit parity the XLA splat achieves, and the residual deviations:

  - deposit mass scales with the MAJOR-AXIS extent like the GL DDA (the
    euclidean-length scaling used before over-deposited diagonals by √2);
  - the bilinear point-sample footprint spreads coverage over fractional
    pixels, inflating the concave `1-∏(1-a)` coverage sum by ~5-14% for
    long lines (angle-independent; documented, asserted bounded);
  - sub-pixel placement differs from the hard pen (spatial correlation
    pinned, not exactness).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tendrils.ops import splat
from gl_line_oracle import gl_lines_exact

H = W = 64


def ours_coverage(p0, p1, alpha, width, samples=4, rows=1):
    vals = jnp.ones((1, p0.shape[0]), jnp.float32)
    _, _, logt = splat.splat_segments_accumulate(
        jnp.asarray(p0), jnp.asarray(p1), vals, jnp.asarray(alpha),
        grid_hw=(H, W), width=float(width), samples=samples, rows=rows)
    return 1.0 - np.exp(np.asarray(logt))


def gl_coverage(p0, p1, alpha, width):
    dst = np.zeros((1, H, W), np.float32)
    _, cov = gl_lines_exact(dst, p0, p1,
                            np.ones((1, len(alpha)), np.float32),
                            np.asarray(alpha, np.float32), width)
    return cov


def test_long_line_mass_angle_independent():
    """GL's major-axis pen makes mass ∝ major extent; the splat matches, so
    the ours/GL mass ratio is flat in angle (within the bilinear-spread
    inflation band ~1.0-1.15) — before the major-extent fix the 45° ratio
    was 1.58."""
    ratios = []
    for deg in (0, 15, 30, 45, 60, 75, 90):
        th = np.radians(deg)
        c = np.array([[32.0, 32.0]], np.float32)
        d = np.array([[np.cos(th), np.sin(th)]], np.float32) * 10
        a = np.array([0.3], np.float32)
        mo = ours_coverage(c - d, c + d, a, 1, samples=16).sum()
        mg = gl_coverage(c - d, c + d, a, 1).sum()
        ratios.append(mo / mg)
    ratios = np.asarray(ratios)
    assert ratios.max() < 1.2, ratios
    assert ratios.min() > 0.95, ratios
    assert ratios.max() / ratios.min() < 1.12, \
        f"angle-dependent deposit mass: {ratios}"


def test_short_segment_batch_mass_matches_gl():
    """200 random sub-4px segments (the per-frame regime) at production
    sample counts: total coverage mass within 5% of the GL rasteriser,
    spatial correlation of the coverage maps > 0.8."""
    rng = np.random.RandomState(0)
    n = 200
    p0 = rng.uniform(10, 54, (n, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    ln = rng.uniform(0.2, 4.0, n)
    p1 = (p0 + np.stack([np.cos(ang), np.sin(ang)], -1)
          * ln[:, None]).astype(np.float32)
    a = rng.uniform(0.05, 0.5, n).astype(np.float32)
    mo = ours_coverage(p0, p1, a, 1, samples=4)
    mg = gl_coverage(p0, p1, a, 1)
    assert abs(mo.sum() / mg.sum() - 1.0) < 0.05
    assert np.corrcoef(mo.ravel(), mg.ravel())[0, 1] > 0.8


def test_wide_line_cross_section_matches_pen():
    """Width-3 horizontal line at production flow params (samples=4,
    rows=3): the coverage cross-section occupies the same 3 rows as the GL
    pen, with per-pixel alpha within 10%."""
    p0 = np.array([[12.0, 32.5]], np.float32)
    p1 = np.array([[52.0, 32.5]], np.float32)
    a = np.array([0.3], np.float32)
    co = ours_coverage(p0, p1, a, 3, samples=16, rows=3)
    cg = gl_coverage(p0, p1, a, 3)
    col_o = co[:, 32]
    col_g = cg[:, 32]
    assert (col_o > 0.05).sum() == 3
    assert (col_g > 0.05).sum() == 3
    np.testing.assert_allclose(col_o[31:34], col_g[31:34], rtol=0.1)


def test_gl_oracle_sanity():
    """The oracle itself: a horizontal width-1 line lights exactly one row,
    one fragment per column, src-alpha composited."""
    p0 = np.array([[10.0, 20.5]], np.float32)
    p1 = np.array([[20.0, 20.5]], np.float32)
    cov = gl_coverage(p0, p1, np.array([0.4], np.float32), 1)
    assert cov[20, 10:20].tolist() == [np.float32(0.4)] * 10
    assert cov.sum() == np.float32(0.4) * 10


def _coverage(grid_hw, p0, p1, alpha, width, samples, rows):
    vals = jnp.ones((1, p0.shape[0]), jnp.float32)
    _, _, logt = splat.splat_segments_accumulate(
        jnp.asarray(p0), jnp.asarray(p1), vals, jnp.asarray(alpha),
        grid_hw=grid_hw, width=float(width), samples=samples, rows=rows)
    ours = 1.0 - np.exp(np.asarray(logt))
    _, gl = gl_lines_exact(np.zeros((1, *grid_hw), np.float32), p0, p1,
                           np.ones((1, len(alpha)), np.float32),
                           np.asarray(alpha, np.float32), width)
    return ours, gl


def _segments(rng, n, grid_hw, margin, length):
    h, w = grid_hw
    p0 = np.stack([rng.uniform(-margin, w + margin, n),
                   rng.uniform(-margin, h + margin, n)],
                  -1).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    ln = rng.uniform(*length, n)
    p1 = (p0 + np.stack([np.cos(ang), np.sin(ang)], -1)
          * ln[:, None]).astype(np.float32)
    return p0, p1


# The XLA scatter splat against the GL pen over the static sampling
# (samples along, rows across), traced line widths, grid shapes that are
# not multiples of 128 and segments across every edge. Each case pins the
# coverage-mass ratio band and the least spatial correlation measured over
# six seeds, widened by ~0.03. Two cases pin known deviations of the
# sampling rather than parity: 2 samples on 2-8 px segments over-deposit
# by ~1.5-1.7x (each sample carries half the segment's alpha, which the
# transmittance product compounds), and 3 rows at width 2 light 3 rows
# where the GL pen lights 2 (~1.4x).
@pytest.mark.parametrize(
    "grid_hw,samples,rows,width,length,margin,mass,min_corr", [
        ((64, 64), 4, 1, 1, (0.2, 4.0), 0, (0.97, 1.07), 0.82),
        ((64, 64), 2, 1, 1, (0.2, 2.0), 0, (0.97, 1.09), 0.78),
        ((64, 64), 8, 1, 1, (2.0, 8.0), 0, (0.97, 1.05), 0.84),
        ((64, 64), 2, 1, 1, (2.0, 8.0), 0, (1.45, 1.72), 0.56),
        ((45, 77), 4, 1, 1, (0.2, 4.0), 0, (0.97, 1.09), 0.81),
        ((37, 129), 4, 1, 1, (0.2, 4.0), 0, (0.96, 1.07), 0.82),
        ((130, 50), 4, 1, 1, (0.2, 4.0), 0, (0.98, 1.06), 0.82),
        ((45, 77), 4, 3, 3, (0.2, 4.0), 0, (0.95, 1.06), 0.80),
        ((64, 64), 4, 3, 3, (2.0, 8.0), 0, (1.05, 1.13), 0.83),
        ((64, 64), 4, 3, 2, (0.2, 4.0), 0, (1.37, 1.47), 0.83),
        ((64, 64), 4, 5, 5, (0.2, 4.0), 0, (0.95, 1.03), 0.76),
        ((64, 64), 4, 1, 1, (0.2, 4.0), 8, (0.96, 1.09), 0.81),
        ((45, 77), 4, 1, 1, (0.2, 4.0), 8, (0.97, 1.06), 0.81),
        ((45, 77), 4, 3, 3, (0.2, 4.0), 8, (0.94, 1.04), 0.79),
        ((37, 129), 2, 1, 1, (0.2, 2.0), 8, (0.99, 1.11), 0.78),
        ((64, 64), 4, 1, 1, (0.2, 4.0), 40, (0.98, 1.12), 0.80),
    ])
def test_splat_matches_gl_pen(grid_hw, samples, rows, width, length, margin,
                              mass, min_corr):
    rng = np.random.RandomState(0)
    p0, p1 = _segments(rng, 300, grid_hw, margin, length)
    a = rng.uniform(0.05, 0.5, len(p0)).astype(np.float32)
    ours, gl = _coverage(grid_hw, p0, p1, a, width, samples, rows)
    assert ours.shape == gl.shape == grid_hw
    assert np.isfinite(ours).all()
    ratio = ours.sum() / gl.sum()
    assert mass[0] < ratio < mass[1], ratio
    assert np.corrcoef(ours.ravel(), gl.ravel())[0, 1] > min_corr


def test_splat_off_grid_segments_deposit_nothing():
    """Segments wholly outside the grid (with their line width) leave no
    coverage: out-of-range bilinear corners are masked, not clamped onto
    the border."""
    p0 = np.array([[-20.0, 10.0], [10.0, -20.0], [90.0, 30.0],
                   [30.0, 90.0]], np.float32)
    p1 = p0 + np.float32(3.0)
    a = np.full(4, 0.5, np.float32)
    ours, gl = _coverage((64, 64), p0, p1, a, 3, 4, 3)
    assert ours.max() == 0.0
    assert gl.max() == 0.0
