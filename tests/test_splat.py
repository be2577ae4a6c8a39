"""Splat op tests: scatter accumulation + order-independent blend resolve
against sequential GL-blending oracles (SURVEY §7 "hard parts": flow scatter
order-dependence is resolved order-independently; exact for non-overlapping
fragments)."""

import jax.numpy as jnp
import numpy as np

from tendrils.ops import splat


def test_point_splat_bilinear_weights():
    # One sample exactly at a pixel centre deposits fully in that pixel.
    x = jnp.asarray([2.5])
    y = jnp.asarray([1.5])
    vals = jnp.asarray([[7.0]])
    num, wsum, logt = splat.splat_accumulate_xla((4, 8), x, y, vals,
                                                 jnp.asarray([0.5]))
    assert float(wsum[1, 2]) == 0.5
    assert float(num[0, 1, 2]) == 3.5
    assert float(wsum.sum()) == 0.5  # nothing leaked


def test_point_splat_corner_split():
    # A sample at a pixel corner splits 4 ways.
    num, wsum, _ = splat.splat_accumulate_xla(
        (4, 8), jnp.asarray([2.0]), jnp.asarray([2.0]),
        jnp.asarray([[1.0]]), jnp.asarray([1.0]))
    w = np.asarray(wsum)
    np.testing.assert_allclose(w[1:3, 1:3], 0.25)
    np.testing.assert_allclose(w.sum(), 1.0)


def test_composite_single_fragment_matches_gl():
    # Non-overlapping fragment: out = src*a + dst*(1-a) exactly.
    dst = jnp.full((3, 2, 2), 0.4)
    x = jnp.asarray([0.5])
    y = jnp.asarray([0.5])
    a = 0.25
    src = jnp.asarray([[0.9], [0.1], [0.5]])
    num, wsum, logt = splat.splat_accumulate_xla((2, 2), x, y, src,
                                                 jnp.asarray([a]))
    out = splat.composite_over(dst, num, wsum, logt)
    expected = np.asarray(src[:, 0]) * a + 0.4 * (1 - a)
    np.testing.assert_allclose(np.asarray(out)[:, 0, 0], expected, rtol=1e-5)
    # Untouched pixels unchanged.
    np.testing.assert_allclose(np.asarray(out)[:, 1, 1], 0.4, rtol=1e-6)


def test_composite_overlap_statistical():
    # Many overlapping fragments vs sequential GL blending in random order:
    # the OIT resolve should land near the order-averaged result.
    rng = np.random.default_rng(0)
    m = 64
    alphas = rng.uniform(0.05, 0.3, m).astype(np.float32)
    colors = rng.uniform(0, 1, m).astype(np.float32)
    dst0 = 0.5

    # Sequential oracle, averaged over shuffles.
    outs = []
    for _ in range(50):
        order = rng.permutation(m)
        acc = dst0
        for i in order:
            acc = colors[i] * alphas[i] + acc * (1 - alphas[i])
        outs.append(acc)
    oracle = np.mean(outs)

    x = jnp.full((m,), 0.5)
    y = jnp.full((m,), 0.5)
    num, wsum, logt = splat.splat_accumulate_xla(
        (1, 1), x, y, jnp.asarray(colors)[None], jnp.asarray(alphas))
    out = splat.composite_over(jnp.full((1, 1, 1), dst0), num, wsum, logt)
    assert abs(float(out[0, 0, 0]) - oracle) < 0.05


def test_segment_samples_deposit_total():
    # Total deposited alpha ~ alpha * max(length_px, 1).
    p0 = jnp.asarray([[10.0, 10.0]])
    p1 = jnp.asarray([[20.0, 10.0]])
    a = jnp.asarray([0.5])
    x, y, aa = splat.segment_samples(p0, p1, a, samples=8, rows=1, width=1.0)
    np.testing.assert_allclose(np.asarray(aa).sum(), 0.5 * 10.0, rtol=1e-5)
    # Stationary particle still deposits ~alpha (1 covered pixel).
    x, y, aa = splat.segment_samples(p0, p0, a, samples=8, rows=1, width=1.0)
    np.testing.assert_allclose(np.asarray(aa).sum(), 0.5, rtol=1e-5)


def test_segment_splat_lands_on_line():
    dst = jnp.zeros((4, 32, 32))
    p0 = jnp.asarray([[4.5, 16.5]])
    p1 = jnp.asarray([[28.5, 16.5]])
    vals = jnp.ones((4, 1))
    out = splat.splat_segments(dst, p0, p1, vals, jnp.asarray([0.9]),
                               grid_hw=(32, 32), samples=16)
    arr = np.asarray(out[0])
    # Deposits on row 16, nowhere else.
    assert arr[16].sum() > 0.5
    mask = np.ones((32, 32), bool)
    mask[15:18] = False
    assert arr[mask].sum() == 0


def test_rows_widen_line():
    dst = jnp.zeros((1, 32, 32))
    p0 = jnp.asarray([[4.5, 16.5]])
    p1 = jnp.asarray([[28.5, 16.5]])
    out = splat.splat_segments(dst, p0, p1, jnp.ones((1, 1)),
                               jnp.asarray([0.9]), grid_hw=(32, 32),
                               samples=16, rows=5, width=5.0)
    arr = np.asarray(out[0])
    rows_hit = np.where(arr.sum(axis=1) > 1e-3)[0]
    assert rows_hit.min() <= 15 and rows_hit.max() >= 18
