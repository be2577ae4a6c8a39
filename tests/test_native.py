"""C++ native module vs the numpy twins."""

import numpy as np
import pytest

native = pytest.importorskip("tendrils.native")


def test_builds_and_loads():
    native._load()


def test_polyline_normals_matches_numpy():
    # Compare against the pure-numpy implementation (bypass the native
    # dispatch inside geom by calling the fallback path logic directly).
    from tendrils import geom

    rng = np.random.default_rng(0)
    path = rng.uniform(-1, 1, (64, 2))

    n_nat, m_nat = native.polyline_normals(path, False)

    # numpy fallback (force it)
    saved = geom._native
    geom._native = None
    try:
        n_np, m_np = geom.polyline_normals(path, False)
    finally:
        geom._native = saved

    np.testing.assert_allclose(n_nat, n_np, atol=1e-5)
    np.testing.assert_allclose(m_nat, m_np, atol=1e-5)


def test_polyline_normals_closed():
    path = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    n, m = native.polyline_normals(path, True)
    # Square corners: all miters sqrt(2).
    np.testing.assert_allclose(m, np.sqrt(2), rtol=1e-5)


def test_fill_ribbon():
    path = np.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    times = np.asarray([0.0, 10.0, 20.0])
    verts, vels = native.fill_ribbon(path, times, rad=0.5, speed=2.0)
    assert verts.shape == (6, 2)
    assert vels.shape == (3, 2)
    # Straight line: vertices at y = ±0.5.
    np.testing.assert_allclose(sorted(verts[:2, 1]), [-0.5, 0.5], atol=1e-6)
    # vel = (pos - prev) * speed / max(dt, 1) = 1*2/10.
    np.testing.assert_allclose(vels[1], [0.2, 0.0], atol=1e-6)


def test_log_rates():
    last = np.asarray([1.0, 2.0], np.float32)
    cur = np.asarray([3.0, 2.0], np.float32)
    out = native.log_rates(last, cur, 2.0)
    np.testing.assert_allclose(out, [1.0, 0.0])
