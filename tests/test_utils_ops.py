"""Tests for the small GLSL/FP utility twins and physics integrators."""

import jax.numpy as jnp
import numpy as np
import pytest

from tendrils.ops import glsl_utils as g
from tendrils.ops import physics
from tendrils.ops.spawn import test_simple as simple_score
from tendrils.utils import fp


class TestPhysics:
    def test_euler_roundtrip(self):
        pos1 = physics.euler(2.0, 1.0, 0.5)
        assert pos1 == 2.0
        assert physics.euler_dy_dt(1.0, pos1, 0.5) == 2.0

    def test_verlet_constant_velocity(self):
        # Zero acceleration: uniform motion continues.
        assert physics.verlet(0.0, 0.0, 1.0, 1.0) == 2.0
        # Inverse recovers acceleration.
        p2 = physics.verlet(3.0, 0.0, 1.0, 0.5)
        assert physics.verlet_dy_dt(0.0, 1.0, p2, 0.5) == pytest.approx(3.0)


class TestGlslUtils:
    def test_length2_perp(self):
        v = jnp.asarray([[3.0, 4.0]])
        assert float(g.length2(v)[0]) == 25.0
        np.testing.assert_allclose(g.perp(v)[0], [-4.0, 3.0])
        np.testing.assert_allclose(g.perp(v, True)[0], [4.0, -3.0])

    def test_nilish(self):
        assert bool(g.nilish(jnp.asarray([1e-6, 0.0])))
        assert not bool(g.nilish(jnp.asarray([1e-3, 0.0])))

    def test_transform(self):
        m = jnp.asarray([[2.0, 0, 1.0], [0, 2.0, -1.0], [0, 0, 1.0]])
        out = g.transform(m, jnp.asarray([[1.0, 1.0]]))
        np.testing.assert_allclose(out[0], [3.0, 1.0])

    def test_point_in_box(self):
        box = jnp.asarray([0.0, 0.0, 1.0, 1.0])
        assert float(g.point_in_box(jnp.asarray([0.5, 0.5]), box)) == 1.0
        assert float(g.point_in_box(jnp.asarray([2.0, 0.5]), box)) == 0.0

    def test_line_sdf(self):
        d = g.line_sdf(jnp.asarray([0.5, 1.0]), jnp.asarray([0.0, 0.0]),
                       jnp.asarray([1.0, 0.0]), 0.25)
        assert float(d) == pytest.approx(0.75)

    def test_hsv_roundtrip(self):
        rgb = jnp.asarray([[1.0, 0.25, 0.5], [0.0, 1.0, 0.0]])
        back = g.hsv_to_rgb(g.rgb_to_hsv(rgb))
        np.testing.assert_allclose(back, rgb, atol=1e-5)

    def test_simple_score(self):
        data = jnp.asarray([[0.7], [0.1], [0.2], [0.3]])
        assert float(simple_score(data)[0]) == pytest.approx(0.7)


class TestFP:
    def test_map_reduce_filter(self):
        out = fp.map_obj(lambda v, k: v * 2, {"a": 1, "b": 2})
        assert out == {"a": 2, "b": 4}
        assert fp.reduce_obj(lambda a, v, k: (a or 0) + v, [1, 2, 3]) == 6
        assert fp.filter_obj(lambda v, k: v > 1, {"a": 1, "b": 2}) == {
            "b": 2}

    def test_compose_curry(self):
        f = fp.compose(lambda x: x + 1, lambda x: x * 2)
        assert f(3) == 7  # right-to-left
        add3 = fp.curry(lambda a, b, c: a + b + c)
        assert add3(1)(2)(3) == 6
        assert add3(1, 2)(3) == 6


class TestProfiling:
    def test_frame_profiler_sections(self):
        import jax.numpy as jnp

        from tendrils.utils.profiling import FrameProfiler
        prof = FrameProfiler(history=4)
        for _ in range(3):
            prof.begin_frame()
            with prof.section("work", jnp.ones(8) * 2.0):
                pass
            with prof.section("boxed") as box:
                box["result"] = jnp.arange(4) + 1
            prof.end_frame()
        s = prof.summary()
        assert s["work"]["count"] == 3 and s["boxed"]["count"] == 3
        assert s["frame"]["mean"] >= s["work"]["mean"] >= 0.0
        assert "work" in prof.report()
