"""Post-processing, optical-flow, flow-line and geometry tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from tendrils import EngineConfig, Tendrils
from tendrils.flow_line import FlowLine, FlowLines
from tendrils.geom import Line, polyline_normals
from tendrils.media import OpticalFlow, grid_to_image, image_to_grid
from tendrils.ops import post
from tendrils.ops.optical_flow import gray_scale, optical_flow


class TestBlend:
    def test_premultiplied_sum(self):
        # ref screen/blend/main.frag: sum of preAlpha(color, color.a*alpha)
        v1 = jnp.ones((4, 2, 2)) * jnp.asarray([1.0, 0, 0, 1.0])[:, None,
                                                                 None]
        v2 = jnp.ones((4, 2, 2)) * jnp.asarray([0, 1.0, 0, 0.5])[:, None,
                                                                 None]
        out = post.blend([v1, v2], jnp.asarray([1.0, 1.0]))
        np.testing.assert_allclose(np.asarray(out)[:, 0, 0],
                                   [1.0, 0.5, 0.0, 1.5], atol=1e-6)

    def test_alpha_scales(self):
        v = jnp.ones((4, 2, 2))
        out = post.blend([v], jnp.asarray([0.5]))
        np.testing.assert_allclose(np.asarray(out)[3], 0.5)


class TestBlur:
    def test_box_blur_preserves_mean(self):
        # The first stack level (two radius-2 boxes) is an averaging
        # operator: the mean survives up to the edge replication.
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.uniform(0, 1, (1, 32, 64)), jnp.float32)
        out = post.blur_stack(img, (3,))[1]
        assert abs(float(out.mean()) - float(img.mean())) < 1e-3

    def test_vignette_blur_edges_only(self):
        # Sharp impulse at centre stays sharper than one at the edge.
        img = jnp.zeros((4, 64, 64)).at[:, 32, 32].set(1.0).at[:, 4, 4].set(
            1.0)
        out = np.asarray(post.vignette_blur(img, radius=20.0, limit=0.5))
        assert out[0, 32, 32] > out[0, 4, 4]  # edge impulse spread out more

    def test_vignette_blur_hash_grain(self):
        # The blurred zones carry the reference's hash-noise grain
        # (`glsl-hash-blur`'s jittered taps, `screen/blur.frag:24-32`):
        # grain>0 differs from the smooth blur in blurred regions, is
        # deterministic, and leaves crisp (centre) pixels untouched.
        rng = np.random.default_rng(2)
        img = jnp.asarray(rng.uniform(0, 1, (4, 64, 64)), jnp.float32)
        # limit=1.0 keeps the centre at blur level 0 (vignette amount 0).
        smooth = np.asarray(post.vignette_blur(img, 20.0, 1.0, grain=0.0))
        grainy = np.asarray(post.vignette_blur(img, 20.0, 1.0, grain=0.75))
        grainy2 = np.asarray(post.vignette_blur(img, 20.0, 1.0, grain=0.75))
        np.testing.assert_array_equal(grainy, grainy2)  # deterministic
        corner_delta = np.abs(grainy[:3, :, :6, :6]
                              - smooth[:3, :, :6, :6]
                              if grainy.ndim == 4 else
                              grainy[:3, :6, :6] - smooth[:3, :6, :6]).mean()
        centre_delta = np.abs(grainy[:3, 30:34, 30:34]
                              - smooth[:3, 30:34, 30:34]).mean()
        assert corner_delta > 1e-4
        # The kernel-matched level LUT (ops/post._level_lut) gives sub-pixel
        # strengths a small but nonzero level (bilinear taps at 0.5 px DO
        # blur in the exact shader too), so the near-centre block carries a
        # little grain — it must still be well below the blurred corners.
        # Fidelity vs the exact shader is pinned in test_post_oracle.py.
        assert centre_delta < corner_delta * 0.5

    def test_bokeh_runs_and_preserves_alpha(self):
        rng = np.random.default_rng(1)
        img = jnp.asarray(rng.uniform(0, 1, (4, 32, 32)), jnp.float32)
        out = post.bokeh(img, radius=5.0, amount=40.0)
        assert out.shape == img.shape
        np.testing.assert_allclose(np.asarray(out[3]), np.asarray(img[3]))


class TestOpticalFlow:
    def test_moving_edge_produces_flow(self):
        # A bright vertical bar moving right between frames.
        h, w = 64, 64
        def frame(x0):
            img = np.zeros((4, h, w), np.float32)
            img[:3, :, x0:x0 + 6] = 1.0
            img[3] = 1.0
            return jnp.asarray(img)

        last, view = frame(20), frame(24)
        out = np.asarray(optical_flow(view, last, time=100.0, offset=0.05,
                                      speed=1.0, speed_limit=1.0))
        # Payload weight nonzero somewhere near the moving edge.
        assert out[3].max() > 0.0
        # Mean x-velocity over active texels is signed (motion detected).
        active = out[3] > 0.01
        assert active.sum() > 0
        assert abs(out[0][active].mean()) > 0

    def test_static_frames_no_flow(self):
        img = jnp.asarray(np.random.default_rng(0).uniform(
            0, 1, (4, 32, 32)), jnp.float32)
        out = np.asarray(optical_flow(img, img, time=0.0))
        np.testing.assert_allclose(out[0], 0.0, atol=1e-6)
        np.testing.assert_allclose(out[3], 0.0, atol=1e-6)

    def test_gray_scale_weights(self):
        img = jnp.ones((4, 1, 1)) * jnp.asarray([1.0, 0.5, 0.25, 1.0]
                                                )[:, None, None]
        assert float(gray_scale(img)[0, 0]) == pytest.approx(
            0.3 + 0.59 * 0.5 + 0.11 * 0.25)

    def test_wrapper_double_buffer(self):
        of = OpticalFlow({"offset": 0.05})
        f0 = np.zeros((8, 8, 3), np.uint8)
        f1 = np.full((8, 8, 3), 255, np.uint8)
        of.set_pixels(f0)
        of.step()
        of.set_pixels(f1)
        payload = of.update(time=16.0)
        assert payload.shape == (4, 8, 8)


class TestGeom:
    def test_straight_line_normals(self):
        n, m = polyline_normals([[0, 0], [1, 0], [2, 0]])
        np.testing.assert_allclose(np.abs(n[:, 1]), 1.0, atol=1e-6)
        np.testing.assert_allclose(m, 1.0, atol=1e-6)

    def test_right_angle_miter(self):
        # 90° corner: miter length = 1/cos(45°) = sqrt(2).
        n, m = polyline_normals([[0, 0], [1, 0], [1, 1]])
        assert m[1] == pytest.approx(np.sqrt(2), rel=1e-5)

    def test_line_vertices(self):
        line = Line(uniforms={"rad": 0.5}, path=[[0, 0], [1, 0]])
        line.update()
        verts = line.vertices()
        assert verts.shape == (4, 2)
        # Pairs straddle the path by ±rad.
        np.testing.assert_allclose(sorted(verts[:2, 1]), [-0.5, 0.5],
                                   atol=1e-6)


class TestFlowLine:
    def test_segments_velocity(self):
        fl = FlowLine({"speed": 2.0})
        fl.add(0.0, (0.0, 0.0))
        fl.add(10.0, (0.1, 0.0))
        p0, p1, vel, width = fl.flow_segments(10.0, (1.0, 1.0), (64, 64),
                                              crest_rows=1)
        assert p0.shape == (1, 2)
        # vel = (pos - prev) * speed / max(dt, 1) = 0.1*2/10
        assert vel[0, 0] == pytest.approx(0.02)
        assert width > 0

    def test_crest_rows_shape_velocity(self):
        # Ribbon rows: centre row keeps the full path velocity; outer rows
        # slow down (1-d) and bend toward the crest normal —
        # ref flow-line/index.frag:10-17.
        fl = FlowLine({"speed": 2.0, "crestShape": 0.6})
        fl.add(0.0, (0.0, 0.0))
        fl.add(10.0, (0.1, 0.0))
        p0, p1, vel, width = fl.flow_segments(10.0, (1.0, 1.0), (64, 64),
                                              crest_rows=5)
        assert p0.shape == (5, 2)
        speeds = np.linalg.norm(vel, axis=0)
        centre = 2  # middle row
        assert speeds[centre] == pytest.approx(0.02, rel=1e-5)
        assert (speeds[[0, -1]] < speeds[centre]).all()
        # Outer rows gain a perpendicular (y) component.
        assert abs(vel[1, 0]) > 0

    def test_trim_drops_old(self):
        fl = FlowLine()
        fl.add(0.0, (0, 0))
        fl.add(100.0, (1, 1))
        assert fl.trim(50.0, now=120.0) == 1
        assert fl.path == [(1, 1)]

    def test_multi_lazily_creates_and_deletes(self):
        fls = FlowLines()
        fls.get("a").add(0.0, (0, 0))
        fls.get("b").add(90.0, (0, 0))
        assert len(fls.active) == 2
        assert fls.trim(50.0, now=100.0) == 1
        assert "a" not in fls.active

    def test_engine_injection(self):
        eng = Tendrils(EngineConfig(root_num=16, view_res=(32, 64),
                                    flow_samples=2, flow_rows=1))
        eng.setup()
        fls = FlowLines()
        line = fls.get(1)
        for i in range(5):
            line.add(i * 16.0, (-0.5 + i * 0.25, 0.0))
        p0, p1, vel, width = fls.segments(eng.timer.time, eng._view_size,
                                          eng.config.flow_shape)
        eng.inject_flow_segments(p0, p1, vel, width)
        flow = np.asarray(eng.sim.flow)
        assert flow[3].max() > 0  # painted
        active = flow[3] > 1e-3
        assert flow[0][active].mean() > 0  # rightward stroke


class TestMediaConversions:
    def test_image_grid_roundtrip(self):
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, (8, 6, 4)).astype(np.float32)
        back = grid_to_image(image_to_grid(img))
        np.testing.assert_allclose(back, img, atol=1e-6)


def test_u8_feed_matches_f32():
    """uint8 camera frames ride the upload as u8 (4x fewer bytes) and are
    normalised on device — the resulting flow payload must equal the f32
    feed exactly (u8/255 is exact in f32)."""
    import numpy as np
    from tendrils.media import OpticalFlow
    from tendrils.ops.optical_flow import optical_flow

    rng = np.random.RandomState(11)
    img_u8 = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
    img2_u8 = np.roll(img_u8, 3, axis=1)

    of8 = OpticalFlow({"offset": 0.05, "speed": 0.1})
    of8.set_pixels(img_u8)
    of8.step()
    of8.set_pixels(img2_u8)
    cur8, last8 = of8.device_buffers()
    assert cur8.dtype == jnp.uint8 and last8.dtype == jnp.uint8

    off = OpticalFlow({"offset": 0.05, "speed": 0.1})
    off.set_pixels(img_u8.astype(np.float32) / 255.0)
    off.step()
    off.set_pixels(img2_u8.astype(np.float32) / 255.0)
    curf, lastf = off.device_buffers()

    p8 = optical_flow(cur8, last8, jnp.float32(8.0))
    pf = optical_flow(curf, lastf, jnp.float32(8.0))
    np.testing.assert_allclose(np.asarray(p8), np.asarray(pf), atol=1e-6)
