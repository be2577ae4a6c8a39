"""Unit tests for device ops against pure-math oracles (SURVEY §4: the
reference has no tests; kernel oracles follow its JS/GLSL twin functions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tendrils.const import INERT
from tendrils.ops import coords, filters, flow, logic, sample, spawn
from tendrils.ops.noise import snoise3
from tendrils.ops.rand import glsl_random


class TestNoise:
    def test_range_and_determinism(self):
        pts = jax.random.uniform(jax.random.PRNGKey(0), (4096, 3),
                                 minval=-10, maxval=10)
        v = snoise3(pts)
        assert v.shape == (4096,)
        assert np.all(np.abs(np.asarray(v)) <= 1.05)
        assert np.allclose(v, snoise3(pts))
        # Non-degenerate field.
        assert np.std(np.asarray(v)) > 0.1

    def test_continuity(self):
        p = jnp.asarray([[0.3, 0.7, 1.1]])
        eps = 1e-3
        dp = jnp.asarray([[eps, 0.0, 0.0]])
        a, b = snoise3(p), snoise3(p + dp)
        assert abs(float(a[0] - b[0])) < 0.05

    def test_batch_shapes(self):
        v = snoise3(jnp.zeros((3, 5, 3)))
        assert v.shape == (3, 5)


class TestRandom:
    def test_glsl_hash(self):
        co = jax.random.uniform(jax.random.PRNGKey(1), (1000, 2)) * 100
        v = np.asarray(glsl_random(co))
        assert np.all((v >= 0) & (v < 1))
        # Matches the packaged formula (incl. its mod(dt, 3.14) reduction).
        d = np.asarray(co[:, 0]) * 12.9898 + np.asarray(co[:, 1]) * 78.233
        d = np.mod(d.astype(np.float32), np.float32(3.14))
        exp = np.sin(d) * np.float32(43758.5453)
        exp = exp - np.floor(exp)
        np.testing.assert_allclose(v, exp, atol=2e-2)


class TestCoords:
    def test_pos_uv_roundtrip(self):
        p = jnp.asarray([[-1.0, -1.0], [0.0, 0.5], [1.0, 1.0]])
        np.testing.assert_allclose(coords.uv_to_pos(coords.pos_to_uv(p)), p,
                                   atol=1e-6)

    def test_cover_aspect(self):
        # ref src/utils/aspect.js: max(size)/size
        np.testing.assert_allclose(coords.cover_aspect((1280, 720)),
                                   [1.0, 1280 / 720])

    def test_uv_grid_centres(self):
        g = coords.uv_grid((2, 4))
        np.testing.assert_allclose(g[0, 0], [0.125, 0.25])
        np.testing.assert_allclose(g[1, 3], [0.875, 0.75])


class TestSample:
    def test_bilinear_matches_manual(self):
        grid = jnp.arange(2 * 4 * 4, dtype=jnp.float32).reshape(2, 4, 4)
        # Sample exactly at texel centre (1,2) -> texel value.
        out = sample.bilinear_sample(grid, jnp.asarray([2.5]),
                                     jnp.asarray([1.5]))
        np.testing.assert_allclose(out[:, 0], grid[:, 1, 2], atol=1e-6)
        # Midpoint between two texels.
        out = sample.bilinear_sample(grid, jnp.asarray([3.0]),
                                     jnp.asarray([1.5]))
        np.testing.assert_allclose(out[:, 0],
                                   (grid[:, 1, 2] + grid[:, 1, 3]) / 2,
                                   atol=1e-6)

    def test_clamp_to_edge(self):
        grid = jnp.ones((1, 4, 4))
        out = sample.bilinear_sample(grid, jnp.asarray([-5.0, 50.0]),
                                     jnp.asarray([-5.0, 50.0]))
        np.testing.assert_allclose(out, 1.0)


class TestFlow:
    def test_payload(self):
        vel = jnp.asarray([[0.003, 0.0], [0.004, 0.0]])  # [2, N=2]
        p = flow.flow_payload(vel, 123.0, 0.01)
        np.testing.assert_allclose(p[0], [0.003, 0.0])
        np.testing.assert_allclose(p[2], [123.0, 123.0])
        np.testing.assert_allclose(p[3], [0.5, 0.0], atol=1e-6)

    def test_decay_on_read(self):
        # ref src/flow/get.glsl: vel * max(0, 1-(time-stamp)*decay)
        data = jnp.asarray([[1.0], [2.0], [100.0], [1.0]])
        out = flow.flow_decayed(data, 150.0, 0.005)
        np.testing.assert_allclose(out[:, 0], [0.75, 1.5], atol=1e-6)
        # Fully decayed.
        out = flow.flow_decayed(data, 400.0, 0.005)
        np.testing.assert_allclose(out[:, 0], [0.0, 0.0])

    def test_level_weighting(self):
        g0 = jnp.zeros((4, 8, 8)).at[0].set(1.0).at[3].set(1.0)
        g1 = jnp.zeros((4, 8, 8)).at[0].set(3.0).at[3].set(1.0)
        pos = jnp.zeros((1, 2))
        out = flow.flow_at_screen_pos(pos, [g0, g1], 0.0, 0.0)
        # weights 1, 1/2 -> (1*1 + 3*0.5) / 1.5
        np.testing.assert_allclose(out[0, 0], (1 + 1.5) / 1.5, rtol=1e-6)


class TestFilters:
    def test_bezier_linear(self):
        assert float(filters.bezier([0.0, 1.0], 0.25)) == pytest.approx(0.25)

    def test_bezier_quad_endpoints(self):
        for t, v in [(0.0, 0.1), (1.0, 0.9)]:
            assert float(filters.bezier([0.1, 0.5, 0.9], t)) == pytest.approx(
                v)

    def test_vignette(self):
        centre = jnp.zeros((1, 2))
        assert float(filters.vignette(centre, jnp.zeros(2), 1.0)[0]) == 1.0
        far = jnp.asarray([[3.0, 0.0]])
        assert float(filters.vignette(far, jnp.zeros(2), 1.0)[0]) == 0.0


def _params():
    from tendrils.engine import default_params
    return default_params()


class TestLogic:
    def test_inert_particles_stay(self):
        n = 64
        particles = jnp.concatenate([
            jnp.full((2, n), INERT), jnp.zeros((2, n))])
        flows = [jnp.zeros((4, 8, 8))]
        targets = jnp.zeros((4, n))
        uv = jnp.zeros((2, n))
        idx = jnp.zeros((n,))
        out = logic.step_particles(particles, flows, targets, _params(), uv,
                                   idx, jnp.ones(2), 100.0, 16.0)
        np.testing.assert_allclose(out, particles)

    def test_speed_clamp(self):
        # A particle pulled hard by targets must not exceed speedLimit.
        n = 8
        particles = jnp.zeros((4, n))
        flows = [jnp.zeros((4, 8, 8))]
        targets = jnp.ones((4, n)) * 0.9
        p = _params()
        p = dict(p, target=jnp.float32(10.0), varyTarget=jnp.float32(0.0),
                 noiseWeight=jnp.float32(0.0))
        uv = jnp.zeros((2, n))
        idx = jnp.zeros((n,))
        out = logic.step_particles(particles, flows, targets, p, uv, idx,
                                   jnp.ones(2), 0.0, 16.0)
        speed = np.sqrt(np.asarray(out[2]) ** 2 + np.asarray(out[3]) ** 2)
        assert np.all(speed <= float(p["speedLimit"]) + 1e-6)

    def test_flow_force_moves_particles(self):
        n = 16
        particles = jnp.zeros((4, n))
        # Constant rightward flow, fresh stamp, full weight.
        g = jnp.zeros((4, 16, 16)).at[0].set(0.01).at[3].set(1.0)
        p = _params()
        p = dict(p, noiseWeight=jnp.float32(0.0), varyNoise=jnp.float32(0.0),
                 varyFlow=jnp.float32(0.0), varyForce=jnp.float32(0.0))
        uv = jnp.zeros((2, n))
        idx = jnp.zeros((n,))
        out = logic.step_particles(particles, [g], jnp.zeros((4, n)), p, uv,
                                   idx, jnp.ones(2), 0.0, 16.0)
        assert np.all(np.asarray(out[0]) > 0)  # moved right
        np.testing.assert_allclose(out[1], 0.0, atol=1e-7)

    def test_vary(self):
        # ref src/logic.frag:41-43
        assert float(logic.vary(2.0, 0.5, 0.3)) == pytest.approx(2.3)


class TestSpawn:
    def test_init(self):
        out = spawn.init(jnp.ones((4, 32)))
        assert np.all(np.asarray(out[:2]) == INERT)
        assert np.all(np.asarray(out[2:]) == 0)

    def test_ball_within_radius(self):
        n = 64 * 64
        frag = jnp.stack([
            jnp.tile(jnp.arange(64, dtype=jnp.float32) + 0.5, 64),
            jnp.repeat(jnp.arange(64, dtype=jnp.float32) + 0.5, 64)])
        out = spawn.ball(jnp.zeros((4, n)), frag, 0.5, 0.01)
        r = np.sqrt(np.asarray(out[0]) ** 2 + np.asarray(out[1]) ** 2)
        s = np.sqrt(np.asarray(out[2]) ** 2 + np.asarray(out[3]) ** 2)
        assert np.all(r <= 0.5 + 1e-5)
        assert np.all(s <= 0.01 + 1e-6)
        # Deterministic (same hash every respawn, like the GPU shader).
        out2 = spawn.ball(jnp.zeros((4, n)), frag, 0.5, 0.01)
        np.testing.assert_allclose(out, out2)
        # Roughly fills the disc.
        assert np.mean(r) > 0.1

    def test_best_sample_keeps_faster(self):
        # With test=length2(vel) and bias=1, a zero-velocity spawnData can
        # never replace a fast particle.
        n = 256
        particles = jnp.zeros((4, n)).at[2].set(1.0)
        spawn_data = jnp.zeros((4, 8, 8))
        uv = jnp.stack([jnp.linspace(0, 1, n), jnp.linspace(0, 1, n)],
                       axis=-1)
        out = spawn.pixels_best_sample(
            particles, spawn_data, uv, apply_fn=spawn.apply_particles,
            test_fn=spawn.test_particles, samples=3, bias=1.0, speed=1.0,
            spawn_matrix=jnp.eye(3), spawn_size=jnp.ones(2),
            jitter=jnp.zeros(2), time=0.0)
        np.testing.assert_allclose(out, particles)

    def test_rasterize_triangles(self):
        tris = jnp.asarray([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]])
        img = spawn.rasterize_triangles(tris, (32, 32), jnp.ones(2))
        arr = np.asarray(img[3])
        # Lower-left half-ish of upper-right quadrant filled.
        assert arr.sum() > 0
        assert arr[20, 20] >= 0  # inside region indices valid
        # A texel clearly inside: clip (0.2, 0.2) -> uv (0.6, 0.6)
        assert arr[int(0.6 * 32), int(0.6 * 32)] == 1.0
        # Clearly outside (clip (-0.5, -0.5)).
        assert arr[int(0.25 * 32), int(0.25 * 32)] == 0.0


class TestFlowPyramid:
    def test_multi_level_sampling(self):
        # flow_levels > 1 builds a mean-pooled LOD pyramid and the sampler
        # weights levels 1/(l+1) — ref flow-at-screen-pos.glsl (the
        # reference's intended-but-disabled mipmap path, index.js:305-312).
        import jax.numpy as jnp
        from tendrils.engine import flow_pyramid
        g = jnp.zeros((4, 8, 8)).at[0, 0:2, 0:2].set(4.0)
        levels = flow_pyramid(g, 3)
        assert [l.shape for l in levels] == [(4, 8, 8), (4, 4, 4),
                                             (4, 2, 2)]
        assert float(levels[1][0, 0, 0]) == 4.0  # 2x2 pool of the block
        assert float(levels[2][0, 0, 0]) == 1.0  # next pool dilutes 4/16

    def test_engine_runs_with_levels(self):
        from tendrils import EngineConfig, Tendrils
        from tendrils.ops import spawn as sp
        eng = Tendrils(EngineConfig(root_num=16, view_res=(32, 64),
                                    flow_levels=2, flow_samples=2,
                                    flow_rows=1, view_samples=2))
        eng.setup()
        eng.spawn_shader(lambda p, e: sp.ball(p, e._frag_xy, 0.5, 0.01))
        for _ in range(3):
            eng.frame()
        assert np.isfinite(np.asarray(eng.sim.particles)).all()
