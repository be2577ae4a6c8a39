"""Engine integration tests: end-to-end frames, feedback loop, spawn targets,
determinism at fixed timestep (SURVEY §4 golden-trajectory strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tendrils import EngineConfig, Tendrils
from tendrils.const import INERT
from tendrils.ops import spawn


def small_engine(**kw):
    cfg = dict(root_num=32, view_res=(48, 64), flow_samples=2, flow_rows=1,
               view_samples=2)
    cfg.update(kw)
    eng = Tendrils(EngineConfig(**cfg))
    eng.timer.step = 1000.0 / 60.0
    eng.setup()
    return eng


def ball_spawner(radius=0.5, speed=0.01):
    def op(particles, eng):
        return spawn.ball(particles, eng._frag_xy, radius, speed)
    return op


class TestEngine:
    def test_initial_state_inert(self):
        eng = small_engine()
        assert np.all(np.asarray(eng.sim.particles[:2]) == INERT)

    def test_frames_advance_particles(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner())
        p0 = np.asarray(eng.sim.particles)
        for _ in range(3):
            eng.frame()
        p1 = np.asarray(eng.sim.particles)
        assert not np.allclose(p0[:2], p1[:2])
        # All particles remain alive and within speed limit.
        speed = np.sqrt(p1[2] ** 2 + p1[3] ** 2)
        assert np.all(speed <= eng.state["speedLimit"] + 1e-6)

    def test_flow_feedback_written(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner(speed=0.01))
        for _ in range(2):
            eng.frame()
        flow = np.asarray(eng.sim.flow)
        assert np.abs(flow[3]).sum() > 0  # weights deposited
        # Stamp channel carries recent times where weight > 0.
        stamped = flow[2][flow[3] > 1e-3]
        assert stamped.size and np.all(stamped >= 0)

    def test_view_trail_accumulates_and_fades(self):
        eng = small_engine()
        eng.state["fadeColor"] = [0.0, 0.0, 0.0, 0.1]
        eng.spawn_shader(ball_spawner(speed=0.01))
        for _ in range(4):
            eng.frame()
        v = np.asarray(eng.sim.view[0])
        assert v[3].max() > 0  # particles drawn

    def test_fixed_step_determinism(self):
        def run():
            eng = small_engine()
            eng.spawn_shader(ball_spawner())
            for _ in range(5):
                eng.frame()
            return np.asarray(eng.sim.particles)

        np.testing.assert_array_equal(run(), run())

    def test_spawn_into_targets(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner())
        cur = np.asarray(eng.sim.particles)
        eng.spawn_shader(ball_spawner(radius=0.1), target="targets")
        # Particle state untouched; targets written.
        np.testing.assert_array_equal(np.asarray(eng.sim.particles), cur)
        t = np.asarray(eng.sim.targets)
        r = np.sqrt(t[0] ** 2 + t[1] ** 2)
        assert np.all(r <= 0.1 + 1e-5)

    def test_target_seek(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner(radius=0.8, speed=0.0))
        eng.sim = eng.sim.__class__(**{
            **{f.name: getattr(eng.sim, f.name)
               for f in eng.sim.__dataclass_fields__.values()},
            "targets": jnp.zeros_like(eng.sim.targets)})
        eng.state["target"] = 0.01
        eng.state["varyTarget"] = 0.0
        eng.state["noiseWeight"] = 0.0
        r0 = float(np.sqrt(np.asarray(eng.sim.particles[0]) ** 2
                           + np.asarray(eng.sim.particles[1]) ** 2).mean())
        for _ in range(20):
            eng.frame()
        r1 = float(np.sqrt(np.asarray(eng.sim.particles[0]) ** 2
                           + np.asarray(eng.sim.particles[1]) ** 2).mean())
        assert r1 < r0  # pulled towards origin targets

    def test_restart_clears(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner())
        for _ in range(2):
            eng.frame()
        eng.restart()
        assert np.all(np.asarray(eng.sim.particles[:2]) == INERT)
        assert np.abs(np.asarray(eng.sim.flow)).sum() == 0
        assert np.abs(np.asarray(eng.sim.view)).sum() == 0

    def test_param_change_no_recompile_crash(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner())
        eng.frame()
        eng.state["noiseScale"] = 5.0
        eng.state["flowWeight"] = -0.5
        eng.frame()  # same compiled fn, new values

    def test_resize(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner())
        eng.frame()
        eng.resize((24, 96))
        assert eng.sim.view.shape[-2:] == (24, 96)
        eng.frame()

    def test_setup_new_rootnum(self):
        eng = small_engine()
        eng.setup(root_num=16)
        assert eng.sim.particles.shape == (4, 256)
        eng.spawn_shader(ball_spawner())
        eng.frame()

    def test_pause_freezes(self):
        eng = small_engine()
        eng.spawn_shader(ball_spawner())
        eng.frame()
        p = np.asarray(eng.sim.particles)
        eng.timer.paused = True
        eng.frame()
        np.testing.assert_array_equal(np.asarray(eng.sim.particles), p)


class TestFlowResDecoupled:
    def test_low_res_flow_grid(self):
        # flow_res != view_res forces the generic (non-fused) draw path;
        # flow samples/splats at the lower resolution.
        eng = Tendrils(EngineConfig(root_num=16, view_res=(48, 64),
                                    flow_res=(24, 32), flow_samples=2,
                                    flow_rows=1, view_samples=2))
        eng.setup()
        eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6, 0.01))
        for _ in range(3):
            eng.frame()
        assert eng.sim.flow.shape == (4, 24, 32)
        assert np.asarray(eng.sim.flow)[3].max() > 0
        assert np.isfinite(np.asarray(eng.sim.particles)).all()


@pytest.mark.parametrize("option", [
    "splat_backend", "gather_backend", "fused_draw", "carry_force",
    "resident_stream", "merge_reorder"])
def test_kernel_selection_options_are_gone(option):
    """The engine has one path (XLA scatter/gather); the options that chose
    the removed kernel backends are refused, not silently ignored."""
    with pytest.raises(TypeError):
        EngineConfig(**{option: "pallas"})
