"""The engine's frame paths on the XLA scatter/gather path, each against a
plain composition of the same ops: flow-off pruning, pause, spawns,
checkpoint round trips, the one-dispatch frames and the headless scan."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tendrils import EngineConfig, Tendrils
from tendrils.engine import (_frame_jit, draw_sim, faded_view, flow_parts,
                             run_headless, step_sim, view_parts)
from tendrils.io import load_checkpoint, save_checkpoint
from tendrils.ops import spawn, splat

DT = 1000.0 / 60.0


def make_engine(frames=3):
    # 30x50: a grid that is no multiple of any tile size.
    eng = Tendrils(EngineConfig(root_num=16, view_res=(30, 50),
                                flow_samples=2, flow_rows=1, view_samples=2))
    eng.setup()
    eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.5, 0.01))
    for _ in range(frames):
        eng.frame()
    return eng


def clone(sim):
    return jax.tree_util.tree_map(jnp.array, sim)


def assert_sims_equal(a, b, rtol=0.0, atol=0.0):
    for f in dataclasses.fields(a):
        np.testing.assert_allclose(np.asarray(getattr(a, f.name)),
                                   np.asarray(getattr(b, f.name)),
                                   rtol=rtol, atol=atol, err_msg=f.name)


def check_flow_off():
    """flowWeight == 0: the pruned step (no flow gather) gives the same
    frame as the general one — the flow term is exactly zero."""
    eng = make_engine()
    eng.state["flowWeight"] = 0.0
    params = eng.params()
    t, dt = jnp.float32(eng.timer.time + DT), jnp.float32(DT)
    a = _frame_jit(clone(eng.sim), params, t, dt, eng.config,
                   eng._view_size, flow_off=True)
    b = _frame_jit(clone(eng.sim), params, t, dt, eng.config,
                   eng._view_size, flow_off=False)
    assert_sims_equal(a, b)


def check_pause():
    """A paused timer keeps drawing (fade + splat) but never steps."""
    eng = make_engine()
    p0 = np.asarray(eng.sim.particles)
    v0 = np.asarray(eng.sim.view)
    eng.timer.paused = True
    eng.frame()
    np.testing.assert_array_equal(np.asarray(eng.sim.particles), p0)
    assert np.abs(np.asarray(eng.sim.view) - v0).max() > 0


def check_spawn_rotates():
    """A shader spawn rotates the ping-pong: the pre-spawn state becomes
    `previous`, so the next frame draws from it to the spawned state."""
    eng = make_engine()
    before = np.asarray(eng.sim.particles)
    eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.2, 0.005))
    np.testing.assert_array_equal(np.asarray(eng.sim.previous), before)
    eng.frame()
    p = np.asarray(eng.sim.particles)
    assert np.isfinite(p).all()
    assert (p[0] > -9e5).all()


def test_checkpoint_round_trip_resumes_frames(tmp_path):
    """Saving and loading mid-run resumes the exact trajectory."""
    eng = make_engine()
    path = save_checkpoint(str(tmp_path / "ck.npz"), eng)
    other = make_engine(frames=0)
    load_checkpoint(path, other)
    for _ in range(2):
        eng.frame()
        other.frame()
    assert_sims_equal(eng.sim, other.sim)


def check_step_draw_matches_separate_calls():
    """`step_draw` (one dispatch) equals `step` then `draw`."""
    a, b = make_engine(), make_engine()
    a.step_draw()
    b.step()
    b.draw()
    assert_sims_equal(a.sim, b.sim, atol=1e-6)


def check_run_headless_matches_frames():
    """The scanned headless run equals the same frames dispatched one by
    one at the same fixed times."""
    eng = make_engine()
    params = eng.params()
    t0, dt = jnp.float32(eng.timer.time), jnp.float32(DT)
    got = jax.jit(run_headless, static_argnames=("cfg", "steps"))(
        clone(eng.sim), params, eng.config, eng._view_size, t0, dt,
        steps=3)
    sim = clone(eng.sim)
    for i in range(3):
        sim = _frame_jit(sim, params, t0 + dt * (i + 1), dt, eng.config,
                         eng._view_size)
    # Scan and separate dispatches fuse differently: float rounding only
    # (the flow's stamp channel holds times ~100, hence the relative part).
    assert_sims_equal(got, sim, rtol=1e-6, atol=1e-6)


def check_draw_is_composed_passes():
    """`draw_sim` is the flow pass and the view pass, each resolved over
    its grid (the view faded first)."""
    eng = make_engine()
    params = eng.params()
    t = jnp.float32(eng.timer.time)
    sim = step_sim(eng.sim, params, t, jnp.float32(DT), eng.config,
                   eng._view_size)
    got = draw_sim(sim, params, t, eng.config, eng._view_size)
    flow = splat.composite_over(
        sim.flow, *flow_parts(sim, params, t, eng.config, eng._view_size))
    view = splat.composite_over(
        faded_view(sim, params),
        *view_parts(sim, params, t, eng.config, eng._view_size))
    np.testing.assert_allclose(np.asarray(got.flow), np.asarray(flow),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.view[0]), np.asarray(view),
                               atol=1e-6)


def check_restart_clears():
    """`restart` zeroes both grids and respawns all-inert; frames then run
    without drawing anything."""
    eng = make_engine()
    eng.restart()
    eng.frame()
    assert np.abs(np.asarray(eng.sim.flow)).max() == 0.0
    assert (np.asarray(eng.sim.particles)[0] < -9e5).all()


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_flow_off, check_pause, check_spawn_rotates,
    check_step_draw_matches_separate_calls,
    check_run_headless_matches_frames, check_draw_is_composed_passes,
    check_restart_clears)}


@pytest.mark.parametrize("name", list(CHECKS))
def test_frame_path(name):
    CHECKS[name]()
