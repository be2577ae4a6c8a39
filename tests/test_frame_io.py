"""The one-dispatch interactive frame (`engine.step_draw_io`).

It must (a) numerically match the separate facade calls it fuses
(colour-map blend → step+draw → flow-line inject → optical flow → blur),
and (b) actually be what the demo loop uses — no per-stage dispatches left.
Ref per-frame stack: `demo.main.js:1024-1161`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tendrils import EngineConfig, Tendrils
from tendrils.ops import post, spawn


def make_engine():
    eng = Tendrils(EngineConfig(root_num=16, view_res=(32, 64),
                                flow_samples=2, flow_rows=1,
                                view_samples=2))
    eng.setup()
    eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6, 0.01))
    return eng


def inputs():
    rng = np.random.RandomState(3)
    cm = [np.asarray(rng.rand(4, 8, 1), np.float32),
          np.asarray(rng.rand(4, 4, 4), np.float32)]
    alphas = [0.3, 0.6]
    p0 = np.asarray([[5.0, 5.0], [20.0, 10.0]], np.float32)
    p1 = p0 + 2.0
    vel = np.asarray(rng.rand(2, 2) * 0.004, np.float32)
    of_cur = np.asarray(rng.rand(4, 16, 24), np.float32)
    of_last = np.roll(of_cur, 2, axis=2)
    return cm, alphas, (p0, p1, vel, 2.0), (of_cur, of_last)


def test_step_draw_io_matches_separate_calls():
    cm, alphas, seg, of = inputs()
    of_uniforms = {"offset": 0.05, "speed": 0.08}
    blur = (3.0, 1.0)

    a = make_engine()
    a.timer.tick()
    screen = a.step_draw_io(color_maps=cm, color_alphas=alphas,
                            segments=seg, of_frames=of,
                            of_uniforms=of_uniforms, blur=blur)

    b = make_engine()
    b.timer.tick()
    import jax.image
    target = max((g.shape for g in cm), key=lambda sh: sh[1] * sh[2])
    views = [jnp.asarray(g) if g.shape == target
             else jax.image.resize(jnp.asarray(g), target, "bilinear")
             for g in cm]
    b.set_color_map(post.blend(views, jnp.asarray(alphas, jnp.float32)))
    b.step_draw()
    b.inject_flow_segments(*seg)
    from tendrils.ops.optical_flow import optical_flow
    payload = optical_flow(jnp.asarray(of[0]), jnp.asarray(of[1]),
                           jnp.float32(b.timer.time),
                           offset=jnp.float32(0.05),
                           lambda_=jnp.float32(0.001),
                           speed=jnp.float32(0.08),
                           speed_limit=b.params()["speedLimit"])
    b.composite_flow(payload)
    screen_b = post.vignette_blur(b.sim.view[0], jnp.float32(blur[0]),
                                  jnp.float32(blur[1]))

    np.testing.assert_allclose(np.asarray(a.sim.particles),
                               np.asarray(b.sim.particles), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.sim.flow),
                               np.asarray(b.sim.flow), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.sim.view),
                               np.asarray(b.sim.view), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.sim.color_map),
                               np.asarray(b.sim.color_map), atol=1e-6)
    np.testing.assert_allclose(np.asarray(screen), np.asarray(screen_b),
                               atol=1e-5)


def test_step_draw_io_minimal():
    # No optional stages: equivalent to plain step_draw, returns no screen.
    a = make_engine()
    a.timer.tick()
    out = a.step_draw_io()
    assert out is None

    b = make_engine()
    b.timer.tick()
    b.step_draw()
    np.testing.assert_allclose(np.asarray(a.sim.particles),
                               np.asarray(b.sim.particles), atol=0)
    np.testing.assert_allclose(np.asarray(a.sim.flow),
                               np.asarray(b.sim.flow), atol=0)


def test_step_draw_io_paused_draws_only():
    a = make_engine()
    a.timer.tick()
    a.timer.paused = True
    p_before = np.asarray(a.sim.particles)
    screen = a.step_draw_io(blur=(2.0, 1.0))
    assert screen is not None
    np.testing.assert_array_equal(np.asarray(a.sim.particles), p_before)


def test_demo_render_is_single_dispatch():
    """The demo loop must route the whole device frame through
    `step_draw_io` — the per-stage facade methods (step_draw,
    inject_flow_segments, composite_flow, set_color_map) must NOT be hit
    during render()."""
    from tendrils.app.demo import TendrilsDemo

    demo = TendrilsDemo({"rootNum": 16}, view_res=(32, 64))

    forbidden = []

    def forbid(name):
        def stub(*a, **kw):
            forbidden.append(name)
            raise AssertionError(f"render() dispatched via {name}")
        return stub

    eng = demo.tendrils
    eng.step_draw = forbid("step_draw")
    eng.inject_flow_segments = forbid("inject_flow_segments")
    eng.composite_flow = forbid("composite_flow")
    eng.set_color_map = forbid("set_color_map")

    # Pointer input so the flow-line stage is live.
    demo.pointer_move("p1", 0.1, 0.2)
    demo.render()
    demo.pointer_move("p1", 0.15, 0.25)
    demo.render()
    assert not forbidden
    assert demo.screen is not None


def test_paused_io_still_applies_inputs():
    """Paused timer skips only the STEP: colour maps, pointer segments and
    optical flow still land (ref keeps drawing flow input every frame,
    `demo.main.js:1107-1160`)."""
    cm, alphas, seg, of = inputs()
    eng = make_engine()
    eng.timer.tick()
    eng.timer.paused = True
    particles_before = np.asarray(eng.sim.particles)
    flow_before = np.asarray(eng.sim.flow)
    screen = eng.step_draw_io(color_maps=cm, color_alphas=alphas,
                              segments=seg, of_frames=of,
                              of_uniforms={"offset": 0.05, "speed": 0.08},
                              blur=(3.0, 1.0))
    assert screen is not None
    # No step: particle state unchanged.
    np.testing.assert_array_equal(np.asarray(eng.sim.particles),
                                  particles_before)
    # Flow inputs landed: the flow grid changed where the segment splats.
    assert not np.allclose(np.asarray(eng.sim.flow), flow_before)
    # Colour map blended.
    assert eng.sim.color_map.shape == (4, 4, 4)

def test_step_draw_io_bokeh_stage():
    """The bokeh screen pass inside the one-dispatch frame must match the
    separate `post.bokeh` call — alone and stacked after blur."""
    a = make_engine()
    a.timer.tick()
    screen = a.step_draw_io(bokeh=(2.0, 40.0))

    b = make_engine()
    b.timer.tick()
    b.step_draw()
    screen_b = post.bokeh(b.sim.view[0], jnp.float32(2.0),
                          jnp.float32(40.0))
    np.testing.assert_allclose(np.asarray(screen), np.asarray(screen_b),
                               atol=1e-6)

    c = make_engine()
    c.timer.tick()
    screen_c = c.step_draw_io(blur=(3.0, 1.0), bokeh=(2.0, 40.0))
    blurred = post.vignette_blur(b.sim.view[0], jnp.float32(3.0),
                                 jnp.float32(1.0))
    want = post.bokeh(blurred, jnp.float32(2.0), jnp.float32(40.0))
    np.testing.assert_allclose(np.asarray(screen_c), np.asarray(want),
                               atol=1e-6)
