"""High-level spawner API tests."""

import jax.numpy as jnp
import numpy as np

from tendrils import EngineConfig, Tendrils
from tendrils.const import INERT
from tendrils.spawners import (GeometrySpawner, PixelSpawner, spawn_ball,
                                   spawn_init)


def engine():
    eng = Tendrils(EngineConfig(root_num=16, view_res=(32, 64),
                                flow_samples=2, flow_rows=1, view_samples=2))
    eng.setup()
    return eng


def test_spawn_init_and_ball():
    eng = engine()
    ball = spawn_ball(radius=0.4, speed=0.01)
    ball.spawn(eng)
    p = np.asarray(eng.sim.particles)
    r = np.sqrt(p[0] ** 2 + p[1] ** 2)
    assert np.all(r <= 0.4 + 1e-5)
    # Live uniforms: change radius, respawn.
    ball.uniforms["radius"] = 0.1
    ball.spawn(eng)
    p = np.asarray(eng.sim.particles)
    assert np.all(np.sqrt(p[0] ** 2 + p[1] ** 2) <= 0.1 + 1e-5)

    spawn_init().spawn(eng)
    assert np.all(np.asarray(eng.sim.particles[:2]) == INERT)


def test_pixel_spawner_direct():
    eng = engine()
    sp = PixelSpawner(shader="direct", speed=0.5, jitter_rad=0.0)
    # Bright red image -> hue 0 -> direction angle ~0 (plus tiny time term).
    img = jnp.zeros((4, 8, 8)).at[0].set(1.0).at[3].set(1.0)
    sp.set_pixels(img)
    sp.spawn(eng)
    p = np.asarray(eng.sim.particles)
    alive = p[0] > -9e5
    assert alive.all()
    # Red hue: velocity along +x.
    assert np.abs(p[2]).mean() > np.abs(p[3]).mean()


def test_pixel_spawner_best_sample_into_targets():
    eng = engine()
    spawn_ball(0.5, 0.01).spawn(eng)
    before = np.asarray(eng.sim.particles)
    sp = PixelSpawner(shader="flow-sample", bias=1e9)
    sp.set_pixels(eng.sim.flow)
    sp.spawn(eng, target="targets")
    # Particles untouched; targets written.
    np.testing.assert_array_equal(np.asarray(eng.sim.particles), before)


def test_geometry_spawner():
    eng = engine()
    gs = GeometrySpawner(seed=3)
    gs.shuffle().spawn(eng)
    p = np.asarray(eng.sim.particles)
    assert np.isfinite(p).all()
    # Particles land inside the triangle fan's extent (radius <= ~1.55·aspect).
    alive = p[0] > -9e5
    assert alive.sum() > 0
    # Shuffling changes the forms.
    t1 = np.asarray(gs.triangles)
    gs.shuffle()
    assert not np.allclose(t1, np.asarray(gs.triangles))
