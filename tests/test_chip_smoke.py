"""`chip_smoke.py` off the card: its comparison helpers on tiny CPU inputs,
its phases at tiny sizes, and its refusal to run without a GPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from post_oracles import box_stack_reference
from tendrils import EngineConfig, Tendrils
from tendrils.ops import post, sample, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=300)


def test_refuses_the_cpu():
    out = _run(["chip_smoke.py"], ROOT, JAX_PLATFORMS="cpu")
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path), JAX_PLATFORMS="cpu",
               PYTHONPATH="")
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("got,ok", [
    (np.array([0.0, 1e-6, 2e-6, 0.0]), True),      # all within bulk
    (np.array([0.0, 0.0, 0.0, 5e-3]), True),       # one outlier in bound
    (np.array([0.0, 0.0, 5e-3, 5e-3]), False),     # too many outliers
    (np.array([0.0, 0.0, 0.0, 2e-2]), False),      # outlier past bound
    (np.array([0.0, 0.0, 0.0, np.nan]), False),    # not finite
])
def test_check_close(got, ok):
    kw = dict(bulk=1e-5, bulk_frac=0.75, bound=1e-2)
    want = np.zeros(4)
    if ok:
        stats = cs.check_close("x", got, want, **kw)
        assert stats["max"] == float(np.abs(got).max())
    else:
        with pytest.raises(AssertionError, match="x"):
            cs.check_close("x", got, want, **kw)


def test_check_close_rejects_shape_change():
    with pytest.raises(AssertionError, match="shape"):
        cs.check_close("x", np.zeros(3), np.zeros(4), bulk=1, bulk_frac=0,
                       bound=1)


def test_grid_scale_is_per_channel():
    g = np.zeros((3, 2, 2))
    g[0, 0, 0] = -4.0
    g[1, 1, 1] = 0.5
    s = cs.grid_scale(g)
    assert s.shape == (3, 1, 1)
    assert s[0, 0, 0] == 4.0 and s[1, 0, 0] == 0.5 and s[2, 0, 0] > 0


@pytest.mark.parametrize("shape", [(1, 7, 11), (4, 45, 77), (2, 130, 50)])
def test_numpy_bilinear_matches_xla_gather(shape):
    rng = np.random.RandomState(1)
    grid = rng.rand(*shape).astype(np.float32)
    _, h, w = shape
    x = rng.uniform(-3, w + 3, 500).astype(np.float32)
    y = rng.uniform(-3, h + 3, 500).astype(np.float32)
    got = sample.bilinear_sample(jnp.asarray(grid), jnp.asarray(x),
                                 jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(got),
                               cs.numpy_bilinear(grid, x, y), atol=1e-6)


def _engine(frames):
    eng = Tendrils(EngineConfig(root_num=16, view_res=(30, 50),
                                flow_samples=2, flow_rows=1, view_samples=2))
    eng.setup()
    eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.5, 0.01))
    for _ in range(frames):
        eng.frame()
    return eng


def test_life_needs_evidence():
    with pytest.raises(AssertionError, match="life"):
        cs.life(_engine(0).sim)
    out = cs.life(_engine(3).sim)
    assert out["alive"] == 256 and out["finite"]


def test_compare_frames_same_device():
    """One frame on the CPU twice from one host state: identical, and a
    particle moved past `2·speedLimit` is caught."""
    eng = _engine(3)
    cpu = jax.devices("cpu")[0]
    host = cs.to_host(eng.sim)
    params = cs.to_host(eng.params())
    vs = np.asarray(eng._view_size)
    a = cs.frame_on(cpu, host, params, eng.config, vs, 70.0)
    b = cs.frame_on(cpu, host, params, eng.config, vs, 70.0)
    sl = float(params["speedLimit"])
    stats = cs.compare_frames("cpu", a, b, sl)
    assert stats["particles"]["max"] == 0.0
    bad = a.particles.copy()
    bad[0, 0] += 3 * sl
    with pytest.raises(AssertionError, match="particles"):
        cs.compare_frames("cpu", dataclasses.replace(a, particles=bad), b,
                          sl)


def test_cumsum_stack_is_the_blur_stack_operator():
    rng = np.random.RandomState(2)
    img = rng.rand(4, 23, 41).astype(np.float32)
    radii = (2, 6, 16)
    got = cs.cumsum_stack(jnp.asarray(img), radii)
    ref = box_stack_reference(img, radii)
    mm = post.blur_stack(jnp.asarray(img), radii)
    for g, r, m in zip(got, ref, mm):
        np.testing.assert_allclose(np.asarray(g), r, atol=1e-5)
        np.testing.assert_allclose(np.asarray(m), r, atol=1e-5)


def test_phase2_at_tiny_size(capsys):
    cpu = jax.devices("cpu")[0]
    cs.phase2_splat_gather(cpu, grid_hw=(60, 90), n=200, m=2048)
    out = capsys.readouterr().out
    assert out.startswith("phase 2 splat+gather: ")


def test_time_ms_counts_reps():
    t = cs.time_ms(lambda: jnp.ones(3) * 2, 3)
    assert t["reps"] == 3 and 0 <= t["min"] <= t["median"] <= t["max"]
