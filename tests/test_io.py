"""IO tests: PNG/PPM export and checkpoint/resume round-trips."""

import numpy as np

from tendrils import EngineConfig, Tendrils
from tendrils.io import (load_checkpoint, save_checkpoint, save_png,
                             save_ppm, view_to_u8)
from tendrils.spawners import spawn_ball


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
    path = save_png(str(tmp_path / "x.png"), img)
    from PIL import Image
    back = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(back, img)


def test_ppm_and_u8(tmp_path):
    view = np.zeros((4, 6, 4), np.float32)
    view[..., 0] = 1.0
    view[..., 3] = 0.5
    u8 = view_to_u8(view)
    assert u8[0, 0, 0] == 128  # half-alpha red over black
    save_ppm(str(tmp_path / "x.ppm"), u8)
    with open(tmp_path / "x.ppm", "rb") as f:
        assert f.readline() == b"P6\n"


def test_checkpoint_roundtrip(tmp_path):
    eng = Tendrils(EngineConfig(root_num=16, view_res=(24, 32),
                                flow_samples=2, flow_rows=1, view_samples=2))
    eng.setup()
    spawn_ball(0.5, 0.01).spawn(eng)
    for _ in range(3):
        eng.frame()
    eng.state["noiseScale"] = 7.5
    path = save_checkpoint(str(tmp_path / "ck.npz"), eng)

    p_ref = np.asarray(eng.sim.particles)
    t_ref = eng.timer.time

    # Resume into a DIFFERENT-shaped engine (exercises rebuild).
    eng2 = Tendrils(EngineConfig(root_num=8, view_res=(16, 16),
                                 flow_samples=2, flow_rows=1,
                                 view_samples=2))
    eng2.setup()
    load_checkpoint(path, eng2)
    np.testing.assert_array_equal(np.asarray(eng2.sim.particles), p_ref)
    assert eng2.timer.time == t_ref
    assert eng2.state["noiseScale"] == 7.5

    # Resumed run continues identically to the original.
    eng.frame()
    eng2.frame()
    np.testing.assert_array_equal(np.asarray(eng2.sim.particles),
                                  np.asarray(eng.sim.particles))
