"""Demo app tests: preset replay, triggers, quality tiers, render loop,
keyboard map, scroll sequencer (SURVEY §4 golden-replay strategy)."""

import numpy as np
import pytest

from tendrils.app import PRESETS, TendrilsDemo
from tendrils.app.keys import KeyMash
from tendrils.app.sub import SubSequencer


def small_demo(**settings):
    return TendrilsDemo(settings, view_res=(36, 64), root_num=16,
                        flow_samples=2, flow_rows=1, view_samples=2)


class TestPresets:
    def test_all_presets_present(self):
        # The reference registers 41 presets (incl. 2 aliases) —
        # demo.main.js:1483-3236.
        assert len(PRESETS) == 41

    def test_apply_preset_sets_state(self):
        demo = small_demo()
        demo.apply_preset("Rave")
        assert demo.state["noiseScale"] == 12
        assert demo.state["target"] == 0.001
        assert demo.reset_spawner.uniforms["radius"] == 0.3
        np.testing.assert_allclose(demo.state["baseColor"],
                                   [0, 1, 30 / 255, 0.6])

    def test_preset_resets_previous(self):
        demo = small_demo()
        demo.apply_preset("Rave")
        demo.apply_preset("Flow")
        # Rave's noiseScale must have reset to default before Flow applied.
        assert demo.state["noiseScale"] == demo.default_state["noiseScale"]
        assert demo.state["colorMapAlpha"] == 0

    def test_fade_alpha_min_decay(self):
        demo = small_demo()
        demo.apply_preset("Flow")
        # fadeAlpha = max(flowDecay, 0.05) with default flowDecay 0.005.
        assert demo.state["fadeColor"][3] == pytest.approx(0.05)

    def test_audio_scaling(self):
        demo = small_demo()
        demo.apply_preset("Ghostly")
        assert demo.audio_state["micSpawnAt"] == pytest.approx(
            demo.audio_defaults["micSpawnAt"] * 0.5)

    def test_every_preset_applies_and_renders(self):
        demo = small_demo()
        for name in PRESETS:
            demo.apply_preset(name)
            demo.render()
            img = np.asarray(demo.screen_image)
            assert np.isfinite(img).all(), name


class TestDemoLoop:
    def test_frames_advance(self):
        demo = small_demo()
        for _ in range(3):
            demo.render()
        assert demo.frame_count == 3
        p = np.asarray(demo.tendrils.sim.particles)
        assert np.isfinite(p).all()
        assert demo.screen is not None

    def test_deterministic_replay(self):
        def run():
            demo = small_demo()
            demo.apply_preset("Flow")
            for _ in range(5):
                demo.render()
            return np.asarray(demo.tendrils.sim.particles)

        np.testing.assert_array_equal(run(), run())

    def test_pointer_flow_injects(self):
        demo = small_demo()
        for i in range(6):
            demo.pointer_move(1, 10.0 + i * 6, 18.0)
            demo.render()
        flow = np.asarray(demo.tendrils.sim.flow)
        assert flow[3].max() > 0

    def test_video_pipeline(self):
        demo = small_demo()
        rng = np.random.default_rng(0)
        for i in range(3):
            demo.feed_video_frame(
                rng.uniform(0, 255, (24, 32, 3)).astype(np.uint8))
            demo.render()
        assert demo._video_frame is not None

    def test_quality_change(self):
        demo = small_demo()
        demo.quality["options"] = [{"rootNum": 16, "damping": 0.043},
                                   {"rootNum": 32, "damping": 0.042}]
        demo.quality_change(1)
        assert demo.tendrils.config.root_num == 32
        demo.render()

    def test_mic_trigger_fires_spawn(self):
        demo = small_demo()
        demo.audio_state["micFlowAt"] = 1e-6  # hair trigger
        demo.audio_state["micFastAt"] = 0
        demo.audio_state["micFormAt"] = 0
        demo.audio_state["micSampleAt"] = 0
        demo.audio_state["micCamAt"] = 0
        demo.audio_state["micSpawnAt"] = 0
        demo.feed_mic_spectrum(np.zeros(512))
        demo.render()
        demo.feed_mic_spectrum(np.full(512, 200.0))
        assert demo.render() is demo  # no crash; fire path exercised

    def test_show_link_roundtrip(self):
        demo = small_demo(preset="Flow")
        link = demo.show_link()
        assert link.startswith("?")
        assert "use_media" in link


class TestKeyMash:
    def test_preset_keys(self):
        demo = small_demo()
        km = KeyMash(demo)
        assert km.key_down("6")  # Rave
        assert demo.state["noiseScale"] == 12

    def test_space_restarts(self):
        demo = small_demo()
        demo.render()
        km = KeyMash(demo)
        km.key_down("<space>")
        assert demo.timer["app"].time == 0

    def test_editor_adjust(self):
        demo = small_demo(editor_keys="true")
        km = KeyMash(demo)
        base = demo.state["forceWeight"]
        km.key_down("Q")  # select forceWeight
        km.key_down("<up>")  # +1 * 0.01
        assert demo.state["forceWeight"] == pytest.approx(base + 0.01)
        km.key_up("Q")  # records a keyframe
        frames = demo.player["track"].tracks["tendrils"].frames
        assert len(frames) > 3


class TestSubSequencer:
    def test_preset_switching_by_visibility(self):
        demo = small_demo()
        seq = SubSequencer(demo)
        seq.add_section(preset="Flow")
        seq.add_section(preset="Rave")
        seq.observe([0.8, 0.1])
        assert seq.preset == "Flow"
        seq.observe([0.2, 0.9])
        assert seq.preset == "Rave"
        assert demo.state["noiseScale"] == 12

    def test_trigger_fires_on_schedule(self):
        demo = small_demo()
        demo.render()
        seq = SubSequencer(demo, trigger_times={"restart": [0.0, 50.0]})
        seq.add_section(trigger="restart")
        seq.observe([1.0], now=100.0)
        assert len(seq.pending) == 2
        seq.tick(now=120.0)
        assert len(seq.pending) == 1
        seq.tick(now=200.0)
        assert len(seq.pending) == 0


class TestDemoSpawnPaths:
    def test_set_image_and_spawn_image(self):
        demo = small_demo()
        rng = np.random.default_rng(0)
        demo.set_image(rng.uniform(0, 255, (24, 32, 3)).astype(np.uint8))
        demo.spawn_image(None)
        p = np.asarray(demo.tendrils.sim.particles)
        assert (p[0] > -9e5).all()  # all particles spawned from the image
        # Colour map follows the image raster — ref demo.main.js:503.
        assert demo.tendrils.sim.color_map.shape[1:] == (24, 32)

    def test_spawn_image_targets_sets_both(self):
        demo = small_demo()
        demo.set_image(np.full((16, 16, 3), 200, np.uint8))
        demo.spawn_image_targets()
        t = np.asarray(demo.tendrils.sim.targets)
        assert np.abs(t[:2]).max() <= 1.5  # image positions, not inert
        assert demo.spawn_targets["spawnImage"] == "targets"

    def test_spawn_flow_mirror_scales(self):
        demo = small_demo()
        demo.render()
        for scale in ["normal", "mirror x", "mirror y", "mirror xy"]:
            demo.flow_pixel_state["scale"] = scale
            demo.spawn_flow()
        p = np.asarray(demo.tendrils.sim.particles)
        assert np.isfinite(p).all()

    def test_spawn_fastest_runs(self):
        demo = small_demo()
        demo.render()
        demo.spawn_fastest()
        assert np.isfinite(np.asarray(demo.tendrils.sim.particles)).all()

    def test_wav_track_reactivity(self, tmp_path):
        import math
        import wave
        sr = 8000
        t = np.arange(sr) / sr
        pcm = (np.sin(2 * math.pi * 440 * t) * 20000).astype(np.int16)
        path = str(tmp_path / "t.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
        demo = small_demo(track=path)
        demo.play_track()
        for _ in range(3):
            demo.render()
        # Track spectrum reached the texture (some energy registered).
        assert demo.track_texture.array.max() >= 0
