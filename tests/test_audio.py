"""Audio subsystem tests — reference JS functions are the oracles
(`src/analyse/index.js`, `src/data-log/index.js`, `src/audio/index.js`)."""

import math
import wave

import numpy as np
import pytest

from tendrils.audio import (Analyser, AudioTexture, AudioTrigger,
                                WavAnalyser, mean_weight, order_log_rates,
                                peak, peak_pos, sum_weight)
from tendrils.audio.data_log import make_log, make_order_log, step


class TestDataLog:
    def test_order_log_shape(self):
        ol = make_order_log(4)
        assert [len(l) for l in ol] == [4, 3, 2, 1]

    def test_step_rotation(self):
        a = [1, 2, 3]
        out = step(a)
        assert out == 3
        assert a == [3, 1, 2]


class TestAnalyse:
    def test_peak(self):
        assert peak([1.0, -5.0, 3.0]) == -5.0
        assert peak_pos([1.0, -5.0, 3.0]) == {"peak": -5.0, "pos": 1}

    def test_sum_weight_bandpass(self):
        data = np.zeros(11)
        data[5] = 1.0  # centre bin
        # fulcrum at centre weights it 1; at the end weights it 0.5.
        assert sum_weight(data, 0.5) == pytest.approx(1.0)
        assert sum_weight(data, 0.0) == pytest.approx(0.5)
        assert mean_weight(data, 0.5) == pytest.approx(1.0 / 11)

    def test_order_log_rates(self):
        ol = make_order_log(3, lambda s: make_log(
            s, lambda i: np.zeros(4, np.float32)))
        # Two spectra one dt apart -> first-order rate = diff/dt.
        ol[0][0][:] = [4, 4, 4, 4]
        ol[0][1][:] = [2, 2, 2, 2]
        order_log_rates(ol, dt=2.0)
        np.testing.assert_allclose(ol[1][0], 1.0)


class TestTrigger:
    def test_fire_on_threshold(self):
        an = Analyser(fft_size=8)
        trig = AudioTrigger(an, orders=3)
        fired = []
        an.push(frequencies=np.zeros(4))
        trig.sample(dt=1)
        an.push(frequencies=np.full(4, 100.0))
        trig.sample(dt=1)
        # order-1 rate = 100; fires when mean_weight > 50.
        assert trig.fire(lambda t: fired.append(1),
                         lambda t: mean_weight(t.data_order(1), 0.5) > 50)
        assert fired == [1]
        # No fire when threshold high.
        assert not trig.fire(lambda t: fired.append(2),
                             lambda t: peak(t.data_order(1)) > 1e9)
        assert fired == [1]

    def test_clear(self):
        an = Analyser(fft_size=8)
        trig = AudioTrigger(an, orders=2)
        an.push(frequencies=np.full(4, 9.0))
        trig.sample()
        trig.clear()
        assert float(np.abs(trig.data_order(0)).sum()) == 0


class TestWavAnalyser:
    def test_fft_peaks_at_tone(self, tmp_path):
        # 1 kHz sine at 8 kHz sample rate -> peak near bin k = f/sr*fft.
        sr, f, secs = 8000, 1000.0, 1.0
        t = np.arange(int(sr * secs)) / sr
        pcm = (np.sin(2 * math.pi * f * t) * 32000).astype(np.int16)
        path = str(tmp_path / "tone.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())

        an = WavAnalyser(path, fft_size=256, smoothing=0.0)
        an.tick(500.0)
        out = np.zeros(an.frequency_bin_count, np.float32)
        an.frequencies(out)
        expected_bin = round(f / sr * 256)
        assert abs(int(np.argmax(out)) - expected_bin) <= 1
        assert out.max() > 50  # strong tone registers high in byte scale


class TestAudioTexture:
    def test_frequency_mapping(self):
        tex = AudioTexture(4)
        tex.frequencies([0, 128, 255, 64])
        np.testing.assert_allclose(tex.array,
                                   [0, 0.5, 255 / 256, 0.25], atol=1e-6)
        g = np.asarray(tex.grid())
        assert g.shape == (4, 1, 4)
        np.testing.assert_allclose(g[3], 1.0)
