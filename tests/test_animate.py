"""Animation engine tests (SURVEY §4: `animate/tween.js` / `timeline.js` give
exact oracles — values below are hand-computed from the reference math)."""

import math

import pytest

from tendrils.animate import (Player, Timeline, apply_span, bezier_ease,
                                  frame, join_curve, tween, tween_value)


class TestTween:
    def test_lerp(self):
        assert tween_value(0.0, 10.0, 0.25) == 2.5

    def test_ease_bezier(self):
        # de Casteljau over [0, 1]: identity; over [0, 0, 1]: t^2.
        assert bezier_ease([0.0, 1.0], 0.3) == pytest.approx(0.3)
        assert bezier_ease([0.0, 0.0, 1.0], 0.5) == pytest.approx(0.25)
        assert tween_value(0.0, 1.0, 0.5, [0.0, 0.0, 1.0]) == pytest.approx(
            0.25)

    def test_non_number_passthrough(self):
        # Non-number props don't tween — they fall back to the output's own
        # value (ref `tween.js:8-11`: tweenable returns defaults[k]); string
        # props reach outputs via the accumulated `apply`, not the tween.
        out = tween({"x": 0.0, "name": "a"}, {"x": 1.0, "name": "b"}, 0.5)
        assert out["x"] == 0.5
        assert out["name"] is None
        out = {"name": "keep"}
        tween({"name": "a"}, {"name": "b"}, 1.0, None, out)
        assert out["name"] == "keep"

    def test_props_use_out_defaults(self):
        # tweenable falls back to the output object's value — ref
        # `tween.js:8-11`.
        out = {"x": 4.0}
        tween({}, {"x": 8.0}, 0.5, None, out)
        assert out["x"] == 6.0

    def test_list_tween(self):
        out = [0.0, 0.0, 0.0]
        tween([0.0, 0.0, 0.0], [1.0, 2.0, 4.0], 0.5, None, out)
        assert out == [0.5, 1.0, 2.0]

    def test_span_form(self):
        out = {}
        tween({"a": {"x": 0.0}, "b": {"x": 2.0}, "t": 0.5, "ease": None},
              out)
        assert out["x"] == 1.0


class TestJoinCurve:
    def test_reflection(self):
        # (last - second_last) * align — ref join-curve.js:6-9
        assert join_curve([0.0, 0.2, 1.0]) == pytest.approx(0.8)
        assert join_curve([0.0, 0.2, 1.0], -1) == pytest.approx(-0.8)
        assert join_curve([0.7]) == 0.7
        assert join_curve(None) == 0


class TestTimeline:
    def test_sentinels(self):
        tl = Timeline([frame({"x": 1.0}, 100.0)])
        assert tl.frames[0]["time"] == -math.inf
        assert tl.frames[-1]["time"] == math.inf
        assert len(tl.frames) == 3

    def test_seek_interpolates(self):
        tl = Timeline([frame({"x": 0.0}, 0.0), frame({"x": 10.0}, 100.0)])
        span = tl.seek(50.0)
        assert span["t"] == pytest.approx(0.5)
        out = apply_span(span, {})
        assert out["x"] == pytest.approx(5.0)

    def test_always_sorted_insert(self):
        tl = Timeline([])
        tl.to({"x": 2.0}, 200.0).to({"x": 1.0}, 100.0).to({"x": 3.0}, 300.0)
        times = [f["time"] for f in tl.frames]
        assert times == sorted(times)

    def test_play_accumulates_skipped_calls(self):
        fired = []
        tl = Timeline([
            frame({"x": 0.0}, 0.0),
            frame({"x": 1.0}, 10.0, None, [lambda out, span: fired.append(
                1)]),
            frame({"x": 2.0}, 20.0, None, [lambda out, span: fired.append(
                2)]),
            frame({"x": 3.0}, 100.0),
        ])
        tl.play(1.0)
        out = {}
        apply_span(tl.play(50.0), out)  # jumps over frames at t=10 and 20
        assert fired == [1, 2]
        # Accumulated `to`s applied before the tween.
        assert out["x"] >= 2.0

    def test_play_accumulates_skipped_tos(self):
        tl = Timeline([
            frame({"x": 1.0, "y": 5.0}, 10.0),
            frame({"x": 2.0}, 20.0),
            frame({"x": 4.0}, 100.0),
        ])
        tl.play(0.0)
        out = {}
        apply_span(tl.play(60.0), out)
        # y only exists on the skipped first frame — must still land.
        assert out["y"] == 5.0

    def test_smooth_to_joins_ease(self):
        tl = Timeline([])
        tl.to({"x": 0.0}, 0.0, [0.0, 0.3, 1.0])
        tl.smooth_to({"x": 1.0}, 100.0)
        fr = tl.frames[-2]  # before the +inf sentinel
        # ease = [0, join([0,.3,1], 1)=0.7, 1]
        assert fr["ease"] == [0, pytest.approx(0.7), 1]

    def test_splice_protects_sentinels(self):
        # Ref `timeline.js:231-250`: start clamps past the left sentinel and
        # remove clamps before the right one — splice(0, 99) on two real
        # frames removes only the first (remove = length - start = 1).
        tl = Timeline([frame({"x": 1.0}, 1.0), frame({"x": 2.0}, 2.0)])
        removed = tl.splice(0, 99)
        assert tl.frames[0]["time"] == -math.inf
        assert tl.frames[-1]["time"] == math.inf
        assert len(tl.frames) == 3
        assert removed[0]["time"] == 1.0
        assert tl.frames[1]["time"] == 2.0

    def test_over_adds_null_start(self):
        tl = Timeline([frame({"x": 0.0}, 0.0)])
        tl.over(20.0, {"x": 5.0}, 100.0)
        times = [f["time"] for f in tl.frames]
        assert 80.0 in times  # null start frame at 100-20

    def test_start_end_duration(self):
        tl = Timeline([frame({"x": 1.0}, 5.0)], infinite=False)
        assert tl.start() == 5.0
        assert tl.end() == 5.0
        assert tl.duration() == 0.0


class TestPlayer:
    def test_tracks_apply_to_outputs(self):
        state = {"x": 0.0}
        color = [0.0, 0.0, 0.0]
        p = Player({"main": [frame({"x": 0.0}, 0.0),
                             frame({"x": 10.0}, 100.0)],
                    "color": [frame([0.0, 0.0, 0.0], 0.0),
                              frame([1.0, 1.0, 1.0], 100.0)]},
                   {"main": state, "color": color})
        p.play(0.5)
        p.play(50.0)
        assert state["x"] == pytest.approx(5.0)
        assert color[0] == pytest.approx(0.5)

    def test_seek_does_not_fire_calls(self):
        fired = []
        p = Player({"t": [frame({"x": 1.0}, 10.0, None,
                                [lambda *a: fired.append(1)]),
                          frame({"x": 2.0}, 99.0)]})
        p.seek(50.0)
        assert fired == []


class TestTimelineModes:
    def test_rewind_swaps_span(self):
        tl = Timeline([frame({"x": 0.0}, 0.0, [0.0, 1.0]),
                       frame({"x": 10.0}, 100.0, [0.0, 0.5, 1.0])],
                      rewind=True)
        span = tl.seek(25.0)
        # rewind: past/next swapped; symmetric keeps the later frame's ease.
        assert span["past"]["time"] == 100.0
        assert span["next"]["time"] == 0.0
        assert span["ease"] == [0.0, 0.5, 1.0]

    def test_rewind_asymmetric_uses_past_ease(self):
        tl = Timeline([frame({"x": 0.0}, 0.0, [0.0, 1.0]),
                       frame({"x": 10.0}, 100.0, [0.0, 0.5, 1.0])],
                      rewind=True, symmetric=False)
        span = tl.seek(25.0)
        assert span["ease"] == [0.0, 1.0]
