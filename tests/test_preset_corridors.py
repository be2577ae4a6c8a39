"""Preset-replay statistical corridors.

Three presets replay 60 fixed-step frames headless; trajectory statistics
(alive fraction, mean alive speed, view alpha mass, flow weight mass) must
stay inside pinned bands at frames 10/30/60.

The bands were generated by `scripts/gen_corridors.py` on the XLA backend
(3 seeds x 60 frames; the sim's spawn hashes are seed-deterministic, so
the band width is a ±25% relative margin around the recorded trajectory).
They are intentionally wide enough to survive compiler/backend rounding,
and tight enough to
catch force-model drift (a damping, flow-force or colour-alpha regression
moves these statistics far more than 25%). No re-pin needed on
recompilation — only on deliberate semantic change.

Closes the gap `test_golden.py` admits (its stats are self-referential):
these corridors pin the PRESET-level behaviour the reference's live demo
defined (`demo.main.js:1483-3236`).
"""

import numpy as np
import pytest

# preset -> frame -> stat -> (lo, hi)
BANDS = {
    "Flow": {
        10: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00126487, 0.00210812),
             "view_mass": (1170.01, 1950.01),
             "flow_mass": (174.359, 290.598)},
        30: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00232426, 0.00387377),
             "view_mass": (1458.23, 2430.38),
             "flow_mass": (353.295, 588.825)},
        60: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00261982, 0.00436636),
             "view_mass": (1534.69, 2557.81),
             "flow_mass": (524.873, 874.788)},
    },
    "Starlings": {
        10: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00272603, 0.00454339),
             "view_mass": (1572.13, 2620.21),
             "flow_mass": (339.133, 565.221)},
        30: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00679013, 0.0113169),
             "view_mass": (2114.53, 3524.22),
             "flow_mass": (1380.56, 2300.94)},
        60: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00692844, 0.0115474),
             "view_mass": (3440.55, 5734.24),
             "flow_mass": (3266.95, 5444.92)},
    },
    "Kelp Forest": {
        10: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00266856, 0.00444761),
             "view_mass": (1825.05, 3041.75),
             "flow_mass": (414.366, 690.611)},
        30: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00479178, 0.00798629),
             "view_mass": (2213.13, 3688.56),
             "flow_mass": (984.74, 1641.23)},
        60: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00499987, 0.00833312),
             "view_mass": (2377.64, 3962.73),
             "flow_mass": (1509.51, 2515.84)},
    },
    "Rave": {
        10: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00181698, 0.00302831),
             "view_mass": (1698.22, 2830.37),
             "flow_mass": (595.735, 992.892)},
        30: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.00114434, 0.00190723),
             "view_mass": (1282.32, 2137.19),
             "flow_mass": (404.045, 673.409)},
        60: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.000910637, 0.00151773),
             "view_mass": (1195.05, 1991.75),
             "flow_mass": (326.44, 544.067)},
    },
    "Pissarides": {
        10: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.000257553, 0.000429255),
             "view_mass": (116.871, 194.785),
             "flow_mass": (123.465, 205.775)},
        30: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.000273265, 0.000455442),
             "view_mass": (345.82, 576.366),
             "flow_mass": (348.181, 580.302)},
        60: {"alive_frac": (0.75, 1.25),
             "mean_speed": (0.000271414, 0.000452357),
             "view_mass": (524.491, 874.152),
             "flow_mass": (532.785, 887.974)},
    },
}


def stats(demo):
    p = np.asarray(demo.tendrils.sim.particles)
    alive = p[0] > -9e5
    speed = np.sqrt(p[2] ** 2 + p[3] ** 2)
    return dict(
        alive_frac=float(alive.mean()),
        mean_speed=float(speed[alive].mean()) if alive.any() else 0.0,
        view_mass=float(np.abs(np.asarray(demo.tendrils.sim.view[0])[3])
                        .sum()),
        flow_mass=float(np.abs(np.asarray(demo.tendrils.sim.flow)[3])
                        .sum()),
    )


# Post-stack corridor: the banded-matrix blur+bokeh
# screen passes, exercised end-to-end through the demo's one-dispatch
# io-frame. Pissarides carries the heaviest blur preset (radius 12,
# limit 0.3); bokeh (radius 3, amount 40 — bench config-5 settings) is
# layered on via the demo's `bokeh_state` wiring. Stats are masses of
# the POST-PROCESSED screen (`demo.screen`), not sim state — a post
# regression (level LUT, band weights, limit gate) moves these directly.
# Bands: ±25% around a CPU/XLA reference run (same recipe as BANDS).
POST_BANDS = {
    10: {"rgb_mass": (73.77, 122.95), "alpha_mass": (116.87, 194.78)},
    30: {"rgb_mass": (317.54, 529.24), "alpha_mass": (345.82, 576.37)},
    60: {"rgb_mass": (594.15, 990.26), "alpha_mass": (524.49, 874.15)},
}


def test_post_stack_corridor():
    from tendrils.app.demo import TendrilsDemo
    demo = TendrilsDemo({"quality": 0}, view_res=(90, 160), root_num=32, seed=0)
    demo.apply_preset("Pissarides")
    # apply_preset resets bokeh to its (off) default — layer it back on
    # to exercise the full blur→bokeh post stack.
    demo.bokeh_state.update(radius=3.0, amount=40.0)
    for f in range(1, 61):
        demo.render()
        if f in POST_BANDS:
            scr = np.asarray(demo.screen)
            s = {"rgb_mass": float(np.abs(scr[:3]).sum()),
                 "alpha_mass": float(np.abs(scr[3]).sum())}
            for k, (lo, hi) in POST_BANDS[f].items():
                assert lo <= s[k] <= hi, (
                    f"post corridor frame {f}: {k}={s[k]:.6g} outside "
                    f"[{lo:.6g}, {hi:.6g}]")


@pytest.mark.parametrize("preset", list(BANDS))
def test_preset_corridor(preset):
    from tendrils.app.demo import TendrilsDemo
    demo = TendrilsDemo({"quality": 0}, view_res=(90, 160), root_num=32, seed=0)
    demo.apply_preset(preset)
    for f in range(1, 61):
        demo.render()
        if f in BANDS[preset]:
            s = stats(demo)
            for k, (lo, hi) in BANDS[preset][f].items():
                assert lo <= s[k] <= hi, (
                    f"{preset} frame {f}: {k}={s[k]:.6g} outside "
                    f"[{lo:.6g}, {hi:.6g}]")
