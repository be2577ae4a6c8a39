"""Generate preset-replay statistical corridor bands.

Runs 3 presets x 3 seeds x 60 fixed-step frames on the CPU/XLA backend and
prints per-checkpoint bands for: alive fraction, mean alive speed, view
alpha mass, flow weight mass. The bands (min/max over seeds, widened by a
relative margin) are pinned into tests/test_preset_corridors.py.

Run: JAX_PLATFORMS=cpu python scripts/gen_corridors.py
"""

import json

import numpy as np

PRESETS = ("Flow", "Starlings", "Kelp Forest", "Rave", "Pissarides")
CHECKPOINTS = (10, 30, 60)
SEEDS = (0, 1, 2)


def stats(demo):
    p = np.asarray(demo.tendrils.sim.particles)
    alive = p[0] > -9e5
    speed = np.sqrt(p[2] ** 2 + p[3] ** 2)
    view = np.asarray(demo.tendrils.sim.view[0])
    flow = np.asarray(demo.tendrils.sim.flow)
    return dict(
        alive_frac=float(alive.mean()),
        mean_speed=float(speed[alive].mean()) if alive.any() else 0.0,
        view_mass=float(np.abs(view[3]).sum()),
        flow_mass=float(np.abs(flow[3]).sum()),
    )


def run(preset, seed):
    from tendrils.app.demo import TendrilsDemo
    demo = TendrilsDemo({"quality": 0}, view_res=(90, 160), root_num=32,
                        splat_backend="xla", gather_backend="xla",
                        seed=seed)
    demo.apply_preset(preset)
    out = {}
    for f in range(1, max(CHECKPOINTS) + 1):
        demo.render()
        if f in CHECKPOINTS:
            out[f] = stats(demo)
    return out


def main():
    bands = {}
    for preset in PRESETS:
        runs = [run(preset, s) for s in SEEDS]
        bands[preset] = {}
        for f in CHECKPOINTS:
            bands[preset][f] = {}
            for k in runs[0][f]:
                vals = [r[f][k] for r in runs]
                lo, hi = min(vals), max(vals)
                spread = max(hi - lo, abs(hi) * 0.25, 1e-6)
                bands[preset][f][k] = (lo - spread, hi + spread)
    print(json.dumps(bands, indent=1))


if __name__ == "__main__":
    main()
