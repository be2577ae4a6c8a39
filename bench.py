"""Benchmark: particle-steps/sec on the flow-feedback config (BASELINE.md
config 2 family: 1M particles, rasterised flow-field advection + trail
feedback at 1080p).

    python bench.py               # config 2, one JSON line (four keys)
    python bench.py --all         # every BASELINE.md config, a line each
    python bench.py --config N    # config N only

Runs on an accelerator at the published sizes of `tendrils/models/
configs.py`, and refuses to run on the CPU: a CPU time is no device metric.
Every line names the device (platform, device_kind, count); the card's name
and power limit from `nvidia-smi` go to stderr first. Times are host wall
clock around work ended with `block_until_ready`.

Baseline: the reference's implicit design point — its tier-1 quality is
1024² = 1,048,576 particles at the fixed 60 steps/s timestep
(`src/demo.main.js:978-1009`, `src/index.js:67`) → 62,914,560
particle-steps/s on a consumer GPU. vs_baseline = value / that.
"""

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_PSTEPS = 1024 * 1024 * 60  # reference tier-1 @ 60 steps/s
DT = 1000.0 / 60.0

# BASELINE.md's configs: line name, `models.configs` builder, a view
# resolution override (config 1 benches its preview at 720p) and the
# description that goes into the unit.
CONFIGS = {
    1: ("1:256sq-noise-only", "default-preview", (720, 1280),
        "256² noise-only, 720p"),
    2: ("2:1M-flow-trail", "1m-flow", None, "1M flow feedback, 1080p"),
    3: ("3:4M-respawn-stress", "4m-respawn-stress", None,
        "4M, respawn every 10 steps"),
    4: ("4:optical-flow-driven", "optical-flow-driven", None,
        "512² + camera optical flow"),
    5: ("5:16M-4K-live-show", "16m-live-show", None,
        "16M particles, 4K trail + bokeh/frame"),
}


def config_shape(config):
    """(rootNum, view (H, W)) a config benches at."""
    from tendrils.models.configs import PUBLISHED
    _, model, view, _ = CONFIGS[config]
    root, published_view = PUBLISHED[model]
    return root, view or published_view


def device_info():
    """Platform, kind and count of the devices JAX sees; exits on the
    CPU."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("bench.py: no accelerator (JAX found only the "
                         "CPU); a CPU run measures no device")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _engine(config):
    """A spawned engine at the config's published size (a 0.6-radius ball
    at speed 0.01)."""
    from tendrils.models import configs
    _, model, view, _ = CONFIGS[config]
    return configs.build(model, view_res=view)


@functools.partial(jax.jit, static_argnames=("cfg", "steps", "flow_off"),
                   donate_argnums=(0,))
def _run_scan(sim, params, cfg, view_size, t0, dt, steps, flow_off=False):
    from tendrils.engine import run_headless
    # flow_off is decided host-side (params are traced here).
    return run_headless(sim, params, cfg, view_size, t0, dt, steps,
                        flow_off=flow_off)


def _scan_once(eng, steps, t0=0.0):
    """One scan of `steps` frames, waited for on the device (jit cache
    keyed on (cfg, steps) — no per-call recompiles)."""
    from tendrils.engine import flow_force_unused
    eng.sim = _run_scan(eng.sim, eng.params(), eng.config, eng._view_size,
                        jnp.float32(t0), DT, steps,
                        flow_off=flow_force_unused(eng.state))
    jax.block_until_ready(eng.sim)


def _scan_steps(eng, steps):
    """Warm-up scan + timed scan, return seconds per step."""
    _scan_once(eng, steps)
    t0 = time.perf_counter()
    _scan_once(eng, steps, t0=steps * DT)
    return (time.perf_counter() - t0) / steps


def _line(config, n, sec_per_step, device, **more):
    name, _, _, desc = CONFIGS[config]
    psteps = n / sec_per_step
    print(json.dumps({
        "metric": "particle_steps_per_sec",
        "config": name,
        "value": round(psteps),
        "unit": f"particle-steps/s ({desc})",
        "ms_per_step": sec_per_step * 1000,
        "vs_baseline": round(psteps / BASELINE_PSTEPS, 4),
        "device": device,
        **more,
    }), flush=True)


def bench_default(device):
    eng = _engine(2)
    psteps = eng.config.n / _scan_steps(eng, 90)
    # Driver contract line: exactly the documented four keys; the device
    # rides in the unit.
    print(json.dumps({
        "metric": "particle_steps_per_sec",
        "value": round(psteps),
        "unit": ("particle-steps/s (1M particles, flow feedback + 1080p "
                 f"trail; {device['platform']} {device['kind']} "
                 f"x{device['count']})"),
        "vs_baseline": round(psteps / BASELINE_PSTEPS, 4),
    }), flush=True)


def bench_all(device, only=None):
    def want(k):
        return only is None or only == k

    # 1: default demo preset scale, 256², noise-only.
    if want(1):
        eng = _engine(1)
        eng.state["flowWeight"] = 0.0
        _line(1, eng.config.n, _scan_steps(eng, 180), device)

    # 2: 1M flow feedback + trail, 1080p.
    if want(2):
        eng = _engine(2)
        _line(2, eng.config.n, _scan_steps(eng, 60), device)

    if want(3):
        _bench_3(device)
    if want(4):
        _bench_4(device)
    if want(5):
        _bench_5(device)


def _bench_3(device):
    # 3: 4M respawn stress (ball respawn every 10 steps; the host spawn
    # call between scans is part of this config's semantics).
    from tendrils.ops import spawn as sp
    eng = _engine(3)
    segs, per = 3, 10

    def respawn():
        eng.spawn_shader(lambda p, e: sp.ball(p, e._frag_xy, 0.6, 0.01))

    respawn()  # warm-up compiles (spawn + scan)
    _scan_once(eng, per)
    t0 = time.perf_counter()
    for _ in range(segs):
        respawn()
        _scan_once(eng, per)
    sec = (time.perf_counter() - t0) / (segs * per)
    _line(3, eng.config.n, sec, device)


def _bar_image(i):
    """A synthetic 480p camera frame: a white bar moving right."""
    img = np.zeros((480, 640, 3), np.uint8)
    img[:, (i * 8) % 600:(i * 8) % 600 + 40] = 255
    return img


def _bench_4(device):
    # 4: optical-flow-driven (synthetic moving-bar camera at 480p). The
    # whole frame — optical-flow kernel + composite + step + draw — is ONE
    # dispatch (`engine.step_draw_io`); the per-frame host work is the video
    # upload, like the reference's texture upload (`demo.main.js:1131-1160`).
    from tendrils import media
    eng = _engine(4)
    of = media.OpticalFlow({"offset": 0.05, "speed": 0.08})
    of_uniforms = {"offset": 0.05, "speed": 0.08}
    frames = 20

    def of_frame(i):
        of.set_pixels(_bar_image(i))
        eng.timer.tick()
        eng.step_draw_io(of_frames=of.device_buffers(),
                         of_uniforms=of_uniforms)
        of.step()

    of_frame(0)
    jax.block_until_ready(eng.sim)
    t0 = time.perf_counter()
    for i in range(frames):
        of_frame(i + 1)
    jax.block_until_ready(eng.sim)
    sec = (time.perf_counter() - t0) / frames

    # Device-side number: the SAME per-frame pipeline scanned over a
    # pre-uploaded u8 frame stack in ONE dispatch, without the per-frame
    # host→device upload. The headline stays the end-to-end number.
    steps_dev = 90
    stack = jnp.asarray(np.stack([
        media.image_to_grid(_bar_image(i), keep_u8=True)
        for i in range(steps_dev + 1)]))
    jax.block_until_ready(stack)
    sec_dev = None
    for _ in range(2):  # first call compiles; second is the timed run
        t0 = time.perf_counter()
        eng.sim = _bench4_device_scan(eng.sim, stack, eng.params(),
                                      eng.config, eng._view_size)
        jax.block_until_ready(eng.sim)
        sec_dev = (time.perf_counter() - t0) / steps_dev
    _line(4, eng.config.n, sec, device,
          device_ms_per_step=sec_dev * 1000,
          device_vs_baseline=round(
              eng.config.n / sec_dev / BASELINE_PSTEPS, 4))


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def _bench4_device_scan(sim, frame_stack, params, cfg, view_size):
    """Config-4's per-frame pipeline under `lax.scan`: step + draw, then
    optical flow between consecutive pre-uploaded u8 frames composited into
    the flow grid (the next logic step sees the optical flow written this
    frame, `demo.main.js:1131-1160`) — the device-only cost of the config-4
    frame."""
    import dataclasses

    from tendrils.engine import draw_sim, step_sim
    from tendrils.ops.optical_flow import composite_flow, optical_flow

    dt = jnp.float32(DT)
    fh, fw = cfg.flow_shape
    n_steps = frame_stack.shape[0] - 1

    def body(sim, xt):
        cur, last, i = xt
        time = dt * (i + 1.0)
        sim = step_sim(sim, params, time, dt, cfg, view_size)
        sim = draw_sim(sim, params, time, cfg, view_size)
        payload = optical_flow(cur, last, time, offset=jnp.float32(0.05),
                               lambda_=jnp.float32(0.001),
                               speed=jnp.float32(0.08),
                               speed_limit=params["speedLimit"])
        if payload.shape[1:] != (fh, fw):
            import jax.image
            payload = jax.image.resize(payload, (4, fh, fw), "bilinear")
        return dataclasses.replace(
            sim, flow=composite_flow(sim.flow, payload)), ()

    xs = (frame_stack[1:], frame_stack[:-1],
          jnp.arange(n_steps, dtype=jnp.float32))
    sim, _ = jax.lax.scan(body, sim, xs)
    return sim


def _bench_5(device):
    # 5: live-show: 16M particles, 4K trail, audio-style modulation + bokeh
    # run EVERY frame (the live-show config includes post). The whole show
    # frame — step + draw + bokeh screen pass — is ONE dispatch
    # (`engine.step_draw_io`), like the reference's per-frame pass stack.
    eng = _engine(5)
    frames = 5

    def show_frame(i):
        eng.state["noiseScale"] = 2.0 + 0.5 * (i % 3)  # audio-style mod
        eng.timer.tick()
        return eng.step_draw_io(bokeh=(3.0, 40.0))

    jax.block_until_ready(show_frame(0))
    t0 = time.perf_counter()
    for i in range(frames):
        screen = show_frame(i + 1)
    jax.block_until_ready(screen)
    sec = (time.perf_counter() - t0) / frames
    _line(5, eng.config.n, sec, device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_info()
    from tendrils.compile_cache import enable_compile_cache
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip(), file=sys.stderr, flush=True)
    if "--config" in argv:
        bench_all(device, only=int(argv[argv.index("--config") + 1]))
    elif "--all" in argv:
        bench_all(device)
    else:
        bench_default(device)


if __name__ == "__main__":
    main()
