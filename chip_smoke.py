"""On-card smoke run: the engine's main path once, at published sizes, checked
against the repo's plain references.

    python chip_smoke.py               # one GPU: phases 0-4
    python chip_smoke.py --devices 4   # only the sharded frames, 1x4 mesh

Phases, each printing one `phase ...` line of findings:

  0. device: the first JAX device must be a GPU (the script exits non-zero
     otherwise and never falls back to the CPU); the card's name and power
     limit from `nvidia-smi`.
  1. config 2 (1M particles, 1080p, flow feedback): `Tendrils.frame` and a
     `run_headless` scan, evidence of life, ms per frame, per-layer times,
     one frame from one host-uploaded state on the GPU and on the CPU, and
     the GPU's run-to-run difference.
  2. the segment splat on a 1080p grid against the numpy GL_LINES oracle
     (`tests/gl_line_oracle.py`), and the bilinear flow gather against a
     numpy bilinear.
  3. demo: `TendrilsDemo.render` (-> `step_draw_io`) with a preset, pointer
     flow lines and camera optical flow, at 720p.
  4. config 5 (16.7M particles, 4K trail, bokeh every frame): compiled
     memory analysis, ms per `step_draw_io` frame, per-layer times, peak
     device memory, and the blur A/B (cumsum box stack against dense
     matrix products in default and highest precision).

`--devices N` runs only the multi-device phase: `parallel_frame` and
`spatial_frame` at config 5 on a 1xN mesh, each against the single-card
frame from the same state.

All work stays in this one process (one JAX process per card). The last
line of stdout is `{"ok": true, "device": {...}}`; any failed check raises,
so the script then exits non-zero without it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
# The CPU backend is the reference side of the GPU-vs-CPU comparisons; keep
# it available when the environment names the platforms.
_PLATFORMS = os.environ.get("JAX_PLATFORMS")
if _PLATFORMS and "cpu" not in _PLATFORMS.split(","):
    os.environ["JAX_PLATFORMS"] = _PLATFORMS + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tendrils import engine  # noqa: E402
from tendrils.compile_cache import enable_compile_cache  # noqa: E402
from tendrils.models import configs  # noqa: E402
from tendrils.ops import post, sample, splat  # noqa: E402

sys.path.insert(0, os.path.join(_HERE, "tests"))
from gl_line_oracle import gl_lines_exact  # noqa: E402

DT = 1000.0 / 60.0


# --- helpers (tested on the CPU in tests/test_chip_smoke.py) ---------------


def report(phase, **findings):
    print(f"phase {phase}: " + json.dumps(findings, sort_keys=True),
          flush=True)


def time_ms(fn, reps):
    """Median, min and max wall ms of `fn()` over `reps` calls, each ended
    with `block_until_ready` (JAX returns before the device finishes)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(out)), "min": float(np.min(out)),
            "max": float(np.max(out)), "reps": reps}


def diff_stats(got, want):
    """Absolute differences: max, 99.9th percentile and mean."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return {"max": float(d.max()), "q999": float(np.quantile(d, 0.999)),
            "mean": float(d.mean())}


def check_close(name, got, want, *, bulk, bulk_frac, bound):
    """At least `bulk_frac` of the elements within `bulk` of the reference,
    and every element within `bound`. Returns the difference stats; raises
    AssertionError naming `name` otherwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    d = np.abs(got - want)
    frac = float((d <= bulk).mean())
    stats = dict(diff_stats(got, want), frac_within_bulk=frac)
    if frac < bulk_frac or d.max() > bound:
        raise AssertionError(
            f"{name}: {stats} (want {bulk_frac} within {bulk}, all within "
            f"{bound})")
    return stats


def grid_scale(grid):
    """Per-channel max |value| of a `[C, H, W]` grid, shaped to broadcast;
    grid differences are judged relative to their channel's scale."""
    g = np.abs(np.asarray(grid, np.float64))
    return np.maximum(g.reshape(g.shape[0], -1).max(axis=1), 1e-30)[
        :, None, None]


def life(sim):
    """Evidence of life: alive particles, flow texels with weight, view
    alpha, all finite."""
    p = np.asarray(sim.particles)
    flow = np.asarray(sim.flow)
    view = np.asarray(sim.view[0])
    out = {"alive": int((p[0] > -9e5).sum()),
           "flow_texels": int((flow[3] > 1e-3).sum()),
           "view_alpha_max": float(view[3].max()),
           "finite": bool(np.isfinite(p).all() and np.isfinite(flow).all()
                          and np.isfinite(view).all())}
    if not (out["finite"] and out["alive"] and out["flow_texels"]
            and out["view_alpha_max"] > 0):
        raise AssertionError(f"no evidence of life: {out}")
    return out


def numpy_bilinear(grid, x, y):
    """Plain numpy twin of `sample.bilinear_sample` (clamp-to-edge, texel
    centres at +0.5), in float64."""
    c, h, w = grid.shape
    gx = np.clip(np.asarray(x, np.float64), 0.5, w - 0.5) - 0.5
    gy = np.clip(np.asarray(y, np.float64), 0.5, h - 0.5) - 0.5
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    fx, fy = gx - x0, gy - y0
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    g = np.asarray(grid, np.float64)
    top = g[:, y0, x0] * (1 - fx) + g[:, y0, x1] * fx
    bot = g[:, y1, x0] * (1 - fx) + g[:, y1, x1] * fx
    return top * (1 - fy) + bot * fy


def to_host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_device(tree, device):
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, device), tree)


def gpu_device():
    """The first JAX device, which must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (first device is "
                         f"{dev.platform}); nothing was run")
    return dev


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# --- phases ----------------------------------------------------------------


def one_frame(sim, params, cfg, view_size, t):
    return engine._frame_jit(sim, params, t, jnp.float32(DT), cfg, view_size)


def frame_on(device, host_sim, host_params, cfg, host_vs, t):
    """One step+draw frame on `device` from host-side state."""
    sim = engine._frame_jit(to_device(host_sim, device),
                            to_device(host_params, device),
                            jax.device_put(np.float32(t), device),
                            jax.device_put(np.float32(DT), device), cfg,
                            jax.device_put(host_vs, device))
    return to_host(sim)


def compare_frames(name, got, want, speed_limit):
    """Frame outputs of two devices from one state. Tolerances:

    - particles: the step has no reduction, so rows differ only by the
      compilers' transcendental ulps and fused multiply-adds; 99.9% of
      values within 1e-5. A few may flip a simplex-cell `floor` (or the
      noise permutation's `mod`), which changes that particle's force;
      its new velocity is clamped to `speedLimit`, so no row can move more
      than `2·speedLimit` from the reference.
    - flow and view grids: atomic scatter-adds sum in another order
      (relative error ~1e-7 per add, a few hundred adds per texel), so
      99.9% of texels within 1e-4 of their channel's scale; texels hit by a
      flipped particle's segment can differ by up to the channel's scale.
    """
    p = check_close(f"{name} particles", got.particles, want.particles,
                    bulk=1e-5, bulk_frac=0.999,
                    bound=2 * speed_limit + 1e-6)
    out = {"particles": p}
    for key in ("flow", "view"):
        g, w = getattr(got, key), getattr(want, key)
        if key == "view":
            g, w = g[0], w[0]
        s = grid_scale(w)
        out[key] = check_close(f"{name} {key}", g / s, w / s, bulk=1e-4,
                               bulk_frac=0.999, bound=1.0)
    return out


def layer_times(eng, reps, bokeh=None):
    """Device ms of each layer of the frame, each jitted alone on the
    engine's current state: logic step with its flow gather, flow splat,
    view splat, resolve and fade, and post (bokeh) when given."""
    cfg, vs, params = eng.config, eng._view_size, eng.params()
    t, dt = jnp.float32(eng.timer.time), jnp.float32(DT)
    sim = eng.sim
    flow_splat = jax.jit(lambda s: engine.flow_parts(s, params, t, cfg, vs))
    view_splat = jax.jit(lambda s: engine.view_parts(s, params, t, cfg, vs))
    fp, vp = flow_splat(sim), view_splat(sim)
    layers = {
        "logic_gather": (jax.jit(
            lambda s: engine.step_sim(s, params, t, dt, cfg, vs).particles),
            (sim,)),
        "flow_splat": (flow_splat, (sim,)),
        "view_splat": (view_splat, (sim,)),
        "resolve_fade": (jax.jit(lambda s, fp, vp: (
            splat.composite_over(s.flow, *fp),
            splat.composite_over(engine.faded_view(s, params), *vp))),
            (sim, fp, vp)),
    }
    if bokeh is not None:
        layers["post_bokeh"] = (jax.jit(
            lambda v, m: post.bokeh(v, *bokeh, mats=m)),
            (sim.view[0], eng._blur_mats((2, 6, 16))))
    out = {}
    for name, (fn, args) in layers.items():
        jax.block_until_ready(fn(*args))
        out[name] = time_ms(lambda fn=fn, args=args: fn(*args),
                            reps)["median"]
    return out


def phase1_config2(cpu, build=configs.one_m_flow, frames=20):
    eng = build()
    cfg = eng.config
    warm = time_ms(eng.frame, 2)
    frame = time_ms(lambda: eng.frame().sim, frames)
    report("1 config2 frame", n=cfg.n, view_res=cfg.view_res,
           ms_per_frame=frame, first_two_frames_ms=warm,
           life=life(eng.sim))

    steps = 30
    params = eng.params()
    scan = jax.jit(engine.run_headless,
                   static_argnames=("cfg", "steps", "flow_off"))
    args = (params, cfg, eng._view_size, jnp.float32(eng.timer.time),
            jnp.float32(DT))
    jax.block_until_ready(scan(eng.sim, *args, steps=steps))
    t = time_ms(lambda: scan(eng.sim, *args, steps=steps), 3)
    report("1 config2 run_headless", steps=steps,
           ms_per_step=t["median"] / steps,
           life=life(scan(eng.sim, *args, steps=steps)))

    report("1 config2 layers", ms=layer_times(eng, 10))

    # One frame from one host-side state on each device.
    host_sim = to_host(eng.sim)
    host_params = to_host(eng.params())
    host_vs = np.asarray(eng._view_size)
    t_next = eng.timer.time + DT
    gpu = jax.devices()[0]
    a = frame_on(gpu, host_sim, host_params, cfg, host_vs, t_next)
    b = frame_on(gpu, host_sim, host_params, cfg, host_vs, t_next)
    c = frame_on(cpu, host_sim, host_params, cfg, host_vs, t_next)
    sl = float(host_params["speedLimit"])
    report("1 config2 gpu-vs-cpu",
           **compare_frames("config2 gpu-vs-cpu", a, c, sl))
    report("1 config2 gpu-run-to-run",
           particles=diff_stats(a.particles, b.particles),
           flow=diff_stats(a.flow, b.flow), view=diff_stats(a.view, b.view))


def phase2_splat_gather(cpu, grid_hw=(1080, 1920), n=4000, m=1 << 20,
                        seed=0):
    rng = np.random.RandomState(seed)
    h, w = grid_hw
    p0 = np.stack([rng.uniform(4, w - 4, n),
                   rng.uniform(4, h - 4, n)], -1).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    ln = rng.uniform(0.2, 4.0, n)
    p1 = (p0 + np.stack([np.cos(ang), np.sin(ang)], -1)
          * ln[:, None]).astype(np.float32)
    a = rng.uniform(0.05, 0.5, n).astype(np.float32)
    vals = np.ones((1, n), np.float32)

    acc = jax.jit(lambda p0, p1, v, a: splat.splat_segments_accumulate(
        p0, p1, v, a, grid_hw=(h, w), width=1.0, samples=4, rows=1))
    gpu = jax.devices()[0]
    args = [jax.device_put(x, gpu) for x in (p0, p1, vals, a)]
    logt = np.asarray(acc(*args)[2])
    ours = 1.0 - np.exp(logt)
    _, gl = gl_lines_exact(np.zeros((1, h, w), np.float32), p0, p1, vals, a,
                           1.0)
    mass = float(ours.sum() / gl.sum())
    corr = float(np.corrcoef(ours.ravel(), gl.ravel())[0, 1])
    # The splat's acceptance against the GL pen (tests/test_splat_oracle.py):
    # total coverage mass within 5%, spatial correlation above 0.8.
    if abs(mass - 1.0) >= 0.05 or corr <= 0.8:
        raise AssertionError(f"splat vs GL oracle: mass {mass}, corr {corr}")
    cpu_logt = np.asarray(
        acc(*[jax.device_put(x, cpu) for x in (p0, p1, vals, a)])[2])
    # Same XLA operator on both devices; only the atomic add order differs.
    splat_cpu = check_close("splat gpu-vs-cpu logt", logt, cpu_logt,
                            bulk=1e-6, bulk_frac=0.999, bound=1e-5)

    grid = rng.rand(4, h, w).astype(np.float32)
    # Positions spill past every edge to exercise clamp-to-edge.
    x = rng.uniform(-8, w + 8, m).astype(np.float32)
    y = rng.uniform(-8, h + 8, m).astype(np.float32)
    got = jax.jit(sample.bilinear_sample)(*[jax.device_put(v, gpu)
                                           for v in (grid, x, y)])
    # Interpolation of values in [0, 1]: f32 rounding of the weights and
    # fused multiply-adds only.
    gather = check_close("bilinear gather", got,
                         numpy_bilinear(grid, x, y), bulk=1e-6,
                         bulk_frac=0.999, bound=1e-5)
    report("2 splat+gather", grid=[h, w], segments=n, gl_mass_ratio=mass,
           gl_correlation=corr, splat_gpu_vs_cpu=splat_cpu,
           gather_samples=m, gather_vs_numpy=gather)


def _bar_frame(i):
    """A synthetic 360p camera frame: a white bar moving right."""
    frame = np.zeros((360, 640, 3), np.uint8)
    frame[:, (i * 16) % 600:(i * 16) % 600 + 40] = 255
    return frame


def phase3_demo(view_res=(720, 1280), **engine_kw):
    from tendrils.app import TendrilsDemo

    demo = TendrilsDemo({}, view_res=view_res,
                        **dict(configs.SAMPLING, **engine_kw))
    demo.apply_preset("Kelp Forest")
    h, w = view_res
    for i in range(8):
        demo.pointer_move("p", w * (0.3 + 0.05 * i), h * (0.5 + 0.02 * i))
        demo.feed_video_frame(_bar_frame(i))
        demo.render()
    jax.block_until_ready(demo.screen)
    times = []
    for i in range(8, 16):
        demo.pointer_move("p", w * (0.7 - 0.05 * (i - 8)), h * 0.4)
        demo.feed_video_frame(_bar_frame(i))
        t0 = time.perf_counter()
        demo.render()
        jax.block_until_ready(demo.screen)
        times.append((time.perf_counter() - t0) * 1e3)
    screen = np.asarray(demo.screen_image)
    if not np.isfinite(screen).all():
        raise AssertionError("demo screen has non-finite values")
    report("3 demo", preset="Kelp Forest", view_res=[h, w],
           n=demo.tendrils.config.n, ms_per_render=float(np.median(times)),
           life=life(demo.tendrils.sim))


def cumsum_stack(img, radii):
    """The blur stack as sequential edge-replicated box blurs through
    cumulative sums: O(H·W·C) work per level, the alternative that
    `post.blur_stack`'s dense matrices were measured against."""

    def box_axis(x, r, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r + 1, r)
        c = jnp.cumsum(jnp.pad(x, pad, mode="edge"), axis=axis)
        n = x.shape[axis]
        hi = jax.lax.slice_in_dim(c, 2 * r + 1, 2 * r + 1 + n, axis=axis)
        return (hi - jax.lax.slice_in_dim(c, 0, n, axis=axis)) / (2 * r + 1)

    def box(x, r):
        return box_axis(box_axis(x, r, 1), r, 2)

    stack, prev = [img], 0
    for r in radii:
        rr = max(1, (r - prev) // 2 + 1)
        stack.append(box(box(stack[-1], rr), rr))
        prev = r
    return stack


def blur_ab(view, reps):
    """The bokeh blur stack (4 channels, radii (2, 6, 16)) at the view's
    size: `post.blur_stack`'s dense matrix products in default and highest
    matmul precision against `cumsum_stack`. Returns ms and each matrix
    variant's difference from the cumsum stack."""
    radii = (2, 6, 16)
    mats = jax.device_put(post.blur_stack_matrices(view.shape[1:], radii))
    cumsum = jax.jit(lambda v: cumsum_stack(v, radii))
    mm = jax.jit(lambda v, m: post.blur_stack(v, radii, mats=m))
    ref = np.asarray(cumsum(view)[-1])
    out = {"cumsum_ms": time_ms(lambda: cumsum(view), reps)["median"]}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(mm(view, mats)[-1])
            out[f"matmul_{prec}_ms"] = time_ms(lambda: mm(view, mats),
                                               reps)["median"]
        out[f"matmul_{prec}_vs_cumsum"] = diff_stats(got, ref)
    return out


def phase4_config5(build=configs.live_show_16m):
    eng = build()
    cfg = eng.config
    bokeh = (3.0, 40.0)
    t0 = time.perf_counter()
    lowered = engine._frame_io_jit.lower(
        eng.sim, eng.params(), jnp.float32(DT), jnp.float32(DT), cfg,
        eng._view_size, None, None, None, None, None,
        (*eng._cached_scalars("_bokeh", bokeh), eng._blur_mats((2, 6, 16))),
        stepping=True, flow_off=False)
    mem = lowered.compile().memory_analysis()
    compile_s = time.perf_counter() - t0
    mem_info = {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)}

    def show_frame():
        eng.timer.tick()
        return eng.step_draw_io(bokeh=bokeh)

    warm = time_ms(show_frame, 2)
    frame = time_ms(show_frame, 5)
    stats = jax.devices()[0].memory_stats() or {}
    report("4 config5 frame", n=cfg.n, view_res=cfg.view_res,
           compile_s=compile_s, memory_analysis=mem_info,
           peak_bytes_in_use=int(stats.get("peak_bytes_in_use", -1)),
           ms_per_frame=frame, first_two_frames_ms=warm,
           life=life(eng.sim))
    report("4 config5 layers", ms=layer_times(eng, 5, bokeh=bokeh))
    report("4 blur A/B", view_res=cfg.view_res,
           **blur_ab(eng.sim.view[0], 5))


def phase_devices(n_dev, build=configs.live_show_16m):
    from tendrils.parallel import (make_mesh, parallel_frame, shard_sim,
                                   shard_sim_spatial, spatial_frame)

    devices = jax.devices()
    if len(devices) < n_dev:
        raise SystemExit(f"chip_smoke: --devices {n_dev} but JAX sees "
                         f"{len(devices)}")
    mesh = make_mesh(devices[:n_dev])
    eng = build()
    for _ in range(3):
        eng.frame()
    cfg = eng.config
    host_sim = to_host(eng.sim)
    params = eng.params()
    vs = eng._view_size
    t, dt = jnp.float32(eng.timer.time + DT), jnp.float32(DT)
    eng.sim = None

    def timed_frames(sim, frame):
        # The frame functions donate their input: carry the state along.
        box = [sim]

        def run():
            box[0] = frame(box[0])
            return box[0]
        return time_ms(run, 3)["median"]

    single = one_frame(to_device(host_sim, devices[0]), params, cfg, vs, t)
    ref = to_host(single)
    out = {"single_ms_per_frame": timed_frames(
        single, lambda s: one_frame(s, params, cfg, vs, t))}
    del single
    sl = float(params["speedLimit"])
    for name, shard, frame in (("parallel_frame", shard_sim, parallel_frame),
                               ("spatial_frame", shard_sim_spatial,
                                spatial_frame)):
        def step(s, frame=frame):
            return frame(s, params, t, dt, cfg, vs, mesh)
        got = step(shard(host_sim, mesh))
        out[name] = {"vs_single": compare_frames(name, to_host(got), ref,
                                                 sl),
                     "ms_per_frame": timed_frames(got, step)}
        del got
    report(f"devices {n_dev}", n=cfg.n, view_res=cfg.view_res, **out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="run only the sharded frames on a 1xN mesh")
    args = ap.parse_args(argv)

    dev = gpu_device()
    enable_compile_cache()
    smi = nvidia_smi()
    report("0 device", platform=dev.platform, kind=dev.device_kind,
           count=len(jax.devices()), jax=jax.__version__)
    if args.devices:
        phase_devices(args.devices)
    else:
        cpu = jax.devices("cpu")[0]
        phase1_config2(cpu)
        phase2_splat_gather(cpu)
        phase3_demo()
        phase4_config5()
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
