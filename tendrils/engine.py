"""The Tendrils engine — orchestration of step / draw / spawn / resize.

JAX re-derivation of `src/index.js:83-458`. Where the reference owns FBOs
and issues GL passes, this engine owns a `SimState` pytree and composes pure
ops into one jitted frame function:

    frame(sim, params, time, dt):
        particles' = logic_step(particles, flow, targets)   # src/index.js:248-272
        flow'      = splat(flow, prev->curr segments, flow payload)
                                                            # src/index.js:296-303
        view'      = fade(view); view' = splat(view', render colours)
                                                            # src/index.js:317-337
ordering invariant preserved: the step reads the flow *before* the new flow is
splatted ("so particles don't respond to their own flow",
`src/index.js:297-298`) — functional dataflow makes this explicit.

All ~20 reference state fields are traced arguments (never recompiled on
change); structural settings (rootNum, resolutions, splat sample counts) are
static config and rebuilding them is `setup()`, like the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import state as state_mod
from .const import INERT

from .ops import coords, flow as flow_ops, logic, render, spawn as spawn_ops
from .ops import splat as splat_ops
from .timer import Timer


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (shape/compile-affecting) engine configuration."""
    root_num: int = 512
    view_res: tuple[int, int] = (720, 1280)  # (H, W)
    flow_res: tuple[int, int] | None = None  # defaults to view_res
    num_view_buffers: int = 1  # ref demo uses numBuffers: 1
    color_map_res: tuple[int, int] = (1, 1)
    flow_levels: int = 1  # ref compiles levels=1 (src/logic.frag:39)
    # Splat sampling (static): points along each segment and across the line
    # width, per pass.
    flow_samples: int = 4
    flow_rows: int = 3
    view_samples: int = 4
    view_rows: int = 1

    @property
    def n(self) -> int:
        return self.root_num * self.root_num

    @property
    def flow_shape(self) -> tuple[int, int]:
        return self.flow_res if self.flow_res is not None else self.view_res


def default_params() -> dict[str, Any]:
    """Traced-parameter schema (the reference `defaults().state` minus
    structural fields) — ref `src/index.js:29-66`."""
    st = state_mod.default_state()
    p = state_mod.params_from_state(st)
    # autoClearView / autoFade become traced 0/1 gates so presets can toggle
    # them without recompiling.
    p["autoClearView"] = jnp.float32(0.0)
    p["autoFade"] = jnp.float32(1.0)
    return p


# --- Pure frame functions ---------------------------------------------------


def flow_pyramid(flow_grid, levels):
    """LOD pyramid for multi-level flow sampling (ref
    `flow-at-screen-pos.glsl` levels loop; reference ships with levels=1 and
    mipmaps disabled, `src/index.js:305-312`)."""
    grids = [flow_grid]
    g = flow_grid
    for _ in range(1, levels):
        c, h, w = g.shape
        g = g.reshape(c, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        grids.append(g)
    return grids


def flow_force_unused(src) -> bool:
    """Host-known `flowWeight == 0`: the logic's flow-force term is exactly
    zero (parameter variance is multiplicative — `vary(0, ·, ·) == 0`, ref
    `src/logic.frag:41-43`), so the step skips the flow gather entirely.
    A trace-time policy read from the host-side state dict: flipping
    flowWeight between zero and nonzero retraces once. Traced/abstract
    values keep the general path."""
    if src is None:
        return False
    try:
        return float(src.get("flowWeight", 1.0)) == 0.0
    except (TypeError, ValueError, jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        return False


def step_sim(sim: state_mod.SimState, params, time, dt, cfg: EngineConfig,
             view_size, flow_off=False):
    """Logic step + ping-pong — ref `src/index.js:248-272` +
    `src/particles.js:123-145`.

    `flow_off=True` (host-known `flowWeight == 0`, see `flow_force_unused`):
    the logic's flow term is exactly zero — parameter variance is
    multiplicative (ref `src/logic.frag:41-43`) — so the flow sampling is
    skipped entirely (no decay pass, no gather)."""
    uv, index01, _ = state_mod.particle_coords_from_idx(sim.idx,
                                                        cfg.root_num)
    flow_force_fn = None
    flows = None
    if flow_off:

        def flow_force_fn(pos_screen):
            del pos_screen
            return jnp.float32(0.0)
    else:
        flows = flow_pyramid(sim.flow, cfg.flow_levels)

    new_particles = logic.step_particles(
        sim.particles, flows, sim.targets, params, uv, index01, view_size,
        time, dt, flow_force_fn=flow_force_fn)
    return dataclasses.replace(sim, particles=new_particles,
                               previous=sim.particles)


def _segments(sim: state_mod.SimState, view_size):
    """This frame's particle segments (previous -> current position) in clip
    space, with the live mask: a segment is drawn only when both ends are
    alive (ref `src/index.js:296-303,317-337` draw `previous` to `current`)."""
    pos = sim.particles[:2]
    prev_pos = sim.previous[:2]
    alive = ((pos[0] != INERT) | (pos[1] != INERT)) & \
            ((prev_pos[0] != INERT) | (prev_pos[1] != INERT))
    p_clip0 = jnp.stack([prev_pos[0] * view_size[0],
                         prev_pos[1] * view_size[1]], axis=-1)
    p_clip1 = jnp.stack([pos[0] * view_size[0], pos[1] * view_size[1]],
                        axis=-1)
    return p_clip0, p_clip1, alive.astype(jnp.float32)


def flow_parts(sim: state_mod.SimState, params, time, cfg: EngineConfig,
               view_size):
    """Flow pass accumulation (ref `src/index.js:296-303`): each segment's
    velocity payload splatted as `(num, wsum, logt)` partial sums over the
    full flow grid (see `splat.splat_segments_accumulate`)."""
    p_clip0, p_clip1, live = _segments(sim, view_size)
    fh, fw = cfg.flow_shape
    payload = flow_ops.flow_payload(sim.particles[2:], time,
                                    params["speedLimit"])  # [4, N]
    return splat_ops.splat_segments_accumulate(
        coords.clip_to_pixel(p_clip0, (fw, fh)),
        coords.clip_to_pixel(p_clip1, (fw, fh)), payload, payload[3] * live,
        grid_hw=(fh, fw), width=params["flowWidth"],
        samples=cfg.flow_samples, rows=cfg.flow_rows)


def view_parts(sim: state_mod.SimState, params, time, cfg: EngineConfig,
               view_size):
    """View pass accumulation (ref `src/index.js:317-337`): the particles'
    render colours splatted as `(num, wsum, logt)` partial sums over the
    full view grid."""
    p_clip0, p_clip1, live = _segments(sim, view_size)
    h, w = cfg.view_res
    _, _, colormap_uv = state_mod.particle_coords_from_idx(sim.idx,
                                                           cfg.root_num)
    colors = render.particle_colors(sim.particles[:2], sim.particles[2:],
                                    colormap_uv, sim.color_map, params, time)
    return splat_ops.splat_segments_accumulate(
        coords.clip_to_pixel(p_clip0, (w, h)),
        coords.clip_to_pixel(p_clip1, (w, h)), colors, colors[3] * live,
        grid_hw=(h, w), width=params["lineWidth"],
        samples=cfg.view_samples, rows=cfg.view_rows)


def faded_view(sim: state_mod.SimState, params):
    """View buffer 0 after the optional clear and the fade (ref
    `src/index.js:317-333`), ready for this frame's splats."""
    view0 = sim.view[0] * (1.0 - params["autoClearView"])
    return render.fade_fill(view0, params["fadeColor"] * params["autoFade"])


def draw_sim(sim: state_mod.SimState, params, time, cfg: EngineConfig,
             view_size, reduce=None):
    """Flow + view render passes — ref `src/index.js:278-340`.

    `reduce` maps each pass's `(num, wsum, logt)` partial sums before the
    blend resolve. Sharded frames pass a collective: `psum` when every
    device holds the whole grid (`parallel.sharding`), a row-slab
    `psum_scatter` when each holds a slab of it (`parallel.spatial`). The
    partials are linear in the particle set, so either gives the
    single-device result (SURVEY §2.9)."""
    reduce = reduce or (lambda parts: parts)
    # Flow grid is NOT cleared: it accumulates, and decays on read.
    new_flow = splat_ops.composite_over(
        sim.flow, *reduce(flow_parts(sim, params, time, cfg, view_size)))
    view0 = splat_ops.composite_over(
        faded_view(sim, params),
        *reduce(view_parts(sim, params, time, cfg, view_size)))
    return dataclasses.replace(sim, flow=new_flow,
                               view=sim.view.at[0].set(view0))


# --- Stateful engine --------------------------------------------------------


class Tendrils:
    """Stateful engine facade mirroring the reference class API
    (`src/index.js:83`): `setup/reset/restart/step/draw/spawn/spawnShader/
    clear*/drawFade/resize` — with a functional jitted core underneath."""

    def __init__(self, config: EngineConfig | None = None, *,
                 timer: Timer | None = None, seed: int = 0, **overrides):
        self.config = config or EngineConfig(**overrides)
        # Live-tweakable parameter dict (host-side mirror of
        # `defaults().state`); converted to traced f32 leaves per call.
        self.state = state_mod.default_state()
        self.timer = timer or Timer()
        if timer is None:
            self.timer.step = 1000.0 / 60.0  # ref src/index.js:67
        self.seed = seed
        self.sim: state_mod.SimState | None = None
        self._pcache = {}  # params() device-scalar cache (see params())
        self._setup_static()

    # -- setup / teardown

    def _setup_static(self):
        cfg = self.config
        h, w = cfg.view_res
        self._view_size = jnp.asarray(coords.cover_aspect((w, h)),
                                      jnp.float32)

    # Per-particle constants derive from the row permutation `sim.idx` —
    # see `state.particle_coords_from_idx`.
    @property
    def _uv(self):
        return state_mod.particle_coords_from_idx(
            self.sim.idx, self.config.root_num)[0]

    @property
    def _index01(self):
        return state_mod.particle_coords_from_idx(
            self.sim.idx, self.config.root_num)[1]

    @property
    def _colormap_uv(self):
        return state_mod.particle_coords_from_idx(
            self.sim.idx, self.config.root_num)[2]

    @property
    def _frag_xy(self):
        return self._uv * self.config.root_num  # texel-centre frag coords

    def setup(self, root_num: int | None = None):
        """(Re)allocate particle + grid state — ref `src/index.js:149-154`."""
        if root_num is not None and root_num != self.config.root_num:
            self.config = dataclasses.replace(self.config,
                                              root_num=int(root_num))
            self.state["rootNum"] = int(root_num)
            self._setup_static()
        cfg = self.config
        self.sim = state_mod.make_state(
            cfg.root_num, cfg.view_res, cfg.num_view_buffers,
            cfg.color_map_res, self.seed, cfg.flow_shape)
        self.reset()
        return self

    def reset(self):
        """Respawn all-inert — ref `src/index.js:156-160`."""
        return self.spawn()

    def restart(self):
        """Clear + reset — ref `src/index.js:241-246`."""
        self.clear()
        return self.reset()

    # -- clears (ref src/index.js:215-239)

    def clear(self):
        return self.clear_view().clear_flow()

    def clear_view(self):
        self.sim = dataclasses.replace(self.sim,
                                       view=jnp.zeros_like(self.sim.view))
        return self

    def clear_flow(self):
        self.sim = dataclasses.replace(self.sim,
                                       flow=jnp.zeros_like(self.sim.flow))
        return self

    # -- parameters

    def params(self):
        """Traced-parameter view of `state`, with per-key device caching.

        Each `jnp.asarray` is a host-to-device put, and an interactive
        frame would otherwise pay ~24 of them per dispatch. Keep the
        converted scalar per key and re-upload only when the host value
        changed (keyed on value bytes, so in-place list mutation is
        caught)."""
        cache = self._pcache
        out = {}
        for k, v in self.state.items():
            if k in state_mod._STATIC_KEYS:
                continue
            hv = np.asarray(v, np.float32)
            hk = (hv.shape, hv.tobytes())
            ent = cache.get(k)
            if ent is None or ent[0] != hk:
                ent = (hk, jnp.asarray(hv))
                cache[k] = ent
            out[k] = ent[1]
        acv = 1.0 if self.state.get("autoClearView") else 0.0
        afd = 1.0 if self.state.get("autoFade", True) else 0.0
        for k, val in (("autoClearView", acv), ("autoFade", afd)):
            ent = cache.get(k)
            if ent is None or ent[0] != val:
                ent = (val, jnp.float32(val))
                cache[k] = ent
            out[k] = ent[1]
        return out

    def _cached_scalars(self, key, vals):
        """Device-cached tuple of f32 scalars (same rationale as
        `params()`)."""
        tv = tuple(float(v) for v in vals)
        ent = self._pcache.get(key)
        if ent is None or ent[0] != tv:
            ent = (tv, tuple(jnp.float32(v) for v in tv))
            self._pcache[key] = ent
        return ent[1]

    def _blur_mats(self, radii):
        """Device-cached blur-stack matrices for the current view res
        (`post.blur_stack_matrices`). They ride the io frame as jit
        ARGUMENTS: at 4K one radii tuple's matrices hold ~233 MB, which as
        constants would bloat the compiled program by as much."""
        from .ops import post as post_ops
        key = ("_bmats", self.config.view_res, tuple(radii))
        ent = self._pcache.get(key)
        if ent is None:
            ent = post_ops.blur_stack_matrices(self.config.view_res,
                                               tuple(radii))
            self._pcache[key] = ent
        return ent

    # -- per-frame API

    def step(self):
        """Ref `src/index.js:248-272` (honours timer pause)."""
        if not self.timer.paused:
            self.sim = _step_jit(self.sim, self.params(),
                                 jnp.float32(self.timer.time),
                                 jnp.float32(self.timer.dt), self.config,
                                 self._view_size,
                                 flow_off=flow_force_unused(self.state))
        return self

    def draw(self):
        """Ref `src/index.js:278-340`."""
        self.sim = _draw_jit(self.sim, self.params(),
                             jnp.float32(self.timer.time), self.config,
                             self._view_size)
        return self

    def step_draw(self):
        """step + draw in ONE device dispatch (no timer tick) — for hosts
        that tick timers themselves (the demo loop)."""
        if self.timer.paused:
            return self.draw()
        self.sim = _frame_jit(self.sim, self.params(),
                              jnp.float32(self.timer.time),
                              self._cached_scalars(
                                  "_dt", (self.timer.dt,))[0], self.config,
                              self._view_size,
                              flow_off=flow_force_unused(self.state))
        return self

    def frame(self):
        """tick + step + draw — one fused jitted frame (the hot loop)."""
        self.timer.tick()
        return self.step_draw()

    # -- spawning

    def spawn(self, spawner=None):
        """CPU-spawner equivalent: replace both ping-pong buffers — ref
        `src/index.js:425-429` + `src/particles.js:94-117`. `spawner` is a
        pure `f32[4, N] -> f32[4, N]` function (default: all-inert init)."""
        fn = spawner or spawn_ops.init
        particles = fn(self.sim.particles)
        self.sim = dataclasses.replace(self.sim, particles=particles,
                                       previous=particles)
        return self

    def spawn_shader(self, op, target=None):
        """GPU-respawn equivalent — ref `src/index.js:432-457`.

        `op(prev_particles, engine) -> f32[4, N]` is a pure spawn op. With no
        `target`, rotates the ping-pong and replaces the current state
        (reading the pre-spawn current, like the rotated `buffers[1]` bind in
        `src/particles.js:128-143`); with `target="targets"` writes the
        targets buffer without rotating (reading `previous`, the un-rotated
        `buffers[1]`)."""
        self.timer.tick()
        if target is None:
            new = op(self.sim.particles, self)
            self.sim = dataclasses.replace(self.sim, particles=new,
                                           previous=self.sim.particles)
        elif target == "targets":
            new = op(self.sim.previous, self)
            self.sim = dataclasses.replace(self.sim, targets=new)
        else:
            raise ValueError(f"unknown spawn target: {target}")
        return self

    # -- flow injection (flow lines, optical flow)

    @staticmethod
    def _bucket_segments(p0_pix, p1_pix, vel):
        """Pad the segment count to a power-of-2 bucket so a growing pointer
        path doesn't recompile every frame (pad segments are zero-velocity
        -> zero payload weight -> no deposit). Floor of 256 keeps typical
        pointer paths (with crest-row expansion) to one compilation."""
        n = int(np.shape(p0_pix)[0])
        bucket = 1 << max(8, (n - 1).bit_length())
        pad = bucket - n
        p0_pix = np.pad(np.asarray(p0_pix, np.float32), ((0, pad), (0, 0)))
        p1_pix = np.pad(np.asarray(p1_pix, np.float32), ((0, pad), (0, 0)))
        vel = np.pad(np.asarray(vel, np.float32), ((0, 0), (0, pad)))
        return p0_pix, p1_pix, vel

    def inject_flow_segments(self, p0_pix, p1_pix, vel, width_px,
                             samples=None):
        """Splat velocity-painting segments into the flow grid — the
        equivalent of drawing FlowLine ribbons into the flow FBO
        (`demo.main.js:1107-1122`). `vel`: `f32[2, S]` velocities in the
        flow-payload convention."""
        if int(np.shape(p0_pix)[0]) == 0:
            return self
        p0_pix, p1_pix, vel = self._bucket_segments(p0_pix, p1_pix, vel)
        new_flow = _inject_flow(
            self.sim.flow, jnp.asarray(p0_pix), jnp.asarray(p1_pix),
            jnp.asarray(vel), jnp.float32(max(width_px, 1.0)),
            self.params(), jnp.float32(self.timer.time), self.config,
            samples=samples or self.config.flow_samples)
        self.sim = dataclasses.replace(self.sim, flow=new_flow)
        return self

    def step_draw_io(self, *, color_maps=None, color_alphas=None,
                     segments=None, of_frames=None, of_uniforms=None,
                     blur=None, bokeh=None):
        """The whole interactive frame in ONE device dispatch (no timer
        tick, like `step_draw`): optional colour-map blend, step + draw,
        optional pointer flow-line injection, optional optical-flow
        composite, optional vignette-blur post. This is the reference's full
        per-frame stack (`demo.main.js:1024-1161`) as a single jit.

        `color_maps`: sequence of `f32[4, h, w]` grids blended into the
        colour map with `color_alphas` weights (ref `demo.main.js:1070-1079`);
        `segments`: `(p0_pix, p1_pix, vel, width_px)` pointer ribbons;
        `of_frames`: `(current, last)` optical-flow frame grids with
        `of_uniforms` dict (offset/lambda/speed); `blur`: `(radius, limit)`;
        `bokeh`: `(radius, amount)` — the reference's other screen pass
        (`src/screen/bokeh.frag`), applied after `blur` when both are set.
        Returns the post-processed screen image (or None without a post
        stage).

        While the timer is paused only the STEP stage is skipped — colour
        maps, pointer flow segments and optical-flow frames still land (the
        reference keeps drawing flow-line/optical-flow input into the flow
        FBO every frame, `demo.main.js:1107-1160`).
        """
        cm = None
        if color_maps is not None:
            cm = tuple(jnp.asarray(g, jnp.float32) for g in color_maps)
            target = max((g.shape for g in cm),
                         key=lambda sh: sh[1] * sh[2])
            if target != self.sim.color_map.shape:
                self.config = dataclasses.replace(self.config,
                                                  color_map_res=target[1:])
            color_alphas = jnp.asarray(color_alphas, jnp.float32)

        seg = None
        if segments is not None and int(np.shape(segments[0])[0]):
            p0, p1, vel = self._bucket_segments(*segments[:3])
            seg = (jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(vel),
                   jnp.float32(max(segments[3], 1.0)))

        of = None
        if of_frames is not None:
            u = dict({"offset": 1.0, "lambda": 0.001, "speed": 1.0},
                     **(of_uniforms or {}))
            # Frames keep their dtype across the upload (uint8 camera
            # frames are 4x cheaper through the host→device pipe); the
            # optical-flow op normalises on device.
            of = (jnp.asarray(of_frames[0]), jnp.asarray(of_frames[1]),
                  *self._cached_scalars(
                      "_of_u", (u["offset"], u["lambda"], u["speed"])))

        blur_t = None
        if blur is not None:
            blur_t = (*self._cached_scalars("_blur", blur),
                      self._blur_mats((1, 3, 8)))
        bokeh_t = None
        if bokeh is not None:
            bokeh_t = (*self._cached_scalars("_bokeh", bokeh),
                       self._blur_mats((2, 6, 16)))

        self.sim, screen = _frame_io_jit(
            self.sim, self.params(), jnp.float32(self.timer.time),
            self._cached_scalars("_dt", (self.timer.dt,))[0],
            self.config, self._view_size,
            cm, color_alphas, seg, of, blur_t, bokeh_t,
            stepping=not self.timer.paused,
            flow_off=flow_force_unused(self.state))
        return screen

    def composite_flow(self, payload_grid):
        """Alpha-blend a full-screen flow payload (e.g. optical flow) over
        the flow grid — ref `demo.main.js:1150-1156`."""
        from .ops.optical_flow import composite_flow as _composite
        fh, fw = self.config.flow_shape
        payload_grid = jnp.asarray(payload_grid, jnp.float32)
        if payload_grid.shape[1:] != (fh, fw):
            import jax.image
            payload_grid = jax.image.resize(payload_grid, (4, fh, fw),
                                            "bilinear")
        self.sim = dataclasses.replace(
            self.sim, flow=_composite(self.sim.flow, payload_grid))
        return self

    # -- view helpers (ref src/index.js:342-391)

    def draw_fade(self):
        p = self.params()
        view0 = render.fade_fill(self.sim.view[0], p["fadeColor"])
        self.sim = dataclasses.replace(self.sim,
                                       view=self.sim.view.at[0].set(view0))
        return self

    def copy_buffer(self, index=0):
        """Composite a view buffer's contents over the current screen output
        — ref `src/index.js:370-383` (`copyBuffer` blits buffer `index` into
        the bound target). Returns the composited `f32[4, H, W]` image (the
        headless 'screen')."""
        if index < self.config.num_view_buffers:
            return self.sim.view[index]
        return jnp.zeros_like(self.sim.view[0])

    def draw_buffer(self, index=0):
        """`drawBuffer`: copy a buffer to the screen then rotate the ring —
        ref `src/index.js:358-367`. Returns the screen image."""
        out = self.copy_buffer(index)
        self.step_buffers()
        return out

    def step_buffers(self):
        """Ring-rotate view buffers — ref `src/index.js:385-391` +
        `src/utils/index.js:1-7`."""
        if self.config.num_view_buffers > 1:
            self.sim = dataclasses.replace(
                self.sim, view=jnp.roll(self.sim.view, 1, axis=0))
        return self

    def resize(self, view_res, flow_res=None):
        """Reallocate view/flow grids — ref `src/index.js:393-408` (state
        content is not preserved across resize, same as FBO reshape)."""
        self.config = dataclasses.replace(self.config,
                                          view_res=tuple(view_res),
                                          flow_res=flow_res)
        self._setup_static()
        cfg = self.config
        h, w = cfg.view_res
        fh, fw = cfg.flow_shape
        self.sim = dataclasses.replace(
            self.sim,
            view=jnp.zeros((cfg.num_view_buffers, 4, h, w), jnp.float32),
            flow=jnp.zeros((4, fh, fw), jnp.float32))
        return self

    def set_color_map(self, color_map):
        """Replace the colour-map grid (`f32[4, h, w]`), reallocating if the
        shape changed — ref colorMap FBO `src/index.js:94-96`."""
        color_map = jnp.asarray(color_map, jnp.float32)
        if color_map.shape != self.sim.color_map.shape:
            self.config = dataclasses.replace(
                self.config, color_map_res=color_map.shape[1:])
        self.sim = dataclasses.replace(self.sim, color_map=color_map)
        return self

    @property
    def view_image(self):
        """Current view buffer as `f32[H, W, 4]`, row 0 at top (display)."""
        return jnp.transpose(self.sim.view[0], (1, 2, 0))[::-1]


# --- jitted cores -----------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "flow_off"),
                   donate_argnums=(0,))
def _step_jit(sim, params, time, dt, cfg, view_size, flow_off=False):
    return step_sim(sim, params, time, dt, cfg, view_size,
                    flow_off=flow_off)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def _draw_jit(sim, params, time, cfg, view_size):
    return draw_sim(sim, params, time, cfg, view_size)


@functools.partial(jax.jit, static_argnames=("cfg", "flow_off"),
                   donate_argnums=(0,))
def _frame_jit(sim, params, time, dt, cfg, view_size, flow_off=False):
    sim = step_sim(sim, params, time, dt, cfg, view_size, flow_off=flow_off)
    return draw_sim(sim, params, time, cfg, view_size)


def _inject_flow(flow, p0_pix, p1_pix, vel, width, params, time, cfg,
                 samples=None):
    """Pure flow-line segment injection core (ref `demo.main.js:1107-1122`);
    shared by the facade method and the fused io-frame."""
    payload = flow_ops.flow_payload(vel, time, params["speedLimit"])
    return splat_ops.splat_segments(
        flow, p0_pix, p1_pix, payload, payload[3],
        grid_hw=cfg.flow_shape, width=width,
        samples=samples or cfg.flow_samples, rows=max(1, cfg.flow_rows))


@functools.partial(jax.jit, static_argnames=("cfg", "stepping", "flow_off"),
                   donate_argnums=(0,))
def _frame_io_jit(sim, params, time, dt, cfg, view_size, cm, cm_alphas,
                  seg, of, blur, bokeh=None, stepping=True, flow_off=False):
    """One-dispatch interactive frame: [colormap blend] + step + draw +
    [flow-line inject] + [optical flow] + [vignette blur] + [bokeh].
    Optional stages are `None` (absence is part of the jit cache key via
    the pytree structure). `blur` and `bokeh` are `(radius, amount,
    blur-stack matrices)`. Ref per-frame stack: `demo.main.js:1024-1161`.

    `stepping=False` (paused timer) skips only the logic step — the draw
    and every io stage still land, like the reference's paused loop."""
    if cm is not None:
        # Blend colour maps (ref demo.main.js:1070-1079); shapes are static
        # at trace time — resize to the largest.
        import jax.image
        from .ops import post as post_ops
        target = max((g.shape for g in cm), key=lambda sh: sh[1] * sh[2])
        views = [g if g.shape == target
                 else jax.image.resize(g, target, "bilinear") for g in cm]
        sim = dataclasses.replace(sim,
                                  color_map=post_ops.blend(views, cm_alphas))

    if stepping:
        sim = step_sim(sim, params, time, dt, cfg, view_size,
                       flow_off=flow_off)
    sim = draw_sim(sim, params, time, cfg, view_size)

    if seg is not None:
        p0, p1, vel, width = seg
        sim = dataclasses.replace(
            sim, flow=_inject_flow(sim.flow, p0, p1, vel, width, params,
                                   time, cfg))

    if of is not None:
        import jax.image
        from .ops.optical_flow import composite_flow, optical_flow
        cur, last, offset, lam, speed = of
        payload = optical_flow(cur, last, time, offset=offset, lambda_=lam,
                               speed=speed, speed_limit=params["speedLimit"])
        fh, fw = cfg.flow_shape
        if payload.shape[1:] != (fh, fw):
            payload = jax.image.resize(payload, (4, fh, fw), "bilinear")
        sim = dataclasses.replace(sim,
                                  flow=composite_flow(sim.flow, payload))

    screen = None
    if blur is not None:
        from .ops import post as post_ops
        screen = post_ops.vignette_blur(sim.view[0], blur[0], blur[1],
                                        mats=blur[2])
    if bokeh is not None:
        from .ops import post as post_ops
        screen = post_ops.bokeh(
            sim.view[0] if screen is None else screen, bokeh[0], bokeh[1],
            mats=bokeh[2])
    return sim, screen


def run_headless(sim, params, cfg: EngineConfig, view_size, t0, dt, steps,
                 flow_off=False):
    """Fixed-step headless run under `lax.scan` (SURVEY §7 pillar 2).

    Frame `i` steps and draws at time `t0 + dt * (i + 1)`. Returns the
    final state."""

    def body(sim, i):
        time = t0 + dt * (i + 1)
        sim = step_sim(sim, params, time, dt, cfg, view_size,
                       flow_off=flow_off)
        return draw_sim(sim, params, time, cfg, view_size), ()

    sim, _ = jax.lax.scan(body, sim, jnp.arange(steps, dtype=jnp.float32))
    return sim
