"""Full logic-step formula vs an independent numpy oracle transcribed
directly from `src/logic.frag:45-101` (noise disabled so the oracle needs no
simplex implementation; flow/target/damping/clamp/integration all exact)."""

import jax.numpy as jnp
import numpy as np

from tendrils.engine import default_params
from tendrils.ops import logic


def numpy_logic_oracle(pos, vel, flow_grid, targets, p, uv, i01, view_size,
                       time, dt):
    """Direct transcription of logic.frag with noiseWeight = 0."""
    def vary(base, off, variance):
        return base + off * variance * base

    n = pos.shape[1]
    new_pos = pos.copy()
    new_vel = vel.copy()
    c, h, w = flow_grid.shape
    for k in range(n):
        if pos[0, k] == -1e6 and pos[1, k] == -1e6:
            continue
        i = i01[k]
        # flowAtScreenPos(pos*viewSize, flow, time, flowDecay), levels=1:
        sx = pos[0, k] * view_size[0]
        sy = pos[1, k] * view_size[1]
        u = (sx * 0.5 + 0.5) * w
        v = (sy * 0.5 + 0.5) * h
        # bilinear, CLAMP_TO_EDGE
        gu = min(max(u, 0.5), w - 0.5) - 0.5
        gv = min(max(v, 0.5), h - 0.5) - 0.5
        x0, y0 = int(np.floor(gu)), int(np.floor(gv))
        fx, fy = gu - x0, gv - y0
        x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)

        def tap(cN):
            g = flow_grid[cN]
            top = g[y0, x0] + (g[y0, x1] - g[y0, x0]) * fx
            bot = g[y1, x0] + (g[y1, x1] - g[y1, x0]) * fx
            return top + (bot - top) * fy

        fvx, fvy, stamp = tap(0), tap(1), tap(2)
        decay = max(0.0, 1.0 - (time - stamp) * p["flowDecay"])
        flow_fx, flow_fy = fvx * decay, fvy * decay

        fw = vary(p["forceWeight"], i, p["varyForce"])
        flw = vary(p["flowWeight"], i, p["varyFlow"])

        nvx = vel[0, k] * p["damping"] * dt + fw * (flow_fx * dt * flw)
        nvy = vel[1, k] * p["damping"] * dt + fw * (flow_fy * dt * flw)

        tw = vary(p["target"], i, p["varyTarget"])
        nvx += (targets[0, k] - pos[0, k]) * tw
        nvy += (targets[1, k] - pos[1, k]) * tw

        speed = np.sqrt(nvx * nvx + nvy * nvy)
        scale = min(speed, p["speedLimit"]) / max(speed, 1e-12)
        nvx, nvy = nvx * scale, nvy * scale

        new_vel[0, k], new_vel[1, k] = nvx, nvy
        new_pos[0, k] = pos[0, k] + nvx
        new_pos[1, k] = pos[1, k] + nvy
    return new_pos, new_vel


def test_full_formula_matches_oracle():
    rng = np.random.default_rng(7)
    n = 128
    pos = rng.uniform(-0.9, 0.9, (2, n)).astype(np.float32)
    vel = rng.uniform(-0.005, 0.005, (2, n)).astype(np.float32)
    pos[:, 0] = -1e6  # one inert particle
    targets = rng.uniform(-1, 1, (4, n)).astype(np.float32)
    flow_grid = rng.uniform(-0.01, 0.01, (4, 16, 32)).astype(np.float32)
    flow_grid[2] = rng.uniform(0, 100, (16, 32))  # stamps
    uv = rng.uniform(0, 1, (2, n)).astype(np.float32)
    i01 = rng.uniform(0, 1, n).astype(np.float32)
    view_size = np.asarray([1.0, 1.5], np.float32)
    time, dt = 120.0, 1000.0 / 60.0

    params = default_params()
    params = dict(params, noiseWeight=jnp.float32(0.0),
                  varyNoise=jnp.float32(0.0), target=jnp.float32(0.0004),
                  varyTarget=jnp.float32(0.5))

    out = logic.step_particles(
        jnp.asarray(np.concatenate([pos, vel])),
        [jnp.asarray(flow_grid)], jnp.asarray(targets), params,
        jnp.asarray(uv), jnp.asarray(i01), jnp.asarray(view_size), time, dt)

    pf = {k: float(v) for k, v in params.items()
          if np.ndim(v) == 0}
    exp_pos, exp_vel = numpy_logic_oracle(
        pos.astype(np.float64), vel.astype(np.float64),
        flow_grid.astype(np.float64), targets.astype(np.float64), pf,
        uv.astype(np.float64), i01.astype(np.float64),
        view_size.astype(np.float64), time, dt)

    np.testing.assert_allclose(np.asarray(out[:2]), exp_pos, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(out[2:]), exp_vel, rtol=1e-4,
                               atol=1e-7)
    # Inert particle untouched.
    assert np.asarray(out)[0, 0] == -1e6
