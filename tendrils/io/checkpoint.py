"""Checkpoint / resume.

The reference persists *parameters* (presets, shareable URLs, keyframe
capture — `demo.main.js:1281-1293`) and reconstructs sim state by respawning.
This build keeps that param-first model AND adds real state checkpointing
(SURVEY §5): the full `SimState` pytree + engine params + timer, as one npz —
so long trajectories resume bit-exactly, which respawn cannot give.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from ..state import SimState


def save_checkpoint(path, engine):
    """Dump engine sim state + live params + timer to `path` (.npz)."""
    arrays = {f.name: np.asarray(getattr(engine.sim, f.name))
              for f in dataclasses.fields(engine.sim)}
    meta = {
        "state": {k: v for k, v in engine.state.items()},
        "timer": {"time": engine.timer.time, "since": engine.timer.since,
                  "offset": engine.timer.offset, "rate": engine.timer.rate,
                  "step": engine.timer.step, "dt": engine.timer.dt,
                  "paused": engine.timer.paused, "end": engine.timer.end,
                  "loop": engine.timer.loop},
        "config": {
            "root_num": engine.config.root_num,
            "view_res": list(engine.config.view_res),
            "flow_res": (list(engine.config.flow_res)
                         if engine.config.flow_res else None),
        },
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path


def load_checkpoint(path, engine):
    """Restore a checkpoint into an engine (must have compatible config —
    rebuild with `setup(root_num)` / `resize` first if shapes differ)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))

    cfg = meta["config"]
    if cfg["root_num"] != engine.config.root_num:
        engine.setup(cfg["root_num"])
    ck_flow = tuple(cfg["flow_res"]) if cfg["flow_res"] else None
    ck_flow_shape = ck_flow if ck_flow else tuple(cfg["view_res"])
    if (tuple(cfg["view_res"]) != tuple(engine.config.view_res)
            or ck_flow_shape != tuple(engine.config.flow_shape)):
        engine.resize(tuple(cfg["view_res"]), ck_flow)

    kw = {f.name: jnp.asarray(data[f.name])
          for f in dataclasses.fields(SimState) if f.name in data}
    engine.sim = SimState(**kw)
    engine.state.update(meta["state"])
    for k, v in meta["timer"].items():
        setattr(engine.timer, k, v)
    return engine
