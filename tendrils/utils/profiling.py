"""Tracing & profiling (SURVEY §5: the reference has none — greenfield).

Two layers:
  - `FrameProfiler`: lightweight per-pass wall timing, each section ended
    with `jax.block_until_ready` on its result (JAX dispatch returns before
    the device finishes), keeping a ring of recent frames plus running
    stats.
  - `trace()`: context manager around `jax.profiler` for full XLA traces.
"""

import contextlib
import time
from collections import defaultdict, deque

import jax
import numpy as np


def sync(x):
    """Wait until the device has finished computing every array of `x`."""
    return jax.block_until_ready(x)


class FrameProfiler:
    def __init__(self, history=120):
        self.history = history
        self.frames = deque(maxlen=history)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._current = None

    def begin_frame(self):
        self._current = {}
        self._t0 = time.perf_counter()
        return self

    @contextlib.contextmanager
    def section(self, name, result=None):
        """Time a named pass; pass `result` (any pytree) to sync on exit."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("result", result)
            if out is not None:
                sync(out)
            dt = time.perf_counter() - t0
            if self._current is not None:
                self._current[name] = self._current.get(name, 0.0) + dt
            self.totals[name] += dt
            self.counts[name] += 1

    def end_frame(self):
        if self._current is not None:
            self._current["frame"] = time.perf_counter() - self._t0
            self.frames.append(self._current)
            self._current = None
        return self

    def summary(self):
        """Mean/p50/p95 per section over the retained frames (seconds)."""
        keys = set()
        for f in self.frames:
            keys.update(f)
        out = {}
        for k in sorted(keys):
            vals = np.asarray([f[k] for f in self.frames if k in f])
            if vals.size:
                out[k] = {
                    "mean": float(vals.mean()),
                    "p50": float(np.percentile(vals, 50)),
                    "p95": float(np.percentile(vals, 95)),
                    "count": int(vals.size),
                }
        return out

    def report(self):
        lines = []
        for k, s in self.summary().items():
            lines.append(f"{k:>24}: mean {s['mean']*1e3:7.2f} ms  "
                         f"p50 {s['p50']*1e3:7.2f}  p95 {s['p95']*1e3:7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir):
    """XLA profiler trace (view with xprof/tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
