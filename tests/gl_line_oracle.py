"""Exact numpy twin of the reference's GL_LINES rasterisation + blending.

The reference draws each particle segment as a GL_LINES primitive with
`gl.lineWidth(w)` and `SRC_ALPHA, ONE_MINUS_SRC_ALPHA` blending
(`src/index.js:300-303,335-337`, blend state :267-268). This transcribes the
OpenGL non-antialiased wide-line rule (GL 2.0 §3.4.2 / GLES 2.0 — the
WebGL1 semantics):

  - major-axis DDA: one fragment column per integer major-axis coordinate
    whose pixel centre falls inside the segment's major extent;
  - the `lineWidth` pen replicates that fragment along the MINOR window
    axis (not the segment's perpendicular): rows whose centres fall in
    `[minor - w/2, minor + w/2)`;
  - each fragment composites src-alpha-over, in submission order.

The diamond-exit endpoint rule differs by ≤1 fragment per segment between
real GPUs; this oracle uses the pixel-centre-inclusion form, which is within
that cross-GPU variation. Used by tests/test_splat_oracle.py to MEASURE the
deposit deviation of the XLA splat (euclidean-length isotropic samples) from
the GL pen (major-extent, axis-aligned) instead of merely documenting it.
"""

import numpy as np

F = np.float32


def gl_lines_exact(dst, p0, p1, colors, alphas, width):
    """Rasterise segments into `dst: f32[C, H, W]` (C colour channels; the
    alpha product is tracked separately and returned).

    `p0`, `p1`: f32[N, 2] window-pixel endpoints (x, y). `colors`:
    f32[C, N]; `alphas`: f32[N]. Returns (out f32[C, H, W],
    coverage f32[H, W] = 1 - prod(1-a))."""
    c, h, w = dst.shape
    out = dst.astype(np.float64).copy()
    transmit = np.ones((h, w), np.float64)
    width = float(max(width, 1.0))

    for i in range(p0.shape[0]):
        x0, y0 = float(p0[i, 0]), float(p0[i, 1])
        x1, y1 = float(p1[i, 0]), float(p1[i, 1])
        a = float(alphas[i])
        col = colors[:, i].astype(np.float64)
        dx, dy = x1 - x0, y1 - y0
        x_major = abs(dx) >= abs(dy)
        if x_major:
            ma0, ma1, mi0, slope = x0, x1, y0, (dy / dx if dx else 0.0)
        else:
            ma0, ma1, mi0, slope = y0, y1, x0, (dx / dy if dy else 0.0)
        if ma1 < ma0:
            # endpoint swap: the new ma0 is the original p1 end, so the
            # minor intercept becomes p1's minor coordinate (the slope is
            # direction-independent).
            ma0, ma1 = ma1, ma0
            mi0 = float(y1 if x_major else x1)
        # fragment columns: integer cells whose centre m+0.5 ∈ [ma0, ma1)
        m_lo = int(np.ceil(ma0 - 0.5))
        m_hi = int(np.ceil(ma1 - 0.5))  # exclusive
        if m_hi <= m_lo:
            # zero-extent (GL still lights the diamond containing the
            # start point for degenerate short lines via the endpoint
            # rule; approximate with the single containing cell)
            m_lo = int(np.floor(ma0))
            m_hi = m_lo + 1
        for m in range(m_lo, m_hi):
            t = ((m + 0.5) - ma0)
            minor = mi0 + slope * t
            r_lo = int(np.ceil(minor - width / 2.0 - 0.5))
            r_hi = int(np.ceil(minor + width / 2.0 - 0.5))
            if r_hi <= r_lo:
                r_hi = r_lo + 1
            for r in range(r_lo, r_hi):
                x, y = (m, r) if x_major else (r, m)
                if 0 <= x < w and 0 <= y < h:
                    out[:, y, x] = col * a + out[:, y, x] * (1.0 - a)
                    transmit[y, x] *= (1.0 - a)

    return out.astype(F), (1.0 - transmit).astype(F)
