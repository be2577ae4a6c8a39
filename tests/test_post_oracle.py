"""Measured acceptance of the blur/bokeh stack approximations against EXACT
transcriptions of the reference's shaders (tests/post_oracles.py — tap
patterns verified against the shader text inlined in the reference's shipped
bundle, `docs/js/demo-run.js`).

These bounds turn the documented deviations of `ops/post.py` into measured
ones: rel-RMS distance from the exact shader output on trail-like synthetic
frames, at the preset-used parameter points. For scale, each assertion
records the identity distance (how far NO blur is) — the approximation must
capture the bulk of the effect, not just not-diverge.

Square frames only: the shipped blur shader's `circle.x *= aspect` on a
UV-radius makes its pixel-space x-extent aspect² × the y-extent on wide
frames; the production pass is isotropic at the y-extent (documented in
tests/post_oracles.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tendrils.ops import post
from post_oracles import bokeh_exact, box_stack_reference, hash_blur_exact


def mkimg(seed, h=192, w=192):
    """Trail-like synthetic frame: soft blobs + broadband detail."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((4, h, w), np.float32)
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(3, 18)
        a = rng.uniform(0.2, 1.0)
        g = a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
        for c in range(3):
            img[c] += g * rng.uniform(0.3, 1.0)
    img[:3] += 0.15 * rng.rand(3, h, w).astype(np.float32)
    img[3] = np.clip(img[:3].max(0), 0, 1)
    return np.clip(img, 0, 1).astype(np.float32)


def rel(a, b):
    return float(np.sqrt(((a[:3] - b[:3]) ** 2).mean())
                 / np.sqrt((b[:3] ** 2).mean()))


# (radius, limit) points the demo/presets actually use: defaults 3/0.5 and
# 5/0.4 (demo.main.js:804-812), preset overrides 9/0.5 and 6/0.8
# (:2398,2482). Bounds = measured + ~40% headroom; identity distance is
# 0.18-0.25 at these points, so the pass must capture >2/3 of the effect.
@pytest.mark.parametrize("radius,limit,bound", [
    (3, 0.5, 0.06), (5, 0.4, 0.065), (9, 0.5, 0.09), (6, 0.8, 0.065)])
def test_blur_close_to_exact_shader(radius, limit, bound):
    img = mkimg(3 if radius in (3, 5) else 5)
    exact = hash_blur_exact(img, radius, limit, time=7.0)
    base = rel(img, exact)
    got = np.asarray(post.vignette_blur(jnp.asarray(img), float(radius),
                                        float(limit)))
    err = rel(got, exact)
    assert err < bound, f"blur drifted from exact shader: {err:.4f}"
    assert err < base / 2.5, f"captures too little of the effect: {err:.4f}" \
                             f" vs identity {base:.4f}"


def test_blur_grain_stays_close():
    img = mkimg(3)
    exact = hash_blur_exact(img, 5.0, 0.4, time=7.0)
    got = np.asarray(post.vignette_blur(jnp.asarray(img), 5.0, 0.4,
                                        grain=0.75))
    assert rel(got, exact) < 0.07


def test_blur_centre_untouched():
    """vignette==1 centre: amount 0 → level 0 → identity, like the
    reference's centre (whose taps collapse to the same pixel)."""
    img = mkimg(3)
    got = np.asarray(post.vignette_blur(jnp.asarray(img), 5.0, 0.4))
    c = slice(90, 102)
    assert np.abs(got[:3, c, c] - img[:3, c, c]).max() < 5e-3


# Bokeh is defined but wired into no reference app (src/screen/bokeh.frag
# has no importer) — parity is shader-level only. Small radii are the
# usable range; at rad >= 3 the ^18 highlight weighting makes the exact
# pass near a disc max-filter, which a separable stack cannot chase
# (documented in ops/post.py).
@pytest.mark.parametrize("rad,amt,bound", [(1, 20, 0.12), (2, 20, 0.18)])
def test_bokeh_close_to_exact_shader(rad, amt, bound):
    img = mkimg(3)
    exact = bokeh_exact(img, rad, amt)
    base = rel(img, exact)
    got = np.asarray(post.bokeh(jnp.asarray(img), float(rad), float(amt)))
    err = rel(got, exact)
    assert err < bound, f"bokeh drifted from exact shader: {err:.4f}"
    assert err < base / 4, f"captures too little: {err:.4f} vs {base:.4f}"


def test_level_lut_monotone_and_saturating():
    s, l = post._level_lut((1, 3, 8), "disc")
    assert list(l) == sorted(l)
    assert l[-1] == 3.0  # saturates at the deepest level
    s2, l2 = post._level_lut((2, 6, 16), "bokeh")
    assert list(l2) == sorted(l2)


def test_blur_stack_matmul_matches_cumsum():
    """The matrix stack (`blur_stack`) is the SAME linear operator as the
    sequential cumsum boxes (`post_oracles.box_stack_reference`) — banded
    matrix composition reproduces the clamped edges exactly, so outputs
    agree to f32 rounding. Non-square, non-tile-multiple dims on
    purpose."""
    img = mkimg(7, h=61, w=107)
    t = jnp.asarray(img)
    for radii in ((2, 6, 16), (1, 3, 8)):
        mats = post.blur_stack_matrices((61, 107), radii)
        ref = box_stack_reference(img, radii)
        got = post.blur_stack(t, radii, mats=mats)
        for lvl, (r, g) in enumerate(zip(ref, got)):
            err = float(np.max(np.abs(r - np.asarray(g))))
            assert err < 1e-4, (radii, lvl, err)
        # Level matrices are averaging operators: each output's kernel
        # sums to 1 (rows of A; columns of the pre-transposed Bt).
        for m in mats[0]:
            assert np.allclose(np.asarray(m).sum(axis=1), 1.0, atol=1e-5)
        for m in mats[1]:
            assert np.allclose(np.asarray(m).sum(axis=0), 1.0, atol=1e-5)


def test_bokeh_matmul_matches_cumsum(monkeypatch):
    """Bokeh through the matrix stack against bokeh through the float64
    cumsum reference stack (the same pass, un-jitted, with
    `post.blur_stack` swapped for `box_stack_reference`)."""
    img = mkimg(9)
    t = jnp.asarray(img)
    mats = post.blur_stack_matrices(img.shape[1:], (2, 6, 16))
    b = np.asarray(post.bokeh(t, 2.0, 20.0, mats=mats))
    monkeypatch.setattr(
        post, "blur_stack", lambda x, radii, mats=None: [
            jnp.asarray(v, jnp.float32)
            for v in box_stack_reference(np.asarray(x), radii)])
    a = np.asarray(post.bokeh.__wrapped__(t, 2.0, 20.0))
    # The num/den division amplifies f32 rounding where den is small:
    # measured max 2.2e-3 / p99.9 5e-4 on this frame.
    assert np.abs(a - b).max() < 5e-3
    assert float(np.quantile(np.abs(a - b), 0.999)) < 2e-3
