"""Reference-anchored numeric oracles for the GLSL-derived primitives.

The reference's randomness comes from two published GLSL algorithms:
  - `glsl-random` (`sn = mod(dot(co, vec2(12.9898, 78.233)), 3.14);
    fract(sin(sn) * 43758.5453)` — the package's argument reduction is
    verified against the shader text inlined in the reference's shipped
    bundle, `docs/js/demo-run.js`), used by the ball spawner
    (`src/spawn/ball/index.frag:6-14`) and pixel-spawn UV jitter;
  - `glsl-noise` simplex 3D (the public-domain Ashima Arts / Stefan
    Gustavson `webgl-noise` algorithm), required from `src/logic.frag:36`.

This file anchors `ops/rand.py` / `ops/noise.py` to those algorithms with an
*independent* strictly-float32 numpy transcription (vectorised over the last
axis, written from the GLSL source — structurally unlike the component-wise
jnp code), plus hard-pinned literal vectors generated from that transcription.
A semantic drift in either implementation breaks the pins; re-pinning is only
legitimate if the transcription below (i.e. the GLSL algorithm itself) agrees.

fp32 tolerance notes:
  - GLSL highp float IS fp32, so fp32 evaluation is the reference semantics.
    The package's `mod(dt, 3.14)` keeps the sine argument small, but at
    frag-coordinate magnitudes (dt up to ~1e5) the fp32 mod itself
    quantises: ulp(dt) ≈ 0.008 relative to the 3.14 modulus, and
    `sin(sn) * 43758.5453` still carries only ~8 fractional bits
    (ulp(43758) = 1/256). Any faithful fp32 implementation therefore
    quantises to ~1/256 steps; numpy vs XLA vs a GPU differ by a step or
    two → hash tolerance 0.01 (the reference itself is not bit-stable
    across GPUs).
  - Simplex noise is polynomial (no transcendentals): fp32 implementations
    agree to ~1e-7 except exactly on simplex cell boundaries where a floor()
    can flip (the pin points avoid boundaries) → tolerance 1e-5.
  - fp64 evaluation legitimately DIFFERS from the reference (mod289/floor
    flips, 8-bit fract granularity); the fp64 cross-check below therefore
    only runs at small coordinates where amplification is negligible, to
    anchor the *constants* at high precision.
"""

import numpy as np

from tendrils.ops.noise import snoise3
from tendrils.ops.rand import glsl_random

F = np.float32


# --- independent float32 transcriptions of the GLSL sources -----------------


def _glsl_random32(x, y):
    """glsl-random (npm package, incl. its `mod(dt, 3.14)` argument
    reduction — transcribed from the bundle-inlined shader text), strictly
    fp32."""
    d = F(x) * F(12.9898) + F(y) * F(78.233)
    d = np.mod(d, F(3.14))
    s = np.sin(d, dtype=F) * F(43758.5453)
    return s - np.floor(s)


def _mod289(x):
    return x - np.floor(x * F(1.0 / 289.0)) * F(289.0)


def _permute(x):
    return _mod289(((x * F(34.0)) + F(1.0)) * x)


def _taylor_inv_sqrt(r):
    return F(1.79284291400159) - F(0.85373472095314) * r


def _snoise3_32(v):
    """Ashima webgl-noise `snoise(vec3)`, strictly fp32, vectors on the last
    axis (literal transcription of the GLSL, swizzles via np.roll)."""
    v = np.asarray(v, F)
    c_x, c_y = F(1.0 / 6.0), F(1.0 / 3.0)
    s = (v[..., 0] + v[..., 1] + v[..., 2]) * c_y
    i = np.floor(v + s[..., None])
    t = (i[..., 0] + i[..., 1] + i[..., 2]) * c_x
    x0 = v - i + t[..., None]
    g = (x0 >= np.roll(x0, -1, axis=-1)).astype(F)  # step(x0.yzx, x0.xyz)
    l = F(1.0) - g
    lzxy = np.roll(l, 1, axis=-1)
    i1 = np.minimum(g, lzxy)
    i2 = np.maximum(g, lzxy)
    x1 = x0 - i1 + c_x
    x2 = x0 - i2 + c_y
    x3 = x0 - F(0.5)
    i = _mod289(i)

    def corner_perm(a):
        return _permute(
            _permute(_permute(i[..., 2] + a[..., 2]) + i[..., 1] + a[..., 1])
            + i[..., 0] + a[..., 0])

    p0 = corner_perm(np.zeros_like(i))
    p1 = corner_perm(i1)
    p2 = corner_perm(i2)
    p3 = corner_perm(np.ones_like(i))
    ns_x, ns_y, ns_z = F(2.0 / 7.0), F(0.5 / 7.0 - 1.0), F(1.0 / 7.0)

    def grad_dot(p, xc):
        j = p - F(49.0) * np.floor(p * (ns_z * ns_z))
        x_ = np.floor(j * ns_z)
        y_ = np.floor(j - F(7.0) * x_)
        x = x_ * ns_x + ns_y
        y = y_ * ns_x + ns_y
        h = F(1.0) - np.abs(x) - np.abs(y)
        sx = np.floor(x) * F(2.0) + F(1.0)
        sy = np.floor(y) * F(2.0) + F(1.0)
        sh = -(h <= F(0.0)).astype(F)
        ax = x + sx * sh
        ay = y + sy * sh
        norm = _taylor_inv_sqrt(ax * ax + ay * ay + h * h)
        return norm * (ax * xc[..., 0] + ay * xc[..., 1] + h * xc[..., 2])

    d0 = grad_dot(p0, x0)
    d1 = grad_dot(p1, x1)
    d2 = grad_dot(p2, x2)
    d3 = grad_dot(p3, x3)

    def falloff(x):
        m = np.maximum(
            F(0.6) - (x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2),
            F(0.0))
        m = m * m
        return m * m

    return F(42.0) * (falloff(x0) * d0 + falloff(x1) * d1
                      + falloff(x2) * d2 + falloff(x3) * d3)


# --- pinned vectors (generated from the transcriptions above) ---------------

SNOISE_PTS = np.array(
    [[0.1, 0.2, 0.3], [0.7, -0.4, 1.3], [-1.2, 2.6, 0.4],
     [3.1, 0.9, -2.2], [0.35, 0.85, 5.1], [-4.6, -0.3, 0.6],
     [12.3, 7.7, 1.9], [0.51, 0.49, 0.52]], F)
SNOISE_VALS = np.array(
    [-0.47550187, -0.56451875, 0.55733997, 0.21043840,
     -0.04589070, -0.40588817, -0.59907675, -0.11523978], np.float64)

HASH_CO = np.array(
    [[0.5, 0.5], [1.5, 0.5], [0.5, 1.5], [3.5, 2.5],
     [10.5, 7.5], [0.25, 0.75], [2.125, 4.375], [5.0, 5.0]], F)
HASH_VALS = np.array(
    [0.4765625, 0.36328125, 0.59765625, 0.9941406,
     0.7734375, 0.44140625, 0.5253906, 0.140625], np.float64)

# Ball spawner randoms (src/spawn/ball/index.frag:8-14): the four hash draws
# at three data-texture frag coords (texel centres).
BALL_FRAG = np.array([[0.5, 0.5], [1.5, 2.5], [10.5, 3.5]], F)
BALL_SCALE_OFF = [(1.7654, 2.3675), (1.23494, 0.36434),
                  (0.327789, 3.498787), (9.0374, 0.2773)]
BALL_VALS = np.array(
    [[0.2421875, 0.5546875, 0.265625],
     [0.08203125, 0.59375, 0.6875],
     [0.94921875, 0.3203125, 0.67578125],
     [0.5703125, 0.2084961, 0.0625]], np.float64)


# --- tests -------------------------------------------------------------------


def test_transcription_matches_pins():
    """Guards against rot in this file itself: the literal pins are what the
    fp32 transcriptions produce."""
    np.testing.assert_allclose(_snoise3_32(SNOISE_PTS), SNOISE_VALS,
                               atol=1e-7)
    np.testing.assert_allclose(_glsl_random32(HASH_CO[:, 0], HASH_CO[:, 1]),
                               HASH_VALS, atol=1e-7)
    for (scale, off), want in zip(BALL_SCALE_OFF, BALL_VALS):
        got = _glsl_random32(BALL_FRAG[:, 0] * F(scale) + F(off),
                             BALL_FRAG[:, 1] * F(scale) + F(off))
        np.testing.assert_allclose(got, want, atol=1e-7)


def test_snoise_matches_reference_algorithm():
    got = np.asarray(snoise3(SNOISE_PTS))
    np.testing.assert_allclose(got, SNOISE_VALS, atol=1e-5)


def test_snoise_matches_on_grid():
    """Dense-grid agreement with the independent transcription (boundary
    points where fp32 ties can flip a floor are excluded)."""
    rng = np.random.RandomState(7)
    pts = rng.uniform(-8.0, 8.0, (4096, 3)).astype(F)
    ref = _snoise3_32(pts)
    got = np.asarray(snoise3(pts))
    err = np.abs(got - ref)
    # Allow a tiny fraction of boundary flips (|err| ~ O(1)); the bulk must
    # agree to fp32 noise.
    flips = (err > 1e-3).mean()
    assert flips < 0.002, f"too many boundary disagreements: {flips:.4%}"
    assert np.median(err) < 1e-6


def test_hash_matches_reference_algorithm():
    got = np.asarray(glsl_random(HASH_CO))
    np.testing.assert_allclose(got, HASH_VALS, atol=0.01)


def test_ball_spawn_randoms_match_reference():
    """End-to-end: ops/spawn.ball reconstructs the reference's four hash
    draws and the angle/radius composition.

    Only the small frag coords are compared: the third pin point's dot
    product reaches |dt| ≈ 3700 where numpy's and XLA's fp32 `mod(dt, 3.14)`
    legitimately diverge by an ulp of dt (≈ 1/4096 of the modulus, amplified
    through the sine's 1/256 fract granularity; real GPUs differ too) — the
    hash *values* at that point are still covered by
    test_transcription_matches_pins."""
    from tendrils.ops.spawn import ball
    radius, speed = 0.6, 0.01
    n = BALL_FRAG.shape[0]
    particles = np.zeros((4, n), F)
    got = np.asarray(ball(particles, BALL_FRAG.T, radius, speed))
    tau = 2.0 * np.pi
    r = BALL_VALS[:, :2]  # [draw, point] — small-coordinate points only
    want_pos = np.stack([np.cos(r[0] * tau), np.sin(r[0] * tau)]) \
        * (r[1] * radius)
    want_vel = np.stack([np.cos(r[2] * tau), np.sin(r[2] * tau)]) \
        * (r[3] * speed)
    np.testing.assert_allclose(got[:2, :2], want_pos, atol=1e-3)
    np.testing.assert_allclose(got[2:, :2], want_vel, atol=1e-4)


def test_hash_constants_anchor_fp64():
    """At small coordinates (negligible sin-argument amplification) the fp32
    hash must agree with the fp64 ideal of the same constants — anchors the
    12.9898 / 78.233 / 43758.5453 constants at high precision."""
    co = np.array([[0.01, 0.02], [0.03, 0.005], [0.002, 0.017],
                   [0.0041, 0.0007]], F)
    d = co[:, 0].astype(np.float64) * 12.9898 \
        + co[:, 1].astype(np.float64) * 78.233
    d = np.mod(d, 3.14)
    s = np.sin(d) * 43758.5453
    want = s - np.floor(s)
    got = np.asarray(glsl_random(co))
    np.testing.assert_allclose(got, want, atol=0.005)


def test_luma_triples_match_shipped_shaders():
    """TWO different luma conventions ship in the reference and must not be
    conflated: the npm `glsl-luma` (pixel-spawn brightest scoring) is
    Rec-601 `(0.299, 0.587, 0.114)`; the local `src/utils/gray-scale.glsl`
    (optical flow) is `(0.3, 0.59, 0.11)` — both verified against the
    bundle-inlined shader text."""
    from tendrils.ops.optical_flow import gray_scale
    from tendrils.ops.spawn import luma
    px = np.array([[1.0], [0.0], [0.0], [1.0]], F)
    img = np.ones((4, 1, 1), F) * px[:, :, None]
    np.testing.assert_allclose(float(luma(px)[0]), 0.299, atol=1e-6)
    np.testing.assert_allclose(float(np.asarray(gray_scale(img))[0, 0]),
                               0.3, atol=1e-6)
    px_g = np.array([[0.0], [1.0], [0.0], [1.0]], F)
    img_g = np.ones((4, 1, 1), F) * px_g[:, :, None]
    np.testing.assert_allclose(float(luma(px_g)[0]), 0.587, atol=1e-6)
    np.testing.assert_allclose(float(np.asarray(gray_scale(img_g))[0, 0]),
                               0.59, atol=1e-6)


def test_hash_uniformity_at_frag_scale():
    """Statistical sanity at real frag-coordinate scale (512² data texture):
    mean/var of a uniform [0,1) stream."""
    ix, iy = np.meshgrid(np.arange(64, dtype=F) + F(0.5),
                         np.arange(64, dtype=F) + F(0.5))
    co = np.stack([ix.ravel() * F(1.7654) + F(2.3675),
                   iy.ravel() * F(1.7654) + F(2.3675)], -1)
    r = np.asarray(glsl_random(co))
    assert abs(r.mean() - 0.5) < 0.02
    assert abs(r.var() - 1.0 / 12.0) < 0.01
