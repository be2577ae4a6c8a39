"""Simplex noise, vectorised.

The reference's wander force uses `glsl-noise`'s simplex 3D (the public-domain
Ashima Arts / Stefan Gustavson `webgl-noise` algorithm), required from
`src/logic.frag:36` and evaluated per particle at
`(pos*noiseScale, uv.x + time*noiseSpeed)` — `src/logic.frag:62-68`.

This module reimplements the same algorithm as pure `jnp` elementwise math so
XLA fuses it straight into the particle-step kernel (it is transcendental-free
— only floor/abs/mul).

The core is component-wise (`snoise3_xyz` over separate x/y/z arrays): every
intermediate keeps the input's shape with the big extent contiguous. The
packed `snoise3(f32[..., 3])` wrapper exists for convenience/tests; a size-3
minor axis makes every access strided, so use the component form in hot
paths.
"""

import jax.numpy as jnp


def _mod289(x):
    return x - jnp.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def snoise3_xyz(vx, vy, vz):
    """Simplex 3D noise over component arrays `f32[...]` -> `f32[...]`."""
    vx = jnp.asarray(vx, jnp.float32)
    vy = jnp.asarray(vy, jnp.float32)
    vz = jnp.asarray(vz, jnp.float32)
    C_x = jnp.float32(1.0 / 6.0)
    C_y = jnp.float32(1.0 / 3.0)

    # First corner
    s = (vx + vy + vz) * C_y
    ix = jnp.floor(vx + s)
    iy = jnp.floor(vy + s)
    iz = jnp.floor(vz + s)
    t = (ix + iy + iz) * C_x
    x0x = vx - ix + t
    x0y = vy - iy + t
    x0z = vz - iz + t

    # Other corners: g = step(x0.yzx, x0.xyz); l = 1 - g;
    # i1 = min(g, l.zxy); i2 = max(g, l.zxy).
    gx = (x0x >= x0y).astype(jnp.float32)
    gy = (x0y >= x0z).astype(jnp.float32)
    gz = (x0z >= x0x).astype(jnp.float32)
    lx = 1.0 - gx
    ly = 1.0 - gy
    lz = 1.0 - gz
    i1x = jnp.minimum(gx, lz)
    i1y = jnp.minimum(gy, lx)
    i1z = jnp.minimum(gz, ly)
    i2x = jnp.maximum(gx, lz)
    i2y = jnp.maximum(gy, lx)
    i2z = jnp.maximum(gz, ly)

    x1x = x0x - i1x + C_x
    x1y = x0y - i1y + C_x
    x1z = x0z - i1z + C_x
    x2x = x0x - i2x + C_y
    x2y = x0y - i2y + C_y
    x2z = x0z - i2z + C_y
    x3x = x0x - 0.5
    x3y = x0y - 0.5
    x3z = x0z - 0.5

    # Permutations (4 corners).
    ix = _mod289(ix)
    iy = _mod289(iy)
    iz = _mod289(iz)

    def corner_perm(az, ay, ax):
        return _permute(_permute(_permute(iz + az) + iy + ay) + ix + ax)

    p0 = corner_perm(0.0, 0.0, 0.0)
    p1 = corner_perm(i1z, i1y, i1x)
    p2 = corner_perm(i2z, i2y, i2x)
    p3 = corner_perm(1.0, 1.0, 1.0)

    # Gradients: 7x7 points over a square, mapped onto an octahedron.
    ns_x = jnp.float32(2.0 / 7.0)
    ns_y = jnp.float32(0.5 / 7.0 - 1.0)
    ns_z = jnp.float32(1.0 / 7.0)

    def gradient(p, xc, yc, zc):
        j = p - 49.0 * jnp.floor(p * (ns_z * ns_z))
        x_ = jnp.floor(j * ns_z)
        y_ = jnp.floor(j - 7.0 * x_)
        x = x_ * ns_x + ns_y
        y = y_ * ns_x + ns_y
        h = 1.0 - jnp.abs(x) - jnp.abs(y)
        sx = jnp.floor(x) * 2.0 + 1.0
        sy = jnp.floor(y) * 2.0 + 1.0
        sh = -(h <= 0.0).astype(jnp.float32)
        ax = x + sx * sh
        ay = y + sy * sh
        norm = _taylor_inv_sqrt(ax * ax + ay * ay + h * h)
        gx = ax * norm
        gy = ay * norm
        gz = h * norm
        return gx * xc + gy * yc + gz * zc

    d0 = gradient(p0, x0x, x0y, x0z)
    d1 = gradient(p1, x1x, x1y, x1z)
    d2 = gradient(p2, x2x, x2y, x2z)
    d3 = gradient(p3, x3x, x3y, x3z)

    def falloff(xx, yy, zz):
        m = jnp.maximum(0.6 - (xx * xx + yy * yy + zz * zz), 0.0)
        m = m * m
        return m * m

    return 42.0 * (falloff(x0x, x0y, x0z) * d0
                   + falloff(x1x, x1y, x1z) * d1
                   + falloff(x2x, x2y, x2z) * d2
                   + falloff(x3x, x3y, x3z) * d3)


def snoise3(v):
    """Simplex 3D noise of `v: f32[..., 3]` -> `f32[...]` in ~[-1, 1].

    Packed-vector convenience wrapper over `snoise3_xyz`.
    """
    v = jnp.asarray(v, jnp.float32)
    return snoise3_xyz(v[..., 0], v[..., 1], v[..., 2])
