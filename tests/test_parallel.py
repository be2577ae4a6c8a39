"""Multi-device tests on the 8-virtual-device CPU mesh (SURVEY §4): the
sharded frames must match the single-device frame (the reduced splat
partial sums are float adds over disjoint particle sets in another order;
CPU keeps them bit-stable enough for tight tolerances)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tendrils import EngineConfig, Tendrils
from tendrils.engine import draw_sim, step_sim
from tendrils.ops import spawn
from tendrils.parallel import make_mesh, parallel_frame, shard_sim


@pytest.fixture
def engine():
    cfg = EngineConfig(root_num=32, view_res=(32, 64), flow_samples=2,
                       flow_rows=1, view_samples=2)
    eng = Tendrils(cfg)
    eng.setup()
    eng.spawn_shader(
        lambda p, e: spawn.ball(p, e._frag_xy, 0.5, 0.01))
    return eng


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def _clone(s):
    """Deep copy: the frame functions donate their input, and `shard_sim`
    may alias the source buffers."""
    return jax.tree_util.tree_map(jnp.array, s)


def _warm(eng, frames=3):
    """Advance the fixture a few single-device frames so the flow grid the
    compared frames read is non-trivial."""
    for _ in range(frames):
        eng.frame()
    return eng


def _single_frames(eng, params, times, dt):
    sim = _clone(eng.sim)
    for t in times:
        sim = step_sim(sim, params, t, dt, eng.config, eng._view_size)
        sim = draw_sim(sim, params, t, eng.config, eng._view_size)
    return sim


def _assert_frames_match(out, ref):
    # Identical per-row math; only the collective's float add order differs.
    np.testing.assert_allclose(np.asarray(out.particles),
                               np.asarray(ref.particles), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.flow), np.asarray(ref.flow),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.view), np.asarray(ref.view),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_parallel_frame_matches_single(engine, n_dev):
    """DP shard_map (psum'd splat partials) over `n_dev` devices vs the
    single-device frame, two frames from a state with live flow."""
    eng = _warm(engine)
    params = eng.params()
    dt = jnp.float32(16.0)
    times = [jnp.float32(100.0), jnp.float32(116.0)]
    ref = _single_frames(eng, params, times, dt)

    mesh = make_mesh(jax.devices()[:n_dev])
    sim = shard_sim(_clone(eng.sim), mesh)
    for t in times:
        sim = parallel_frame(sim, params, t, dt, eng.config, eng._view_size,
                             mesh)
    _assert_frames_match(sim, ref)


def test_parallel_multi_step_stable(engine):
    eng = engine
    mesh = make_mesh()
    sim = shard_sim(eng.sim, mesh)
    params = eng.params()
    for i in range(3):
        t = jnp.float32(16.0 * (i + 1))
        sim = parallel_frame(sim, params, t, jnp.float32(16.0), eng.config,
                             eng._view_size, mesh)
    p = np.asarray(sim.particles)
    assert np.isfinite(p).all()
    speed = np.sqrt(p[2] ** 2 + p[3] ** 2)
    assert np.all(speed <= float(params["speedLimit"]) + 1e-6)
    # Flow got written by all shards' particles.
    assert np.abs(np.asarray(sim.flow)[3]).sum() > 0


def test_parallel_tendrils_facade(engine):
    from tendrils.parallel.sharding import ParallelTendrils
    par = ParallelTendrils(engine)
    par.frame()
    par.frame()
    p = np.asarray(engine.sim.particles)
    assert np.isfinite(p).all()
    assert np.abs(np.asarray(engine.sim.flow)[3]).sum() > 0


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_spatial_slab_matches_single(engine, n_dev):
    """Row-slab grid partition (reduce-scatter resolve + 3-channel flow
    all-gather) over `n_dev` devices reproduces the single-device frame —
    SURVEY §2.9's high-resolution design — two frames from a state with
    live flow."""
    from tendrils.parallel import shard_sim_spatial, spatial_frame

    eng = _warm(engine)
    params = eng.params()
    dt = jnp.float32(16.0)
    times = [jnp.float32(100.0), jnp.float32(116.0)]
    ref = _single_frames(eng, params, times, dt)

    mesh = make_mesh(jax.devices()[:n_dev])
    sim = shard_sim_spatial(_clone(eng.sim), mesh)
    for t in times:
        sim = spatial_frame(sim, params, t, dt, eng.config, eng._view_size,
                            mesh)
    _assert_frames_match(sim, ref)


def test_spatial_multi_step_stable(engine):
    from tendrils.parallel.spatial import SpatialTendrils
    par = SpatialTendrils(engine)
    for _ in range(3):
        par.frame()
    p = np.asarray(engine.sim.particles)
    assert np.isfinite(p).all()
    assert np.abs(np.asarray(engine.sim.flow)[3]).sum() > 0
    # The view grid really is sharded by rows across the mesh.
    shardings = engine.sim.flow.sharding
    assert shardings.num_devices == 8


def test_multihost_mesh_matches_single_axis(engine):
    """(hosts, devices) mesh: same specs/collectives as the flat mesh, psum
    staged devices-then-hosts. Validated by reshaping the
    8 CPU devices to (2, 4) and comparing against the flat-mesh frame."""
    from tendrils.parallel import make_multihost_mesh

    eng = engine
    params = eng.params()
    t, dt = jnp.float32(16.0), jnp.float32(16.0)

    mesh_flat = make_mesh()
    mesh_mh = make_multihost_mesh(hosts=2)
    assert mesh_mh.devices.shape == (2, 4)
    assert mesh_mh.axis_names == ("host", "dp")

    out_flat = parallel_frame(shard_sim(_clone(eng.sim), mesh_flat), params,
                              t, dt, eng.config, eng._view_size, mesh_flat)
    out_mh = parallel_frame(shard_sim(_clone(eng.sim), mesh_mh), params, t,
                            dt, eng.config, eng._view_size, mesh_mh)
    np.testing.assert_allclose(np.asarray(out_mh.particles),
                               np.asarray(out_flat.particles), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(out_mh.flow),
                               np.asarray(out_flat.flow), rtol=1e-4,
                               atol=1e-6)


_DTYPE_BYTES = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "pred": 1,
                "f16": 2, "s8": 1, "u8": 1}


def collective_bytes(txt, n_dev):
    """Bytes each device moves for the collectives of an optimised HLO
    dump, ring model: an all-reduce moves `2·(D-1)/D` of its bytes, a
    reduce-scatter or all-gather `(D-1)/D` of the full array. Returns
    `(rows, total)` with one `(kind, bytes)` row per collective."""
    rows = []
    for line in txt.splitlines():
        m = re.search(r"= (.*?) (all-reduce|reduce-scatter|all-gather|"
                      r"collective-permute|all-to-all)\(", line)
        if not m:
            continue
        shapes, kind = re.sub(r"/\*.*?\*/", "", m.group(1)), m.group(2)
        nbytes = sum(int(np.prod([int(d) for d in dims.split(",") if d]))
                     * _DTYPE_BYTES[dt]
                     for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", shapes)
                     if dt in _DTYPE_BYTES)
        # HLO prints each op's OUTPUT shape: a reduce-scatter's output is
        # the 1/D shard, an all-gather's the gathered whole.
        if kind == "all-reduce":
            moved = 2 * (n_dev - 1) / n_dev * nbytes
        elif kind == "reduce-scatter":
            moved = (n_dev - 1) * nbytes
        else:
            moved = (n_dev - 1) / n_dev * nbytes
        rows.append((kind, moved))
    return rows, sum(m for _, m in rows)


def test_slab_mode_moves_fewer_ici_bytes(engine):
    """The slab layout's reason to exist: collective traffic, counted from
    the compiled program's collectives, below replicate+psum. The ratio is
    resolution-independent (every collective is grid-proportional): 12
    reduce-scattered splat planes + 3 all-gathered flow planes against 12
    all-reduced ones, 15/24 = 0.625."""
    from tendrils.parallel import shard_sim_spatial, spatial_frame

    eng = engine
    cfg = eng.config
    params = eng.params()
    t, dt = jnp.float32(16.0), jnp.float32(16.0)
    mesh = make_mesh()
    totals = {}
    for name, mk, frame in (("psum", shard_sim, parallel_frame),
                            ("slab", shard_sim_spatial, spatial_frame)):
        sim = mk(eng.sim, mesh)
        txt = jax.jit(
            lambda s, frame=frame: frame(s, params, t, dt, cfg,
                                         eng._view_size, mesh)
        ).lower(sim).compile().as_text()
        rows, total = collective_bytes(txt, mesh.devices.size)
        assert rows, f"{name}: no collectives found in HLO"
        totals[name] = total
    assert 0.6 * totals["psum"] < totals["slab"] < 0.65 * totals["psum"], \
        totals


@pytest.mark.parametrize("cfg_kw,match", [
    ({"view_res": (30, 64)}, "not divisible"),
    ({"flow_res": (16, 32)}, "one grid shape"),
])
def test_spatial_frame_rejects_unsupported_layouts(engine, cfg_kw, match):
    import dataclasses

    from tendrils.parallel import spatial_frame
    eng = engine
    cfg = dataclasses.replace(eng.config, **cfg_kw)
    mesh = make_mesh(jax.devices()[:4])
    with pytest.raises(ValueError, match=match):
        spatial_frame(eng.sim, eng.params(), jnp.float32(16.0),
                      jnp.float32(16.0), cfg, eng._view_size, mesh)
