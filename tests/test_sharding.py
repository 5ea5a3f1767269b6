"""Multi-device sharding tests on the 8 virtual CPU devices (conftest).

The sharded frame (screen-row data parallelism over a jax.sharding.Mesh,
parallel/sharding.py) must produce the same image as the unsharded frame:
the sharding constraints only tell XLA's SPMD partitioner how to split the
dense per-pixel stages; they must not change any math.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.framework.renderer import FrameState, Globals, render_frame
from voidin_tpu.parallel.sharding import ROW_AXIS, make_mesh, shard_rows
from voidin_tpu.passes.raster import RasterConfig

WIDTH, HEIGHT = 256, 128  # 128 rows = 16 rows/device on 8 devices


def _scene():
    w = vt.World()
    w.lights.add_point_light([0, 2.0, 0], 15.0, [1, 1, 1])
    w.add_area_light(
        [1, 1, 1],
        7.0,
        (5.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 10, 15])
            @ mathx.from_rotation_x(np.float32(-np.pi / 4))
        ),
    )
    moving = []
    for i in range(6):
        a = 2 * np.pi * i / 6
        t = mathx.from_translation([3.5 * np.cos(a), 1 + 3.5 * np.sin(a), -10.0])
        moving.append(w.instances.add(np.asarray(t), vt.mesh.SPHERE_1_MESH, 0))
    w.instances.add(
        np.asarray(mathx.from_translation([0, -3, -10]) @ mathx.from_scale(50.0)),
        vt.mesh.HORIZONTAL_PLANE_MESH,
        0,
    )
    cfg = RasterConfig(
        width=WIDTH,
        height=HEIGHT,
        tri_capacity=1 << 12,
        pair_capacity=1 << 13,
        tile_tri_capacity=64,
        backend="xla",
    )
    scene = w.device()
    cam = vt.Camera(
        position=[0.0, 2.0, 2.0], yaw=0.0, pitch=-10.0, aspect=WIDTH / HEIGHT
    ).uniform()
    globals_ = Globals.make(WIDTH, HEIGHT, frame=0, time=0.0, dt=1 / 60)
    state = FrameState.initial(WIDTH, HEIGHT)
    moving_ids = np.asarray(moving, np.int32)
    return cfg, (scene, cam, globals_, state, moving_ids)


def test_eight_devices_available():
    assert len(jax.devices()) >= 8, "conftest must provision 8 virtual devices"


def test_sharded_frame_matches_unsharded():
    cfg, args = _scene()
    base_fn = jax.jit(partial(render_frame, config=cfg, mesh=None))
    img_base, _, _, _ = base_fn(*args)

    mesh = make_mesh(8)
    shard_fn = jax.jit(partial(render_frame, config=cfg, mesh=mesh))
    img_shard, _, _, aux = shard_fn(*args)

    a = np.asarray(img_base)
    b = np.asarray(img_shard)
    assert a.shape == b.shape == (HEIGHT, WIDTH, 3)
    assert np.isfinite(b).all()
    np.testing.assert_array_equal(
        a, b, err_msg="sharded frame must be bit-identical to unsharded"
    )


def test_sharded_output_is_actually_sharded():
    """The with_sharding_constraint calls must survive into the executable:
    the G-buffer depth returned in aux should come back row-sharded."""
    cfg, args = _scene()
    mesh = make_mesh(8)
    shard_fn = jax.jit(partial(render_frame, config=cfg, mesh=mesh))
    _, _, _, aux = shard_fn(*args)
    depth = aux["depth"]
    sharding = depth.sharding
    # Eight distinct device shards, split over rows.
    assert len(sharding.device_set) == 8, sharding
    shard_shape = sharding.shard_shape(depth.shape)
    assert shard_shape[0] == HEIGHT // 8, shard_shape


def test_sharded_pallas_raster_matches_unsharded():
    """The PRODUCTION raster path (Pallas kernel, row-partitioned under
    shard_map — each device bins + rasterizes its own tile rows) must be
    bit-identical to the unsharded Pallas frame."""
    cfg, args = _scene()
    cfg = dataclasses.replace(cfg, backend="pallas", interpret=True)
    base_fn = jax.jit(partial(render_frame, config=cfg, mesh=None))
    img_base, _, _, aux_base = base_fn(*args)

    mesh = make_mesh(8)
    shard_fn = jax.jit(partial(render_frame, config=cfg, mesh=mesh))
    img_shard, _, _, aux = shard_fn(*args)

    assert int(aux["overflow"]) == int(aux_base["overflow"]) == 0
    np.testing.assert_array_equal(
        np.asarray(img_base), np.asarray(img_shard),
        err_msg="sharded Pallas raster must be bit-identical",
    )


def test_sharded_raster_work_is_partitioned():
    """Per-device raster work is provably ~1/N: each device's binned pair
    count equals the pairs whose tiles fall in its row slab, and the slab
    counts sum to the global pair count (nothing replicated, nothing
    dropped)."""
    from jax.sharding import PartitionSpec as P

    from voidin_tpu.parallel.sharding import shard_map_unchecked

    from voidin_tpu.parallel import sharding as sh
    from voidin_tpu.passes import cull, raster

    cfg, (scene, cam, _g, _st, _mov) = _scene()
    cfg = dataclasses.replace(cfg, backend="pallas", interpret=True)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    setup = raster.triangle_setup(
        scene.meshes, scene.instances, draws, cam, cfg,
        materials=scene.materials,
    )
    # global binning: per-tile counts
    _rec, _starts, counts_g, ov_g = raster.bin_triangles_pairs(setup, cfg)
    assert int(ov_g) == 0
    mesh = make_mesh(8)
    rows_per = cfg.tiles_y // 8

    def body(setup_):
        d = jax.lax.axis_index(sh.ROW_AXIS)
        _r, _s, counts, ov = raster.bin_triangles_pairs(
            setup_, cfg, ty_range=(d * rows_per, rows_per)
        )
        return jnp.sum(counts)[None], ov[None]

    per_dev, ovs = jax.jit(shard_map_unchecked(
        body, mesh=mesh, in_specs=(P(),),
        out_specs=(P(sh.ROW_AXIS), P(sh.ROW_AXIS)),
    ))(setup)
    per_dev = np.asarray(per_dev)
    assert (np.asarray(ovs) == 0).all()
    # each device binned only its slab's pairs...
    counts_tiles = np.asarray(counts_g)[:cfg.n_tiles].reshape(
        cfg.tiles_y, cfg.tiles_x
    )
    want = counts_tiles.reshape(8, rows_per, -1).sum(axis=(1, 2))
    np.testing.assert_array_equal(per_dev, want)
    # ...and the slabs cover the global work exactly
    assert per_dev.sum() == counts_tiles.sum()
    # the scene actually spans several slabs (the test would be vacuous if
    # one device owned all pairs)
    assert (per_dev > 0).sum() >= 3, per_dev


def test_sharded_raster_track2_matches_unsharded():
    """The alpha-mask variant (track2: runner-up depth/id outputs ride the
    shard_map as two extra row-sharded arrays) must also be bit-identical
    to the unsharded Pallas frame."""
    cfg, (scene, cam, _g, _st, _mov) = _scene()
    cfg = dataclasses.replace(
        cfg, backend="pallas", interpret=True, alpha_mask=True
    )
    from voidin_tpu.parallel.sharding import rasterize_sharded
    from voidin_tpu.passes import cull, raster

    draws = cull.emit_draws(scene.meshes, scene.instances, cam)

    def unsharded():
        return raster.rasterize(
            scene.meshes, scene.instances, draws, cam, cfg,
            materials=scene.materials,
        )

    vis_base = jax.jit(unsharded)()
    mesh = make_mesh(8)

    def sharded():
        return rasterize_sharded(
            scene.meshes, scene.instances, draws, cam, cfg, mesh,
            materials=scene.materials,
        )

    vis = jax.jit(sharded)()
    assert vis.tri_id2 is not None and vis.depth2 is not None
    for field in ("depth", "tri_id", "depth2", "tri_id2"):
        np.testing.assert_array_equal(
            np.asarray(getattr(vis_base, field)),
            np.asarray(getattr(vis, field)),
            err_msg=f"sharded track2 {field} must be bit-identical",
        )


def test_sharded_setup_is_slot_partitioned(monkeypatch):
    """Triangle setup must not run replicated: under the
    sharded raster each device transforms tri_capacity/N work slots
    (setup_work_slice num=cap/N — 1/N of the setup flops and gather rows)
    and the packed streams are exchanged with an all-gather."""
    from voidin_tpu.parallel.sharding import rasterize_sharded
    from voidin_tpu.passes import cull, raster

    cfg, (scene, cam, _g, _st, _mov) = _scene()
    cfg = dataclasses.replace(cfg, backend="pallas", interpret=True)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    mesh = make_mesh(8)

    calls = []
    orig = raster.setup_work_slice

    def spy(*a, **kw):
        calls.append(kw.get("num"))
        return orig(*a, **kw)

    monkeypatch.setattr(raster, "setup_work_slice", spy)

    def f():
        return rasterize_sharded(
            scene.meshes, scene.instances, draws, cam, cfg, mesh,
            materials=scene.materials,
        )

    lowered = jax.jit(f).lower()
    assert calls == [cfg.tri_capacity // 8], calls
    hlo = lowered.as_text()
    assert "all-gather" in hlo or "all_gather" in hlo, (
        "the setup streams must be exchanged with an all-gather"
    )


def test_sharded_raster_imbalanced_slabs_no_overflow():
    """Geometry bunches in a few row slabs, so one device can hold most of
    the frame's multi-tile extras: at a pair capacity the unsharded frame
    fits exactly (2048 here: the densest slabs hold 9 and 22 extras more
    than a 1/8 window), the sharded frame must not overflow either, and
    its image stays bit-identical."""
    cfg, args = _scene()
    cfg = dataclasses.replace(cfg, backend="pallas", interpret=True,
                              pair_capacity=1 << 11)
    base_fn = jax.jit(partial(render_frame, config=cfg, mesh=None))
    img_base, _, _, aux_base = base_fn(*args)
    shard_fn = jax.jit(partial(render_frame, config=cfg, mesh=make_mesh(8)))
    img_shard, _, _, aux = shard_fn(*args)
    assert int(aux_base["overflow"]) == 0
    assert int(aux["overflow"]) == 0
    np.testing.assert_array_equal(np.asarray(img_base), np.asarray(img_shard))


def test_shard_rows_helper_roundtrip():
    mesh = make_mesh(8)

    @jax.jit
    def f(x):
        return shard_rows(mesh, x) * 2.0

    x = jnp.arange(8 * 16 * 4, dtype=jnp.float32).reshape(8 * 16, 4)
    y = f(x)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x) * 2.0)
    assert ROW_AXIS in mesh.axis_names


def test_sharded_rt_shadows_match_unsharded():
    """Raytraced shadows under the row-sharded frame: the lock-step TLAS
    traversal runs over row-sharded per-pixel rays with replicated BVH
    tables — the traced frame must stay bit-identical to the unsharded
    one (no sharding constraint may change ray results)."""
    w = vt.World()
    w.lights.add_point_light([3, 6, -6], 25.0, [1, 1, 1])
    w.instances.add(
        np.asarray(mathx.from_translation([0, 1.2, -8.0])),
        vt.mesh.SPHERE_1_MESH, 0,
    )
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1, -8])
                   @ mathx.from_scale(30.0)),
        vt.mesh.HORIZONTAL_PLANE_MESH, 0,
    )
    cfg = RasterConfig(
        width=WIDTH, height=HEIGHT, tri_capacity=1 << 10,
        pair_capacity=1 << 11, tile_tri_capacity=64, backend="xla",
    )
    scene = w.device(with_tlas=True)
    cam = vt.Camera(
        position=[0.0, 2.0, -2.0], yaw=0.0, pitch=-15.0,
        aspect=WIDTH / HEIGHT,
    ).uniform()
    g = Globals.make(WIDTH, HEIGHT, frame=0, time=0.0, dt=1 / 60)
    state = FrameState.initial(WIDTH, HEIGHT)
    mv = np.zeros(0, np.int32)
    args = (scene, cam, g, state, mv)

    kw = dict(config=cfg, enable_taa=False, enable_rt_shadows=True)
    img_base, _, _, _ = jax.jit(
        partial(render_frame, mesh=None, **kw))(*args)
    img_shard, _, _, _ = jax.jit(
        partial(render_frame, mesh=make_mesh(8), **kw))(*args)
    a, b = np.asarray(img_base), np.asarray(img_shard)
    assert np.isfinite(b).all()
    assert a.std() > 0.01  # scene actually renders something
    np.testing.assert_array_equal(
        a, b, err_msg="sharded raytraced frame must be bit-identical"
    )


def test_sharded_skinned_frame_matches_unsharded():
    """Vertex skinning inside the row-sharded frame: the skinned pool
    update + BLAS/mesh-AABB refit run replicated, the per-pixel stages
    shard — the rendered frame must stay bit-identical to unsharded."""
    from tests.test_skin import _skinned_world
    from voidin_tpu.core import mathx as mx

    w, mid = _skinned_world()
    cfg = RasterConfig(
        width=WIDTH, height=HEIGHT, tri_capacity=1 << 10,
        pair_capacity=1 << 11, tile_tri_capacity=64, backend="xla",
    )
    scene = w.device()
    cam = vt.Camera(
        position=[0.0, 1.0, 4.0], yaw=0.0, pitch=0.0,
        aspect=WIDTH / HEIGHT,
    ).uniform()
    g = Globals.make(WIDTH, HEIGHT, frame=0, time=0.0, dt=1 / 60)
    state = FrameState.initial(WIDTH, HEIGHT)
    rot = np.asarray(
        mx.from_translation([0, 1, 0])
        @ mx.from_rotation_z(np.float32(np.pi / 3))
        @ mx.from_translation([0, -1, 0])
    )
    jm = jnp.asarray(np.stack([np.eye(4, dtype=np.float32), rot]))
    args = (scene, cam, g, state, np.zeros(0, np.int32))

    kw = dict(config=cfg, enable_taa=False, joint_mats=jm)
    img_base, _, _, _ = jax.jit(
        partial(render_frame, mesh=None, **kw))(*args)
    img_shard, _, _, _ = jax.jit(
        partial(render_frame, mesh=make_mesh(8), **kw))(*args)
    a, b = np.asarray(img_base), np.asarray(img_shard)
    assert np.isfinite(b).all()
    assert a.std() > 0.001  # the bent strip is on screen
    np.testing.assert_array_equal(
        a, b, err_msg="sharded skinned frame must be bit-identical"
    )
