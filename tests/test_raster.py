import jax.numpy as jnp
import numpy as np
import pytest

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.ops import fine_raster as fr
from voidin_tpu.passes import cull, raster

CFG = raster.RasterConfig(
    width=128,
    height=64,
    tri_capacity=1 << 13,
    pair_capacity=1 << 14,
    tile_tri_capacity=64,
    interpret=True,
)


def _scene(n_spheres=3):
    w = vt.World()
    for i in range(n_spheres):
        t = mathx.from_translation([2.5 * (i - 1), 0.0, -6.0 - i])
        w.instances.add(np.asarray(t), vt.mesh.SPHERE_1_MESH, 0)
    # ground plane
    t = np.asarray(mathx.from_translation([0, -1.5, -6]) @ mathx.from_scale(20.0))
    w.instances.add(t, vt.mesh.HORIZONTAL_PLANE_MESH, 0)
    return w


def _camera(aspect):
    cam = vt.Camera(position=[0.0, 0.5, 2.0], yaw=0.0, pitch=-10.0, aspect=aspect)
    return cam.uniform()


def _oracle_raster(setup, width, height):
    """Brute-force per-pixel rasterizer over the *same* setup data."""
    sx = np.asarray(setup["sx"])
    sy = np.asarray(setup["sy"])
    z = np.asarray(setup["sz"])
    alive = np.asarray(setup["alive"])
    depth = np.zeros((height, width), np.float32)
    tid = np.full((height, width), -1, np.int32)
    nxt = [1, 2, 0]
    for t in np.nonzero(alive)[0]:
        x0 = max(int(np.floor(sx[t].min())), 0)
        x1 = min(int(np.ceil(sx[t].max())) + 1, width)
        y0 = max(int(np.floor(sy[t].min())), 0)
        y1 = min(int(np.ceil(sy[t].max())) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1) + 0.5
        ys = np.arange(y0, y1) + 0.5
        X, Y = np.meshgrid(xs, ys)
        e = np.stack(
            [
                (X - sx[t, k]) * (sy[t, nxt[k]] - sy[t, k])
                - (Y - sy[t, k]) * (sx[t, nxt[k]] - sx[t, k])
                for k in range(3)
            ],
            axis=-1,
        )
        inside = (e >= 0).all(axis=-1)
        area = e.sum(axis=-1)
        area = np.where(np.abs(area) > 1e-20, area, 1e-20)
        d = (e[..., 1] * z[t, 0] + e[..., 2] * z[t, 1] + e[..., 0] * z[t, 2]) / area
        win = inside & (d > depth[y0:y1, x0:x1])
        depth[y0:y1, x0:x1] = np.where(win, d, depth[y0:y1, x0:x1])
        tid[y0:y1, x0:x1] = np.where(win, t, tid[y0:y1, x0:x1])
    return tid, depth


def test_raster_matches_oracle():
    w = _scene()
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    setup = raster.triangle_setup(scene.meshes, scene.instances, draws, cam, CFG)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, CFG)

    assert int(vis.overflow) == 0
    tid_ref, depth_ref = _oracle_raster(setup, CFG.width, CFG.height)
    tid = np.asarray(vis.tri_id)
    depth = np.asarray(vis.depth)

    # Coverage must be non-trivial
    assert (tid >= 0).sum() > 500
    np.testing.assert_allclose(depth, depth_ref, atol=1e-6)
    # ids may differ only where depths tie (e.g. along the shared edge of
    # the two halves of a near-clipped quad, where both triangles produce
    # identical interpolated depth); depths above are exact, so any id
    # disagreement is a tie by construction.
    agree = (tid == tid_ref).mean()
    assert agree > 0.99, agree


def test_cull_equals_full_render():
    """Property: culling must not change the image (emit_draws contract)."""
    w = _scene(n_spheres=5)
    # add some instances far outside the frustum
    for i in range(10):
        t = mathx.from_translation([100.0 + i, 50.0, 20.0])
        w.instances.add(np.asarray(t), vt.mesh.SPHERE_1_MESH, 0)
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)

    draws_all = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    draws_culled = cull.emit_draws(scene.meshes, scene.instances, cam)
    assert int(draws_culled.count) < scene.instances.count

    vis_all = raster.rasterize(scene.meshes, scene.instances, draws_all, cam, CFG)
    vis_cull = raster.rasterize(scene.meshes, scene.instances, draws_culled, cam, CFG)
    np.testing.assert_allclose(
        np.asarray(vis_all.depth), np.asarray(vis_cull.depth), atol=1e-6
    )


def test_visibility_mask_conservative():
    """Everything that rasterizes to >=1 pixel must be marked visible."""
    w = _scene(n_spheres=5)
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    mask = np.asarray(cull.instance_visibility(scene.meshes, scene.instances, cam))

    draws_all = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    vis = raster.rasterize(scene.meshes, scene.instances, draws_all, cam, CFG)
    tid = np.asarray(vis.tri_id)
    inst_of_tri = np.asarray(vis.resolve_rec[:, 9]).astype(np.int32)
    covered = np.unique(inst_of_tri[tid[tid >= 0]])
    for i in covered:
        assert mask[i], f"instance {i} rasterized but was culled"


def _rand_records(rng, n, ties=False):
    """Random tile-local coefficient records on a dyadic grid: every
    product and sum the raster forms is exact in f32. Depths never tie
    across the kernel's chunks or the twin's groups (whose first-chunk tie
    rules differ only there): each record's depth stays inside its own
    1/64-wide band — or, with `ties`, each aligned group of TRI_GROUP
    records shares three constant depths of its own, tying only within
    the group."""
    r = np.zeros((n, fr.RECORD_F), np.float32)
    q = lambda lo, hi, size, s=8: rng.integers(lo * s, hi * s, size) / s  # noqa: E731,E501
    for e in range(3):
        r[:, 3 * e] = q(-2, 2, n)
        r[:, 3 * e + 1] = q(-2, 2, n)
        r[:, 3 * e + 2] = q(-4, 20, n)
    if ties:
        group = np.arange(n) // fr.TRI_GROUP
        r[:, fr.F_D + 2] = (3 * group + rng.integers(1, 4, n)) / 64.0
        r[:, fr.F_ZMAX] = 1e3
    else:
        band = (rng.permutation(n) + 1) / 64.0
        # slopes < 2^-12: a record moves < 2^-7 over the tile
        r[:, fr.F_D] = q(-1, 1, n, 2**12) / 2**12
        r[:, fr.F_D + 1] = q(-1, 1, n, 2**12) / 2**12
        r[:, fr.F_D + 2] = band
        # zmax clamps about half of the records inside their band
        r[:, fr.F_ZMAX] = band + rng.choice([-1.0, 1.0], n) / 2**8
    r[:, fr.F_ID] = rng.permutation(n).astype(np.float32)
    return r


def _pairs_and_blocks(per_tile, nt, lead):
    """Tile-sorted pair stream (`lead` foreign rows first, so tile ranges
    start unaligned) + the same records as (NT, K, F) blocks."""
    junk = np.zeros((lead, fr.RECORD_F), np.float32)
    junk[:, 2] = junk[:, 5] = junk[:, 8] = 1.0  # would cover every pixel
    junk[:, fr.F_D + 2] = junk[:, fr.F_ZMAX] = 0.99
    junk[:, fr.F_ID] = 1e6
    counts = np.asarray([len(per_tile.get(t, ())) for t in range(nt)])
    starts = lead + np.concatenate([[0], np.cumsum(counts)[:-1]])
    stream = np.concatenate(
        [junk] + [per_tile[t] for t in range(nt) if t in per_tile] + [junk]
    )
    k = max(fr.TRI_GROUP, -(-int(counts.max()) // fr.TRI_GROUP) * fr.TRI_GROUP)
    blocks = np.zeros((nt, k, fr.RECORD_F), np.float32)
    blocks[:, :, fr.F_ID] = -1.0
    for t, recs in per_tile.items():
        blocks[t, : len(recs)] = recs
    return (stream, starts.astype(np.int32), counts.astype(np.int32),
            blocks)


def _kernel_case(case, rng):
    nt = CFG.n_tiles
    if case == "empty":
        return {}, 0
    if case == "single":
        rec = _rand_records(rng, 1)
        rec[0, [2, 5, 8]] = 64.0  # covers the whole tile
        return {5: rec}, 3
    if case == "multi_chunk_unaligned":
        return {0: _rand_records(rng, 7),
                3: _rand_records(rng, 3 * fr.CHUNK + 5),
                nt - 1: _rand_records(rng, fr.CHUNK)}, 11
    if case in ("depth_ties", "depth_ties_track2"):
        return {t: _rand_records(rng, 2 * fr.CHUNK + t, ties=True)
                for t in (1, 2, 9)}, 1
    # "random_track2": many tiles, mixed counts
    return {t: _rand_records(rng, int(rng.integers(1, 2 * fr.CHUNK)))
            for t in range(0, nt, 3)}, 6


KERNEL_CASES = ["empty", "single", "multi_chunk_unaligned", "depth_ties",
                "depth_ties_track2", "random_track2"]


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_fine_raster_pairs_matches_xla(case):
    """The pair-streaming kernel (interpret mode) and fine_raster_xla over
    the same records per tile must agree exactly: winner depth and id, and
    with track2 the runner-up pair."""
    rng = np.random.default_rng(KERNEL_CASES.index(case))
    per_tile, lead = _kernel_case(case, rng)
    track2 = case.endswith("track2")
    stream, starts, counts, blocks = _pairs_and_blocks(
        per_tile, CFG.n_tiles, lead
    )
    got = fr.fine_raster_pairs(
        jnp.asarray(stream), jnp.asarray(starts), jnp.asarray(counts),
        interpret=True, track2=track2,
    )
    want = raster.fine_raster_xla(
        jnp.asarray(blocks), jnp.asarray(counts), CFG, track2=track2
    )
    assert len(got) == len(want) == (4 if track2 else 2)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))
    if case == "empty":
        assert (np.asarray(got[1]) == -1).all()
    else:
        assert (np.asarray(got[1]) >= 0).any()


def test_lod_selection_by_distance():
    """cull.select_lod picks the registered level by view-distance/radius
    ratio; emit_draws carries it as the per-draw mesh override and the
    frame renders with it (beyond reference parity — voidin has no LOD)."""
    w = vt.World()
    fine = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 6))
    coarse = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 2))
    coarsest = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 1))
    # ratio = dist / (AABB half-diagonal) = dist / sqrt(3) for unit spheres:
    # near 2.9, mid 8.7, far 23.1
    w.meshes.set_lods(fine, [(coarse, 7.0), (coarsest, 20.0)])
    near = w.instances.add(
        np.asarray(mathx.from_translation([0, 0, -5])), fine, 0
    )
    mid = w.instances.add(
        np.asarray(mathx.from_translation([0, 0, -15])), fine, 0
    )
    far = w.instances.add(
        np.asarray(mathx.from_translation([0, 0, -40])), fine, 0
    )
    scene = w.device()
    assert scene.meshes.has_lods
    cam = vt.Camera(position=[0, 0, 0], yaw=0.0, aspect=1.0).uniform()
    sel = np.asarray(cull.select_lod(scene.meshes, scene.instances, cam))
    assert sel[near] == fine
    assert sel[mid] == coarse
    assert sel[far] == coarsest

    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    assert draws.mesh is not None
    n = int(draws.count)
    inst = np.asarray(draws.instance)[:n]
    mesh = np.asarray(draws.mesh)[:n]
    np.testing.assert_array_equal(mesh, sel[inst])
    # the frame renders with the override and the far instance uses ~96
    # tris, not the fine mesh's ~4.6k
    vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, CFG)
    assert int(vis.overflow) == 0
    assert (np.asarray(vis.tri_id) >= 0).sum() > 30


def test_lod_unregistered_meshes_unchanged():
    """A pool without LODs emits no mesh override (zero-cost path)."""
    w = _scene()
    scene = w.device()
    assert not scene.meshes.has_lods
    cam = _camera(1.0)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    assert draws.mesh is None


def test_sort_payload_matches_default_path():
    """sort_payload=True (payload rides the sort) must produce the same
    frame as the default sort-then-gather path. Guards the round-2 advisor
    finding: sorting only 15 of 16 fields zeroed F_ZMAX, whose sliver
    guard then clamped every depth to 0 — a completely blank frame."""
    import dataclasses

    w = _scene()
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)

    vis_def = raster.rasterize(scene.meshes, scene.instances, draws, cam, CFG)
    cfg_sp = dataclasses.replace(CFG, sort_payload=True)
    vis_sp = raster.rasterize(scene.meshes, scene.instances, draws, cam, cfg_sp)

    assert (np.asarray(vis_sp.tri_id) >= 0).sum() > 500  # not blank
    np.testing.assert_array_equal(
        np.asarray(vis_sp.depth), np.asarray(vis_def.depth)
    )
    np.testing.assert_array_equal(
        np.asarray(vis_sp.tri_id), np.asarray(vis_def.tri_id)
    )


def test_single_stream_bin_matches_default_path():
    """two_stream_bin=False (single-stream general pair expansion) must
    produce the same frame as the default two-stream binning — an
    untested-option guard of the sort_payload class: both are kept as
    A/B alternatives and must not rot."""
    import dataclasses

    w = _scene()
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)

    vis_def = raster.rasterize(scene.meshes, scene.instances, draws, cam, CFG)
    cfg_ss = dataclasses.replace(CFG, two_stream_bin=False)
    vis_ss = raster.rasterize(scene.meshes, scene.instances, draws, cam,
                              cfg_ss)

    assert (np.asarray(vis_ss.tri_id) >= 0).sum() > 500  # not blank
    np.testing.assert_array_equal(
        np.asarray(vis_ss.depth), np.asarray(vis_def.depth)
    )
    np.testing.assert_array_equal(
        np.asarray(vis_ss.tri_id), np.asarray(vis_def.tri_id)
    )


def _alpha_scene():
    """Masked cutout quad in front of a solid backdrop, plus a
    base_color.w=0.2 'ghost' quad in front of both that must vanish.
    The vertical plane faces -Z, so the camera (see _alpha_camera) sits at
    z=-12 looking +Z: the masked quad at z=-8 is nearest, the backdrop at
    z=-4 is behind it, the ghost at z=-9 is in front of everything."""
    w = vt.World()
    tex = np.full((8, 8, 4), 255, np.uint8)
    tex[2:6, 2:6, 3] = 0  # hole: uv [0.25, 0.75)^2
    mat_mask = w.materials.add(albedo=w.textures.add(tex))
    mat_solid = w.materials.add(base_color=(1, 0, 0, 1))
    mat_ghost = w.materials.add(base_color=(1, 1, 1, 0.2))
    w.instances.add(
        np.asarray(mathx.from_translation([0, 0, -8]) @ mathx.from_scale(4.0)),
        vt.mesh.VERTICAL_PLANE_MESH,
        mat_mask,
    )
    w.instances.add(
        np.asarray(mathx.from_translation([0, 0, -4]) @ mathx.from_scale(14.0)),
        vt.mesh.VERTICAL_PLANE_MESH,
        mat_solid,
    )
    w.instances.add(
        np.asarray(mathx.from_translation([0, 0, -9]) @ mathx.from_scale(2.0)),
        vt.mesh.VERTICAL_PLANE_MESH,
        mat_ghost,
    )
    return w, mat_mask, mat_solid


def _alpha_camera(aspect):
    return vt.Camera(
        position=[0.0, 0.0, -12.0], yaw=180.0, pitch=0.0, aspect=aspect
    ).uniform()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_alpha_cutout_reveals_occluded_geometry(backend):
    """visibility.wgsl:79-81 discard semantics: a cut fragment must not win
    the depth competition — the geometry BEHIND the cutout shows through,
    and a base_color.w < 0.5 material never rasterizes at all."""
    import dataclasses

    from voidin_tpu.passes import resolve

    w, mat_mask, mat_solid = _alpha_scene()
    scene = w.device()
    assert scene.alpha_masked  # host detection of masked content
    cfg = dataclasses.replace(CFG, alpha_mask=True, backend=backend)
    cam = _alpha_camera(cfg.width / cfg.height)
    draws = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    vis = raster.rasterize(
        scene.meshes, scene.instances, draws, cam, cfg,
        materials=scene.materials,
    )
    gb, _albedo = resolve.resolve_gbuffer(scene, vis, cam, cfg)
    mat = np.asarray(gb.material)
    depth = np.asarray(gb.depth)
    cy, cx = cfg.height // 2, cfg.width // 2
    # dead center: inside the hole -> the backdrop is visible through it
    assert mat[cy, cx] == mat_solid, mat[cy, cx]
    assert depth[cy, cx] > 0.0
    # near the quad's edge (outside the hole, inside the quad): masked quad
    # wins; its depth is NEARER (reverse-Z: larger) than the hole pixels'.
    probe = None
    for dx in range(cfg.width // 2):
        if mat[cy, cx + dx] == mat_mask:
            probe = (cy, cx + dx)
            break
    assert probe is not None, "masked quad not visible anywhere on the row"
    assert depth[probe] > depth[cy, cx]
    # the ghost quad (base_color.w < 0.5) must appear nowhere
    ghost_mat = mat_solid + 1
    assert not (mat == ghost_mat).any()


def test_lazy_alpha_fallback_matches_dense():
    """The compacted lazy alpha fallback must agree with the dense two-pass
    oracle. Depth/material/normals agree exactly wherever the mip level
    cannot differ; the only sanctioned deviation is lod selection on
    fallback pixels (analytic within-triangle derivatives vs image-space
    diffs), so agreement is asserted at >= 99.5% with identical coverage."""
    import dataclasses

    from voidin_tpu.passes import resolve

    w, mat_mask, mat_solid = _alpha_scene()
    scene = w.device()
    cam = _alpha_camera(CFG.width / CFG.height)
    draws = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    cfg_d = dataclasses.replace(CFG, alpha_mask=True, lazy_alpha_resolve=False)
    cfg_l = dataclasses.replace(CFG, alpha_mask=True, lazy_alpha_resolve=True)
    vis = raster.rasterize(
        scene.meshes, scene.instances, draws, cam, cfg_d,
        materials=scene.materials,
    )
    gb_d, aux_d = resolve.resolve_gbuffer(scene, vis, cam, cfg_d)
    gb_l, aux_l = resolve.resolve_gbuffer(scene, vis, cam, cfg_l)

    assert int(aux_l.overflow) == 0
    md, ml = np.asarray(gb_d.material), np.asarray(gb_l.material)
    dd, dl = np.asarray(gb_d.depth), np.asarray(gb_l.depth)
    assert (md == ml).mean() > 0.995, (md != ml).sum()
    assert (dd == dl).mean() > 0.995
    # the fallback actually engaged: some revealed-backdrop pixels exist
    assert ((md == ml) & (md > 0)).sum() > 100
    # Albedo matches everywhere except fallback pixels whose mip level
    # legitimately differs (analytic vs image-space derivatives).
    ad, al = np.asarray(aux_d.albedo), np.asarray(aux_l.albedo)
    close = (np.abs(ad - al) < 1e-6).all(axis=-1)
    assert close.mean() > 0.99, close.mean()


def test_lazy_alpha_fallback_overflow_counter():
    """Fallback pixels beyond capacity resolve to background and are
    counted, never silently mis-resolved."""
    import dataclasses

    from voidin_tpu.passes import resolve

    w, _mask, _solid = _alpha_scene()
    scene = w.device()
    cam = _alpha_camera(CFG.width / CFG.height)
    draws = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    cfg = dataclasses.replace(
        CFG, alpha_mask=True, lazy_alpha_resolve=True,
        alpha_fallback_capacity=8,
    )
    vis = raster.rasterize(
        scene.meshes, scene.instances, draws, cam, cfg,
        materials=scene.materials,
    )
    _gb, aux = resolve.resolve_gbuffer(scene, vis, cam, cfg)
    assert int(aux.overflow) > 0


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_alpha_quad_diagonal_tie_reveals_backdrop(backend):
    """Tie-collapse semantics (deliberate): along a masked quad's diagonal
    both of its triangles produce bit-equal depths; the runner-up must be
    the geometry BEHIND the quad, not the quad's own cut twin — otherwise
    the single fallback level exhausts and background leaks through the
    hole. (An id-aware tie-break was tried in round 3 and regressed exactly
    this; see ops/fine_raster.py.)"""
    import dataclasses

    from voidin_tpu.passes import resolve

    w, mat_mask, mat_solid = _alpha_scene()
    scene = w.device()
    cfg = dataclasses.replace(CFG, alpha_mask=True, backend=backend)
    cam = _alpha_camera(cfg.width / cfg.height)
    draws = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    vis = raster.rasterize(
        scene.meshes, scene.instances, draws, cam, cfg,
        materials=scene.materials,
    )
    # center pixel sits ON the quad diagonal: winner and its twin tie
    cy, cx = cfg.height // 2, cfg.width // 2
    d1 = float(np.asarray(vis.depth)[cy, cx])
    assert d1 > 0.0
    # the runner-up is NOT at the winner's depth (tie collapsed): it is
    # the backdrop behind the quad
    d2 = float(np.asarray(vis.depth2)[cy, cx])
    assert d2 < d1  # reverse-Z: farther
    gb, _aux = resolve.resolve_gbuffer(scene, vis, cam, cfg)
    assert np.asarray(gb.material)[cy, cx] == mat_solid


def test_alpha_mask_off_keeps_legacy_semantics():
    """Without alpha_mask the cut pixel maps to background (the documented
    round-1 deviation) — guards the default path's behavior."""
    from voidin_tpu.passes import resolve

    w, _mat_mask, _mat_solid = _alpha_scene()
    scene = w.device()
    cam = _alpha_camera(CFG.width / CFG.height)
    draws = cull.DrawList(
        instance=jnp.arange(scene.instances.count, dtype=jnp.int32),
        count=jnp.int32(scene.instances.count),
    )
    vis = raster.rasterize(
        scene.meshes, scene.instances, draws, cam, CFG,
        materials=scene.materials,
    )
    assert vis.tri_id2 is None
    gb, _ = resolve.resolve_gbuffer(scene, vis, cam, CFG)
    cy, cx = CFG.height // 2, CFG.width // 2
    assert np.asarray(gb.depth)[cy, cx] == 0.0  # hole -> background


def test_fused_resolve_rec_matches_default():
    """fused_resolve_rec=True (attr row rides the resolve record) must be
    bit-identical to the two-gather default — it only moves WHERE the
    corner attributes are fetched."""
    import dataclasses

    from voidin_tpu.passes import resolve

    w = _scene()
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)

    def gb_of(cfg):
        vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, cfg)
        gb, aux = resolve.resolve_gbuffer(scene, vis, cam, cfg)
        return gb, aux

    gb_d, aux_d = gb_of(CFG)
    gb_f, aux_f = gb_of(dataclasses.replace(CFG, fused_resolve_rec=True))
    np.testing.assert_array_equal(np.asarray(gb_d.normal_uv),
                                  np.asarray(gb_f.normal_uv))
    np.testing.assert_array_equal(np.asarray(gb_d.material),
                                  np.asarray(gb_f.material))
    np.testing.assert_array_equal(np.asarray(aux_d.albedo),
                                  np.asarray(aux_f.albedo))


def test_fused_inst_rec_matches_inst_f16():
    """fused_inst_rec=True (the f16 instance+material record rides the
    resolve record from setup) must be bit-identical to inst_rec_f16's
    per-pixel gather — same u32 values, different route."""
    import dataclasses

    from voidin_tpu.passes import resolve

    w = _scene()
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)

    def gb_of(cfg, inst_rec=None):
        vis = raster.rasterize(scene.meshes, scene.instances, draws, cam,
                               cfg, inst_rec=inst_rec)
        gb, aux = resolve.resolve_gbuffer(scene, vis, cam, cfg)
        return vis, gb, aux

    base_cfg = dataclasses.replace(
        CFG, fused_resolve_rec=True, inst_rec_f16=True
    )
    _, gb_a, aux_a = gb_of(base_cfg)
    fused_cfg = dataclasses.replace(base_cfg, fused_inst_rec=True)
    vis_b, gb_b, aux_b = gb_of(fused_cfg,
                               inst_rec=resolve._inst_rec_f16(scene))
    assert vis_b.resolve_rec.shape[-1] >= 36  # the fold actually happened
    for name in ("normal_uv", "material", "depth"):
        np.testing.assert_array_equal(
            np.asarray(getattr(gb_a, name)), np.asarray(getattr(gb_b, name)),
            err_msg=f"fused_inst_rec {name} must be bit-identical",
        )
    np.testing.assert_array_equal(np.asarray(aux_a.albedo),
                                  np.asarray(aux_b.albedo))
    np.testing.assert_array_equal(np.asarray(aux_a.emissive),
                                  np.asarray(aux_b.emissive))


def test_inst_rec_f16_close_to_f32():
    """inst_rec_f16=True (fused instance record packed as f16 pairs, 48 B
    rows): ids and material selection must be EXACT; interpolated basis /
    color fields stay well inside the 1e-2 image budget."""
    import dataclasses

    from voidin_tpu.passes import resolve

    w = _scene()
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)

    def gb_of(cfg):
        vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, cfg)
        return resolve.resolve_gbuffer(scene, vis, cam, cfg)

    gb_d, aux_d = gb_of(CFG)
    gb_h, aux_h = gb_of(dataclasses.replace(CFG, inst_rec_f16=True))
    # discrete fields exact: material id, and depth (not touched by irec)
    np.testing.assert_array_equal(np.asarray(gb_d.material),
                                  np.asarray(gb_h.material))
    np.testing.assert_array_equal(np.asarray(gb_d.depth),
                                  np.asarray(gb_h.depth))
    # albedo: only lod selection can shift (f16 basis -> uv unchanged;
    # extent exact for pow2 textures) — require near-equality
    da = np.abs(np.asarray(aux_d.albedo) - np.asarray(aux_h.albedo))
    assert da.max() < 1e-2, da.max()
    # packed normals: octahedral u32 differs only in low bits; decode and
    # compare as vectors
    from voidin_tpu.core import encoding

    n_d = np.asarray(encoding.decode_octahedral_32(gb_d.normal_uv[..., 0]))
    n_h = np.asarray(encoding.decode_octahedral_32(gb_h.normal_uv[..., 0]))
    assert np.abs(n_d - n_h).max() < 2e-2, np.abs(n_d - n_h).max()
    # uv packing identical (uv never passes through the f16 record)
    np.testing.assert_array_equal(np.asarray(gb_d.normal_uv[..., 1]),
                                  np.asarray(gb_h.normal_uv[..., 1]))


def test_auto_lod_decimation():
    """decimate_grid + add_with_auto_lods: coarse levels shrink triangle
    counts substantially, keep the AABB, and render through the LOD path."""
    from voidin_tpu.scene.mesh import decimate_grid, make_torus_knot

    knot = make_torus_knot(segments=96, sides=16)  # ~3k tris
    coarse = decimate_grid(knot, 8)
    t0, t1 = knot.indices.size // 3, coarse.indices.size // 3
    assert t1 < t0 // 3, (t0, t1)
    # AABB preserved within a cell
    np.testing.assert_allclose(
        coarse.vertices.min(0), knot.vertices.min(0), atol=0.2)
    np.testing.assert_allclose(
        coarse.vertices.max(0), knot.vertices.max(0), atol=0.2)

    w = vt.World()
    base = w.meshes.add_with_auto_lods(knot, ratios=(6.0, 16.0),
                                       cells=(12, 7))
    assert "lods" in w.meshes.mesh_info[base]
    w.instances.add(np.asarray(mathx.from_translation([0, 0, -20])), base, 0)
    scene = w.device()
    cam = _camera(CFG.width / CFG.height)
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    sel = int(np.asarray(draws.mesh)[0])
    assert sel != base  # far instance picked a coarser level
    vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, CFG)
    assert int(vis.overflow) == 0
    assert (np.asarray(vis.tri_id) >= 0).sum() > 3


# ---------------------------------------------------------------------------
# Cross-boundary tie collapse: the within-chunk/group c2 mask cannot see a
# bit-equal twin that lands in a DIFFERENT chunk (pairs kernel, fr.CHUNK) or
# group (XLA twin, TRI_GROUP=8); the carry merge must collapse it too.
# ---------------------------------------------------------------------------

def _const_record(depth, tri_id, inside=True):
    """Raw coefficient record with constant depth covering every pixel
    (edges e = +-1 everywhere); `inside=False` makes it cover nothing."""
    r = np.zeros(fr.RECORD_F, np.float32)
    b = 1.0 if inside else -1.0
    r[2] = r[5] = r[8] = b
    r[fr.F_D + 2] = depth
    r[fr.F_ID] = tri_id
    r[fr.F_ZMAX] = depth
    return r


def test_runner_up_tie_collapse_across_groups_xla():
    K = 16
    recs = np.stack(
        [_const_record(0.0, -1.0, inside=False) for _ in range(K)]
    )
    recs[0] = _const_record(0.5, 7.0)      # winner, group 0
    recs[1] = _const_record(0.25, 3.0)     # true runner-up (backdrop)
    recs[8] = _const_record(0.5, 9.0)      # bit-equal twin, group 1
    d, i, d2, i2 = raster.fine_raster_xla(
        jnp.asarray(recs)[None], jnp.asarray([K], jnp.int32), CFG,
        track2=True,
    )
    assert float(d[0, 0]) == 0.5
    # the tie collapsed: runner-up is the backdrop, not the 0.5 twin
    assert float(d2[0, 0]) == 0.25, float(d2[0, 0])
    assert float(i2[0, 0]) == 3.0


def test_runner_up_tie_collapse_across_chunks_pairs():
    NT, E = 8, 2 * fr.CHUNK
    recs = np.stack(
        [_const_record(0.0, -1.0, inside=False) for _ in range(E)]
    )
    recs[0] = _const_record(0.5, 7.0)      # winner, chunk 0
    recs[1] = _const_record(0.25, 3.0)     # true runner-up, chunk 0
    recs[fr.CHUNK + 2] = _const_record(0.5, 9.0)  # bit-equal twin, chunk 1
    starts = np.zeros(NT, np.int32)
    counts = np.zeros(NT, np.int32)
    counts[0] = E
    d, i, d2, i2 = fr.fine_raster_pairs(
        jnp.asarray(recs), jnp.asarray(starts), jnp.asarray(counts),
        interpret=True, track2=True,
    )
    assert float(d[0, 0]) == 0.5
    assert float(d2[0, 0]) == 0.25, float(d2[0, 0])
    assert float(i2[0, 0]) == 3.0
    # order swap: twin first, winner+backdrop in the later chunk
    recs2 = np.stack(
        [_const_record(0.0, -1.0, inside=False) for _ in range(E)]
    )
    recs2[0] = _const_record(0.5, 9.0)
    recs2[fr.CHUNK + 1] = _const_record(0.5, 7.0)
    recs2[fr.CHUNK + 2] = _const_record(0.25, 3.0)
    d, i, d2, i2 = fr.fine_raster_pairs(
        jnp.asarray(recs2), jnp.asarray(starts), jnp.asarray(counts),
        interpret=True, track2=True,
    )
    assert float(d[0, 0]) == 0.5
    assert float(d2[0, 0]) == 0.25, float(d2[0, 0])
