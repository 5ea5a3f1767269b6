"""Sponza-scale texture-pool stress (VERDICT r3 next #3).

The reference's flagship loads Sponza — ~103 real 1024^2 textures
(/root/reference/src/bin/model.rs:86-106). Sponza.bin is absent from the
asset mount, so config6_sponza_textures puts the REAL Sponza texture set
on synthesized geometry. These tests validate (a) the HBM budget math
that makes the texel-quad pool viable at that scale, (b) the preset
builds and renders, (c) the real textures actually load when the mount
is present.
"""

import numpy as np
import pytest

from voidin_tpu.framework.presets import config6_sponza_textures, find_asset
from voidin_tpu.scene.texture import pool_device_bytes

HBM_BYTES = 16 << 30  # device-memory budget the pool layout was sized for
# 1080p frame working set + capacities + pools stay far under this
FRAME_RESERVE = 4 << 30


def test_sponza_pool_budget():
    """The ~108-slot 1024^2 pool (104 preset textures + 4 reserved ids)
    fits a 16 GB budget without the tap-block tables — and provably would NOT
    with them, which is why bench.run_preset builds blocks only when the
    tuned variant taps them."""
    n_slots = 104 + 4
    plain = pool_device_bytes(n_slots, 1024, blocks=False)
    assert plain < HBM_BYTES - FRAME_RESERVE, f"{plain / 2**30:.1f} GiB"
    # sanity on the per-slot constant documented in the preset docstring
    per_slot = pool_device_bytes(1, 1024, blocks=False)
    assert abs(per_slot - (4 / 3) * 1024 * 1024 * 32) / per_slot < 0.01
    blocked = pool_device_bytes(n_slots, 1024, blocks=True)
    assert blocked > HBM_BYTES - FRAME_RESERVE, (
        "if the 3x block tables fit comfortably, drop this gate and "
        "enable tap_blocks for config 6"
    )


def test_config6_builds_and_renders_small():
    """Scaled-down config 6 (tiny pool size, 12 textures, 2 knots)
    renders a clean frame end to end: many-material resolve + textured
    shading + area light, overflow 0."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from voidin_tpu.framework.renderer import (
        FrameState, Globals, render_frame,
    )
    from voidin_tpu.passes.raster import RasterConfig

    W, H = 160, 96
    # low-poly knots: the full-detail mesh at 160x96 is sub-pixel-dense
    # (hundreds of triangles per tile); the 1080p bench preset uses the
    # dense knot with tile capacity 192
    p = config6_sponza_textures(W / H, base_size=64, n_textures=12,
                                n_knots=2, knot_detail=(48, 8))
    cfg = RasterConfig(
        width=W, height=H, tri_capacity=1 << 14, pair_capacity=1 << 16,
        tile_tri_capacity=512, backend="xla",
    )
    scene = p.world.device(tap_blocks=False)
    g = Globals.make(W, H, frame=0, time=0.0, dt=0.0)
    state = FrameState.initial(W, H)
    img, _, _, aux = jax.jit(
        partial(render_frame, config=cfg, enable_cull=True,
                enable_taa=False)
    )(scene, p.camera.uniform(), g, state, jnp.zeros(0, jnp.int32))
    img = np.asarray(img)
    assert int(aux["overflow"]) == 0
    assert np.isfinite(img).all()
    assert img.std() > 0.02, "stress frame rendered empty"
    # many DISTINCT textures actually reach pixels: the rendered knots
    # use different albedos, so hue variance across the image is real
    assert np.abs(img[..., 0] - img[..., 1]).max() > 0.05


def test_config6_loads_real_sponza_textures():
    if find_asset("glTF-Sample-Models/2.0/Sponza/glTF") is None:
        pytest.skip("Sponza textures not mounted")
    p = config6_sponza_textures(16 / 9, base_size=64, n_textures=70,
                                n_knots=1)
    pool = p.world.textures
    # 4 reserved + 69 real Sponza files + 1 procedural pad
    assert len(pool.images) == 4 + 70
    # the real files are distinct content, not copies of one image
    real = [pool.images[4 + i] for i in range(8)]
    assert len({im.tobytes() for im in real}) == len(real)


def test_config6_procedural_fallback():
    """Without the asset mount the preset still builds (procedural
    textures), so the stress config runs anywhere."""
    import voidin_tpu.framework.presets as pr

    orig = pr.find_asset
    try:
        pr.find_asset = lambda rel: None
        p = pr.config6_sponza_textures(16 / 9, base_size=64,
                                       n_textures=8, n_knots=1)
        assert len(p.world.textures.images) == 4 + 8
    finally:
        pr.find_asset = orig


def test_config7_sponza_geometry_scale():
    """Config 7 synthesizes Sponza's GEOMETRY character (VERDICT r4
    missing #3): ~250k unique triangles over ~25 distinct meshes with one
    instance each — per-mesh BLASes, no instancing leverage, no LOD
    chains (model.rs:86-106 loads the 262k-tri Sponza glTF once)."""
    from voidin_tpu.framework.presets import config7_sponza_geometry

    p = config7_sponza_geometry(16 / 9, n_textures=8, base_size=64)
    w = p.world
    tris = w.meshes._index_count // 3
    assert 200_000 < tris < 320_000, tris
    # ~25 distinct scene meshes (+4 pool builtins), each its own BLAS
    assert len(w.meshes) >= 24 + 4
    assert len(w.meshes.bvh_nodes) == len(w.meshes)
    # single-instance character: one draw per scene mesh
    assert len(w.instances.transforms) >= 24
    assert p.moving_ids == []  # static model, like Sponza


def test_config7_builds_and_renders_small():
    """Scaled-down config 7 renders a clean frame end to end with
    overflow 0: unique-geometry raster + textured resolve + area
    lights."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from voidin_tpu.framework.presets import config7_sponza_geometry
    from voidin_tpu.framework.renderer import (
        FrameState, Globals, render_frame,
    )
    from voidin_tpu.passes.raster import RasterConfig

    W, H = 256, 144
    p = config7_sponza_geometry(W / H, n_textures=8, base_size=64,
                                detail=0.15)
    cfg = RasterConfig(
        width=W, height=H, tri_capacity=1 << 15, pair_capacity=1 << 17,
        tile_tri_capacity=1024, backend="xla",
    )
    scene = p.world.device(tap_blocks=False)
    g = Globals.make(W, H, frame=0, time=0.0, dt=0.0)
    state = FrameState.initial(W, H)
    img, _, _, aux = jax.jit(
        partial(render_frame, config=cfg, enable_cull=True,
                enable_taa=False)
    )(scene, p.camera.uniform(), g, state, jnp.zeros(0, jnp.int32))
    img = np.asarray(img)
    assert int(aux["overflow"]) == 0
    assert int(aux["draw_count"]) >= 24
    assert np.isfinite(img).all()
    assert img.std() > 0.02, "geometry-stress frame rendered empty"
