"""16 B split-twin pool tables (TexturePoolData.quads_child/parent).

Big pools (>= texture._SPLIT_MIN_ROWS flattened rows) carry 16 B-row
twins of the 32 B quad table (two 16 B fetches in place of one 32 B
fetch). The
twins hold the SAME bytes, so every sample must be bit-identical to the
unsplit path. The threshold is monkeypatched here so the tests stay
CPU-sized."""

import numpy as np
import pytest

import voidin_tpu.scene.texture as tex_mod
from voidin_tpu.scene.texture import TexturePool


def _pool(monkeypatch, split: bool):
    monkeypatch.setattr(
        tex_mod, "_SPLIT_MIN_ROWS", 1 if split else 1 << 60
    )
    rng = np.random.default_rng(7)
    p = TexturePool(base_size=64)
    p.add(rng.integers(0, 255, (64, 64, 4), np.uint8).astype(np.uint8),
          srgb=True)
    p.add(rng.integers(0, 255, (48, 32, 4), np.uint8).astype(np.uint8))
    p.add(rng.integers(0, 255, (16, 16, 4), np.uint8).astype(np.uint8))
    return p.device(blocks=False)


def test_split_tables_bitexact(monkeypatch):
    import jax.numpy as jnp

    base = _pool(monkeypatch, split=False)
    split = _pool(monkeypatch, split=True)
    assert base.quads_child is None
    assert split.quads_child is not None
    # twins are byte-slices of the same table
    np.testing.assert_array_equal(
        np.asarray(split.quads_child), np.asarray(split.quads)[:, :16]
    )
    np.testing.assert_array_equal(
        np.asarray(split.quads_parent), np.asarray(split.quads)[:, 16:]
    )

    rng = np.random.default_rng(3)
    n = 4096
    uv = jnp.asarray(rng.random((n, 2), np.float32) * 2.0 - 0.5)
    lod = jnp.asarray((rng.random(n) * 7.0).astype(np.float32))
    tid = jnp.asarray(rng.integers(4, 7, n).astype(np.int32))

    for kwargs in (
        dict(lod=lod),                      # trilinear (child + parent)
        dict(lod=lod, trilinear=False),     # nearest-level bilinear
        dict(lod=None),                     # level-0 bilinear
    ):
        a = tex_mod.sample_trilinear(base, tid, uv, **kwargs)
        b = tex_mod.sample_trilinear(split, tid, uv, **kwargs)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_split_frame_last_ulp(monkeypatch):
    """Whole-frame budget: samples are bit-exact (above), but inside the
    frame program XLA fuses/contracts the surrounding arithmetic
    differently per table layout — measured last-ulp drift (~4e-7 max at
    160x96 config-6). Goldens are u8-quantized and unaffected; this
    pins the drift so a real regression (wrong texels ~1e-2+) trips."""
    import jax.numpy as jnp  # noqa: F401

    from voidin_tpu.framework.presets import config6_sponza_textures
    from voidin_tpu.framework.renderer import Renderer
    from voidin_tpu.passes.raster import RasterConfig

    def render(split):
        monkeypatch.setattr(
            tex_mod, "_SPLIT_MIN_ROWS", 1 if split else 1 << 60
        )
        W, H = 160, 96
        p = config6_sponza_textures(W / H, base_size=64, n_textures=12,
                                    n_knots=2, knot_detail=(48, 8))
        cfg = RasterConfig(
            width=W, height=H, tri_capacity=p.tri_capacity,
            pair_capacity=p.pair_capacity,
            tile_tri_capacity=p.tile_tri_capacity, interpret=True,
        )
        r = Renderer(p.world.device(), cfg, enable_taa=p.enable_taa,
                     moving_ids=np.asarray(p.moving_ids, np.int32))
        return np.asarray(r.render(p.camera))

    a = render(False)
    b = render(True)
    assert np.abs(a.astype(np.float64) - b).max() < 1e-5


def test_split_snapshot_roundtrip(tmp_path, monkeypatch):
    import jax.tree_util as jtu

    import voidin_tpu as vt
    from voidin_tpu.core import mathx
    from voidin_tpu.io.snapshot import load_scene, save_scene

    monkeypatch.setattr(tex_mod, "_SPLIT_MIN_ROWS", 1)
    w = vt.World()
    w.instances.add(np.asarray(mathx.from_translation([0, 0, -4])),
                    vt.mesh.SPHERE_1_MESH, 0)
    scene = w.device()
    assert scene.textures.quads_child is not None
    p = tmp_path / "scene_split.npz"
    save_scene(str(p), scene)
    scene2, _ = load_scene(str(p))
    for a, b in zip(jtu.tree_leaves(scene), jtu.tree_leaves(scene2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert scene2.textures.quads_child is not None


def test_pool_device_bytes_split_accounting(monkeypatch):
    from voidin_tpu.scene.texture import pool_device_bytes

    # default: twins disabled (the paired fetch measured SLOWER than one
    # 32 B gather on hardware — see _SPLIT_MIN_ROWS), no byte doubling
    assert pool_device_bytes(8, 1024) == 8 * 1398101 * 32
    # with the threshold active the twins double the bytes
    monkeypatch.setattr(tex_mod, "_SPLIT_MIN_ROWS", 2_000_000)
    assert pool_device_bytes(8, 1024) == 8 * 1398101 * 32 * 2
    assert pool_device_bytes(4, 64) == 4 * 5461 * 32
