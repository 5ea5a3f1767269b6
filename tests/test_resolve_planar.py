"""Planar (channel-major) resolve: RasterConfig.planar_resolve.

The planar path evaluates the same arithmetic as the vector path, only on
(H, W) planes instead of (H, W, 3)-shaped arrays (whose tiny trailing
dims may pad when materialized between fusions).

Certification contract (PARITY.md): the GBuffer fields (packed normal,
packed uv, material id, depth) are BIT-IDENTICAL — interpolation,
octahedral encode and f16 uv pack agree exactly. The full-precision aux
taps (albedo/emissive/mr) may differ by last-ulp amounts (<= ~6e-6)
because XLA fuses/reassociates (FMA) the restructured graph differently
than the vector one; the post-quantization (u8) frame is identical.
"""

import dataclasses

import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.passes import cull, raster, resolve

from .test_resolve_quad import (
    CFG,
    _camera,
    _gb_of,
    _textured_scene,
)

# Last-ulp budget for the full-precision aux channels (see module doc).
AUX_ATOL = 2e-5


def _planar(cfg):
    return dataclasses.replace(cfg, planar_resolve=True)


def _assert_planar_match(a, b):
    gb_a, aux_a = a
    gb_b, aux_b = b
    np.testing.assert_array_equal(
        np.asarray(gb_a.normal_uv), np.asarray(gb_b.normal_uv)
    )
    np.testing.assert_array_equal(
        np.asarray(gb_a.material), np.asarray(gb_b.material)
    )
    np.testing.assert_array_equal(
        np.asarray(gb_a.depth), np.asarray(gb_b.depth)
    )
    for k in ("albedo", "emissive", "mr"):
        np.testing.assert_allclose(
            np.asarray(getattr(aux_a, k)), np.asarray(getattr(aux_b, k)),
            atol=AUX_ATOL, rtol=0,
        )


def test_planar_gbuffer_bit_identical_aux_ulp():
    scene = _textured_scene().device()
    cam = _camera(CFG.width / CFG.height)
    _assert_planar_match(
        _gb_of(scene, cam, CFG), _gb_of(scene, cam, _planar(CFG))
    )


def test_planar_inst_f16():
    scene = _textured_scene().device()
    cam = _camera(CFG.width / CFG.height)
    cfg_h = dataclasses.replace(CFG, inst_rec_f16=True)
    _assert_planar_match(
        _gb_of(scene, cam, cfg_h), _gb_of(scene, cam, _planar(cfg_h))
    )


def test_planar_fused_rec():
    """planar composes with fused_resolve_rec (the all_lut production
    combination)."""
    scene = _textured_scene().device()
    cam = _camera(CFG.width / CFG.height)
    cfg_f = dataclasses.replace(
        CFG, fused_resolve_rec=True, inst_rec_f16=True
    )
    _assert_planar_match(
        _gb_of(scene, cam, cfg_f), _gb_of(scene, cam, _planar(cfg_f))
    )


def test_planar_normal_mapped():
    """Tangent interpolation + TBN + normal-map tap on planes."""
    w = _textured_scene()
    rng = np.random.default_rng(3)
    nrm = rng.integers(100, 156, (32, 32, 3)).astype(np.uint8)
    nrm[..., 2] = 255
    tn = w.textures.add(nrm, srgb=False)
    m = w.materials.add(albedo=1, normal=tn)
    t = mathx.from_translation([0.0, 0.3, -3.0])
    w.instances.add(np.asarray(t), vt.mesh.SPHERE_1_MESH, m)
    scene = w.device()
    assert not getattr(scene, "no_normal_maps", False)
    cam = _camera(CFG.width / CFG.height)
    _assert_planar_match(
        _gb_of(scene, cam, CFG), _gb_of(scene, cam, _planar(CFG))
    )


def test_planar_alpha_mask():
    """Lazy alpha fallback: the planar dense pass feeds the same winner
    fields into the compacted fallback machinery (which stays on the
    vector path — it operates on flat batches, not images)."""
    from tests.test_raster import _alpha_camera, _alpha_scene

    w, _, _ = _alpha_scene()
    scene = w.device()
    assert scene.alpha_masked
    cfg = dataclasses.replace(CFG, alpha_mask=True)
    cam = _alpha_camera(CFG.width / CFG.height)
    _assert_planar_match(
        _gb_of(scene, cam, cfg), _gb_of(scene, cam, _planar(cfg))
    )
    cfg_d = dataclasses.replace(cfg, lazy_alpha_resolve=False)
    _assert_planar_match(
        _gb_of(scene, cam, cfg_d), _gb_of(scene, cam, _planar(cfg_d))
    )


def test_planar_full_frame_u8_identical():
    """Through the WHOLE frame pipeline (update/cull/raster/resolve/
    shade/TAA/post): the pre-quantization frame agrees to last-ulp scale
    and the u8 frame (what any sink sees) is bit-identical."""
    import jax.numpy as jnp

    from voidin_tpu.framework.renderer import (
        FrameState, Globals, render_frame,
    )

    scene = _textured_scene().device()
    cam = _camera(CFG.width / CFG.height)
    g = Globals.make(CFG.width, CFG.height, frame=1, time=0.5, dt=1 / 60)
    state = FrameState.initial(CFG.width, CFG.height).replace(
        history_valid=jnp.asarray(True)
    )
    mov = jnp.zeros(0, jnp.int32)
    base, _st, _sc, _aux = render_frame(scene, cam, g, state, mov, CFG)
    plan, _st, _sc, _aux = render_frame(scene, cam, g, state, mov,
                                        _planar(CFG))
    base = np.asarray(base)
    plan = np.asarray(plan)
    np.testing.assert_allclose(plan, base, atol=1e-4, rtol=0)
    q = lambda x: np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    mismatch = (q(base) != q(plan)).mean()
    assert mismatch <= 1e-4, f"u8 frame flips: {mismatch:.2e}"
