"""End-to-end image anchoring against the independent numpy oracle.

tests/oracle_renderer.py implements the reference WGSL semantics
(visibility/shading/ltc/postprocess + the wgpu raster rules) from scratch
in numpy — no production rendering code, only shared INPUT data. These
tests diff the production frame against it at image level (VERDICT r3
next #6: "diffed <1e-2"), converting "goldens lock our own behavior" into
"goldens anchor to reference semantics".

Why image-level and not bit-level: two independently written rasterizers
legitimately disagree on coverage/tie pixels (different edge-function
arithmetic) and on texture LOD fractions (quad-derivative estimates vs
analytic gradients), and the production renderer carries documented
approximations (post-filter sRGB, parent-resampled trilinear — see
PARITY.md). The budgets below are tight enough that any semantic bug
(wrong light formula, wrong encode, a dropped pass — or the capacity
truncation this oracle caught in round 4, see test_golden.py CFG note)
blows through them, while the legitimate divergences stay inside.

First frame only (TAA off in both): configs 1 and 3 are the BASELINE
presets whose first frame is TAA-free by design.
"""

import numpy as np
import pytest

import voidin_tpu as vt
from voidin_tpu.framework.renderer import FrameState, Globals, render_frame
from voidin_tpu.passes.raster import RasterConfig

from . import oracle_renderer as orc


def _production(world, cam_uniform, width, height, caps, enable_cull,
                enable_rt_shadows=False):
    """First frame (TAA off) through the production frame program; the
    raster kernel runs compiled on an accelerator, interpreted on the CPU
    (chip_smoke.py runs these scenes on the GPU)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    cfg = RasterConfig(
        width=width, height=height,
        interpret=jax.default_backend() == "cpu", **caps
    )
    scene = world.device(with_tlas=enable_rt_shadows)
    g = Globals.make(width, height, frame=0, time=0.0, dt=0.0)
    state = FrameState.initial(width, height)
    img, _, _, aux = jax.jit(
        partial(
            render_frame, config=cfg, enable_cull=enable_cull,
            enable_taa=False, enable_rt_shadows=enable_rt_shadows,
        )
    )(scene, cam_uniform, g, state, jnp.zeros(0, jnp.int32))
    assert int(aux["overflow"]) == 0, "capacities must hold the scene"
    return np.asarray(img)


def case_deferred():
    """(production, oracle) images of the golden deferred scene."""
    from .test_golden import CFG, H, W, _deferred_scene

    w = _deferred_scene()
    cam = vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    cu = cam.uniform()
    prod = _production(
        w, cu, W, H,
        dict(tri_capacity=CFG.tri_capacity,
             pair_capacity=CFG.pair_capacity,
             tile_tri_capacity=CFG.tile_tri_capacity),
        enable_cull=False,
    )
    return prod, orc.render_oracle(w, cu, W, H)


def case_config1():
    """(production, oracle) images of BASELINE config 1 at 256x144."""
    from voidin_tpu.framework.presets import config1_single_mesh

    W, H = 256, 144
    p = config1_single_mesh(W / H)
    cu = p.camera.uniform()
    prod = _production(
        p.world, cu, W, H,
        dict(tri_capacity=1 << 17, pair_capacity=1 << 18,
             tile_tri_capacity=192),
        enable_cull=False,
    )
    return prod, orc.render_oracle(p.world, cu, W, H)


def _raytraced_world():
    from voidin_tpu.core import mathx

    w = vt.World()
    knot = w.meshes.add(vt.mesh.make_torus_knot(segments=48, sides=8))
    sphere = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 4))
    mat = w.materials.add()
    rng = np.random.default_rng(11)
    for i in range(8):
        a = 2 * np.pi * i / 8
        r = 3 + (i % 3)
        t = mathx.from_translation(
            [r * np.cos(a), 0.5 + (i % 3) * 1.2, -8 + r * np.sin(a)]
        ) @ mathx.from_scale(float(rng.uniform(0.6, 1.0)))
        w.instances.add(np.asarray(t), knot if i % 2 else sphere, mat)
    w.instances.add(
        np.asarray(
            mathx.from_translation([0, -1.0, -8]) @ mathx.from_scale(30.0)
        ),
        vt.mesh.HORIZONTAL_PLANE_MESH,
        mat,
    )
    # a LOW light elongates the cast shadows toward the camera (a high
    # light at this pose shadows only ~2% of pixels — too weak for the
    # dead-traversal check of the test)
    w.lights.add_point_light([8, 4, -2], 35.0, [0.7, 0.68, 0.6])
    return w


def case_raytraced():
    """(production, oracle, world, camera uniform, W, H) of the config-5
    class scene: TLAS-traced point-light shadows with the PRODUCTION
    traversal settings (threaded 8x16 screen-block packets)."""
    W, H = 192, 108
    w = _raytraced_world()
    cu = vt.Camera(position=[0, 4, 3], pitch=-22.0, aspect=W / H).uniform()
    prod = _production(
        w, cu, W, H,
        dict(tri_capacity=1 << 15, pair_capacity=1 << 16,
             tile_tri_capacity=128, rt_packet=128, rt_threaded=True),
        enable_cull=False, enable_rt_shadows=True,
    )
    return prod, orc.render_oracle_raytraced(w, cu, W, H), w, cu, W, H


def _diff_report(prod, oracle):
    d = np.abs(prod - oracle)
    return dict(
        mean=float(d.mean()),
        p99=float(np.percentile(d, 99)),
        frac_gt_05=float((d > 0.05).mean()),
    )


def _assert_anchored(prod, oracle, mean_budget=1e-2, name=""):
    assert np.isfinite(oracle).all(), f"{name}: oracle produced non-finite"
    assert prod.std() > 0.02, f"{name}: production image is empty"
    assert oracle.std() > 0.02, f"{name}: oracle image is empty"
    rep = _diff_report(prod, oracle)
    assert rep["mean"] < mean_budget, f"{name}: {rep}"
    # edge/tie pixels may flip, but they must stay a small minority
    assert rep["frac_gt_05"] < 0.05, f"{name}: {rep}"


def test_oracle_matches_production_deferred_scene():
    """The golden deferred scene (point + area light, 5 spheres + plane):
    the fastest full-pipeline anchor."""
    prod, oracle = case_deferred()
    _assert_anchored(prod, oracle, name="deferred")


def test_oracle_matches_production_config1():
    """BASELINE config 1 (single dense mesh, point light, no cull/TAA) at
    reduced resolution — shading.wgsl point-light semantics + raster at
    ~65k triangles."""
    prod, oracle = case_config1()
    _assert_anchored(prod, oracle, name="config1")


def test_oracle_matches_production_config3():
    """BASELINE config 3 (glTF + two LTC area lights + point light):
    textured materials, normal maps, LTC area lighting."""
    from voidin_tpu.framework.presets import config3_gltf_arealights

    W, H = 256, 144
    p = config3_gltf_arealights(W / H)
    cu = p.camera.uniform()
    prod = _production(
        p.world, cu, W, H,
        dict(tri_capacity=1 << 17, pair_capacity=1 << 18,
             tile_tri_capacity=192),
        enable_cull=True,
    )
    oracle = orc.render_oracle(p.world, cu, W, H)
    # textured content adds the LOD-estimate and sRGB-filter-order
    # divergences (both documented above); the budget stays well below
    # anything a semantic bug would produce
    _assert_anchored(prod, oracle, mean_budget=1.5e-2, name="config3")


def test_oracle_matches_production_raytraced():
    """Config-5-class scene (TLAS raytraced point-light shadows) against
    the brute-force world-space occlusion oracle — anchors the whole
    BVH/packet/threaded traversal stack at image level (VERDICT r4 next
    #6). The production frame runs the PRODUCTION traversal settings
    (threaded 8x16 screen-block packets)."""
    prod, oracle, w, cu, W, H = case_raytraced()
    _assert_anchored(prod, oracle, name="raytraced")

    # the shadows must MATTER in this frame: the oracle re-run with an
    # empty occlusion set must differ measurably from the production
    # frame, otherwise this test can't see a dead traversal
    orig = orc._world_triangles
    orc._world_triangles = lambda _w: np.zeros((0, 3, 3), np.float32)
    try:
        no_shadow = orc.render_oracle_raytraced(w, cu, W, H)
    finally:
        orc._world_triangles = orig
    d = np.abs(prod - no_shadow)
    # measured at this pose: mean ~1.3e-3 over ~3.7% of pixels — a dead
    # traversal (occlusion never applied) trips both
    assert d.mean() > 5e-4 and (d.sum(-1) > 0.01).mean() > 0.02


def test_oracle_matches_production_taa_two_frames():
    """Two-frame temporal anchor (VERDICT r4 next #6): frame 0 seeds
    history, frame 1 renders with a different sub-pixel jitter and a
    previous-frame camera, and the TAA resolve (reproject + YCbCr clamp +
    blend) must match the independent numpy port of reproject.wgsl:14-38 +
    taa.wgsl:45-103 at image level."""
    import dataclasses
    from functools import partial

    import jax
    import jax.numpy as jnp

    from .test_golden import CFG, H, W, _deferred_scene

    w = _deferred_scene()
    cam = vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)

    # Halton-style sub-pixel jitters in NDC units (jitter-in-projection)
    j0 = np.array([0.25 / W, -0.33 / H], np.float32) * 2.0
    j1 = np.array([-0.4 / W, 0.2 / H], np.float32) * 2.0
    cam.jitter = j0
    cu0 = cam.uniform()
    cam.jitter = j1
    cu1 = cam.uniform(previous=cu0)

    cfg_caps = dict(tri_capacity=CFG.tri_capacity,
                    pair_capacity=CFG.pair_capacity,
                    tile_tri_capacity=CFG.tile_tri_capacity)
    from voidin_tpu.passes.raster import RasterConfig

    cfg = RasterConfig(width=W, height=H, interpret=True, **cfg_caps)
    scene = w.device()
    g = Globals.make(W, H, frame=0, time=0.0, dt=0.0)
    state = FrameState.initial(W, H)
    f = jax.jit(
        partial(render_frame, config=cfg, enable_cull=False,
                enable_taa=True)
    )
    mov = jnp.zeros(0, jnp.int32)
    img0, state, _, aux0 = f(scene, cu0, g, state, mov)
    img1, state, _, aux1 = f(scene, cu1, g, state, mov)
    assert int(aux0["overflow"]) == 0 and int(aux1["overflow"]) == 0
    prod = np.asarray(img1)

    oracle = orc.render_oracle_taa(w, [cu0, cu1], W, H)
    _assert_anchored(prod, oracle, name="taa_two_frames")

    # the temporal pass must MATTER: the TAA-off frame-1 image differs
    prod0 = np.asarray(img0)
    assert np.abs(prod - prod0).mean() > 1e-4


def test_oracle_matches_production_config7():
    """Config 7 (Sponza-geometry-scale class): many DISTINCT single
    -instance meshes, one textured material per mesh, two LTC area lights
    + point light — anchors the unique-geometry path (per-mesh vertex
    pools, 30+ BLAS draw records) to the from-spec oracle."""
    from voidin_tpu.framework.presets import config7_sponza_geometry

    W, H = 256, 144
    p = config7_sponza_geometry(W / H, n_textures=8, base_size=64,
                                detail=0.15)
    cu = p.camera.uniform()
    prod = _production(
        p.world, cu, W, H,
        dict(tri_capacity=1 << 15, pair_capacity=1 << 17,
             tile_tri_capacity=1024),
        enable_cull=True,
    )
    oracle = orc.render_oracle(p.world, cu, W, H)
    # same textured-content divergences as config 3 (LOD estimate +
    # sRGB filter order)
    _assert_anchored(prod, oracle, mean_budget=1.5e-2, name="config7")
