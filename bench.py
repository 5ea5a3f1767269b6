#!/usr/bin/env python
"""North-star benchmark: ms/frame at 1080p on a 10k-instance culled scene
(cull + raster + shade + TAA + postprocess), per BASELINE.json.

Scene: 10k instances (spheres / cubes / planes) scattered over a large
field so the frustum culls most of them, with LTC area lights, a point
light, TAA and postprocessing — the full frame pipeline in one jit.

Each frame is timed on the host clock around `Renderer.render` ended by
`block_until_ready`; the JSON line reports the median over --frames frames,
with the first call's compile time apart, and names the device it ran on.
On a machine where JAX finds no accelerator the script exits non-zero
(except --smoke, a CPU wiring check at tiny scale).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
vs_baseline is (16.6 ms display budget) / measured.
"""

import json
import os
import statistics
import sys

import numpy as np

# Perf-option variants swept by tools/ab_options.py on the north-star frame.
# name -> (RasterConfig overrides, LTC_LUT_BF16, area_light_scale).
# Every variant is image-budget-tested: fused_rec is bit-identical
# (tests/test_raster.py test_fused_resolve_rec_matches_default), ltc_bf16
# stays under the 1e-2 budget (tests/test_ltc.py test_ltc_lut_bf16_...),
# area_half is a documented deviation tested to mean < 5e-3
# (test_half_res_area_lights_close_to_full_res). None has been measured on
# the current device until tools/ab_options.py runs there.
AB_VARIANTS = {
    "base": (dict(), False, 1),
    # gather-free TAA history fetch (bit-identical,
    # tests/test_taa_inwindow.py)
    "slim_pw": (
        dict(slim_rec=True, planar_resolve=True, taa_inwindow=True), True, 2
    ),
    "all_lut_pw": (
        dict(fused_resolve_rec=True, inst_rec_f16=True,
             planar_resolve=True, taa_inwindow=True), True, 2
    ),
    "taa_inw": (dict(taa_inwindow=True), False, 1),
    # quad-block history fetch with the where-chain select (bit-identical,
    # tests/test_taa_inwindow.py)
    "slim_pqw": (
        dict(slim_rec=True, planar_resolve=True, taa_quad_history=True,
             taa_quad_where=True), True, 2
    ),
    "all_lut_pqw": (
        dict(fused_resolve_rec=True, inst_rec_f16=True, planar_resolve=True,
             taa_quad_history=True, taa_quad_where=True), True, 2
    ),
    "taa_qw": (dict(taa_quad_history=True, taa_quad_where=True), False, 1),
    # planar (channel-major) resolve: identical arithmetic on (H, W)
    # planes (tests/test_resolve_planar.py)
    "all_lut_p": (
        dict(fused_resolve_rec=True, inst_rec_f16=True,
             planar_resolve=True), True, 2
    ),
    # slim_rec: ONE 96 B record row (clip + uv + world-space oct normals +
    # 12xf16 material payload); image budget like inst_rec_f16
    # (tests/test_resolve_slim.py); Renderer falls back to fused+f16 on
    # scenes outside the envelope (normal maps / non-const emissive/mr /
    # alpha masking).
    "slim_p": (dict(slim_rec=True, planar_resolve=True), True, 2),
    # fused_inst_rec folds the f16 instance+material record INTO the
    # resolve record at setup (tests/test_raster.py
    # test_fused_inst_rec_matches_inst_f16).
    "all_lut_pi": (
        dict(fused_resolve_rec=True, inst_rec_f16=True,
             planar_resolve=True, fused_inst_rec=True), True, 2
    ),
    "ifold": (
        dict(fused_resolve_rec=True, inst_rec_f16=True,
             fused_inst_rec=True), False, 1
    ),
    "planar": (dict(planar_resolve=True), False, 1),
    # tile-rate (slot) resolve + quad-block TAA history + quad-rate albedo
    # tap are bit-exact with the default path (tests/test_resolve_slot.py,
    # test_taa_quad.py, test_texture_meta.py)
    "all_s": (
        dict(slot_resolve=True, inst_rec_f16=True,
             taa_quad_history=True, tap_block=True), True, 2
    ),
    # quad-rate resolve + quad-block TAA history + quad-rate albedo tap
    # (tests/test_resolve_quad.py, test_taa_quad.py, test_texture_meta.py)
    "all_q": (
        dict(quad_rate_resolve=True, inst_rec_f16=True,
             taa_quad_history=True, tap_block=True), True, 2
    ),
    "slot": (dict(slot_resolve=True), False, 1),
    "taa_quad": (dict(taa_quad_history=True), False, 1),
    "tap_block": (dict(tap_block=True), False, 1),
    "all_lut": (dict(fused_resolve_rec=True, inst_rec_f16=True), True, 2),
    "quad": (dict(quad_rate_resolve=True), False, 1),
    # every bit-exact coherence option and nothing else
    "all_exact": (
        dict(quad_rate_resolve=True, taa_quad_history=True, tap_block=True),
        False, 1
    ),
    "all_x": (dict(quad_rate_resolve=True, inst_rec_f16=True), True, 2),
    "all": (dict(fused_resolve_rec=True, inst_rec_f16=True), True, 2),
    "slim_solo": (dict(slim_rec=True), False, 1),
    "fused_rec": (dict(fused_resolve_rec=True), False, 1),
    "inst_f16": (dict(inst_rec_f16=True), False, 1),
    "ltc_bf16": (dict(), True, 1),
    "area_half": (dict(), False, 2),
}

METRIC = "ms/frame 1080p 10k-instance culled scene (cull+raster+shade+TAA)"


def apply_ab_runtime_options(bf16, ascale):
    """Set the module-level shading switch for a variant (returns
    area_light_scale unchanged for the caller to plumb)."""
    from voidin_tpu.passes import shading

    shading.LTC_LUT_BF16 = bf16
    return ascale


def ab_variants_stamp():
    """Canonical JSON-stable description of AB_VARIANTS, written into
    AB_OPTIONS.json by the sweep and REQUIRED to match by tuned_options —
    a capture taken before a variant's definition changed must not steer
    the official run (it measured something else)."""
    return {
        name: [sorted(cfg.items()), bool(bf16), int(ascale)]
        for name, (cfg, bf16, ascale) in AB_VARIANTS.items()
    }


def tuned_options(path=None, with_meta=False, device_kind=None):
    """The fastest measured variant from AB_OPTIONS.json (written by
    tools/ab_options.py). A sweep steers the run only if its stamped
    `device_kind` equals the current device's (`device_kind`, default
    jax.devices()[0].device_kind) and it measured the same variant
    definition this build applies (checked per variant). Otherwise the
    run uses "base" — the RasterConfig defaults. `with_meta`: also return
    whether a valid sweep backed the choice."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "AB_OPTIONS.json")
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    name, swept = "base", False
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        d = {}
    if d.get("device_kind") == device_kind:
        cur = json.loads(json.dumps(ab_variants_stamp()))
        stored = d.get("variants") or {}
        ms = {
            k: v for k, v in d.get("ms_per_variant", {}).items()
            if k in AB_VARIANTS and isinstance(v, (int, float))
            and stored.get(k) == cur.get(k)
        }
        if ms:
            name, swept = min(ms, key=ms.get), True
    if with_meta:
        return name, AB_VARIANTS[name], swept
    return name, AB_VARIANTS[name]


def build_world(n_instances=10_000, seed=0):
    import voidin_tpu as vt
    from voidin_tpu.core import mathx

    rng = np.random.default_rng(seed)
    w = vt.World()
    w.lights.add_point_light([0, 10.0, 0], 40.0, [1.0, 0.95, 0.9])
    w.add_area_light(
        [1, 1, 1],
        7.0,
        (5.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 18, 10])
            @ mathx.from_rotation_x(np.float32(-np.pi / 4))
        ),
    )
    w.add_area_light(
        [1, 0.8, 0.6],
        5.0,
        (6.0, 6.0),
        np.asarray(
            mathx.from_translation([0, 18, -40])
            @ mathx.from_rotation_x(np.float32(-3 * np.pi / 4))
        ),
    )

    # mesh mix sized so ~10k instances yield ~1.5M pooled triangles —
    # heavier than the reference's own scenes (Sponza ~260k tris) while
    # staying within one frame's capacity budget
    # real textures so texture-fetch cost is represented (pool sizes to
    # content; checkerboard + noise at 256^2)
    yy, xx = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    checker = ((xx // 16 + yy // 16) % 2 * 155 + 100).astype(np.uint8)
    tex_checker = w.textures.add(
        np.stack([checker, checker // 2 + 64, checker // 3 + 42], -1), srgb=True
    )
    noise = rng.integers(60, 220, (256, 256, 3)).astype(np.uint8)
    tex_noise = w.textures.add(noise, srgb=True)
    mat_checker = w.materials.add(albedo=tex_checker)
    mat_noise = w.materials.add(albedo=tex_noise)

    sphere2 = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 2))  # ~250 tris
    sphere3 = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 3))  # ~600 tris
    cube = w.meshes.add(vt.mesh.make_cube_mesh(1.5))  # 12 tris
    meshes = [sphere2, cube, sphere3, vt.mesh.SPHERE_1_MESH]
    # Geometric LOD (cull.select_lod): instances past ~540/ratio px of
    # screen radius rasterize coarser spheres — live triangles (and with
    # them the capacity-padded setup/bin costs) drop ~3x with no visible
    # change at 1080p (sub-pixel triangles are pure binning waste).
    sphere1 = vt.mesh.SPHERE_1_MESH  # ~50 tris
    w.meshes.set_lods(sphere3, [(sphere2, 8.0), (sphere1, 20.0)])
    w.meshes.set_lods(sphere2, [(sphere1, 14.0)])

    # 10k instances in a 400x400 field; the camera sees a narrow slice.
    moving = []
    for i in range(n_instances - w.instances.__len__()):
        x = rng.uniform(-200, 200)
        z = rng.uniform(-200, 200)
        y = rng.uniform(-2, 6)
        t = mathx.from_translation([x, y, z]) @ mathx.from_scale(
            float(rng.uniform(0.5, 1.5))
        )
        mid = int(rng.integers(0, len(meshes)))
        idx = w.instances.add(
            np.asarray(t), meshes[mid], mat_checker if i % 2 else mat_noise
        )
        if i % 50 == 0:
            moving.append(idx)
    # ground
    w.instances.add(
        np.asarray(mathx.from_translation([0, -3, 0]) @ mathx.from_scale(500.0)),
        vt.mesh.HORIZONTAL_PLANE_MESH,
        0,
    )
    return w, np.asarray(moving, np.int32)


def _report(metric, ms, compile_s, renderer, extra):
    from voidin_tpu.framework.device import device_stamp

    med = statistics.median(ms)
    print(
        f"# draws={int(renderer.aux['draw_count'])} "
        f"overflow={int(renderer.aux['overflow'])} "
        f"coverage={int(renderer.aux['vis_coverage'])}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": metric,
        "value": med,
        "unit": "ms",
        "vs_baseline": 16.6 / med,
        "frames": len(ms),
        "ms_min": min(ms),
        "ms_max": max(ms),
        "compile_s": compile_s,
        "overflow": int(renderer.aux["overflow"]),
        **extra,
        "device": device_stamp(),
    }), flush=True)


def _time_frames(renderer, camera, frames, joint_mats=lambda: None):
    """time_calls over Renderer.render; `joint_mats()` gives each frame's
    skinning matrices (None for unskinned scenes)."""
    from voidin_tpu.framework.device import time_calls

    return time_calls(
        lambda: renderer.render(camera, dt=1 / 60,
                                joint_mats=joint_mats()), frames
    )


def run_preset(n, rt_scale=0, ab=True, frames=10):
    """Run one of the BASELINE preset configs (framework/presets.py).
    rt_scale > 0 overrides the preset's rt_shadow_scale (config-5
    half-res shadow rays, a documented deviation tested in
    tests/test_traverse.py). `ab`: apply the tuned A/B variant (a sweep
    measured on this device, else "base"); the applied variant is recorded
    in the JSON line."""
    import dataclasses

    from voidin_tpu.framework.device import (
        enable_compile_cache, require_accelerator,
    )

    suffix = f" (rt_shadow_scale={rt_scale})" if rt_scale else ""
    metric = f"ms/frame 1080p BASELINE config {n}{suffix}"
    require_accelerator(metric)
    enable_compile_cache()
    from voidin_tpu.framework.presets import PRESETS
    from voidin_tpu.framework.renderer import Renderer
    from voidin_tpu.passes.raster import RasterConfig

    p = PRESETS[n](1920 / 1080)
    if rt_scale:
        p = dataclasses.replace(p, rt_shadow_scale=rt_scale)
    if ab:
        ab_name, (ab_cfg, ab_bf16, ab_ascale), ab_swept = \
            tuned_options(with_meta=True)
        apply_ab_runtime_options(ab_bf16, ab_ascale)
    else:
        ab_name, ab_cfg, ab_ascale, ab_swept = "base", {}, 1, False
    cfg = RasterConfig(
        width=1920,
        height=1080,
        tri_capacity=p.tri_capacity,
        pair_capacity=p.pair_capacity,
        tile_tri_capacity=p.tile_tri_capacity,
        quad_edge_capacity=p.quad_edge_capacity,
        taa_edge_capacity=p.taa_edge_capacity,
        tap_edge_capacity=p.tap_edge_capacity,
        rt_packet=p.rt_packet,
        rt_threaded=p.rt_threaded,
        **ab_cfg,
    )
    r = Renderer(
        # block tables cost 3x the pool bytes — only build them when the
        # tuned variant actually taps them
        p.world.device(with_tlas=p.with_tlas,
                       tap_blocks=bool(ab_cfg.get("tap_block", False))),
        cfg,
        enable_cull=p.enable_cull,
        enable_taa=p.enable_taa,
        enable_rt_shadows=p.enable_rt_shadows,
        rt_shadow_scale=p.rt_shadow_scale,
        area_light_scale=ab_ascale,
        moving_ids=np.asarray(p.moving_ids, np.int32),
    )

    def jm():
        return p.animator(r.time) if p.animator else None

    compile_s, ms = _time_frames(r, p.camera, frames, jm)
    _report(metric, ms, compile_s, r,
            dict(options=ab_name, options_swept=ab_swept))
    return r, p


def main():
    import argparse

    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0,
                    help="BASELINE preset 1-7; 0 = north-star 10k scene")
    ap.add_argument("--rt-scale", type=int, default=0,
                    help="override preset rt_shadow_scale (2 = half-res "
                    "shadow rays, documented deviation)")
    ap.add_argument("--smoke", action="store_true",
                    help="drive the EXACT north-star wiring (incl. the A/B "
                    "option application) at tiny scale on the CPU — a "
                    "wiring check, not a measurement")
    ap.add_argument("--no-ab", action="store_true",
                    help="run at base options (no tuned variant)")
    ap.add_argument("--frames", type=int, default=10,
                    help="timed frames after the compile call; the median "
                    "is reported")
    args = ap.parse_args()
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    if args.config:
        run_preset(args.config, rt_scale=args.rt_scale, ab=not args.no_ab,
                   frames=args.frames)
        return

    import voidin_tpu as vt
    from voidin_tpu.framework.device import (
        enable_compile_cache, require_accelerator,
    )
    from voidin_tpu.framework.renderer import Renderer
    from voidin_tpu.passes.raster import RasterConfig

    if not args.smoke:
        require_accelerator(METRIC)
    enable_compile_cache()
    world, moving = build_world(n_instances=300 if args.smoke else 10_000)
    if args.smoke:
        # exercise every option path (all_s is the strict superset: slot
        # resolve + quad TAA/tap + f16 instance records + bf16 LUT weights
        # + half-res area lights)
        ab_name, ab_swept = "all_s", False
        ab_cfg, ab_bf16, ab_ascale = AB_VARIANTS["all_s"]
    elif args.no_ab:
        ab_name, (ab_cfg, ab_bf16, ab_ascale), ab_swept = \
            "base", AB_VARIANTS["base"], False
    else:
        ab_name, (ab_cfg, ab_bf16, ab_ascale), ab_swept = \
            tuned_options(with_meta=True)
    if ab_name != "base":
        print(f"# applying A/B variant: {ab_name}", file=sys.stderr)
    apply_ab_runtime_options(ab_bf16, ab_ascale)
    W, H = (320, 184) if args.smoke else (1920, 1080)
    cap = 1 << (14 if args.smoke else 19)
    cfg = RasterConfig(
        width=W,
        height=H,
        tri_capacity=cap,  # ~204k live LOD-selected tris at the bench pose
        pair_capacity=cap,  # overflow checked 0 at the bench pose
        tile_tri_capacity=128,
        interpret=jax.default_backend() == "cpu",
        # edge capacities of the coherence options at the bench pose
        # (tools/count_edge_quads.py): quad-rate resolve edge quads, TAA
        # edge quads, tap-block edge quads
        quad_edge_capacity=0 if args.smoke else 1 << 15,
        taa_edge_capacity=0 if args.smoke else 1 << 12,
        tap_edge_capacity=0 if args.smoke else 1 << 15,
        **ab_cfg,
    )
    r = Renderer(world.device(), cfg, moving_ids=moving,
                 area_light_scale=ab_ascale)
    cam = vt.Camera(
        position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0, aspect=W / H
    )
    frames = 2 if args.smoke else args.frames
    compile_s, ms = _time_frames(r, cam, frames)
    metric = METRIC
    if args.smoke:
        # never report the official metric string for a tiny CPU run
        metric = f"SMOKE {W}x{H} cpu culled scene (not a measurement)"
    _report(metric, ms, compile_s, r,
            dict(options=ab_name, options_swept=ab_swept,
                 **({"smoke": True} if args.smoke else {})))


if __name__ == "__main__":
    main()
