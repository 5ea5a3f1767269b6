"""LTC ring (annulus) light demo — src/bin/ring_light.rs equivalent.

Uses the EXACT clipped-disk LTC evaluation (ellipse eigen-decomposition +
cubic solve, ring_light.wgsl:189-305): spec via ltc_evaluate_ring2 (full
disk minus shrunk disk), diffuse via the full disk — the reference demo's
semantics, including the flat-grey material-0 background and the
ray-intersected annulus emitter band."""

import argparse

import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.io.image import save_png
from voidin_tpu.passes import cull, raster, resolve, shading
from voidin_tpu.passes.raster import RasterConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--out", default="ring_light.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    import jax

    w = vt.World()
    grey = w.materials.add(albedo=w.textures.add(
        np.array([[[170, 170, 175, 255]]], np.uint8), srgb=True))
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1, -6]) @ mathx.from_scale(40.0)),
        vt.mesh.HORIZONTAL_PLANE_MESH, grey)
    for i in range(3):
        t = mathx.from_translation([2.0 * (i - 1), 0.0, -6.0])
        w.instances.add(np.asarray(t), vt.mesh.SPHERE_10_MESH, grey)
    scene = w.device()
    cfg = RasterConfig(width=args.width, height=args.height,
                       tri_capacity=1 << 16, pair_capacity=1 << 18,
                       interpret=jax.default_backend() == "cpu")
    cam = vt.Camera(position=[0, 2.0, -1.0], pitch=-18.0,
                    aspect=args.width / args.height).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, cfg)
    gb, aux = resolve.resolve_gbuffer(scene, vis, cam, cfg)
    hdr = shading.shade_ring_light(
        scene, gb, cam,
        disk_center=[0, 4.0, -2.0], disk_dirx=[1.0, 0.0, 0.0],
        disk_diry=[0.0, 0.2, -1.0], halfx=2.5, halfy=2.5,
        albedo=aux.albedo,
    )
    from voidin_tpu.passes.postprocess import postprocess
    from voidin_tpu.scene.texture import linear_to_srgb

    img = linear_to_srgb(postprocess(hdr))
    save_png(args.out, np.asarray(img))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
