"""Raytraced point-light shadows over the TLAS (src/bin/raytraced_shadows.rs
equivalent): instanced scene, SAH BVH + TLAS, per-pixel any-hit shadow rays."""

import argparse

import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.framework.renderer import Renderer
from voidin_tpu.io.image import save_png
from voidin_tpu.passes.raster import RasterConfig


def build_world():
    w = vt.World()
    w.lights.add_point_light([3.0, 6.0, 2.0], 30.0, [1.0, 0.95, 0.85])
    mat = w.materials.add()
    sphere5 = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 5))
    cube = w.meshes.add(vt.mesh.make_cube_mesh(1.2))
    rng = np.random.default_rng(3)
    for i in range(14):
        a = 2 * np.pi * i / 14
        r = 2.0 + (i % 3)
        t = mathx.from_translation([r * np.cos(a), 0.2 + 0.8 * (i % 4), -6 + r * np.sin(a)])
        w.instances.add(np.asarray(t), sphere5 if i % 2 else cube, mat)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1.2, -6]) @ mathx.from_scale(40.0)),
        vt.mesh.HORIZONTAL_PLANE_MESH,
        mat,
    )
    return w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--out", default="raytraced_shadows.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()

    w = build_world()
    cfg = RasterConfig(
        width=args.width,
        height=args.height,
        tri_capacity=1 << 16,
        pair_capacity=1 << 18,
        tile_tri_capacity=128,
        # production config-5 traversal: threaded (stackless) 8x16
        # screen-block packets — bit-exact with the per-ray loop
        rt_packet=128,
        rt_threaded=True,
    )
    import jax

    cfg = type(cfg)(**{**cfg.__dict__, "interpret": jax.default_backend() == "cpu"})
    r = Renderer(
        w.device(with_tlas=True), cfg, enable_taa=False, enable_rt_shadows=True
    )
    cam = vt.Camera(position=[0, 3.0, 1.0], yaw=0.0, pitch=-20.0,
                    aspect=args.width / args.height)
    img = r.render(cam)
    save_png(args.out, img)
    print("wrote", args.out, "coverage:", int(r.aux["vis_coverage"]))


if __name__ == "__main__":
    main()
