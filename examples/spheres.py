"""Minimal end-to-end example: procedural spheres + plane, lights, full
frame pipeline (cull -> raster -> shade -> TAA -> postprocess) to PNG.

The analogue of the reference's src/bin/model.rs scene shape (ring of
spheres, area lights, ground) with procedural assets only.
"""

import argparse

import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.framework.renderer import Renderer
from voidin_tpu.io.image import save_png
from voidin_tpu.passes.raster import RasterConfig


def build_world():
    w = vt.World()
    w.lights.add_point_light([0, 2.0, 0], 15.0, [1.0, 0.9, 0.8])
    w.add_area_light(
        [1, 1, 1],
        7.0,
        (5.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 10, 15])
            @ mathx.from_rotation_x(np.float32(-np.pi / 4))
        ),
    )

    # checkerboard-ish materials
    red = w.materials.add(base_color=(0.8, 0.2, 0.2, 1.0))
    blue = w.materials.add(base_color=(0.2, 0.2, 0.9, 1.0))

    sphere5 = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 5))
    n = 10
    moving = []
    for i in range(n):
        a = 2 * np.pi * i / n
        t = mathx.from_translation([3.5 * np.cos(a), 1.0 + 3.5 * np.sin(a), -10.0])
        moving.append(
            w.instances.add(np.asarray(t), sphere5, red if i % 2 else blue)
        )
    # ground plane
    w.instances.add(
        np.asarray(mathx.from_translation([0, -5, -10]) @ mathx.from_scale(60.0)),
        vt.mesh.HORIZONTAL_PLANE_MESH,
        0,
    )
    return w, moving


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="spheres.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()

    world, moving = build_world()
    import jax

    cfg = RasterConfig(
        width=args.width,
        height=args.height,
        tri_capacity=1 << 16,
        pair_capacity=1 << 18,
        tile_tri_capacity=128,
        interpret=jax.default_backend() == "cpu",
    )
    r = Renderer(world.device(), cfg, moving_ids=np.asarray(moving, np.int32))
    cam = vt.Camera(position=[0.0, 2.0, 2.0], yaw=0.0, pitch=-10.0,
                    aspect=args.width / args.height)
    img = None
    for _ in range(args.frames):
        img = r.render(cam)
    print("draws:", int(r.aux["draw_count"]), "coverage:", int(r.aux["vis_coverage"]),
          "overflow:", int(r.aux["overflow"]))
    save_png(args.out, img)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
