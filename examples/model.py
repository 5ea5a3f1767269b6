"""The flagship example — everything at once (src/bin/model.rs:64-229).

Scene per the reference's default binary, adapted to the assets present in
the mount (model.rs loads Sponza + DamagedHelmet + ferris; Sponza's .bin and
ferris3d_v1.0.glb are absent, so AntiqueCamera stands in for the big glTF
scene and torus knots for ferris):

* point light + two LTC area lights (emissive light quads added by
  add_area_light, app.rs:220-236);
* two glTF documents imported into the pools;
* a ring of 10 moving spheres + 10 moving torus knots animated on-device by
  compute_update (rotation-Z +-2*sin(0.5t)*dt, compute_update.wgsl:19-27);
* full pipeline: cull -> visibility raster -> deferred LTC shade -> TAA ->
  postprocess, HUD burn-in, recorded clip + screenshot.

Run: python examples/model.py --cpu --frames 8 --out model.png
     python examples/model.py --record clip_dir --frames 120   (GPU)
"""

import argparse
import os

import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.framework.app import App, AppState, Example
from voidin_tpu.passes.raster import RasterConfig

ASSETS = "/root/reference/assets/glTF-Sample-Models/2.0"


class Model(Example):
    name = "model"

    def setup_scene(self, app: App):
        from voidin_tpu.io.gltf import GltfDocument

        w = app.world
        w.lights.add_point_light([0.0, 0.5, 0.0], 10.0, [1.0, 1.0, 1.0])
        app.add_area_light(
            [1, 1, 1], 7.0, (5.0, 8.0),
            np.asarray(
                mathx.from_translation([0, 10, 15])
                @ mathx.from_rotation_x(np.float32(-np.pi / 4))
            ),
        )
        app.add_area_light(
            [1, 1, 1], 7.0, (5.0, 8.0),
            np.asarray(
                mathx.from_translation([0, 10, -25])
                @ mathx.from_rotation_x(np.float32(-3 * np.pi / 4))
            ),
        )

        # Big glTF scene (Sponza stand-in) + DamagedHelmet (model.rs:86-106).
        camera_gltf = os.path.join(ASSETS, "AntiqueCamera/glTF/AntiqueCamera.gltf")
        helmet_glb = os.path.join(ASSETS, "DamagedHelmet/glTF-Binary/DamagedHelmet.glb")
        if os.path.exists(camera_gltf):
            doc = GltfDocument.import_file(w, camera_gltf)
            doc.add_to_world(
                w,
                np.asarray(
                    mathx.from_translation([7.0, -5.0, 1.0])
                    @ mathx.from_scale(0.5)
                ),
            )
        if os.path.exists(helmet_glb):
            doc = GltfDocument.import_file(w, helmet_glb)
            doc.add_to_world(
                w,
                np.asarray(
                    mathx.from_translation([0.0, 0.0, 9.0]) @ mathx.from_scale(3.0)
                ),
            )

        # Static torus knots where model.rs places two ferris instances.
        knot = w.meshes.add(vt.mesh.make_torus_knot(segments=96, sides=16))
        rng = np.random.default_rng(7)
        n_mats = len(w.materials)
        for pos in ([-3.0, -5.0, -4.0], [2.0, -5.0, -2.0]):
            w.instances.add(
                np.asarray(mathx.from_translation(pos) @ mathx.from_scale(1.5)),
                knot,
                int(rng.integers(0, n_mats)),
            )

        # Moving ring: 10 spheres at r=3.5, z=-17 + 10 knots at z=-9
        # (model.rs:118-143); compute_update animates them on device.
        sphere10 = w.meshes.add(vt.mesh.make_uv_sphere(1.0, 10))
        num = 10
        for i in range(num):
            r = 3.5
            angle = 2 * np.pi * i / num
            x, y = r * np.cos(angle), r * np.sin(angle)
            app.moving_ids.append(
                w.instances.add(
                    np.asarray(mathx.from_translation([x, y, -17.0])),
                    sphere10,
                    int(rng.integers(0, n_mats)),
                )
            )
            app.moving_ids.append(
                w.instances.add(
                    np.asarray(
                        mathx.from_translation([x, y, -9.0])
                        @ mathx.from_rotation_z(np.float32(angle))
                        @ mathx.from_scale(1.0)
                    ),
                    knot,
                    int(rng.integers(0, n_mats)),
                )
            )
        # Ground so the area lights have something to reflect off.
        w.instances.add(
            np.asarray(mathx.from_translation([0, -5.2, 0]) @ mathx.from_scale(80.0)),
            vt.mesh.HORIZONTAL_PLANE_MESH,
            0,
        )

    def update(self, app: App, state: AppState):
        pass  # jitter + compute_update are driven by Renderer.render


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=1024)  # model.rs window
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default="model.png")
    ap.add_argument("--record", default=None, help="record a clip to this path")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    import jax

    cfg = RasterConfig(
        width=args.width,
        height=args.height,
        tri_capacity=1 << 18,
        pair_capacity=1 << 19,
        tile_tri_capacity=128,
        interpret=jax.default_backend() == "cpu",
    )
    cam = vt.Camera(
        position=[2.0, 5.0, 12.0], yaw=0.0, pitch=-20.0,
        aspect=args.width / args.height,
    )  # model.rs:232-236
    app = App(Model(), camera=cam, config=cfg)
    if args.record:
        fps = app.run(args.frames, record_path=args.record, hud=True)
        print(f"recorded {args.frames} frames to {args.record} (fps {fps:.1f})")
    else:
        img = None
        for _ in range(args.frames):
            img = app.step()
    from voidin_tpu.io.image import save_png

    if args.record or img is None:  # record consumed its frames inside
        # run(); --frames 0 without --record never stepped at all
        img = app.step()
    save_png(args.out, img)
    aux = app.renderer.aux
    print(
        "wrote", args.out,
        "draws:", int(aux["draw_count"]),
        "coverage:", int(aux["vis_coverage"]),
        "overflow:", int(aux["overflow"]),
    )


if __name__ == "__main__":
    main()
