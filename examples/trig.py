"""Hello triangle (src/bin/trig.rs equivalent): the smallest possible
pipeline smoke test — one triangle through the full raster + shade path."""

import argparse

import numpy as np

import voidin_tpu as vt
from voidin_tpu.io.image import save_png
from voidin_tpu.framework.renderer import Renderer
from voidin_tpu.passes.raster import RasterConfig
from voidin_tpu.scene.mesh import Mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trig.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()

    w = vt.World()
    tri = Mesh(
        vertices=np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        normals=np.tile(np.array([[0, 0, 1]], np.float32), (3, 1)),
        tangents=np.tile(np.array([[1, 0, 0, -1]], np.float32), (3, 1)),
        uvs=np.array([[0, 0], [1, 0], [0.5, 1]], np.float32),
        indices=np.array([0, 1, 2], np.int32),
    )
    mesh_id = w.meshes.add(tri)
    tex = w.textures.add(np.array([[[230, 80, 60, 255]]], np.uint8), srgb=True)
    mat = w.materials.add(albedo=tex)
    w.instances.add(np.eye(4, dtype=np.float32), mesh_id, mat)
    w.lights.add_point_light([0, 0, 3], 10.0, [1, 1, 1])

    cfg = RasterConfig(width=320, height=240, tri_capacity=1 << 8,
                       pair_capacity=1 << 10, tile_tri_capacity=64)
    import jax

    cfg = type(cfg)(**{**cfg.__dict__, "interpret": jax.default_backend() == "cpu"})
    r = Renderer(w.device(), cfg, enable_taa=False)
    img = r.render(vt.Camera(position=[0, 0, 2.5], aspect=320 / 240))
    save_png(args.out, img)
    print("wrote", args.out, "coverage:", int(r.aux["vis_coverage"]))


if __name__ == "__main__":
    main()
