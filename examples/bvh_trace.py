"""Primary-ray TLAS tracer with traversal-depth heat overlay — the
src/bin/bvh_trace.wgsl / bvh_gpu.rs equivalent, validating the BVH stack
on device against the raster path."""

import argparse

import numpy as np

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.io.image import save_png
from voidin_tpu.rt import traverse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--out", default="bvh_trace.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    w = vt.World()
    knot = w.meshes.add(vt.mesh.make_torus_knot(segments=128, sides=24))
    rng = np.random.default_rng(5)
    for i in range(12):
        a = 2 * np.pi * i / 12
        t = mathx.from_translation([4 * np.cos(a), (i % 3) - 1, -8 + 4 * np.sin(a)])
        w.instances.add(np.asarray(t), knot if i % 2 else vt.mesh.SPHERE_1_MESH, 0)
    scene = w.device(with_tlas=True)
    tlas, blas, inst, tri_pos = traverse.scene_rays(scene)

    cam = vt.Camera(position=[0, 2.5, 0.0], yaw=0.0, pitch=-15.0,
                    aspect=args.width / args.height)
    u = cam.uniform()
    H, W = args.height, args.width
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = 1 - (np.arange(H) + 0.5) / H * 2
    xx, yy = np.meshgrid(xs, ys)
    clip = np.stack([xx, yy, np.full_like(xx, 0.5), np.ones_like(xx)], -1)
    world = clip @ np.asarray(u.clip_to_world).T
    world = world[..., :3] / world[..., 3:4]
    origins = np.broadcast_to(np.asarray(u.position)[:3], world.shape).reshape(-1, 3)
    dirs = (world - np.asarray(u.position)[:3]).reshape(-1, 3).astype(np.float32)

    f = jax.jit(lambda o, d: traverse.closest_hit(tlas, blas, inst, tri_pos, o, d, t_max=1e6))
    res = f(jnp.asarray(origins, jnp.float32), jnp.asarray(dirs))
    t = np.asarray(res.t).reshape(H, W)
    visits = np.asarray(res.visits).reshape(H, W)
    assert int(res.overflow) == 0 and int(res.exhausted) == 0, (
        f"traversal overflow={int(res.overflow)} exhausted={int(res.exhausted)}"
    )

    hit = t < 1e6
    shade = np.where(hit, 1.0 / (1.0 + 0.05 * t), 0.05)
    heat = np.clip(visits / max(visits.max(), 1), 0, 1)
    img = np.stack([shade + heat * 0.6, shade, shade], -1).clip(0, 1)
    save_png(args.out, img)
    print("wrote", args.out, "hit frac:", float(hit.mean()),
          "max visits:", int(visits.max()))


if __name__ == "__main__":
    main()
