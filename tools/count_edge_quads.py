#!/usr/bin/env python
"""Count non-uniform (edge) 2x2 quads in the north-star frame at 1080p:

* visibility-buffer tri-id quads -> RasterConfig.quad_edge_capacity
* TAA reprojected-history floor-coord spread -> RasterConfig.
  taa_edge_capacity (quads whose 4 bilinear footprints don't fit one
  4x4 block)

Backend-independent (the XLA-twin raster matches the pair kernel), so this
runs on the CPU. Quad-rate gathers cost by CAPACITY: keep it tight per
scene, like tri/pair capacities.

Usage: python -u tools/count_edge_quads.py [--frames K]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8,
                    help="frames to step (moving instances change edges)")
    ap.add_argument("--config", type=int, default=0,
                    help="BASELINE preset 1-5 (0 = north-star scene)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    import bench
    import voidin_tpu as vt
    from voidin_tpu.passes import cull as cull_pass
    from voidin_tpu.passes import raster as raster_pass
    from voidin_tpu.passes import update as update_pass
    from voidin_tpu.passes.raster import RasterConfig

    W, H = 1920, 1080
    if args.config:
        from voidin_tpu.framework.presets import PRESETS

        p = PRESETS[args.config](W / H)
        world, moving = p.world, np.asarray(p.moving_ids, np.int32)
        scene = world.device()
        tri_cap, pair_cap = p.tri_capacity, p.pair_capacity
        cam = p.camera
    else:
        world, moving = bench.build_world(n_instances=10_000)
        scene = world.device()
        tri_cap = pair_cap = 1 << 19
        cam = vt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                        aspect=W / H)
    # tile_tri_capacity 1024, not the bench's 128: the XLA twin bins with a
    # PER-TILE cap (the pair kernel the bench runs has none), and the
    # north-star pose holds up to 636 pairs in one tile.
    cfg = RasterConfig(
        width=W, height=H, tri_capacity=tri_cap, pair_capacity=pair_cap,
        tile_tri_capacity=1024, backend="xla",
        alpha_mask=getattr(scene, "alpha_masked", False),
    )
    uni = cam.uniform()

    from voidin_tpu.passes import resolve as resolve_pass
    from voidin_tpu.passes import taa as taa_pass

    @jax.jit
    def edge_count(scene_, t):
        inst = update_pass.compute_update(
            scene_.instances, jnp.asarray(moving), t, jnp.asarray(1 / 60.0)
        )
        scene_ = scene_.replace(instances=inst)
        draws = cull_pass.emit_draws(scene_.meshes, scene_.instances, uni)
        vis = raster_pass.rasterize(
            scene_.meshes, scene_.instances, draws, uni, cfg,
            materials=scene_.materials,
        )
        q = vis.tri_id.reshape(H // 2, 2, W // 2, 2)
        anchor = q[:, 0, :, 0]
        nonuni = ~jnp.all(q == anchor[:, None, :, None], axis=(1, 3))

        # TAA: quads whose reprojected bilinear footprints spread past the
        # 4x4 block (taa._bilinear_clamp_quadblock's edge condition)
        gb, _aux = resolve_pass.resolve_gbuffer(scene_, vis, uni, cfg)
        motion = taa_pass.reproject(gb, uni)
        uu = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
        vv = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
        hist_u = uu[None, :] - motion[..., 0] * 0.5
        hist_v = vv[:, None] + motion[..., 1] * 0.5
        x0 = jnp.clip(jnp.floor(hist_u * W - 0.5).astype(jnp.int32),
                      0, W - 1)
        y0 = jnp.clip(jnp.floor(hist_v * H - 0.5).astype(jnp.int32),
                      0, H - 1)

        def q4(a):
            return a.reshape(H // 2, 2, W // 2, 2).transpose(0, 2, 1, 3)

        x4, y4 = q4(x0), q4(y0)
        spread = (
            (jnp.max(x4, (2, 3)) - jnp.min(x4, (2, 3)) > 2)
            | (jnp.max(y4, (2, 3)) - jnp.min(y4, (2, 3)) > 2)
        )
        # albedo-tap edge quads (texture/mip/wrap straddles): run the
        # tap-block resolve at capacity 1 — its overflow counter + 1 IS
        # the edge count. Caveats handled: (a) the lazy alpha-fallback
        # overflow shares the counter on alpha-masked configs, so measure
        # it separately (same config, no tap_block) and subtract; (b) the
        # counter saturates at 0, so a scene with ZERO edge quads still
        # reports 1 — harmless for capacity sizing (min capacity is 1024).
        import dataclasses as _dc

        cfg_tap = _dc.replace(cfg, tap_block=True, tap_edge_capacity=1)
        _gb2, aux2 = resolve_pass.resolve_gbuffer(scene_, vis, uni, cfg_tap)
        tap_ovf = aux2.overflow
        if _aux is not None and _aux.overflow is not None:
            tap_ovf = tap_ovf - _aux.overflow  # alpha-fallback share
        return (jnp.sum(nonuni.astype(jnp.int32)),
                jnp.sum(spread.astype(jnp.int32)),
                jnp.maximum(tap_ovf, 0) + 1, vis.overflow)

    counts, tcounts, tapcounts = [], [], []
    for f in range(args.frames):
        c, tc, tpc, ovf = edge_count(
            scene, jnp.asarray(f / 60.0, jnp.float32)
        )
        counts.append(int(c))
        tcounts.append(int(tc))
        tapcounts.append(int(tpc))
        print(f"frame {f}: edge quads {int(c)} "
              f"({100 * int(c) / (H * W // 4):.1f}% of {H * W // 4}) "
              f"taa-edge {int(tc)} tap-edge {int(tpc)} "
              f"overflow {int(ovf)}", flush=True)

    def cap_of(mx):
        cap = 1 << max((mx - 1).bit_length(), 10)
        if cap < mx * 1.25:
            cap *= 2  # headroom for pose drift
        return cap

    print(f"max {max(counts)} -> suggested quad_edge_capacity "
          f"{cap_of(max(counts))}")
    print(f"taa max {max(tcounts)} -> suggested taa_edge_capacity "
          f"{cap_of(max(tcounts))}")
    print(f"tap max {max(tapcounts)} -> suggested tap_edge_capacity "
          f"{cap_of(max(tapcounts))}")


if __name__ == "__main__":
    main()
