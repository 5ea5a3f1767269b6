#!/usr/bin/env python
"""Times, on the GPU, the choices the bring-up on this card had to make:

* the fine-raster kernel's chunk size and warp count on the north-star
  pair stream (1920x1080, 10k-instance culled scene);
* the two plain forms of the LTC matrix fetch (shading.LTC12_MXU): the
  two-tap weight contraction at Precision.HIGHEST and the quad gather,
  alone at 1080p and inside the whole north-star frame.

Each time is the median of --n calls ended by block_until_ready, with
compilation excluded. Prints one line per measurement and, last, a JSON
object with all of them and the device stamp.

Usage: python tools/bring_up_ab.py [--n 20]
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args()

    from functools import partial

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from voidin_tpu.framework.device import (
        device_stamp, enable_compile_cache, require_accelerator, time_calls,
    )
    from voidin_tpu.framework.renderer import Renderer
    from voidin_tpu.ops import fine_raster as fr
    from voidin_tpu.passes import shading

    require_accelerator("bring_up_ab")
    enable_compile_cache()
    out = {}

    def record(name, compile_s, ms):
        out[name] = dict(median_ms=statistics.median(ms), min_ms=min(ms),
                         max_ms=max(ms), compile_s=compile_s)
        print(f"{name}: median {statistics.median(ms):.4f} ms "
              f"(min {min(ms):.4f}, max {max(ms):.4f}; compile "
              f"{compile_s:.2f} s)", flush=True)

    world, moving, cam, cfg = chip_smoke.north_star()
    scene = world.device()
    _, (rec, starts, counts, _) = chip_smoke.pair_stream(scene, cam.uniform(),
                                                         cfg)
    for chunk in (16, 32, 64):
        for warps in (2, 4, 8):
            k = jax.jit(partial(fr.fine_raster_pairs, chunk=chunk,
                                num_warps=warps))
            record(f"fine_raster_pairs chunk={chunk} warps={warps}",
                   *time_calls(lambda: k(rec, starts, counts), args.n))

    # LTC matrix fetch alone: per-pixel normals/views/roughness at 1080p
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    shape = (cfg.height, cfg.width)
    nor = jax.random.normal(k1, shape + (3,))
    nor = nor / jnp.linalg.norm(nor, axis=-1, keepdims=True)
    view = jax.random.normal(k2, shape + (3,))
    view = view / jnp.linalg.norm(view, axis=-1, keepdims=True)
    rough = jax.random.uniform(k3, shape)
    for form, mxu in (("contraction", True), ("quad_gather", False)):
        shading.LTC12_MXU = mxu
        f = jax.jit(lambda s, n, v, r: shading.ltc_matrix(s, n, v, r)[0])
        record(f"ltc_matrix 1080p {form}",
               *time_calls(lambda: f(scene, nor, view, rough), args.n))
        r = Renderer(world.device(), cfg, moving_ids=moving)
        record(f"frame 1080p ltc {form}",
               *time_calls(lambda: r.render(cam, dt=1 / 60), args.n))
        del r
    shading.LTC12_MXU = True
    print(json.dumps({"bring_up_ab": out, "device": device_stamp()}))


if __name__ == "__main__":
    main()
