"""Per-pass GPU-time profiler.

Equivalent of the reference's wgpu_profiler scope tree (ProfilerCommandEncoder,
app.rs:660-729): per-pass device timings printed as an indented table, gated
on the GPU_PROFILING env var with a 500-frame cadence (app.rs:417-424).

Each pass is jitted separately and timed on the host clock around calls
ended by `block_until_ready` (median of a few calls after a warm-up). This
measures per-pass steady-state time, not in-frame overlap — the same
semantic as the reference's timestamp scopes.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp

PROFILING_ENV = "GPU_PROFILING"
DUMP_EVERY = 500  # frames (app.rs:417)


def profiling_enabled() -> bool:
    return bool(os.environ.get(PROFILING_ENV))


def time_fn(fn: Callable, *args, n: int = 5) -> float:
    """Median milliseconds of `n` calls of jitted `fn(*args, 0.0)`, each
    ended by block_until_ready, after one compile/warm-up call. The
    trailing scalar argument keeps the timed inputs runtime values."""
    f = jax.jit(fn)
    eps = jnp.float32(0.0)
    jax.block_until_ready(f(*args, eps))
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args, eps))
        ms.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(ms)


def profile_frame(scene, camera, config, state=None, moving_ids=None) -> List[Tuple[str, float]]:
    """Per-pass timing table for one frame's stages."""
    import numpy as np

    from ..passes import cull, postprocess as pp, raster, resolve, shading, taa as taa_m
    from .renderer import FrameState

    if moving_ids is None:
        moving_ids = jnp.zeros((0,), jnp.int32)
    if state is None:
        state = FrameState.initial(config.width, config.height)

    rows: List[Tuple[str, float]] = []
    draws = jax.jit(lambda s, c: cull.emit_draws(s.meshes, s.instances, c))(
        scene, camera
    )
    rows.append(
        (
            "emit_draws (cull+compact)",
            time_fn(
                lambda e: cull.emit_draws(
                    scene.meshes, scene.instances,
                    camera.replace(znear=camera.znear + e),
                )
            ),
        )
    )
    setup = jax.jit(
        lambda s, c, d: raster.triangle_setup(s.meshes, s.instances, d, c, config)
    )(scene, camera, draws)
    rows.append(
        (
            "triangle setup + clip",
            time_fn(
                lambda e: raster.triangle_setup(
                    scene.meshes,
                    scene.instances,
                    draws,
                    camera.replace(znear=camera.znear + e),
                    config,
                )
            ),
        )
    )
    # the binning + fine raster the frame itself runs (config.backend)
    if config.backend == "pallas":
        from ..ops import fine_raster as fr

        def bin_fn(s):
            return raster.bin_triangles_pairs(s, config)[:3]

        def raster_fn(b, e):
            return fr.fine_raster_pairs(
                b[0] + e, b[1], b[2], interpret=config.interpret,
                track2=config.alpha_mask,
            )
    else:
        def bin_fn(s):
            return raster.bin_triangles(s, config)[:2]

        def raster_fn(b, e):
            return raster.fine_raster_xla(b[0] + e, b[1], config,
                                          track2=config.alpha_mask)
    binned = jax.jit(bin_fn)(setup)
    rows.append(
        (
            "binning (pairs+sort)",
            time_fn(lambda e: bin_fn({**setup, "sx": setup["sx"] + e})),
        )
    )
    rows.append(
        (
            f"fine raster ({config.backend})",
            time_fn(lambda e: raster_fn(binned, e)),
        )
    )
    vis = jax.jit(
        lambda s, c, d: raster.rasterize(s.meshes, s.instances, d, c, config)
    )(scene, camera, draws)
    rows.append(
        (
            "gbuffer resolve",
            time_fn(
                lambda e: resolve.resolve_gbuffer(
                    scene, vis.replace(depth=vis.depth + e), camera, config
                )
            ),
        )
    )
    gb, aux = jax.jit(
        lambda s, v, c: resolve.resolve_gbuffer(s, v, c, config)
    )(scene, vis, camera)
    rows.append(
        (
            "deferred shade (LTC)",
            time_fn(
                lambda e: shading.shade(
                    scene, gb.replace(depth=gb.depth + e), camera, aux=aux
                )
            ),
        )
    )
    hdr = jax.jit(lambda s, g, c: shading.shade(s, g, c))(scene, gb, camera)
    rows.append(
        ("taa (reproject+resolve)", time_fn(lambda e: taa_m.taa(hdr + e, gb, camera, state)[:2]))
    )
    rows.append(("postprocess", time_fn(lambda e: pp.postprocess(hdr + e))))
    return rows


def print_table(rows: List[Tuple[str, float]]):
    total = sum(t for _, t in rows)
    print(f"{'pass':30s} {'ms':>9s}")
    for name, t in rows:
        print(f"  {name:28s} {t:9.3f}")
    print(f"{'total (sum of passes)':30s} {total:9.3f}")
