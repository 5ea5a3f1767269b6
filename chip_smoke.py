#!/usr/bin/env python
"""Smoke test of the production frame on one GPU (or four, --cards 4).

Phases, each raising on failure (nothing is caught, nothing falls back to
the CPU):

1. device  — JAX's default backend must be "gpu"; prints device_kind and
             the card's name and power limit (nvidia-smi), and checks that
             the north-star frame's lowered HLO holds the Triton custom call
             of the fine-raster kernel (compiled, not interpreted).
2. kernel  — the pair-streaming kernel against fine_raster_xla on the
             north-star pair stream at 1920x1080 (tile_tri_capacity = the
             largest per-tile count, so both see every pair): the per-pixel
             id must agree on >= 99.99% of covered pixels and depth within
             1e-6 where ids agree; prints mismatch counts and both times.
3. frame   — the north-star frame (10k-instance culled scene, 1080p,
             capacities 2^19, TAA + postprocess) through Renderer for 8
             frames: overflow 0, finite, std > 0.02, and within mean abs
             1e-3 of the same frames with backend="xla"; prints compile
             seconds and median ms/frame of both.
4. oracle  — the deferred, config-1 and raytraced scenes of
             tests/test_oracle.py against the numpy oracle under its budget.

--cards 4 runs only the row-sharded frame (Renderer(mesh=...)) on four
cards at 1920x1088 (135 tile rows of 1080p do not split four ways) against
the same frame on one card.

The last line of stdout is {"ok": true, "device": {...}}.
Usage: python chip_smoke.py [--cards 4]
"""

import argparse
import json
import os
import statistics
import sys

import numpy as np

W, H = 1920, 1080
CAP = 1 << 19
FRAMES = 8


def _log(*a):
    print(*a, flush=True)


def _require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def north_star(width=W, height=H, n_instances=10_000, cap=CAP, **cfg_kw):
    """(world, moving ids, camera, RasterConfig) of bench.py's config 0."""
    import jax

    import bench
    import voidin_tpu as vt
    from voidin_tpu.passes.raster import RasterConfig

    world, moving = bench.build_world(n_instances=n_instances)
    cam = vt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                    aspect=width / height)
    cfg = RasterConfig(width=width, height=height, tri_capacity=cap,
                       pair_capacity=cap,
                       interpret=jax.default_backend() == "cpu", **cfg_kw)
    return world, moving, cam, cfg


def pair_stream(scene, cu, cfg):
    """(setup, (records, starts, counts, overflow)) of the frame's raster
    at camera uniform `cu`: the fine-raster kernel's input."""
    import jax

    from voidin_tpu.passes import cull, raster

    @jax.jit
    def f(scene_, cu_):
        draws = cull.emit_draws(scene_.meshes, scene_.instances, cu_)
        setup = raster.triangle_setup(
            scene_.meshes, scene_.instances, draws, cu_, cfg,
            materials=scene_.materials,
        )
        return setup, raster.bin_triangles_pairs(setup, cfg)

    return f(scene, cu)


def phase_device():
    import jax

    from voidin_tpu.framework.device import gpu_name_power

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX backend is {jax.default_backend()!r}"
        )
    _log(f"device_kind: {jax.devices()[0].device_kind}; "
         f"devices: {len(jax.devices())}")
    cards = gpu_name_power()
    if not cards:
        raise RuntimeError("nvidia-smi reported no card")
    for line in cards:
        _log(line)


def check_triton_call(renderer, cam):
    """The frame's lowered HLO holds the kernel as a compiled Triton call."""
    hlo = renderer.lower(cam).as_text()
    n = hlo.count("__gpu$xla.gpu.triton")
    _log(f"frame HLO: {n} Triton custom call(s)")
    _require(n >= 1 and "fine_raster_pairs" in hlo,
             "the fine-raster kernel is not a compiled Triton call")


def phase_kernel(world, cam, cfg, n_timed=20):
    """Returns the tile_tri_capacity that holds every tile's pairs."""
    import dataclasses
    from functools import partial

    import jax

    from voidin_tpu.framework.device import time_calls
    from voidin_tpu.ops import fine_raster as fr
    from voidin_tpu.passes import raster

    setup, (rec, starts, counts, ovf) = pair_stream(world.device(),
                                                    cam.uniform(), cfg)
    _require(int(setup["setup_overflow"]) == 0 and int(ovf) == 0,
             "the pair stream overflowed")
    max_count = int(counts.max())
    k = max(1, -(-max_count // fr.TRI_GROUP)) * fr.TRI_GROUP
    _log(f"pairs: {int(counts.sum())} live, {int((counts > 0).sum())} "
         f"of {counts.shape[0]} tiles non-empty, max {max_count}/tile "
         f"-> tile_tri_capacity {k}")

    kern = jax.jit(partial(fr.fine_raster_pairs, interpret=cfg.interpret))
    cfg_x = dataclasses.replace(cfg, tile_tri_capacity=k, backend="xla")
    blocks, counts_x, ovf_x = jax.jit(
        partial(raster.bin_triangles, config=cfg_x))(setup)
    _require(int(ovf_x) == 0, "the XLA twin's tile capacity overflowed")
    twin = jax.jit(partial(raster.fine_raster_xla, config=cfg_x))

    k_compile, k_ms = time_calls(lambda: kern(rec, starts, counts), n_timed)
    x_compile, x_ms = time_calls(lambda: twin(blocks, counts_x), n_timed)
    d_k, i_k = (np.asarray(a) for a in kern(rec, starts, counts))
    d_x, i_x = (np.asarray(a) for a in twin(blocks, counts_x))
    covered = (i_k >= 0) | (i_x >= 0)
    agree = covered & (i_k == i_x)
    n_cov, n_mis = int(covered.sum()), int((covered & ~agree).sum())
    ddiff = np.abs(d_k - d_x)[agree]
    n_dbad = int((ddiff > 1e-6).sum())
    _log(f"kernel check: {n_cov} covered px, {n_mis} id mismatches "
         f"({n_mis / max(n_cov, 1):.3e}), {n_dbad} depth diffs > 1e-6 "
         f"(max {float(ddiff.max(initial=0.0)):.3e})")
    _log(f"fine_raster_pairs: compile {k_compile:.2f} s, median "
         f"{statistics.median(k_ms):.4f} ms; fine_raster_xla (K={k}): "
         f"compile {x_compile:.2f} s, median "
         f"{statistics.median(x_ms):.4f} ms")
    _require(n_cov > 0, "nothing covered")
    _require(n_mis <= 1e-4 * n_cov, "per-pixel ids disagree on > 0.01%")
    _require(n_dbad == 0, "depth differs where the ids agree")
    return k


def _frames(renderer, cam):
    """Compile seconds and per-frame ms of FRAMES frames (compile first)."""
    from voidin_tpu.framework.device import time_calls

    return time_calls(lambda: renderer.render(cam, dt=1 / 60), FRAMES - 1)


def phase_frame(world, moving, cam, cfg, k):
    import dataclasses

    from voidin_tpu.framework.renderer import Renderer

    imgs = {}
    for name, c in (("pallas", cfg),
                    ("xla", dataclasses.replace(cfg, tile_tri_capacity=k,
                                                backend="xla"))):
        r = Renderer(world.device(), c, moving_ids=moving)
        compile_s, ms = _frames(r, cam)
        img = np.asarray(r.render(cam, dt=1 / 60))
        overflow = int(r.aux["overflow"])
        _log(f"frame[{name}] {c.width}x{c.height}: compile {compile_s:.2f} s,"
             f" median {statistics.median(ms):.3f} ms/frame over {len(ms)} "
             f"(min {min(ms):.3f}, max {max(ms):.3f}), overflow {overflow}, "
             f"draws {int(r.aux['draw_count'])}, std {img.std():.4f}")
        _require(overflow == 0, f"{name}: overflow {overflow}")
        _require(np.isfinite(img).all(), f"{name}: non-finite image")
        _require(img.std() > 0.02, f"{name}: empty image")
        imgs[name] = img
        del r
    d = np.abs(imgs["pallas"] - imgs["xla"])
    _log(f"frame pallas vs xla: mean abs {d.mean():.3e}, max {d.max():.3e}")
    _require(d.mean() < 1e-3, "pallas and xla frames differ")


def phase_oracle():
    from tests import test_oracle as to

    for name, case in (("deferred", to.case_deferred),
                       ("config1", to.case_config1),
                       ("raytraced", to.case_raytraced)):
        prod, oracle = case()[:2]
        rep = to._diff_report(prod, oracle)
        _log(f"oracle[{name}]: {rep}")
        to._assert_anchored(prod, oracle, name=name)


def phase_sharded(n_cards, world, moving, cam, cfg):
    """The row-sharded frame on `n_cards` cards against one card."""
    from voidin_tpu.framework.renderer import Renderer
    from voidin_tpu.parallel.sharding import make_mesh

    imgs = {}
    for name, mesh in (("1 card", None), (f"{n_cards} cards",
                                          make_mesh(n_cards))):
        r = Renderer(world.device(), cfg, moving_ids=moving, mesh=mesh)
        compile_s, ms = _frames(r, cam)
        img = np.asarray(r.render(cam, dt=1 / 60))
        overflow = int(r.aux["overflow"])
        _log(f"frame[{name}] {cfg.width}x{cfg.height}: compile "
             f"{compile_s:.2f} s, median {statistics.median(ms):.3f} "
             f"ms/frame, overflow {overflow}, std {img.std():.4f}")
        _require(overflow == 0 and np.isfinite(img).all()
                 and img.std() > 0.02, f"{name}: bad frame")
        imgs[name] = img
        del r
    a, b = imgs.values()
    d = np.abs(a - b).max(axis=-1)
    n_px, n_diff = d.size, int((d > 1e-6).sum())
    _log(f"sharded vs single card: {n_diff} of {n_px} px differ by > 1e-6 "
         f"({int((d > 1e-4).sum())} by > 1e-4, {int((d > 1e-2).sum())} by "
         f"> 1e-2; max {d.max():.3e}, mean {d.mean():.3e})")
    _require(n_diff <= 1e-4 * n_px, "sharded frame differs from one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the row-sharded frame on four cards")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "voidin_tpu")):
        raise SystemExit("chip_smoke.py runs from the root of a checkout")

    import jax

    phase_device()  # fails before anything else without a GPU
    if len(jax.devices()) < args.cards:
        raise SystemExit(f"--cards {args.cards}: JAX sees "
                         f"{len(jax.devices())} device(s)")
    from voidin_tpu.framework.device import enable_compile_cache

    enable_compile_cache()
    if args.cards > 1:
        world, moving, cam, cfg = north_star(height=1088)
        _log("sharded frame at 1920x1088: 1080p's 135 tile rows do not "
             f"split over {args.cards} cards")
        phase_sharded(args.cards, world, moving, cam, cfg)
    else:
        from voidin_tpu.framework.renderer import Renderer

        world, moving, cam, cfg = north_star()
        check_triton_call(Renderer(world.device(), cfg, moving_ids=moving),
                          cam)
        k = phase_kernel(world, cam, cfg)
        phase_frame(world, moving, cam, cfg, k)
        phase_oracle()
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
