#!/usr/bin/env python
"""A/B the perf-option variants of bench.AB_VARIANTS on the north-star
frame and write AB_OPTIONS.json, stamped with the device kind and the
variant definitions; bench.tuned_options applies the fastest variant only
on the same device kind and definition.

Each variant is timed by driving the PRODUCTION `Renderer.render` loop —
the same jitted program, output pytree and donation bench.py times — as
the median of --frames frames ended by block_until_ready, compile apart.

Usage: python -u tools/ab_options.py [--only base,slim_p] [--smoke]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--only",
        default="",
        help="comma-separated variant subset (e.g. base,all_lut_p,slim_p); "
        "the incremental writer + definition stamp make a subset capture "
        "valid for bench.tuned_options (it takes the min over measured "
        "entries)",
    )
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument(
        "--smoke", action="store_true",
        help="tiny-scale CPU wiring check (320x184, 300 instances) — "
        "drives the exact sweep loop in minutes; NEVER writes AB_OPTIONS",
    )
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "AB_OPTIONS.json",
        ),
    )
    args = ap.parse_args()

    import statistics

    import jax

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    import voidin_tpu as vt
    from bench import build_world
    from voidin_tpu.framework.device import (
        enable_compile_cache, require_accelerator, time_calls,
    )
    from voidin_tpu.framework.renderer import Renderer
    from voidin_tpu.passes import shading
    from voidin_tpu.passes.raster import RasterConfig

    if not args.smoke:
        require_accelerator("ab_options")
    enable_compile_cache()
    kind = jax.devices()[0].device_kind
    world, moving = build_world(n_instances=300 if args.smoke else 10_000)
    scene = world.device()
    if args.smoke:
        cfg0 = RasterConfig(
            width=320, height=184, tri_capacity=1 << 14,
            pair_capacity=1 << 14, tile_tri_capacity=128,
            quad_edge_capacity=1 << 10, taa_edge_capacity=1 << 10,
            tap_edge_capacity=1 << 10, interpret=True,
        )
        args.out = None  # a wiring check never writes a sweep
    else:
        cfg0 = RasterConfig(
            width=1920, height=1080, tri_capacity=1 << 19,
            pair_capacity=1 << 19, tile_tri_capacity=128,
            quad_edge_capacity=1 << 15, taa_edge_capacity=1 << 12,
            tap_edge_capacity=1 << 15,
        )
    cam = vt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                    aspect=cfg0.width / cfg0.height)

    # Single source of truth: bench.AB_VARIANTS (bench.tuned_options applies
    # the winner this sweep finds).
    from bench import AB_VARIANTS, apply_ab_runtime_options

    variants = [(name, *opts) for name, opts in AB_VARIANTS.items()]
    if args.only:
        keep = [s.strip() for s in args.only.split(",") if s.strip()]
        unknown = [k for k in keep if k not in AB_VARIANTS]
        if unknown:
            raise SystemExit(f"unknown variants: {unknown}")
        variants = [v for v in variants if v[0] in keep]
    print(f"device_kind={kind}")
    results = {}
    for name, cfg_kw, bf16, ascale in variants:
        cfg = dataclasses.replace(cfg0, **cfg_kw)
        apply_ab_runtime_options(bf16, ascale)
        try:
            # the PRODUCTION program: Renderer.render's jitted frame with
            # the slimmed output pytree + donation — identical to what
            # bench.py times for the official number
            r = Renderer(scene, cfg, moving_ids=moving,
                         area_light_scale=ascale)

            _, ms_all = time_calls(lambda: r.render(cam, dt=1 / 60),
                                   args.frames)
            ms = statistics.median(ms_all)
        except Exception as e:  # a variant that fails to compile must not
            # kill the rest of the sweep; tuned_options ignores non-numeric
            # entries
            print(f"{name:12s} FAILED: {str(e)[:160]}", flush=True)
            results[name] = f"error: {str(e)[:200]}"
            _write(args.out, kind, results)
            continue
        finally:
            shading.LTC_LUT_BF16 = False
        results[name] = ms
        base_ms = results.get("base")
        if isinstance(base_ms, (int, float)) and name != "base":
            print(f"{name:12s} {ms:8.2f} ms   ({ms - base_ms:+6.2f} vs base)",
                  flush=True)
        else:
            print(f"{name:12s} {ms:8.2f} ms", flush=True)
        _write(args.out, kind, results)  # incremental: a timeout mid-
        # sweep keeps every variant measured so far


def _write(path, device_kind, results):
    import json

    from bench import ab_variants_stamp
    from voidin_tpu.framework.device import device_stamp

    if path is None:
        return
    with open(path, "w") as f:
        json.dump(
            {
                "device_kind": device_kind,
                "device": device_stamp(),
                "scene": "north-star 10k instances 1080p",
                "method": "production Renderer.render, median ms/frame "
                          "(block_until_ready)",
                # definition stamp: bench.tuned_options refuses captures
                # whose variant definitions differ from the current build
                "variants": ab_variants_stamp(),
                "ms_per_variant": results,
            },
            f,
            indent=2,
        )


if __name__ == "__main__":
    main()
