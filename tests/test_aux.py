"""Aux framework components: input map, pipeline hot-reload, HUD, blit."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from voidin_tpu.framework.input import (
    CameraController,
    Input,
    KeyboardMap,
    default_keymap,
)
from voidin_tpu.framework.pipeline import PipelineCache
from voidin_tpu.passes.blit import downsample2x, generate_mipmaps, present
from voidin_tpu.passes.hud import draw_hud, text_bitmap


def test_input_just_pressed_edges():
    inp = Input()
    inp.press("w")
    assert inp.was_just_pressed("w")
    inp.tick()
    assert inp.is_held("w") and not inp.was_just_pressed("w")
    inp.release("w")
    assert not inp.is_held("w")


def test_keymap_accumulation_and_clamp():
    m = KeyboardMap().bind("w", "fwd", 1.0).bind("s", "fwd", -1.0).bind(
        "x", "fwd", 5.0
    )
    inp = Input()
    inp.press("w")
    inp.press("x")
    acts = m.map(inp)
    assert acts["fwd"] == 1.0  # clamped from 6


def test_camera_controller_moves():
    import voidin_tpu as vt

    cam = vt.Camera(position=[0, 0, 0], yaw=0.0, pitch=0.0)
    ctl = CameraController(cam, speed=2.0)
    inp = Input()
    inp.press("w")
    acts = default_keymap().map(inp)
    ctl.update(acts, inp, dt=0.5)
    assert cam.position[2] < -0.5  # moved forward (-z)


def test_pipeline_cache_reload_keeps_good_version():
    cache = PipelineCache()
    state = {"v": 1}

    def build():
        v = state["v"]
        if v == 99:
            raise RuntimeError("bad shader")
        return lambda x: x * v

    f = cache.register("scale", build)
    assert float(f(jnp.float32(2.0))) == 2.0
    state["v"] = 3
    assert cache.reload("scale")
    assert float(f(jnp.float32(2.0))) == 6.0
    state["v"] = 99
    assert not cache.reload("scale")  # failed reload
    assert float(f(jnp.float32(2.0))) == 6.0  # previous version kept


def test_hud_draws_text():
    img = jnp.zeros((64, 128, 3), jnp.float32)
    out = draw_hud(img, "fps: 60.0")
    assert float(out.max()) > 0.5
    assert text_bitmap("123").shape[0] == 10  # 5 rows * scale 2


def test_blit_mips_and_present():
    img = jnp.ones((32, 32, 3), jnp.float32) * 0.5
    mips = generate_mipmaps(img)
    assert mips[-1].shape[0] == 1
    np.testing.assert_allclose(np.asarray(downsample2x(img))[0, 0], 0.5, atol=1e-6)
    u8 = present(img, srgb=True, to_uint8=True)
    assert u8.dtype == jnp.uint8 and int(u8[0, 0, 0]) == 188  # srgb(0.5)*255


def test_ltc_polygon_annulus():
    """Annulus (outer - inner) irradiance is positive and less than the
    full outer disk; polygon evaluator agrees with evaluate_rect on a quad."""
    import voidin_tpu as vt
    from voidin_tpu.passes import shading

    w = vt.World()
    scene = w.device()
    nor = jnp.array([[[0.0, 1.0, 0.0]]])
    view = jnp.array([[[0.0, 0.7071, 0.7071]]])
    pos = jnp.array([[[0.0, 0.0, 0.0]]])
    ident = jnp.broadcast_to(jnp.eye(3), (1, 1, 3, 3))

    outer = jnp.asarray(shading.ring_points([0, 3, 0], [0, 1, 0], 2.0, 16))
    inner = jnp.asarray(shading.ring_points([0, 3, 0], [0, 1, 0], 1.0, 16))
    d_out = shading.ltc_evaluate_polygon(scene, nor, view, pos, ident, outer)
    d_in = shading.ltc_evaluate_polygon(scene, nor, view, pos, ident, inner)
    assert float(d_out[0, 0]) > float(d_in[0, 0]) > 0.0

    # quad through the polygon evaluator == evaluate_rect
    pts = jnp.array([[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]], jnp.float32)
    a = shading.ltc_evaluate_polygon(scene, nor, view, pos, ident, pts)
    b = shading.ltc_evaluate_rect(scene, nor, view, pos, ident, pts)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)


def _bench():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    return bench


def _sweep(path, device_kind, variants, ms):
    import json

    with open(path, "w") as f:
        json.dump({"device_kind": device_kind, "variants": variants,
                   "ms_per_variant": ms}, f)


def test_bench_tuned_options(tmp_path):
    """bench.tuned_options picks the fastest A/B variant of a sweep
    measured on THIS device kind. Missing/stale/malformed captures fall
    back to 'base' — the RasterConfig defaults."""
    import json

    bench = _bench()
    kind = "NVIDIA H100 80GB HBM3"
    p = str(tmp_path / "AB_OPTIONS.json")
    # no file -> base
    assert bench.tuned_options(p, device_kind=kind)[0] == "base"
    assert bench.AB_VARIANTS["base"] == (dict(), False, 1)
    # capture without a matching variant-definition stamp -> base
    # (a capture from an older build measured different semantics)
    _sweep(p, kind, None, {"base": 10, "all": 5.5})
    assert bench.tuned_options(p, device_kind=kind)[0] == "base"
    # a variant whose DEFINITION changed since the capture is invalidated
    # individually: its (stale) 5.5 ms may not steer, but the still-valid
    # 'fused_rec' entry does — the sweep survives an edit to one variant
    stale = json.loads(json.dumps(bench.ab_variants_stamp()))
    stale["all"][1] = not stale["all"][1]
    _sweep(p, kind, stale, {"base": 10, "fused_rec": 9, "all": 5.5})
    assert bench.tuned_options(p, device_kind=kind)[0] == "fused_rec"
    # a capture taken before a NEW variant was added stays valid for the
    # variants it measured (additive edits don't discard the sweep)
    subset = json.loads(json.dumps(bench.ab_variants_stamp()))
    subset.pop("fused_rec")
    _sweep(p, kind, subset, {"base": 10, "all": 5.5})
    assert bench.tuned_options(p, device_kind=kind)[0] == "all"
    # current stamp -> fastest variant wins
    _sweep(p, kind, bench.ab_variants_stamp(),
           {"base": 10, "fused_rec": 8, "all": 5.5})
    name, opts, swept = bench.tuned_options(p, with_meta=True,
                                            device_kind=kind)
    assert name == "all" and opts == bench.AB_VARIANTS["all"] and swept
    # malformed -> base
    with open(p, "w") as f:
        f.write("not json")
    assert bench.tuned_options(p, device_kind=kind)[0] == "base"


@pytest.mark.parametrize("stamped", [None, "cpu", "NVIDIA H200",
                                     "NVIDIA A100-SXM4-80GB"])
def test_bench_tuned_options_refuses_other_device_kind(tmp_path, stamped):
    """A sweep stamped with another device_kind (or none) never steers the
    run, however fast its variants measured there."""
    bench = _bench()
    p = str(tmp_path / "AB_OPTIONS.json")
    _sweep(p, stamped, bench.ab_variants_stamp(),
           {"base": 10, "all": 1.0})
    name, opts, swept = bench.tuned_options(
        p, with_meta=True, device_kind="NVIDIA H100 80GB HBM3"
    )
    assert (name, opts, swept) == ("base", bench.AB_VARIANTS["base"], False)
