"""Every f32 contraction on the frame path asks for Precision.HIGHEST.

On a GPU an f32 matrix product without a precision may run in TF32 (about
three decimal digits): enough to move vertices and reverse-Z depth, and to
break the one-hot selects that claim to be bit-exact. These tests read the
jaxprs, so they hold on any backend.
"""

from functools import partial

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from voidin_tpu.core import fastmath

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """All dot_general equations of a closed jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dots(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dots(sub)
    return out


def _f32_dots_below_highest(closed):
    bad = []
    for eqn in _dots(closed.jaxpr):
        if all(v.aval.dtype != jnp.float32 for v in eqn.invars):
            continue  # explicit low-precision operands (bf16/f16 paths)
        prec = eqn.params["precision"]
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        if any(p != HIGHEST for p in precs):
            bad.append(str(eqn)[:160])
    return bad


@pytest.mark.parametrize("name", ["compose_mat4", "upsample_bilinear_mm",
                                  "subsample_mm"])
def test_fastmath_products_are_highest(name):
    x = jnp.ones((6, 10, 3), jnp.float32)
    fn, args = {
        "compose_mat4": (fastmath.compose_mat4,
                         (jnp.eye(4), jnp.ones((5, 4, 4), jnp.float32))),
        "upsample_bilinear_mm": (
            partial(fastmath.upsample_bilinear_mm, s=2, h_out=12, w_out=20),
            (x,)),
        "subsample_mm": (partial(fastmath.subsample_mm, s=2), (x,)),
    }[name]
    closed = jax.make_jaxpr(fn)(*args)
    assert _dots(closed.jaxpr), "expected a real matrix product"
    assert _f32_dots_below_highest(closed) == []


def test_compose_mat4_matches_float64():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b = rng.normal(size=(7, 4, 4)).astype(np.float32)
    got = np.asarray(fastmath.compose_mat4(jnp.asarray(a), jnp.asarray(b)))
    want = np.einsum("ij,njk->nik", a.astype(np.float64), b)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("options", [
    dict(),
    dict(area_light_scale=2),
    dict(config=dict(slot_resolve=True, taa_quad_history=True,
                     tap_block=True)),
])
def test_frame_has_no_default_precision_f32_dots(options):
    """The whole north-star-style frame (tiny scale): no f32 dot_general
    anywhere in it runs below Precision.HIGHEST."""
    import dataclasses

    import __graft_entry__ as ge
    from voidin_tpu.framework.renderer import render_frame

    _, cfg, args = ge._tiny_setup()
    cfg = dataclasses.replace(cfg, **options.get("config", {}))
    fn = partial(render_frame, config=cfg,
                 area_light_scale=options.get("area_light_scale", 1))
    closed = jax.make_jaxpr(fn)(*args)
    assert len(_dots(closed.jaxpr)) >= 2  # MVP + view_proj at least
    assert _f32_dots_below_highest(closed) == []
