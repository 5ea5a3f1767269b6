"""Pallas (Triton route) kernel: tile-local visibility-buffer fine raster.

Replaces the reference's hardware raster (multi_draw_indexed_indirect +
shaders/visibility.wgsl) with a software design. Triangle records carry
PRECOMPUTED AFFINE COEFFICIENTS — for each edge function and for the depth
plane, (ax, ay, b) with e(p) = ax*px + ay*py + b — instead of vertex
positions, so a record costs three multiply-adds per quantity per pixel.

Precision: coefficients are derived in a per-triangle anchor frame (bbox
corner) and re-based to each tile's origin at binning time ("baking"), so
products stay at triangle/tile magnitude — the naive screen-space affine
form loses ~0.25 absolute in e at 1080p magnitudes and corrupts
small-triangle rasterization.

Work decomposition: one program per 8x16 screen tile. The program reads
its own range [starts[t], starts[t] + counts[t]) of the tile-sorted record
stream and walks it in chunks of `chunk` records with masked loads. Each
chunk is evaluated against the tile's 128 pixels as (chunk, 128) f32
multiply-adds on the CUDA cores (an affine function with three terms has
no useful tensor-core form, and TF32 would break the `e >= 0` tests), then
max-reduced over the chunk axis; the running (depth, id) — and (depth2,
id2) with `track2` — stay in registers and are stored once. Cost scales
with live pairs, not with a per-tile capacity.

Record fields (RECORD_F = 16 f32 = one 64 B row, read as is):
  0..8  edge coefficients   [ax0 ay0 b0  ax1 ay1 b1  ax2 ay2 b2]
  9..11 depth coefficients  [axd ayd bd]
  12    triangle id as f32 (-1 = invalid)
  13,14 anchor (x, y) — consumed by the binning bake, pad afterwards
  15    max vertex z (sliver clamp)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

RECORD_F = 16
F_E = 0  # 9 edge coefficients
F_D = 9  # 3 depth coefficients
F_ID = 12
F_ANCHOR = 13  # anchor x, y
F_ZMAX = 15  # max vertex z: clamps the affine depth (sliver guard)

TILE_H = 8
TILE_W = 16
TILE_PX = TILE_H * TILE_W  # 128 pixels per tile
TRI_GROUP = 8  # record group of the XLA twin (passes/raster.fine_raster_xla)

# Records per loop step, and warps per program: chunks of 16/32/64 records
# with 2/4/8 warps all ran in 0.38-0.61 ms on the north-star pair stream
# (H100 SXM, 700 W); 32 x 8 was within 4% of the fastest (PERF.md).
CHUNK = 32
NUM_WARPS = 8


def _kernel(starts_ref, counts_ref, rec_ref, depth_ref, id_ref, *rest,
            chunk, track2):
    t = pl.program_id(0)
    start = starts_ref[t]
    count = counts_ref[t]
    lane = jnp.arange(TILE_PX, dtype=jnp.int32)
    px = ((lane % TILE_W).astype(jnp.float32) + 0.5)[None, :]  # (1, 128)
    py = ((lane // TILE_W).astype(jnp.float32) + 0.5)[None, :]
    row = jnp.arange(chunk, dtype=jnp.int32)

    def body(c, carry):
        live = row < count - c * chunk  # (chunk,) records of THIS tile
        rows = pl.ds(start + c * chunk, chunk)

        def col(f):  # (chunk, 1): field f of the chunk's records
            v = plt.load(rec_ref.at[rows, f], mask=live, other=0.0)
            return v[:, None]

        def plane(f):  # (chunk, 128) affine function of fields f..f+2
            return col(f) * px + col(f + 1) * py + col(f + 2)

        inside = (
            (plane(F_E) >= 0.0) & (plane(F_E + 3) >= 0.0)
            & (plane(F_E + 6) >= 0.0) & live[:, None]
        )
        idt = col(F_ID)
        # clamp: precomputed 1/area2 loses the per-pixel form's convexity;
        # a sliver's amplified depth must not steal pixels in front of its
        # own true depth range
        cand = jnp.where(inside, jnp.minimum(plane(F_D), col(F_ZMAX)), -1.0)
        gmax = jnp.max(cand, axis=0)  # (128,)
        top = cand == gmax[None, :]
        gid = jnp.max(jnp.where(top, idt, -1.0), axis=0)
        bd, bi = carry[0], carry[1]
        take = gmax > bd
        nbd = jnp.where(take, gmax, bd)
        nbi = jnp.where(take, gid, bi)
        if not track2:
            return nbd, nbi
        bd2, bi2 = carry[2], carry[3]
        # Runner-up among DISTINCT triangles: within-chunk 2nd place (mask
        # the argmax rows), then a sorted-pair merge with the running
        # (best, second). Deliberate: ALL records at the winner's depth are
        # masked, not just the winner's id. An id-aware tie-break is WRONG
        # for the dominant tie source — a quad's own two triangles meet
        # along the diagonal at bit-equal depth, and the surviving twin is
        # cut at the same texel, exhausting the single fallback level and
        # leaking background. Collapsing ties instead falls through to the
        # geometry BEHIND the quad (correct); the cost is the pathological
        # coplanar-duplicate-cutout case, documented.
        c2 = jnp.where(top, -1.0, cand)
        g2 = jnp.max(c2, axis=0)
        g2id = jnp.max(jnp.where(c2 == g2[None, :], idt, -1.0), axis=0)
        g2id = jnp.where(g2 > 0.0, g2id, -1.0)
        # Demoted best for the cross-chunk merge. When the chunk's winner
        # bit-equals the running best (take is False, gmax == bd) it is a
        # TIE of the overall winner — e.g. a quad's twin landing in a
        # different chunk — and must be collapsed exactly like the
        # within-chunk ties above, not tracked as runner-up.
        lv = jnp.where(take, bd, jnp.where(gmax == bd, -1.0, gmax))
        li = jnp.where(take, bi, gid)
        t2 = g2 > bd2
        m2v = jnp.where(t2, g2, bd2)
        m2i = jnp.where(t2, g2id, bi2)
        t3 = lv > m2v
        return nbd, nbi, jnp.where(t3, lv, m2v), jnp.where(t3, li, m2i)

    zeros = jnp.zeros((TILE_PX,), jnp.float32)
    negs = jnp.full((TILE_PX,), -1.0, jnp.float32)
    init = (zeros, negs, zeros, negs) if track2 else (zeros, negs)
    n_chunks = (count + chunk - 1) // chunk
    out = jax.lax.fori_loop(0, n_chunks, body, init)
    for ref, v in zip((depth_ref, id_ref) + tuple(rest), out):
        ref[...] = v


def fine_raster_pairs(
    records_sorted: jnp.ndarray,  # (E, RECORD_F) f32, tile-sorted, with b
    # coefficients already baked to each pair's tile origin
    starts: jnp.ndarray,  # (NT,) i32 first pair slot per tile
    counts: jnp.ndarray,  # (NT,) i32 pairs per tile (uncapped)
    interpret: bool = False,
    track2: bool = False,
    chunk: int = CHUNK,
    num_warps: int = NUM_WARPS,
):
    """Returns (depth, id) (NT, TILE_PX) f32 each; with `track2` also the
    per-pixel runner-up (depth2, id2) for the alpha-cutoff fallback.

    `interpret=True` runs the kernel on the CPU (tests)."""
    nt = starts.shape[0]
    assert records_sorted.shape[1] == RECORD_F
    assert chunk & (chunk - 1) == 0, "Triton blocks are powers of two"
    if interpret:
        # The interpreter slices with lax.dynamic_slice, which clamps a
        # window that runs past the end instead of masking it; the compiled
        # kernel never dereferences masked rows, so only it skips the pad.
        records_sorted = jnp.pad(records_sorted, ((0, chunk), (0, 0)))
    n_out = 4 if track2 else 2
    out_spec = pl.BlockSpec((None, TILE_PX), lambda t: (t, 0))
    outs = pl.pallas_call(
        functools.partial(_kernel, chunk=chunk, track2=track2),
        grid=(nt,),
        out_specs=[out_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((nt, TILE_PX), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="fine_raster_pairs",
    )(starts, counts, records_sorted)
    return tuple(outs)
