"""Temporal anti-aliasing: depth-dilated reprojection + variance-clamped
history resolve.

Per-pixel ports of shaders/reproject.wgsl:14-38 and shaders/taa.wgsl:45-103
with identical constants: 3x3 max-depth dilation, velocity =
(curr_ndc + jitter) - (prev_ndc + prev_jitter), YCbCr Gaussian-weighted 3x3
moments (w = exp(-3 d^2 / (k+1)^2)), Mitchell-Netravali(B=C=1/3) filtered
center, adaptive box from local contrast + texel-center distance, mu +/-
1.5 sigma clamp, blend 1 -> 1/12 by velocity validity widened by clamp
distance.

Functional state: the history ping-pong becomes (history in) -> (history
out); the reference's AtomicU8 texture flip (taa.rs:311-318) disappears.
Deviation: a `history_valid` flag seeds history with the current frame on
frame 0 instead of converging from black (the reference starts from a
zeroed texture).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import fastmath
from ..core.color import rgb_to_ycbcr, ycbcr_to_rgb
from .shading import world_position_from_depth


def _shift(img, dy, dx):
    H, W = img.shape[:2]
    ys = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    xs = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    return img[ys][:, xs]


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _mitchell_weight_np(x: float) -> float:
    """Scalar Mitchell-Netravali weight (host-side constant)."""
    import numpy as np

    B = C = 1.0 / 3.0
    ax = abs(float(x))
    if ax < 1.0:
        return (
            (12 - 9 * B - 6 * C) * ax**3
            + (-18 + 12 * B + 6 * C) * ax**2
            + (6 - 2 * B)
        ) / 6.0
    if ax < 2.0:
        return (
            (-B - 6 * C) * ax**3
            + (6 * B + 30 * C) * ax**2
            + (-12 * B - 48 * C) * ax
            + (8 * B + 24 * C)
        ) / 6.0
    return 0.0


def _mitchell_netravali(x):
    B = C = 1.0 / 3.0
    ax = jnp.abs(x)
    p1 = (
        (12.0 - 9.0 * B - 6.0 * C) * ax**3
        + (-18.0 + 12.0 * B + 6.0 * C) * ax**2
        + (6.0 - 2.0 * B)
    ) / 6.0
    p2 = (
        (-B - 6.0 * C) * ax**3
        + (6.0 * B + 30.0 * C) * ax**2
        + (-12.0 * B - 48.0 * C) * ax
        + (8.0 * B + 24.0 * C)
    ) / 6.0
    return jnp.where(ax < 1.0, p1, jnp.where(ax < 2.0, p2, 0.0))


def _bilinear_clamp(img, u, v):
    """Bilinear sample of (H, W, C) at normalized uv (clamp-to-edge).

    The 2x2 neighborhood is packed densely into one row per texel first
    (four shifted copies — cheap dense work), so the per-pixel fetch is ONE
    flat gather instead of four two-axis gathers."""
    H, W = img.shape[:2]
    C = img.shape[2]
    xn = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    yn = jnp.concatenate([img[1:], img[-1:]], axis=0)
    xyn = jnp.concatenate([xn[1:], xn[-1:]], axis=0)
    # f16 halves the gathered table (gather cost scales with table bytes);
    # history is tonemapped-range color, f16 is ample for the TAA blend.
    quads = (
        jnp.concatenate([img, xn, yn, xyn], axis=-1)
        .astype(jnp.float16)
        .reshape(H * W, 4 * C)
    )
    # Force materialization: otherwise XLA fuses the shifted copies INTO the
    # gather and recomputes them per sample (measured 60 ms vs 10).
    quads = jax.lax.optimization_barrier(quads)

    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    q = quads[y0i * W + x0i].astype(jnp.float32)
    c00, c10, c01, c11 = q[..., :C], q[..., C : 2 * C], q[..., 2 * C : 3 * C], q[..., 3 * C :]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def _bilinear_clamp_quadblock(img, u, v, capacity=0, select="einsum"):
    """Coherence-aware twin of _bilinear_clamp: the reprojected history
    coordinates of a 2x2 output quad land within ~1 texel of each other
    (d hist_x / dx ~= 1), so ONE 4x4-texel block row (16 texels x 3ch f16
    = 96 B, still the flat gather tier) serves all four pixels' bilinear
    quads; quads whose floor coords spread wider than the block (velocity
    edges) go through a compacted per-pixel batch on the regular quad
    table. Bit-identical to _bilinear_clamp: the same texels feed the
    same lerp (the in-block 9-way select is VPU work).

    Returns (samples (H, W, C), edge-overflow count)."""
    H, W = img.shape[:2]
    C = img.shape[2]
    Hq, Wq = H // 2, W // 2
    imgh = img.astype(jnp.float16)

    # (H*W, 16*C) f16 4x4 blocks, clamp-replicated like the 2x2 table.
    # Built as 16 STATIC slices of one edge-padded array — the previous
    # chained-concat shifts materialized O(16^2/2) intermediate copies
    # (~600 MB of HBM traffic at 1080p); one pad + slices is a single
    # write of the table. Values identical (same clamp-to-edge texels).
    # Materialize via optimization_barrier (same lesson as _bilinear_clamp:
    # XLA otherwise recomputes the shifts inside the gather).
    padded = jnp.concatenate([imgh, imgh[-1:], imgh[-1:], imgh[-1:]], axis=0)
    padded = jnp.concatenate(
        [padded, padded[:, -1:], padded[:, -1:], padded[:, -1:]], axis=1
    )
    blocks = jnp.concatenate(
        [padded[dy : dy + H, dx : dx + W] for dy in range(4)
         for dx in range(4)],
        axis=-1,
    ).reshape(H * W, 16 * C)
    blocks = jax.lax.optimization_barrier(blocks)

    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)

    def q4(a):  # (H, W) -> (Hq, Wq, 2, 2)
        return a.reshape(Hq, 2, Wq, 2).transpose(0, 2, 1, 3)

    x4, y4 = q4(x0i), q4(y0i)
    bx = jnp.min(x4, axis=(2, 3))  # (Hq, Wq) block origin
    by = jnp.min(y4, axis=(2, 3))
    ok = (jnp.max(x4, axis=(2, 3)) - bx <= 2) & (
        jnp.max(y4, axis=(2, 3)) - by <= 2
    )

    blk = blocks[by * W + bx].reshape(Hq, Wq, 4, 4, C)  # f16 (Hq,Wq,4,4,C)

    # per-pixel in-block offsets (0..2 when ok); gather-free select
    ox = jnp.clip(x4 - bx[..., None, None], 0, 2)  # (Hq, Wq, 2, 2)
    oy = jnp.clip(y4 - by[..., None, None], 0, 2)

    def unq(a):  # (Hq, Wq, 2, 2, C) -> (H, W, C)
        return a.transpose(0, 2, 1, 3, 4).reshape(H, W, C)

    if select == "where":
        # separable where-chains on the f16 block: select the column by
        # ox (3 candidates), then the row by oy. Pure fused VPU selects —
        # the einsum variant's one-hot contraction lane-pads tiny (4, 4)
        # contractions onto the MXU at quad rate and measured ~125 ms at
        # 1080p (tools/r5_taa_fetch_ab.py); these chains are the same
        # f16 values through jnp.where, so the result is bit-identical.
        bq = blk[:, :, None, None]  # (Hq, Wq, 1, 1, 4, 4, C)
        oxm = [(ox == j)[..., None] for j in (1, 2)]
        corner = {}
        for e in (0, 1):
            cols = []
            for k in range(4):
                col = bq[..., k, e, :]
                for j in (1, 2):
                    col = jnp.where(oxm[j - 1], bq[..., k, j + e, :], col)
                cols.append(col)  # (Hq, Wq, 2, 2, C) f16
            oym = [(oy == i)[..., None] for i in (1, 2)]
            for d in (0, 1):
                row = cols[d]
                for i in (1, 2):
                    row = jnp.where(oym[i - 1], cols[i + d], row)
                corner[(d, e)] = row.astype(jnp.float32)
        c00 = unq(corner[(0, 0)])
        c10 = unq(corner[(0, 1)])
        c01 = unq(corner[(1, 0)])
        c11 = unq(corner[(1, 1)])
    else:
        # ONE einsum over the full 4x4 block with per-corner shifted
        # one-hots (d, e index the bilinear corner) instead of four
        # einsums over f32 3x3 sub-slices: the f16 table is read once and
        # never upcast as a whole (f32 blk alone was ~400 MB at 1080p).
        # Exact: one-hot weights are 0/1, products/accumulation select a
        # single f16 value into f32 — bit-identical to upcasting first
        # (test_taa_quad.py holds the path to _bilinear_clamp
        # bit-equality).
        j4 = jnp.arange(4)
        oh_y = (oy[..., None, None] + jnp.arange(2)[:, None] == j4).astype(
            jnp.float16
        )  # (Hq, Wq, 2, 2, d, j)
        oh_x = (ox[..., None, None] + jnp.arange(2)[:, None] == j4).astype(
            jnp.float16
        )  # (Hq, Wq, 2, 2, e, i)
        corners = jnp.einsum(
            "hwjic,hwpqdj,hwpqei->hwpqdec", blk, oh_y, oh_x,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (Hq, Wq, 2, 2, 2, 2, C) f32
        c00 = unq(corners[..., 0, 0, :])
        c10 = unq(corners[..., 0, 1, :])
        c01 = unq(corners[..., 1, 0, :])
        c11 = unq(corners[..., 1, 1, :])
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    out = top + (bot - top) * ty

    # edge quads: per-pixel fetch, scattered back — identical machinery to
    # resolve._quad_fetch. The pixel's 2x2 bilinear quad is the (0..1,
    # 0..1) corner of ITS OWN 4x4 block row, so the edge path reuses the
    # block table instead of building a second (H*W, 4C) quad table.
    F = capacity or max(Hq * Wq // 4, 1024)
    flat = (~ok).reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    qidx = fastmath.compact_indices(flat, F)
    valid = jnp.arange(F) < jnp.minimum(count, F)
    qy = qidx // Wq
    qx = qidx - qy * Wq
    py = jnp.concatenate([qy * 2, qy * 2, qy * 2 + 1, qy * 2 + 1])
    px = jnp.concatenate([qx * 2, qx * 2 + 1, qx * 2, qx * 2 + 1])
    pix = py * W + px  # (4F,)
    xe = x0i.reshape(-1)[pix]
    ye = y0i.reshape(-1)[pix]
    qe = blocks[ye * W + xe].astype(jnp.float32)  # (4F, 16C)
    txe = tx.reshape(-1, 1)[pix]
    tye = ty.reshape(-1, 1)[pix]
    # block texel (dy, dx) lives at columns (dy*4 + dx)*C
    e00, e10 = qe[..., 0:C], qe[..., C : 2 * C]
    e01, e11 = qe[..., 4 * C : 5 * C], qe[..., 5 * C : 6 * C]
    tope = e00 + (e10 - e00) * txe
    bote = e01 + (e11 - e01) * txe
    vals = tope + (bote - tope) * tye
    widx = jnp.where(jnp.concatenate([valid] * 4), pix, H * W)
    out = (
        out.reshape(H * W, C).at[widx].set(vals, mode="drop")
        .reshape(H, W, C)
    )
    return out, jnp.maximum(count - F, 0)


def _bilinear_clamp_inwindow(img, u, v, capacity=0):
    """Gather-free twin of _bilinear_clamp for NEAR-STATIC pixels.

    The history coordinate of a pixel moves by (velocity + jitter-delta);
    for everything except fast-moving geometry that is well under 2
    texels, so the pixel's 2x2 bilinear corner quad lives inside its OWN
    5x5 neighborhood. Those corners are picked with dense `where` chains
    over 25 statically shifted copies (pure VPU work; XLA fuses the whole
    select into one elementwise loop) — ZERO gather rows. Pixels whose
    corner quad escapes the window (fast movers; measured ~1-2% at the
    north-star pose, tools/r5_taa_fetch_ab.py) fall back to the quad-table
    gather at 8x8-BLOCK granularity through a compacted, capacity-padded
    batch.

    BIT-IDENTICAL to _bilinear_clamp: both paths read the same
    f16-quantized texels and run the same f32 lerp; the fallback gathers
    the same packed quad rows. Returns (samples, block-overflow count).
    """
    H, W = img.shape[:2]
    C = img.shape[2]
    if H % 8 or W % 8:
        return _bilinear_clamp(img, u, v), jnp.zeros((), jnp.int32)
    imgh = img.astype(jnp.float16)

    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)

    px = jnp.arange(W, dtype=jnp.int32)[None, :]
    py = jnp.arange(H, dtype=jnp.int32)[:, None]
    ox = x0i - px  # in-window iff in [-2, 1]
    oy = y0i - py

    # 25 clamp-shifted views of the f16 history (static slices of one
    # edge-padded array; XLA fuses the reads into the select loop)
    padded = jnp.pad(imgh, ((2, 2), (2, 2), (0, 0)), mode="edge")
    shifted = {
        (ky, kx): padded[2 + ky : 2 + ky + H, 2 + kx : 2 + kx + W]
        for ky in range(-2, 3)
        for kx in range(-2, 3)
    }

    # separable select: colsel[ky][e] = shifted[ky, ox + e]
    def sel4(cands, off):
        # cands: {k: (H, W, C)} for k in -2..1; off in [-2, 1]
        out = cands[-2]
        for k in (-1, 0, 1):
            out = jnp.where((off == k)[..., None], cands[k], out)
        return out

    corners = {}
    for e in (0, 1):
        colsel = {
            ky: sel4({k: shifted[(ky, k + e)] for k in range(-2, 2)}, ox)
            for ky in range(-2, 3)
        }
        for d in (0, 1):
            corners[(d, e)] = sel4(
                {k: colsel[k + d] for k in range(-2, 2)}, oy
            ).astype(jnp.float32)

    c00, c10 = corners[(0, 0)], corners[(0, 1)]
    c01, c11 = corners[(1, 0)], corners[(1, 1)]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    out = top + (bot - top) * ty

    # ---- 8x8-block fallback for out-of-window pixels --------------------
    Hb, Wb = H // 8, W // 8
    bad = (ox < -2) | (ox > 1) | (oy < -2) | (oy > 1)
    bad_blk = bad.reshape(Hb, 8, Wb, 8).any(axis=(1, 3)).reshape(-1)
    count = jnp.sum(bad_blk.astype(jnp.int32))
    F = capacity or max(Hb * Wb // 8, 256)
    bidx = fastmath.compact_indices(bad_blk, F)
    valid = jnp.arange(F) < jnp.minimum(count, F)
    by = bidx // Wb
    bx = bidx - by * Wb
    pys = by[:, None, None] * 8 + jnp.arange(8)[None, :, None]
    pxs = bx[:, None, None] * 8 + jnp.arange(8)[None, None, :]
    pix = (pys * W + pxs).reshape(-1)  # (64F,)
    pix = jnp.where(jnp.repeat(valid, 64), pix, 0)

    # the same packed quad table _bilinear_clamp gathers (f16, 4C/row)
    xn = jnp.concatenate([imgh[:, 1:], imgh[:, -1:]], axis=1)
    yn = jnp.concatenate([imgh[1:], imgh[-1:]], axis=0)
    xyn = jnp.concatenate([xn[1:], xn[-1:]], axis=0)
    quads = jnp.concatenate([imgh, xn, yn, xyn], axis=-1).reshape(
        H * W, 4 * C
    )
    quads = jax.lax.optimization_barrier(quads)

    # per-pixel fetch record [row, tx, ty] packed once densely -> ONE
    # 12 B gather per fallback pixel + one quad row
    rec = jnp.concatenate(
        [
            (y0i * W + x0i).astype(jnp.float32).reshape(H * W, 1),
            tx.reshape(H * W, 1),
            ty.reshape(H * W, 1),
        ],
        axis=-1,
    )
    rec = jax.lax.optimization_barrier(rec)
    r = rec[pix]
    q = quads[r[:, 0].astype(jnp.int32)].astype(jnp.float32)
    txe = r[:, 1:2]
    tye = r[:, 2:3]
    e00, e10 = q[..., :C], q[..., C : 2 * C]
    e01, e11 = q[..., 2 * C : 3 * C], q[..., 3 * C :]
    tope = e00 + (e10 - e00) * txe
    bote = e01 + (e11 - e01) * txe
    vals = tope + (bote - tope) * tye
    widx = jnp.where(jnp.repeat(valid, 64), pix, H * W)
    out = (
        out.reshape(H * W, C).at[widx].set(vals, mode="drop")
        .reshape(H, W, C)
    )
    return out, jnp.maximum(count - F, 0)


def reproject(gbuffer, camera) -> jnp.ndarray:
    """-> (H, W, 3): (velocity.xy in NDC units, in-bounds flag)."""
    depth = gbuffer.depth
    H, W = depth.shape
    # 3x3 max dilation (reproject.wgsl:20-26).
    d = depth
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            d = jnp.maximum(d, _shift(depth, dy, dx))

    u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    x_ndc = (u * 2.0 - 1.0)[None, :].repeat(H, 0)
    y_ndc = ((1.0 - v) * 2.0 - 1.0)[:, None].repeat(W, 1)

    pos_ws = world_position_from_depth(d, camera.clip_to_world)
    m = jnp.asarray(camera.prev_world_to_clip)
    px_, py_, pz_, pw_ = fastmath.const_mat4_point4(
        m, pos_ws[..., 0], pos_ws[..., 1], pos_ws[..., 2]
    )
    prev_ndc = jnp.stack([px_ / pw_, py_ / pw_], axis=-1)

    jit = jnp.asarray(camera.jitter)
    pjit = jnp.asarray(camera.prev_jitter)
    vel_x = (x_ndc + jit[0]) - (prev_ndc[..., 0] + pjit[0])
    vel_y = (y_ndc + jit[1]) - (prev_ndc[..., 1] + pjit[1])

    inv_dims = jnp.asarray([1.0 / W, 1.0 / H], jnp.float32)
    in_bounds = jnp.all(
        prev_ndc == jnp.clip(prev_ndc, -1.0 + inv_dims, 1.0 - inv_dims), axis=-1
    )
    return jnp.stack([vel_x, vel_y, in_bounds.astype(jnp.float32)], axis=-1)


def taa_resolve(color, history, motion, quad_history=False,
                edge_capacity=0, inwindow=False, block_capacity=0,
                quad_select="einsum"):
    """taa.wgsl:45-103. color/history: (H, W, 3); motion: (H, W, 3).
    Returns (resolved, edge-overflow count — 0 unless quad_history or
    inwindow). `inwindow`: gather-free history fetch for near-static
    pixels (bit-identical; see _bilinear_clamp_inwindow). `quad_select`:
    the quad path's in-block select ("einsum" | "where", bit-identical)."""
    H, W = color.shape[:2]
    u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    uu = u[None, :].repeat(H, 0)
    vv = v[:, None].repeat(W, 1)

    vel = motion
    hist_u = uu - vel[..., 0] * 0.5
    hist_v = vv + vel[..., 1] * 0.5  # * (1, -1) flip

    overflow = jnp.zeros((), jnp.int32)
    if quad_history and H % 2 == 0 and W % 2 == 0:
        hist_rgb, overflow = _bilinear_clamp_quadblock(
            history, hist_u, hist_v, capacity=edge_capacity,
            select=quad_select,
        )
    elif inwindow:
        hist_rgb, overflow = _bilinear_clamp_inwindow(
            history, hist_u, hist_v, capacity=block_capacity
        )
    else:
        hist_rgb = _bilinear_clamp(history, hist_u, hist_v)
    hist = rgb_to_ycbcr(hist_rgb)

    # 3x3 Gaussian-weighted moments in YCbCr.
    vsum = jnp.zeros_like(color)
    vsum2 = jnp.zeros_like(color)
    wsum = 0.0
    mn_sum = jnp.zeros_like(color)
    mn_wsum = 0.0
    import numpy as np

    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = _shift(color, dy, dx)
            neigh = rgb_to_ycbcr(shifted)
            w = float(np.exp(-3.0 * (dx * dx + dy * dy) / 4.0))
            vsum = vsum + neigh * w
            vsum2 = vsum2 + neigh * neigh * w
            wsum += w
            # Mitchell-Netravali center filter accumulates in RGB
            wt = _mitchell_weight_np(np.sqrt(dx * dx + dy * dy))
            mn_sum = mn_sum + shifted * wt
            mn_wsum += wt

    ex = vsum / wsum
    ex2 = vsum2 / wsum
    dev = jnp.sqrt(jnp.maximum(0.0, ex2 - ex * ex))
    local_contrast = dev[..., 0] / (ex[..., 0] + 1e-5)

    hist_px = hist_u * W
    hist_py = hist_v * H
    frac = jnp.stack(
        [hist_px - jnp.floor(hist_px), hist_py - jnp.floor(hist_py)], axis=-1
    )
    texel_center_dist = jnp.sum(jnp.abs(0.5 - frac), axis=-1)

    box_size = 1.0
    box_size = box_size * (0.5 + 0.5 * _smoothstep(-0.1, 0.3, local_contrast))
    box_size = box_size * (
        0.5 + 0.5 * jnp.clip(1.0 - texel_center_dist, 0.0, 1.0)
    )

    center = rgb_to_ycbcr(mn_sum / mn_wsum)

    n_dev = 1.5
    bs2 = (box_size * box_size)[..., None]
    mid = center + (ex - center) * bs2
    nmin = mid - dev * (box_size[..., None] * n_dev)
    nmax = mid + dev * (box_size[..., None] * n_dev)

    clamped = jnp.clip(hist, nmin, nmax)
    blend = 1.0 + (1.0 / 12.0 - 1.0) * vel[..., 2]
    clamp_dist = jnp.minimum(
        jnp.abs(hist[..., 0] - nmin[..., 0]), jnp.abs(hist[..., 0] - nmax[..., 0])
    ) / jnp.maximum(jnp.maximum(hist[..., 0], ex[..., 0]), 1e-5)
    blend = blend * (0.2 + 0.8 * _smoothstep(0.0, 2.0, clamp_dist))

    result = clamped + (center - clamped) * blend[..., None]
    return ycbcr_to_rgb(result), overflow


def taa(color, gbuffer, camera, state, quad_history=False, edge_capacity=0,
        inwindow=False, block_capacity=0, quad_select="einsum"):
    """Full TAA pass; returns (resolved color, new state, overflow)."""
    motion = reproject(gbuffer, camera)
    resolved, overflow = taa_resolve(
        color, state.history, motion, quad_history=quad_history,
        edge_capacity=edge_capacity, inwindow=inwindow,
        block_capacity=block_capacity, quad_select=quad_select,
    )
    out = jnp.where(state.history_valid, resolved, color)
    new_state = state.replace(history=out, history_valid=jnp.asarray(True))
    return out, new_state, overflow
