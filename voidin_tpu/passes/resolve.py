"""Visibility-buffer -> G-buffer resolve.

The reference's raster fragment shader (shaders/visibility.wgsl:66-97)
interpolates normal/tangent/uv per fragment, samples the normal map, applies
the alpha cutoff, and writes the packed G-buffer. Our rasterizer emits only
(triangle id, depth); this pass recomputes perspective-correct barycentrics
per winning pixel and evaluates the same attribute math densely.

Gather budget: per pixel this pass issues
exactly 3 row-gathers — the packed resolve record (clip + ids, 48 B), ONE
packed corner-attribute row (uv f32 + octahedral normals/tangents, 48 B),
one fused instance+material record (basis + full material row, 96 B from a
SMALL table) — plus the albedo texture tap (and the normal-map tap only
when the scene has normal maps).

Contract reproduced exactly:
* normal matrix = upper-left 3x3 of the instance transform (not inverse
  transpose) — visibility.wgsl:43-46;
* bitangent = cross(normal, tangent) * tangent.w — visibility.wgsl:47;
* normal map applied iff material.normal != 0 (WHITE) — visibility.wgsl:83-89;
* alpha cutoff: base_color.w < 0.5 || albedo.a < 0.5 -> background
  (visibility.wgsl:79-81);
* G-buffer = (octahedral normal u32, pack2x16float uv, material id, depth).

Alpha-masked scenes (RasterConfig.alpha_mask): pixels whose depth winner is
alpha-cut fall back to the rasterizer's runner-up candidate. With
`lazy_alpha_resolve` the fallback resolves only a COMPACTED list of cut
pixels (capacity-padded flat batch + one packed-row scatter) instead of
re-resolving every pixel densely — cut pixels are rare, so the masked-scene
resolve cost drops from 2x to ~1.2x. Fallback pixels use ANALYTIC
within-triangle uv derivatives for mip selection (the barycentric probe at
+1px), which is what the reference's raster-FS helper lanes compute for the
revealed surface; the dense path keeps image-space finite differences (the
reference's fullscreen shading-FS semantics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import checks, encoding, fastmath
from ..scene.scene import SceneData
from ..scene.texture import sample_trilinear
from .gbuffer import GBuffer, VisBuffer
from .shading import uv_lod


@struct.dataclass
class ResolveAux:
    """Per-pixel material fields the shading pass consumes, produced here so
    shading issues ZERO per-pixel gathers: the material row rides the fused
    instance record this pass gathers anyway (one 96 B row from a small
    table), and emissive/metallic-roughness are const-folded or sampled at
    the same quantized uv/lod the reference's shading FS would use
    (shading.wgsl:58-64 samples via the G-buffer's packed uv)."""

    albedo: jnp.ndarray  # (H, W, 4) filtered albedo (shading.wgsl:58)
    emissive: jnp.ndarray  # (H, W, 3)
    mr: jnp.ndarray  # (H, W, 4) metallic-roughness texel
    overflow: jnp.ndarray = struct.field(default=None)  # () i32 or None


def _normalize(v, eps=1e-20):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def _inst_rec(scene: SceneData):
    """ONE fused per-instance record (transform basis + the FULL material
    row), built densely from the live pools each frame. Folding every
    material field the frame needs into the instance row makes this the
    frame's only material fetch: the shading pass then runs with zero
    per-pixel gathers. 24 f32 = 96 B rows from a small (N-instance) table
    stay in the flat-cost gather regime (tools/microbench_gather.py)."""
    n_inst = scene.instances.count
    mats = scene.materials
    mid = scene.instances.material_id  # (N,)
    albedo_sz = scene.textures.size[mats.albedo[mid]].astype(jnp.float32)
    return jnp.concatenate(
        [
            scene.instances.transform[:, :3, :3].reshape(n_inst, 9),
            mid.astype(jnp.float32)[:, None],
            mats.albedo[mid].astype(jnp.float32)[:, None],
            mats.normal[mid].astype(jnp.float32)[:, None],
            mats.base_color[mid, 3][:, None],
            mats.emissive[mid].astype(jnp.float32)[:, None],
            mats.metallic_roughness[mid].astype(jnp.float32)[:, None],
            albedo_sz,  # (N, 2) albedo texture extent (lod)
            mats.emissive_rgba[mid, :3],  # const-folded 1x1 emissive
            mats.mr_rgba[mid],  # const-folded 1x1 metallic-roughness
        ],
        axis=-1,
    )  # (N, 24)


def _inst_rec_f16(scene: SceneData):
    """RasterConfig.inst_rec_f16: the fused record as f16 pairs bitcast
    into 12 u32 columns — 48 B rows, ONE flat-rate gather instead of a
    96 B row. f16 keeps ids (exact < 2048; MAX_TEXTURES is 1024) and
    power-of-two texture extents exact; basis/color fields carry ~1e-3
    relative error, inside the 1e-2 image budget."""
    # f16 integers are exact only up to 2048 — ids beyond that would
    # silently select the wrong material/texture. Pool sizes are static,
    # so fail LOUDLY at trace time instead.
    n_mats = scene.materials.albedo.shape[0]
    n_tex = scene.textures.size.shape[0]
    if n_mats > 2048 or n_tex > 2048:
        raise ValueError(
            f"inst_rec_f16 requires material/texture ids < 2048 (f16 "
            f"integer exactness); scene has {n_mats} materials / "
            f"{n_tex} textures — disable RasterConfig.inst_rec_f16"
        )
    rec = _inst_rec(scene).astype(jnp.float16)  # (N, 24)
    n = rec.shape[0]
    return jax.lax.bitcast_convert_type(
        rec.reshape(n, 12, 2), jnp.uint32
    )  # (N, 12)


def _fetch_rows(scene: SceneData, vis: VisBuffer, tri_id,
                inst_f16: bool = False, slim: bool = False):
    """The resolve pass's per-pixel GATHERS, separated from the math so the
    quad-rate path (_quad_fetch) can issue them at 2x2-quad rate: raw row
    tables for an arbitrary pixel-set shape S. Keys:
      rec  (*S, 12|24) f32  packed resolve record
      pk   (*S, 12)    u32  packed corner-attribute row
      irec (*S, 24) f32 | (*S, 12) u32  fused instance+material record
    Raw (undecoded) forms so the quad path can scatter narrow rows."""
    tid = jnp.maximum(tri_id, 0)
    rec = vis.resolve_rec[
        checks.check_index(tid, vis.resolve_rec.shape[0], "resolve.rec")
    ]
    if slim:
        # RasterConfig.slim_rec: ONE 96 B row carries everything (clip,
        # uv, world-space normals, f16 material payload) — the frame's
        # only other per-pixel gather is the albedo tap.
        return dict(rec=rec)
    if rec.shape[-1] >= 24:
        pk = jax.lax.bitcast_convert_type(rec[..., 12:24], jnp.uint32)
    else:
        tri_pool = (rec[..., 10] / 3.0).astype(jnp.int32)  # idx_start / 3
        pk = scene.meshes.tri_attr_packed[
            checks.check_index(
                tri_pool, scene.meshes.tri_attr_packed.shape[0],
                "resolve.tri_attr",
            )
        ]  # (*S, 12) u32
    if rec.shape[-1] >= 36:
        # RasterConfig.fused_inst_rec: the f16 instance+material columns
        # rode the resolve record from setup — zero extra gathers here.
        # (Bit-identical to the inst_f16 gather: same u32 values, they
        # just travel as bitcast f32 columns.)
        irec = jax.lax.bitcast_convert_type(rec[..., 24:36], jnp.uint32)
        return dict(rec=rec, pk=pk, irec=irec)
    inst = rec[..., 9].astype(jnp.int32)
    inst = checks.check_index(
        inst, scene.instances.count, "resolve.instance"
    )
    if inst_f16:
        irec = _inst_rec_f16(scene)[inst]  # (*S, 12) u32
    else:
        irec = _inst_rec(scene)[inst]  # (*S, 24) f32
    return dict(rec=rec, pk=pk, irec=irec)


def _quad_fetch(scene: SceneData, vis: VisBuffer, tri_id,
                inst_f16: bool = False, capacity: int = 0):
    """Coherence-aware fetch (RasterConfig.quad_rate_resolve): neighboring
    pixels usually hit the same triangle, so the three per-pixel row
    gathers (the resolve pass's dominant cost) are issued once per UNIFORM
    2x2 quad and broadcast; only pixels of non-uniform (edge) quads go
    through a compacted flat batch + row scatters. Bit-exact with the
    per-pixel path: the same rows feed the same math. Row count drops from
    3 * H*W to ~3 * (H*W/4 + 8 * edge_quads); at typical 1080p edge
    densities (~10-20% of quads) that is a ~2x cut.

    Returns (dense row tables (H, W, C), overflow count beyond capacity).
    Overflowed edge pixels keep their quad anchor's rows (bounded error,
    counted — size quad_edge_capacity per scene like other capacities)."""
    H, W = tri_id.shape
    Hq, Wq = H // 2, W // 2
    q = tri_id.reshape(Hq, 2, Wq, 2)
    anchor = q[:, 0, :, 0]  # (Hq, Wq)
    uniform = jnp.all(q == anchor[:, None, :, None], axis=(1, 3))

    rows_q = _fetch_rows(scene, vis, anchor, inst_f16)

    def up(t):  # (Hq, Wq, C) -> (H, W, C) 2x2 broadcast
        C = t.shape[2:]
        tt = jnp.broadcast_to(t[:, None, :, None], (Hq, 2, Wq, 2) + C)
        return tt.reshape((H, W) + C)

    dense = {k: up(v) for k, v in rows_q.items()}

    F = capacity or max(Hq * Wq // 4, 1024)
    flat = (~uniform).reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    qidx = fastmath.compact_indices(flat, F)  # (F,) quad indices
    valid = jnp.arange(F) < jnp.minimum(count, F)
    qy = qidx // Wq
    qx = qidx - qy * Wq
    # all 4 pixels of each edge quad as one flat batch
    py = jnp.concatenate([qy * 2, qy * 2, qy * 2 + 1, qy * 2 + 1])
    px = jnp.concatenate([qx * 2, qx * 2 + 1, qx * 2, qx * 2 + 1])
    pix = py * W + px  # (4F,)
    tid_e = tri_id.reshape(-1)[pix]
    rows_e = _fetch_rows(scene, vis, tid_e, inst_f16)
    valid4 = jnp.concatenate([valid] * 4)
    widx = jnp.where(valid4, pix, H * W)  # invalid slots dropped
    for k in dense:
        t = dense[k].reshape((H * W,) + dense[k].shape[2:])
        dense[k] = t.at[widx].set(
            rows_e[k], mode="drop"
        ).reshape(dense[k].shape)
    return dense, jnp.maximum(count - F, 0)


def _decode_slim_channels(rows):
    """Slim-record decode (RasterConfig.slim_rec): cl/uv read straight off
    the f32 columns, corner normals are ALREADY world-space oct32 (cols
    15:18), and the 12xf16 payload (cols 18:24) carries the material
    scalars — no instance record, no tangents (slim requires a scene with
    no normal maps)."""
    rec = rows["rec"]
    S = rec.shape[:-1]
    n_u32 = jax.lax.bitcast_convert_type(rec[..., 15:18], jnp.uint32)
    n_c = encoding.decode_octahedral_32(n_u32)  # (*S, 3, 3)
    pay = jax.lax.bitcast_convert_type(
        rec[..., 18:24], jnp.float16
    ).reshape(S + (12,)).astype(jnp.float32)
    return dict(
        cl=rec[..., :9],
        uv_c=rec[..., 9:15],
        n_c=n_c.reshape(S + (9,)),
        pay=pay,
    )


def _decode_channels(rows, inst_f16: bool = False, tangents: bool = True):
    """Raw row tables -> pure-f32 per-element channels, shape-agnostic.

    Elementwise, so it commutes with any EXACT selection: the slot-rate
    path (_slot_fetch_channels) decodes at (tile, slot) rate and one-hot
    selects the f32 channels per pixel — bit-identical to decoding
    per-pixel fetched rows. Channels (trailing dims flat):
      cl     (*S, 9)   clip x/y/w per vertex
      uv_c   (*S, 6)   corner uvs
      n_c    (*S, 9)   decoded corner normals
      t_c    (*S, 9)   decoded corner tangents
      t_sign (*S, 3)   tangent.w signs
      irec   (*S, 24)  fused instance+material record
    """
    rec = rows["rec"]
    S = rec.shape[:-1]
    pk = rows["pk"]  # (*S, 12) u32
    uv_c = jax.lax.bitcast_convert_type(pk[..., 0:6], jnp.float32)
    n_c = encoding.decode_octahedral_32(pk[..., 6:9])  # (*S, 3, 3)
    if inst_f16:
        irec = jax.lax.bitcast_convert_type(
            rows["irec"], jnp.float16
        ).reshape(S + (24,)).astype(jnp.float32)
    else:
        irec = rows["irec"]  # (*S, 24)
    out = dict(
        cl=rec[..., :9],
        uv_c=uv_c,
        n_c=n_c.reshape(S + (9,)),
        irec=irec,
    )
    if tangents:
        # Skipped when the scene has no normal maps (tangents feed only
        # the TBN transform): 12 of 60 channels off the slot select.
        t_enc = pk[..., 9:12]
        out["t_sign"] = 1.0 - 2.0 * (
            t_enc & jnp.uint32(1)
        ).astype(jnp.float32)
        out["t_c"] = encoding.decode_octahedral_32(t_enc).reshape(S + (9,))
    return out


def _slot_fetch_channels(scene: SceneData, vis: VisBuffer, tri_id,
                         inst_f16: bool = False, k_slots: int = 16,
                         capacity: int = 0):
    """Tile-rate fetch (RasterConfig.slot_resolve): an 8x16 fine-raster
    tile shows only a handful of DISTINCT winning triangles, so the three
    resolve row gathers are issued once per (tile, slot) — k_slots slots
    per tile — instead of once per pixel or 2x2 quad. Per-pixel channel
    values are then produced by an EXACT one-hot matmul on the MXU
    (weights are exactly 0/1, so products/sums select a single f32 value
    bit-exactly; jax.lax.Precision.HIGHEST keeps the f32 passes exact on
    the MXU — hardware-guarded in tools/check_kernel_hw.py).

    Distinct ids are extracted with k_slots dense iterated-max passes
    (zero gathers). TILES holding more than k_slots distinct ids go
    through a compacted per-TILE fallback: every pixel of an overflowing
    tile is re-resolved per-pixel and scattered back (compacting 16k tile
    flags costs ~1/128 of compacting 2M pixel flags; re-writing the
    tile's matched pixels with identical values keeps bit-exactness).
    `capacity` counts TILES (0 = n_tiles // 32).

    Gather rows: 3 * NT * k_slots (~0.8M at 1080p/K=16, vs ~2.6M for the
    quad path at typical edge densities) + 3 * 128 * capacity fallback.

    Returns (channels dict of dense (H, W, C) f32, overflow tile count)."""
    H, W = tri_id.shape
    from ..ops import fine_raster as fr

    TH, TW = fr.TILE_H, fr.TILE_W
    Ty, Tx = H // TH, W // TW
    NT = Ty * Tx
    PX = TH * TW
    t = (
        tri_id.reshape(Ty, TH, Tx, TW)
        .transpose(0, 2, 1, 3)
        .reshape(Ty, Tx, PX)
    )

    # k_slots iterated-max passes -> (Ty, Tx, K) distinct ids, descending.
    # -2 marks consumed lanes (ids are >= -1); exhausted slots stay -2.
    uniq = []
    cur = t
    for _ in range(k_slots):
        m = jnp.max(cur, axis=-1)  # (Ty, Tx)
        uniq.append(m)
        cur = jnp.where(cur == m[..., None], -2, cur)
    uniq = jnp.stack(uniq, axis=-1)  # (Ty, Tx, K)
    # a tile overflowed iff ids remain unconsumed after k_slots passes
    tile_ovf = jnp.max(cur, axis=-1) > -2  # (Ty, Tx)

    tangents = not getattr(scene, "no_normal_maps", False)
    rows = _fetch_rows(scene, vis, jnp.maximum(uniq, -1), inst_f16)
    ch = _decode_channels(rows, inst_f16, tangents=tangents)
    keys = list(ch.keys())
    table = jnp.concatenate([ch[k] for k in keys], axis=-1)
    # (Ty, Tx, K, Ctot)

    onehot = (t[..., None] == uniq[..., None, :]).astype(jnp.float32)
    # (Ty, Tx, PX, K); unmatched pixels live only in overflowing tiles
    dense = jnp.einsum(
        "abpk,abkc->abpc", onehot, table,
        precision=jax.lax.Precision.HIGHEST,
    )  # (Ty, Tx, PX, Ctot)
    Ctot = table.shape[-1]
    dense = (
        dense.reshape(Ty, Tx, TH, TW, Ctot)
        .transpose(0, 2, 1, 3, 4)
        .reshape(H, W, Ctot)
    )

    # Per-tile fallback: all 128 pixels of each overflowing tile.
    F = capacity or max(NT // 32, 64)
    flat = tile_ovf.reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    tidx = fastmath.compact_indices(flat, F)  # (F,) tile indices
    valid = jnp.arange(F) < jnp.minimum(count, F)
    tid_e = t.reshape(NT, PX)[tidx]  # (F, PX) one row gather per tile
    tid_e = jnp.where(valid[:, None], tid_e, -1)
    rows_e = _fetch_rows(scene, vis, tid_e, inst_f16)
    ch_e = _decode_channels(rows_e, inst_f16, tangents=tangents)
    rows_flat = jnp.concatenate(
        [ch_e[k] for k in keys], axis=-1
    ).reshape(F * PX, Ctot)
    ty = tidx // Tx
    tx = tidx - ty * Tx
    lane = jnp.arange(PX, dtype=jnp.int32)
    pix = (
        (ty[:, None] * TH + lane[None, :] // TW) * W
        + tx[:, None] * TW + lane[None, :] % TW
    )  # (F, PX) image-flat pixel indices
    widx = jnp.where(valid[:, None], pix, H * W).reshape(F * PX)
    dense = (
        dense.reshape(H * W, Ctot)
        .at[widx].set(rows_flat, mode="drop")
        .reshape(H, W, Ctot)
    )

    out, off = {}, 0
    for k in keys:
        c = ch[k].shape[-1]
        out[k] = dense[..., off : off + c]
        off += c
    return out, jnp.maximum(count - F, 0)


def _pixel_fields(scene: SceneData, vis: VisBuffer, tri_id, depth,
                  x_ndc, y_ndc, want_aux: bool = True, lod_probe=None,
                  inst_f16: bool = False, rows=None, tap_block_cap=None,
                  channels=None, slim: bool = False):
    """Core per-pixel resolve for an arbitrary pixel-set shape S.

    tri_id/depth: shape S (raw ids, -1 = background). x_ndc/y_ndc: NDC
    coordinates broadcastable to S. lod_probe: None -> mip lod from dense
    image-space finite differences (requires S = (H, W)); (dx, dy) NDC
    steps -> analytic within-triangle barycentric probes (any S).
    `rows`: pre-fetched row tables (quad-rate path) — default fetches
    per-pixel. `channels`: pre-decoded f32 channels (slot-rate path) —
    skips fetch + decode entirely. Returns a dict of unmasked per-pixel
    fields + keep/cut masks.
    """
    S = tri_id.shape
    hit = tri_id >= 0
    if channels is None:
        if rows is None:
            rows = _fetch_rows(scene, vis, tri_id, inst_f16, slim=slim)
        channels = (_decode_slim_channels(rows) if slim
                    else _decode_channels(rows, inst_f16))
    slim = "pay" in channels

    cl = channels["cl"].reshape(S + (3, 3))

    # Perspective-correct barycentrics via 2D homogeneous coordinates:
    # b ∝ cross(u, v) with u_i = c_i.x - x*c_i.w, v_i = c_i.y - y*c_i.w.
    def bary(xn, yn):
        u = cl[..., 0] - xn[..., None] * cl[..., 2]  # (*S, 3)
        v = cl[..., 1] - yn[..., None] * cl[..., 2]
        b = jnp.cross(u, v)
        bsum = jnp.sum(b, axis=-1, keepdims=True)
        sign = jnp.where(bsum < 0, -1.0, 1.0)
        return b * sign / jnp.maximum(bsum * sign, 1e-20)

    lam_p = bary(x_ndc, y_ndc)  # (*S, 3)

    uv_c = channels["uv_c"].reshape(S + (3, 2))
    n_c = channels["n_c"].reshape(S + (3, 3))
    normal_raw = jnp.sum(n_c * lam_p[..., None], axis=-2)
    if "t_c" in channels:  # absent iff scene.no_normal_maps (slot path)
        t_c = channels["t_c"].reshape(S + (3, 3))
        tangent_raw = jnp.sum(t_c * lam_p[..., None], axis=-2)
        tangent_w = jnp.sum(channels["t_sign"] * lam_p, axis=-1)
    else:
        tangent_raw = tangent_w = None
    uv = jnp.sum(uv_c * lam_p[..., None], axis=-2)

    if slim:
        # slim_rec: corner normals were transformed to world space at
        # setup; the f16 payload supplies the material scalars directly.
        pay = channels["pay"]  # (*S, 12)
        material_id = pay[..., 0].astype(jnp.int32)
        mat_albedo = pay[..., 1].astype(jnp.int32)
        base_color_a = pay[..., 11]
        n_ws = normal_raw
        tex_w = pay[..., 2]
        tex_h = pay[..., 3]
        if not getattr(scene, "no_normal_maps", False):
            raise ValueError("slim_rec requires a scene with no normal maps")
    else:
        irec = channels["irec"]  # (*S, 24)
        basis = irec[..., :9].reshape(S + (3, 3))
        material_id = irec[..., 9].astype(jnp.int32)
        mat_albedo = irec[..., 10].astype(jnp.int32)
        mat_normal = irec[..., 11].astype(jnp.int32)
        base_color_a = irec[..., 12]

        # Object -> world with the plain upper 3x3 (reference parity).
        n_ws = fastmath.mat3_vec(basis, normal_raw)
        if tangent_raw is not None:
            t_ws = fastmath.mat3_vec(basis, tangent_raw)
            b_ws = jnp.cross(n_ws, t_ws) * tangent_w[..., None]
        elif not getattr(scene, "no_normal_maps", False):
            raise ValueError(
                "tangent channels were pruned but the scene has normal maps"
            )

        # Mip LOD (texture extent rides the fused instance record).
        tex_w = irec[..., 15]
        tex_h = irec[..., 16]
    if lod_probe is None:
        lod = uv_lod(uv, tex_w, tex_h)
    else:
        dxn, dyn = lod_probe
        uv_x = jnp.sum(uv_c * bary(x_ndc + dxn, y_ndc)[..., None], axis=-2)
        uv_y = jnp.sum(uv_c * bary(x_ndc, y_ndc - dyn)[..., None], axis=-2)
        du = uv_x - uv
        dv = uv_y - uv
        rho = jnp.maximum(
            jnp.abs(du[..., 0]) * tex_w + jnp.abs(du[..., 1]) * tex_h,
            jnp.abs(dv[..., 0]) * tex_w + jnp.abs(dv[..., 1]) * tex_h,
        )
        lod = jnp.clip(jnp.log2(jnp.maximum(rho, 1e-8)), 0.0, 16.0)

    # wh from the fused record + the scene's static sRGB slot flag: the
    # tap costs ONE texel-row gather, no per-pixel metadata gathers. With
    # tap_block_cap (RasterConfig.tap_block) the dense tap drops to TWO
    # block rows per 2x2 pixel QUAD (sample_trilinear_quadblock).
    tap_ovf = None
    if tap_block_cap is not None and len(S) == 2 and S[0] % 2 == 0 \
            and S[1] % 2 == 0 \
            and scene.textures.child_blocks is not None:
        from ..scene.texture import sample_trilinear_quadblock

        albedo, tap_ovf = sample_trilinear_quadblock(
            scene.textures, mat_albedo, uv, lod, wh=(tex_w, tex_h),
            srgb=getattr(scene, "albedo_srgb", None),
            capacity=tap_block_cap,
        )
    else:
        albedo = sample_trilinear(scene.textures, mat_albedo, uv, lod,
                                  wh=(tex_w, tex_h),
                                  srgb=getattr(scene, "albedo_srgb", None))

    n_geo = _normalize(n_ws)
    if getattr(scene, "no_normal_maps", False):
        # Static: no material has a normal map (normal == WHITE default,
        # visibility.wgsl:83) — skip the per-pixel fetch + TBN transform.
        normal = n_geo
    else:
        normal_tex = sample_trilinear(scene.textures, mat_normal, uv, lod,
                                      srgb=getattr(scene, "normal_srgb",
                                                   None))
        tbn_t = _normalize(t_ws)
        tbn_b = _normalize(b_ws)
        mapped = (
            tbn_t * (normal_tex[..., 0:1] * 2.0 - 1.0)
            + tbn_b * (normal_tex[..., 1:2] * 2.0 - 1.0)
            + n_geo * (normal_tex[..., 2:3] * 2.0 - 1.0)
        )
        use_map = (mat_normal != 0)[..., None]
        normal = _normalize(jnp.where(use_map, mapped, n_geo))

    cut = (base_color_a < 0.5) | (albedo[..., 3] < 0.5)
    keep = hit & ~cut

    packed_n = encoding.encode_octahedral_32(normal)
    packed_uv = encoding.pack2x16float(uv)
    out = dict(
        packed_n=jnp.where(keep, packed_n, jnp.uint32(0)),
        packed_uv=jnp.where(keep, packed_uv, jnp.uint32(0)),
        material=jnp.where(keep, material_id, 0).astype(jnp.int32),
        depth=jnp.where(keep, depth, 0.0),
        keep=keep,
        cut=cut,
    )
    if tap_ovf is not None:
        out["tap_overflow"] = tap_ovf
    if not want_aux:
        return out

    # Shading-pass material fields (see ResolveAux). Semantics match what
    # shade() previously derived from the G-buffer exactly:
    # * albedo: sampled above at the exact uv/lod (shading.wgsl:58);
    #   background / cut pixels revert to the material-0 WHITE lookup the
    #   reference would produce from its cleared G-buffer.
    # * emissive / metallic-roughness: const-folded from the fused record
    #   when every such texture is 1x1; otherwise sampled at the QUANTIZED
    #   uv + its lod — the reference shading FS reads uv back from the
    #   packed G-buffer (pack2x16float roundtrip), so we reproduce that
    #   quantization rather than use the exact uv.
    mats = scene.materials
    out["albedo"] = jnp.where(keep[..., None], albedo, jnp.ones_like(albedo))
    if slim:
        if not (scene.emissive_const and scene.mr_const):
            raise ValueError(
                "slim_rec requires const-folded emissive/metallic-roughness"
            )
        out["emissive"] = jnp.where(
            keep[..., None], pay[..., 4:7], mats.emissive_rgba[0, :3]
        )
        out["mr"] = jnp.where(
            keep[..., None], pay[..., 7:11], mats.mr_rgba[0]
        )
        return out
    mat_emissive = irec[..., 13].astype(jnp.int32)
    mat_mr = irec[..., 14].astype(jnp.int32)
    if not (scene.emissive_const and scene.mr_const):
        uv_s = encoding.unpack2x16float(out["packed_uv"])  # 0 off-keep
        if lod_probe is None:
            lod_s = uv_lod(uv_s, jnp.where(keep, tex_w, 1.0),
                           jnp.where(keep, tex_h, 1.0))
        else:
            lod_s = lod  # flat batch: reuse the analytic lod
    if scene.emissive_const:
        out["emissive"] = jnp.where(
            keep[..., None], irec[..., 17:20], mats.emissive_rgba[0, :3]
        )
    else:
        out["emissive"] = sample_trilinear(
            scene.textures,
            jnp.where(keep, mat_emissive, mats.emissive[0]),
            uv_s, lod_s, srgb=getattr(scene, "emissive_srgb", None),
        )[..., :3]
    if scene.mr_const:
        out["mr"] = jnp.where(
            keep[..., None], irec[..., 20:24], mats.mr_rgba[0]
        )
    else:
        out["mr"] = sample_trilinear(
            scene.textures,
            jnp.where(keep, mat_mr, mats.metallic_roughness[0]),
            uv_s, lod_s, srgb=getattr(scene, "mr_srgb", None),
        )
    return out


# ---------------------------------------------------------------------------
# Planar (channel-major) resolve twin — RasterConfig.planar_resolve
# ---------------------------------------------------------------------------
#
# The per-pixel math operates on (H, W, 3) / (H, W, 3, 3) arrays whose tiny
# trailing dims may pad when materialized between fusion barriers. This
# twin evaluates the IDENTICAL arithmetic
# (same ops, same association order, bit-exact — tests/test_resolve_planar)
# on channel-major (H, W) planes, which tile perfectly.


def _planar(t):
    """(H, W, C) -> list of C (H, W) planes via ONE transpose."""
    return list(jnp.moveaxis(t, -1, 0))


def _decode_oct_planar(plane_u32):
    """decode_octahedral_32 on a (H, W) u32 plane -> 3 planes (bit-exact:
    same ops in the same order as encoding.decode_octahedral_32)."""
    mu = float((1 << 16) - 1)
    data = plane_u32.astype(jnp.uint32)
    vx = (data & jnp.uint32(0xFFFF)).astype(jnp.float32) / mu * 2.0 - 1.0
    vy = ((data >> 16) & jnp.uint32(0xFFFF)).astype(
        jnp.float32) / mu * 2.0 - 1.0
    z = 1.0 - jnp.abs(vx) - jnp.abs(vy)
    t = jnp.maximum(-z, 0.0)
    x = vx + jnp.where(vx > 0.0, -t, t)
    y = vy + jnp.where(vy > 0.0, -t, t)
    norm = jnp.sqrt(x * x + y * y + z * z)
    return x / norm, y / norm, z / norm


def _encode_oct_planar(x, y, z):
    """encode_octahedral_32 on planes (bit-exact twin)."""
    denom = jnp.abs(x) + jnp.abs(y) + jnp.abs(z)
    nx, ny, nz = x / denom, y / denom, z / denom
    fx = (1.0 - jnp.abs(ny)) * jnp.sign(nx)
    fy = (1.0 - jnp.abs(nx)) * jnp.sign(ny)
    lower = nz < 0.0
    ex = jnp.where(lower, fx, nx) * 0.5 + 0.5
    ey = jnp.where(lower, fy, ny) * 0.5 + 0.5
    mu = float((1 << 16) - 1)
    dx = jnp.floor(ex * mu + 0.5).astype(jnp.uint32)
    dy = jnp.floor(ey * mu + 0.5).astype(jnp.uint32)
    return (dy << 16) | dx


def _pack2x16_planar(u, v):
    """pack2x16float on planes (bit-exact twin)."""
    lo = jax.lax.bitcast_convert_type(
        u.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        v.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)
    return lo | (hi << 16)


def _unpack2x16_planar(p):
    """unpack2x16float on a plane -> 2 planes (bit-exact twin)."""
    p = p.astype(jnp.uint32)
    u = jax.lax.bitcast_convert_type(
        (p & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    v = jax.lax.bitcast_convert_type(
        ((p >> 16) & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    return u, v


def _normalize_planar(x, y, z, eps=1e-20):
    norm = jnp.sqrt(jnp.maximum(x * x + y * y + z * z, eps))
    return x / norm, y / norm, z / norm


def _uv_lod_planar(u, v, tex_w, tex_h):
    """uv_lod (shading.py) on planes: image-space finite differences."""
    du_u = jnp.diff(u, axis=1, append=u[:, -1:])
    du_v = jnp.diff(v, axis=1, append=v[:, -1:])
    dv_u = jnp.diff(u, axis=0, append=u[-1:, :])
    dv_v = jnp.diff(v, axis=0, append=v[-1:, :])
    rho = jnp.maximum(
        jnp.abs(du_u) * tex_w + jnp.abs(du_v) * tex_h,
        jnp.abs(dv_u) * tex_w + jnp.abs(dv_v) * tex_h,
    )
    return jnp.clip(jnp.log2(jnp.maximum(rho, 1e-8)), 0.0, 16.0)


def _pixel_fields_planar(scene: SceneData, vis: VisBuffer, tri_id, depth,
                         x_ndc, y_ndc, want_aux: bool = True,
                         inst_f16: bool = False, slim: bool = False):
    """Channel-major twin of `_pixel_fields` for the dense (H, W) path
    (image-space lod, no coherence machinery). Bit-exact by construction:
    every multiply-add appears in the same order as the vector form."""
    S = tri_id.shape
    hit = tri_id >= 0
    rows = _fetch_rows(scene, vis, tri_id, inst_f16, slim=slim)

    rec_p = _planar(rows["rec"])
    no_nmaps = getattr(scene, "no_normal_maps", False)
    if slim:
        # slim_rec planar decode: uv/clip straight off the f32 planes,
        # world-space oct32 corner normals, 12xf16 payload -> 12 planes.
        if not no_nmaps:
            raise ValueError("slim_rec requires a scene with no normal maps")
        cl = rec_p[:9]
        uv_c = rec_p[9:15]
        n_c = [
            _decode_oct_planar(
                jax.lax.bitcast_convert_type(rec_p[15 + i], jnp.uint32)
            )
            for i in range(3)
        ]
        pay_p = []
        for j in range(6):
            pair = jax.lax.bitcast_convert_type(rec_p[18 + j], jnp.float16)
            pay_p.append(pair[..., 0].astype(jnp.float32))
            pay_p.append(pair[..., 1].astype(jnp.float32))
    else:
        pk_p = _planar(rows["pk"])
        if inst_f16:
            irec_p = []
            for j in range(12):
                pair = jax.lax.bitcast_convert_type(
                    rows["irec"][..., j], jnp.float16)  # (*S, 2) f16
                irec_p.append(pair[..., 0].astype(jnp.float32))
                irec_p.append(pair[..., 1].astype(jnp.float32))
        else:
            irec_p = _planar(rows["irec"])

        cl = rec_p[:9]  # vertex-major: cl[3*i + j], j in (x, y, w)
        uv_c = [jax.lax.bitcast_convert_type(pk_p[k], jnp.float32)
                for k in range(6)]
        n_c = [_decode_oct_planar(pk_p[6 + i]) for i in range(3)]
        if not no_nmaps:
            t_sign = [1.0 - 2.0 * (pk_p[9 + i] & jnp.uint32(1)).astype(
                jnp.float32) for i in range(3)]
            t_c = [_decode_oct_planar(pk_p[9 + i]) for i in range(3)]

    def bary(xn, yn):
        u = [cl[3 * i + 0] - xn * cl[3 * i + 2] for i in range(3)]
        v = [cl[3 * i + 1] - yn * cl[3 * i + 2] for i in range(3)]
        b = [u[1] * v[2] - u[2] * v[1],
             u[2] * v[0] - u[0] * v[2],
             u[0] * v[1] - u[1] * v[0]]
        bsum = b[0] + b[1] + b[2]
        sign = jnp.where(bsum < 0, -1.0, 1.0)
        denom = jnp.maximum(bsum * sign, 1e-20)
        return [bi * sign / denom for bi in b]

    lam = bary(x_ndc, y_ndc)

    def interp(c):  # c: list of 3 corner planes
        return c[0] * lam[0] + c[1] * lam[1] + c[2] * lam[2]

    normal_raw = [interp([n_c[i][j] for i in range(3)]) for j in range(3)]
    u_pl = interp([uv_c[0], uv_c[2], uv_c[4]])
    v_pl = interp([uv_c[1], uv_c[3], uv_c[5]])

    if slim:
        n_ws = normal_raw  # corners already world-space (setup transform)
        material_id = pay_p[0].astype(jnp.int32)
        mat_albedo = pay_p[1].astype(jnp.int32)
        base_color_a = pay_p[11]
        tex_w, tex_h = pay_p[2], pay_p[3]
    else:
        basis = irec_p[:9]  # row-major basis[3*i + j]

        def mat3v(vec):
            return [basis[3 * i + 0] * vec[0] + basis[3 * i + 1] * vec[1]
                    + basis[3 * i + 2] * vec[2] for i in range(3)]

        n_ws = mat3v(normal_raw)
        material_id = irec_p[9].astype(jnp.int32)
        mat_albedo = irec_p[10].astype(jnp.int32)
        mat_normal = irec_p[11].astype(jnp.int32)
        base_color_a = irec_p[12]
        tex_w, tex_h = irec_p[15], irec_p[16]

    lod = _uv_lod_planar(u_pl, v_pl, tex_w, tex_h)
    uv_img = jnp.stack([u_pl, v_pl], axis=-1)
    albedo = sample_trilinear(scene.textures, mat_albedo, uv_img, lod,
                              wh=(tex_w, tex_h),
                              srgb=getattr(scene, "albedo_srgb", None))

    n_geo = _normalize_planar(*n_ws)
    if no_nmaps:
        normal = n_geo
    else:
        tangent_raw = [interp([t_c[i][j] for i in range(3)])
                       for j in range(3)]
        tangent_w = interp(t_sign)
        t_ws = mat3v(tangent_raw)
        b_ws = [(n_ws[1] * t_ws[2] - n_ws[2] * t_ws[1]) * tangent_w,
                (n_ws[2] * t_ws[0] - n_ws[0] * t_ws[2]) * tangent_w,
                (n_ws[0] * t_ws[1] - n_ws[1] * t_ws[0]) * tangent_w]
        normal_tex = sample_trilinear(
            scene.textures, mat_normal, uv_img, lod,
            srgb=getattr(scene, "normal_srgb", None))
        nt = _planar(normal_tex)
        tbn_t = _normalize_planar(*t_ws)
        tbn_b = _normalize_planar(*b_ws)
        use_map = mat_normal != 0
        mapped = [tbn_t[j] * (nt[0] * 2.0 - 1.0)
                  + tbn_b[j] * (nt[1] * 2.0 - 1.0)
                  + n_geo[j] * (nt[2] * 2.0 - 1.0) for j in range(3)]
        normal = _normalize_planar(*[
            jnp.where(use_map, mapped[j], n_geo[j]) for j in range(3)
        ])

    cut = (base_color_a < 0.5) | (albedo[..., 3] < 0.5)
    keep = hit & ~cut

    packed_n = _encode_oct_planar(*normal)
    packed_uv = _pack2x16_planar(u_pl, v_pl)
    out = dict(
        packed_n=jnp.where(keep, packed_n, jnp.uint32(0)),
        packed_uv=jnp.where(keep, packed_uv, jnp.uint32(0)),
        material=jnp.where(keep, material_id, 0).astype(jnp.int32),
        depth=jnp.where(keep, depth, 0.0),
        keep=keep,
        cut=cut,
    )
    if not want_aux:
        return out

    mats = scene.materials
    out["albedo"] = jnp.where(keep[..., None], albedo,
                              jnp.ones_like(albedo))
    if slim:
        if not (scene.emissive_const and scene.mr_const):
            raise ValueError(
                "slim_rec requires const-folded emissive/metallic-roughness"
            )
        out["emissive"] = jnp.where(
            keep[..., None], jnp.stack(pay_p[4:7], axis=-1),
            mats.emissive_rgba[0, :3],
        )
        out["mr"] = jnp.where(
            keep[..., None], jnp.stack(pay_p[7:11], axis=-1),
            mats.mr_rgba[0],
        )
        return out
    mat_emissive = irec_p[13].astype(jnp.int32)
    mat_mr = irec_p[14].astype(jnp.int32)
    if not (scene.emissive_const and scene.mr_const):
        us, vs = _unpack2x16_planar(out["packed_uv"])
        lod_s = _uv_lod_planar(us, vs, jnp.where(keep, tex_w, 1.0),
                               jnp.where(keep, tex_h, 1.0))
        uv_s = jnp.stack([us, vs], axis=-1)
    if scene.emissive_const:
        out["emissive"] = jnp.where(
            keep[..., None], jnp.stack(irec_p[17:20], axis=-1),
            mats.emissive_rgba[0, :3],
        )
    else:
        out["emissive"] = sample_trilinear(
            scene.textures,
            jnp.where(keep, mat_emissive, mats.emissive[0]),
            uv_s, lod_s, srgb=getattr(scene, "emissive_srgb", None),
        )[..., :3]
    if scene.mr_const:
        out["mr"] = jnp.where(
            keep[..., None], jnp.stack(irec_p[20:24], axis=-1),
            mats.mr_rgba[0],
        )
    else:
        out["mr"] = sample_trilinear(
            scene.textures,
            jnp.where(keep, mat_mr, mats.metallic_roughness[0]),
            uv_s, lod_s, srgb=getattr(scene, "mr_srgb", None),
        )
    return out


def _assemble(fields, overflow=None):
    gbuffer = GBuffer(
        normal_uv=jnp.stack([fields["packed_n"], fields["packed_uv"]],
                            axis=-1),
        material=fields["material"],
        depth=fields["depth"],
    )
    aux = None
    if "albedo" in fields:
        aux = ResolveAux(albedo=fields["albedo"], emissive=fields["emissive"],
                         mr=fields["mr"], overflow=overflow)
    return gbuffer, aux


# Packed fallback row layout (u32 bitcast): the flat batch's results return
# to the image through ONE row scatter instead of 15 separate field
# scatters.
_FB_F = 16  # [n, uv, material, depth, albedo*4, emissive*3, mr*4, flag]


def _pack_fallback_rows(fields):
    f32 = lambda x: jax.lax.bitcast_convert_type(  # noqa: E731
        x.astype(jnp.float32), jnp.uint32
    )
    cols = [
        fields["packed_n"],
        fields["packed_uv"],
        fields["material"].astype(jnp.uint32),
        f32(fields["depth"]),
    ]
    cols += [f32(fields["albedo"][..., c]) for c in range(4)]
    cols += [f32(fields["emissive"][..., c]) for c in range(3)]
    cols += [f32(fields["mr"][..., c]) for c in range(4)]
    cols.append(jnp.ones_like(fields["packed_n"]))  # processed flag
    return jnp.stack(cols, axis=-1)  # (F, 16) u32


def _unpack_fallback(img_u32):
    f32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)  # noqa: E731
    return dict(
        packed_n=img_u32[..., 0],
        packed_uv=img_u32[..., 1],
        material=img_u32[..., 2].astype(jnp.int32),
        depth=f32(img_u32[..., 3]),
        albedo=f32(img_u32[..., 4:8]),
        emissive=f32(img_u32[..., 8:11]),
        mr=f32(img_u32[..., 11:15]),
        flag=img_u32[..., 15] > 0,
    )


def resolve_gbuffer(scene: SceneData, vis: VisBuffer, camera, config):
    """Resolve the winning candidate; with second-candidate tracking
    (RasterConfig.alpha_mask), pixels whose winner is alpha-cut fall back to
    the runner-up — reproducing visibility.wgsl:79-81 `discard`, where a cut
    fragment never writes depth and the triangle BEHIND it stays visible.
    One level of fallback: a cutout behind a cutout (both cut at the same
    pixel) resolves to background; deeper stacking would need k > 2
    candidates. Returns (GBuffer, ResolveAux)."""
    H, W = vis.depth.shape
    x_ndc = ((jnp.arange(W, dtype=jnp.float32) + 0.5) / W * 2.0 - 1.0)[None, :]
    y_ndc = (1.0 - (jnp.arange(H, dtype=jnp.float32) + 0.5) / H * 2.0)[:, None]
    x_ndc = jnp.broadcast_to(x_ndc, (H, W))
    y_ndc = jnp.broadcast_to(y_ndc, (H, W))
    f16 = getattr(config, "inst_rec_f16", False)
    quad = getattr(config, "quad_rate_resolve", False) and H % 2 == 0 \
        and W % 2 == 0
    slot = getattr(config, "slot_resolve", False) and H % 8 == 0 \
        and W % 16 == 0
    if slot:
        quad = False  # slot-rate subsumes quad-rate (coarser reuse)
    if (quad or slot) and getattr(config, "fused_resolve_rec", False):
        raise ValueError(
            "quad/slot_rate_resolve and fused_resolve_rec are mutually "
            "exclusive: the coherence paths re-split the fused record's "
            "gathers"
        )
    slim = getattr(config, "slim_rec", False)
    if slim and (quad or slot):
        raise ValueError(
            "slim_rec and quad/slot_rate_resolve are mutually exclusive"
        )
    quad_cap = getattr(config, "quad_edge_capacity", 0)
    slot_cap = getattr(config, "slot_edge_capacity", 0)
    slot_k = getattr(config, "slot_k", 16)
    quad_ovf = jnp.zeros((), jnp.int32)
    track_ovf = quad or slot or getattr(config, "tap_block", False)

    tap_cap = None
    if getattr(config, "tap_block", False):
        tap_cap = getattr(config, "tap_edge_capacity", 0) \
            or max((H // 2) * (W // 2) // 4, 1024)

    planar = getattr(config, "planar_resolve", False) and not (
        quad or slot or tap_cap is not None
    )

    def dense_fields(tri_id, depth, want_aux=True):
        """Dense (H, W) resolve; slot-/quad-rate gathers when enabled."""
        nonlocal quad_ovf
        if planar:
            return _pixel_fields_planar(
                scene, vis, tri_id, depth, x_ndc, y_ndc,
                want_aux=want_aux, inst_f16=f16, slim=slim,
            )
        rows = None
        channels = None
        if slot:
            channels, ovf = _slot_fetch_channels(
                scene, vis, tri_id, inst_f16=f16, k_slots=slot_k,
                capacity=slot_cap,
            )
            quad_ovf = quad_ovf + ovf
        elif quad:
            rows, ovf = _quad_fetch(scene, vis, tri_id, inst_f16=f16,
                                    capacity=quad_cap)
            quad_ovf = quad_ovf + ovf
        f = _pixel_fields(scene, vis, tri_id, depth, x_ndc, y_ndc,
                          want_aux=want_aux, inst_f16=f16, rows=rows,
                          tap_block_cap=tap_cap, channels=channels,
                          slim=slim)
        if "tap_overflow" in f:
            quad_ovf = quad_ovf + f.pop("tap_overflow")
        return f

    if vis.tri_id2 is None:
        fields = dense_fields(vis.tri_id, vis.depth)
        return _assemble(fields, overflow=quad_ovf if track_ovf else None)

    if not getattr(config, "lazy_alpha_resolve", False):
        # Dense two-pass fallback (kept as the oracle twin for the lazy
        # path): pass 1 finds cut winners, pass 2 re-resolves every pixel
        # with the runner-up substituted.
        f1 = dense_fields(vis.tri_id, vis.depth, want_aux=False)
        # Only the FINAL pass's edge-quad/tap overflow counts — pass 1
        # visits the same quads, and summing both would double-report.
        quad_ovf = jnp.zeros((), jnp.int32)
        fall = (vis.tri_id >= 0) & f1["cut"]
        tid = jnp.where(fall, vis.tri_id2, vis.tri_id)
        dep = jnp.where(fall, vis.depth2, vis.depth)
        fields = dense_fields(tid, dep)
        return _assemble(fields, overflow=quad_ovf if track_ovf else None)

    # Lazy fallback: full resolve of the winners (this IS the final result
    # for every non-cut pixel), then a compacted flat batch over the cut
    # pixels only, scattered back as packed rows.
    f1 = dense_fields(vis.tri_id, vis.depth)
    fall = (vis.tri_id >= 0) & f1["cut"]
    F = config.alpha_fallback_capacity or max((H * W) // 16, 1024)

    flat = fall.reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    idx = fastmath.compact_indices(flat, F)  # (F,) pixel indices
    valid = jnp.arange(F) < jnp.minimum(count, F)
    tid2 = jnp.where(valid, vis.tri_id2.reshape(-1)[idx], -1)
    dep2 = vis.depth2.reshape(-1)[idx]
    fx = (idx % W).astype(jnp.float32)
    fy = (idx // W).astype(jnp.float32)
    xb = (fx + 0.5) / W * 2.0 - 1.0
    yb = 1.0 - (fy + 0.5) / H * 2.0
    fb = _pixel_fields(scene, vis, tid2, dep2, xb, yb,
                       lod_probe=(2.0 / W, 2.0 / H), inst_f16=f16,
                       slim=slim)
    rows = _pack_fallback_rows(fb)

    buf = jnp.zeros((H * W, _FB_F), jnp.uint32)
    # invalid slots write out-of-bounds and are dropped
    widx = jnp.where(valid, idx, H * W)
    buf = buf.at[widx].set(rows, mode="drop")
    fbimg = _unpack_fallback(buf.reshape(H, W, _FB_F))
    use = fall & fbimg["flag"]

    merged = dict(f1)
    for k in ("packed_n", "packed_uv", "material"):
        merged[k] = jnp.where(use, fbimg[k], f1[k])
    merged["depth"] = jnp.where(use, fbimg["depth"], f1["depth"])
    for k in ("albedo", "emissive", "mr"):
        merged[k] = jnp.where(use[..., None], fbimg[k], f1[k])
    overflow = jnp.maximum(count - F, 0) + quad_ovf
    return _assemble(merged, overflow=overflow)
