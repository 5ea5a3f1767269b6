"""Tile-binned software visibility-buffer rasterizer.

Replaces the reference's hardware raster path (multi_draw_indexed_indirect +
visibility.wgsl) with a sort-middle software design:

* every per-element fetch is ONE wide packed record, never several narrow
  ones;
* variable-rate expansions use scatter-of-boundaries + cummax instead of
  searchsorted;
* binning sorts (tile, triangle) pairs;
* the per-pixel depth competition runs in a Pallas kernel
  (ops/fine_raster.py), one program per screen tile.

Pipeline:
  1. setup: expand the compact draw stream into triangle work items,
     fetch one de-indexed corner row + one fat draw record per triangle,
     transform, near-clip (Sutherland-Hodgman, <=2 tris, extras into the
     capacity tail), then reduce each triangle to an AFFINE COEFFICIENT
     record — (ax, ay, b) per edge + depth plane in a per-triangle anchor
     frame — plus a 48 B resolve record.
  2. binning: two-stream pairs (every triangle's first tile is a 1:1
     slot; multi-tile extras expand at pair_capacity/4) -> sort by tile ->
     gather records into tile order -> bake b coefficients to each pair's
     tile origin.
  3. fine raster: Pallas kernel (ops/fine_raster.py) — each program walks
     its tile's range of the sorted record stream in small chunks; the
     reverse-Z depth/id competition reduces over the chunk's records.

Depth semantics: reverse-Z max (Greater compare, pass/visibility.rs:127-133)
with ndc.z affine in screen space.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core import encoding, fastmath
from ..ops import fine_raster as fr
from ..scene.instance import InstanceData
from ..scene.mesh import MeshPoolData
from .cull import DrawList
from .gbuffer import VisBuffer

NEAR_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    width: int = 1920
    height: int = 1080
    tri_capacity: int = 1 << 20  # max live triangle work items per frame
    pair_capacity: int = 1 << 22  # max (triangle, tile) pairs
    tile_tri_capacity: int = 128  # max triangles per tile ("xla" backend)
    interpret: bool = False  # Pallas interpret mode (CPU backend only)
    # "pallas": pair-streaming kernel (ops/fine_raster.py), no per-tile
    # capacity; "xla": fine_raster_xla over tile_tri_capacity blocks.
    backend: str = "pallas"
    # Track the second-place depth candidate per pixel so resolve can apply
    # the per-texel alpha cutoff INSIDE the depth competition
    # (visibility.wgsl:79-81 discard semantics). Costs ~15% fine-raster
    # time; Renderer enables it only when SceneData.alpha_masked.
    alpha_mask: bool = False
    # Carry record fields through the tile sort instead of a random
    # post-sort gather. Measured SLOWER on the north-star scene (32.4 vs
    # 27.9 ms for the bin stage: the 10-operand sort + field re-stack costs
    # more than the 64 B gather at ~6.6 ns/row) — kept as an option for
    # scenes with far higher pair counts where sort scaling could win.
    sort_payload: bool = False
    # Two-stream pair binning (first tile 1:1, extras via compacted
    # expansion at pair_capacity/4) vs single-stream general expansion.
    two_stream_bin: bool = True
    # Alpha-mask fallback strategy: resolve runner-up candidates lazily on
    # a compacted list of cut pixels (capacity alpha_fallback_capacity;
    # 0 = height*width//16) instead of re-resolving every pixel densely.
    # Cuts the masked-scene resolve cost from 2x to ~1.2x.
    lazy_alpha_resolve: bool = True
    alpha_fallback_capacity: int = 0
    # Carry the 48 B corner-attribute row INSIDE the resolve record (96 B
    # rows): resolve then issues ONE big-table gather per pixel instead of
    # two, at the price of a per-work-item gather at setup and wider rows
    # (48 B rows gather ~25% faster than 64 B — the win is not obvious;
    # Off until measured).
    fused_resolve_rec: bool = False
    # Pack the fused per-instance record (resolve._inst_rec, 24 f32 =
    # 96 B) as f16 pairs bitcast into 12 u32 columns = 48 B — ONE
    # flat-rate gather row per pixel instead of a 96 B row. f16 keeps
    # ids (< 2048) and texture extents exact; basis/color fields land
    # well inside the 1e-2 image budget (test_inst_rec_f16_...). Off until
    # measured.
    inst_rec_f16: bool = False
    # Channel-major resolve math (resolve._pixel_fields_planar): the
    # identical per-pixel arithmetic on (H, W) planes instead of
    # (H, W, 3)-shaped vectors, whose tiny trailing dims lane-pad to 128
    # when XLA materializes them between fusion barriers. Bit-exact
    # (tests/test_resolve_planar.py). Dense path only — ignored when a
    # coherence path (quad/slot/tap_block) is on. Off until measured.
    planar_resolve: bool = False
    # Fold the f16 fused instance+material record (resolve._inst_rec_f16)
    # INTO the resolve record at setup time: the 12 u32 columns ride the
    # per-draw record (one gather already paid per work item), so resolve
    # drops from 3 to 2 per-pixel gathers (rec + albedo). Bit-exact with
    # inst_rec_f16 (identical bits, different route —
    # tests/test_raster.py). Requires fused_resolve_rec + inst_rec_f16;
    # the renderer threads the instance table through
    # rasterize(inst_rec=...). Off until measured: the 144 B row trades
    # one gather row per pixel for a wider row.
    fused_inst_rec: bool = False
    # Slim single-row resolve record (96 B, 24 cols): clip x/y/w (9 f32) +
    # corner uv (6 f32) + WORLD-space octahedral corner normals (3 u32,
    # transformed by the instance basis at setup and re-encoded) + a 12xf16
    # material payload (ids, texture extent, const emissive/mr, alpha).
    # Resolve then issues ONE record gather + the albedo tap per pixel —
    # 2 rows instead of all_lut_p's 3 — while staying at the 96 B width
    # where the flat gather-rate regime ends (fused_inst_rec's 144 B rows
    # measured SLOWER; this keeps the row-count win without the width
    # penalty). IMAGE-BUDGET variant, not bit-exact: normals pay a second
    # octahedral quantization and are interpolated after (not before) the
    # basis transform — identical direction under uniform scale, ~1e-3
    # deviation overall (tests/test_resolve_slim.py). Requires a scene
    # with no normal maps, const-folded 1x1 emissive/metallic-roughness
    # textures, and no alpha masking (the Renderer auto-falls-back to
    # fused_resolve_rec + inst_rec_f16 otherwise). Off until measured.
    slim_rec: bool = False
    # Coherence-aware resolve (resolve._quad_fetch): issue the three
    # per-pixel resolve row gathers once per UNIFORM 2x2 pixel quad
    # (neighbors usually hit the same triangle) and per-pixel only for
    # edge quads via a compacted flat batch. Bit-exact with the per-pixel
    # path (same rows, same math); cuts resolve's gather rows ~2x at
    # typical 1080p edge densities. Mutually exclusive with
    # fused_resolve_rec. Off until measured.
    quad_rate_resolve: bool = False
    # Edge-quad capacity for quad_rate_resolve's compacted flat batch
    # (0 = n_quads // 4). Overflowed edge pixels keep their quad anchor's
    # rows — bounded error, counted in ResolveAux.overflow; size per scene
    # from the counter like the other capacities.
    quad_edge_capacity: int = 0
    # Coherence-aware TAA history fetch (taa._bilinear_clamp_quadblock):
    # one 4x4-texel block row per uniform 2x2 output quad instead of one
    # 2x2 quad row per pixel; velocity-edge quads go through a compacted
    # per-pixel batch (taa_edge_capacity, 0 = n_quads // 4). Bit-exact
    # (tests/test_taa_quad.py). Off until measured.
    taa_quad_history: bool = False
    taa_edge_capacity: int = 0
    # Gather-free TAA history fetch: near-static pixels select their
    # bilinear corners from 25 statically shifted copies (dense VPU work,
    # zero gather rows); fast movers fall back per 8x8 block through a
    # compacted batch. BIT-IDENTICAL to the default fetch
    # (tests/test_taa_inwindow.py). taa_block_capacity: fallback blocks
    # (0 = auto Hb*Wb // 8), overflow counted.
    taa_inwindow: bool = False
    taa_block_capacity: int = 0
    # taa_quad_history's in-block select: where-chains instead of the
    # one-hot einsum (bit-identical; the einsum lane-pads tiny (4, 4)
    # contractions onto the MXU at quad rate and measured ~8x slower
    # than the per-pixel gather it replaces — tools/r5_taa_fetch_ab.py).
    taa_quad_where: bool = False
    # Packet traversal for raytraced shadows (rt.traverse.
    # occluded_packets): this many screen-adjacent rays share one
    # traversal stack — node/tri rows fetched once per packet instead of
    # once per ray. BIT-EXACT (tests/test_traverse.py); 0 = per-ray
    # lock-step loop.
    rt_packet: int = 0
    # Threaded (stackless) packet traversal (rt.traverse.
    # occluded_threaded): exit links replace the per-step stack scatters,
    # and packets are 8x16 SCREEN BLOCKS (not 128x1 row strips) so the
    # union of lane paths stays tight. BIT-EXACT
    # (tests/test_traverse_threaded.py). Requires rt_packet == 128.
    rt_threaded: bool = False
    # Threaded-walk steps composed per while iteration: the walk is
    # iteration-bound (one node per packet per device loop step, each
    # step a fixed dispatch overhead) — unrolling trades M-x fewer
    # iterations for M-x per-step gathers/flops (tiny). BIT-EXACT incl.
    # the max_steps cut (tests/test_traverse_threaded.py).
    rt_unroll: int = 1
    # Quad-rate albedo tap (texture.sample_trilinear_quadblock): two 4x4
    # block rows per uniform 2x2 pixel quad instead of four 32 B quad
    # rows. Bit-exact (tests/test_texture_meta.py); edge quads (texture/
    # mip/wrap-seam straddles) go through a compacted per-pixel batch
    # (tap_edge_capacity, 0 = n_quads // 4). Off until measured.
    tap_block: bool = False
    tap_edge_capacity: int = 0
    # Tile-rate resolve (resolve._slot_fetch_channels): the three resolve
    # row gathers are issued once per (8x16 tile, distinct triangle) —
    # slot_k slots per tile, distinct ids via dense iterated max — and
    # broadcast to pixels with an EXACT one-hot MXU matmul. Subsumes
    # quad_rate_resolve (coarser reuse, ~3x fewer rows); bit-exact
    # (tests/test_resolve_slot.py). Pixels beyond slot_k distinct ids per
    # tile go through a compacted per-pixel batch (slot_edge_capacity,
    # 0 = n_pixels // 64). Off until measured.
    slot_resolve: bool = False
    slot_k: int = 16
    slot_edge_capacity: int = 0
    # OOB validation mode (SURVEY §5.2): trace the frame under
    # jax.experimental.checkify and assert every data-dependent gather
    # index (resolve records, texel rows, BVH nodes/instances) is in
    # range — core/checks.py. Debug tool: the checked frame pays the
    # checkify overhead; production leaves it off and relies on the
    # capacity/overflow counters.
    debug_bounds: bool = False

    tile_h: int = fr.TILE_H
    tile_w: int = fr.TILE_W

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_w

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_h


# Saturation bound: 2*_SAT still fits in int32. Plain Python int: a
# module-level jnp scalar would initialize the JAX backend at import time,
# before applications can pin jax_platforms.
_SAT = 1 << 29


def saturating_cumsum(counts: jnp.ndarray) -> jnp.ndarray:
    """int32 cumsum that saturates at 2^29 instead of wrapping negative.

    A huge scene (~2^31 (tri,tile) pairs) would wrap a plain int32 cumsum,
    silently zeroing pair_valid and corrupting the overflow counter — the
    guard meant to catch exactly that. int64 is unavailable (x64 disabled),
    so clamp: saturating add of non-negative ints is associative, and any
    prefix that saturates is far beyond every capacity anyway.
    """
    c = jnp.minimum(counts, _SAT)
    return jax.lax.associative_scan(lambda a, b: jnp.minimum(a + b, _SAT), c)


def segment_ids_from_counts(counts: jnp.ndarray, cap: int,
                            need_local: bool = True):
    """Variable-rate expansion without searchsorted.

    Given per-segment element counts, returns for each stream position
    e in [0, cap): (segment id, position-within-segment, valid).
    Cost: one |counts|-sized scatter + two cap-sized cumulative ops.
    `need_local=False` skips the position-within-segment computation (its
    cap-sized start-position gather) — callers that carry the segment
    start inside a record they fetch anyway recompute local from it.
    """
    cum = saturating_cumsum(counts)
    total = jnp.minimum(cum[-1], cap)
    starts = jnp.concatenate([jnp.zeros(1, cum.dtype), cum[:-1]])
    seg_of_start = jnp.arange(counts.shape[0], dtype=jnp.int32)
    marks = jnp.zeros(cap, jnp.int32)
    # Empty segments share a start position; max keeps the last (correct)
    # one. Out-of-range starts (>= cap) are dropped.
    marks = marks.at[jnp.minimum(starts, cap)].max(seg_of_start, mode="drop")
    seg = jax.lax.cummax(marks)
    e = jnp.arange(cap, dtype=jnp.int32)
    if not need_local:
        return seg, None, e < total
    if counts.shape[0] <= (1 << 16):
        # Small segment table: gather the start positions instead of a
        # second cap-sized cummax (small-table gathers ~2.5 ns/row vs
        # ~5 ms per 1M-element cummax — tools/microbench_scans.py).
        start_pos = starts[seg]
    else:
        is_start = jnp.concatenate(
            [jnp.ones(1, jnp.bool_), seg[1:] != seg[:-1]]
        )
        start_pos = jax.lax.cummax(jnp.where(is_start, e, 0))
    local = e - start_pos
    return seg, local, e < total


# ---------------------------------------------------------------------------
# 1. Triangle setup
# ---------------------------------------------------------------------------

# Near clipping: Vulkan clips 0 <= z_clip <= w_clip. With the infinite
# reverse-Z projection z_clip = znear (constant), so the z <= w plane IS the
# near plane (view depth >= znear, ndc.z <= 1); z >= 0 never clips. We clip
# against the signed distance s = w - z.


def _project(clip, config: RasterConfig):
    """Clip-space (..., 4) -> pixel coords + ndc z (y down, uv.wgsl cs_to_uv)."""
    w = clip[..., 3]
    inv_w = 1.0 / jnp.where(jnp.abs(w) > NEAR_EPS, w, NEAR_EPS)
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * config.width
    sy = (0.5 - ndc[..., 1] * 0.5) * config.height
    return sx, sy, ndc[..., 2]


def _front_face(sx, sy):
    """wgpu culls clockwise given front_face=Ccw (pass/visibility.rs:124).
    CCW in y-up NDC is negative signed area in y-down pixel space."""
    area2 = (sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0]) - (
        sy[..., 1] - sy[..., 0]
    ) * (sx[..., 2] - sx[..., 0])
    return area2 < 0.0


def setup_draw_records(
    meshes: MeshPoolData,
    instances: InstanceData,
    draws: DrawList,
    camera,
    config: RasterConfig,
    materials=None,
    inst_rec=None,
):
    """Setup phase A (per-DRAW, cheap): the fat per-draw record plus
    triangle counts and stream offsets.

    One fat record (mvp + offsets + instance id) -> a single 96 B gather
    per work item serves ALL draw-level data (gathers are row-rate bound;
    width is nearly free). The draw's stream START rides the record too,
    so position-within-draw needs no second gather
    (segment_ids_from_counts need_local=False).

    Split from the per-work-item phase (setup_work_slice) so the sharded
    raster can replicate this O(n_draws) part while partitioning the heavy
    per-triangle math across devices
    (parallel/sharding.rasterize_sharded)."""
    inst_ids = draws.instance  # (N,) -1 padded
    safe_inst = jnp.maximum(inst_ids, 0)
    if draws.mesh is not None:  # cull-time LOD selection (cull.select_lod)
        mesh_ids = jnp.maximum(draws.mesh, 0)
    else:
        mesh_ids = instances.mesh_id[safe_inst]
    n_tris = jnp.where(
        jnp.arange(inst_ids.shape[0]) < draws.count,
        meshes.index_count[mesh_ids] // 3,
        0,
    )  # (N,)

    view_proj = jnp.matmul(
        jnp.asarray(camera.projection), jnp.asarray(camera.view),
        precision=fastmath.HIGHEST,
    )
    mvp = fastmath.compose_mat4(view_proj, instances.transform)  # (N_inst,4,4)
    n_draws = inst_ids.shape[0]
    if materials is not None:
        bc_w = materials.base_color[instances.material_id[safe_inst], 3]
    else:
        bc_w = jnp.ones((n_draws,), jnp.float32)
    cum_draws = saturating_cumsum(n_tris)
    # f32-exact for every VALID work item (start < cap << 2^24); invalid
    # tail slots are masked downstream.
    draw_start = jnp.concatenate(
        [jnp.zeros(1, jnp.float32), cum_draws[:-1].astype(jnp.float32)]
    )
    cols = [
        mvp.reshape(-1, 16)[safe_inst],
        (meshes.base_index[mesh_ids] // 3).astype(jnp.float32)[:, None],
        meshes.base_index[mesh_ids].astype(jnp.float32)[:, None],
        safe_inst.astype(jnp.float32)[:, None],
        bc_w[:, None],
        draw_start[:, None],
        jnp.zeros((n_draws, 3), jnp.float32),
    ]
    if inst_rec is not None:
        # RasterConfig.fused_inst_rec: the f16 fused instance+material
        # record (12 u32, resolve._inst_rec_f16) rides the per-draw
        # record — ONE work-item gather already serves it, so the resolve
        # pass skips its per-pixel instance-record gather entirely.
        cols.append(
            jax.lax.bitcast_convert_type(inst_rec, jnp.float32)[safe_inst]
        )
    draw_rec = jnp.concatenate(cols, axis=-1)  # (N, 24|36) f32
    return draw_rec, n_tris, cum_draws


def setup_work_slice(
    tri_pos,
    tri_attr_packed,
    draw_rec,
    n_tris,
    cum_draws,
    config: RasterConfig,
    lo=0,
    num=None,
):
    """Setup phase B (per-WORK-ITEM, heavy): transform/clip/project/pack
    for the global work slots [lo, lo+num).

    Every operation here is per-slot (elementwise math + gathers along the
    slot axis), so a slice computes bit-identical values to the same rows
    of the full-capacity run — the property the sharded raster relies on:
    each device runs this over tri_capacity/N slots (1/N of the transform
    flops and gather rows) and the packed streams are then all-gathered
    (parallel/sharding.rasterize_sharded). `lo` may be a traced scalar
    (lax.axis_index). `tri_attr_packed` is only read when
    config.fused_resolve_rec."""
    cap = config.tri_capacity
    if num is None:
        num = cap
    draw_slot, _, valid = segment_ids_from_counts(
        n_tris, cap, need_local=False
    )
    full_range = isinstance(lo, int) and lo == 0 and num == cap
    if not full_range:
        draw_slot = jax.lax.dynamic_slice_in_dim(draw_slot, lo, num)
        valid = jax.lax.dynamic_slice_in_dim(valid, lo, num)
    slot_ids = lo + jnp.arange(num, dtype=jnp.int32)  # global work slots
    rec = draw_rec[draw_slot]  # (num, 24)
    inst = jnp.where(valid, rec[:, 18].astype(jnp.int32), 0)
    bc_cut = rec[:, 19] < 0.5  # base_color.w cutoff: drop the triangle
    local_tri = slot_ids - rec[:, 20].astype(jnp.int32)
    tri_pool = rec[:, 16].astype(jnp.int32) + local_tri
    idx_start = rec[:, 17].astype(jnp.int32) + 3 * local_tri

    # One 36 B de-indexed corner row per triangle.
    pos = tri_pos[jnp.where(valid, tri_pool, 0)].reshape(num, 3, 3)

    m = rec[:, :16].reshape(num, 4, 4)
    clip = fastmath.mat4_point4(m[:, None, :, :], pos)  # (num, 3, 4)

    # --- near-plane clipping (s = w - z > 0) ----------------------------
    s_dist = clip[..., 3] - clip[..., 2]
    is_in = s_dist > 0.0
    n_in = jnp.sum(is_in.astype(jnp.int32), axis=-1)

    r1 = jnp.argmax(is_in, axis=-1)
    r2 = (jnp.argmax(~is_in, axis=-1) + 1) % 3
    r = jnp.where(n_in == 1, r1, jnp.where(n_in == 2, r2, 0)).astype(jnp.int32)
    # Branchless rotation: static permutations + dense selects (a dynamic
    # take_along_axis here would be a 12-element/tri gather — element-rate
    # bound and ~50 ms/frame at 1M triangles).
    rot1 = clip[:, jnp.array([1, 2, 0])]
    rot2 = clip[:, jnp.array([2, 0, 1])]
    rsel = r[:, None, None]
    rclip = jnp.where(rsel == 1, rot1, jnp.where(rsel == 2, rot2, clip))
    a, b, c = rclip[:, 0], rclip[:, 1], rclip[:, 2]

    def lerp_to_plane(p, q):
        sp = p[..., 3] - p[..., 2]
        sq = q[..., 3] - q[..., 2]
        t = sp / jnp.where(jnp.abs(sp - sq) > 1e-20, sp - sq, 1e-20)
        return p + (q - p) * t[..., None]

    i_ab = lerp_to_plane(a, b)
    i_ac = lerp_to_plane(a, c)
    i_bc = lerp_to_plane(b, c)

    tri1 = jnp.where(
        (n_in == 3)[:, None, None],
        clip,
        jnp.where(
            (n_in == 2)[:, None, None],
            jnp.stack([a, b, i_bc], axis=1),
            jnp.stack([a, i_ab, i_ac], axis=1),
        ),
    )
    tri2 = jnp.stack([a, i_bc, i_ac], axis=1)  # only when n_in == 2

    sx1, sy1, z1 = _project(tri1, config)
    sx2, sy2, z2 = _project(tri2, config)
    alive1 = valid & (n_in >= 1) & _front_face(sx1, sy1) & ~bc_cut
    needs2 = valid & (n_in == 2) & ~bc_cut
    alive2 = needs2 & _front_face(sx2, sy2)

    rec1 = _pack_raster(sx1, sy1, z1, alive1, slot_ids)

    # Resolve record: ORIGINAL clip x/y/w per vertex + instance + idx_start
    # as f32 (exact < 2^24). Clip z is NOT stored: with the infinite
    # reverse-Z projection z_clip == znear (constant) and the homogeneous
    # barycentrics never read it. 48B rows gather ~25% faster than 64B.
    if getattr(config, "slim_rec", False):
        # Slim 24-col record (see RasterConfig.slim_rec): everything the
        # dense resolve needs in ONE 96 B row. Corner normals go to world
        # space HERE (at record rate, ~4x below pixel rate) so the 9-col
        # instance basis never has to reach resolve; the 12xf16 payload
        # carries the material scalars the fused instance record would
        # have supplied (resolve._inst_rec column order).
        if draw_rec.shape[-1] < 36:
            raise ValueError(
                "slim_rec needs the f16 instance record threaded through "
                "the draw record (rasterize(inst_rec=...))"
            )
        attr = tri_attr_packed[jnp.where(valid, tri_pool, 0)]  # (num,12) u32
        irec = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(rec[:, 24:36], jnp.uint32),
            jnp.float16,
        ).reshape(num, 24).astype(jnp.float32)
        basis = irec[:, :9].reshape(num, 1, 3, 3)
        n_c = encoding.decode_octahedral_32(attr[:, 6:9])  # (num, 3, 3)
        n_ws = fastmath.mat3_vec(basis, n_c)  # world-space corner normals
        n_enc = encoding.encode_octahedral_32(n_ws)  # (num, 3) u32
        pay = jnp.stack(
            [
                irec[:, 9],  # material id
                irec[:, 10],  # albedo texture id
                irec[:, 15],  # albedo tex width
                irec[:, 16],  # albedo tex height
                irec[:, 17], irec[:, 18], irec[:, 19],  # const emissive rgb
                irec[:, 20], irec[:, 21], irec[:, 22], irec[:, 23],  # mr
                irec[:, 12],  # base_color.a
            ],
            axis=-1,
        ).astype(jnp.float16)  # (num, 12)
        resolve1 = jnp.concatenate(
            [
                clip[:, :, jnp.array([0, 1, 3])].reshape(num, 9),
                jax.lax.bitcast_convert_type(attr[:, 0:6], jnp.float32),
                jax.lax.bitcast_convert_type(n_enc, jnp.float32),
                jax.lax.bitcast_convert_type(
                    jax.lax.bitcast_convert_type(
                        pay.reshape(num, 6, 2), jnp.uint32
                    ),
                    jnp.float32,
                ),
            ],
            axis=-1,
        )  # (num, 24)
    else:
        resolve_cols = [
            clip[:, :, jnp.array([0, 1, 3])].reshape(num, 9),
            inst.astype(jnp.float32)[:, None],
            idx_start.astype(jnp.float32)[:, None],
            jnp.zeros((num, 1), jnp.float32),
        ]
        if config.fused_resolve_rec:
            # fold the corner-attribute row in (one setup-time gather per
            # work item buys resolve one fewer per-pixel big-table gather)
            attr = tri_attr_packed[jnp.where(valid, tri_pool, 0)]
            resolve_cols.append(
                jax.lax.bitcast_convert_type(attr, jnp.float32)
            )
            if draw_rec.shape[-1] >= 36:
                # fused_inst_rec: the instance+material columns copied from
                # the per-draw record (already gathered above as `rec`)
                resolve_cols.append(rec[:, 24:36])
        resolve1 = jnp.concatenate(resolve_cols, axis=-1)

    # ONE packed 40 B row per slot serves the extras compaction downstream
    # (sx2/sy2/z2/alive2 in one gather — row-rate bound, width nearly
    # free).
    extra_geom = jnp.concatenate(
        [sx2, sy2, z2, alive2[:, None].astype(jnp.float32)], axis=-1
    )  # (num, 10)

    return dict(
        rec1=rec1,
        resolve1=resolve1,
        sx1=sx1,
        sy1=sy1,
        z1=z1,
        needs2=needs2,
        extra_geom=extra_geom,
    )


def _pack_raster(sxv, syv, zv, alivev, ids):
    """Affine coefficient record: e_k(p) = ax_k*px + ay_k*py + b_k and
    the depth plane, in a per-triangle anchor frame (bbox corner) so
    products stay at triangle magnitude; binning re-bases b to each
    pair's tile origin. Dead records zero out with bd = -1 so their
    candidates never win."""
    idf = jnp.where(alivev, ids.astype(jnp.float32), -1.0)
    n = sxv.shape[0]
    anchor_x = jnp.floor(jnp.min(sxv, axis=-1))
    anchor_y = jnp.floor(jnp.min(syv, axis=-1))
    rx = sxv - anchor_x[:, None]
    ry = syv - anchor_y[:, None]
    nxt = jnp.array([1, 2, 0])
    dx = rx[:, nxt] - rx  # (n, 3) per-edge deltas
    dy = ry[:, nxt] - ry
    ax = dy
    ay = -dx
    b = ry * dx - rx * dy
    area2 = dy[:, 0] * dx[:, 1] - dx[:, 0] * dy[:, 1]  # = e0+e1+e2
    inv = 1.0 / jnp.where(jnp.abs(area2) > 1e-20, area2, 1e-20)
    # depth = (e1 z0 + e2 z1 + e0 z2) / area2, coefficient-wise
    zrot = zv[:, jnp.array([2, 0, 1])]  # weight of edge k is z[(k+2)%3]
    axd = jnp.sum(ax * zrot, axis=-1) * inv
    ayd = jnp.sum(ay * zrot, axis=-1) * inv
    bd = jnp.sum(b * zrot, axis=-1) * inv
    dead = ~alivev
    # zmax bounds the affine depth in the kernels: the precomputed
    # 1/area2 in the depth coefficients loses the per-pixel form's
    # convexity, so a near-degenerate sliver could otherwise win the
    # reverse-Z competition with a catastrophically amplified depth.
    zmax = jnp.max(zv, axis=-1)
    rec = jnp.concatenate(
        [
            jnp.stack([ax[:, 0], ay[:, 0], b[:, 0],
                       ax[:, 1], ay[:, 1], b[:, 1],
                       ax[:, 2], ay[:, 2], b[:, 2],
                       axd, ayd, bd], axis=-1),
            idf[:, None],
            anchor_x[:, None],
            anchor_y[:, None],
            zmax[:, None],
        ],
        axis=-1,
    )
    return jnp.where(
        dead[:, None],
        jnp.concatenate(
            [jnp.zeros((n, 11), jnp.float32),
             jnp.full((n, 1), -1.0),  # bd
             jnp.full((n, 1), -1.0),  # idf
             jnp.zeros((n, 3), jnp.float32)], axis=-1),
        rec,
    )


def setup_finalize(parts: dict, cum_draws, config: RasterConfig):
    """Setup phase C (stream-GLOBAL): compact the clipped second-triangles
    into the small extras region and emit the final packed streams. Needs
    the FULL work stream — phase-B parts covering all tri_capacity slots,
    either from one full-range setup_work_slice call or all-gathered
    device slices (the order restored by a tiled all_gather is the slot
    order, so the result is bit-identical either way)."""
    cap = config.tri_capacity
    cum = cum_draws
    tri_total = jnp.minimum(cum[-1], cap)

    # Clipped second-triangles go to a SMALL separate region selected by
    # sort + gather instead of a capacity-wide scatter of 16-float rows.
    # Extras are rare; give them cap/8 slots.
    ecap = cap // 8
    needs2 = parts["needs2"]
    n_extras = jnp.sum(needs2.astype(jnp.int32))
    overflow = jnp.maximum(cum[-1] - cap, 0) + jnp.maximum(n_extras - ecap, 0)
    # parent indices: one-operand fused-key compaction (same ascending
    # True-first order as stable argsort at half the sort cost)
    extra_src = fastmath.compact_indices(needs2, ecap)
    valid_extra = jnp.arange(ecap) < jnp.minimum(n_extras, ecap)

    extra_ids = cap + jnp.arange(ecap, dtype=jnp.int32)
    extra_geom = parts["extra_geom"][extra_src]  # (ecap, 10)
    sx2e, sy2e, z2e = extra_geom[:, 0:3], extra_geom[:, 3:6], \
        extra_geom[:, 6:9]
    alive2e = extra_geom[:, 9] > 0.5
    rec2 = _pack_raster(
        sx2e, sy2e, z2e, alive2e & valid_extra, extra_ids,
    )
    raster_rec = jnp.concatenate([parts["rec1"], rec2])  # (cap + ecap, 16)

    resolve_rec = jnp.concatenate(
        [parts["resolve1"], parts["resolve1"][extra_src]]
    )

    work_total = jnp.minimum(tri_total, cap) + jnp.minimum(n_extras, ecap)
    # Screen-space vertices per work item (binning bboxes + test oracles);
    # the raster record itself carries only affine coefficients.
    sx = jnp.concatenate([parts["sx1"], sx2e])
    sy = jnp.concatenate([parts["sy1"], sy2e])
    sz = jnp.concatenate([parts["z1"], z2e])

    return dict(
        sx=sx,
        sy=sy,
        sz=sz,
        alive=raster_rec[:, fr.F_ID] >= 0.0,
        raster_rec=raster_rec,
        resolve_rec=resolve_rec,
        tri_total=work_total,
        setup_overflow=overflow,
    )


def triangle_setup(
    meshes: MeshPoolData,
    instances: InstanceData,
    draws: DrawList,
    camera,
    config: RasterConfig,
    materials=None,
    inst_rec=None,
):
    """Per-work-item triangle screen data, packed records, capacity padded.

    Composition of the three setup phases — setup_draw_records (per draw)
    -> setup_work_slice (per work item, full range here) -> setup_finalize
    (extras compaction + final streams) — kept separate so the sharded
    raster can partition phase B over devices while this single-device
    entry point stays byte-identical.

    `materials`: when given, triangles whose material base_color.w < 0.5 are
    dropped here — every fragment of such a triangle discards
    (visibility.wgsl:79), so the whole triangle can never write depth. The
    per-TEXEL albedo cutoff is handled downstream via second-candidate
    tracking (RasterConfig.alpha_mask) + resolve fallback."""
    draw_rec, n_tris, cum_draws = setup_draw_records(
        meshes, instances, draws, camera, config, materials=materials,
        inst_rec=inst_rec,
    )
    parts = setup_work_slice(
        meshes.tri_pos,
        meshes.tri_attr_packed
        if (config.fused_resolve_rec or getattr(config, 'slim_rec', False))
        else None,
        draw_rec,
        n_tris,
        cum_draws,
        config,
    )
    return setup_finalize(parts, cum_draws, config)


# ---------------------------------------------------------------------------
# 2. Binning
# ---------------------------------------------------------------------------


def bake_tile_origin(rec, tiles, config: RasterConfig, row_px_offset=0):
    """Re-base record b coefficients from the per-triangle anchor frame to
    each pair's tile origin: the kernels then evaluate edges/depth with
    tile-LOCAL pixel coordinates only. b' = b + ax*(tx0 - anchor_x) +
    ay*(ty0 - anchor_y); products stay at triangle/tile magnitude.
    `row_px_offset`: global pixel row of tile 0 (device-local tile ids in
    the sharded raster)."""
    tx0 = ((tiles % config.tiles_x) * config.tile_w).astype(jnp.float32)
    ty0 = (
        (tiles // config.tiles_x) * config.tile_h + row_px_offset
    ).astype(jnp.float32)
    offx = tx0 - rec[..., fr.F_ANCHOR]
    offy = ty0 - rec[..., fr.F_ANCHOR + 1]
    out = rec
    for q in range(4):  # e0, e1, e2, depth
        axc = rec[..., 3 * q]
        ayc = rec[..., 3 * q + 1]
        out = out.at[..., 3 * q + 2].add(axc * offx + ayc * offy)
    return out


def bin_triangles(setup: dict, config: RasterConfig):
    """(tri, tile) pairs -> per-tile field-major record blocks + counts."""
    TX, TY = config.tiles_x, config.tiles_y
    NT = config.n_tiles
    K = config.tile_tri_capacity
    E = config.pair_capacity

    sx, sy, alive = setup["sx"], setup["sy"], setup["alive"]
    x0 = jnp.floor(jnp.min(sx, axis=-1))
    x1 = jnp.ceil(jnp.max(sx, axis=-1))
    y0 = jnp.floor(jnp.min(sy, axis=-1))
    y1 = jnp.ceil(jnp.max(sy, axis=-1))
    on_screen = (x1 >= 0) & (y1 >= 0) & (x0 < config.width) & (y0 < config.height)
    alive = alive & on_screen

    tx0 = jnp.clip(x0.astype(jnp.int32) // config.tile_w, 0, TX - 1)
    tx1 = jnp.clip(x1.astype(jnp.int32) // config.tile_w, 0, TX - 1)
    ty0 = jnp.clip(y0.astype(jnp.int32) // config.tile_h, 0, TY - 1)
    ty1 = jnp.clip(y1.astype(jnp.int32) // config.tile_h, 0, TY - 1)
    bw = tx1 - tx0 + 1
    n_pairs = jnp.where(alive, bw * (ty1 - ty0 + 1), 0)

    # Packed bbox record: one gather at pair-expansion time.
    bbox_rec = jnp.stack([tx0, ty0, bw], axis=-1)  # (cap, 3) i32

    tri, local, pair_valid = segment_ids_from_counts(n_pairs, E)
    cum = saturating_cumsum(n_pairs)
    overflow = jnp.maximum(cum[-1] - E, 0)

    br = bbox_rec[tri]  # (E, 3)
    tile = (br[:, 1] + local // br[:, 2]) * TX + (br[:, 0] + local % br[:, 2])
    tile = jnp.where(pair_valid, tile, NT)

    tile_sorted, tri_sorted = jax.lax.sort_key_val(tile, tri)

    # Rank within tile without gathers: segment-start positions via cummax.
    e = jnp.arange(E, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), tile_sorted[1:] != tile_sorted[:-1]]
    )
    start_pos = jax.lax.cummax(jnp.where(is_start, e, 0))
    rank = e - start_pos
    in_cap = (rank < K) & (tile_sorted < NT)
    overflow = overflow + jnp.sum((rank >= K) & (tile_sorted < NT), dtype=jnp.int32)

    dest = jnp.where(in_cap, tile_sorted * K + rank, NT * K + e)
    tile_tris = jnp.full((NT * K,), -1, jnp.int32)
    tile_tris = tile_tris.at[dest].set(tri_sorted, mode="drop", unique_indices=True)
    tile_tris = tile_tris.reshape(NT, K)

    counts = jnp.searchsorted(
        tile_sorted, jnp.arange(1, NT + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32) - jnp.searchsorted(
        tile_sorted, jnp.arange(NT, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    counts = jnp.minimum(counts, K)

    # Gather packed raster records -> (NT, K, RECORD_F), then bake the
    # coefficient b's to each tile's origin.
    rec = setup["raster_rec"]
    safe = jnp.maximum(tile_tris, 0)
    blocks = rec[safe.reshape(-1)].reshape(NT, K, fr.RECORD_F)
    blocks = bake_tile_origin(
        blocks, jnp.arange(NT, dtype=jnp.int32)[:, None], config
    )
    # Invalidate empty slots via the id field.
    blocks = blocks.at[:, :, fr.F_ID].set(
        jnp.where(tile_tris >= 0, blocks[:, :, fr.F_ID], -1.0)
    )
    return blocks, counts, overflow  # (NT, K, RECORD_F)


# ---------------------------------------------------------------------------
# 3. Fine raster + assembly
# ---------------------------------------------------------------------------


def bin_triangles_pairs(setup: dict, config: RasterConfig, ty_range=None):
    """Pair-centric binning: tile-sorted records + per-tile ranges, no
    per-tile capacity (feeds ops/fine_raster.fine_raster_pairs).

    Two-stream pair construction (few capacity-sized scans and scatters,
    one sort): every triangle's FIRST tile is a direct
    1:1 slot (no expansion at all); only multi-tile triangles (~15% of a
    typical scene) are compacted by a sort and expanded at
    pair_capacity/4 scale, cutting the expansion scans 4x.

    `ty_range=(ty_lo, rows)`: bin only the `rows` tile-rows starting at
    tile-row `ty_lo` (ty_lo may be traced — the sharded raster passes
    `jax.lax.axis_index`). Tile ids in the output are LOCAL to the range;
    record b coefficients are still baked to GLOBAL pixel origins."""
    TX, TY = config.tiles_x, config.tiles_y
    if ty_range is None:
        NT = config.n_tiles
        ty_lo, row_px_offset = 0, 0
    else:
        ty_lo, local_rows = ty_range
        NT = local_rows * TX
        row_px_offset = ty_lo * config.tile_h
    EB = config.pair_capacity // 4  # extra-pair stream capacity

    sx, sy, alive = setup["sx"], setup["sy"], setup["alive"]
    x0 = jnp.floor(jnp.min(sx, axis=-1))
    x1 = jnp.ceil(jnp.max(sx, axis=-1))
    y0 = jnp.floor(jnp.min(sy, axis=-1))
    y1 = jnp.ceil(jnp.max(sy, axis=-1))
    on_screen = (x1 >= 0) & (y1 >= 0) & (x0 < config.width) & (y0 < config.height)
    alive = alive & on_screen

    tx0 = jnp.clip(x0.astype(jnp.int32) // config.tile_w, 0, TX - 1)
    tx1 = jnp.clip(x1.astype(jnp.int32) // config.tile_w, 0, TX - 1)
    ty0 = jnp.clip(y0.astype(jnp.int32) // config.tile_h, 0, TY - 1)
    ty1 = jnp.clip(y1.astype(jnp.int32) // config.tile_h, 0, TY - 1)
    if ty_range is not None:
        # clamp to this device's tile rows; rebase to local row 0
        ty0 = jnp.maximum(ty0, ty_lo) - ty_lo
        ty1 = jnp.minimum(ty1, ty_lo + local_rows - 1) - ty_lo
        alive = alive & (ty1 >= ty0)
    bw = tx1 - tx0 + 1
    n_pairs = jnp.where(alive, bw * (ty1 - ty0 + 1), 0)
    bbox_rec = jnp.stack([tx0, ty0, bw], axis=-1)
    EA = n_pairs.shape[0]  # tri work items (tri_capacity + extras tail)

    if config.two_stream_bin:
        # Stream A: first tile per alive triangle, slot i <-> triangle i.
        tile_a = jnp.where(alive, ty0 * TX + tx0, NT)
        tri_a = jnp.arange(EA, dtype=jnp.int32)

        # Stream B: remaining tiles of multi-tile triangles, compacted.
        n_extra = jnp.maximum(n_pairs - 1, 0)
        has_extra = n_extra > 0
        parents = jnp.argsort(~has_extra, stable=True)[:EB]  # tri ids
        counts_b = jnp.where(has_extra[parents], n_extra[parents], 0)
        seg_b, local_b, valid_b = segment_ids_from_counts(counts_b, EB)
        tri_b = parents[seg_b]
        br = bbox_rec[tri_b]  # monotonic-ish gather, small row
        k = local_b + 1  # tile within the parent bbox, skipping (0, 0)
        tile_b = (br[:, 1] + k // br[:, 2]) * TX + (br[:, 0] + k % br[:, 2])
        tile_b = jnp.where(valid_b, tile_b, NT)

        # Pairs not placed in B (parents beyond the EB compaction window
        # have counts_b == 0 there, so total_extra - placed covers them
        # too). f32 accumulation: exact while < 2^24, immune to i32 wrap.
        total_extra = jnp.sum(n_extra.astype(jnp.float32))
        placed_b = jnp.minimum(jnp.sum(counts_b.astype(jnp.float32)), EB)
        overflow = jnp.maximum(
            total_extra - placed_b.astype(jnp.float32), 0.0
        ).astype(jnp.int32)

        tile = jnp.concatenate([tile_a, tile_b])
        tri = jnp.concatenate([tri_a, tri_b])
    else:
        # Single-stream general expansion (scan-heavy baseline).
        E = config.pair_capacity
        tri, local, pair_valid = segment_ids_from_counts(n_pairs, E)
        cum = saturating_cumsum(n_pairs)
        overflow = jnp.maximum(cum[-1] - E, 0)
        br = bbox_rec[tri]
        tile = (br[:, 1] + local // br[:, 2]) * TX + (
            br[:, 0] + local % br[:, 2]
        )
        tile = jnp.where(pair_valid, tile, NT)

    if config.sort_payload:
        # Sort all RECORD_F record fields ALONG with the tile key instead
        # of gathering records afterwards (kept as an option; measured
        # slower than the 64 B gather on the north-star scene). All 16
        # fields must ride the sort: dropping F_ZMAX zeroes the sliver
        # guard, which clamps depth to min(d, 0) and blanks the frame.
        rec_pairs = setup["raster_rec"][tri]  # monotonic gather, (E, 16)
        ops = jax.lax.sort(
            (tile,) + tuple(rec_pairs[:, f] for f in range(fr.RECORD_F)),
            num_keys=1,
        )
        tile_sorted = ops[0]
        rec_sorted = jnp.stack(list(ops[1:]), axis=-1)
    else:
        tile_sorted, tri_sorted = jax.lax.sort_key_val(tile, tri)
        rec_sorted = setup["raster_rec"][tri_sorted]  # (E, 16), tile order
    rec_sorted = bake_tile_origin(
        rec_sorted, tile_sorted, config, row_px_offset=row_px_offset
    )
    bounds = jnp.searchsorted(
        tile_sorted, jnp.arange(NT + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    starts = bounds[:-1]
    counts = bounds[1:] - bounds[:-1]
    return rec_sorted, starts, counts, overflow


def fine_raster_xla(records, counts, config: RasterConfig, track2: bool = False):
    """Pure-XLA reference fine raster over per-tile record blocks.

    The plain twin of ops/fine_raster.fine_raster_pairs: affine-coefficient
    records with b baked to each tile's origin (bin_triangles), the same
    depth/id competition, but over a fixed tile_tri_capacity per tile —
    it pays for capacity, and drops pairs past it (counted as overflow).
    """
    NT, K, F = records.shape
    PX = config.tile_h * config.tile_w
    lane = jnp.arange(PX, dtype=jnp.float32)
    px = (jnp.mod(lane, config.tile_w) + 0.5)[None, None, :]  # (1, 1, PX)
    py = (jnp.floor(lane / config.tile_w) + 0.5)[None, None, :]

    G = fr.TRI_GROUP

    def body(g, carry):
        best_d, best_i = carry[0], carry[1]
        blk = jax.lax.dynamic_slice(records, (0, g * G, 0), (NT, G, F))

        def fld(f):
            return blk[:, :, f][:, :, None]  # (NT, G, 1)

        idf = fld(fr.F_ID)
        in_count = (g * G + jnp.arange(G))[None, :, None] < counts[:, None, None]

        e0 = fld(0) * px + fld(1) * py + fld(2)
        e1 = fld(3) * px + fld(4) * py + fld(5)
        e2 = fld(6) * px + fld(7) * py + fld(8)
        depth = jnp.minimum(
            fld(fr.F_D) * px + fld(fr.F_D + 1) * py + fld(fr.F_D + 2),
            fld(fr.F_ZMAX),  # sliver guard (see pack_raster)
        )
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (idf >= 0) & in_count
        cand = jnp.where(inside, depth, -1.0)
        gmax = jnp.max(cand, axis=1)  # (NT, PX)
        gid = jnp.max(jnp.where(cand == gmax[:, None, :], idf, -1.0), axis=1)
        take = gmax > best_d
        nd = jnp.where(take, gmax, best_d)
        ni = jnp.where(take, gid, best_i)
        if not track2:
            return nd, ni
        best_d2, best_i2 = carry[2], carry[3]
        c2 = jnp.where(cand == gmax[:, None, :], -1.0, cand)
        g2 = jnp.max(c2, axis=1)
        g2id = jnp.max(jnp.where(c2 == g2[:, None, :], idf, -1.0), axis=1)
        g2id = jnp.where(g2 > 0.0, g2id, -1.0)
        # Demoted best; a cross-group bit-equal winner (gmax == best_d,
        # take False) is a tie of the overall winner and must collapse,
        # same as the within-group c2 mask (see ops/fine_raster.py).
        lv = jnp.where(take, best_d, jnp.where(gmax == best_d, -1.0, gmax))
        li = jnp.where(take, best_i, gid)
        t2 = g2 > best_d2
        m2v = jnp.where(t2, g2, best_d2)
        m2i = jnp.where(t2, g2id, best_i2)
        t3 = lv > m2v
        return nd, ni, jnp.where(t3, lv, m2v), jnp.where(t3, li, m2i)

    zeros = jnp.zeros((NT, PX), jnp.float32)
    negs = jnp.full((NT, PX), -1.0)
    init = (zeros, negs, zeros, negs) if track2 else (zeros, negs)
    return jax.lax.fori_loop(0, K // G, body, init)


def _untile(depth, trif, config: RasterConfig):
    NT = config.n_tiles
    TY, TX = config.tiles_y, config.tiles_x
    th, tw = config.tile_h, config.tile_w

    def untile(a):
        return (
            a[:NT]
            .reshape(TY, TX, th, tw)
            .transpose(0, 2, 1, 3)
            .reshape(TY * th, TX * tw)
        )

    return untile(depth), untile(trif).astype(jnp.int32)


def rasterize(
    meshes: MeshPoolData,
    instances: InstanceData,
    draws: DrawList,
    camera,
    config: RasterConfig,
    materials=None,
    inst_rec=None,
) -> VisBuffer:
    track2 = config.alpha_mask
    setup = triangle_setup(meshes, instances, draws, camera, config,
                           materials=materials, inst_rec=inst_rec)
    if config.backend == "pallas":
        # pair-centric path: no per-tile capacity
        rec_sorted, starts, counts, overflow = bin_triangles_pairs(setup, config)
        outs = fr.fine_raster_pairs(
            rec_sorted, starts, counts,
            interpret=config.interpret, track2=track2,
        )
    else:
        records, counts, overflow = bin_triangles(setup, config)
        outs = fine_raster_xla(records, counts, config, track2=track2)
    depth, tri_id = _untile(outs[0], outs[1], config)
    tri_id2 = depth2 = None
    if track2:
        depth2, tri_id2 = _untile(outs[2], outs[3], config)
    H, W = config.height, config.width
    return VisBuffer(
        tri_id=tri_id[:H, :W],
        depth=depth[:H, :W],
        resolve_rec=setup["resolve_rec"],
        overflow=overflow + setup["setup_overflow"],
        tri_id2=None if tri_id2 is None else tri_id2[:H, :W],
        depth2=None if tri_id2 is None else depth2[:H, :W],
    )
