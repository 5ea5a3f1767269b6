"""Bindless-style texture pool — texel-quad packed.

The reference binds up to 1024 textures as a `binding_array` sampled by
material index (pools/src/texture.rs:29-161). Here every texel fetch is
an XLA gather rather than a texture-unit sample, so the pool layout is
built around "one gather row per bilinear tap":

* every texel stores its full 2x2 bilinear neighborhood as one 16-byte row
  (RGBA8 x [c00, c10, c01, c11]) with wrap addressing baked in at build
  time — a bilinear sample is ONE gather + VPU lerps, not 4 gathers;
* all mip levels of all textures live in a single flattened row axis:
  row(t, level, y0, x0) = t * TOTAL + level_offset[level] + y0 * stride + x0
  so the mip level is a dynamic index (trilinear = 2 gathers);
* texels are stored in their source encoding (sRGB for color maps, linear
  for data maps) and decoded AFTER filtering per a per-texture flag —
  8-bit quality, matching standard GPU texture precision.

The same quad trick packs small f32 LUTs (the LTC tables) with
clamp-to-edge baked in.

Sampler semantics match the reference default sampler (app.rs:43-56):
repeat addressing, bilinear filtering, linear mip blending.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import checks

WHITE_TEXTURE = 0
BLACK_TEXTURE = 1
LTC1_TEXTURE = 2
LTC2_TEXTURE = 3
MAX_TEXTURES = 1024

_SRGB_BREAK = 0.04045

# Pools whose flattened quad table reaches this many rows also carry the
# 16 B split twins (see TexturePoolData.quads_child). DISABLED by
# default: a single 8.39M x 16 B probe measured 2.39 ns/row (vs ~18 for
# 32 B) suggesting a fast path, but the confirmation run
# (tools/r5_cliff16.py, repeats) found the PAIRED child+parent fetch —
# the actual trilinear use case — costs 20-26 ns per row-pair at
# 5.6-11.2M rows, i.e. WORSE than one 32 B gather (18.7); the 2.39 was a
# one-off tier. Machinery + tests kept (thresh monkeypatched there);
# single-table 16 B fetches do run ~12 ns at 11M, so a bilinear-only
# big-pool path could still use the child twin if one ever dominates.
_SPLIT_MIN_ROWS = 1 << 62


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(c <= _SRGB_BREAK, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(
        c <= 0.0031308, c * 12.92, 1.055 * np.maximum(c, 1e-10) ** (1 / 2.4) - 0.055
    ).astype(np.float32)


def linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    """jnp version (final blit path, blit.wgsl)."""
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(
        c <= 0.0031308, c * 12.92, 1.055 * jnp.maximum(c, 1e-10) ** (1 / 2.4) - 0.055
    )


def srgb_to_linear_jnp(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(
        c <= _SRGB_BREAK, c / 12.92, ((c + 0.055) / 1.055) ** 2.4
    )


def _mip_sizes(base: int) -> List[int]:
    sizes = [base]
    while sizes[-1] > 1:
        sizes.append(sizes[-1] // 2)
    return sizes


def pool_device_bytes(n_textures: int, pool_size: int,
                      blocks: bool = False) -> int:
    """HBM bytes of the TexturePoolData quad tables for `n_textures`
    slots at pool size S=`pool_size`: one 32 B quad row per texel over
    the flattened mip chain (sum of s^2 over mips ~= (4/3) S^2 rows),
    doubled when the pool crosses _SPLIT_MIN_ROWS (the 16 B split twins
    duplicate the bytes), tripled on top when the 4x4 tap-block tables
    are built. The Sponza-scale budget check (tests/test_stress.py) holds
    this against device HBM — at S=1024 a slot costs ~44.7 MB, so a
    ~100-texture scene fits a 16 GB device only with blocks=False
    (bench.run_preset builds blocks solely when the tuned variant taps
    them)."""
    total_rows = sum(s * s for s in _mip_sizes(pool_size))
    per_slot = total_rows * 32  # quads (T, total, 32) u8
    split = 2 if n_textures * total_rows >= _SPLIT_MIN_ROWS else 1
    return n_textures * per_slot * ((3 if blocks else 1) + split - 1)


def _downsample2x2(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    if h == 1 and w == 1:
        return img
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h > 1 and w > 1:
        return img[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
    if h == 1:
        return img[:, : nw * 2].reshape(1, nw, 2, -1).mean(axis=2)
    return img[: nh * 2].reshape(nh, 2, 1, -1).mean(axis=1)


def _upsample_to_child(parent: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """Bilinearly sample the parent level at this level's texel centers."""
    ph, pw = parent.shape[:2]
    if ph == ch and pw == cw:
        return parent
    py = np.clip((np.arange(ch) + 0.5) * ph / ch - 0.5, 0, ph - 1)
    px = np.clip((np.arange(cw) + 0.5) * pw / cw - 0.5, 0, pw - 1)
    y0 = np.floor(py).astype(int)
    x0 = np.floor(px).astype(int)
    y1 = np.minimum(y0 + 1, ph - 1)
    x1 = np.minimum(x0 + 1, pw - 1)
    ty = (py - y0)[:, None, None]
    tx = (px - x0)[None, :, None]
    a = parent[y0][:, x0] * (1 - tx) + parent[y0][:, x1] * tx
    b = parent[y1][:, x0] * (1 - tx) + parent[y1][:, x1] * tx
    return a * (1 - ty) + b * ty


def _quad_rows(img: np.ndarray, wrap: bool) -> np.ndarray:
    """(h, w, 4) -> (h, w, 16): each texel's 2x2 neighborhood, edge-baked."""
    if wrap:
        xn = np.roll(img, -1, axis=1)
        yn = np.roll(img, -1, axis=0)
        xyn = np.roll(xn, -1, axis=0)
    else:
        xn = np.concatenate([img[:, 1:], img[:, -1:]], axis=1)
        yn = np.concatenate([img[1:], img[-1:]], axis=0)
        xyn = np.concatenate([xn[1:], xn[-1:]], axis=0)
    return np.concatenate([img, xn, yn, xyn], axis=-1)


@struct.dataclass
class TexturePoolData:
    # (T * TOTAL, 32) u8 per texel: [2x2 quad of this level | 2x2 quad of
    # the parent level resampled at this level's texel centers] — one 32 B
    # gather serves a full trilinear sample (the resampled-parent term is a
    # slightly wider kernel than true parent bilinear; visually identical).
    quads: jnp.ndarray
    size: jnp.ndarray  # (T, 2) i32 (w, h) at level 0
    max_lod: jnp.ndarray  # (T,) f32 highest meaningful mip per texture
    srgb: jnp.ndarray  # (T,) bool — decode rgb after filtering
    # (T * TOTAL, 64) u8: the texel's 4x4 wrap-baked neighborhood, child
    # level / resampled-parent — the quad-rate tap
    # (sample_trilinear_quadblock) fetches the 2x2 bilinear footprints of
    # FOUR screen pixels from one child + one parent block row. Derived
    # from `quads` (corner columns) at device() time.
    child_blocks: jnp.ndarray = None
    parent_blocks: jnp.ndarray = None
    # 16 B-row twins of `quads` (child half / parent half, same row
    # index), built when the pool crosses _SPLIT_MIN_ROWS: two 16 B gathers
    # in place of one 32 B gather. Identical bytes -> bit-exact.
    quads_child: jnp.ndarray = None
    quads_parent: jnp.ndarray = None
    level_offset: tuple = struct.field(pytree_node=False, default=None)
    base_size: int = struct.field(pytree_node=False, default=0)
    total: int = struct.field(pytree_node=False, default=0)
    # ((w, h), ...) host copy of `size` — per-texture metadata then rides
    # the compiled program as a where-CHAIN over the static ids instead of
    # a per-pixel table gather (gathers are row-rate bound: a 2M-pixel
    # metadata lookup costs ~10 ms however tiny the table; a <=64-term
    # VPU select chain is free). None after snapshot load of older files.
    host_sizes: tuple = struct.field(pytree_node=False, default=None)

    @property
    def count(self) -> int:
        return self.size.shape[0]


class TexturePool:
    def __init__(self, base_size: int = 1024):
        assert base_size & (base_size - 1) == 0
        self.base_size = base_size
        self.images: List[np.ndarray] = []  # u8 (h, w, 4), source encoding
        self.srgb_flags: List[bool] = []
        white = np.full((1, 1, 4), 255, np.uint8)
        black = np.zeros((1, 1, 4), np.uint8)
        black[..., 3] = 255
        # Reserved ids (texture.rs:10-13); LTC slots are placeholders — the
        # real LUTs are dedicated f32 quad tables on SceneData.
        for img in (white, black, white.copy(), white.copy()):
            self.images.append(img)
            self.srgb_flags.append(False)

    def __len__(self):
        return len(self.images)

    def has_mask(self, tex_id: int) -> bool:
        """Any texel with alpha below the 0.5 cutoff (visibility.wgsl:80)."""
        return bool((self.images[tex_id][..., 3] < 128).any())

    def is_const(self, tex_id: int) -> bool:
        """1x1 texture: any sample returns its single texel."""
        return self.images[tex_id].shape[:2] == (1, 1)

    def const_value(self, tex_id: int) -> np.ndarray:
        """(4,) linear-space value of a 1x1 texture (zeros if not 1x1) —
        exactly what sample_trilinear returns for it at any uv/lod."""
        if not self.is_const(tex_id):
            return np.zeros(4, np.float32)
        v = self.images[tex_id][0, 0].astype(np.float32) / 255.0
        if self.srgb_flags[tex_id]:
            c = v[:3]
            v = np.concatenate(
                [
                    np.where(c <= _SRGB_BREAK, c / 12.92,
                             ((c + 0.055) / 1.055) ** 2.4),
                    v[3:4],
                ]
            )
        return v.astype(np.float32)

    def add(self, image: np.ndarray, srgb: bool = False) -> int:
        """Add an (H, W, C) uint8/float image; returns its texture id."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img.astype(np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(
                np.uint8
            )
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full_like(img[..., :1], 255)], axis=-1
            )
        while img.shape[0] > self.base_size or img.shape[1] > self.base_size:
            img = _downsample2x2(img.astype(np.float32)).astype(np.uint8)
        if len(self.images) >= MAX_TEXTURES:
            raise ValueError("texture pool full")
        self.images.append(np.ascontiguousarray(img))
        self.srgb_flags.append(bool(srgb))
        return len(self.images) - 1

    def device(self, blocks: bool = True) -> TexturePoolData:
        # Size the pool to the largest ACTUAL texture (pow2): gather cost
        # grows with table size, and a pool of 1x1 debug textures must not
        # pay a 1024^2-mip-chain table.
        #
        # `blocks`: also build the 4x4 block tables for the quad-rate tap
        # (RasterConfig.tap_block) — 3x the pool bytes; pass False for
        # memory-constrained scenes (the tap then falls back to the
        # per-pixel quad rows).
        largest = max(max(i.shape[0], i.shape[1]) for i in self.images)
        S = 1
        while S < largest:
            S *= 2
        S = min(S, self.base_size)
        sizes = _mip_sizes(S)
        offsets = np.cumsum([0] + [s * s for s in sizes])[:-1]
        total = int(sum(s * s for s in sizes))
        # the samplers address levels with the _level_offset_closed
        # arithmetic identity instead of gathering this table — they must
        # agree exactly
        for li in range(len(sizes)):
            sl = max(S >> li, 1)
            assert offsets[li] == (4 * (S * S - sl * sl)) // 3, (
                li, offsets[li])
        T = len(self.images)
        quads = np.zeros((T, total, 32), np.uint8)
        wh = np.zeros((T, 2), np.int32)
        max_lod = np.zeros(T, np.float32)
        from ..native import pack_texture as native_pack

        for t, img in enumerate(self.images):
            h, w = img.shape[:2]
            wh[t] = (w, h)
            max_lod[t] = max(0, int(np.floor(np.log2(max(min(w, h), 1)))))
            # Native packer (C++ twin, ~5x faster device() on big
            # textures; texture upload is the reference's native-image-crate
            # hot path). Numpy below is the oracle and fallback — exact at
            # fine mips, deepest mips within a few u8 steps (accumulation
            # order).
            packed = native_pack(img, S, total)
            if packed is not None:
                quads[t] = packed
                continue
            # full level chain first
            levels = [img.astype(np.float32)]
            while min(levels[-1].shape[0], levels[-1].shape[1]) > 1:
                levels.append(_downsample2x2(levels[-1]))
            for li, s in enumerate(sizes):
                if li >= len(levels):
                    # propagate the 1x1 tail
                    row = quads[t, offsets[li - 1]]
                    sj = sizes[li]
                    quads[t, offsets[li] : offsets[li] + sj * sj] = row
                    continue
                level = levels[li]
                lh, lw = level.shape[:2]
                parent = levels[min(li + 1, len(levels) - 1)]
                par_rs = _upsample_to_child(parent, lh, lw)
                lvl_u8 = (level + 0.5).astype(np.uint8)
                par_u8 = (par_rs + 0.5).astype(np.uint8)
                q = np.concatenate(
                    [_quad_rows(lvl_u8, wrap=True), _quad_rows(par_u8, wrap=True)],
                    axis=-1,
                )
                block = quads[t, offsets[li] : offsets[li] + s * s].reshape(s, s, 32)
                block[:lh, :lw] = q[:s, :s]
        # 4x4 block tables for the quad-rate tap, derived from the packed
        # quads so native- and numpy-packed pools agree: corner c00 of a
        # quad row IS the texel, columns 16:20 its resampled-parent value.
        child_blocks = np.zeros((T, total, 64), np.uint8) if blocks else None
        parent_blocks = np.zeros((T, total, 64), np.uint8) if blocks else None
        for t in range(T if blocks else 0):
            w0, h0 = int(wh[t, 0]), int(wh[t, 1])
            for li, s in enumerate(sizes):
                lw, lh = max(w0 >> li, 1), max(h0 >> li, 1)
                rows = quads[t, offsets[li] : offsets[li] + s * s]
                grid = rows.reshape(s, s, 32)
                child = grid[:lh, :lw, 0:4]
                parent = grid[:lh, :lw, 16:20]

                def blk(img):
                    cols = [
                        np.roll(np.roll(img, -j, axis=0), -i, axis=1)
                        for j in range(4)
                        for i in range(4)
                    ]
                    return np.concatenate(cols, axis=-1)  # (lh, lw, 64)

                cb = child_blocks[t, offsets[li] : offsets[li] + s * s]
                pb = parent_blocks[t, offsets[li] : offsets[li] + s * s]
                cb.reshape(s, s, 64)[:lh, :lw] = blk(child)
                pb.reshape(s, s, 64)[:lh, :lw] = blk(parent)
        flat = quads.reshape(T * total, 32)
        split = T * total >= _SPLIT_MIN_ROWS
        return TexturePoolData(
            quads=jnp.asarray(flat),
            size=jnp.asarray(wh),
            max_lod=jnp.asarray(max_lod),
            srgb=jnp.asarray(np.asarray(self.srgb_flags, bool)),
            child_blocks=None if child_blocks is None else jnp.asarray(
                child_blocks.reshape(T * total, 64)),
            parent_blocks=None if parent_blocks is None else jnp.asarray(
                parent_blocks.reshape(T * total, 64)),
            quads_child=jnp.asarray(
                np.ascontiguousarray(flat[:, :16])) if split else None,
            quads_parent=jnp.asarray(
                np.ascontiguousarray(flat[:, 16:])) if split else None,
            level_offset=tuple(int(o) for o in offsets),
            base_size=S,
            total=total,
            host_sizes=tuple((int(w), int(h)) for w, h in wh),
        )


# ---------------------------------------------------------------------------
# Device-side sampling (inside jit)
# ---------------------------------------------------------------------------


# Where-chains longer than this fall back to the table gather: the VPU
# select chain is free per term, but compile time and code size grow
# linearly (config 6 has 108 textures; its taps keep the gather).
_CHAIN_MAX = 64


def _wh_chain(pool: TexturePoolData, tex_id):
    """Per-sample (w, h) as a compile-time where-chain over the pool's
    static host_sizes — replaces the pool.size per-pixel gather (~10 ms
    per 1080p tap however small the table; the chain is free VPU work).
    Returns None when the pool is too big for a chain or host metadata is
    unavailable (snapshot-loaded older files)."""
    if pool.host_sizes is None or len(pool.host_sizes) > _CHAIN_MAX:
        return None
    sizes = pool.host_sizes
    w = jnp.full(tex_id.shape, sizes[0][0], jnp.int32)
    h = jnp.full(tex_id.shape, sizes[0][1], jnp.int32)
    for k in range(1, len(sizes)):
        if sizes[k] == sizes[0]:
            continue
        sel = tex_id == k
        w = jnp.where(sel, sizes[k][0], w)
        h = jnp.where(sel, sizes[k][1], h)
    return w, h


def _level_offset_closed(base_size: int, level):
    """Row offset of mip `level` in a texture's flattened quad rows.

    offsets = cumsum((S >> k)^2) has the closed form
    (4/3) * (S^2 - (S >> l)^2) for pow2 S (exact integer: 4^k - 1 is
    divisible by 3) — an ARITHMETIC identity replacing the per-pixel
    level_offset[level] table gather (gathers are row-rate bound; a 2M-
    pixel 4 B lookup costs ~5 ms, the identity is free VPU work).
    Asserted equal to the built table in TexturePool.device()."""
    sl = jnp.maximum(base_size >> level, 1)
    return (4 * (base_size * base_size - sl * sl)) // 3


def derived_max_lod(w, h):
    """floor(log2(min(w, h))) — TexturePool.device()'s max_lod, derived
    from the level-0 extent so callers that already hold (w, h) (e.g. the
    resolve pass's fused instance record) skip the per-pixel max_lod table
    gather. The +0.5 nudge makes floor(log2) exact for every integer
    extent: exact powers land safely above the integer boundary, all
    other values stay below the next one (f32 log2 error ~1e-7 vs the
    ~7e-4 closest margin at 1024)."""
    m = jnp.minimum(w, h).astype(jnp.float32)
    return jnp.floor(jnp.log2(jnp.maximum(m, 1.0) + 0.5))


def _bilinear_level(pool: TexturePoolData, tex_id, uv, level, lod_frac=None,
                    wh=None):
    """One quad-gather (tri|bi)linear sample of a (dynamic) mip level.

    With `lod_frac`, blends toward the parent-resampled quad in the same
    32 B row — a full trilinear sample from ONE gather. Returns raw
    (source-encoded) color in [0, 1]. `wh`: the level-0 (w, h) per sample
    when the caller already holds it — skips the pool.size gather.
    """
    level = level.astype(jnp.int32)
    if wh is None:
        whg = pool.size[tex_id]  # (..., 2)
        w0, h0 = whg[..., 0], whg[..., 1]
    else:
        w0, h0 = wh
    lw = jnp.maximum(w0.astype(jnp.int32) >> level, 1)
    lh = jnp.maximum(h0.astype(jnp.int32) >> level, 1)
    stride = jnp.maximum(pool.base_size >> level, 1)
    off = _level_offset_closed(pool.base_size, level)

    fx = uv[..., 0] * lw.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * lh.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), lw)
    y0i = jnp.mod(y0.astype(jnp.int32), lh)

    idx = tex_id * pool.total + off + y0i * stride + x0i
    idx = checks.check_index(idx, pool.quads.shape[0], "texture.quads")

    def bilin(q, base):
        c00 = q[..., base : base + 4]
        c10 = q[..., base + 4 : base + 8]
        c01 = q[..., base + 8 : base + 12]
        c11 = q[..., base + 12 : base + 16]
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        return top + (bot - top) * ty

    scale = jnp.float32(1.0 / 255.0)
    if pool.quads_child is not None:
        # 16 B split twins: above the gather cliff two 16 B row fetches
        # run ~4x faster than one 32 B fetch — identical bytes, same
        # lerp order; samples are bit-exact, whole frames drift last-ulp
        # from XLA refusing/contracting the surrounding arithmetic
        # differently per layout (tests/test_texture_split.py budgets
        # both; goldens are u8-quantized and unaffected).
        child = bilin(pool.quads_child[idx].astype(jnp.float32) * scale, 0)
        if lod_frac is None:
            return child
        parent = bilin(
            pool.quads_parent[idx].astype(jnp.float32) * scale, 0
        )
        return child + (parent - child) * lod_frac[..., None]
    q = pool.quads[idx].astype(jnp.float32) * scale  # (..., 32)
    child = bilin(q, 0)
    if lod_frac is None:
        return child
    parent = bilin(q, 16)
    return child + (parent - child) * lod_frac[..., None]


def sample_trilinear(pool: TexturePoolData, tex_id, uv, lod=None,
                     trilinear=True, wh=None, srgb=None):
    """Texture sample with repeat wrap; returns linear-space (..., 4).

    The TEXEL cost is 1 quad-gather row per sample — but the naive form
    pays FOUR more per-pixel gathers for metadata (size, level offset,
    max_lod, srgb flag; each ~2.5-6.6 ns/row = ~5-13 ms/tap at 1080p).
    Callers that statically know the metadata pass it in and pay only the
    texel row:
      wh    — (w, h) level-0 extent per sample (e.g. from the resolve
              pass's fused instance record); max_lod + level addressing
              derive arithmetically (derived_max_lod/_level_offset_closed).
      srgb  — static bool when every texture this call site can touch
              shares one flag (SceneData.*_srgb statics; pure-{0,255}
              textures like WHITE/BLACK are sRGB fixed points and never
              block the static).
    """
    if wh is None:
        # static where-chain when the pool is small enough, else one
        # extent gather; max_lod and level offsets then derive
        # arithmetically (saves two more table gathers per sample)
        wh = _wh_chain(pool, tex_id)
    if wh is None:
        whg = pool.size[tex_id]
        wh = (whg[..., 0], whg[..., 1])
    if lod is None:
        raw = _bilinear_level(
            pool, tex_id, uv, jnp.zeros(uv.shape[:-1], jnp.int32), wh=wh
        )
    else:
        lod = jnp.clip(lod, 0.0, derived_max_lod(*wh))
        if trilinear:
            l0 = jnp.floor(lod)
            raw = _bilinear_level(
                pool, tex_id, uv, l0.astype(jnp.int32), lod_frac=lod - l0,
                wh=wh,
            )
        else:
            raw = _bilinear_level(
                pool, tex_id, uv, jnp.round(lod).astype(jnp.int32), wh=wh
            )
    # Post-filter sRGB decode (rgb only) where flagged.
    if srgb is None:
        decode = pool.srgb[tex_id][..., None]
        rgb = jnp.where(
            decode, srgb_to_linear_jnp(raw[..., :3]), raw[..., :3]
        )
    elif srgb:
        rgb = srgb_to_linear_jnp(raw[..., :3])
    else:
        rgb = raw[..., :3]
    return jnp.concatenate([rgb, raw[..., 3:4]], axis=-1)


def sample_trilinear_quadblock(pool: TexturePoolData, tex_id, uv, lod,
                               wh, srgb=None, capacity: int = 0):
    """Quad-rate trilinear tap over an (H, W) pixel grid: the 2x2 bilinear
    footprints of a 2x2 PIXEL quad land within ~1 texel of each other at a
    proper mip level, so ONE child-block + ONE parent-block 4x4 row (64 B
    each, pool.child_blocks/parent_blocks) serve all four pixels — 2
    gather rows per quad instead of 4.
    Quads that straddle a texture, mip level, wrap seam, or >3-texel
    spread go through a compacted per-pixel batch on the regular 32 B
    quad rows. BIT-IDENTICAL to sample_trilinear(..., wh=wh, srgb=srgb):
    same texels (the blocks bake the same wrap), same lerp and mip-blend
    order (tests/test_texture_meta.py).

    Returns (samples (H, W, 4) linear-space, edge-overflow count).
    """
    H, W = lod.shape
    Hq, Wq = H // 2, W // 2
    w0, h0 = wh
    lodc = jnp.clip(lod, 0.0, derived_max_lod(w0, h0))
    l0 = jnp.floor(lodc)
    frac = lodc - l0
    level = l0.astype(jnp.int32)
    lw = jnp.maximum(w0.astype(jnp.int32) >> level, 1)
    lh = jnp.maximum(h0.astype(jnp.int32) >> level, 1)
    stride = jnp.maximum(pool.base_size >> level, 1)
    off = _level_offset_closed(pool.base_size, level)
    fx = uv[..., 0] * lw.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * lh.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), lw)
    y0i = jnp.mod(y0.astype(jnp.int32), lh)
    tid = tex_id.astype(jnp.int32)
    idx_img = tid * pool.total + off + y0i * stride + x0i  # per-pixel row

    def q4(a):  # (H, W) -> (Hq, Wq, 2, 2)
        return a.reshape(Hq, 2, Wq, 2).transpose(0, 2, 1, 3)

    tex4, lev4 = q4(tid), q4(level)
    x4, y4 = q4(x0i), q4(y0i)
    bx = jnp.min(x4, axis=(2, 3))
    by = jnp.min(y4, axis=(2, 3))
    a00 = lambda a: a[:, :, 0, 0]  # noqa: E731 quad anchor
    uniform = (
        jnp.all(tex4 == tex4[:, :, :1, :1], axis=(2, 3))
        & jnp.all(lev4 == lev4[:, :, :1, :1], axis=(2, 3))
        & (jnp.max(x4, axis=(2, 3)) - bx <= 2)
        & (jnp.max(y4, axis=(2, 3)) - by <= 2)
    )
    bidx = (
        a00(q4(tid)) * pool.total + a00(q4(off))
        + by * a00(q4(stride)) + bx
    )
    scale = jnp.float32(1.0 / 255.0)
    bidx = checks.check_index(
        bidx, pool.child_blocks.shape[0], "texture.blocks"
    )
    cb = (pool.child_blocks[bidx].astype(jnp.float32) * scale).reshape(
        Hq, Wq, 4, 4, 4
    )  # [j, i, rgba]
    pb = (pool.parent_blocks[bidx].astype(jnp.float32) * scale).reshape(
        Hq, Wq, 4, 4, 4
    )
    ox = jnp.clip(x4 - bx[..., None, None], 0, 2)
    oy = jnp.clip(y4 - by[..., None, None], 0, 2)
    oh_y = (oy[..., None] == jnp.arange(3)).astype(jnp.float32)
    oh_x = (ox[..., None] == jnp.arange(3)).astype(jnp.float32)

    def corner(blk, dy, dx):  # (Hq, Wq, 2, 2, 4) one-hot select
        sub = blk[:, :, dy : dy + 3, dx : dx + 3, :]
        return jnp.einsum("hwjic,hwpqj,hwpqi->hwpqc", sub, oh_y, oh_x,
                          precision=jax.lax.Precision.HIGHEST)

    def unq(a):  # (Hq, Wq, 2, 2, 4) -> (H, W, 4)
        return a.transpose(0, 2, 1, 3, 4).reshape(H, W, 4)

    def bilin(blk):
        c00 = unq(corner(blk, 0, 0))
        c10 = unq(corner(blk, 0, 1))
        c01 = unq(corner(blk, 1, 0))
        c11 = unq(corner(blk, 1, 1))
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        return top + (bot - top) * ty

    child = bilin(cb)
    parent = bilin(pb)
    raw = child + (parent - child) * frac[..., None]

    # edge quads: per-pixel 32 B quad rows, scattered back
    F = capacity or max(Hq * Wq // 4, 1024)
    flat = (~uniform).reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    from ..core.fastmath import compact_indices

    qidx = compact_indices(flat, F)
    valid = jnp.arange(F) < jnp.minimum(count, F)
    qy = qidx // Wq
    qx = qidx - qy * Wq
    py = jnp.concatenate([qy * 2, qy * 2, qy * 2 + 1, qy * 2 + 1])
    px = jnp.concatenate([qx * 2, qx * 2 + 1, qx * 2, qx * 2 + 1])
    pix = py * W + px  # (4F,)
    # ONE packed 16 B per-pixel row (idx bit-cast + tx/ty/frac) instead of
    # four separate element gathers — gathers are row-rate bound, and the
    # bitcast transports the i32 index exactly (no arithmetic on the f32).
    epack = jnp.stack(
        [
            jax.lax.bitcast_convert_type(idx_img, jnp.float32),
            tx[..., 0], ty[..., 0], frac,
        ],
        axis=-1,
    ).reshape(-1, 4)  # (H*W, 4) f32
    eg = epack[pix]  # (4F, 4)
    idx_e = jax.lax.bitcast_convert_type(eg[:, 0], jnp.int32)
    idx_e = checks.check_index(idx_e, pool.quads.shape[0],
                               "texture.quads_edge")
    qrow = pool.quads[idx_e].astype(jnp.float32) * scale  # (4F, 32)
    txe = eg[:, 1:2]
    tye = eg[:, 2:3]

    def bilin_e(base):
        c00 = qrow[:, base : base + 4]
        c10 = qrow[:, base + 4 : base + 8]
        c01 = qrow[:, base + 8 : base + 12]
        c11 = qrow[:, base + 12 : base + 16]
        top = c00 + (c10 - c00) * txe
        bot = c01 + (c11 - c01) * txe
        return top + (bot - top) * tye

    frace = eg[:, 3:4]
    ch_e = bilin_e(0)
    vals = ch_e + (bilin_e(16) - ch_e) * frace
    widx = jnp.where(jnp.concatenate([valid] * 4), pix, H * W)
    raw = (
        raw.reshape(H * W, 4).at[widx].set(vals, mode="drop")
        .reshape(H, W, 4)
    )

    if srgb is None:
        decode = pool.srgb[tid][..., None]
        rgb = jnp.where(
            decode, srgb_to_linear_jnp(raw[..., :3]), raw[..., :3]
        )
    elif srgb:
        rgb = srgb_to_linear_jnp(raw[..., :3])
    else:
        rgb = raw[..., :3]
    out = jnp.concatenate([rgb, raw[..., 3:4]], axis=-1)
    return out, jnp.maximum(count - F, 0)


def pack_lut_quads(table: np.ndarray) -> np.ndarray:
    """(H, W, 4) f32 LUT -> (H*W, 16) f32 quad rows, clamp-to-edge baked."""
    return _quad_rows(np.asarray(table, np.float32), wrap=False).reshape(-1, 16)


def sample_lut_bilinear(quads: jnp.ndarray, width: int, uv: jnp.ndarray,
                        channels: int = 4):
    """One-gather clamp-to-edge bilinear fetch from a packed f32 LUT.

    `channels` > 4 samples several tables packed side by side (their quad
    rows concatenated along the last axis); corners interleave per table.
    """
    h = quads.shape[0] // width
    fx = uv[..., 0] * width - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, width - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    q = quads[y0i * width + x0i]
    if channels != 4:
        # (..., ntab*16) -> per-corner (..., ntab*4)
        ntab = channels // 4
        qs = q.reshape(*q.shape[:-1], ntab, 4, 4)  # (..., tab, corner, rgba)
        corners = [
            qs[..., :, c, :].reshape(*q.shape[:-1], ntab * 4) for c in range(4)
        ]
        c00, c10, c01, c11 = corners
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        return top + (bot - top) * ty
    c00, c10, c01, c11 = q[..., 0:4], q[..., 4:8], q[..., 8:12], q[..., 12:16]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty
