"""Independent end-to-end image oracle.

A deliberately simple numpy renderer written directly from the reference
WGSL semantics and the Vulkan/wgpu rasterization rules:

* vertex transform + G-buffer fragment ... shaders/visibility.wgsl:32-91
* deferred lighting ..................... shaders/shading.wgsl:36-118
* LTC rect area lights .................. shaders/utils/ltc.wgsl:49-192
* octahedral-32 / pack2x16float ......... shaders/utils/encoding.wgsl:4-28
* world position from depth ............. shaders/utils/uv.wgsl:13-22
* sharpen + neutral tonemap ............. shaders/postprocess.wgsl:21-98
* YCbCr / luma .......................... shaders/utils/color.wgsl
* pixel-center coverage, reverse-Z GREATER depth test, back-face cull of
  clockwise triangles (front_face=Ccw), perspective-correct
  interpolation, near clipping at z_clip <= w ... wgpu/Vulkan raster
  rules + crates/app/src/pass/visibility.rs:124,130

No production rendering code is reused — every formula here is re-derived
from the cited shader lines.  Only INPUT data is shared with the
production renderer (World host arrays, the camera uniform, the fitted
LTC tables, the texture pool's mip pyramids — all asset preparation, not
per-frame semantics), so agreement between this oracle and the production
frame anchors the production renderer to reference behavior instead of to
its own goldens.

This is a test fixture: clarity over speed (pure numpy, a Python loop
per triangle).  Known, bounded divergences from the production frame are
listed in tests/test_oracle.py; the comparison budget is image-level
(mean diff < 1e-2), never bit-level — two independently written
rasterizers legitimately disagree on edge/tie pixels.
"""

from __future__ import annotations

import numpy as np

LIGHT_MATERIAL = 2  # shared.wgsl:1
LUT_SIZE = 64.0  # ltc.wgsl:39
LUT_SCALE = (LUT_SIZE - 1.0) / LUT_SIZE  # ltc.wgsl:40
LUT_BIAS = 0.5 / LUT_SIZE  # ltc.wgsl:41


# ---------------------------------------------------------------------------
# color (sRGB EOTF per the sRGB spec; utils/color.wgsl luma/ycbcr)
# ---------------------------------------------------------------------------


def srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = np.clip(np.asarray(c, np.float32), 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def calculate_luma(col):
    return col @ np.array([0.2126, 0.7152, 0.0722], np.float32)


_YCBCR = np.array(  # rgb_to_ycbcr: col * mat3x3(rows as written) — WGSL
    # v * M multiplies the vector by ROWS of column-major M, i.e. M^T @ v;
    # writing the 9 literals row-major and using col @ M reproduces it.
    [[0.2126, 0.7152, 0.0722], [-0.1146, -0.3854, 0.5], [0.5, -0.4542, -0.0458]],
    np.float32,
)
_YCBCR_INV = np.array(
    [[1.0, 0.0, 1.5748], [1.0, -0.1873, -0.4681], [1.0, 1.8556, 0.0]],
    np.float32,
)


def rgb_to_ycbcr(col):
    return col @ _YCBCR.T


def ycbcr_to_rgb(col):
    return col @ _YCBCR_INV.T


# ---------------------------------------------------------------------------
# encoding (utils/encoding.wgsl)
# ---------------------------------------------------------------------------

_PRES = 16
_MU = (1 << _PRES) - 1


def encode_octahedral_32(n):
    """encoding.wgsl:4-15. n: (..., 3) normalized."""
    n = np.asarray(n, np.float32)
    s = np.abs(n[..., 0]) + np.abs(n[..., 1]) + np.abs(n[..., 2])
    nor = n / np.maximum(s[..., None], 1e-30)
    xy = (1.0 - np.abs(nor[..., [1, 0]])) * np.sign(nor[..., [0, 1]])
    low = nor[..., 2] < 0.0
    v = np.where(low[..., None], xy, nor[..., :2]) * 0.5 + 0.5
    d = np.floor(v * np.float32(_MU) + 0.5).astype(np.uint32)
    return (d[..., 1] << _PRES) | d[..., 0]


def decode_octahedral_32(data):
    """encoding.wgsl:17-28."""
    data = np.asarray(data, np.uint32)
    d = np.stack([data & _MU, (data >> _PRES) & _MU], -1).astype(np.float32)
    v = d / np.float32(_MU) * 2.0 - 1.0
    nor = np.concatenate(
        [v, (1.0 - np.abs(v[..., :1]) - np.abs(v[..., 1:2]))], -1
    )
    t = np.maximum(-nor[..., 2], 0.0)
    nor[..., 0] += np.where(nor[..., 0] > 0.0, -t, t)
    nor[..., 1] += np.where(nor[..., 1] > 0.0, -t, t)
    return nor / np.linalg.norm(nor, axis=-1, keepdims=True)


def pack_unpack_2x16float(uv):
    """pack2x16float then unpack (visibility.wgsl:88 / shading.wgsl:59):
    the G-buffer uv survives an f16 roundtrip."""
    return np.asarray(uv, np.float32).astype(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# texturing: repeat wrap, bilinear, trilinear mips, pre-filter sRGB decode
# (wgpu sampler app.rs:45-47 Repeat + Linear; Srgb formats decode per
# texel BEFORE filtering per the Vulkan spec)
# ---------------------------------------------------------------------------


def build_pyramid(pool, tex_id):
    """Linear-space f32 mip pyramid for one pool texture.

    The pyramid CONTENT comes from the pool's own box-filter chain
    (scene/texture.py _downsample2x2) — mip generation is asset
    preparation shared as input data; SAMPLING below is implemented
    from the spec."""
    from voidin_tpu.scene.texture import _downsample2x2

    img = pool.images[tex_id].astype(np.float32) / 255.0
    levels = [img]
    while min(levels[-1].shape[0], levels[-1].shape[1]) > 1:
        levels.append(_downsample2x2(levels[-1] * 255.0) / 255.0)
    if pool.srgb_flags[tex_id]:
        levels = [
            np.concatenate([srgb_to_linear(l[..., :3]), l[..., 3:]], -1)
            for l in levels
        ]
    return levels


def _bilinear_wrap(level, uv):
    """One bilinear tap with repeat addressing. uv: (..., 2)."""
    h, w = level.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0m, x1m = x0 % w, (x0 + 1) % w
    y0m, y1m = y0 % h, (y0 + 1) % h
    c00 = level[y0m, x0m]
    c10 = level[y0m, x1m]
    c01 = level[y1m, x0m]
    c11 = level[y1m, x1m]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (
        c01 * (1 - fx) + c11 * fx
    ) * fy


def sample_trilinear(pyramid, uv, lod):
    """Trilinear: bilinear at floor(lod) and floor(lod)+1, linear blend."""
    n_levels = len(pyramid)
    lod = np.clip(np.asarray(lod, np.float32), 0.0, n_levels - 1)
    l0 = np.floor(lod).astype(np.int64)
    frac = (lod - l0)[..., None]
    out = np.zeros(uv.shape[:-1] + (pyramid[0].shape[-1],), np.float32)
    for li in range(n_levels):
        m0 = l0 == li
        if not m0.any():
            continue
        child = _bilinear_wrap(pyramid[li], uv[m0])
        parent = _bilinear_wrap(pyramid[min(li + 1, n_levels - 1)], uv[m0])
        out[m0] = child + (parent - child) * frac[m0]
    return out


def _bilinear_clamp(table, uv):
    """Clamp-to-edge bilinear (the LTC LUT sampler; uv pre-scaled by
    LUT_SCALE/LUT_BIAS so taps stay interior — ltc.wgsl:149-152)."""
    h, w = table.shape[:2]
    x = np.clip(uv[..., 0] * w - 0.5, 0, w - 1)
    y = np.clip(uv[..., 1] * h - 0.5, 0, h - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = (x - x0)[..., None] if table.ndim == 3 else (x - x0)
    fy = (y - y0)[..., None] if table.ndim == 3 else (y - y0)
    c00 = table[y0, x0]
    c10 = table[y0, x0 + 1]
    c01 = table[y0 + 1, x0]
    c11 = table[y0 + 1, x0 + 1]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (
        c01 * (1 - fx) + c11 * fx
    ) * fy


# ---------------------------------------------------------------------------
# rasterization (wgpu fixed function + visibility.wgsl vertex stage)
# ---------------------------------------------------------------------------


def _mat3(m4):
    return np.asarray(m4, np.float32)[:3, :3]


def rasterize(world, cam, width, height):
    """Vertex transform, near clip, pixel-center rasterization with a
    reverse-Z GREATER depth test; returns per-pixel interpolated vertex
    outputs (VertexOutput, visibility.wgsl:22-29) plus analytic uv
    screen-gradients for the fragment stage's implicit derivatives."""
    mesh_h = world.meshes.host_arrays()
    inst_h = world.instances.host_arrays()
    positions = mesh_h["positions"]
    normals = mesh_h["normals"]
    tangents = mesh_h["tangents"]
    uvs = mesh_h["uvs"]
    indices = mesh_h["indices"]
    base_index = mesh_h["base_index"]
    index_count = mesh_h["index_count"]
    vertex_offset = mesh_h["vertex_offset"]

    proj = np.asarray(cam.projection, np.float32)
    view = np.asarray(cam.view, np.float32)
    vp = proj @ view

    zbuf = np.zeros((height, width), np.float32)  # reverse-Z clear = 0
    # interpolated VertexOutput per pixel
    g_norm = np.zeros((height, width, 3), np.float32)
    g_tan = np.zeros((height, width, 3), np.float32)
    g_bitan = np.zeros((height, width, 3), np.float32)
    g_uv = np.zeros((height, width, 2), np.float32)
    g_mat = np.zeros((height, width), np.int32)
    g_duvdx = np.zeros((height, width, 2), np.float32)
    g_duvdy = np.zeros((height, width, 2), np.float32)
    g_valid = np.zeros((height, width), bool)

    base_colors = np.stack(world.materials.base_color).astype(np.float32)

    for ii in range(len(inst_h["transform"])):
        m = inst_h["transform"][ii]
        mesh_id = int(inst_h["mesh_id"][ii])
        mat_id = int(inst_h["material_id"][ii])
        # base_color.w < 0.5 -> every fragment discards
        # (visibility.wgsl:73); the whole instance never writes depth.
        if base_colors[mat_id, 3] < 0.5:
            continue
        b = base_index[mesh_id]
        n_idx = index_count[mesh_id]
        vo = vertex_offset[mesh_id]
        idx = indices[b: b + n_idx].reshape(-1, 3) + vo

        pos = positions[idx]  # (T, 3, 3)
        # vs_main (visibility.wgsl:32-51)
        mvp = (vp @ m).astype(np.float32)
        clip = pos @ mvp[:, :3].T + mvp[:, 3]  # (T, 3, 4)
        m3 = _mat3(m)
        nrm = normals[idx] @ m3.T
        tan4 = tangents[idx]
        tan = tan4[..., :3] @ m3.T
        bitan = np.cross(nrm, tan) * tan4[..., 3:4]
        uv = uvs[idx]

        # 10 attribute channels lerped linearly in clip space by the
        # clipper (normal 3, tangent 3, bitangent 3 are per-vertex varying;
        # uv 2)
        attr = np.concatenate([nrm, tan, bitan, uv], axis=-1)  # (T, 3, 11)

        for t in range(clip.shape[0]):
            _raster_triangle(
                clip[t], attr[t], mat_id, width, height,
                zbuf, g_norm, g_tan, g_bitan, g_uv, g_mat,
                g_duvdx, g_duvdy, g_valid,
            )

    return dict(
        depth=zbuf, normal=g_norm, tangent=g_tan, bitangent=g_bitan,
        uv=g_uv, material=g_mat, duvdx=g_duvdx, duvdy=g_duvdy,
        valid=g_valid,
    )


def _clip_near(clip, attr):
    """Sutherland–Hodgman against the near plane z_clip <= w (the only
    clip plane that cuts geometry under the infinite reverse-Z projection:
    z_clip == znear > 0 satisfies z >= 0 everywhere). Attributes lerp
    with the same clip-space t (hardware clipper behavior). Returns a
    list of (3,4)+(3,K) triangles (0, 1 or 2)."""
    s = clip[:, 3] - clip[:, 2]
    inside = s > 0.0
    n_in = int(inside.sum())
    if n_in == 0:
        return []
    if n_in == 3:
        return [(clip, attr)]
    verts = []
    for i in range(3):
        j = (i + 1) % 3
        if inside[i]:
            verts.append((clip[i], attr[i]))
        if inside[i] != inside[j]:
            t = s[i] / (s[i] - s[j])
            verts.append(
                (clip[i] + (clip[j] - clip[i]) * t,
                 attr[i] + (attr[j] - attr[i]) * t)
            )
    tris = []
    for k in range(1, len(verts) - 1):
        tris.append(
            (np.stack([verts[0][0], verts[k][0], verts[k + 1][0]]),
             np.stack([verts[0][1], verts[k][1], verts[k + 1][1]])),
        )
    return tris


def _raster_triangle(clip, attr, mat_id, width, height, zbuf,
                     g_norm, g_tan, g_bitan, g_uv, g_mat,
                     g_duvdx, g_duvdy, g_valid):
    for c, a in _clip_near(clip, attr):
        w = c[:, 3]
        if np.any(w <= 0.0):
            continue  # fully clipped cases already handled; guard slivers
        inv_w = 1.0 / w
        sx = (c[:, 0] * inv_w * 0.5 + 0.5) * width
        sy = (0.5 - c[:, 1] * inv_w * 0.5) * height
        zn = c[:, 2] * inv_w  # NDC depth (reverse-Z)

        # back-face cull: front_face=Ccw + cull_mode=Back
        # (pass/visibility.rs:124) — CCW in y-up NDC = negative signed
        # area in y-down pixel space.
        area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
            sx[2] - sx[0]
        )
        if area2 >= 0.0:
            continue

        x0 = max(int(np.floor(sx.min())), 0)
        x1 = min(int(np.ceil(sx.max())), width - 1)
        y0 = max(int(np.floor(sy.min())), 0)
        y1 = min(int(np.ceil(sy.max())), height - 1)
        if x1 < x0 or y1 < y0:
            continue

        px = np.arange(x0, x1 + 1, dtype=np.float32) + 0.5
        py = np.arange(y0, y1 + 1, dtype=np.float32) + 0.5
        gx, gy = np.meshgrid(px, py)

        # edge functions; e0+e1+e2 == -area2, so the interior of a front
        # face (area2 < 0) has every e >= 0
        e = []
        for i in range(3):
            j = (i + 1) % 3
            e.append(
                (gx - sx[i]) * (sy[j] - sy[i]) - (gy - sy[i]) * (sx[j] - sx[i])
            )
        inside = (e[0] >= 0.0) & (e[1] >= 0.0) & (e[2] >= 0.0)
        if not inside.any():
            continue

        inv_a = 1.0 / -area2  # barycentric normalizer: e0+e1+e2 = -area2
        # screen barycentric of vertex k is the edge opposite it
        l0 = e[1] * inv_a
        l1 = e[2] * inv_a
        l2 = e[0] * inv_a
        # NDC z is affine in screen space -> linear interpolation
        depth = l0 * zn[0] + l1 * zn[1] + l2 * zn[2]

        sub = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        win = inside & (depth > zbuf[sub])  # CompareFunction::Greater
        if not win.any():
            continue

        # perspective-correct attributes: attr/w affine in screen space
        wi = l0 * inv_w[0] + l1 * inv_w[1] + l2 * inv_w[2]  # 1/w image
        aw = (
            l0[..., None] * (a[0] * inv_w[0])
            + l1[..., None] * (a[1] * inv_w[1])
            + l2[..., None] * (a[2] * inv_w[2])
        )
        vals = aw / wi[..., None]

        # analytic screen gradient of uv (the quantity hardware quad
        # derivatives estimate): u = U(x,y)/W(x,y) with U, W affine ->
        # du/dx = (Ux*W - U*Wx) / W^2. Barycentric gradients: dl0/dx =
        # (sy1-sy2)/area2 etc. (cyclic).
        dldx = np.array(
            [sy[2] - sy[1], sy[0] - sy[2], sy[1] - sy[0]], np.float32
        ) * inv_a
        dldy = np.array(
            [sx[1] - sx[2], sx[2] - sx[0], sx[0] - sx[1]], np.float32
        ) * inv_a
        uvw = np.stack([a[k][9:11] * inv_w[k] for k in range(3)])  # (3,2)
        Ux = (dldx[:, None] * uvw).sum(0)
        Uy = (dldy[:, None] * uvw).sum(0)
        Wx = (dldx * inv_w).sum()
        Wy = (dldy * inv_w).sum()
        U = aw[..., 9:11]
        duvdx = (Ux[None, None] * wi[..., None] - U * Wx) / (
            wi[..., None] ** 2
        )
        duvdy = (Uy[None, None] * wi[..., None] - U * Wy) / (
            wi[..., None] ** 2
        )

        zb = zbuf[sub]
        zb[win] = depth[win]
        g_norm[sub][win] = vals[win][:, 0:3]
        g_tan[sub][win] = vals[win][:, 3:6]
        g_bitan[sub][win] = vals[win][:, 6:9]
        g_uv[sub][win] = vals[win][:, 9:11]
        g_mat[sub][win] = mat_id
        g_duvdx[sub][win] = duvdx[win]
        g_duvdy[sub][win] = duvdy[win]
        g_valid[sub][win] = True


# ---------------------------------------------------------------------------
# G-buffer fragment stage (visibility.wgsl:66-91)
# ---------------------------------------------------------------------------


def gbuffer_fragment(raster, world, pyramids):
    """Per-pixel fs_main: normal mapping via TBN when material.normal != 0,
    octahedral-32 + f16-uv quantization (the G-buffer ABI the shading pass
    reads back)."""
    mats = world.materials
    normal_ids = np.asarray(mats.normal, np.int32)
    mat_img = raster["material"]
    n = raster["normal"]
    valid = raster["valid"]

    nid = normal_ids[mat_img]
    need_tbn = (nid != 0) & valid
    out_n = np.where(
        valid[..., None],
        n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30),
        0.0,
    )
    if need_tbn.any():
        # get_tbn + tbn * (tex*2-1) (visibility.wgsl:58-83)
        lod = _lod_from_grads(
            raster["duvdx"], raster["duvdy"], pyramids, nid
        )
        ntex = np.zeros(mat_img.shape + (4,), np.float32)
        for t in np.unique(nid[need_tbn]):
            m = need_tbn & (nid == t)
            ntex[m] = sample_trilinear(
                pyramids[int(t)], raster["uv"][m], lod[m]
            )

        def norm(v):
            return v / np.maximum(
                np.linalg.norm(v, axis=-1, keepdims=True), 1e-30
            )

        tbn_t = norm(raster["tangent"])
        tbn_b = norm(raster["bitangent"])
        tbn_n = norm(raster["normal"])
        local = ntex[..., :3] * 2.0 - 1.0
        mapped = (
            tbn_t * local[..., 0:1]
            + tbn_b * local[..., 1:2]
            + tbn_n * local[..., 2:3]
        )
        out_n = np.where(need_tbn[..., None], norm(mapped), out_n)

    # background keeps the CLEARED G-buffer (normal_uv = 0u, material 0,
    # depth 0) — the reference shades those pixels from the clear values
    packed = np.where(valid, encode_octahedral_32(out_n), np.uint32(0))
    return dict(
        normal=decode_octahedral_32(packed),  # shading reads the decode
        uv=pack_unpack_2x16float(np.where(valid[..., None], raster["uv"], 0.0)),
        material=np.where(valid, mat_img, 0),
        depth=raster["depth"],
        valid=valid,
    )


def _lod_from_grads(duvdx, duvdy, pyramids, tex_ids):
    """Canonical Vulkan LOD: log2(max(|duv/dx * size|, |duv/dy * size|))
    with the Euclidean footprint."""
    lod = np.zeros(tex_ids.shape, np.float32)
    for t in np.unique(tex_ids):
        pyr = pyramids[int(t)]
        h, w = pyr[0].shape[:2]
        m = tex_ids == t
        sx = np.sqrt(
            (duvdx[m][:, 0] * w) ** 2 + (duvdx[m][:, 1] * h) ** 2
        )
        sy = np.sqrt(
            (duvdy[m][:, 0] * w) ** 2 + (duvdy[m][:, 1] * h) ** 2
        )
        rho = np.maximum(np.maximum(sx, sy), 1e-8)
        lod[m] = np.clip(np.log2(rho), 0.0, 16.0)
    return lod


# ---------------------------------------------------------------------------
# LTC (utils/ltc.wgsl:49-192)
# ---------------------------------------------------------------------------


def integrate_edge(v1, v2):
    """ltc.wgsl:49-63 (the published Heitz et al. rational fit)."""
    x = (v1 * v2).sum(-1)
    y = np.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    ts = np.where(
        x <= 0.0,
        0.5 / np.sqrt(np.maximum(1.0 - x * x, 1e-7)) - v,
        v,
    )
    return np.cross(v1, v2) * ts[..., None]


def ltc_evaluate_rect(nor, view, pos, minv_img, points, ltc2_w, two_sided=False):
    """ltc.wgsl:114-160. minv_img: (..., 3, 3) row-major (acts by M @ v)."""
    ndv = (view * nor).sum(-1, keepdims=True)
    T1 = view - nor * ndv
    T1 = T1 / np.maximum(np.linalg.norm(T1, axis=-1, keepdims=True), 1e-30)
    T2 = np.cross(nor, T1)
    # transpose(mat3x3(T1, T2, nor)) has T1/T2/nor as ROWS
    basis = np.stack([T1, T2, nor], axis=-2)  # (..., 3, 3)
    minv = minv_img @ basis

    L = np.stack(
        [
            np.einsum("...ij,...j->...i", minv, points[k] - pos)
            for k in range(4)
        ],
        axis=-2,
    )
    L = L / np.maximum(np.linalg.norm(L, axis=-1, keepdims=True), 1e-30)

    dirv = points[0] - pos
    light_n = np.cross(points[1] - points[0], points[3] - points[0])
    behind = (dirv * light_n).sum(-1) < 0.0

    vsum = (
        integrate_edge(L[..., 0, :], L[..., 1, :])
        + integrate_edge(L[..., 1, :], L[..., 2, :])
        + integrate_edge(L[..., 2, :], L[..., 3, :])
        + integrate_edge(L[..., 3, :], L[..., 0, :])
    )
    length = np.linalg.norm(vsum, axis=-1)
    z = vsum[..., 2] / np.maximum(length, 1e-30)
    z = np.where(behind, -z, z)
    uv = np.stack([z * 0.5 + 0.5, length], -1) * LUT_SCALE + LUT_BIAS
    scale = _bilinear_clamp(ltc2_w, uv)
    total = length * scale
    if not two_sided:
        total = np.where(behind, 0.0, total)
    return total


# ---------------------------------------------------------------------------
# deferred shading (shading.wgsl:36-118)
# ---------------------------------------------------------------------------


def attenuation(max_intensity, falloff, dist, radius):
    """shading.wgsl:40-47. s is clamped before the polynomial only to
    avoid float overflow in the branch the s >= 1 early-out discards."""
    s = dist / radius
    s2 = np.minimum(s * s, 4.0)
    att = max_intensity * (1.0 - s2) ** 2 / (1.0 + falloff * s2)
    return np.where(s >= 1.0, 0.0, att)


def shade(gbuf, world, cam, pyramids, ltc1, ltc2, width, height):
    mats = world.materials
    albedo_ids = np.asarray(mats.albedo, np.int32)
    emissive_ids = np.asarray(mats.emissive, np.int32)
    mr_ids = np.asarray(mats.metallic_roughness, np.int32)

    mat_img = gbuf["material"]
    uv = gbuf["uv"]
    # shading-pass texture LOD: the implicit derivatives of a fullscreen
    # pass are 2x2-quad finite differences of the G-buffer uv IMAGE
    duvdx, duvdy = _quad_diffs(uv)

    def sample_mat_tex(tex_ids):
        out = np.zeros(mat_img.shape + (4,), np.float32)
        ids = tex_ids[mat_img]
        lod = _lod_from_grads(duvdx, duvdy, pyramids, ids)
        for t in np.unique(ids):
            m = ids == t
            out[m] = sample_trilinear(pyramids[int(t)], uv[m], lod[m])
        return out

    albedo = sample_mat_tex(albedo_ids)
    emissive = sample_mat_tex(emissive_ids)[..., :3]
    mr = sample_mat_tex(mr_ids)

    # world_position_from_depth (uv.wgsl:13-22) at the fullscreen pass's
    # pixel-center uv (uv.wgsl:1-3)
    px = (np.arange(width, dtype=np.float32) + 0.5) / width
    py = (np.arange(height, dtype=np.float32) + 0.5) / height
    gu, gv = np.meshgrid(px, py)
    ndc = np.stack(
        [gu * 2.0 - 1.0, (1.0 - gv) * 2.0 - 1.0, gbuf["depth"],
         np.ones_like(gu)],
        -1,
    )
    c2w = np.asarray(cam.clip_to_world, np.float32)
    wpos4 = ndc @ c2w.T
    # depth == 0 (background, infinite far) gives w == 0: both renderers
    # clamp w so the position is huge-but-finite and the light loops stay
    # NaN-free (attenuation evaluates to 0 there) — the GPU would produce
    # inf here, i.e. the same zero contributions
    wdiv = wpos4[..., 3:4]
    wdiv = np.where(
        np.abs(wdiv) > 1e-12, wdiv, np.where(wdiv < 0, -1e-12, 1e-12)
    )
    pos = wpos4[..., :3] / wdiv

    nor = gbuf["normal"]
    campos = np.asarray(cam.position, np.float32)[:3]
    rd = campos - pos
    rd = rd / np.maximum(np.linalg.norm(rd, axis=-1, keepdims=True), 1e-30)

    is_light = mat_img == LIGHT_MATERIAL
    color = np.where(
        is_light[..., None],
        albedo[..., :3] + emissive,
        albedo[..., :3] * 0.01 + emissive,
    )

    # point lights (shading.wgsl:75-96)
    for i in range(len(world.lights.point_radius)):
        lpos = np.asarray(world.lights.point_position[i], np.float32)
        lrad = np.float32(world.lights.point_radius[i])
        lcol = np.asarray(world.lights.point_color[i], np.float32)
        lvec = lpos - pos
        dist = np.linalg.norm(lvec, axis=-1)
        att = np.where(
            dist - lrad > 0.0, 0.0, attenuation(1.0, 1.0, dist, lrad)
        )
        ldir = lvec / np.maximum(dist[..., None], 1e-30)
        shade_t = np.maximum(0.0, (nor * ldir).sum(-1))
        diff = lcol * albedo[..., :3] * (shade_t * att)[..., None]
        # NOTE the reference quirk kept verbatim: refl is computed but the
        # specular uses pow(dot(-rd, nor), 16) (shading.wgsl:91-93)
        covr = np.maximum(0.0, (-rd * nor).sum(-1))
        spec = lcol * (mr[..., 2] * covr**16 * att)[..., None]
        contrib = diff + spec
        color = np.where(is_light[..., None], color, color + contrib)

    # area lights (shading.wgsl:98-114)
    if world.lights.area_points:
        # ltc_matrix (ltc.wgsl:162-180)
        ndv = np.clip((nor * rd).sum(-1), 0.0, 1.0)
        luv = np.stack(
            [np.clip(mr[..., 0], 0.0, 1.0), np.sqrt(1.0 - ndv)], -1
        ) * LUT_SCALE + LUT_BIAS
        t1 = _bilinear_clamp(ltc1, luv)
        t2 = _bilinear_clamp(ltc2, luv)
        zeros = np.zeros_like(t1[..., 0])
        ones = np.ones_like(t1[..., 0])
        # mat3x3(vec3(t1.x,0,t1.y), vec3(0,1,0), vec3(t1.z,0,t1.w)):
        # columns -> row-major [[x,0,z],[0,1,0],[y,0,w]]
        minv = np.stack(
            [
                np.stack([t1[..., 0], zeros, t1[..., 2]], -1),
                np.stack([zeros, ones, zeros], -1),
                np.stack([t1[..., 1], zeros, t1[..., 3]], -1),
            ],
            axis=-2,
        )
        identity = np.broadcast_to(np.eye(3, dtype=np.float32), minv.shape)
        ltc2_w = np.ascontiguousarray(ltc2[..., 3])
        for i in range(len(world.lights.area_points)):
            pts = np.asarray(world.lights.area_points[i], np.float32)
            lcol = np.asarray(world.lights.area_color[i], np.float32)
            inten = np.float32(world.lights.area_intensity[i])
            center = 0.5 * (pts[0] + pts[2])
            diff = ltc_evaluate_rect(nor, rd, pos, identity, pts, ltc2_w)
            spec = ltc_evaluate_rect(nor, rd, pos, minv, pts, ltc2_w)
            # scolor = vec3(1): spec *= t2.x (ltc.wgsl:188-192)
            spec = spec * t2[..., 0]
            dist = np.linalg.norm(center - pos, axis=-1)
            att = attenuation(inten, 500.0, dist, 25.0)  # shading.wgsl:102,112
            contrib = lcol * (
                inten
                * (spec * att)[..., None]
                + inten * albedo[..., :3] * diff[..., None]
            )
            color = np.where(is_light[..., None], color, color + contrib)

    return np.maximum(color, 0.0)


def _quad_diffs(img):
    """2x2-quad derivative estimate (what hardware ddx/ddy return for a
    fullscreen pass): both pixels of a quad share the within-quad
    difference."""
    dx = np.zeros_like(img)
    dx[:, 0::2] = img[:, 1::2] - img[:, 0::2]
    dx[:, 1::2] = dx[:, 0::2]
    dy = np.zeros_like(img)
    dy[0::2, :] = img[1::2, :] - img[0::2, :]
    dy[1::2, :] = dy[0::2, :]
    return dx, dy


# ---------------------------------------------------------------------------
# postprocess (postprocess.wgsl:21-98) + final sRGB encode
# ---------------------------------------------------------------------------


def postprocess(hdr):
    col = np.asarray(hdr, np.float32)
    luma = calculate_luma(col)
    center = np.sqrt(np.maximum(luma, 0.0))  # sharpen_remap

    # neighbors at +1x / +1y with the sampler's Repeat addressing
    n0 = np.sqrt(np.maximum(calculate_luma(np.roll(col, -1, axis=1)), 0.0))
    n1 = np.sqrt(np.maximum(calculate_luma(np.roll(col, -1, axis=0)), 0.0))

    sharpen_amount = 0.5
    wt = np.maximum(0.0, 1.0 - 6.0 * (np.abs(center - n0) + np.abs(center - n1)))
    wt = np.minimum(wt, sharpen_amount * wt * 1.25)
    # the WGSL loop body indexes dim_offsets[0] and [1] in BOTH dim
    # iterations (postprocess.wgsl:76-88), so each neighbor accumulates
    # twice
    neighbours = 2.0 * (n0 * wt + n1 * wt)
    wt_sum = 4.0 * wt

    sharpened = np.maximum(0.0, center * (wt_sum + 1.0) - neighbours)
    sharpened = sharpened * sharpened  # sharpen_remap_inv
    col = col * np.maximum(
        0.0, sharpened / np.maximum(1e-5, luma)
    )[..., None]

    # neutral_tonemap (postprocess.wgsl:30-48)
    def curve(v):
        c = v + v * v + 0.5 * v * v * v
        return c / (1.0 + c)

    ycbcr = rgb_to_ycbcr(col)
    chroma = np.linalg.norm(ycbcr[..., 1:], axis=-1) * 2.4
    bt = curve(chroma)
    desat = np.maximum((bt - 0.7) * 0.8, 0.0)
    desat = desat * desat
    desat_col = col + (ycbcr[..., :1] - col) * desat[..., None]
    tm_luma = curve(ycbcr[..., 0])
    tm0 = col * np.maximum(
        0.0, tm_luma / np.maximum(1e-5, calculate_luma(col))
    )[..., None]
    tm1 = curve(desat_col)
    res = tm0 + (tm1 - tm0) * (bt * bt)[..., None]
    return res * 0.97


# ---------------------------------------------------------------------------
# whole frame
# ---------------------------------------------------------------------------


def render_oracle(world, cam, width, height, enable_post=True):
    """Full oracle frame -> sRGB (H, W, 3) float in [0, 1]."""
    import os

    import voidin_tpu

    tables = np.load(
        os.path.join(
            os.path.dirname(voidin_tpu.__file__), "assets", "ltc_tables.npz"
        )
    )
    ltc1 = tables["ltc1"].astype(np.float32)
    ltc2 = tables["ltc2"].astype(np.float32)

    pyramids = [
        build_pyramid(world.textures, t)
        for t in range(len(world.textures.images))
    ]
    raster = rasterize(world, cam, width, height)
    gbuf = gbuffer_fragment(raster, world, pyramids)
    hdr = shade(gbuf, world, cam, pyramids, ltc1, ltc2, width, height)
    ldr = postprocess(hdr) if enable_post else hdr
    return linear_to_srgb(ldr)


# ---------------------------------------------------------------------------
# raytraced point-light shadows (src/bin/raytraced_shadows.wgsl:58-119).
# The occlusion query is BRUTE FORCE over every world-space triangle —
# deliberately independent of the production BVH/traversal machinery (which
# the numpy oracles in tests/test_traverse.py cover structurally); a wrong
# TLAS/BLAS/packet/threading path shows up here as a wrong image.
# ---------------------------------------------------------------------------


def _world_triangles(world):
    """(T, 3, 3) world-space triangle vertices over all opaque instances."""
    mesh_h = world.meshes.host_arrays()
    inst_h = world.instances.host_arrays()
    positions = mesh_h["positions"]
    indices = mesh_h["indices"]
    base_index = mesh_h["base_index"]
    index_count = mesh_h["index_count"]
    vertex_offset = mesh_h["vertex_offset"]
    tris = []
    for ii in range(len(inst_h["transform"])):
        m = inst_h["transform"][ii]
        mesh_id = int(inst_h["mesh_id"][ii])
        b = base_index[mesh_id]
        idx = indices[b : b + index_count[mesh_id]].reshape(-1, 3)
        pos = positions[idx + vertex_offset[mesh_id]]  # (t, 3, 3)
        tris.append(pos @ m[:3, :3].T + m[:3, 3])
    return (
        np.concatenate(tris, axis=0)
        if tris
        else np.zeros((0, 3, 3), np.float32)
    )


def _any_hit_brute(tris, origins, dirs, t_max=1.0, chunk=2048):
    """Backface-culled Moller-Trumbore any-hit (intersections.wgsl:26-45):
    det >= 1e-10, 0 <= u, v, u + v <= 1, 0 < t < t_max."""
    R = origins.shape[0]
    hit = np.zeros(R, bool)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    for s in range(0, R, chunk):
        o = origins[s : s + chunk][:, None, :]  # (r, 1, 3)
        d = dirs[s : s + chunk][:, None, :]
        uvec = np.cross(d, e2[None])
        det = np.sum(e1[None] * uvec, axis=-1)
        inv_det = 1.0 / np.where(np.abs(det) > 1e-20, det, 1e-20)
        orig = o - v0[None]
        u = inv_det * np.sum(orig * uvec, axis=-1)
        vvec = np.cross(orig, e1[None])
        v = inv_det * np.sum(d * vvec, axis=-1)
        t = inv_det * np.sum(e2[None] * vvec, axis=-1)
        ok = (
            (det >= 1e-10)
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > 0.0)
            & (t < t_max)
        )
        hit[s : s + chunk] = ok.any(axis=1)
    return hit


def shade_raytraced_oracle(gbuf, world, cam, pyramids, width, height):
    """raytraced_shadows.wgsl:58-119: ambient 0.3*albedo + emissive,
    shadow ray from pos + 1e-4*normal toward the light (t_max = 1 in
    light-vector units), occlusion 0.5 on hit, (diff + spec) * occ * atten,
    magenta debug for material 0."""
    mats = world.materials
    albedo_ids = np.asarray(mats.albedo, np.int32)
    emissive_ids = np.asarray(mats.emissive, np.int32)
    mr_ids = np.asarray(mats.metallic_roughness, np.int32)
    mat_img = gbuf["material"]
    uv = gbuf["uv"]
    duvdx, duvdy = _quad_diffs(uv)

    def sample_mat_tex(tex_ids):
        out = np.zeros(mat_img.shape + (4,), np.float32)
        ids = tex_ids[mat_img]
        lod = _lod_from_grads(duvdx, duvdy, pyramids, ids)
        for t in np.unique(ids):
            m = ids == t
            out[m] = sample_trilinear(pyramids[int(t)], uv[m], lod[m])
        return out

    albedo = sample_mat_tex(albedo_ids)
    emissive = sample_mat_tex(emissive_ids)[..., :3]
    mr = sample_mat_tex(mr_ids)

    px = (np.arange(width, dtype=np.float32) + 0.5) / width
    py = (np.arange(height, dtype=np.float32) + 0.5) / height
    gu, gv = np.meshgrid(px, py)
    depth = gbuf["depth"]
    ndc = np.stack(
        [gu * 2.0 - 1.0, (1.0 - gv) * 2.0 - 1.0, depth, np.ones_like(gu)],
        -1,
    )
    c2w = np.asarray(cam.clip_to_world, np.float32)
    wpos4 = ndc @ c2w.T
    wdiv = wpos4[..., 3:4]
    wdiv = np.where(
        np.abs(wdiv) > 1e-12, wdiv, np.where(wdiv < 0, -1e-12, 1e-12)
    )
    pos = wpos4[..., :3] / wdiv

    nor = gbuf["normal"]
    campos = np.asarray(cam.position, np.float32)[:3]
    rd = campos - pos
    rd = rd / np.maximum(np.linalg.norm(rd, axis=-1, keepdims=True), 1e-30)

    is_light = mat_img == LIGHT_MATERIAL
    color = np.where(
        is_light[..., None],
        albedo[..., :3] + emissive,
        albedo[..., :3] * 0.3 + emissive,
    )

    tris = _world_triangles(world)
    shadable = (depth > 0.0) & ~is_light
    for i in range(len(world.lights.point_radius)):
        lpos = np.asarray(world.lights.point_position[i], np.float32)
        lrad = np.float32(world.lights.point_radius[i])
        lcol = np.asarray(world.lights.point_color[i], np.float32)
        lvec = lpos - pos
        dist = np.linalg.norm(lvec, axis=-1)

        # shadow rays only where the contribution can be nonzero (the
        # production renderer's EXACT skipping; identical images) — and
        # where shadable, which bounds the brute-force ray count
        need = shadable & (dist < lrad)
        origins = (pos + nor * 1e-4)[need]
        dirs = lvec[need]
        occ_hit = np.zeros(depth.shape, bool)
        occ_hit[need] = _any_hit_brute(tris, origins, dirs, t_max=1.0)
        occlusion = np.where(occ_hit, 0.5, 1.0)

        att = attenuation(1.0, 1.0, dist, lrad)
        ldir = lvec / np.maximum(dist[..., None], 1e-30)
        shade_t = np.maximum(0.0, (nor * ldir).sum(-1))
        diff = lcol * albedo[..., :3] * shade_t[..., None]
        covr = np.maximum(0.0, (-rd * nor).sum(-1))
        spec = lcol * (mr[..., 2] * covr**16)[..., None]
        contrib = (diff + spec) * (occlusion * att)[..., None]
        color = color + np.where(shadable[..., None], contrib, 0.0)

    # material 0 renders magenta where geometry was hit
    # (raytraced_shadows.wgsl:83-85)
    color = np.where(
        ((mat_img == 0) & (depth > 0.0))[..., None],
        np.array([1.0, 0.0, 1.0], np.float32),
        color,
    )
    return np.maximum(color, 0.0)


def render_oracle_raytraced(world, cam, width, height, enable_post=True):
    """Full raytraced-shadows oracle frame -> sRGB float (H, W, 3)."""
    pyramids = [
        build_pyramid(world.textures, t)
        for t in range(len(world.textures.images))
    ]
    raster = rasterize(world, cam, width, height)
    gbuf = gbuffer_fragment(raster, world, pyramids)
    hdr = shade_raytraced_oracle(gbuf, world, cam, pyramids, width, height)
    ldr = postprocess(hdr) if enable_post else hdr
    return linear_to_srgb(ldr)


# ---------------------------------------------------------------------------
# temporal pass: reprojection (shaders/reproject.wgsl:14-38) + TAA history
# resolve (shaders/taa.wgsl:45-103)
# ---------------------------------------------------------------------------


def _bilinear_image_clamp(img, u, v):
    """Clamp-to-edge bilinear sample of (H, W, C) at normalized uv — the
    GPU sampler semantics taa.wgsl relies on."""
    H, W = img.shape[:2]
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = np.floor(fx)
    y0 = np.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)

    def at(yy, xx):
        return img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]

    c00 = at(y0, x0)
    c10 = at(y0, x0 + 1)
    c01 = at(y0 + 1, x0)
    c11 = at(y0 + 1, x0 + 1)
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def _shift_clamp(img, dy, dx):
    H, W = img.shape[:2]
    ys = np.clip(np.arange(H) + dy, 0, H - 1)
    xs = np.clip(np.arange(W) + dx, 0, W - 1)
    return img[ys][:, xs]


def _smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _mitchell(x):
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


def reproject_oracle(depth, cam, width, height):
    """reproject.wgsl:14-38 -> (H, W, 3) = (vel_x, vel_y, in_bounds)."""
    d = depth
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                d = np.maximum(d, _shift_clamp(depth, dy, dx))

    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    x_ndc = np.broadcast_to((u * 2.0 - 1.0)[None, :], d.shape)
    y_ndc = np.broadcast_to(((1.0 - v) * 2.0 - 1.0)[:, None], d.shape)

    ndc = np.stack([x_ndc, y_ndc, d, np.ones_like(d)], -1)
    c2w = np.asarray(cam.clip_to_world, np.float32)
    wpos4 = ndc @ c2w.T
    wdiv = wpos4[..., 3:4]
    wdiv = np.where(
        np.abs(wdiv) > 1e-12, wdiv, np.where(wdiv < 0, -1e-12, 1e-12)
    )
    pos_ws = wpos4[..., :3] / wdiv

    m = np.asarray(cam.prev_world_to_clip, np.float32)
    prev4 = pos_ws @ m[:, :3].T + m[:, 3]
    prev_ndc = prev4[..., :2] / prev4[..., 3:4]

    jit = np.asarray(cam.jitter, np.float32)
    pjit = np.asarray(cam.prev_jitter, np.float32)
    vel_x = (x_ndc + jit[0]) - (prev_ndc[..., 0] + pjit[0])
    vel_y = (y_ndc + jit[1]) - (prev_ndc[..., 1] + pjit[1])

    inv_dims = np.array([1.0 / width, 1.0 / height], np.float32)
    in_bounds = np.all(
        prev_ndc == np.clip(prev_ndc, -1.0 + inv_dims, 1.0 - inv_dims),
        axis=-1,
    )
    return np.stack([vel_x, vel_y, in_bounds.astype(np.float32)], -1)


def taa_resolve_oracle(color, history, motion):
    """taa.wgsl:45-103: YCbCr Gaussian 3x3 moments, Mitchell-filtered
    center, adaptive clamp box from local contrast + texel-center
    distance, mu +/- 1.5 sigma clamp, blend 1 -> 1/12 by velocity
    validity widened by clamp distance."""
    H, W = color.shape[:2]
    u = (np.arange(W, dtype=np.float32) + 0.5) / W
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    uu = np.broadcast_to(u[None, :], (H, W))
    vv = np.broadcast_to(v[:, None], (H, W))

    hist_u = uu - motion[..., 0] * 0.5
    hist_v = vv + motion[..., 1] * 0.5  # * (1, -1) flip

    hist = rgb_to_ycbcr(_bilinear_image_clamp(history, hist_u, hist_v))

    vsum = np.zeros_like(color)
    vsum2 = np.zeros_like(color)
    wsum = 0.0
    mn_sum = np.zeros_like(color)
    mn_wsum = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = _shift_clamp(color, dy, dx)
            neigh = rgb_to_ycbcr(shifted)
            w = float(np.exp(-3.0 * (dx * dx + dy * dy) / 4.0))
            vsum += neigh * w
            vsum2 += neigh * neigh * w
            wsum += w
            wt = _mitchell(np.sqrt(dx * dx + dy * dy))
            mn_sum += shifted * wt
            mn_wsum += wt

    ex = vsum / wsum
    ex2 = vsum2 / wsum
    dev = np.sqrt(np.maximum(0.0, ex2 - ex * ex))
    local_contrast = dev[..., 0] / (ex[..., 0] + 1e-5)

    hist_px = hist_u * W
    hist_py = hist_v * H
    frac = np.stack(
        [hist_px - np.floor(hist_px), hist_py - np.floor(hist_py)], -1
    )
    texel_center_dist = np.sum(np.abs(0.5 - frac), axis=-1)

    box_size = 0.5 + 0.5 * _smoothstep(-0.1, 0.3, local_contrast)
    box_size = box_size * (
        0.5 + 0.5 * np.clip(1.0 - texel_center_dist, 0.0, 1.0)
    )

    center = rgb_to_ycbcr(mn_sum / mn_wsum)

    bs2 = (box_size * box_size)[..., None]
    mid = center + (ex - center) * bs2
    nmin = mid - dev * (box_size[..., None] * 1.5)
    nmax = mid + dev * (box_size[..., None] * 1.5)

    clamped = np.clip(hist, nmin, nmax)
    blend = 1.0 + (1.0 / 12.0 - 1.0) * motion[..., 2]
    clamp_dist = np.minimum(
        np.abs(hist[..., 0] - nmin[..., 0]),
        np.abs(hist[..., 0] - nmax[..., 0]),
    ) / np.maximum(np.maximum(hist[..., 0], ex[..., 0]), 1e-5)
    blend = blend * (0.2 + 0.8 * _smoothstep(0.0, 2.0, clamp_dist))

    return ycbcr_to_rgb(clamped + (center - clamped) * blend[..., None])


def render_oracle_taa(world, cams, width, height, enable_post=True):
    """Multi-frame oracle with the temporal pass: `cams` is the per-frame
    CameraUniform chain (cams[i] built with previous=cams[i-1]). History
    seeds from frame 0's output (the production renderer's documented
    deviation — PARITY.md; the reference converges from black instead).
    Returns the final frame -> sRGB float (H, W, 3)."""
    pyramids = [
        build_pyramid(world.textures, t)
        for t in range(len(world.textures.images))
    ]
    import os

    import voidin_tpu

    tables = np.load(
        os.path.join(
            os.path.dirname(voidin_tpu.__file__), "assets", "ltc_tables.npz"
        )
    )
    ltc1 = tables["ltc1"].astype(np.float32)
    ltc2 = tables["ltc2"].astype(np.float32)

    history = None
    out = None
    for cam in cams:
        raster = rasterize(world, cam, width, height)
        gbuf = gbuffer_fragment(raster, world, pyramids)
        hdr = shade(gbuf, world, cam, pyramids, ltc1, ltc2, width, height)
        if history is None:
            out = hdr
        else:
            motion = reproject_oracle(gbuf["depth"], cam, width, height)
            out = taa_resolve_oracle(hdr, history, motion)
        history = out
    ldr = postprocess(out) if enable_post else out
    return linear_to_srgb(ldr)
