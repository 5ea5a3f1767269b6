"""Deferred shading: ambient + emissive, point lights, LTC area lights.

Dense per-pixel port of shaders/shading.wgsl:36-118 over the G-buffer —
fully data-parallel, ideal for the VPU. Faithfully reproduced semantics:

* world position reconstructed from reverse-Z depth + clip_to_world
  (utils/uv.wgsl world_position_from_depth);
* ambient = 0.01 * albedo + emissive; LIGHT_MATERIAL pixels render
  albedo + emissive and skip all lights (shading.wgsl:66-71);
* point lights: smooth attenuation (1-s^2)^2/(1+f*s^2), lambert diffuse and
  the reference's pow-16 "spec" term — which uses dot(-rd, normal) and is
  therefore ~always zero for front-facing surfaces; kept bit-for-bit for
  parity (shading.wgsl:85-95);
* area lights: LTC rect evaluation (utils/ltc.wgsl) with roughness from
  metallic_roughness.x, radius-25 attenuation on the specular term only
  (shading.wgsl:98-112).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import encoding, fastmath
from ..scene.material import LIGHT_MATERIAL
from ..scene.scene import SceneData
from ..scene.texture import sample_lut_bilinear, sample_trilinear
from .gbuffer import GBuffer

LUT_SIZE = 64.0
LUT_SCALE = (LUT_SIZE - 1.0) / LUT_SIZE
LUT_BIAS = 0.5 / LUT_SIZE


def _normalize(v, eps=1e-20):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def world_position_from_depth(depth: jnp.ndarray, clip_to_world) -> jnp.ndarray:
    """(H, W) raw depth -> (H, W, 3) world positions (uv.wgsl:18-23)."""
    H, W = depth.shape
    # uv convention: x right, y down; ndc y = (1 - uv.y)*2 - 1.
    u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    x_ndc = (u * 2.0 - 1.0)[None, :].repeat(H, 0)
    y_ndc = ((1.0 - v) * 2.0 - 1.0)[:, None].repeat(W, 1)
    m = jnp.asarray(clip_to_world)
    wx, wy, wz, ww = fastmath.const_mat4_point4(m, x_ndc, y_ndc, depth)
    world = jnp.stack([wx, wy, wz, ww], axis=-1)
    # depth == 0 (background, infinite far) gives w == 0: clamp so the
    # position is a huge-but-finite point and downstream light math stays
    # NaN-free (attenuation evaluates to 0 there).
    w = world[..., 3:4]
    w = jnp.where(jnp.abs(w) > 1e-12, w, jnp.where(w < 0, -1e-12, 1e-12))
    return jnp.clip(world[..., :3] / w, -1e12, 1e12)


def attenuation(max_intensity, falloff, dist, radius):
    s = dist / radius
    s2 = s * s
    att = max_intensity * (1.0 - s2) ** 2 / (1.0 + falloff * s2)
    return jnp.where(s >= 1.0, 0.0, att)


def uv_lod(uv: jnp.ndarray, tex_w, tex_h) -> jnp.ndarray:
    """Mip level from screen-space finite differences of the uv image."""
    du = jnp.diff(uv, axis=1, append=uv[:, -1:, :])
    dv = jnp.diff(uv, axis=0, append=uv[-1:, :, :])
    rho = jnp.maximum(
        jnp.abs(du[..., 0]) * tex_w + jnp.abs(du[..., 1]) * tex_h,
        jnp.abs(dv[..., 0]) * tex_w + jnp.abs(dv[..., 1]) * tex_h,
    )
    return jnp.clip(jnp.log2(jnp.maximum(rho, 1e-8)), 0.0, 16.0)


# ---------------------------------------------------------------------------
# LTC (utils/ltc.wgsl)
# ---------------------------------------------------------------------------


def sample_lut_bilinear_mxu_multi(tables, uv: jnp.ndarray):
    """Gather-free bilinear LUT samples: two-tap weight matrices shared
    across all tables, one (P, H) @ (H, W) contraction per table.

    `tables`: list of (H, W) single-channel f32 (same shape). `uv`: (..., 2)
    pre-scaled by LUT_SCALE/BIAS (taps never cross the clamp border, so this
    matches sample_lut_bilinear exactly up to f32 rounding). The quad-gather
    form is sample_lut_bilinear over scene.ltc12_quads (LTC12_MXU off)."""
    h, w = tables[0].shape
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.clip(jnp.floor(fx), 0, w - 1)
    y0 = jnp.clip(jnp.floor(fy), 0, h - 1)
    tx = fx - x0
    ty = fy - y0
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    iy = jnp.arange(h, dtype=jnp.float32)
    wy = (iy == y0[..., None]) * (1.0 - ty[..., None]) + (
        iy == y1[..., None]
    ) * ty[..., None]  # (..., H) two-tap row weights
    ix = jnp.arange(w, dtype=jnp.float32)
    wx = (ix == x0[..., None]) * (1.0 - tx[..., None]) + (
        ix == x1[..., None]
    ) * tx[..., None]
    # One (P, H) @ (H, W) matmul per channel, weight matrices shared and
    # the wx-reduce fused as the matmul epilogue — avoids a (P, W, C)
    # materialization an einsum formulation would create.
    wy_flat = wy.reshape(-1, h)
    out = []
    if LTC_LUT_BF16:
        wy_flat = wy_flat.astype(jnp.bfloat16)
        for t in tables:
            rows = jnp.matmul(
                wy_flat, t.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ).reshape(uv.shape[:-1] + (w,))
            out.append(jnp.sum(rows * wx, axis=-1))
        return out
    for t in tables:
        rows = jnp.matmul(
            wy_flat, t, precision=jax.lax.Precision.HIGHEST
        ).reshape(uv.shape[:-1] + (w,))
        out.append(jnp.sum(rows * wx, axis=-1))
    return out


def sample_lut_bilinear_mxu(table: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Single-table convenience wrapper over sample_lut_bilinear_mxu_multi."""
    return sample_lut_bilinear_mxu_multi([table], uv)[0]


def integrate_edge(v1, v2):
    """ltc.wgsl:52-66 — vectorized over (..., 3)."""
    x = jnp.sum(v1 * v2, axis=-1)
    y = jnp.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    theta_sintheta = jnp.where(
        x > 0.0,
        v,
        0.5 / jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-7)) - v,
    )
    return jnp.cross(v1, v2) * theta_sintheta[..., None]


# ltc12 matrix fetch: True = the two-tap weight contraction
# (sample_lut_bilinear_mxu_multi, Precision.HIGHEST), False = the
# quad-gather form (sample_lut_bilinear over ltc12_quads).
LTC12_MXU = True

# Build the two-tap bilinear weight matrices in bf16 (halves the traffic of
# the (P, 64) intermediates; LUT values are O(1) and smooth, so bf16 weights
# cost ~1e-3 absolute — under the 1e-2 image budget). Off by default.
LTC_LUT_BF16 = False


def ltc_matrix(scene: SceneData, nor, view, roughness):
    """ltc.wgsl:160-177: fetch inverse-M + the LTC2 norm/fresnel texel."""
    ndotv = jnp.clip(jnp.sum(nor * view, axis=-1), 0.0, 1.0)
    uv = jnp.stack([roughness, jnp.sqrt(1.0 - ndotv)], axis=-1)
    uv = uv * LUT_SCALE + LUT_BIAS
    if LTC12_MXU:
        # Only 5 of the 8 packed channels are consumed (t1.xyzw + t2.x);
        # the two-tap weight matrices are shared across the 5 contractions.
        chans = [scene.ltc1[..., c] for c in range(4)] + [scene.ltc2[..., 0]]
        vals = sample_lut_bilinear_mxu_multi(chans, uv)
        t1 = jnp.stack(vals[:4], axis=-1)
        zero2 = jnp.zeros_like(vals[4])
        t2 = jnp.stack([vals[4], zero2, zero2, zero2], axis=-1)
    else:
        t12 = sample_lut_bilinear(scene.ltc12_quads, 64, uv, channels=8)
        t1, t2 = t12[..., :4], t12[..., 4:]
    # WGSL columns (t1.x,0,t1.y),(0,1,0),(t1.z,0,t1.w) -> row-major matrix.
    zero = jnp.zeros_like(t1[..., 0])
    one = jnp.ones_like(zero)
    minv = jnp.stack(
        [
            jnp.stack([t1[..., 0], zero, t1[..., 2]], axis=-1),
            jnp.stack([zero, one, zero], axis=-1),
            jnp.stack([t1[..., 1], zero, t1[..., 3]], axis=-1),
        ],
        axis=-2,
    )  # (..., 3, 3) acting on column vectors
    return minv, t1, t2


def ltc_apply_texture(scene: SceneData, tex_id, p0, p1, p2):
    """Filtered light-texture lookup for textured area lights — port of
    ltc.wgsl:75-106 apply_texture (present in the reference's LTC library
    but called by no shipped shader; ported for library parity). p0/p1/p2:
    three corners of the cosine-space quad per pixel (..., 3); returns a
    (..., 3) filtered rgb. The blur width sigma grows with the projected
    distance from the quad plane and with distance outside the unit square
    (sdsquare), approximating the LTC-filtered light texture; the three
    taps emulate textureSampleGrad's decreasing-footprint cascade."""
    v1 = p0 - p1
    v2 = p2 - p1
    plane_orto = jnp.cross(v1, v2)
    plane_area_sq = jnp.sum(plane_orto * plane_orto, axis=-1)
    dist_x_area = jnp.sum(plane_orto * p1, axis=-1)
    denom = jnp.where(jnp.abs(plane_area_sq) > 1e-20, plane_area_sq, 1e-20)
    p = dist_x_area[..., None] * plane_orto / denom[..., None] - p1

    dot_v1_v2 = jnp.sum(v1 * v2, axis=-1)
    inv_dot_v1_v1 = 1.0 / jnp.maximum(jnp.sum(v1 * v1, axis=-1), 1e-20)
    v2p = v2 - v1 * (dot_v1_v2 * inv_dot_v1_v1)[..., None]
    uv_y = jnp.sum(v2p * p, axis=-1) / jnp.maximum(
        jnp.sum(v2p * v2p, axis=-1), 1e-20
    )
    uv_x = (
        jnp.sum(v1 * p, axis=-1) * inv_dot_v1_v1
        - dot_v1_v2 * inv_dot_v1_v1 * uv_y
    )
    uv = jnp.stack([uv_x, uv_y], axis=-1)

    # sdsquare: signed distance to the unit square (ltc.wgsl:65-69)
    q = jnp.abs(uv - 0.5) - 0.5
    sd = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) + jnp.minimum(
        jnp.maximum(q[..., 0], q[..., 1]), 0.0
    )
    sigma = jnp.abs(dist_x_area) / jnp.maximum(denom ** 0.75, 1e-20)
    sigma = sigma + jnp.maximum(sd, 0.0)

    def gaussian_kernel(x, s):
        si = 1.0 / jnp.maximum(s, 1e-8)
        return 0.39894 * jnp.exp(-0.5 * x * x * si * si) * si

    y0 = gaussian_kernel(0.0, sigma)
    xs = [gaussian_kernel(y0 * f, sigma) for f in (0.25, 0.5, 0.75)]

    size = scene.textures.size[tex_id].astype(jnp.float32)
    col = jnp.zeros(uv.shape[:-1] + (3,), jnp.float32)
    for xk in xs:
        # textureSampleGrad footprint 0.5 * xk in uv -> mip level
        rho = 0.5 * xk * jnp.maximum(size[..., 0], size[..., 1])
        lod = jnp.clip(jnp.log2(jnp.maximum(rho, 1e-8)), 0.0, 16.0)
        col = col + sample_trilinear(
            scene.textures, tex_id, uv, lod
        )[..., :3] * 0.333
    return col


def ltc_evaluate_rect(scene: SceneData, nor, view, pos, mminv, points, two_sided=False):
    """ltc.wgsl:108-158. points: (4, 3); pixel fields (..., 3)."""
    t1v = _normalize(view - nor * jnp.sum(view * nor, axis=-1, keepdims=True))
    t2v = jnp.cross(nor, t1v)
    # minv = mminv @ transpose(mat3(T1, T2, N)): rows T1, T2, N.
    basis = jnp.stack([t1v, t2v, nor], axis=-2)  # (..., 3, 3) rows
    minv = fastmath.mat3_mat3(mminv, basis)

    rel = points[..., None, :, :] - pos[..., None, :]  # (..., 4, 3)
    Ln = jnp.stack(
        [_normalize(fastmath.mat3_vec(minv, rel[..., p, :])) for p in range(4)],
        axis=-2,
    )

    direction = points[..., 0, :] - pos  # (..., 3)
    light_normal = jnp.cross(
        points[..., 1, :] - points[..., 0, :], points[..., 3, :] - points[..., 0, :]
    )
    behind = jnp.sum(direction * light_normal, axis=-1) < 0.0

    vsum = (
        integrate_edge(Ln[..., 0, :], Ln[..., 1, :])
        + integrate_edge(Ln[..., 1, :], Ln[..., 2, :])
        + integrate_edge(Ln[..., 2, :], Ln[..., 3, :])
        + integrate_edge(Ln[..., 3, :], Ln[..., 0, :])
    )
    length = jnp.linalg.norm(vsum, axis=-1)
    z = vsum[..., 2] / jnp.maximum(length, 1e-20)
    z = jnp.where(behind, -z, z)
    uv = jnp.stack([z * 0.5 + 0.5, length], axis=-1) * LUT_SCALE + LUT_BIAS
    scale = sample_lut_bilinear_mxu(scene.ltc2[..., 3], uv)
    total = length * scale
    if not two_sided:
        total = jnp.where(behind, 0.0, total)
    return total  # (...,) scalar irradiance (vec3 splat in WGSL)


def _material_fields(scene: SceneData, gbuffer: GBuffer, albedo=None):
    """Fallback material fetch for shade()/shade_raytraced() called WITHOUT
    a ResolveAux (standalone demos): one packed material-row gather for ids
    + albedo texture extent + the constant-folded 1x1 texture values (the
    K-sized record build is dense and cheap; gathers cost by ROW, width is
    nearly free). The production frame gets these fields from the resolve
    pass instead (passes/resolve.py ResolveAux) — zero gathers here."""
    material_id = gbuffer.material
    uv = encoding.unpack2x16float(gbuffer.normal_uv[..., 1])
    mats = scene.materials
    sizes = scene.textures.size[mats.albedo].astype(jnp.float32)  # (K, 2)
    shade_rec = jnp.concatenate(
        [
            mats.albedo.astype(jnp.float32)[:, None],
            mats.emissive.astype(jnp.float32)[:, None],
            mats.metallic_roughness.astype(jnp.float32)[:, None],
            sizes,
            mats.emissive_rgba[:, :3],
            mats.mr_rgba,
            jnp.zeros((mats.albedo.shape[0], 4), jnp.float32),
        ],
        axis=-1,
    )  # (K, 16)
    srec = shade_rec[material_id]
    mat_albedo = srec[..., 0].astype(jnp.int32)
    mat_emissive = srec[..., 1].astype(jnp.int32)
    mat_mr = srec[..., 2].astype(jnp.int32)
    lod = uv_lod(uv, srec[..., 3], srec[..., 4])
    # NOTE: the reference samples the albedo texture only — material
    # base_color does NOT factor into shading (shading.wgsl:58, it is used
    # solely for the alpha cutoff in the raster pass). Parity kept.
    if albedo is None:
        albedo = sample_trilinear(scene.textures, mat_albedo, uv, lod)
    # 1x1 textures fold into the record (exact: any sample of a 1x1
    # texture is its texel) — skips a per-pixel gather each.
    if scene.emissive_const:
        emissive = srec[..., 5:8]
    else:
        emissive = sample_trilinear(
            scene.textures, mat_emissive, uv, lod
        )[..., :3]
    if scene.mr_const:
        mr = srec[..., 8:12]
    else:
        mr = sample_trilinear(scene.textures, mat_mr, uv, lod)
    return albedo, emissive, mr


def _area_light_terms(scene: SceneData, nor, rd, pos, roughness):
    """Accumulated area-light (diffuse-pre-albedo, specular) rgb terms for
    all area lights at the given pixel set (shading.wgsl:98-112)."""
    lights = scene.lights
    minv, _t1, t2 = ltc_matrix(scene, nor, rd, roughness)
    identity = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), minv.shape)
    acc_d = jnp.zeros(pos.shape[:-1] + (3,), jnp.float32)
    acc_s = jnp.zeros_like(acc_d)
    for i in range(lights.area_intensity.shape[0]):
        pts = lights.area_points[i]  # (4, 3)
        intensity = lights.area_intensity[i]
        lcol = lights.area_color[i]
        light_radius = 25.0
        center = (pts[0] + pts[2]) * 0.5
        diff = ltc_evaluate_rect(scene, nor, rd, pos, identity, pts)
        spec = ltc_evaluate_rect(scene, nor, rd, pos, minv, pts)
        # scolor = vec3(1): spec *= t2.x (ltc.wgsl:188-191)
        spec = spec * t2[..., 0]
        dist_c = jnp.linalg.norm(center - pos, axis=-1)
        atten = attenuation(intensity, 500.0, dist_c, light_radius)
        acc_d = acc_d + (lcol * intensity) * diff[..., None]
        acc_s = acc_s + (lcol * intensity) * (spec * atten)[..., None]
    return acc_d, acc_s


def _upsample2x_bilinear(a: jnp.ndarray) -> jnp.ndarray:
    """(h, w, C) -> (2h, 2w, C) bilinear upsample at half-pixel centers
    with edge clamp — jax.image.resize('bilinear') semantics at the fixed
    2x scale, built from static shifts + interleaves instead of the four
    dynamic gathers resize lowers to. Output row 2k mixes source rows
    (k-1, k) at (0.25, 0.75), row 2k+1 mixes (k, k+1) at (0.75, 0.25);
    edges renormalize to the clamped sample, exactly like resize."""

    def axis_up(x, axis):
        n = x.shape[axis]
        first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
        last = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
        prev = jnp.concatenate(
            [first, jax.lax.slice_in_dim(x, 0, n - 1, axis=axis)], axis
        )
        nxt = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 1, n, axis=axis), last], axis
        )
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        inter = jnp.stack([even, odd], axis=axis + 1)
        return inter.reshape(
            x.shape[:axis] + (2 * n,) + x.shape[axis + 1:]
        )

    return axis_up(axis_up(a, 0), 1)


def shade(scene: SceneData, gbuffer: GBuffer, camera, albedo=None,
          aux=None, area_light_scale: int = 1) -> jnp.ndarray:
    """G-buffer -> (H, W, 3) HDR color.

    `aux`: the ResolveAux from the resolve pass (albedo + emissive + mr per
    pixel) — the production path; this function then runs gather-free.
    `albedo`: optional pre-filtered albedo alone (shading.wgsl:58) when no
    aux is available.
    `area_light_scale=s` (a DOCUMENTED deviation, off by default): the
    LTC area-light terms are evaluated on every s-th pixel and bilinearly
    upsampled — an s^2 reduction of the LTC math for scenes where it
    dominates. Albedo modulation, point lights, emissive and visibility
    stay full-res.
    """
    depth = gbuffer.depth
    material_id = gbuffer.material
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])

    if aux is not None:
        albedo, emissive, mr = aux.albedo, aux.emissive, aux.mr
    else:
        albedo, emissive, mr = _material_fields(scene, gbuffer, albedo)

    pos = world_position_from_depth(depth, camera.clip_to_world)
    cam_pos = jnp.asarray(camera.position)[:3]
    rd = _normalize(cam_pos - pos)

    is_light = material_id == LIGHT_MATERIAL
    color = albedo[..., :3] * 0.01 + emissive
    color = jnp.where(is_light[..., None], albedo[..., :3] + emissive, color)

    # Point lights (python loop over the static light count unrolls in jit).
    lights = scene.lights
    for i in range(lights.point_radius.shape[0]):
        lpos = lights.point_position[i]
        lrad = lights.point_radius[i]
        lcol = lights.point_color[i]
        light_vec = lpos - pos
        dist = jnp.linalg.norm(light_vec, axis=-1)
        atten = attenuation(1.0, 1.0, dist, lrad)
        light_dir = _normalize(light_vec)
        shade_t = jnp.maximum(0.0, jnp.sum(nor * light_dir, axis=-1))
        diff = lcol * albedo[..., :3] * (shade_t * atten)[..., None]
        covr = jnp.maximum(0.0, jnp.sum(-rd * nor, axis=-1))
        spec = lcol * (mr[..., 2] * covr**16 * atten)[..., None]
        contrib = jnp.where((dist - lrad > 0.0)[..., None], 0.0, diff + spec)
        color = color + jnp.where(is_light[..., None], 0.0, contrib)

    # Area lights.
    if lights.area_intensity.shape[0] > 0:
        roughness = jnp.clip(mr[..., 0], 0.0, 1.0)
        if area_light_scale > 1:
            s = area_light_scale
            acc_d, acc_s = _area_light_terms(
                scene,
                fastmath.subsample_mm(nor, s),
                fastmath.subsample_mm(rd, s),
                fastmath.subsample_mm(pos, s),
                fastmath.subsample_mm(roughness[..., None], s)[..., 0],
            )
            H, W = pos.shape[:2]

            # Down/upsampling as dot_generals on constant matrices — the
            # MXU-native resize. Hardware-measured (r4 probe #2): four
            # [::2,::2] strided slices cost 28 ms at 1080p and
            # jax.image.resize 2x costs 1.3 ms/call, while the fused
            # subsample_mm + upsample_bilinear_mm round trip is ~1 ms
            # total; the old static-shift interleave made scale=2 SLOWER
            # than full-res LTC (26.1 vs 23.5 ms whole-shade).
            def up(a):
                return fastmath.upsample_bilinear_mm(a, s, H, W)

            acc_d, acc_s = up(acc_d), up(acc_s)
            contrib = albedo[..., :3] * acc_d + acc_s
            color = color + jnp.where(is_light[..., None], 0.0, contrib)
        else:
            # full-res: per-light combine, bit-exact legacy order
            minv, _t1, t2 = ltc_matrix(scene, nor, rd, roughness)
            identity = jnp.broadcast_to(
                jnp.eye(3, dtype=jnp.float32), minv.shape
            )
            for i in range(lights.area_intensity.shape[0]):
                pts = lights.area_points[i]  # (4, 3)
                intensity = lights.area_intensity[i]
                lcol = lights.area_color[i]
                light_radius = 25.0
                center = (pts[0] + pts[2]) * 0.5
                diff = ltc_evaluate_rect(scene, nor, rd, pos, identity, pts)
                spec = ltc_evaluate_rect(scene, nor, rd, pos, minv, pts)
                # scolor = vec3(1): spec *= t2.x (ltc.wgsl:188-191)
                spec = spec * t2[..., 0]
                dist_c = jnp.linalg.norm(center - pos, axis=-1)
                atten = attenuation(intensity, 500.0, dist_c, light_radius)
                contrib = (lcol * intensity)[None, None, :] * (
                    (spec * atten)[..., None]
                    + albedo[..., :3] * diff[..., None]
                )
                color = color + jnp.where(is_light[..., None], 0.0, contrib)

    return jnp.maximum(color, 0.0)


def _trace_occlusion_blocks(
    trav, tables, pos_g, nor_g, lpos, act_g, max_steps, ray_chunk,
    max_leaf, bh=8, bw=16, unroll=1,
):
    """Threaded traversal over 8x16 SCREEN-BLOCK packets. Row-strip packets
    (reshape(-1) order) span 128x1 pixels; a 8x16 block's rays share far
    more of the tree, so the packet-union path is shorter. Per-ray results
    are independent of packet grouping — bit-exact either way."""
    table, n_tlas, inst_rows, tri_pos = tables
    h, w = act_g.shape
    ph, pw = (-h) % bh, (-w) % bw
    o_g = pos_g + nor_g * 1e-4
    d_g = lpos - pos_g
    if ph or pw:
        o_g = jnp.pad(o_g, ((0, ph), (0, pw), (0, 0)))
        d_g = jnp.pad(d_g, ((0, ph), (0, pw), (0, 0)))
        act_g = jnp.pad(act_g, ((0, ph), (0, pw)))
    hb, wb = (h + ph) // bh, (w + pw) // bw

    def blocks(x):
        x = x.reshape((hb, bh, wb, bw) + x.shape[2:])
        x = jnp.swapaxes(x, 1, 2)
        return x.reshape((hb * wb, bh * bw) + x.shape[4:])

    P = bh * bw
    res = trav.occluded_threaded(
        table, n_tlas, inst_rows, tri_pos,
        blocks(o_g).reshape(-1, 3), blocks(d_g).reshape(-1, 3),
        t_max=1.0, max_steps=max_steps,
        active=blocks(act_g).reshape(-1),
        packet=P, chunk_packets=max(ray_chunk // P, 1),
        max_leaf=max_leaf, unroll=unroll,
    )
    hit = res.hit.reshape(hb, wb, bh, bw)
    hit = jnp.swapaxes(hit, 1, 2).reshape(hb * bh, wb * bw)
    return hit[:h, :w]


def shade_raytraced(
    scene: SceneData, gbuffer: GBuffer, camera, albedo=None, max_steps=512,
    ray_chunk=1 << 16, aux=None, shadow_scale=1, rt_packet=0,
    rt_threaded=False, rt_unroll=1,
) -> jnp.ndarray:
    """Deferred shading with TLAS-traced point-light shadows.

    Port of src/bin/raytraced_shadows.wgsl:58-119: ambient 0.3*albedo +
    emissive, magenta debug for material 0, shadow ray from
    pos + 0.0001*normal toward the light (t_max = 1 in light-vector units),
    occlusion 0.5 on hit, attenuation applied to (diff + spec) * occlusion.
    Requires scene.tlas (built at setup like the reference, app.rs:253).

    `shadow_scale=s` (a DOCUMENTED deviation, off by default): trace one
    shadow ray per s*s pixel block (the block's top-left sample) and
    broadcast the occlusion — an s^2 ray-count reduction for scenes where
    the lock-step traversal dominates (BASELINE config 5 at 1080p traces
    ~2M rays at full res). Shadow edges coarsen to s pixels; shading,
    attenuation and visibility remain full-res.

    `rt_packet=P` (BIT-EXACT, off by default): packet traversal — P
    screen-adjacent rays share one traversal stack, fetching node/
    triangle rows once per packet instead of once per ray (the per-ray
    lock-step loop's dominant cost). See rt.traverse.occluded_packets.
    """
    from ..rt import traverse as trav

    depth = gbuffer.depth
    material_id = gbuffer.material
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])
    H, W = depth.shape

    if aux is not None:
        albedo, emissive, mr = aux.albedo, aux.emissive, aux.mr
    else:
        albedo, emissive, mr = _material_fields(scene, gbuffer, albedo)

    pos = world_position_from_depth(depth, camera.clip_to_world)
    cam_pos = jnp.asarray(camera.position)[:3]
    rd = _normalize(cam_pos - pos)

    is_light = material_id == LIGHT_MATERIAL
    color = albedo[..., :3] * 0.3 + emissive
    color = jnp.where(is_light[..., None], albedo[..., :3] + emissive, color)

    if rt_threaded:
        tables_th = trav.scene_rays_threaded(scene)
        max_leaf = scene.meshes.bvh_max_leaf
    else:
        tlas, blas, inst, tri_pos = trav.scene_rays(scene)
    lights = scene.lights
    shadable = (depth > 0.0) & ~is_light
    for i in range(lights.point_radius.shape[0]):
        lpos = lights.point_position[i]
        lrad = lights.point_radius[i]
        lcol = lights.point_color[i]
        light_vec = lpos - pos
        dist = jnp.linalg.norm(light_vec, axis=-1)

        # EXACT ray skipping: occlusion only multiplies (diff + spec) *
        # atten, so pixels where that product is zero regardless of the
        # ray's outcome need no ray — backfacing (diff = 0 AND the pow-16
        # "spec" quirk's base <= 0) or out of light range (atten = 0).
        # Typically skips ~half the shadow rays with a bit-identical image.
        ndl = jnp.sum(nor * _normalize(light_vec), axis=-1)
        cov = jnp.sum(-rd * nor, axis=-1)
        needs_ray = shadable & (dist < lrad) & ((ndl > 0.0) | (cov > 0.0))

        if shadow_scale > 1:
            s = shadow_scale
            pos_s = pos[::s, ::s]
            nor_s = nor[::s, ::s]
            lv_s = lpos - pos_s
            hs, ws = pos_s.shape[:2]
            if rt_threaded:
                occ_small = _trace_occlusion_blocks(
                    trav, tables_th, pos_s, nor_s, lpos,
                    needs_ray[::s, ::s], max_steps * 8, ray_chunk, max_leaf,
                    unroll=rt_unroll,
                )
            elif rt_packet:
                occ_small = trav.occluded_packets(
                    tlas, blas, inst, tri_pos,
                    (pos_s + nor_s * 1e-4).reshape(-1, 3),
                    lv_s.reshape(-1, 3),
                    t_max=1.0,
                    max_steps=max_steps * 8,
                    active=needs_ray[::s, ::s].reshape(-1),
                    packet=rt_packet,
                    chunk_packets=max(ray_chunk // rt_packet, 1),
                ).hit.reshape(hs, ws)
            else:
                occ_small = trav.occluded(
                    tlas, blas, inst, tri_pos,
                    (pos_s + nor_s * 1e-4).reshape(-1, 3),
                    lv_s.reshape(-1, 3),
                    t_max=1.0,
                    max_steps=max_steps,
                    active=needs_ray[::s, ::s].reshape(-1),
                    chunk_size=ray_chunk,
                ).hit.reshape(hs, ws)
            occ_hit = jnp.repeat(
                jnp.repeat(occ_small, s, axis=0), s, axis=1
            )[:H, :W]
        elif rt_threaded:
            occ_hit = _trace_occlusion_blocks(
                trav, tables_th, pos, nor, lpos, needs_ray,
                max_steps * 8, ray_chunk, max_leaf, unroll=rt_unroll,
            )
        else:
            origins = (pos + nor * 1e-4).reshape(-1, 3)
            dirs = light_vec.reshape(-1, 3)
            if rt_packet:
                occ_hit = trav.occluded_packets(
                    tlas, blas, inst, tri_pos, origins, dirs,
                    t_max=1.0,
                    # a packet takes the UNION of its lanes' paths: more
                    # steps than any single lane, but each step costs
                    # 1/packet the gather rows
                    max_steps=max_steps * 8,
                    active=needs_ray.reshape(-1),
                    packet=rt_packet,
                    chunk_packets=max(ray_chunk // rt_packet, 1),
                ).hit.reshape(H, W)
            else:
                occ_hit = trav.occluded(
                    tlas,
                    blas,
                    inst,
                    tri_pos,
                    origins,
                    dirs,
                    t_max=1.0,
                    max_steps=max_steps,
                    active=needs_ray.reshape(-1),
                    chunk_size=ray_chunk,
                ).hit.reshape(H, W)
        occlusion = jnp.where(occ_hit, 0.5, 1.0)

        atten = attenuation(1.0, 1.0, dist, lrad)
        light_dir = _normalize(light_vec)
        shade_t = jnp.maximum(0.0, jnp.sum(nor * light_dir, axis=-1))
        diff = lcol * albedo[..., :3] * shade_t[..., None]
        covr = jnp.maximum(0.0, jnp.sum(-rd * nor, axis=-1))
        spec = lcol * (mr[..., 2] * covr**16)[..., None]
        contrib = (diff + spec) * (occlusion * atten)[..., None]
        color = color + jnp.where(shadable[..., None], contrib, 0.0)

    # reference renders material 0 as magenta (debug) — raytraced_shadows
    # .wgsl:83-85; background pixels resolve to material 0, so only apply
    # where geometry was hit.
    magenta = jnp.array([1.0, 0.0, 1.0], jnp.float32)
    color = jnp.where(
        ((material_id == 0) & (depth > 0.0))[..., None], magenta, color
    )
    return jnp.maximum(color, 0.0)


def _solve_cubic(c0, c1, c2, c3=1.0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0, vectorized/branchless.

    The numerically-robust split-algorithm form (Blinn / Peters, "How to
    solve a cubic equation, revisited", momentsingraphics.de/?p=105) that
    the reference's clipped-disk LTC uses (src/bin/ring_light.wgsl:101-187):
    the largest root from algorithm A, the smallest from algorithm D, the
    middle from their product — each as a homogeneous (num, den) pair.
    Returns (smallest-ish triple ordered so [1] is the middle root used by
    the disk form factor, matching the reference's partial sort)."""
    B = c2 / c3 / 3.0
    C = c1 / c3 / 3.0
    D = c0 / c3
    # Hessian + discriminant
    d1 = C - B * B
    d2 = D - C * B
    d3 = B * D - C * C
    disc = jnp.maximum(4.0 * d1 * d3 - d2 * d2, 0.0)
    sq_disc = jnp.sqrt(disc)

    # Algorithm A (largest root)
    d_a = -2.0 * B * d1 + d2
    theta_a = jnp.arctan2(sq_disc, -d_a) / 3.0
    sc_a = 2.0 * jnp.sqrt(jnp.maximum(-d1, 0.0))
    x1a = sc_a * jnp.cos(theta_a)
    x3a = sc_a * jnp.cos(theta_a + 2.0 * jnp.pi / 3.0)
    xl = jnp.where(x1a + x3a > 2.0 * B, x1a, x3a)
    xlc = jnp.stack([xl - B, jnp.ones_like(xl) * c3], axis=-1)

    # Algorithm D (smallest root)
    d_d = -D * d2 + 2.0 * C * d3
    theta_d = jnp.arctan2(D * sq_disc, -d_d) / 3.0
    sc_d = 2.0 * jnp.sqrt(jnp.maximum(-d3, 0.0))
    x1d = sc_d * jnp.cos(theta_d)
    x3d = sc_d * jnp.cos(theta_d + 2.0 * jnp.pi / 3.0)
    xs = jnp.where(x1d + x3d < 2.0 * C, x1d, x3d)
    xsc = jnp.stack([-D, xs + C], axis=-1)

    e = xlc[..., 1] * xsc[..., 1]
    f = -xlc[..., 0] * xsc[..., 1] - xlc[..., 1] * xsc[..., 0]
    g = xlc[..., 0] * xsc[..., 0]
    xmc = jnp.stack([C * f - B * g, -B * f + C * e], axis=-1)

    def div(pair):
        d = pair[..., 1]
        d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
        return pair[..., 0] / d

    rx, ry, rz = div(xsc), div(xmc), div(xlc)
    # partial sort (ring_light.wgsl:178-184): ensure [1] is the middle
    x_small = (rx < ry) & (rx < rz)
    z_small = (rz < rx) & (rz < ry)
    r0 = jnp.where(x_small, ry, rx)
    r1 = jnp.where(x_small, rx, jnp.where(z_small, rz, ry))
    r2 = jnp.where(z_small, ry, rz)
    return r0, r1, r2


def ltc_evaluate_disk(scene: SceneData, nor, view, pos, mminv, points3,
                      two_sided=False):
    """EXACT clipped-disk (ellipse) LTC evaluation — the analytic sphere
    form factor of the cosine-space ellipse, replacing any polygonal
    approximation (port of ltc_evaluate_ring, ring_light.wgsl:189-305:
    ellipse eigen-decomposition + cubic solve + tabulated horizon-clipped
    sphere). points3: (3, 3) three corners of the disk's bounding rect
    (-ex-ey, +ex-ey, +ex+ey); pixel fields (..., 3)."""
    t1v = _normalize(view - nor * jnp.sum(view * nor, axis=-1, keepdims=True))
    t2v = jnp.cross(nor, t1v)
    basis = jnp.stack([t1v, t2v, nor], axis=-2)  # rows T1, T2, N
    minv = fastmath.mat3_mat3(mminv, basis)

    rel = points3[..., None, :, :] - pos[..., None, :]  # (..., 3, 3)
    l0 = fastmath.mat3_vec(minv, rel[..., 0, :])
    l1 = fastmath.mat3_vec(minv, rel[..., 1, :])
    l2 = fastmath.mat3_vec(minv, rel[..., 2, :])

    c = 0.5 * (l0 + l2)
    v1 = 0.5 * (l1 - l2)
    v2 = 0.5 * (l1 - l0)

    front = jnp.sum(jnp.cross(v1, v2) * c, axis=-1) >= 0.0
    occlusion = (
        jnp.ones_like(front, jnp.float32) if two_sided
        else front.astype(jnp.float32)
    )

    d11 = jnp.sum(v1 * v1, axis=-1)
    d22 = jnp.sum(v2 * v2, axis=-1)
    d12 = jnp.sum(v1 * v2, axis=-1)
    skew = jnp.abs(d12) / jnp.sqrt(jnp.maximum(d11 * d22, 1e-20)) > 1e-4

    # Eigen-decomposition branch (branchless: both paths, then select).
    tr = d11 + d22
    det = jnp.sqrt(jnp.maximum(d11 * d22 - d12 * d12, 0.0))
    u = 0.5 * jnp.sqrt(jnp.maximum(tr - 2.0 * det, 0.0))
    w = 0.5 * jnp.sqrt(jnp.maximum(tr + 2.0 * det, 0.0))
    e_max = (u + w) ** 2
    e_min = (u - w) ** 2
    big11 = (d11 > d22)[..., None]
    v1e = jnp.where(
        big11,
        d12[..., None] * v1 + (e_max - d11)[..., None] * v2,
        d12[..., None] * v2 + (e_max - d22)[..., None] * v1,
    )
    v2e = jnp.where(
        big11,
        d12[..., None] * v1 + (e_min - d11)[..., None] * v2,
        d12[..., None] * v2 + (e_min - d22)[..., None] * v1,
    )
    a_e = 1.0 / jnp.maximum(e_max, 1e-20)
    b_e = 1.0 / jnp.maximum(e_min, 1e-20)
    # Aligned branch
    a_s = 1.0 / jnp.maximum(d11, 1e-20)
    b_s = 1.0 / jnp.maximum(d22, 1e-20)

    a = jnp.where(skew, a_e, a_s)
    b = jnp.where(skew, b_e, b_s)
    sk = skew[..., None]
    v1 = jnp.where(sk, _normalize(v1e), v1 * jnp.sqrt(a_s)[..., None])
    v2 = jnp.where(sk, _normalize(v2e), v2 * jnp.sqrt(b_s)[..., None])

    v3 = jnp.cross(v1, v2)
    flip = (jnp.sum(c * v3, axis=-1) < 0.0)[..., None]
    v3 = jnp.where(flip, -v3, v3)

    ll = jnp.sum(v3 * c, axis=-1)
    ll_safe = jnp.where(jnp.abs(ll) > 1e-20, ll, 1e-20)
    x0 = jnp.sum(v1 * c, axis=-1) / ll_safe
    y0 = jnp.sum(v2 * c, axis=-1) / ll_safe

    a = a * ll * ll
    b = b * ll * ll

    c0 = a * b
    c1 = a * b * (1.0 + x0 * x0 + y0 * y0) - a - b
    c2 = 1.0 - a * (1.0 + x0 * x0) - b * (1.0 + y0 * y0)
    e1, e2, e3 = _solve_cubic(c0, c1, c2)

    avg = jnp.stack(
        [
            a * x0 / jnp.where(jnp.abs(a - e2) > 1e-20, a - e2, 1e-20),
            b * y0 / jnp.where(jnp.abs(b - e2) > 1e-20, b - e2, 1e-20),
            jnp.ones_like(x0),
        ],
        axis=-1,
    )
    # rotate = columns (V1, V2, V3): avg_world = V1*ax + V2*ay + V3*az
    avg_dir = _normalize(
        v1 * avg[..., 0:1] + v2 * avg[..., 1:2] + v3 * avg[..., 2:3]
    )

    l1f = jnp.sqrt(jnp.maximum(-e2 / jnp.where(
        jnp.abs(e3) > 1e-20, e3, 1e-20), 0.0))
    l2f = jnp.sqrt(jnp.maximum(-e2 / jnp.where(
        jnp.abs(e1) > 1e-20, e1, 1e-20), 0.0))
    form = l1f * l2f / jnp.sqrt((1.0 + l1f * l1f) * (1.0 + l2f * l2f))

    uv = jnp.stack([avg_dir[..., 2] * 0.5 + 0.5, form], axis=-1)
    uv = uv * LUT_SCALE + LUT_BIAS
    scale = sample_lut_bilinear_mxu(scene.ltc2[..., 3], uv)
    return form * scale * occlusion


def disk_points3(center, dirx, diry, halfx, halfy):
    """(3, 3) corner triple (-ex-ey, +ex-ey, +ex+ey) of a disk's bounding
    rect (init_disk_points, ring_light.wgsl:69-80), host-side numpy."""
    import numpy as np

    center = np.asarray(center, np.float32)
    ex = float(halfx) * np.asarray(dirx, np.float32)
    ey = float(halfy) * np.asarray(diry, np.float32)
    return np.stack([center - ex - ey, center + ex - ey, center + ex + ey])


def ltc_evaluate_ring2(scene: SceneData, nor, view, pos, mminv,
                       center, dirx, diry, halfx, halfy, two_sided=False):
    """Annulus = full disk minus a shrunk inner disk (ltc_evaluate_ring2,
    ring_light.wgsl:307-321: the outer disk is the UN-grown `disk` — the
    grown disk1 is dead code in the reference — and the inner shrinks by
    clamp(0.5, 0.05, 0.95*half))."""
    import numpy as np

    r, eps = 0.5, 0.05
    dx = float(np.clip(r, eps, 0.95 * halfx))
    dy = float(np.clip(r, eps, 0.95 * halfy))
    p_out = jnp.asarray(disk_points3(center, dirx, diry, halfx, halfy))
    p_in = jnp.asarray(
        disk_points3(center, dirx, diry, halfx - dx, halfy - dy)
    )
    return ltc_evaluate_disk(
        scene, nor, view, pos, mminv, p_out, two_sided
    ) - ltc_evaluate_disk(scene, nor, view, pos, mminv, p_in, two_sided)


def ltc_evaluate_polygon(scene: SceneData, nor, view, pos, mminv, points,
                         two_sided=False):
    """N-vertex generalization of ltc_evaluate_rect (the reference's
    ring_light demo integrates rings with specialized clipped-disk math,
    src/bin/ring_light.wgsl; here a ring is outer polygon minus inner
    polygon). Only the VECTOR form factor is linear in the edge integral;
    the scalar result applies |vsum| and the nonlinear horizon-clip LUT per
    polygon, so outer-minus-inner is an approximation that can go slightly
    negative — shade_ring_light clamps it.

    points: (P, 3) static vertex count, counter-clockwise."""
    P = points.shape[-2]
    t1v = _normalize(view - nor * jnp.sum(view * nor, axis=-1, keepdims=True))
    t2v = jnp.cross(nor, t1v)
    basis = jnp.stack([t1v, t2v, nor], axis=-2)
    minv = fastmath.mat3_mat3(mminv, basis)

    rel = points[..., None, :, :] - pos[..., None, :]  # (..., P, 3)
    Ln = jnp.stack(
        [_normalize(fastmath.mat3_vec(minv, rel[..., p, :])) for p in range(P)],
        axis=-2,
    )
    direction = points[..., 0, :] - pos
    light_normal = jnp.cross(
        points[..., 1, :] - points[..., 0, :],
        points[..., P - 1, :] - points[..., 0, :],
    )
    behind = jnp.sum(direction * light_normal, axis=-1) < 0.0

    vsum = 0.0
    for p in range(P):
        vsum = vsum + integrate_edge(Ln[..., p, :], Ln[..., (p + 1) % P, :])
    length = jnp.linalg.norm(vsum, axis=-1)
    z = vsum[..., 2] / jnp.maximum(length, 1e-20)
    z = jnp.where(behind, -z, z)
    uv = jnp.stack([z * 0.5 + 0.5, length], axis=-1) * LUT_SCALE + LUT_BIAS
    scale = sample_lut_bilinear_mxu(scene.ltc2[..., 3], uv)
    total = length * scale
    if not two_sided:
        total = jnp.where(behind, 0.0, total)
    return total


def ring_points(center, normal_dir, radius, n=16):
    """CCW n-gon approximating a disk boundary (host-side, numpy)."""
    import numpy as np

    normal_dir = np.asarray(normal_dir, np.float32)
    normal_dir = normal_dir / np.linalg.norm(normal_dir)
    up = np.array([0, 1, 0], np.float32)
    if abs(np.dot(up, normal_dir)) > 0.99:
        up = np.array([1, 0, 0], np.float32)
    t = np.cross(up, normal_dir)
    t /= np.linalg.norm(t)
    b = np.cross(normal_dir, t)
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return (
        np.asarray(center, np.float32)
        + radius * (np.cos(a)[:, None] * t + np.sin(a)[:, None] * b)
    ).astype(np.float32)


def shade_ring_light(scene: SceneData, gbuffer: GBuffer, camera,
                     disk_center=(-3.0, 3.5, 10.0),
                     disk_dirx=(1.0, 0.0, 0.0), disk_diry=(0.0, 1.0, 0.0),
                     halfx=3.0, halfy=3.0, roughness=0.3, two_sided=True,
                     albedo=None):
    """Deferred shading with one LTC ring light — exact port of the
    ring_light demo FS (src/bin/ring_light.wgsl:340-440):

    * the pixel ray (from the shaded point TOWARD the camera — a reference
      quirk, kept) is intersected with the disk plane; hits inside the
      annulus band 0.7 < (x/hx)^2+(y/hy)^2 <= 1 render as the emitter;
    * material 0 renders as flat 0.13 grey, LIGHT_MATERIAL as
      albedo + emissive;
    * spec = ltc_evaluate_ring2 (full disk minus shrunk disk) * t2.x with
      the fitted Minv at fixed roughness 0.3; diffuse = ltc_evaluate_ring
      of the FULL disk with the identity matrix (the reference's diffuse
      is the whole disk, not the annulus);
    * color = spec + diffuse (scolor = dcolor = 1; albedo unused)."""
    import numpy as np

    depth = gbuffer.depth
    material_id = gbuffer.material
    uv = encoding.unpack2x16float(gbuffer.normal_uv[..., 1])
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])
    mats = scene.materials
    mat_albedo = mats.albedo[material_id]
    sizes = scene.textures.size[mat_albedo].astype(jnp.float32)
    lod = uv_lod(uv, sizes[..., 0], sizes[..., 1])
    if albedo is None:
        albedo = sample_trilinear(scene.textures, mat_albedo, uv, lod)
    emissive = sample_trilinear(
        scene.textures, mats.emissive[material_id], uv, lod
    )[..., :3]
    pos = world_position_from_depth(depth, camera.clip_to_world)
    rd = _normalize(jnp.asarray(camera.position)[:3] - pos)

    center = np.asarray(disk_center, np.float32)
    dirx = np.asarray(disk_dirx, np.float32)
    diry = np.asarray(disk_diry, np.float32)
    dn = np.cross(dirx, diry)

    rough = jnp.full(depth.shape, float(roughness), jnp.float32)
    minv, _t1, t2 = ltc_matrix(scene, nor, rd, rough)
    identity = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), minv.shape)

    spec = ltc_evaluate_ring2(
        scene, nor, rd, pos, minv, center, dirx, diry, halfx, halfy,
        two_sided=two_sided,
    ) * t2[..., 0]
    diff = ltc_evaluate_disk(
        scene, nor, rd, pos, identity,
        jnp.asarray(disk_points3(center, dirx, diry, halfx, halfy)),
        two_sided=two_sided,
    )
    lit = jnp.maximum(spec + diff, 0.0)[..., None] * jnp.ones(
        (3,), jnp.float32
    )

    # ray_disc_intersect (ring_light.wgsl:82-98) with Ray2(pos, rd)
    plane_n = jnp.asarray(dn)
    denom = jnp.sum(rd * plane_n, axis=-1)
    t_hit = -(jnp.sum(pos * plane_n, axis=-1) - float(np.dot(dn, center))) / (
        jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    )
    hit_p = pos + rd * t_hit[..., None]
    lp = hit_p - jnp.asarray(center)
    hx = jnp.sum(lp * jnp.asarray(dirx), axis=-1) / halfx
    hy = jnp.sum(lp * jnp.asarray(diry), axis=-1) / halfy
    ab = hx * hx + hy * hy
    disk_hit = (t_hit > 0.0) & (ab >= 0.7) & (ab <= 1.0)

    out = jnp.where(
        (material_id == 0)[..., None],
        jnp.asarray([0.13, 0.13, 0.13], jnp.float32),
        lit,
    )
    out = jnp.where(
        (material_id == LIGHT_MATERIAL)[..., None],
        albedo[..., :3] + emissive,
        out,
    )
    out = jnp.where(disk_hit[..., None], albedo[..., :3] + emissive, out)
    return jnp.maximum(out, 0.0)
