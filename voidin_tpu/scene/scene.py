"""Scene container: the World-equivalent.

The reference keeps every subsystem in a TypeId->Any `World`
(components/src/world.rs:81-162) populated at App::new (app.rs:134-158).
Here the host-side :class:`World` owns the pools and asset import, and
``World.device()`` freezes them into :class:`SceneData` — a single pytree of
device arrays that the jitted frame function closes over. Nothing in
SceneData is host-resident; a frame touches HBM only.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..rt import bvh as bvh_mod
from .instance import InstanceData, InstancePool
from .light import LightData, LightPool
from .material import LIGHT_MATERIAL, MaterialData, MaterialPool
from .mesh import VERTICAL_PLANE_MESH, MeshPool, MeshPoolData
from .texture import TexturePool, TexturePoolData
from .ltc import load_ltc_tables


@struct.dataclass
class TlasData:
    tlas_min: jnp.ndarray  # (B, 3) f32
    tlas_max: jnp.ndarray  # (B, 3) f32
    tlas_left_right: jnp.ndarray  # (B,) uint32 (lo16 left, hi16 right; 0 = leaf)
    tlas_instance: jnp.ndarray  # (B,) int32
    # In-jit refit plan (rt/bvh.py tlas_refit_plan): level-ordered node ids
    # (deepest first), children (-1 = leaf), leaf instance ids. Lets frames
    # with skinned geometry re-fit instance world AABBs bottom-up without
    # rebuilding the topology.
    # Stackless exit links (rt/bvh.py tlas_exit_links), encoded e+1 with
    # 0 = traversal done. Topology-only; refits never touch it.
    tlas_exit: jnp.ndarray = struct.field(default=None)  # (B,) i32
    refit_order: jnp.ndarray = struct.field(default=None)  # (B,) i32
    refit_child: jnp.ndarray = struct.field(default=None)  # (B, 2) i32
    refit_instance: jnp.ndarray = struct.field(default=None)  # (B,) i32
    refit_levels: tuple = struct.field(pytree_node=False, default=())


@struct.dataclass
class SceneData:
    meshes: MeshPoolData
    instances: InstanceData
    materials: MaterialData
    lights: LightData
    textures: TexturePoolData
    ltc1: jnp.ndarray  # (64, 64, 4) f32 (reference layout, for tests)
    ltc2: jnp.ndarray  # (64, 64, 4) f32
    ltc1_quads: jnp.ndarray  # (64*64, 16) f32 packed 2x2 quads
    ltc2_quads: jnp.ndarray  # (64*64, 16) f32
    # both tables' quads side by side: one 128B gather serves t1+t2
    ltc12_quads: jnp.ndarray  # (64*64, 32) f32
    tlas: Optional[TlasData] = None
    # Static: any material needs per-texel alpha cutoff inside the depth
    # competition (visibility.wgsl:79-81 discard). Enables the raster's
    # second-candidate tracking; scenes without masked content pay nothing.
    alpha_masked: bool = struct.field(pytree_node=False, default=False)
    # Static constant-folding flags (gathers are the dominant per-pixel
    # cost; a 1x1 texture's "fetch" is a per-material constant): every
    # material's emissive / metallic-roughness texture is 1x1, so shading
    # reads MaterialData.emissive_rgba / mr_rgba instead of sampling.
    emissive_const: bool = struct.field(pytree_node=False, default=False)
    mr_const: bool = struct.field(pytree_node=False, default=False)
    # Static: no material has a normal map (normal == WHITE per
    # material.rs:45 defaults / visibility.wgsl:83) — resolve skips the
    # per-pixel normal-texture fetch entirely.
    no_normal_maps: bool = struct.field(pytree_node=False, default=False)
    # Static per-slot sRGB flags (True/False when every texture a slot can
    # touch shares one flag; None = mixed -> per-pixel gather). Textures
    # whose texels are all 0/255 are sRGB fixed points and never block the
    # static. Saves one per-pixel flag gather per texture tap
    # (sample_trilinear srgb=).
    albedo_srgb: Optional[bool] = struct.field(pytree_node=False,
                                               default=None)
    normal_srgb: Optional[bool] = struct.field(pytree_node=False,
                                               default=None)
    emissive_srgb: Optional[bool] = struct.field(pytree_node=False,
                                                 default=None)
    mr_srgb: Optional[bool] = struct.field(pytree_node=False, default=None)
    # Vertex skinning regions (beyond reference parity — the wgpu importer
    # drops glTF skins). Each SkinData re-computes its pool triangle range
    # from per-frame joint matrices inside the frame jit.
    skins: tuple = ()


class World:
    """Host-side scene assembly (pools + lights + asset import)."""

    def __init__(self, texture_base_size: int = 1024, build_bvh: bool = True):
        self.meshes = MeshPool(build_bvh=build_bvh)
        self.instances = InstancePool()
        self.materials = MaterialPool()
        self.lights = LightPool()
        self.textures = TexturePool(base_size=texture_base_size)
        self.skins: list = []  # SkinData entries (scene/skin.py)
        self._n_joints = 0

    def allocate_joints(self, n: int) -> int:
        """Reserve n rows in the frame's concatenated joint-matrix array;
        returns the skin's offset."""
        off = self._n_joints
        self._n_joints += int(n)
        return off

    @property
    def total_joints(self) -> int:
        return self._n_joints

    def add_area_light(self, color, intensity, wh, transform):
        """Adds the light and an emissive quad instance (app.rs:220-236)."""
        self.lights.add_area_light_from_transform(color, intensity, wh, transform)
        wh = np.asarray(wh, np.float32)
        scale = np.diag([wh[0] / 2.0, wh[1] / 2.0, 1.0, 1.0]).astype(np.float32)
        self.instances.add(
            np.asarray(transform, np.float32) @ scale,
            VERTICAL_PLANE_MESH,
            LIGHT_MATERIAL,
        )

    def build_tlas(self) -> TlasData:
        mesh_h = self.meshes.host_arrays()
        inst_h = self.instances.host_arrays()
        imin, imax = bvh_mod.instance_world_aabbs(
            mesh_h["mesh_min"],
            mesh_h["mesh_max"],
            inst_h["transform"],
            inst_h["mesh_id"],
        )
        nodes = bvh_mod.build_tlas(imin, imax)
        plan = bvh_mod.tlas_refit_plan(nodes)
        return TlasData(
            tlas_min=jnp.asarray(np.ascontiguousarray(nodes["min"])),
            tlas_max=jnp.asarray(np.ascontiguousarray(nodes["max"])),
            tlas_left_right=jnp.asarray(np.ascontiguousarray(nodes["left_right"])),
            tlas_instance=jnp.asarray(
                np.ascontiguousarray(nodes["instance_idx"]).astype(np.int64)
            ).astype(jnp.int32),
            tlas_exit=jnp.asarray(bvh_mod.tlas_exit_links(nodes)),
            refit_order=jnp.asarray(plan["order"]),
            refit_child=jnp.asarray(plan["child"]),
            refit_instance=jnp.asarray(plan["instance"]),
            refit_levels=plan["levels"],
        )

    def any_alpha_mask(self) -> bool:
        """True if any material can cut fragments per texel: an opaque
        base color (w >= 0.5 — otherwise the whole triangle is dropped at
        setup) with an albedo texture containing texels of alpha < 0.5."""
        for bc, albedo in zip(self.materials.base_color, self.materials.albedo):
            if bc[3] >= 0.5 and self.textures.has_mask(albedo):
                return True
        return False

    def _slot_srgb_static(self, tex_ids) -> Optional[bool]:
        """One shared sRGB flag for a material texture slot, or None when
        genuinely mixed. Pure-{0, 255} textures (WHITE/BLACK and friends)
        are sRGB fixed points — decode(0) = 0, decode(1) = 1 — so their
        flag cannot matter and never blocks the static."""
        flags = set()
        for t in sorted(set(int(t) for t in tex_ids)):
            img = self.textures.images[t]
            if bool(np.isin(img, (0, 255)).all()):
                continue
            flags.add(bool(self.textures.srgb_flags[t]))
        if len(flags) > 1:
            return None
        return flags.pop() if flags else False

    def device(self, with_tlas: bool = False,
               tap_blocks: bool = True) -> SceneData:
        from .texture import pack_lut_quads

        ltc1, ltc2 = load_ltc_tables()
        mats = self.materials
        return SceneData(
            meshes=self.meshes.device(),
            instances=self.instances.device(),
            materials=self.materials.device(textures=self.textures),
            lights=self.lights.device(),
            textures=self.textures.device(blocks=tap_blocks),
            ltc1=jnp.asarray(ltc1),
            ltc2=jnp.asarray(ltc2),
            ltc1_quads=jnp.asarray(pack_lut_quads(ltc1)),
            ltc2_quads=jnp.asarray(pack_lut_quads(ltc2)),
            ltc12_quads=jnp.asarray(
                np.concatenate([pack_lut_quads(ltc1), pack_lut_quads(ltc2)], -1)
            ),
            tlas=self.build_tlas() if with_tlas else None,
            alpha_masked=self.any_alpha_mask(),
            emissive_const=all(
                self.textures.is_const(t) for t in mats.emissive
            ),
            mr_const=all(
                self.textures.is_const(t) for t in mats.metallic_roughness
            ),
            no_normal_maps=all(t == 0 for t in mats.normal),
            albedo_srgb=self._slot_srgb_static(mats.albedo),
            normal_srgb=self._slot_srgb_static(mats.normal),
            emissive_srgb=self._slot_srgb_static(mats.emissive),
            mr_srgb=self._slot_srgb_static(mats.metallic_roughness),
            skins=tuple(self.skins),
        )
