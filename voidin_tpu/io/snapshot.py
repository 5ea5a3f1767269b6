"""Scene snapshot: serialize device scene state + camera to npz.

SURVEY.md §5.4: the reference has no checkpointing (scenes rebuild from
assets each run); for deterministic benchmark replay and image-diff
validation we serialize the frozen SceneData pytree and camera to one npz.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.camera import Camera
from ..scene.scene import SceneData


# v2: MeshPoolData gained lod_table/lod_thresh, TlasData gained refit_*.
# v3: TexturePoolData gained child_blocks/parent_blocks (quad-rate tap).
#     SceneData's per-slot sRGB statics are NOT snapshotted: a loaded
#     scene falls back to the per-pixel flag gather — identical samples.
# v4: TlasData gained tlas_exit (stackless traversal exit links); loader
#     now skips non-pytree statics instead of consuming leaves for them,
#     and MeshPoolData.bvh_max_leaf rides aux_mesh_leaf.
# v5: TexturePoolData gained the 16 B split twins quads_child/quads_parent
#     (present only for pools above the gather cliff; aux_tex_split).
SNAPSHOT_VERSION = 5


def save_scene(path: str, scene: SceneData, camera: Optional[Camera] = None):
    # Skinning data is rebuilt from assets, not snapshotted (the leaf
    # enumeration below predates skins and load_scene restores skins=()).
    if scene.skins:
        scene = scene.replace(skins=())
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    payload = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    # static aux data needed to rebuild (texture pool statics)
    tex = scene.textures
    payload["aux_level_offset"] = np.asarray(tex.level_offset, np.int64)
    payload["aux_base_size"] = np.asarray([tex.base_size, tex.total], np.int64)
    payload["aux_has_tlas"] = np.asarray([scene.tlas is not None], bool)
    if scene.tlas is not None:
        payload["aux_tlas_levels"] = np.asarray(
            scene.tlas.refit_levels, np.int64
        ).reshape(-1, 2)
    payload["aux_flags"] = np.asarray(
        [scene.alpha_masked, scene.emissive_const, scene.mr_const,
         scene.no_normal_maps], bool
    )
    payload["aux_mesh_flags"] = np.asarray([scene.meshes.has_lods], bool)
    payload["aux_mesh_leaf"] = np.asarray(
        [scene.meshes.bvh_max_leaf], np.int64
    )
    # None-valued pytree fields flatten to zero leaves — record which
    # optional texture tables are present so load realigns the stream
    payload["aux_tex_blocks"] = np.asarray(
        [scene.textures.child_blocks is not None], bool
    )
    if tex.host_sizes is not None:
        payload["aux_tex_host_sizes"] = np.asarray(tex.host_sizes, np.int64)
    payload["aux_tex_split"] = np.asarray(
        [scene.textures.quads_child is not None], bool
    )
    # Bump when pytree fields change: old files CANNOT load anyway (the
    # leaf_i stream misaligns against the new dataclass fields), so load
    # fails loudly on a version mismatch instead of corrupting silently.
    payload["aux_version"] = np.asarray([SNAPSHOT_VERSION], np.int64)
    if camera is not None:
        payload["cam"] = np.asarray(
            [*camera.position, camera.yaw, camera.pitch, camera.aspect], np.float32
        )
    np.savez_compressed(path, **payload)


def load_scene(path: str) -> Tuple[SceneData, Optional[Camera]]:
    from ..scene.instance import InstanceData
    from ..scene.light import LightData
    from ..scene.mesh import MeshPoolData
    from ..scene.material import MaterialData
    from ..scene.scene import TlasData
    from ..scene.texture import TexturePoolData

    data = np.load(path, allow_pickle=False)
    version = int(data["aux_version"][0]) if "aux_version" in data else 1
    if version != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot {path!r} is format v{version}, this build reads "
            f"v{SNAPSHOT_VERSION}; the flat leaf stream misaligns across "
            f"versions (pytree fields changed) — re-save the scene with "
            f"this build"
        )
    # Rebuild the treedef from a structurally-identical dummy: field order
    # of core.struct dataclasses is deterministic, so flatten order matches.
    has_tlas = bool(data["aux_has_tlas"][0])

    leaves = []
    i = 0
    while f"leaf_{i}" in data:
        leaves.append(jnp.asarray(data[f"leaf_{i}"]))
        i += 1

    # Build a skeleton SceneData with matching treedef.
    def fields(cls):
        import dataclasses

        return [f.name for f in dataclasses.fields(cls)]

    # Reconstruct by consuming leaves in flatten order (core.struct dataclasses
    # flatten pytree fields in declaration order).
    it = iter(leaves)

    def take(cls, static=None):
        import dataclasses

        kwargs = {}
        for f in dataclasses.fields(cls):
            if static and f.name in static:
                kwargs[f.name] = static[f.name]
            elif not f.metadata.get("pytree_node", True):
                # non-pytree statics never appear in the leaf stream;
                # without a value from aux they keep their class default
                # (round-5 fix: MeshPoolData.bvh_max_leaf silently shifted
                # the stream and load died with StopIteration at the TLAS)
                continue
            else:
                kwargs[f.name] = next(it)
        return cls(**kwargs)

    mesh_flags = [bool(x) for x in data["aux_mesh_flags"]]
    mesh_static = dict(has_lods=mesh_flags[0])
    if "aux_mesh_leaf" in data:
        mesh_static["bvh_max_leaf"] = int(data["aux_mesh_leaf"][0])
    meshes = take(MeshPoolData, static=mesh_static)
    instances = take(InstanceData)
    materials = take(MaterialData)
    lights = take(LightData)
    tex_static = dict(
        level_offset=tuple(int(o) for o in data["aux_level_offset"]),
        base_size=int(data["aux_base_size"][0]),
        total=int(data["aux_base_size"][1]),
    )
    if "aux_tex_host_sizes" in data:
        tex_static["host_sizes"] = tuple(
            (int(w), int(h)) for w, h in data["aux_tex_host_sizes"]
        )
    has_blocks = (bool(data["aux_tex_blocks"][0])
                  if "aux_tex_blocks" in data else True)
    if not has_blocks:
        tex_static.update(child_blocks=None, parent_blocks=None)
    has_split = (bool(data["aux_tex_split"][0])
                 if "aux_tex_split" in data else False)
    if not has_split:
        tex_static.update(quads_child=None, quads_parent=None)
    textures = take(TexturePoolData, static=tex_static)
    ltc1 = next(it)
    ltc2 = next(it)
    ltc1_quads = next(it)
    ltc2_quads = next(it)
    ltc12_quads = next(it)
    if has_tlas:
        levels = tuple((int(s), int(e)) for s, e in data["aux_tlas_levels"])
        tlas = take(TlasData, static=dict(refit_levels=levels))
    else:
        tlas = None
    flags = [bool(x) for x in data["aux_flags"]]

    scene = SceneData(
        meshes=meshes,
        instances=instances,
        materials=materials,
        lights=lights,
        textures=textures,
        ltc1=ltc1,
        ltc2=ltc2,
        ltc1_quads=ltc1_quads,
        ltc2_quads=ltc2_quads,
        ltc12_quads=ltc12_quads,
        tlas=tlas,
        alpha_masked=flags[0],
        emissive_const=flags[1],
        mr_const=flags[2],
        no_normal_maps=flags[3],
    )
    camera = None
    if "cam" in data:
        c = data["cam"]
        camera = Camera(
            position=c[:3], yaw=float(c[3]), pitch=float(c[4]), aspect=float(c[5])
        )
    return scene, camera
