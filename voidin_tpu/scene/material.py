"""Material pool (Material struct of shared.wgsl; pools/src/material.rs).

Three default materials are seeded (ids 0..2); LIGHT_MATERIAL = 2 marks
emissive light-quad instances (material.rs:45).
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np
from ..core import struct

from .texture import BLACK_TEXTURE, WHITE_TEXTURE

LIGHT_MATERIAL = 2


@struct.dataclass
class MaterialData:
    base_color: jnp.ndarray  # (K, 4) f32
    albedo: jnp.ndarray  # (K,) i32 texture id
    normal: jnp.ndarray  # (K,) i32
    metallic_roughness: jnp.ndarray  # (K,) i32
    emissive: jnp.ndarray  # (K,) i32
    # Constant-folded 1x1 texture values (linear space): sampling a 1x1
    # texture at any uv/lod returns its single texel, so when EVERY material
    # in a scene uses a 1x1 emissive / metallic-roughness map (the default
    # BLACK), the per-pixel fetch collapses into the material record —
    # SceneData.emissive_const / mr_const gate the fast path. Zeros when the
    # scene has real textures for that slot.
    emissive_rgba: jnp.ndarray = None  # (K, 4) f32
    mr_rgba: jnp.ndarray = None  # (K, 4) f32


class MaterialPool:
    def __init__(self, with_defaults: bool = True):
        self.base_color: List[np.ndarray] = []
        self.albedo: List[int] = []
        self.normal: List[int] = []
        self.metallic_roughness: List[int] = []
        self.emissive: List[int] = []
        if with_defaults:
            for _ in range(3):
                self.add()

    def __len__(self):
        return len(self.albedo)

    def add(
        self,
        base_color=(1.0, 1.0, 1.0, 1.0),
        albedo: int = WHITE_TEXTURE,
        normal: int = WHITE_TEXTURE,
        metallic_roughness: int = BLACK_TEXTURE,
        emissive: int = BLACK_TEXTURE,
    ) -> int:
        self.base_color.append(np.asarray(base_color, np.float32))
        self.albedo.append(int(albedo))
        self.normal.append(int(normal))
        self.metallic_roughness.append(int(metallic_roughness))
        self.emissive.append(int(emissive))
        return len(self.albedo) - 1

    def device(self, textures=None) -> MaterialData:
        k = len(self.albedo)
        em_const = np.zeros((k, 4), np.float32)
        mr_const = np.zeros((k, 4), np.float32)
        if textures is not None:
            for i in range(k):
                em_const[i] = textures.const_value(self.emissive[i])
                mr_const[i] = textures.const_value(self.metallic_roughness[i])
        return MaterialData(
            base_color=jnp.asarray(
                np.stack(self.base_color) if self.base_color else np.zeros((0, 4))
            ).astype(jnp.float32),
            albedo=jnp.asarray(self.albedo, jnp.int32),
            normal=jnp.asarray(self.normal, jnp.int32),
            metallic_roughness=jnp.asarray(self.metallic_roughness, jnp.int32),
            emissive=jnp.asarray(self.emissive, jnp.int32),
            emissive_rgba=jnp.asarray(em_const),
            mr_rgba=jnp.asarray(mr_const),
        )
