"""Instance pool: (N,) struct-of-arrays of transforms + mesh/material ids.

Mirrors Instance (shared.wgsl) / InstancePool
(/root/reference/crates/pools/src/instance.rs:8-89). The inverse transform is
precomputed at upload, as in the reference's Instance::new.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np
from ..core import struct


@struct.dataclass
class InstanceData:
    transform: jnp.ndarray  # (N, 4, 4) f32 object -> world
    inv_transform: jnp.ndarray  # (N, 4, 4) f32 world -> object
    mesh_id: jnp.ndarray  # (N,) i32
    material_id: jnp.ndarray  # (N,) i32

    @property
    def count(self) -> int:
        return self.transform.shape[0]


class InstancePool:
    def __init__(self):
        self.transforms: List[np.ndarray] = []
        self.mesh_ids: List[int] = []
        self.material_ids: List[int] = []

    def __len__(self):
        return len(self.transforms)

    def add(self, transform: np.ndarray, mesh_id: int, material_id: int = 0) -> int:
        self.transforms.append(np.asarray(transform, np.float32).reshape(4, 4))
        self.mesh_ids.append(int(mesh_id))
        self.material_ids.append(int(material_id))
        return len(self.transforms) - 1

    def add_many(self, transforms, mesh_ids, material_ids) -> List[int]:
        ids = []
        for t, m, mat in zip(transforms, mesh_ids, material_ids):
            ids.append(self.add(t, m, mat))
        return ids

    def host_arrays(self) -> dict:
        if self.transforms:
            t = np.stack(self.transforms)
        else:
            t = np.zeros((0, 4, 4), np.float32)
        inv = np.linalg.inv(t) if len(t) else t
        return dict(
            transform=t,
            inv_transform=inv.astype(np.float32),
            mesh_id=np.asarray(self.mesh_ids, np.int32),
            material_id=np.asarray(self.material_ids, np.int32),
        )

    def device(self) -> InstanceData:
        return InstanceData(**{k: jnp.asarray(v) for k, v in self.host_arrays().items()})
