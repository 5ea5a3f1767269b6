"""Light pool: point lights + rectangular area lights.

Mirrors pools/src/light.rs: Light {position, radius, color} and
AreaLight {color, intensity, points[4]} with `from_transform` computing quad
corners from a transform + (width, height) (light.rs:28-52).
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np
from ..core import struct


@struct.dataclass
class LightData:
    point_position: jnp.ndarray  # (L, 3)
    point_radius: jnp.ndarray  # (L,)
    point_color: jnp.ndarray  # (L, 3)
    area_color: jnp.ndarray  # (A, 3)
    area_intensity: jnp.ndarray  # (A,)
    area_points: jnp.ndarray  # (A, 4, 3)


def area_light_points_from_transform(wh, transform) -> np.ndarray:
    """Quad corner positions for an area light (light.rs:28-52)."""
    transform = np.asarray(transform, np.float32)
    basis = transform[:3, :3]
    scale = np.linalg.norm(basis, axis=0)
    rot = basis / scale
    trans = transform[:3, 3]
    direction = rot @ np.array([0.0, 0.0, 1.0], np.float32)
    direction = direction / np.linalg.norm(direction)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    dirx = np.cross(up, direction)
    diry = np.cross(direction, dirx)
    wh = np.asarray(wh, np.float32) * scale[:2]
    dx = dirx * wh[0] / 2.0
    dy = diry * wh[1] / 2.0
    return np.stack(
        [trans - dx - dy, trans + dx - dy, trans + dx + dy, trans - dx + dy]
    ).astype(np.float32)


class LightPool:
    def __init__(self):
        self.point_position: List[np.ndarray] = []
        self.point_radius: List[float] = []
        self.point_color: List[np.ndarray] = []
        self.area_color: List[np.ndarray] = []
        self.area_intensity: List[float] = []
        self.area_points: List[np.ndarray] = []

    def add_point_light(self, position, radius: float, color) -> int:
        self.point_position.append(np.asarray(position, np.float32))
        self.point_radius.append(float(radius))
        self.point_color.append(np.asarray(color, np.float32))
        return len(self.point_radius) - 1

    def add_area_light(self, color, intensity: float, points: np.ndarray) -> int:
        self.area_color.append(np.asarray(color, np.float32))
        self.area_intensity.append(float(intensity))
        self.area_points.append(np.asarray(points, np.float32).reshape(4, 3))
        return len(self.area_intensity) - 1

    def add_area_light_from_transform(self, color, intensity, wh, transform) -> int:
        return self.add_area_light(
            color, intensity, area_light_points_from_transform(wh, transform)
        )

    def device(self) -> LightData:
        def stack(lst, shape):
            return jnp.asarray(
                np.stack(lst).astype(np.float32) if lst else np.zeros(shape, np.float32)
            )

        return LightData(
            point_position=stack(self.point_position, (0, 3)),
            point_radius=jnp.asarray(np.asarray(self.point_radius, np.float32)),
            point_color=stack(self.point_color, (0, 3)),
            area_color=stack(self.area_color, (0, 3)),
            area_intensity=jnp.asarray(np.asarray(self.area_intensity, np.float32)),
            area_points=stack(self.area_points, (0, 4, 3)),
        )
