"""Camera rig + per-frame camera uniform.

Mirrors the reference camera contract exactly
(/root/reference/crates/components/src/camera.rs):
* infinite reverse-Z perspective, FOVY = pi/2, ZNEAR = 0.001 (camera.rs:128-133)
* TAA jitter added to projection[0,2] / projection[1,2] (camera.rs:138-139)
* niagara-style frustum planes packed into one vec4 (camera.rs:142-148)
* previous-frame world_to_clip + jitter retained for reprojection
  (camera.rs:150-154)

The rig itself (position + yaw/pitch + exponential smoothing) is host-side
numpy; ``CameraUniform`` is a pytree of small arrays passed into the jitted
frame function every frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from . import struct

from . import mathx

ZNEAR = 0.001
FOVY = float(np.pi) / 2.0


@struct.dataclass
class CameraUniform:
    """Device-side camera block (CameraUniform, camera.rs:15-27)."""

    position: np.ndarray  # (4,) view position (w=1)
    projection: np.ndarray  # (4,4) jittered projection
    view: np.ndarray  # (4,4) world -> view
    clip_to_world: np.ndarray  # (4,4) inverse of (proj @ view)
    prev_world_to_clip: np.ndarray  # (4,4) previous frame proj @ view
    frustum: np.ndarray  # (4,) packed (fx.x, fx.z, fy.y, fy.z)
    zfar: np.ndarray  # () scalar, +inf
    znear: np.ndarray  # () scalar
    jitter: np.ndarray  # (2,)
    prev_jitter: np.ndarray  # (2,)

    @property
    def world_to_clip(self):
        return self.projection @ self.view


def build_uniform(
    position: np.ndarray,
    view: np.ndarray,
    aspect: float,
    jitter: np.ndarray = np.zeros(2, np.float32),
    previous: Optional[CameraUniform] = None,
    znear: float = ZNEAR,
    fovy: float = FOVY,
) -> CameraUniform:
    """Build the per-frame camera uniform (camera.rs:135-169)."""
    proj = np.asarray(
        mathx.perspective_infinite_reverse_rh(fovy, aspect, znear), dtype=np.float32
    ).copy()
    jitter = np.asarray(jitter, dtype=np.float32)
    proj[0, 2] += jitter[0]
    proj[1, 2] += jitter[1]
    view = np.asarray(view, dtype=np.float32)
    proj_view = proj @ view

    # niagara frustum packing: rows of P give plane equations x+w<0 / y+w<0.
    row0, row1, row3 = proj[0], proj[1], proj[3]
    fx = row3 + row0
    fx = fx / np.linalg.norm(fx)
    fy = row3 + row1
    fy = fy / np.linalg.norm(fy)
    frustum = np.array([fx[0], fx[2], fy[1], fy[2]], dtype=np.float32)

    if previous is not None:
        prev_world_to_clip = np.asarray(previous.projection) @ np.asarray(previous.view)
        prev_jitter = np.asarray(previous.jitter, dtype=np.float32)
    else:
        prev_world_to_clip = proj_view
        prev_jitter = np.zeros(2, np.float32)

    pos = np.asarray(position, dtype=np.float32)
    return CameraUniform(
        position=np.concatenate([pos, [np.float32(1.0)]]).astype(np.float32),
        projection=proj,
        view=view,
        clip_to_world=np.linalg.inv(proj_view).astype(np.float32),
        prev_world_to_clip=np.asarray(prev_world_to_clip, dtype=np.float32),
        frustum=frustum,
        zfar=np.float32(np.inf),
        znear=np.float32(znear),
        jitter=jitter,
        prev_jitter=prev_jitter,
    )


@dataclasses.dataclass
class Camera:
    """Host camera rig: position + yaw/pitch with exponential smoothing.

    Functional analogue of the dolly rig used by the reference
    (camera.rs:100-127: Position + YawPitch + Smooth(1.0, 1.5)).
    """

    position: np.ndarray
    yaw: float = 0.0  # degrees
    pitch: float = 0.0  # degrees
    aspect: float = 1.25
    jitter: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, np.float32)
    )
    smooth_position: float = 1.0
    smooth_rotation: float = 1.5
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32)
    )

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float32)
        self._smoothed_pos = self.position.copy()
        self._smoothed_yaw = float(self.yaw)
        self._smoothed_pitch = float(self.pitch)

    def update(self, dt: float):
        """Advance smoothing toward the target transform."""

        def lerp_t(smoothness):
            # dolly-style exponential smoothing; smoothness -> response time.
            return 1.0 - float(np.exp(-8.0 * dt / max(smoothness, 1e-5)))

        tp = lerp_t(self.smooth_position)
        tr = lerp_t(self.smooth_rotation)
        self._smoothed_pos += (self.position - self._smoothed_pos) * tp
        self._smoothed_yaw += (self.yaw - self._smoothed_yaw) * tr
        self._smoothed_pitch += (self.pitch - self._smoothed_pitch) * tr

    @property
    def final_position(self) -> np.ndarray:
        return self._smoothed_pos

    def forward(self) -> np.ndarray:
        return mathx.yaw_pitch_quat_forward(self._smoothed_yaw, self._smoothed_pitch)

    def view_matrix(self) -> np.ndarray:
        eye = self._smoothed_pos
        return mathx.look_at_rh(eye, eye + self.forward(), self.up)

    def uniform(self, previous: Optional[CameraUniform] = None) -> CameraUniform:
        return build_uniform(
            self._smoothed_pos,
            self.view_matrix(),
            self.aspect,
            jitter=self.jitter,
            previous=previous,
        )
