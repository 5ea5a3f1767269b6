"""G-buffer and frame-target pytrees.

Layout contract mirrors the reference GBuffer (app/gbuffer.rs:5-17):
* ``normal_uv``: (H, W, 2) uint32 — x = 32-bit octahedral normal,
  y = pack2x16float(uv)
* ``material``: (H, W) int32 — material id (R8Uint in the reference)
* ``depth``: (H, W) float32 — reverse-Z (1 near .. 0 far), cleared to 0

and the ViewTarget ping-pong pair of HDR color targets
(app/view_target.rs:27-166) becomes explicit functional state.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import struct


@struct.dataclass
class GBuffer:
    normal_uv: jnp.ndarray  # (H, W, 2) u32
    material: jnp.ndarray  # (H, W) i32
    depth: jnp.ndarray  # (H, W) f32

    @property
    def resolution(self):
        return self.depth.shape


@struct.dataclass
class VisBuffer:
    """Visibility buffer: per-pixel winning work-item id + depth, plus the
    per-triangle setup needed to resolve attributes deferred."""

    tri_id: jnp.ndarray  # (H, W) i32, -1 = background
    depth: jnp.ndarray  # (H, W) f32 reverse-Z
    # Packed per-work-item resolve record (T, 12) f32:
    # [original clip x/y/w per vertex (9), instance id, idx_start, pad]
    # (clip z == znear for the infinite reverse-Z projection — never stored)
    resolve_rec: jnp.ndarray
    overflow: jnp.ndarray  # () i32 count of binning/setup overflows
    # Second-place depth candidate per pixel, tracked only when the scene
    # contains alpha-masked materials (RasterConfig.alpha_mask): the raster
    # equivalent of visibility.wgsl:79-81 `discard`, where a cut fragment
    # must NOT win the depth competition — resolve falls back to this.
    tri_id2: jnp.ndarray = None  # (H, W) i32 or None
    depth2: jnp.ndarray = None  # (H, W) f32 or None
