"""GPU-driven culling + draw compaction (the emit_draws equivalent).

The reference runs a wg-64 compute pass per instance writing one
DrawIndexedIndirect with instance_count 0/1 (shaders/emit_draws.wgsl:37-63);
the hardware then consumes the indirect buffer. Here the same
device-driven loop is a dense visibility test over all N instances followed
by a stream compaction (cumsum + scatter) producing a *compact* draw list —
no host roundtrip, everything inside the frame jit.

Visibility test semantics match is_visible (emit_draws.wgsl:14-35):
view-space bounding sphere vs the packed frustum planes. (The reference's
near/far test can never cull with zfar = inf; we reproduce that.)
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core import fastmath, mathx
from ..scene.instance import InstanceData
from ..scene.mesh import MeshPoolData


@struct.dataclass
class DrawList:
    """Capacity-padded compact draw stream."""

    instance: jnp.ndarray  # (N,) i32 — visible instance ids, compacted; -1 pad
    count: jnp.ndarray  # () i32 — number of valid entries
    # Optional per-draw mesh override (geometric LOD selected at cull
    # time); None = use the instance's own mesh.
    mesh: jnp.ndarray = struct.field(default=None)


def view_sphere(meshes: MeshPoolData, instances: InstanceData, camera):
    """Per-instance view-space bounding sphere: ((N,3) center, (N,) radius).

    Shared by culling and LOD selection so the two can never disagree on
    an instance's bounds.

    NOTE deliberate fix vs the reference: emit_draws.wgsl:15-21 overwrites
    `center` with the *view-space* center before taking
    distance(mesh.min, center), which inflates the radius with the
    camera distance and defeats culling for distant instances. The
    intended bounding-sphere radius is from the *object-space* center.
    """
    transform = instances.transform  # (N, 4, 4)
    mesh_id = instances.mesh_id
    mn = meshes.mesh_min[mesh_id]  # (N, 3)
    mx = meshes.mesh_max[mesh_id]

    center_obj = (mn + mx) * 0.5
    view = jnp.asarray(camera.view)
    vm = fastmath.compose_mat4(view, transform)  # view @ transform, (N,4,4)
    center = fastmath.mat4_point(vm, center_obj)  # view-space center

    scale = mathx.extract_scale(transform, xp=jnp)  # (N, 3)
    max_scale = jnp.max(jnp.abs(scale), axis=-1)
    radius = jnp.linalg.norm((mx - mn) * 0.5, axis=-1) * max_scale
    return center, radius


def instance_visibility(
    meshes: MeshPoolData, instances: InstanceData, camera
) -> jnp.ndarray:
    """(N,) bool visibility mask (vectorized is_visible)."""
    center, radius = view_sphere(meshes, instances, camera)

    fr = jnp.asarray(camera.frustum)
    visible_x = center[:, 2] * fr[1] - jnp.abs(center[:, 0]) * fr[0] >= -radius
    visible_y = center[:, 2] * fr[3] - jnp.abs(center[:, 1]) * fr[2] >= -radius
    # near/far (emit_draws.wgsl:28-30): culled iff z+r > znear AND z-r > zfar;
    # zfar = +inf makes the second clause always false — kept for parity.
    znear = jnp.asarray(camera.znear)
    zfar = jnp.asarray(camera.zfar)
    nf_culled = (center[:, 2] + radius > znear) & (center[:, 2] - radius > zfar)
    return visible_x & visible_y & ~nf_culled


def compact_draws(mask: jnp.ndarray, mesh_sel=None) -> DrawList:
    """Stream-compact visible instance ids into a dense prefix (emit_draws ->
    multi_draw chain, without the per-slot empty draws)."""
    n = mask.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))
    # Stable argsort of ~mask puts visible instance ids first, in order —
    # a sort-based compaction with no scatter.
    order = jnp.argsort(~mask, stable=True).astype(jnp.int32)
    valid = jnp.arange(n, dtype=jnp.int32) < count
    mesh = None
    if mesh_sel is not None:
        mesh = jnp.where(valid, mesh_sel[order], -1)
    return DrawList(instance=jnp.where(valid, order, -1), count=count,
                    mesh=mesh)


def select_lod(
    meshes: MeshPoolData, instances: InstanceData, camera
) -> jnp.ndarray:
    """(N,) i32 per-instance LOD mesh selection (beyond reference parity —
    the reference has no LOD). Level k engages when view-distance /
    world-radius exceeds lod_thresh[m, k]; thresholds ascend, so the level
    is a simple predicate sum. Far instances then rasterize a coarser mesh,
    keeping live triangle counts (and therefore capacities) small on
    many-instance scenes."""
    center, radius = view_sphere(meshes, instances, camera)
    dist = jnp.linalg.norm(center, axis=-1)
    ratio = dist / jnp.maximum(radius, 1e-6)

    mesh_id = instances.mesh_id
    table = meshes.lod_table[mesh_id]  # (N, 4)
    thresh = meshes.lod_thresh[mesh_id]  # (N, 4)
    engaged = (table[:, 1:] >= 0) & (ratio[:, None] >= thresh[:, 1:])
    level = jnp.sum(engaged.astype(jnp.int32), axis=-1)  # (N,) 0..3
    return jnp.take_along_axis(table, level[:, None], axis=-1)[:, 0]


def emit_draws(meshes: MeshPoolData, instances: InstanceData, camera) -> DrawList:
    mesh_sel = (
        select_lod(meshes, instances, camera) if meshes.has_lods else None
    )
    return compact_draws(
        instance_visibility(meshes, instances, camera), mesh_sel
    )
