"""Pooled SoA mesh storage + procedural meshes.

Analogue of the reference MeshPool
(/root/reference/crates/pools/src/mesh/mod.rs:57-352): all meshes live in
flat, device-resident SoA arrays (positions / normals / tangents / uvs /
indices) with a per-mesh offset table (MeshInfo: AABB, base_index,
index_count, vertex_offset, bvh_index). Adding a mesh builds its BLAS and
permutes its index range in place so BVH leaves reference contiguous
triangles (mesh/mod.rs:320-325).

Builtin meshes (ids 0-3, mesh/mod.rs:267-274):
  0 = horizontal unit plane, 1 = vertical unit plane,
  2 = uv sphere(res 1),      3 = uv sphere(res 10).
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..rt import bvh as bvh_mod

HORIZONTAL_PLANE_MESH = 0
VERTICAL_PLANE_MESH = 1
SPHERE_1_MESH = 2
SPHERE_10_MESH = 3


@dataclasses.dataclass
class Mesh:
    """Host-side mesh (CPU numpy)."""

    vertices: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    tangents: np.ndarray  # (V, 4) f32
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (I,) u32 / i64

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.normals = np.ascontiguousarray(self.normals, dtype=np.float32)
        self.tangents = np.ascontiguousarray(self.tangents, dtype=np.float32)
        self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        assert self.indices.size % 3 == 0


def make_plane_mesh(width: float = 1.0, height: float = 1.0) -> Mesh:
    """Horizontal quad in XZ, +Y normal (plane.rs:5-38)."""
    w, h = width / 2.0, height / 2.0
    vertices = np.array(
        [[-w, 0, -h], [-w, 0, h], [w, 0, h], [w, 0, -h]], dtype=np.float32
    )
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    tangents = np.tile(np.array([[1, 0, 0, -1]], np.float32), (4, 1))
    indices = np.array([0, 1, 2, 0, 2, 3], dtype=np.int32)
    return Mesh(vertices, normals, tangents, uvs, indices)


def make_vertical_plane_mesh(width: float = 1.0, height: float = 1.0) -> Mesh:
    """The horizontal plane rotated by Rx(-pi/2): XZ -> XY, normal -Z
    (the +Y normal maps to (0, 0, -1) under this rotation — the quad faces
    a viewer on its -Z side)."""
    m = make_plane_mesh(width, height)
    rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float32)
    m.vertices = m.vertices @ rot.T
    m.normals = m.normals @ rot.T
    return m


def make_uv_sphere(radius: float = 1.0, resolution: int = 10) -> Mesh:
    """UV sphere with 4*res stacks and 8*res sectors (sphere.rs:6-67)."""
    vside = 4 * resolution
    uside = vside * 2
    v = np.linspace(0.0, 1.0, vside + 1, dtype=np.float32)
    u = np.linspace(0.0, 1.0, uside + 1, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)  # (vside+1, uside+1)
    theta = 2.0 * np.pi * uu + np.pi
    phi = np.pi * vv
    x = np.cos(theta) * np.sin(phi) * radius
    y = -np.cos(phi) * radius
    z = np.sin(theta) * np.sin(phi) * radius
    vertices = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    norms = np.linalg.norm(vertices, axis=-1, keepdims=True)
    normals = vertices / np.maximum(norms, 1e-20)
    uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)
    tangents = np.tile(np.array([[1, 0, 0, -1]], np.float32), (len(vertices), 1))

    tri = []
    for i in range(vside):
        k1 = i * (uside + 1)
        for j in range(uside):
            a, b = k1 + j, k1 + j + uside + 1
            if i != 0:
                tri += [a, b, a + 1]
            # the reference emits the second triangle for every stack row
            tri += [a + 1, b, b + 1]
    indices = np.array(tri, dtype=np.int32)
    return Mesh(vertices, normals, tangents, uvs, indices)


def make_box_mesh(width: float, height: float, length: float) -> Mesh:
    """Per-axis box: 24 verts, 6 faces, half-extent per dimension
    (crates/pools/src/mesh/boxx.rs:5-117 — vertices are dims/2, per-face
    normals/uv quads, tangent (1,0,0,-1))."""
    m = make_cube_mesh(1.0)
    scale = np.array([width, height, length], np.float32)
    return Mesh(
        (m.vertices * scale).astype(np.float32),
        m.normals,
        m.tangents,
        m.uvs,
        m.indices,
    )


def make_cube_mesh(size: float = 1.0) -> Mesh:
    """24-vertex, 6-face cube (cube.rs / boxx.rs equivalent)."""
    s = size / 2.0
    faces = [
        # (normal, tangent, corner order)
        ([0, 0, 1], [1, 0, 0]),
        ([0, 0, -1], [-1, 0, 0]),
        ([1, 0, 0], [0, 0, -1]),
        ([-1, 0, 0], [0, 0, 1]),
        ([0, 1, 0], [1, 0, 0]),
        ([0, -1, 0], [1, 0, 0]),
    ]
    verts, norms, tans, uvs, idx = [], [], [], [], []
    for fi, (n, t) in enumerate(faces):
        n = np.array(n, np.float32)
        t = np.array(t, np.float32)
        b = np.cross(n, t)
        for ci, (du, dv) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
            verts.append(n * s + t * (du * s) + b * (dv * s))
            norms.append(n)
            tans.append(np.concatenate([t, [np.float32(-1.0)]]))
            uvs.append([(du + 1) / 2, (dv + 1) / 2])
        base = 4 * fi
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return Mesh(
        np.array(verts, np.float32),
        np.array(norms, np.float32),
        np.array(tans, np.float32),
        np.array(uvs, np.float32),
        np.array(idx, np.int32),
    )


@struct.dataclass
class MeshPoolData:
    """Device-resident mesh pool (one pytree leaf per SoA stream)."""

    positions: jnp.ndarray  # (V, 3) f32
    normals: jnp.ndarray  # (V, 3) f32
    tangents: jnp.ndarray  # (V, 4) f32
    uvs: jnp.ndarray  # (V, 2) f32
    indices: jnp.ndarray  # (I,) i32
    # MeshInfo table (shared.wgsl MeshInfo)
    mesh_min: jnp.ndarray  # (M, 3) f32
    mesh_max: jnp.ndarray  # (M, 3) f32
    index_count: jnp.ndarray  # (M,) i32
    base_index: jnp.ndarray  # (M,) i32
    vertex_offset: jnp.ndarray  # (M,) i32
    bvh_index: jnp.ndarray  # (M,) i32
    # Pooled BLAS nodes (bvh/blas.rs BvhNode layout as SoA)
    bvh_min: jnp.ndarray  # (B, 3) f32
    bvh_max: jnp.ndarray  # (B, 3) f32
    bvh_left_first: jnp.ndarray  # (B,) i32
    bvh_count: jnp.ndarray  # (B,) i32
    # Mesh-LOCAL stackless exit links, encoded e+1 (0 = subtree done) —
    # rt/bvh.py exit_links. Topology-only: skinning refits never touch it.
    bvh_exit: jnp.ndarray  # (B,) i32
    # De-indexed triangle corner positions (T_pool, 9): one 36-byte row per
    # triangle [x0 y0 z0 x1 y1 z1 x2 y2 z2]: the raster setup fetches one
    # wide row per triangle instead of 3 index + 3 position gathers.
    tri_pos: jnp.ndarray  # (T_pool, 9) f32
    # De-indexed per-triangle corner attributes packed into ONE 48-byte
    # u32 row (gathers are row-rate bound; resolve pays 1 gather/pixel
    # instead of 3): [uv0.xy, uv1.xy, uv2.xy as f32 bits (6) | octahedral
    # corner normals (3) | octahedral corner tangents, w-sign in the LSB
    # (3)]. Quantization: normals/tangents at oct-32 (the G-buffer already
    # stores the interpolated normal octahedrally — encoding.wgsl:1-28);
    # uv exact f32.
    tri_attr_packed: jnp.ndarray  # (T_pool, 12) u32
    # Geometric LOD chain (beyond reference parity — the reference has no
    # LOD): lod_table[m, 0] == m; lod_table[m, k>0] = coarser pool mesh id
    # or -1. lod_thresh[m, k] = distance/radius ratio above which level k
    # engages (monotonic). emit_draws selects the level per instance so
    # live raster work — not capacity — sets the frame cost on
    # many-instance scenes (BASELINE config 2).
    lod_table: jnp.ndarray  # (M, 4) i32
    lod_thresh: jnp.ndarray  # (M, 4) f32
    has_lods: bool = struct.field(pytree_node=False, default=False)
    # Static max triangles in any BLAS leaf (builder targets <= 3,
    # blas.rs:106): sizes the traversal's per-step leaf-test loop.
    bvh_max_leaf: int = struct.field(pytree_node=False, default=8)


class MeshPool:
    """Host-side pooled mesh accumulation; `.device()` uploads to jnp."""

    def __init__(self, with_builtins: bool = True, build_bvh: bool = True):
        self.build_bvh = build_bvh
        self.positions: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.indices: List[np.ndarray] = []
        self.bvh_nodes: List[np.ndarray] = []  # structured per-mesh node arrays
        self.mesh_info: List[dict] = []
        self._vertex_count = 0
        self._index_count = 0
        self._bvh_count = 0
        if with_builtins:
            self.add(make_plane_mesh(1.0, 1.0))
            self.add(make_vertical_plane_mesh(1.0, 1.0))
            self.add(make_uv_sphere(1.0, 1))
            self.add(make_uv_sphere(1.0, 10))

    def __len__(self):
        return len(self.mesh_info)

    def add(self, mesh: Mesh) -> int:
        """Append a mesh; builds its BLAS and permutes indices in place."""
        indices = mesh.indices.copy()
        if self.build_bvh:
            nodes, indices = bvh_mod.build_blas(mesh.vertices, indices)
        else:
            nodes = bvh_mod.single_leaf_nodes(mesh.vertices, indices)

        mesh_id = len(self.mesh_info)
        self.mesh_info.append(
            dict(
                min=mesh.vertices.min(axis=0),
                max=mesh.vertices.max(axis=0),
                index_count=indices.size,
                base_index=self._index_count,
                vertex_offset=self._vertex_count,
                bvh_index=self._bvh_count,
            )
        )
        self.positions.append(mesh.vertices)
        self.normals.append(mesh.normals)
        self.tangents.append(mesh.tangents)
        self.uvs.append(mesh.uvs)
        self.indices.append(indices)
        self.bvh_nodes.append(nodes)
        self._vertex_count += len(mesh.vertices)
        self._index_count += indices.size
        self._bvh_count += len(nodes)
        return mesh_id

    def set_lods(self, base_id: int, lods) -> None:
        """Register a geometric LOD chain for `base_id`.

        `lods`: up to 3 (mesh_id, ratio) pairs, ratio = view distance /
        bounding radius above which that level engages; must be ascending.
        emit_draws then substitutes the coarser mesh per instance at cull
        time (the raster, not the ray-traced path, consumes the LOD)."""
        assert len(lods) <= 3
        ratios = [r for _m, r in lods]
        assert ratios == sorted(ratios), "LOD thresholds must ascend"
        for m, _r in lods:
            assert 0 <= m < len(self.mesh_info)
        self.mesh_info[base_id]["lods"] = list(lods)

    def add_with_auto_lods(self, mesh: Mesh, ratios=(10.0, 25.0),
                           cells=(24, 10)) -> int:
        """Add a mesh plus grid-decimated LOD levels (decimate_grid) at the
        given distance/radius thresholds. Levels that fail to reduce the
        triangle count are skipped. Returns the base mesh id."""
        base = self.add(mesh)
        lods = []
        prev_tris = mesh.indices.size // 3
        for r, c in zip(ratios, cells):
            m = decimate_grid(mesh, c)
            t = m.indices.size // 3
            if t >= prev_tris:
                continue
            lods.append((self.add(m), float(r)))
            prev_tris = t
        if lods:
            self.set_lods(base, lods)
        return base

    def host_arrays(self) -> dict:
        nodes = (
            np.concatenate(self.bvh_nodes)
            if self.bvh_nodes
            else np.zeros((0,), bvh_mod.NODE_DTYPE)
        )
        info = self.mesh_info
        return dict(
            positions=np.concatenate(self.positions) if info else np.zeros((0, 3), np.float32),
            normals=np.concatenate(self.normals) if info else np.zeros((0, 3), np.float32),
            tangents=np.concatenate(self.tangents) if info else np.zeros((0, 4), np.float32),
            uvs=np.concatenate(self.uvs) if info else np.zeros((0, 2), np.float32),
            indices=np.concatenate(self.indices) if info else np.zeros((0,), np.int32),
            mesh_min=np.array([i["min"] for i in info], np.float32).reshape(-1, 3),
            mesh_max=np.array([i["max"] for i in info], np.float32).reshape(-1, 3),
            index_count=np.array([i["index_count"] for i in info], np.int32),
            base_index=np.array([i["base_index"] for i in info], np.int32),
            vertex_offset=np.array([i["vertex_offset"] for i in info], np.int32),
            bvh_index=np.array([i["bvh_index"] for i in info], np.int32),
            bvh_min=np.ascontiguousarray(nodes["min"]),
            bvh_max=np.ascontiguousarray(nodes["max"]),
            bvh_left_first=np.ascontiguousarray(nodes["left_first"]),
            bvh_count=np.ascontiguousarray(nodes["count"]),
            bvh_exit=(
                np.concatenate(
                    [bvh_mod.blas_exit_links(n) for n in self.bvh_nodes]
                )
                if self.bvh_nodes
                else np.zeros((0,), np.int32)
            ),
            tri_pos=self._tri_pos(),
            bvh_max_leaf=(
                int(nodes["count"].max()) if len(nodes) else 1
            ),
            **self._tri_attrs(),
            **self._lod_arrays(),
        )

    def _lod_arrays(self) -> dict:
        m = len(self.mesh_info)
        table = np.full((m, 4), -1, np.int32)
        thresh = np.zeros((m, 4), np.float32)
        table[:, 0] = np.arange(m, dtype=np.int32)
        has = False
        for i, info in enumerate(self.mesh_info):
            for k, (mid, ratio) in enumerate(info.get("lods", [])):
                table[i, k + 1] = mid
                thresh[i, k + 1] = ratio
                has = True
        return dict(lod_table=table, lod_thresh=thresh, has_lods=has)

    def _tri_attrs(self) -> dict:
        from ..core.encoding import encode_octahedral_32_np

        rows = []
        for verts, normals, tangents, uvs, idx in zip(
            self.positions, self.normals, self.tangents, self.uvs, self.indices
        ):
            tri = idx.reshape(-1, 3)  # (t, 3)
            t = tri.shape[0]
            row = np.zeros((t, 12), np.uint32)
            row[:, 0:6] = (
                uvs[tri].reshape(t, 6).astype(np.float32).view(np.uint32)
            )
            for k in range(3):
                row[:, 6 + k] = encode_octahedral_32_np(normals[tri[:, k]])
                tang = tangents[tri[:, k]]
                enc = encode_octahedral_32_np(tang[:, :3])
                # w-sign (glTF handedness, +/-1) stored in the LSB of the
                # x quantization (2^-16 normal perturbation — negligible).
                enc = (enc & np.uint32(~np.uint32(1))) | (
                    tang[:, 3] < 0.0
                ).astype(np.uint32)
                row[:, 9 + k] = enc
            rows.append(row)
        return {
            "tri_attr_packed": (
                np.concatenate(rows) if rows else np.zeros((0, 12), np.uint32)
            )
        }

    def _tri_pos(self) -> np.ndarray:
        rows = []
        for verts, idx, info in zip(self.positions, self.indices, self.mesh_info):
            corners = verts[idx.reshape(-1, 3)]  # (t, 3, 3) mesh-local
            rows.append(corners.reshape(-1, 9))
        return (
            np.concatenate(rows).astype(np.float32)
            if rows
            else np.zeros((0, 9), np.float32)
        )

    def device(self) -> MeshPoolData:
        h = self.host_arrays()
        has_lods = h.pop("has_lods")
        max_leaf = h.pop("bvh_max_leaf")
        return MeshPoolData(
            has_lods=has_lods, bvh_max_leaf=max_leaf,
            **{k: jnp.asarray(v) for k, v in h.items()},
        )


def make_torus_knot(
    p: int = 2,
    q: int = 3,
    segments: int = 256,
    sides: int = 32,
    radius: float = 1.0,
    tube: float = 0.3,
) -> Mesh:
    """(p,q) torus knot tube — a dense procedural stand-in for the classic
    bunny/dragon scan meshes (which the reference references but does not
    ship; BASELINE.md asset note). ~segments*sides*2 triangles."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False, dtype=np.float32)
    r = radius * (2 + np.cos(q * t)) * 0.5
    center = np.stack(
        [r * np.cos(p * t), radius * np.sin(q * t) * 0.5, r * np.sin(p * t)], -1
    )
    # Frenet-ish frame
    nxt = np.roll(center, -1, axis=0)
    tang = nxt - center
    tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-9)
    up = np.array([0, 1, 0], np.float32)
    side = np.cross(tang, up)
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-9)
    up2 = np.cross(side, tang)

    a = np.linspace(0, 2 * np.pi, sides, endpoint=False, dtype=np.float32)
    circ = (
        np.cos(a)[None, :, None] * side[:, None, :]
        + np.sin(a)[None, :, None] * up2[:, None, :]
    )  # (seg, sides, 3)
    verts = (center[:, None, :] + tube * circ).reshape(-1, 3)
    normals = circ.reshape(-1, 3)
    uvs = np.stack(
        np.meshgrid(
            np.arange(sides) / sides, np.arange(segments) / segments
        ),
        -1,
    ).reshape(-1, 2).astype(np.float32)
    tangents = np.concatenate(
        [np.repeat(tang, sides, axis=0), -np.ones((len(verts), 1), np.float32)],
        axis=-1,
    )
    idx = []
    for i in range(segments):
        for j in range(sides):
            a0 = i * sides + j
            a1 = i * sides + (j + 1) % sides
            b0 = ((i + 1) % segments) * sides + j
            b1 = ((i + 1) % segments) * sides + (j + 1) % sides
            idx += [a0, b0, a1, a1, b0, b1]
    return Mesh(verts, normals, tangents.astype(np.float32), uvs,
                np.array(idx, np.int32))


def decimate_grid(mesh: Mesh, cells: int = 24) -> Mesh:
    """Vertex-clustering decimation: snap vertices to a cells^3 grid over
    the mesh AABB, merge clusters (position/normal/tangent/uv averaged),
    drop degenerate triangles. Quality is coarse but robust — intended for
    DISTANT geometric LODs (sub-pixel triangles are pure binning waste on
    a software raster), where silhouette fidelity at a few pixels is all
    that matters. The reference has no LOD or decimation at all.
    """
    v = mesh.vertices
    mn = v.min(axis=0)
    ext = np.maximum(v.max(axis=0) - mn, 1e-9)
    key = np.minimum((v - mn) / ext * cells, cells - 1e-4).astype(np.int64)
    flat = (key[:, 0] * cells + key[:, 1]) * cells + key[:, 2]
    uniq, remap = np.unique(flat, return_inverse=True)
    k = len(uniq)

    def avg(a):
        out = np.zeros((k, a.shape[1]), np.float64)
        np.add.at(out, remap, a.astype(np.float64))
        cnt = np.zeros(k, np.float64)
        np.add.at(cnt, remap, 1.0)
        return (out / cnt[:, None]).astype(np.float32)

    verts = avg(v)
    nrm = avg(mesh.normals)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    tan = avg(mesh.tangents)
    t3 = tan[:, :3]
    t3 /= np.maximum(np.linalg.norm(t3, axis=1, keepdims=True), 1e-9)
    # majority handedness; never 0 (a zero tangent.w kills the bitangent)
    tan = np.concatenate(
        [t3, np.where(tan[:, 3:4] >= 0.0, 1.0, -1.0)], axis=1
    )
    uv = avg(mesh.uvs)

    tri = remap[mesh.indices.reshape(-1, 3)]
    keep = (
        (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
        & (tri[:, 0] != tri[:, 2])
    )
    idx = tri[keep].reshape(-1).astype(np.int32)
    if idx.size == 0:  # degenerate input: keep one triangle
        idx = np.array([0, min(1, k - 1), min(2, k - 1)], np.int32)
    return Mesh(verts, nrm, tan.astype(np.float32), uv, idx)
