"""Multi-chip sharding: screen-row data parallelism.

The reference is strictly single-device (SURVEY.md §2.3/§5.8); the natural
multi-chip mapping for this workload is *sort-middle* screen-space
partitioning: scene state replicated, the per-pixel passes (fine raster
competition, G-buffer resolve, shading, TAA, postprocess) sharded over tile
rows. We express this with `jax.lax.with_sharding_constraint` on the dense
per-pixel arrays inside the one frame jit and let XLA's SPMD partitioner
insert the (few) collectives — e.g. halo exchanges for the 3x3 TAA stencils
— over NVLink. `make_mesh` is a flat 1-D mesh: every card reaches every
other at the same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def shard_map_unchecked(f, mesh, in_specs, out_specs):
    """shard_map with replication checking off."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)} "
                "(set XLA_FLAGS=--xla_force_host_platform_device_count=N for CPU)"
            )
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (ROW_AXIS,))


def shard_rows(mesh: Optional[Mesh], *arrays):
    """Constrain (H, W, ...) arrays to be sharded over H."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = []
    for a in arrays:
        spec = P(ROW_AXIS, *([None] * (a.ndim - 1)))
        out.append(jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) > 1 else out[0]


def replicated(mesh: Optional[Mesh], tree):
    if mesh is None:
        return tree
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.lax.with_sharding_constraint(a, sharding), tree
    )


def rasterize_sharded(meshes, instances, draws, camera, config, mesh,
                      materials=None, inst_rec=None):
    """Row-PARTITIONED production raster under `shard_map`: each device
    bins and fine-rasterizes ONLY its own tile rows with the Pallas kernel
    (sort-middle parallel rasterization). Per-device raster work is 1/N by
    construction: binning clamps every triangle's tile-bbox to the
    device's tile-row slab (local pair stream + local sort), and the fine
    raster runs over NT/N tiles.

    Triangle SETUP is slot-partitioned too: the per-draw record phase
    (setup_draw_records, O(n_draws)) runs replicated, each device then
    transforms/clips/packs tri_capacity/N work slots (setup_work_slice —
    1/N of the setup flops and gather rows), and the packed streams are
    all-gathered over NVLink so every device can bin any triangle into its
    own slab; the extras compaction (setup_finalize, one fused-key sort)
    replays replicated on the gathered stream. A tiled all_gather restores
    exact slot order, so the result is bit-identical to the unsharded
    setup. The exchange moves the packed records (~220 B/slot) once per
    frame — bandwidth for compute, in place of a replicated transform.

    The 1:1 first-tile stream (slot i <-> triangle i by construction)
    stays full-length per device, and so does the multi-tile EXTRAS
    window (pair_capacity/4): geometry bunches in a few slabs (near the
    horizon), so one slab can hold most of the frame's extras — a 1/N
    window overflowed the north-star frame on four cards. The psum'd
    overflow counter reports any pair that does not fit.
    Returns a VisBuffer whose images are row-sharded across the mesh.
    """
    import jax.numpy as jnp

    from ..ops import fine_raster as fr
    from ..passes import raster as raster_pass

    n_dev = mesh.devices.size
    TY, TX = config.tiles_y, config.tiles_x
    if TY % n_dev:
        raise ValueError(
            f"tiles_y={TY} must divide evenly across {n_dev} devices "
            f"(pad height to a multiple of {config.tile_h * n_dev})"
        )
    cap = config.tri_capacity
    if cap % n_dev:
        raise ValueError(
            f"tri_capacity={cap} must divide evenly across {n_dev} devices"
        )
    slots_per = cap // n_dev
    rows_per = TY // n_dev
    track2 = config.alpha_mask

    draw_rec, n_tris, cum_draws = raster_pass.setup_draw_records(
        meshes, instances, draws, camera, config, materials=materials,
        inst_rec=inst_rec,
    )
    tri_attr = (meshes.tri_attr_packed
                if (config.fused_resolve_rec
                    or getattr(config, 'slim_rec', False)) else None)

    def body(draw_rec_, n_tris_, cum_draws_, tri_pos_, tri_attr_):
        d = jax.lax.axis_index(ROW_AXIS)
        parts = raster_pass.setup_work_slice(
            tri_pos_, tri_attr_, draw_rec_, n_tris_, cum_draws_, config,
            lo=d * slots_per, num=slots_per,
        )
        parts = jax.tree_util.tree_map(
            lambda a: jax.lax.all_gather(a, ROW_AXIS, axis=0, tiled=True),
            parts,
        )
        setup_ = raster_pass.setup_finalize(parts, cum_draws_, config)
        ty_lo = d * rows_per
        rec_sorted, starts, counts, overflow = (
            raster_pass.bin_triangles_pairs(
                setup_, config, ty_range=(ty_lo, rows_per)
            )
        )
        outs = fr.fine_raster_pairs(
            rec_sorted, starts, counts,
            interpret=config.interpret, track2=track2,
        )

        def untile(a):
            n_local = rows_per * TX
            return (
                a[:n_local]
                .reshape(rows_per, TX, config.tile_h, config.tile_w)
                .transpose(0, 2, 1, 3)
                .reshape(rows_per * config.tile_h, TX * config.tile_w)
            )

        depth = untile(outs[0])
        tri_id = untile(outs[1]).astype(jnp.int32)
        overflow = jax.lax.psum(overflow, ROW_AXIS)
        # resolve_rec / setup_overflow are computed identically on every
        # device (gathered stream + replicated finalize) -> out spec P().
        common = (setup_["resolve_rec"], setup_["setup_overflow"])
        if track2:
            return (depth, tri_id, overflow, untile(outs[2]),
                    untile(outs[3]).astype(jnp.int32)) + common
        return (depth, tri_id, overflow) + common

    row_spec = P(ROW_AXIS, None)
    out_specs = (
        (row_spec, row_spec, P(), row_spec, row_spec, P(), P())
        if track2 else (row_spec, row_spec, P(), P(), P())
    )
    outs = shard_map_unchecked(
        body, mesh=mesh, in_specs=(P(), P(), P(), P(), P()),
        out_specs=out_specs,
    )(draw_rec, n_tris, cum_draws, meshes.tri_pos, tri_attr)

    H, W = config.height, config.width
    depth, tri_id, bin_overflow = outs[0], outs[1], outs[2]
    resolve_rec, setup_overflow = outs[-2], outs[-1]
    tri_id2 = depth2 = None
    if track2:
        depth2, tri_id2 = outs[3][:H, :W], outs[4][:H, :W]
    return raster_pass.VisBuffer(
        tri_id=tri_id[:H, :W],
        depth=depth[:H, :W],
        resolve_rec=resolve_rec,
        overflow=bin_overflow + setup_overflow,
        tri_id2=tri_id2,
        depth2=depth2,
    )
