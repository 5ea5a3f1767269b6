"""Device-side BVH traversal: batched TLAS -> BLAS shadow rays.

Port of the traversal contract of shaders/utils/bvh.wgsl:33-122 (stack-based,
two-level, ray transformed into object space per instance leaf) re-shaped
for a SIMD machine: instead of one divergent thread per ray, ALL rays run in
lock-step through a `lax.while_loop`; each iteration pops one stack entry
per ray and performs masked TLAS/BLAS work. Memory accesses follow the
one-wide-row-per-step rule (one gather row per fetch):

* TLAS nodes packed as (B, 8) rows [min3, a, max3, b]: internal a=left,
  b=right; leaf a=-1, b=instance;
* BLAS nodes packed as (B, 8) rows [min3, left_first, max3, count];
* per-instance rows: inverse transform (16) + [bvh_root, tri_base] aux;
* triangle corners from the de-indexed (T_pool, 9) rows.

Stack entries: TLAS node i stored as i+1, BLAS node j as -(j+1); 0 = empty.
A BLAS subtree completes before any TLAS entry below it pops (LIFO), so a
single current transformed ray per lane is sound — the same invariant the
reference's nested traversal relies on.

This is the any-hit (occlusion) variant used for raytraced area/point-light
shadows (src/bin/raytraced_shadows.wgsl:96-102): rays stop at the first
intersection closer than t_max.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import checks

from ..core import fastmath

MAX_DIST = 1e30
STACK = 48
MAX_LEAF = 8  # builder leaves are <= 3 except degenerate fallbacks


class OcclusionResult(NamedTuple):
    """occluded() output with overflow observability (the raster path's
    `overflow` counter, passes/raster.py, applied to traversal)."""

    hit: jnp.ndarray  # (R,) bool
    overflow: jnp.ndarray  # () i32 — stack pushes dropped (stack full)
    exhausted: jnp.ndarray  # () i32 — rays still active at max_steps


class ClosestHitResult(NamedTuple):
    t: jnp.ndarray  # (R,) f32 hit distance (t_max on miss)
    visits: jnp.ndarray  # (R,) i32 node-visit count (heat overlay)
    overflow: jnp.ndarray  # () i32
    exhausted: jnp.ndarray  # () i32


def pack_blas_rows(bvh_min, bvh_max, left_first, count):
    if not isinstance(count, jax.core.Tracer):
        import numpy as _np

        n_leaf = _np.asarray(count)
        if n_leaf.size and int(n_leaf.max()) > MAX_LEAF:
            raise ValueError(
                f"BLAS leaf with {int(n_leaf.max())} tris exceeds MAX_LEAF="
                f"{MAX_LEAF}; traversal would silently miss intersections "
                "(build with build_bvh=True or raise MAX_LEAF)"
            )
    return jnp.concatenate(
        [
            bvh_min,
            left_first.astype(jnp.float32)[:, None],
            bvh_max,
            count.astype(jnp.float32)[:, None],
        ],
        axis=-1,
    )


def pack_tlas_rows(tlas_min, tlas_max, left_right, instance):
    lr = left_right.astype(jnp.uint32)
    left = (lr & 0xFFFF).astype(jnp.float32)
    right = (lr >> 16).astype(jnp.float32)
    is_leaf = lr == 0
    a = jnp.where(is_leaf, -1.0, left)
    b = jnp.where(is_leaf, instance.astype(jnp.float32), right)
    return jnp.concatenate(
        [tlas_min, a[:, None], tlas_max, b[:, None]], axis=-1
    )


def pack_instance_rows(inv_transform, mesh_bvh_index, mesh_base_index, mesh_id):
    n = inv_transform.shape[0]
    return jnp.concatenate(
        [
            inv_transform.reshape(n, 16),
            mesh_bvh_index[mesh_id].astype(jnp.float32)[:, None],
            (mesh_base_index[mesh_id] // 3).astype(jnp.float32)[:, None],
            jnp.zeros((n, 6), jnp.float32),
        ],
        axis=-1,
    )  # (N, 24)


def _slab(o, inv_d, bmin, bmax, t_max):
    """intersections.wgsl:13-24 — hit iff tmax' >= tmin', tmin' < t, tmax' > 0."""
    tx1 = (bmin - o) * inv_d
    tx2 = (bmax - o) * inv_d
    hi = jnp.min(jnp.maximum(tx1, tx2), axis=-1)
    lo = jnp.max(jnp.minimum(tx1, tx2), axis=-1)
    return (hi >= lo) & (lo < t_max) & (hi > 0.0)


def _tri_hit(o, d, v0, v1, v2, t_max):
    """Backface-culled Moller-Trumbore (intersections.wgsl:26-45)."""
    e1 = v1 - v0
    e2 = v2 - v0
    uvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * uvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    orig = o - v0
    u = inv_det * jnp.sum(orig * uvec, axis=-1)
    vvec = jnp.cross(orig, e1)
    v = inv_det * jnp.sum(d * vvec, axis=-1)
    t = inv_det * jnp.sum(e2 * vvec, axis=-1)
    return (
        (det >= 1e-10)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < t_max)
    )


def occluded(
    tlas_rows,  # (Bt, 8)
    blas_rows,  # (Bb, 8)
    instance_rows,  # (N, 24)
    tri_pos,  # (T_pool, 9)
    origins,  # (R, 3)
    directions,  # (R, 3) NOT normalized; t_max in units of |direction|
    t_max=1.0,
    max_steps=512,
    active=None,
    chunk_size=None,
):
    """Any-hit occlusion for R rays. Returns OcclusionResult.

    `active`: optional (R,) mask — inactive rays are skipped entirely
    (their result is False).

    `chunk_size`: process rays in sequential chunks (lax.map). Lock-step
    traversal runs until the SLOWEST lane finishes; chunking lets
    fast-terminating regions (sky, unoccluded ground) exit early instead
    of paying the global worst case — total steps become the sum of
    per-chunk maxima rather than chunks x global max."""
    R = origins.shape[0]
    if chunk_size is not None and R > chunk_size:
        pad = (-R) % chunk_size
        def padded(x, fill=0):
            return jnp.concatenate(
                [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
            ) if pad else x

        o = padded(origins).reshape(-1, chunk_size, 3)
        d = padded(directions).reshape(-1, chunk_size, 3)
        tm = jnp.broadcast_to(
            jnp.asarray(t_max, jnp.float32), (R,)
        )
        tm = padded(tm).reshape(-1, chunk_size)
        act = (
            jnp.ones((R,), bool) if active is None else active
        )
        act = padded(act).reshape(-1, chunk_size)  # pad rays inactive

        def one(args):
            oo, dd, tt, aa = args
            return occluded(
                tlas_rows, blas_rows, instance_rows, tri_pos,
                oo, dd, t_max=tt, max_steps=max_steps, active=aa,
            )

        res = jax.lax.map(one, (o, d, tm, act))
        return OcclusionResult(
            hit=res.hit.reshape(-1)[:R],
            overflow=jnp.sum(res.overflow),
            exhausted=jnp.sum(res.exhausted),
        )
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    inv0 = 1.0 / jnp.where(jnp.abs(directions) > 1e-20, directions, 1e-20)
    stack0 = jnp.zeros((R, STACK), jnp.int32)
    stack0 = stack0.at[:, 0].set(1)  # TLAS root (node 0 stored as +1)
    sp0 = jnp.ones((R,), jnp.int32)
    if active is not None:
        sp0 = jnp.where(active, sp0, 0)

    state = dict(
        stack=stack0,
        sp=sp0,
        hit=jnp.zeros((R,), bool),
        # current (possibly object-space) ray per lane
        co=origins,
        cd=directions,
        cinv=inv0,
        tri_base=jnp.zeros((R,), jnp.int32),
        bvh_base=jnp.zeros((R,), jnp.int32),
        steps=jnp.asarray(0, jnp.int32),
        ovf=jnp.asarray(0, jnp.int32),
    )

    rr = jnp.arange(R)

    def cond(s):
        return jnp.any((s["sp"] > 0) & ~s["hit"]) & (s["steps"] < max_steps)

    def body(s):
        active = (s["sp"] > 0) & ~s["hit"]
        top = jnp.maximum(s["sp"] - 1, 0)
        entry = s["stack"][rr, top]
        sp = jnp.where(active, s["sp"] - 1, s["sp"])

        is_blas = entry < 0
        t_node = jnp.where(active & ~is_blas, entry - 1, 0)
        b_node = jnp.where(active & is_blas, -entry - 1, 0)

        # --- TLAS step (original ray) --------------------------------
        trow = tlas_rows[checks.check_index(t_node, tlas_rows.shape[0], "rt.tlas_node")]  # (R, 8)
        t_hit = _slab(origins, inv0, trow[:, 0:3], trow[:, 4:7], t_max)
        t_leaf = trow[:, 3] < 0.0
        t_act = active & ~is_blas & t_hit

        # internal: push children
        left = trow[:, 3].astype(jnp.int32) + 1
        right = trow[:, 7].astype(jnp.int32) + 1
        push2 = t_act & ~t_leaf

        # leaf: enter instance — transform ray, push BLAS root
        inst = jnp.where(t_leaf, trow[:, 7], 0.0).astype(jnp.int32)
        irow = instance_rows[checks.check_index(jnp.where(t_act & t_leaf, inst, 0), instance_rows.shape[0], "rt.instance")]  # (R, 24)
        inv_t = irow[:, :16].reshape(R, 4, 4)
        o_obj = fastmath.mat4_point(inv_t, origins)
        d_obj = fastmath.mat3_vec(inv_t[:, :3, :3], directions)
        enter = t_act & t_leaf
        co = jnp.where(enter[:, None], o_obj, s["co"])
        cd = jnp.where(enter[:, None], d_obj, s["cd"])
        cinv = jnp.where(
            enter[:, None],
            1.0 / jnp.where(jnp.abs(d_obj) > 1e-20, d_obj, 1e-20),
            s["cinv"],
        )
        tri_base = jnp.where(enter, irow[:, 17].astype(jnp.int32), s["tri_base"])
        # mesh BLAS child indices are mesh-local (bvh.wgsl:55-56 adds
        # mesh.bvh_index); keep the pool base per lane
        bvh_base = jnp.where(enter, irow[:, 16].astype(jnp.int32), s["bvh_base"])
        blas_root = irow[:, 16].astype(jnp.int32)

        # --- BLAS step (current object-space ray) --------------------
        brow = blas_rows[checks.check_index(b_node, blas_rows.shape[0], "rt.blas_node")]
        b_hit = _slab(s["co"], s["cinv"], brow[:, 0:3], brow[:, 4:7], t_max)
        b_count = brow[:, 7].astype(jnp.int32)
        b_leaf = b_count > 0
        b_act = active & is_blas & b_hit
        b_left = brow[:, 3].astype(jnp.int32)

        hit = s["hit"]
        for i in range(MAX_LEAF):
            in_leaf = b_act & b_leaf & (i < b_count)
            tri = tri_pos[
                jnp.where(in_leaf, s["tri_base"] + b_left + i, 0)
            ]  # (R, 9)
            h = _tri_hit(
                s["co"], s["cd"], tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], t_max
            )
            hit = hit | (in_leaf & h)

        # --- stack pushes (masked, bounded, overflow-counted) --------
        stack = s["stack"]
        ovf = s["ovf"]

        def push(stack, sp, ovf, mask, value):
            full = mask & (sp >= STACK)
            write = mask & ~full
            slot = jnp.minimum(sp, STACK - 1)
            newcol = jnp.where(write, value, stack[rr, slot])
            stack = stack.at[rr, slot].set(newcol)
            sp = jnp.where(write, sp + 1, sp)
            return stack, sp, ovf + jnp.sum(full.astype(jnp.int32))

        # TLAS internal children
        stack, sp, ovf = push(stack, sp, ovf, push2, left)
        stack, sp, ovf = push(stack, sp, ovf, push2, right)
        # instance leaf -> BLAS root (encoded negative)
        stack, sp, ovf = push(stack, sp, ovf, enter, -(blas_root + 1))
        # BLAS internal children (adjacent pair, blas.rs:10-17; indices
        # are mesh-local -> add the pool base)
        push_b = b_act & ~b_leaf
        stack, sp, ovf = push(stack, sp, ovf, push_b, -(bvh_base + b_left + 1))
        stack, sp, ovf = push(stack, sp, ovf, push_b, -(bvh_base + b_left + 2))

        return dict(
            stack=stack,
            sp=sp,
            hit=hit,
            co=co,
            cd=cd,
            cinv=cinv,
            tri_base=tri_base,
            bvh_base=bvh_base,
            steps=s["steps"] + 1,
            ovf=ovf,
        )

    out = jax.lax.while_loop(cond, body, state)
    exhausted = jnp.sum(((out["sp"] > 0) & ~out["hit"]).astype(jnp.int32))
    return OcclusionResult(hit=out["hit"], overflow=out["ovf"], exhausted=exhausted)


def occluded_packets(
    tlas_rows,
    blas_rows,
    instance_rows,
    tri_pos,
    origins,  # (R, 3)
    directions,  # (R, 3)
    t_max=1.0,
    max_steps=4096,
    active=None,
    packet=128,
    chunk_packets=None,
):
    """Packet any-hit occlusion: `packet` coherent rays share ONE traversal
    stack, so each step fetches node/instance/triangle rows once per
    PACKET instead of once per ray — the dominant per-step cost drops from
    ~11 gather rows PER RAY to ~11/packet. Shadow rays from neighboring pixels toward one light visit
    nearly the same nodes, so the union traversal adds few extra steps.

    BIT-IDENTICAL to occluded(): every lane's triangle test is gated on
    its OWN leaf slab test (plus its own TLAS-leaf slab at instance
    entry), and the float slab predicate is monotone under the builder's
    exact parent-contains-child bounds — a lane that misses an ancestor
    AABB cannot pass a descendant's slab, so gating at the leaves
    reproduces the per-ray path gating exactly (tests/test_traverse.py).

    `chunk_packets`: process groups of that many packets sequentially
    (lax.map) so fast-terminating screen regions exit early — same
    rationale as occluded()'s chunk_size.
    """
    R = origins.shape[0]
    P = packet
    pad = (-R) % P

    def padp(x, fill=0):
        if not pad:
            return x
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
        )

    tm_full = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    act_full = jnp.ones((R,), bool) if active is None else active
    o = padp(origins).reshape(-1, P, 3)
    d = padp(directions).reshape(-1, P, 3)
    tm = padp(tm_full).reshape(-1, P)
    act = padp(act_full).reshape(-1, P)  # pad lanes inactive
    K = o.shape[0]

    if chunk_packets is not None and K > chunk_packets:
        kpad = (-K) % chunk_packets

        def padk(x, fill=0):
            if not kpad:
                return x
            return jnp.concatenate(
                [x, jnp.full((kpad,) + x.shape[1:], fill, x.dtype)]
            )

        G = (K + kpad) // chunk_packets
        shp = (G, chunk_packets)

        def one(args):
            oo, dd, tt, aa = args
            return _occluded_packets_core(
                tlas_rows, blas_rows, instance_rows, tri_pos,
                oo, dd, tt, aa, max_steps,
            )

        res = jax.lax.map(
            one,
            (
                padk(o).reshape(shp + (P, 3)),
                padk(d).reshape(shp + (P, 3)),
                padk(tm).reshape(shp + (P,)),
                padk(act).reshape(shp + (P,)),
            ),
        )
        return OcclusionResult(
            hit=res.hit.reshape(-1)[:R],
            overflow=jnp.sum(res.overflow),
            exhausted=jnp.sum(res.exhausted),
        )
    res = _occluded_packets_core(
        tlas_rows, blas_rows, instance_rows, tri_pos, o, d, tm, act,
        max_steps,
    )
    return OcclusionResult(
        hit=res.hit.reshape(-1)[:R],
        overflow=res.overflow,
        exhausted=res.exhausted,
    )


def _occluded_packets_core(
    tlas_rows, blas_rows, instance_rows, tri_pos, o, d, tm, act, max_steps
):
    """(K, P, 3) packet rays -> OcclusionResult with (K, P) hit."""
    K, P = o.shape[:2]
    inv0 = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    stack0 = jnp.zeros((K, STACK), jnp.int32)
    stack0 = stack0.at[:, 0].set(1)  # TLAS root
    sp0 = jnp.where(jnp.any(act, axis=1), 1, 0).astype(jnp.int32)

    state = dict(
        stack=stack0,
        sp=sp0,
        hit=jnp.zeros((K, P), bool),
        co=o,
        cd=d,
        cinv=inv0,
        # per-lane gate: this lane's own slab hit of the TLAS leaf whose
        # instance the packet is currently inside (per-ray entry parity)
        lane_in=jnp.zeros((K, P), bool),
        tri_base=jnp.zeros((K,), jnp.int32),
        bvh_base=jnp.zeros((K,), jnp.int32),
        steps=jnp.asarray(0, jnp.int32),
        ovf=jnp.asarray(0, jnp.int32),
    )
    kk = jnp.arange(K)

    def cond(s):
        live = jnp.any(act & ~s["hit"], axis=1)
        return jnp.any((s["sp"] > 0) & live) & (s["steps"] < max_steps)

    def body(s):
        lane_live = act & ~s["hit"]  # (K, P)
        pa = (s["sp"] > 0) & jnp.any(lane_live, axis=1)  # (K,)
        top = jnp.maximum(s["sp"] - 1, 0)
        entry = s["stack"][kk, top]
        sp = jnp.where(pa, s["sp"] - 1, s["sp"])

        is_blas = entry < 0
        t_node = jnp.where(pa & ~is_blas, entry - 1, 0)
        b_node = jnp.where(pa & is_blas, -entry - 1, 0)

        # --- TLAS step (original rays) -------------------------------
        trow = tlas_rows[checks.check_index(t_node, tlas_rows.shape[0], "rt.tlas_node")]  # (K, 8)
        t_hit = _slab(
            o, inv0, trow[:, None, 0:3], trow[:, None, 4:7], tm
        ) & lane_live  # (K, P)
        t_leaf = trow[:, 3] < 0.0
        t_act = pa & ~is_blas & jnp.any(t_hit, axis=1)

        left = trow[:, 3].astype(jnp.int32) + 1
        right = trow[:, 7].astype(jnp.int32) + 1
        push2 = t_act & ~t_leaf

        inst = jnp.where(t_leaf, trow[:, 7], 0.0).astype(jnp.int32)
        irow = instance_rows[checks.check_index(jnp.where(t_act & t_leaf, inst, 0), instance_rows.shape[0], "rt.instance")]  # (K, 24)
        # fastmath with a broadcast packet axis: IDENTICAL float order to
        # the per-ray path (bit-exactness depends on it)
        inv_t = irow[:, :16].reshape(K, 1, 4, 4)
        o_obj = fastmath.mat4_point(inv_t, o)
        d_obj = fastmath.mat3_vec(inv_t[:, :, :3, :3], d)
        enter = t_act & t_leaf
        em = enter[:, None, None]
        co = jnp.where(em, o_obj, s["co"])
        cd = jnp.where(em, d_obj, s["cd"])
        cinv = jnp.where(
            em,
            1.0 / jnp.where(jnp.abs(d_obj) > 1e-20, d_obj, 1e-20),
            s["cinv"],
        )
        lane_in = jnp.where(enter[:, None], t_hit, s["lane_in"])
        tri_base = jnp.where(
            enter, irow[:, 17].astype(jnp.int32), s["tri_base"]
        )
        bvh_base = jnp.where(
            enter, irow[:, 16].astype(jnp.int32), s["bvh_base"]
        )
        blas_root = irow[:, 16].astype(jnp.int32)

        # --- BLAS step (current object-space rays) -------------------
        brow = blas_rows[checks.check_index(b_node, blas_rows.shape[0], "rt.blas_node")]  # (K, 8)
        b_hit = _slab(
            s["co"], s["cinv"], brow[:, None, 0:3], brow[:, None, 4:7], tm
        ) & lane_live & s["lane_in"]  # (K, P) own-lane leaf gate
        b_count = brow[:, 7].astype(jnp.int32)
        b_leaf = b_count > 0
        b_act = pa & is_blas & jnp.any(b_hit, axis=1)
        b_left = brow[:, 3].astype(jnp.int32)

        hit = s["hit"]
        for i in range(MAX_LEAF):
            in_leaf = b_act & b_leaf & (i < b_count)  # (K,)
            tri = tri_pos[
                jnp.where(in_leaf, s["tri_base"] + b_left + i, 0)
            ]  # (K, 9)
            h = _tri_hit(
                s["co"], s["cd"], tri[:, None, 0:3], tri[:, None, 3:6],
                tri[:, None, 6:9], tm,
            )  # (K, P)
            hit = hit | (in_leaf[:, None] & b_hit & h)

        stack = s["stack"]
        ovf = s["ovf"]

        def push(stack, sp, ovf, mask, value):
            full = mask & (sp >= STACK)
            write = mask & ~full
            slot = jnp.minimum(sp, STACK - 1)
            newcol = jnp.where(write, value, stack[kk, slot])
            stack = stack.at[kk, slot].set(newcol)
            sp = jnp.where(write, sp + 1, sp)
            return stack, sp, ovf + jnp.sum(full.astype(jnp.int32))

        stack, sp, ovf = push(stack, sp, ovf, push2, left)
        stack, sp, ovf = push(stack, sp, ovf, push2, right)
        stack, sp, ovf = push(stack, sp, ovf, enter, -(blas_root + 1))
        push_b = b_act & ~b_leaf
        stack, sp, ovf = push(
            stack, sp, ovf, push_b, -(bvh_base + b_left + 1)
        )
        stack, sp, ovf = push(
            stack, sp, ovf, push_b, -(bvh_base + b_left + 2)
        )

        return dict(
            stack=stack,
            sp=sp,
            hit=hit,
            co=co,
            cd=cd,
            cinv=cinv,
            lane_in=lane_in,
            tri_base=tri_base,
            bvh_base=bvh_base,
            steps=s["steps"] + 1,
            ovf=ovf,
        )

    out = jax.lax.while_loop(cond, body, state)
    exhausted = jnp.sum(
        ((out["sp"] > 0) & jnp.any(act & ~out["hit"], axis=1)).astype(
            jnp.int32
        )
    )
    return OcclusionResult(
        hit=out["hit"], overflow=out["ovf"], exhausted=exhausted
    )


# ---------------------------------------------------------------------------
# Threaded (stackless) packet traversal — round-5 replacement for the
# stack-based packet loop. Exit links (rt/bvh.py exit_links) turn the
# traversal into hit->first-child / miss->exit pointer chasing: the while
# body becomes ONE unified node-row gather + one slab test + the leaf
# triangle tests, with ZERO stack scatters (the stack version pays 5 masked
# scatter pushes + two slab tests per step — the dominant per-step cost on
# hardware). Visits the exact same gated node set as occluded_packets, so
# the hit output is bit-identical (tests/test_traverse_threaded.py).
# ---------------------------------------------------------------------------


def pack_threaded_table(
    tlas_min, tlas_max, tlas_left_right, tlas_instance, tlas_exit,
    blas_min, blas_max, blas_left_first, blas_count, blas_exit,
):
    """ONE (Bt+Bb, 16) f32 node table: [min3, a, max3, exit, count, pad7].

    TLAS rows first (a = left child, or -(instance+1) for leaves; exit
    globally encoded e+1, 0 = done); BLAS rows after (a = left_first,
    mesh-local; leaf iff count > 0; exit mesh-LOCAL encoded e+1, 0 =
    subtree done -> resume to the saved TLAS exit). 64 B rows are inside
    the flat gather-cost regime (<= 96 B, CLAUDE.md round-4)."""
    lr = tlas_left_right.astype(jnp.uint32)
    left = (lr & 0xFFFF).astype(jnp.float32)
    is_leaf = lr == 0
    a_t = jnp.where(is_leaf, -(tlas_instance.astype(jnp.float32) + 1.0), left)
    Bt = tlas_min.shape[0]
    trow = jnp.concatenate(
        [
            tlas_min, a_t[:, None], tlas_max,
            tlas_exit.astype(jnp.float32)[:, None],
            jnp.zeros((Bt, 8), jnp.float32),
        ],
        axis=-1,
    )
    Bb = blas_min.shape[0]
    brow = jnp.concatenate(
        [
            blas_min,
            blas_left_first.astype(jnp.float32)[:, None],
            blas_max,
            blas_exit.astype(jnp.float32)[:, None],
            blas_count.astype(jnp.float32)[:, None],
            jnp.zeros((Bb, 7), jnp.float32),
        ],
        axis=-1,
    )
    return jnp.concatenate([trow, brow], axis=0), Bt


def occluded_threaded(
    table,  # (Bt+Bb, 16) from pack_threaded_table
    n_tlas,  # static int: number of TLAS rows
    instance_rows,  # (N, 24)
    tri_pos,  # (T_pool, 9)
    origins,  # (R, 3)
    directions,  # (R, 3) NOT normalized; t_max in units of |direction|
    t_max=1.0,
    max_steps=4096,
    active=None,
    packet=128,
    chunk_packets=None,
    max_leaf=MAX_LEAF,
    unroll=1,
):
    """Stackless packet any-hit occlusion. Same contract and BIT-IDENTICAL
    results as occluded_packets (same per-lane slab/leaf gating — see
    module comment above); ~3x fewer gather/scatter rows per step."""
    R = origins.shape[0]
    P = packet
    pad = (-R) % P

    def padp(x, fill=0):
        if not pad:
            return x
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
        )

    tm_full = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    act_full = jnp.ones((R,), bool) if active is None else active
    o = padp(origins).reshape(-1, P, 3)
    d = padp(directions).reshape(-1, P, 3)
    tm = padp(tm_full).reshape(-1, P)
    act = padp(act_full).reshape(-1, P)
    K = o.shape[0]

    if chunk_packets is not None and K > chunk_packets:
        kpad = (-K) % chunk_packets

        def padk(x, fill=0):
            if not kpad:
                return x
            return jnp.concatenate(
                [x, jnp.full((kpad,) + x.shape[1:], fill, x.dtype)]
            )

        G = (K + kpad) // chunk_packets
        shp = (G, chunk_packets)

        def one(args):
            oo, dd, tt, aa = args
            return _occluded_threaded_core(
                table, n_tlas, instance_rows, tri_pos,
                oo, dd, tt, aa, max_steps, max_leaf, unroll,
            )

        res = jax.lax.map(
            one,
            (
                padk(o).reshape(shp + (P, 3)),
                padk(d).reshape(shp + (P, 3)),
                padk(tm).reshape(shp + (P,)),
                padk(act).reshape(shp + (P,)),
            ),
        )
        return OcclusionResult(
            hit=res.hit.reshape(-1)[:R],
            overflow=jnp.sum(res.overflow),
            exhausted=jnp.sum(res.exhausted),
        )
    res = _occluded_threaded_core(
        table, n_tlas, instance_rows, tri_pos, o, d, tm, act, max_steps,
        max_leaf, unroll,
    )
    return OcclusionResult(
        hit=res.hit.reshape(-1)[:R],
        overflow=res.overflow,
        exhausted=res.exhausted,
    )


def _occluded_threaded_core(
    table, n_tlas, instance_rows, tri_pos, o, d, tm, act, max_steps,
    max_leaf, unroll=1,
):
    """(K, P, 3) packet rays -> OcclusionResult with (K, P) hit.

    cur encoding: TLAS node t as t+1, BLAS pool node b as -(b+1), 0 = done.
    resume holds the saved TLAS exit (TLAS encoding) of the instance leaf
    the packet is currently inside; one slot suffices because a BLAS
    subtree always completes before the TLAS walk continues (the same LIFO
    invariant the stack version relies on)."""
    K, P = o.shape[:2]
    inv0 = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)

    state = dict(
        cur=jnp.where(jnp.any(act, axis=1), 1, 0).astype(jnp.int32),
        resume=jnp.zeros((K,), jnp.int32),
        hit=jnp.zeros((K, P), bool),
        co=o,
        cd=d,
        cinv=inv0,
        lane_in=jnp.zeros((K, P), bool),
        tri_base=jnp.zeros((K,), jnp.int32),
        bvh_base=jnp.zeros((K,), jnp.int32),
        steps=jnp.asarray(0, jnp.int32),
    )

    def cond(s):
        live = jnp.any(act & ~s["hit"], axis=1)
        return jnp.any((s["cur"] != 0) & live) & (s["steps"] < max_steps)

    def body(s):
        lane_live = act & ~s["hit"]  # (K, P)
        cur = s["cur"]
        pa = (cur != 0) & jnp.any(lane_live, axis=1)  # (K,)
        is_blas = cur < 0
        t_node = jnp.where(pa & ~is_blas, cur - 1, 0)
        b_node = jnp.where(pa & is_blas, -cur - 1, 0)
        idx = jnp.where(is_blas, n_tlas + b_node, t_node)
        row = table[checks.check_index(idx, table.shape[0], "rt.node")]
        a = row[:, 3]
        exit_enc = row[:, 7].astype(jnp.int32)
        count = jnp.where(is_blas, row[:, 8], 0.0).astype(jnp.int32)

        # one slab test on the per-packet SELECTED ray (original for TLAS
        # steps, current object-space for BLAS steps)
        o_sel = jnp.where(is_blas[:, None, None], s["co"], o)
        inv_sel = jnp.where(is_blas[:, None, None], s["cinv"], inv0)
        gate = lane_live & jnp.where(is_blas[:, None], s["lane_in"], True)
        shit = _slab(
            o_sel, inv_sel, row[:, None, 0:3], row[:, None, 4:7], tm
        ) & gate  # (K, P)
        node_hit = pa & jnp.any(shit, axis=1)

        # --- TLAS leaf: enter instance (transform rays, save resume) ----
        t_leaf = ~is_blas & (a < 0.0)
        enter = node_hit & t_leaf
        inst = jnp.where(enter, -a - 1.0, 0.0).astype(jnp.int32)
        irow = instance_rows[
            checks.check_index(inst, instance_rows.shape[0], "rt.instance")
        ]  # (K, 24)
        inv_t = irow[:, :16].reshape(K, 1, 4, 4)
        o_obj = fastmath.mat4_point(inv_t, o)
        d_obj = fastmath.mat3_vec(inv_t[:, :, :3, :3], d)
        em = enter[:, None, None]
        co = jnp.where(em, o_obj, s["co"])
        cd = jnp.where(em, d_obj, s["cd"])
        cinv = jnp.where(
            em,
            1.0 / jnp.where(jnp.abs(d_obj) > 1e-20, d_obj, 1e-20),
            s["cinv"],
        )
        lane_in = jnp.where(enter[:, None], shit, s["lane_in"])
        tri_base = jnp.where(
            enter, irow[:, 17].astype(jnp.int32), s["tri_base"]
        )
        bvh_base = jnp.where(
            enter, irow[:, 16].astype(jnp.int32), s["bvh_base"]
        )
        resume = jnp.where(enter, exit_enc, s["resume"])

        # --- BLAS leaf: triangle tests (own-lane slab gate, as the stack
        # version gates with b_hit) ---------------------------------------
        b_left = jnp.where(is_blas, a, 0.0).astype(jnp.int32)
        b_leaf_act = node_hit & is_blas & (count > 0)
        hit = s["hit"]
        for i in range(max_leaf):
            in_leaf = b_leaf_act & (i < count)  # (K,)
            tri = tri_pos[
                jnp.where(in_leaf, s["tri_base"] + b_left + i, 0)
            ]  # (K, 9)
            h = _tri_hit(
                s["co"], s["cd"], tri[:, None, 0:3], tri[:, None, 3:6],
                tri[:, None, 6:9], tm,
            )  # (K, P)
            hit = hit | (in_leaf[:, None] & shit & h)

        # --- next node: hit-internal -> first child; TLAS-leaf-hit ->
        # BLAS root; everything else -> exit link --------------------------
        t_int_hit = node_hit & ~is_blas & ~t_leaf
        b_int_hit = node_hit & is_blas & (count <= 0)
        exit_b = jnp.where(
            exit_enc > 0, -(s["bvh_base"] + exit_enc), resume
        )
        nxt = jnp.where(
            t_int_hit, a.astype(jnp.int32) + 1,
            jnp.where(
                enter, -(irow[:, 16].astype(jnp.int32) + 1),
                jnp.where(
                    b_int_hit, -(bvh_base + b_left + 1),
                    jnp.where(is_blas, exit_b, exit_enc),
                ),
            ),
        )
        cur = jnp.where(pa, nxt, cur)

        return dict(
            cur=cur,
            resume=resume,
            hit=hit,
            co=co,
            cd=cd,
            cinv=cinv,
            lane_in=lane_in,
            tri_base=tri_base,
            bvh_base=bvh_base,
            steps=s["steps"] + 1,
        )

    if unroll > 1:
        # Compose the step `unroll` times per while iteration: each
        # device-side loop step carries a fixed dispatch overhead, and
        # one node per packet per step makes the walk iteration-bound.
        # body() is masked per packet (pa / cur==0 no-ops) so
        # body^M == M sequential steps; the steps < max_steps guard
        # keeps even exhaustion cases BIT-EXACT vs unroll=1
        # (tests/test_traverse_threaded.py).
        inner = body

        def body(s):  # noqa: F811
            for _ in range(unroll):
                s2 = inner(s)
                ok = s["steps"] < max_steps
                s = {
                    k: jnp.where(ok, s2[k], s[k]) for k in s2
                }
            return s

    out = jax.lax.while_loop(cond, body, state)
    exhausted = jnp.sum(
        ((out["cur"] != 0) & jnp.any(act & ~out["hit"], axis=1)).astype(
            jnp.int32
        )
    )
    return OcclusionResult(
        hit=out["hit"], overflow=jnp.asarray(0, jnp.int32),
        exhausted=exhausted,
    )


def scene_rays_threaded(scene):
    """Packed threaded-traversal tables from SceneData: (table, n_tlas,
    instance_rows, tri_pos). n_tlas is static; pass
    scene.meshes.bvh_max_leaf as occluded_threaded's max_leaf."""
    m = scene.meshes
    t = scene.tlas
    table, n_tlas = pack_threaded_table(
        t.tlas_min, t.tlas_max, t.tlas_left_right, t.tlas_instance,
        t.tlas_exit,
        m.bvh_min, m.bvh_max, m.bvh_left_first, m.bvh_count, m.bvh_exit,
    )
    inst = pack_instance_rows(
        scene.instances.inv_transform, m.bvh_index, m.base_index,
        scene.instances.mesh_id,
    )
    return table, n_tlas, inst, m.tri_pos


def scene_rays(scene):
    """Convenience: packed traversal tables from SceneData."""
    m = scene.meshes
    blas = pack_blas_rows(m.bvh_min, m.bvh_max, m.bvh_left_first, m.bvh_count)
    t = scene.tlas
    tlas = pack_tlas_rows(t.tlas_min, t.tlas_max, t.tlas_left_right, t.tlas_instance)
    inst = pack_instance_rows(
        scene.instances.inv_transform, m.bvh_index, m.base_index,
        scene.instances.mesh_id,
    )
    return tlas, blas, inst, m.tri_pos


def closest_hit(
    tlas_rows,
    blas_rows,
    instance_rows,
    tri_pos,
    origins,
    directions,
    t_max=MAX_DIST,
    max_steps=2048,
    active=None,
):
    """Closest-hit traversal (bvh_trace.wgsl equivalent).

    Returns ClosestHitResult: hit distance in |direction| units (t_max on
    miss), the per-ray node-visit count (the reference demo's
    traversal-depth heat overlay, src/bin/bvh_trace.wgsl:243-244), plus
    overflow / steps-exhausted counters.
    """
    R = origins.shape[0]
    t0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    inv0 = 1.0 / jnp.where(jnp.abs(directions) > 1e-20, directions, 1e-20)
    stack0 = jnp.zeros((R, STACK), jnp.int32)
    stack0 = stack0.at[:, 0].set(1)
    sp0 = jnp.ones((R,), jnp.int32)
    if active is not None:
        sp0 = jnp.where(active, sp0, 0)

    state = dict(
        stack=stack0,
        sp=sp0,
        t=t0,
        co=origins,
        cd=directions,
        cinv=inv0,
        tri_base=jnp.zeros((R,), jnp.int32),
        bvh_base=jnp.zeros((R,), jnp.int32),
        visits=jnp.zeros((R,), jnp.int32),
        steps=jnp.asarray(0, jnp.int32),
        ovf=jnp.asarray(0, jnp.int32),
    )
    rr = jnp.arange(R)

    def cond(s):
        return jnp.any(s["sp"] > 0) & (s["steps"] < max_steps)

    def body(s):
        act = s["sp"] > 0
        top = jnp.maximum(s["sp"] - 1, 0)
        entry = s["stack"][rr, top]
        sp = jnp.where(act, s["sp"] - 1, s["sp"])

        is_blas = entry < 0
        t_node = jnp.where(act & ~is_blas, entry - 1, 0)
        b_node = jnp.where(act & is_blas, -entry - 1, 0)

        trow = tlas_rows[checks.check_index(t_node, tlas_rows.shape[0], "rt.tlas_node")]
        t_hit = _slab(origins, inv0, trow[:, 0:3], trow[:, 4:7], s["t"])
        t_leaf = trow[:, 3] < 0.0
        t_act = act & ~is_blas & t_hit
        left = trow[:, 3].astype(jnp.int32) + 1
        right = trow[:, 7].astype(jnp.int32) + 1
        push2 = t_act & ~t_leaf

        inst = jnp.where(t_leaf, trow[:, 7], 0.0).astype(jnp.int32)
        irow = instance_rows[checks.check_index(jnp.where(t_act & t_leaf, inst, 0), instance_rows.shape[0], "rt.instance")]
        inv_t = irow[:, :16].reshape(R, 4, 4)
        o_obj = fastmath.mat4_point(inv_t, origins)
        d_obj = fastmath.mat3_vec(inv_t[:, :3, :3], directions)
        enter = t_act & t_leaf
        co = jnp.where(enter[:, None], o_obj, s["co"])
        cd = jnp.where(enter[:, None], d_obj, s["cd"])
        cinv = jnp.where(
            enter[:, None],
            1.0 / jnp.where(jnp.abs(d_obj) > 1e-20, d_obj, 1e-20),
            s["cinv"],
        )
        tri_base = jnp.where(enter, irow[:, 17].astype(jnp.int32), s["tri_base"])
        bvh_base = jnp.where(enter, irow[:, 16].astype(jnp.int32), s["bvh_base"])
        blas_root = irow[:, 16].astype(jnp.int32)

        brow = blas_rows[checks.check_index(b_node, blas_rows.shape[0], "rt.blas_node")]
        b_hit = _slab(s["co"], s["cinv"], brow[:, 0:3], brow[:, 4:7], s["t"])
        b_count = brow[:, 7].astype(jnp.int32)
        b_leaf = b_count > 0
        b_act = act & is_blas & b_hit
        b_left = brow[:, 3].astype(jnp.int32)

        t_best = s["t"]
        for i in range(MAX_LEAF):
            in_leaf = b_act & b_leaf & (i < b_count)
            tri = tri_pos[jnp.where(in_leaf, s["tri_base"] + b_left + i, 0)]
            th = _tri_t(s["co"], s["cd"], tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
            t_best = jnp.where(in_leaf & (th > 0) & (th < t_best), th, t_best)

        stack = s["stack"]
        ovf = s["ovf"]

        def push(stack, sp, ovf, mask, value):
            full = mask & (sp >= STACK)
            write = mask & ~full
            slot = jnp.minimum(sp, STACK - 1)
            newcol = jnp.where(write, value, stack[rr, slot])
            stack = stack.at[rr, slot].set(newcol)
            sp = jnp.where(write, sp + 1, sp)
            return stack, sp, ovf + jnp.sum(full.astype(jnp.int32))

        stack, sp, ovf = push(stack, sp, ovf, push2, left)
        stack, sp, ovf = push(stack, sp, ovf, push2, right)
        stack, sp, ovf = push(stack, sp, ovf, enter, -(blas_root + 1))
        push_b = b_act & ~b_leaf
        stack, sp, ovf = push(stack, sp, ovf, push_b, -(bvh_base + b_left + 1))
        stack, sp, ovf = push(stack, sp, ovf, push_b, -(bvh_base + b_left + 2))

        return dict(
            stack=stack,
            sp=sp,
            t=t_best,
            co=co,
            cd=cd,
            cinv=cinv,
            tri_base=tri_base,
            bvh_base=bvh_base,
            visits=s["visits"] + act.astype(jnp.int32),
            steps=s["steps"] + 1,
            ovf=ovf,
        )

    out = jax.lax.while_loop(cond, body, state)
    exhausted = jnp.sum((out["sp"] > 0).astype(jnp.int32))
    return ClosestHitResult(
        t=out["t"], visits=out["visits"], overflow=out["ovf"], exhausted=exhausted
    )


def _tri_t(o, d, v0, v1, v2):
    """Moller-Trumbore distance (backface-culled); -1 on miss."""
    e1 = v1 - v0
    e2 = v2 - v0
    uvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * uvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    orig = o - v0
    u = inv_det * jnp.sum(orig * uvec, axis=-1)
    vvec = jnp.cross(orig, e1)
    v = inv_det * jnp.sum(d * vvec, axis=-1)
    t = inv_det * jnp.sum(e2 * vvec, axis=-1)
    ok = (det >= 1e-10) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return jnp.where(ok, t, -1.0)
