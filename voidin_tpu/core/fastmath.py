"""Batched small-matrix arithmetic and resize helpers.

XLA lowers `einsum` with tiny contraction dims (3 or 4) on large batches to
batched dot_generals, which break fusion and may run in reduced precision
(TF32 on GPUs). These helpers express the same contractions as explicit
elementwise multiply-adds, which XLA fuses into the surrounding code, in
full f32. Every per-pixel / per-triangle matrix op in the frame goes
through here; the few real matrix products ask for Precision.HIGHEST.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def mat3_vec(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3), elementwise."""
    return jnp.stack(
        [
            m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1] + m[..., 0, 2] * v[..., 2],
            m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1] + m[..., 1, 2] * v[..., 2],
            m[..., 2, 0] * v[..., 0] + m[..., 2, 1] * v[..., 1] + m[..., 2, 2] * v[..., 2],
        ],
        axis=-1,
    )


def mat3_mat3(a, b):
    """(..., 3, 3) @ (..., 3, 3) -> (..., 3, 3), elementwise."""
    rows = []
    for i in range(3):
        cols = []
        for j in range(3):
            cols.append(
                a[..., i, 0] * b[..., 0, j]
                + a[..., i, 1] * b[..., 1, j]
                + a[..., i, 2] * b[..., 2, j]
            )
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def mat4_point(m, p):
    """(..., 4, 4) applied to (..., 3) points (w=1) -> (..., 3)."""
    return jnp.stack(
        [
            m[..., i, 0] * p[..., 0]
            + m[..., i, 1] * p[..., 1]
            + m[..., i, 2] * p[..., 2]
            + m[..., i, 3]
            for i in range(3)
        ],
        axis=-1,
    )


def mat4_point4(m, p):
    """(..., 4, 4) applied to (..., 3) points (w=1) -> (..., 4) clip coords."""
    return jnp.stack(
        [
            m[..., i, 0] * p[..., 0]
            + m[..., i, 1] * p[..., 1]
            + m[..., i, 2] * p[..., 2]
            + m[..., i, 3]
            for i in range(4)
        ],
        axis=-1,
    )


def const_mat4_point4(m, x, y, z, w=None):
    """Constant (4, 4) matrix applied to per-pixel component planes.

    x/y/z[/w] are broadcast-compatible arrays; returns a list of 4 planes.
    """
    out = []
    for i in range(4):
        acc = m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
        acc = acc + (m[i, 3] if w is None else m[i, 3] * w)
        out.append(acc)
    return out


def const_mat_vec(m, v):
    """Constant (R, C) matrix times (..., C) batch -> (..., R)."""
    R, C = m.shape
    cols = [v[..., c] for c in range(C)]
    return jnp.stack(
        [sum(float(m[r, c]) * cols[c] for c in range(C)) for r in range(R)],
        axis=-1,
    )


def compose_mat4(a, b):
    """(4, 4) @ (N, 4, 4) -> (N, 4, 4) as one real matmul.

    Contraction written as (4,4) @ (4, N*4): one wide product instead of N
    tiny ones. Full f32 (Precision.HIGHEST): these are every instance's
    MVP and the cull matrices, and TF32 would move vertices and reverse-Z
    depth.
    """
    n = b.shape[0]
    wide = jnp.transpose(b, (1, 0, 2)).reshape(4, n * 4)
    out = jnp.matmul(a, wide, precision=HIGHEST).reshape(4, n, 4)
    return jnp.transpose(out, (1, 0, 2))


def compact_indices(mask_flat, size):
    """Indices of the True entries of a flat bool mask, ascending, padded
    to `size` — the compaction primitive behind every edge-quad / cut-
    pixel batch. jnp.nonzero(size=) lowers to a FULL-LENGTH scatter; a
    single-operand sort of fused (mask, reversed-index) keys yields the
    same first-count indices. Pad slots hold arbitrary (False-entry)
    indices rather than nonzero's fill_value — every call site already masks slots with
    arange(size) < count, so results are unchanged."""
    n = mask_flat.shape[0]
    # one-operand sort: pack (mask, reversed index) into a single u32 key
    # — descending order puts True entries first with ascending indices,
    # at half the cost of a two-operand argsort (sorts price per operand)
    bits = max(int(n - 1).bit_length(), 1)
    assert bits <= 31, "mask too large for fused compaction keys"
    iota = jnp.arange(n, dtype=jnp.uint32)
    key = (mask_flat.astype(jnp.uint32) << bits) | (
        jnp.uint32(n - 1) - iota
    )
    skey = jax.lax.sort(key, is_stable=False)[::-1]  # descending
    order = (jnp.uint32(n - 1) - (
        skey & jnp.uint32((1 << bits) - 1)
    )).astype(jnp.int32)
    if size <= n:
        return order[:size]
    # capacity beyond the mask length (tiny images): pad like nonzero does
    return jnp.concatenate(
        [order, jnp.zeros(size - n, order.dtype)]
    )


def _bilinear_matrix(n_out: int, n_in: int, s: int):
    """(n_out, n_in) numpy f32 interpolation matrix reproducing
    jax.image.resize('bilinear') upsample weights at integer scale s:
    half-pixel centers src = (i + 0.5)/s - 0.5, edge clamp."""
    import numpy as np

    src = (np.arange(n_out, dtype=np.float64) + 0.5) / s - 0.5
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = np.clip(src - np.floor(src), 0.0, 1.0)
    w_hi = np.where(src < 0, 0.0, np.where(src > n_in - 1, 1.0, w_hi))
    m = np.zeros((n_out, n_in), dtype=np.float32)
    m[np.arange(n_out), lo] += (1.0 - w_hi).astype(np.float32)
    m[np.arange(n_out), hi] += w_hi.astype(np.float32)
    return m


def upsample_bilinear_mm(x, s: int, h_out: int, w_out: int):
    """(h, w, C) -> (h_out, w_out, C) bilinear upsample as TWO dot_generals
    on constant weight matrices (Precision.HIGHEST: full f32 weights)."""
    h, w, c = x.shape
    ah = jnp.asarray(_bilinear_matrix(h_out, h, s))
    aw = jnp.asarray(_bilinear_matrix(w_out, w, s))
    # rows: (h_out, h) @ (h, w*c) -> (h_out, w, c)
    y = jnp.matmul(ah, x.reshape(h, w * c), precision=HIGHEST).reshape(
        h_out, w, c
    )
    # cols: contract w with aw^T: (h_out, w, c) x (w_out, w) -> (h_out, c, w_out)
    y = jax.lax.dot_general(
        y, aw, (((1,), (1,)), ((), ())),
        precision=HIGHEST, preferred_element_type=jnp.float32,
    )
    return jnp.transpose(y, (0, 2, 1))


def subsample_mm(x, s: int):
    """(h, w, C) -> (h//s', w//s', C) every-s-th-pixel selection as two
    dot_generals with one-hot matrices, s' rounding up like x[::s].
    Precision.HIGHEST keeps the selection exact in f32."""
    import numpy as np

    h, w, c = x.shape
    ho, wo = -(-h // s), -(-w // s)
    sh = np.zeros((ho, h), dtype=np.float32)
    sh[np.arange(ho), np.arange(ho) * s] = 1.0
    sw = np.zeros((wo, w), dtype=np.float32)
    sw[np.arange(wo), np.arange(wo) * s] = 1.0
    y = jnp.matmul(
        jnp.asarray(sh), x.reshape(h, w * c), precision=HIGHEST
    ).reshape(ho, w, c)
    y = jax.lax.dot_general(
        y, jnp.asarray(sw), (((1,), (1,)), ((), ())),
        precision=HIGHEST, preferred_element_type=jnp.float32,
    )
    return jnp.transpose(y, (0, 2, 1))
