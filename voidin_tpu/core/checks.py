"""Optional OOB bounds validation for data-dependent gather indices.

The frame pipeline is full of data-dependent indexing (resolve records,
texel rows, BVH nodes, traversal stacks) guarded in production only by
capacity/overflow counters — the SURVEY §5.2 sanitizer plan
("checkify for OOB gathers") lands here. With
``RasterConfig.debug_bounds`` the Renderer traces the frame under
``jax.experimental.checkify`` and every `check_index` call becomes a
functionalized assert; production traces pay nothing (the helper is a
no-op passthrough unless the thread-local flag is set at trace time).

The reference relies on wgpu's validation layers for the same class of
bug (robustBufferAccess clamps; debug builds assert) — this is the XLA
analogue, where gathers would silently clamp/wrap instead.

Thread-local (not global): concurrent traces on other threads
(PipelineCache rebuilds, tests) must not inherit the mode.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp

_LOCAL = threading.local()


def bounds_enabled() -> bool:
    return getattr(_LOCAL, "bounds", False)


def set_bounds_enabled(v: bool) -> None:
    _LOCAL.bounds = bool(v)


def check_index(idx, n, name: str):
    """Assert every value of `idx` is a valid row of an `n`-row table.

    Returns `idx` unchanged so call sites read
    ``table[check_index(i, table.shape[0], "resolve.rec")]``. Under a
    checkify trace the failed check carries `name`; outside debug_bounds
    this is a zero-cost passthrough.
    """
    if bounds_enabled():
        from jax.experimental import checkify

        idx_arr = jnp.asarray(idx)
        checkify.check(
            jnp.all((idx_arr >= 0) & (idx_arr < n)),
            name + ": gather index out of range [0, {n})",
            n=jnp.asarray(n, jnp.int32),
        )
    return idx
