"""Device facts, timing and the compile cache for the harness scripts.

bench.py, chip_smoke.py, the examples and tools/ share these so every
measurement names the device it ran on and every process finds the same
persistent compile cache.
"""

from __future__ import annotations

import os
import subprocess
import time

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache at a fixed path.

    Where JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing
    is set here; otherwise the cache lives in <checkout>/.jax_cache (listed
    in .gitignore). Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def gpu_name_power() -> list[str]:
    """`name, power.limit` of each NVIDIA card as nvidia-smi reports it
    (empty where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=REPO_ROOT, timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def device_stamp() -> dict:
    """What every benchmark line carries about where it ran."""
    import jax

    d = jax.devices()[0]
    return dict(
        platform=d.platform,
        device_kind=d.device_kind,
        device_count=len(jax.devices()),
        gpu=gpu_name_power(),
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        git_sha=git_sha(),
    )


def require_accelerator(what: str) -> None:
    """Exit non-zero when JAX found no accelerator: a CPU number is not a
    device measurement, and nothing falls back to the CPU."""
    import jax

    if jax.default_backend() == "cpu":
        raise SystemExit(
            f"{what}: JAX found no accelerator (backend=cpu); "
            "this measurement runs only on the GPU"
        )


def time_calls(fn, n: int):
    """Compile seconds (the first call, blocked) and per-call ms of `n`
    further calls, each ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ms.append((time.perf_counter() - t0) * 1e3)
    return compile_s, ms
