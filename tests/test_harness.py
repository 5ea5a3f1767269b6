"""The harness scripts: compile-cache placement, and the refusal of the
GPU measurement scripts to run (or report) without an accelerator."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from voidin_tpu.framework import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_compile_cache_placement(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: the helper sets nothing and reports
    it. Unset: the cache goes to <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    try:
        got = device.enable_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir is None:
        assert got == now == os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        assert got == env_dir and now == before


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a CPU-only process (or outside a checkout) chip_smoke.py exits
    non-zero and prints no result line."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    p = _run(["chip_smoke.py"], cwd)
    assert p.returncode != 0, p.stdout
    assert '"ok"' not in p.stdout


def test_bench_fails_without_gpu():
    p = _run(["bench.py"], ROOT)
    assert p.returncode != 0
    assert "no accelerator" in p.stderr
