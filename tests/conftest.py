"""Test configuration: force the CPU backend with 8 virtual devices.

The tests run on the JAX CPU backend, with the Pallas kernel in interpret
mode; multi-device sharding tests use the 8 virtual devices.
`jax.config.update` pins the CPU backend and must run before any backend
use.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
