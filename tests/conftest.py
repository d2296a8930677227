"""Test harness config: CPU backend with 8 virtual devices + float64.

The suite runs on the CPU: ``JAX_PLATFORMS`` defaults to ``cpu`` here,
and 8 virtual CPU devices let the multi-device sharding tests build a
real `jax.sharding.Mesh`. Tests marked ``chip`` need a GPU; they skip on
the CPU and run in-process from ``chip_smoke.py`` on the card, where JAX
is already initialized and nothing below changes its platform.
"""

import os
import sys

if "jax" not in sys.modules:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # XLA_FLAGS is read lazily at backend init, which hasn't happened yet.
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
