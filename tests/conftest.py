"""Test config: the suite runs on the CPU with 8 virtual devices (multi-device
sharding tests run on a simulated mesh). The GPU path is exercised by
`python chip_smoke.py` on a machine with the card, not here.

JAX_PLATFORMS=cpu is set before jax is imported, and the live config is
updated too, in case jax was imported earlier in the process."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
