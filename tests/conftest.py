"""Test harness config: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU; multi-card behavior (time/channel sharding, halo
exchange) is validated on virtual CPU devices per SURVEY §4(c).  The
program runs on the GPU through ``chip_smoke.py`` and ``bench.py``.  The
platform is set through jax.config before any backend is initialized, so a
machine whose default backend is a GPU still tests on the CPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
