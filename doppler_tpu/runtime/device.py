"""Process-wide JAX set-up shared by the CLI, ``bench.py`` and
``chip_smoke.py``: the persistent compile cache and the device identity.

Compile cache: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it; otherwise the cache lives at one fixed
path inside the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``).
The path is part of the cache key, so it never depends on a process id, a
time or a temporary directory.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = ["REPO_CACHE_DIR", "compile_cache_dir", "enable_compile_cache",
           "device_summary", "card_identity"]

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    (a no-op for the directory when the environment already names one)."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_summary() -> dict:
    """Platform, device kind and count of the devices JAX sees."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_identity() -> list[str]:
    """``nvidia-smi`` name and power limit, one line per card ([] without
    nvidia-smi).  A card may be set below its maximum power, and then runs
    slower under load, so every timing is reported beside this."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
