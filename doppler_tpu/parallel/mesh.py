"""Device meshes for time × channel sharding.

The framework's parallelism (SURVEY §2 "parallelism strategies") maps the
stream onto a 2-D logical mesh:

- ``'time'``    — shards the sample axis (the sequence/context-parallel
  analog).  Exact for the mixer (phase is per-block constants); the
  resampler needs only an O(taps) halo from the left neighbor.
- ``'channel'`` — shards independent satellite channels (the data-parallel
  analog; BASELINE configs 4-5).

The cards of one host are joined all to all (NVLink), so the layout
follows the algorithm alone: 'channel' needs no communication at all, and
'time' moves one O(taps) halo per shard per chunk.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "iq_sharding", "plan_sharding", "P"]


def make_mesh(time: int = 1, channel: int = 1, devices=None) -> Mesh:
    """Build a ``(channel, time)`` mesh from the available devices.

    Defaults to the *process-local* devices: under multi-host operation
    (``parallel.distributed.init``) each host runs its own mesh over its
    own cards — the host axis is decomposed by stream/channel range
    (``host_slice``), not by a global device mesh, so no collective ever
    crosses hosts (see parallel/distributed.py).
    """
    devices = list(devices if devices is not None else jax.local_devices())
    need = time * channel
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(channel, time)
    return Mesh(arr, ("channel", "time"))


def iq_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``(C, B, L)`` chunk arrays: channels × time-blocks."""
    return NamedSharding(mesh, P("channel", "time", None))


def plan_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``(C, B)`` per-block plan arrays."""
    return NamedSharding(mesh, P("channel", "time"))
