"""Multi-host initialization and stream partitioning.

The reference is strictly single-process (SURVEY §2); multi-host operation
is designed around the framework's
central theorem: *every per-sample quantity is a pure function of absolute
stream position* (NCO phase via the host-emulated counter, resampler
alignment via Bresenham on absolute indices, FIR history via the T−1
preceding samples).  "Resume = seek" therefore also means "distribute =
seek": hosts split the capture by byte range, each seeds its state exactly
at its boundary (``Pipeline.seek_to_block``) and reads its own T−1-sample
history directly from the file — so the host axis needs **zero network
traffic**, not even halo exchange.  Within a host, ONE process drives all
of that host's cards as the usual ``(channel, time)`` mesh, joined all to
all by NVLink (``parallel.sharded``).  A JAX process reserves most of a
card's memory when it starts, so processes never share a card: run one
process per host, or hand each process its own cards.

- every host calls :func:`init` (a ``jax.distributed.initialize`` wrapper;
  on CPU backends it selects the gloo TCP collectives so the same topology
  runs in miniature on fake devices — tests/test_distributed.py);
- :func:`host_slice` computes which (channel, time-block) range this host
  owns, channel-major first (channels are embarrassingly parallel), then
  time blocks;
- ``HostShard.byte_range`` turns the block range into input-file seek
  offsets so per-host readers are independent.

Single-host runs skip ``init`` entirely; everything else in the
framework works unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax

__all__ = ["init", "host_slice", "HostShard", "parse_distributed_spec"]


def parse_distributed_spec(text: str) -> dict:
    """Parse ``--distributed coordinator=H:P,num_processes=N,process_id=K``.

    Any key may be omitted and falls back to JAX's own environment-based
    auto-detection inside ``jax.distributed.initialize``.
    """
    out: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"{part!r} isn't a valid --distributed entry "
                "(want coordinator=HOST:PORT,num_processes=N,process_id=K)"
            )
        key, val = part.split("=", 1)
        key = key.strip()
        if key == "coordinator":
            out["coordinator_address"] = val.strip()
        elif key in ("num_processes", "process_id"):
            try:
                out[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"--distributed {key} must be an integer"
                ) from None
        else:
            raise ValueError(f"unknown --distributed key {key!r}")
    return out


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Join the multi-host JAX runtime (no-op when single-process).

    Must run before the first JAX backend touch.  On CPU platforms the
    gloo TCP collectives are selected so multi-process CPU runs work —
    this is how the multi-host topology is tested without a pod
    (SURVEY §4c).
    """
    if num_processes is None or num_processes <= 1:
        return
    try:
        plat = jax.config.jax_platforms
    except AttributeError:  # pragma: no cover
        plat = None
    if plat and str(plat).split(",")[0] == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


@dataclass
class HostShard:
    """This host's slice of a (C channels × B blocks) capture."""

    channel_lo: int
    channel_hi: int
    block_lo: int
    block_hi: int

    def byte_range(self, block_bytes: int) -> tuple[int, int]:
        return self.block_lo * block_bytes, self.block_hi * block_bytes


def host_slice(
    n_channels: int,
    n_blocks: int,
    *,
    process_index: int | None = None,
    process_count: int | None = None,
    channel_parallel_hosts: int | None = None,
) -> HostShard:
    """Partition (channels × blocks) across hosts, channel-major.

    With H hosts and ``channel_parallel_hosts = Hc`` (default: as many as
    divide the channel count), hosts form an (Hc × Ht) grid: channels split
    over Hc (zero communication), time blocks over Ht = H/Hc (history read
    straight from the shared capture — still zero communication).
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    hc = channel_parallel_hosts
    if hc is None:
        hc = 1
        for cand in range(min(pc, n_channels), 0, -1):
            if pc % cand == 0 and n_channels % cand == 0:
                hc = cand
                break
    if pc % hc:
        raise ValueError(f"channel_parallel_hosts={hc} must divide host count {pc}")
    ht = pc // hc
    ci, ti = pi % hc, pi // hc
    cs = n_channels // hc
    bs = n_blocks // ht
    return HostShard(
        channel_lo=ci * cs,
        channel_hi=(ci + 1) * cs if ci < hc - 1 else n_channels,
        block_lo=ti * bs,
        block_hi=(ti + 1) * bs if ti < ht - 1 else n_blocks,
    )
