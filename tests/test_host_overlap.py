"""Host-planning / device-compute overlap.

End to end on the card the pipeline is host-bound (PERF.md: the config-3
and config-5 traces leave the device 93-99% idle), so its rate rests on the
run loops hiding per-chunk host planning behind the device's execution of
the PREVIOUS chunk (1-deep software pipelining).  These tests make that
claim load-bearing: a fake device whose "compute" completes at a
wall-clock deadline is driven through the real run loops, and total wall
must track max(device, planner) per chunk — not their sum.
"""

import io
import time

import numpy as np

from doppler_tpu.runtime.channels import (
    ChannelSpec,
    ConstScheduler,
    MultiChannelPipeline,
)
from doppler_tpu.runtime.pipeline import Pipeline
from doppler_tpu.runtime.pipeline import ConstScheduler as StreamConst


def test_stream_pipeline_overlaps_planning_with_device():
    """Structural: Pipeline.run dispatches chunk k+1 (host planning)
    before finalizing chunk k (device wait), so wall ≈ N·max(T_dev,
    T_plan) + one unhidden plan — not N·(T_dev + T_plan)."""
    fs, bb, cb = 256000, 8192, 16
    # warm the jitted kernels first (the ~0.3 s first-dispatch compile
    # would otherwise swamp the timing budget), then time a fresh pipeline
    warm = Pipeline(fs, "i16", "i16", StreamConst(-5000.0),
                    block_bytes=bb, chunk_blocks=cb)
    warm.run(io.BytesIO(b"\x01\x02" * (2 * (bb // 4) * cb)), io.BytesIO())

    pipe = Pipeline(fs, "i16", "i16", StreamConst(-5000.0),
                    block_bytes=bb, chunk_blocks=cb)
    T_PLAN, T_DEV, N = 0.08, 0.22, 5

    orig_dispatch = pipe._dispatch
    orig_finalize = pipe._finalize
    # a real device executes chunks one after another: each fake chunk's
    # completion deadline chains off the previous one's
    dev = {"free_at": time.monotonic()}

    def slow_dispatch(chunk):
        if not chunk.data:               # trailing EOF chunk: free
            return (orig_dispatch(chunk), time.monotonic())
        time.sleep(T_PLAN)               # pretend planning costs T_PLAN
        pending = orig_dispatch(chunk)
        dev["free_at"] = max(dev["free_at"], time.monotonic()) + T_DEV
        return (pending, dev["free_at"])

    def waiting_finalize(p):
        pending, deadline = p
        rem = deadline - time.monotonic()
        if rem > 0:                      # fake device still "computing"
            time.sleep(rem)
        return orig_finalize(pending)

    pipe._dispatch = slow_dispatch
    pipe._finalize = waiting_finalize

    data = b"\x01\x02" * (2 * (bb // 4) * cb * N)   # N full chunks
    out = io.BytesIO()
    t0 = time.monotonic()
    pipe.run(io.BytesIO(data), out)
    wall = time.monotonic() - t0

    serial = N * (T_PLAN + T_DEV)
    # at least N−2 of the N plans must have been hidden behind device time
    assert wall < serial - (N - 2) * T_PLAN, (wall, serial)
    # and the fake device latencies themselves are irreducible
    assert wall >= N * T_DEV - 0.02, (wall, N * T_DEV)
    assert len(out.getvalue()) == len(data)


def test_channels_overlap_at_config5_planning_scale():
    """The REAL config-5 host planner (C=256 × B=2048 — measured 28-160 ms
    per chunk depending on host) must be hidden behind a fake device's
    chunk latency by MultiChannelPipeline.run's 1-deep pipeline."""
    C, B, bb = 256, 2048, 8192
    specs = [ChannelSpec(name=f"c{i}", scheduler=ConstScheduler(1000.0 + i))
             for i in range(C)]
    mp = MultiChannelPipeline(100_000_000, "i16", "i16", specs,
                              block_bytes=bb, chunk_blocks=B)
    counts = [bb // 4] * B

    # real planner cost on THIS host (min of 3 — the hidden quantity)
    t_plan = min(
        (lambda t0: (mp._plan_all(counts), time.perf_counter() - t0)[1])(
            time.perf_counter())
        for _ in range(3)
    )
    # reset planner-side state consumed by the warmup plans
    mp2 = MultiChannelPipeline(100_000_000, "i16", "i16",
                               [ChannelSpec(name=f"c{i}",
                                            scheduler=ConstScheduler(
                                                1000.0 + i))
                                for i in range(C)],
                               block_bytes=bb, chunk_blocks=B)

    T_DEV = max(0.35, 3.0 * t_plan)
    N = 4

    dev = {"free_at": time.monotonic()}   # serialize fake chunk execution

    def fake_dispatch(chunk):
        cts = [s // mp2._bps_in for s in chunk.block_sizes]
        if not sum(cts):                 # trailing EOF chunk: free
            return lambda: [b""] * C
        mp2._plan_all(cts)               # the REAL config-5 planning
        dev["free_at"] = max(dev["free_at"], time.monotonic()) + T_DEV
        deadline = dev["free_at"]

        def fin():
            rem = deadline - time.monotonic()
            if rem > 0:
                time.sleep(rem)
            return [b""] * C

        return fin

    mp2._dispatch_chunk = fake_dispatch

    data = b"\x00" * (bb * B * N)
    writers = [io.BytesIO() for _ in range(C)]
    t0 = time.monotonic()
    mp2.run(io.BytesIO(data), writers)
    wall = time.monotonic() - t0

    serial_min = N * (T_DEV + t_plan)
    # the run must hide at least one full plan behind device time (with
    # 4 chunks, 3 of the 4 plans are overlapped in the ideal schedule)
    assert wall < serial_min - 1.0 * t_plan, (wall, serial_min, t_plan)
    assert wall >= N * T_DEV - 0.02, (wall, N * T_DEV)
