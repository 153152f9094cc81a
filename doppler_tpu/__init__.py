"""doppler_tpu — a satellite Doppler-correction framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``cubehub/doppler`` reference (Rust + C), extended with the polyphase
resampling its ecosystem delegated to liquid-dsp, and scaled over a mesh of
GPU cards.

Design stance (see SURVEY.md §7): the reference is a sequential per-sample CPU
stream filter; this framework is a *block-parallel array program*.  The host
does O(blocks) scalar work — CLI, TLE/SGP4 propagation, Doppler scheduling,
stream I/O, telemetry — while the device does all O(samples) work as jitted
XLA programs over time-blocked IQ, sharded ``('channel', 'time')`` over a
``jax.sharding.Mesh`` of cards.

Subpackages
-----------
- ``doppler_tpu.ops``      — device compute: IQ codecs, NCO mixer, polyphase
                             resampler (single-stage and cascade),
                             fixed-point phase arithmetic.
- ``doppler_tpu.orbit``    — host orbital mechanics: TLE parsing, SGP4/SDP4
                             propagation, observer geometry, Doppler schedules.
- ``doppler_tpu.parallel`` — meshes, shardings, halo-exchange collectives.
- ``doppler_tpu.runtime``  — stream framing, pipelines, checkpointing,
                             telemetry, native (C++) accelerations.
- ``doppler_tpu.oracle``   — bit-faithful NumPy model of the reference binary
                             (the golden model the tests compare against).
- ``doppler_tpu.cli``      — ``doppler`` compatible command line (const/track).
"""

__version__ = "0.1.0"

from doppler_tpu import ops  # noqa: F401
