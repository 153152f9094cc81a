"""Multi-channel pipeline: N satellites from one wideband capture.

BASELINE configs 4-5: a single wideband IQ stream carries many satellite
downlinks; each channel c gets its own correction chain

    mix by (center_offset_c + doppler_c(t) + offset_c)  →  resample  →  encode

run as ONE batched device computation over a ``(C, B, L)`` array — the
channel axis is embarrassingly parallel (SURVEY §2 "channel parallelism")
and is exactly the axis the ``parallel`` package shards over the cards of
a ``--mesh channel=N`` run.

Host-side per channel: an independent Doppler scheduler (const or TLE track)
and an independent samplenum-emulation state; the channel's center offset is
folded into the per-block shift before planning, which mirrors what running
C separate reference binaries with ``--offset (offset + center)`` would do.

Outputs go to per-channel files (stdout can't interleave C streams).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from doppler_tpu.ops import codec, nco
from doppler_tpu.ops.phase_plan import (
    NCOState,
    plan_blocks,
    plan_fields_uniform,
)
from doppler_tpu.ops.resample import RationalResampler
from doppler_tpu.runtime import stream as streaming
from doppler_tpu.runtime.pipeline import ConstScheduler, Scheduler
from doppler_tpu.runtime.telemetry import Counters

__all__ = ["ChannelSpec", "MultiChannelPipeline", "load_channel_config"]


@dataclass
class ChannelSpec:
    """One channel of a wideband capture.

    ``out_rate`` overrides the pipeline-wide ``--resample-to`` for this
    channel (None = use the pipeline default, which may itself be None =
    no resampling).
    """

    name: str
    scheduler: Scheduler
    center_offset_hz: float = 0.0
    out_rate: float | None = None
    state: NCOState = field(default_factory=NCOState)


@functools.partial(jax.jit, static_argnames=("intype", "outtype", "C"))
def _channels_mix_kernel(data, d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t,
                         *, intype: str, outtype: str, C: int):
    """Wideband chunk (B, L) × per-channel plans (C, B) → (C, …) streams."""
    if intype == "i16":
        i, q = codec.i16_words_to_iq(data)
    else:
        i, q = data[..., 0], data[..., 1]
    i = jnp.broadcast_to(i[None], (C,) + i.shape)
    q = jnp.broadcast_to(q[None], (C,) + q.shape)
    i, q = nco.mix_blocks(i, q, d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t)
    if outtype == "i16":
        return codec.iq_to_i16_words(i, q)
    return jnp.stack([i, q], axis=-1)


@functools.partial(jax.jit, static_argnames=("outtype",))
def _encode_kernel(i, q, *, outtype: str):
    if outtype == "i16":
        return codec.iq_to_i16_words(i, q)
    return jnp.stack([i, q], axis=-1)


class MultiChannelPipeline:
    """Batched multi-satellite corrector over one input stream."""

    def __init__(
        self,
        samplerate: int,
        intype: str,
        outtype: str,
        channels: list[ChannelSpec],
        *,
        out_rate: int | None = None,
        block_bytes: int = streaming.REFERENCE_BLOCK_BYTES,
        chunk_blocks: int = 64,
        quantize_ratio_f32: bool = True,
        reset_quirk: bool = True,
        mesh=None,
        drain_on_eof: bool = False,
        resample_stages: str = "single",
    ):
        if not channels:
            raise ValueError("need at least one channel")
        self.drain_on_eof = drain_on_eof
        self._drained = False  # did THIS run flush the FIR tails? (ckpt)
        self.samples_in = 0     # absolute input samples consumed (checkpoint)
        self.samplerate = int(samplerate)
        self.intype = intype
        self.outtype = outtype
        self.channels = channels
        self.block_bytes = int(block_bytes)
        self.chunk_blocks = int(chunk_blocks)
        self.quantize_ratio_f32 = quantize_ratio_f32
        self.reset_quirk = reset_quirk
        self._bps_in = streaming.bytes_per_sample(intype)
        self._bps_out = streaming.bytes_per_sample(outtype)
        self.block_samples = self.block_bytes // self._bps_in

        # group channels by effective output rate (per-channel out_rate
        # overrides the pipeline default); each group gets its own batched
        # resampler so different rates coexist in one wideband run
        rates: dict[float | None, list[int]] = {}
        for idx, ch in enumerate(channels):
            rate = ch.out_rate if ch.out_rate is not None else out_rate
            rates.setdefault(rate, []).append(idx)
        from doppler_tpu.ops.multistage import make_resampler

        self._groups: list[tuple[list[int], RationalResampler | None]] = [
            (idxs,
             make_resampler(samplerate, rate, stages=resample_stages,
                            channels=len(idxs))
             if rate is not None else None)
            for rate, idxs in rates.items()
        ]
        # single-rate fast path keeps the historical attribute surface
        self.resampler = (
            self._groups[0][1] if len(self._groups) == 1 else None
        )

        # --mesh: channels × time-blocks SPMD (BASELINE config 5 topology),
        # dispatched per rate GROUP.  Byte contract: the mix-only and
        # single-stage sharded steps match the unsharded run exactly; the
        # channel-sharded CASCADE step batches C_loc ≠ C channels across
        # the mix_tone contraction boundary (ops/sincos.py), so it is
        # pinned to ≤1 LSB with identical lengths
        # (tests/test_sharded_pipeline.py).  A layout no sharded step
        # covers is refused here rather than run on one device.
        self.mesh = mesh
        self._sharded_steps: dict = {}       # (kind, group) → jitted step
        if mesh is not None:
            C = len(channels)
            n_chan = mesh.shape.get("channel", 1)
            n_time = mesh.shape["time"]
            if C % n_chan:
                raise ValueError(
                    f"{C} channels must divide over mesh channel={n_chan}"
                )
            if self.chunk_blocks % n_time:
                raise ValueError(
                    f"chunk_blocks={self.chunk_blocks} must be divisible by "
                    f"mesh time={n_time}"
                )
            n_loc = self.chunk_blocks * self.block_samples // n_time
            for idxs, rs in self._groups:
                if len(idxs) % n_chan:
                    raise ValueError(
                        f"a rate group of {len(idxs)} channels must divide "
                        f"over mesh channel={n_chan}")
                if rs is None:
                    continue
                if getattr(rs, "bank", None) is None:
                    if n_time > 1:
                        raise ValueError(
                            f"a multi-stage resampler cannot be "
                            f"time-sharded (--mesh time={n_time}); use "
                            f"--resample-stages single, or --mesh "
                            f"channel=N only")
                    continue
                if rs.T - 1 > n_loc:
                    raise ValueError(
                        f"resampler history ({rs.T - 1}) exceeds one time "
                        f"shard ({n_loc} samples); use fewer/larger chunks"
                    )
                if n_loc * rs.P >= (1 << 30):
                    raise ValueError(
                        "time shard too large for 32-bit phase math"
                    )

    def _plan_all(self, counts):
        C = len(self.channels)
        B = self.chunk_blocks
        n = len(counts)
        # per-channel shifts for the chunk: f32(scheduler) + f32(center)
        # exactly as the single-stream path composes them (main.rs:177)
        shifts_all = [
            (np.asarray(ch.scheduler.shifts(counts), dtype=np.float64)
             .astype(np.float32) + np.float32(ch.center_offset_hz))
            .astype(np.float64)
            for ch in self.channels
        ]

        # uniform fast lane (config-5 scale): when every channel's shift is
        # constant within the chunk — the common case once chunks are shorter
        # than one staircase second — one (C, B) vectorized planning pass
        # replaces C Python planners (bit-identical; VERDICT r2 #6)
        if n and all(s.size and (s == s[0]).all() for s in shifts_all):
            f = plan_fields_uniform(
                [float(s[0]) for s in shifts_all], counts, self.samplerate,
                [ch.state for ch in self.channels], self.block_samples,
                quantize_f32=self.quantize_ratio_f32,
                reset_quirk=self.reset_quirk,
            )
            if f is not None:
                if n == B:
                    return np.ascontiguousarray(f)
                fields = np.zeros((7, C, B), dtype=np.uint32)
                fields[:, :, :n] = f
                return fields

        fields = np.zeros((7, C, B), dtype=np.uint32)
        for c, ch in enumerate(self.channels):
            plan = plan_blocks(
                shifts_all[c], counts, self.samplerate, ch.state,
                self.block_samples,
                quantize_f32=self.quantize_ratio_f32,
                reset_quirk=self.reset_quirk,
            )
            for fi, arr in enumerate(
                (plan.d_hi, plan.d_lo, plan.c1_hi, plan.c1_lo,
                 plan.c2_hi, plan.c2_lo, plan.t)
            ):
                fields[fi, c, : arr.size] = arr
        return fields

    def process_chunk(self, chunk: streaming.Chunk):
        """→ list of per-channel output byte strings (dispatch + finalize)."""
        return self.dispatch_chunk(chunk)()

    def dispatch_chunk(self, chunk: streaming.Chunk):
        """Host planning + async device dispatch → zero-arg finalizer.

        The finalizer materializes the device output (the only blocking
        sync) and converts it to per-channel byte strings.  ``run()``
        finalizes chunk k−1 AFTER dispatching chunk k, so the host's
        per-chunk planning (config-5 scale: ~28-45 ms for C=256×B=2048)
        overlaps the device's execution of the previous chunk — the
        1-deep software pipelining the single-stream Pipeline already has
        (VERDICT r4 next #6: pinned by
        tests/test_host_overlap.py).  All pipeline/resampler state is
        advanced at dispatch time (host integers + lazy device arrays),
        so finalizers are pure conversions and safe to defer one chunk.
        """
        res = self._dispatch_chunk(chunk)
        return res if callable(res) else (lambda: res)

    def _dispatch_chunk(self, chunk: streaming.Chunk):
        counts = [size // self._bps_in for size in chunk.block_sizes]
        total = sum(counts)
        C = len(self.channels)
        if total == 0:
            if counts:
                self._plan_all(counts)
            return [b""] * C
        fields = self._plan_all(counts)
        self.samples_in += total

        B, L = self.chunk_blocks, self.block_samples
        if self.intype == "i16":
            flat = np.zeros(B * L, dtype="<i4")
            words = codec.bytes_to_i16_words(chunk.data)
            flat[: words.size] = words
            staged = flat.reshape(B, L)
        else:
            flat = np.zeros((B * L, 2), dtype="<f4")
            pairs = codec.bytes_to_f32_pairs(chunk.data)
            flat[: pairs.shape[0]] = pairs
            staged = flat.reshape(B, L, 2)

        if self.mesh is not None:
            sharded = self._process_chunk_sharded(staged, fields, total)
            if sharded is not None:
                return sharded

        no_resampling = all(rs is None for _, rs in self._groups)
        mix_outtype = self.outtype if no_resampling else "f32"
        out = _channels_mix_kernel(
            jnp.asarray(staged),
            *(jnp.asarray(a) for a in fields),
            intype=self.intype, outtype=mix_outtype, C=C,
        )

        def to_bytes(row) -> bytes:
            if self.outtype == "i16":
                return codec.i16_words_to_bytes(row)
            return codec.f32_pairs_to_bytes(row)

        if no_resampling:
            def fin_mix(out=out):
                if self.outtype == "i16":
                    flat_out = np.asarray(out).reshape(C, -1)[:, :total]
                else:
                    flat_out = np.asarray(out).reshape(C, -1, 2)[:, :total]
                return [to_bytes(flat_out[c]) for c in range(C)]
            return fin_mix

        planar = out.reshape(C, -1, 2)
        deferred = []                 # (idxs, lazy device enc, n_out)
        for idxs, rs in self._groups:
            sel = jnp.asarray(idxs)
            sub_i = jnp.take(planar[..., 0], sel, axis=0)
            sub_q = jnp.take(planar[..., 1], sel, axis=0)
            if rs is None:
                enc = _encode_kernel(sub_i, sub_q, outtype=self.outtype)
                n_out = total
            else:
                yi, yq, n_out = rs.process(
                    sub_i, sub_q, total, M=rs.max_out_for(B * L)
                )
                enc = _encode_kernel(yi, yq, outtype=self.outtype)
            deferred.append((idxs, enc, n_out))

        def fin_groups():
            outs: list[bytes] = [b""] * C
            for idxs, enc, n_out in deferred:
                flat_out = np.asarray(enc)[:, :n_out]
                for row, cidx in enumerate(idxs):
                    outs[cidx] = to_bytes(flat_out[row])
            return outs
        return fin_groups

    def _process_chunk_sharded(self, staged, fields, total: int):
        """--mesh device step: channels × time shard_map over the wideband
        chunk, dispatched PER RATE GROUP.  Returns per-channel bytes, or
        None to fall through to the unsharded path for the partial EOF
        chunk of a resampled run, which runs single-device off the
        mesh-maintained history so bytes stay identical."""
        from jax.sharding import NamedSharding, PartitionSpec as Spec

        from doppler_tpu.parallel.sharded import (
            make_cascade_channels_step,
            make_wideband_mix_step,
            make_wideband_stream_step,
            stream_step_alignment,
        )

        C = len(self.channels)
        B, L = self.chunk_blocks, self.block_samples
        n_time = self.mesh.shape["time"]
        if total != B * L and any(rs is not None for _, rs in self._groups):
            return None                      # partial tail → exact fallback

        data_spec = (
            Spec("time", None) if self.intype == "i16"
            else Spec("time", None, None)
        )
        data = jax.device_put(
            jnp.asarray(staged), NamedSharding(self.mesh, data_spec)
        )
        plan_sh = NamedSharding(self.mesh, Spec("channel", "time"))
        hist_sh = NamedSharding(self.mesh, Spec("channel", None))

        def to_bytes(row) -> bytes:
            if self.outtype == "i16":
                return codec.i16_words_to_bytes(row)
            return codec.f32_pairs_to_bytes(row)

        def step_for(kind, g, make, **kw):
            step = self._sharded_steps.get((kind, g))
            if step is None:
                step = make(self.mesh, intype=self.intype,
                            outtype=self.outtype, C=len(self._groups[g][0]),
                            **kw)
                self._sharded_steps[(kind, g)] = step
            return step

        deferred = []                 # (idxs, closure → list[bytes] per row)
        for g, (idxs, rs) in enumerate(self._groups):
            C_g = len(idxs)
            fg = np.ascontiguousarray(fields[:, idxs, :])
            plans = [jax.device_put(jnp.asarray(a), plan_sh) for a in fg]
            if rs is None:
                out = step_for("mix", g, make_wideband_mix_step)(data, *plans)

                def fin_mix(out=out, C_g=C_g):
                    if self.outtype == "i16":
                        flat = np.asarray(out).reshape(C_g, -1)[:, :total]
                    else:
                        flat = np.asarray(out).reshape(C_g, -1, 2)[:, :total]
                    return [to_bytes(flat[row]) for row in range(C_g)]
                deferred.append((idxs, fin_mix))
            elif getattr(rs, "bank", None) is not None:
                step = step_for("rs", g, make_wideband_stream_step,
                                resampler=rs)
                rem, off, out_counts = stream_step_alignment(
                    rs, rs.in_consumed, B * L // n_time, n_time
                )
                hist_i = jax.device_put(jnp.asarray(rs._hist_i), hist_sh)
                hist_q = jax.device_put(jnp.asarray(rs._hist_q), hist_sh)
                out, tail_i, tail_q = step(
                    data, *plans, hist_i, hist_q,
                    jnp.asarray(rem), jnp.asarray(off)
                )
                rs.m_next += sum(out_counts)
                rs.in_consumed += total
                rs._hist_i = tail_i[:, -1]
                rs._hist_q = tail_q[:, -1]

                def fin_rs(out=out, out_counts=out_counts, C_g=C_g):
                    arr = np.asarray(out)     # (C_g, n_time, M_max[, 2])
                    parts = [arr[:, t, :c]
                             for t, c in enumerate(out_counts)]
                    flat = np.concatenate(parts, axis=1)
                    return [to_bytes(flat[row]) for row in range(C_g)]
                deferred.append((idxs, fin_rs))
            else:
                step = step_for("casc", g, make_cascade_channels_step,
                                resampler=rs)
                hists = [jax.device_put(jnp.asarray(h), hist_sh)
                         for st in rs.stages
                         for h in (st._hist_i, st._hist_q)]
                ops, n_out = rs.step_operands(total, B * L)
                out, *new_hists = step(data, *plans, *hists,
                                       *(jnp.asarray(o) for o in ops))
                for s, st in enumerate(rs.stages):
                    st._hist_i, st._hist_q = new_hists[2 * s:2 * s + 2]

                def fin_casc(out=out, n_out=n_out, C_g=C_g):
                    flat = np.asarray(out)[:, :n_out]
                    return [to_bytes(flat[row]) for row in range(C_g)]
                deferred.append((idxs, fin_casc))

        def finalize():
            outs: list[bytes] = [b""] * C
            for idxs, fin in deferred:
                vals = fin()
                for row, cidx in enumerate(idxs):
                    outs[cidx] = vals[row]
            return outs
        return finalize

    def drain(self) -> list[bytes]:
        """Flush every resampler group's FIR tail with T−1 zero samples —
        per-channel analog of Pipeline._drain (liquid-dsp flush semantics)."""
        C = len(self.channels)
        outs: list[bytes] = [b""] * C
        for idxs, rs in self._groups:
            if rs is None:
                continue
            pad = rs.T - 1
            if pad <= 0:
                continue
            zeros = np.zeros((len(idxs), pad), dtype=np.float32)
            yi, yq, n_out = rs.process(zeros, zeros, pad, M=rs.max_out_for(pad))
            if n_out == 0:
                continue
            enc = np.asarray(_encode_kernel(yi, yq, outtype=self.outtype))
            for row, cidx in enumerate(idxs):
                if self.outtype == "i16":
                    outs[cidx] = codec.i16_words_to_bytes(enc[row, :n_out])
                else:
                    outs[cidx] = codec.f32_pairs_to_bytes(enc[row, :n_out])
        return outs

    def run(self, fin, writers, should_stop=None) -> Counters:
        """Pump the stream; ``writers`` is one binary file object per channel.

        One-chunk-deep software pipelining (mirrors ``Pipeline.run``):
        chunk k+1 is planned and dispatched before chunk k's output is
        materialized, hiding the host's per-chunk planning (~28-45 ms at
        config-5's C=256×B=2048) behind the device's execution of the
        previous chunk.
        """
        assert len(writers) == len(self.channels)
        reader = streaming.BlockReader(fin, self.block_bytes)
        counters = Counters()

        def emit(fin_cb, bytes_in, blocks):
            outs = fin_cb()
            for w, ob in zip(writers, outs):
                if ob:
                    w.write(ob)
            counters.add(
                samples=bytes_in // self._bps_in,
                bytes_in=bytes_in,
                bytes_out=sum(len(ob) for ob in outs),
                blocks=blocks,
            )

        pending = None
        pending_meta = (0, 0)
        hit_eof = False
        while True:
            if should_stop is not None and should_stop():
                break
            chunk = reader.read_chunk(self.chunk_blocks)
            new_pending = self.dispatch_chunk(chunk)
            if pending is not None:
                emit(pending, *pending_meta)
            pending = new_pending
            pending_meta = (len(chunk.data), chunk.n_blocks)
            if chunk.eof:
                hit_eof = True
                break
        if pending is not None:
            emit(pending, *pending_meta)
        # drain only on a true EOF exit (see Pipeline.run — a signal stop
        # mid-stream must not flush the tails or set the drained flag)
        if hit_eof and self.drain_on_eof:
            for w, ob in zip(writers, self.drain()):
                if ob:
                    w.write(ob)
                    counters.add(samples=0, bytes_in=0,
                                 bytes_out=len(ob), blocks=0)
            self._drained = True   # checkpointed: a resumed run must not
            #                        append the FIR tails a second time
        for w in writers:
            w.flush()
        return counters


def load_channel_config(path: str, samplerate: int):
    """Build ChannelSpecs from a JSON config (see docs/channels.md).

    Shared keys may live at the top level (tlefile, location, time); each
    entry in ``channels`` is either const (``shift``) or track (``tlename`` +
    ``frequency`` [+ ``offset``]), plus optional ``center_offset``.
    """
    with open(path) as f:
        cfg = json.load(f)
    specs = []
    for ch in cfg["channels"]:
        center = float(ch.get("center_offset", 0.0))
        out_rate = ch.get("resample_to")
        if out_rate is not None:
            out_rate = float(out_rate)
        if "shift" in ch:
            sched = ConstScheduler(float(ch["shift"]))
        else:
            from doppler_tpu.cli import parse_location, parse_time_utc
            from doppler_tpu.orbit import make_track_scheduler

            lat, lon, alt = parse_location(ch.get("location", cfg["location"]))
            time_s = ch.get("time", cfg.get("time"))
            tlef = ch.get("tlefile", cfg.get("tlefile"))
            if tlef is None:
                # open(None) would raise a TypeError that escapes the CLI's
                # bad-config handling — fail like every other config error
                raise ValueError(
                    f"channel {ch.get('name')!r}: track entry needs "
                    "'tlefile' (at the channel or top level)")
            sched = make_track_scheduler(
                tlefile=tlef,
                tlename=ch["tlename"],
                lat=lat, lon=lon, alt=alt,
                frequency_hz=float(ch["frequency"]),
                offset_hz=float(ch.get("offset", 0.0)),
                samplerate=samplerate,
                start_time=parse_time_utc(time_s) if time_s else None,
            )
        specs.append(ChannelSpec(
            name=ch["name"], scheduler=sched, center_offset_hz=center,
            out_rate=out_rate,
        ))
    return specs, cfg
