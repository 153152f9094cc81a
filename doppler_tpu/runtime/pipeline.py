"""The end-to-end streaming pipeline: bytes in → device chunk kernel → bytes out.

Host/device split (SURVEY §7 design stance): the host does O(blocks) work —
framing, schedule evaluation, staging, telemetry — while the device runs one
jit-compiled fused kernel per *chunk* (= ``chunk_blocks`` reference blocks)
covering decode → NCO mix → (optional resample) → encode.

Chunks have a fixed device shape ``(B, L)`` (B = chunk_blocks, L = samples
per reference block), so there is exactly one compilation per direction; the
stream tail is zero-padded to the chunk shape and the valid sample count is
sliced off on the host (padding is harmless: the mixer is elementwise and the
pad never reaches the output bytes).

Doppler schedules are evaluated per reference-sized block (8192 bytes,
main.rs:49) regardless of chunk size, so track-mode output is invariant to
the chunk width — the staircase semantics live entirely in the scheduler.
"""

from __future__ import annotations

import functools
from typing import Protocol, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from doppler_tpu.ops import codec, nco
from doppler_tpu.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu.runtime import stream as streaming
from doppler_tpu.runtime.telemetry import Counters

__all__ = ["Scheduler", "ConstScheduler", "Pipeline"]


class Scheduler(Protocol):
    """Produces the per-block frequency shift (Hz) for successive blocks.

    ``shifts(block_counts)`` is called once per chunk with the sample count of
    each block about to be processed, in order, and must return one shift per
    block.  Implementations may be stateful (the reference's track loop is —
    its Doppler staircase depends on cumulative sample counts, main.rs:156-183);
    the pipeline guarantees blocks are presented exactly once, in stream order.
    """

    def shifts(self, block_counts: Sequence[int]) -> Sequence[float]: ...


class ConstScheduler:
    """const mode: one fixed shift for the whole stream (main.rs:101-119)."""

    def __init__(self, shift_hz: float):
        self.shift_hz = float(shift_hz)

    def shifts(self, block_counts: Sequence[int]) -> Sequence[float]:
        return [self.shift_hz] * len(block_counts)


@functools.partial(jax.jit, static_argnames=("intype", "outtype"))
def _chunk_kernel(data, d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t,
                  *, intype: str, outtype: str):
    """Fused per-chunk device function over a (B, L) block grid."""
    if intype == "i16":
        i, q = codec.i16_words_to_iq(data)
    else:
        i, q = data[..., 0], data[..., 1]
    i, q = nco.mix_blocks(i, q, d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t)
    if outtype == "i16":
        return codec.iq_to_i16_words(i, q)
    return jnp.stack([i, q], axis=-1)


@functools.partial(jax.jit, static_argnames=("outtype",))
def _encode_kernel(i, q, *, outtype: str):
    if outtype == "i16":
        return codec.iq_to_i16_words(i, q)
    return jnp.stack([i, q], axis=-1)


class Pipeline:
    """Streaming Doppler corrector.

    Parameters mirror the reference CLI surface (SURVEY §5 config): sample
    rate, input/output IQ dtypes, and a :class:`Scheduler` supplying per-block
    shifts.  ``block_bytes`` defaults to the reference's 8192 so track-mode
    schedules match the reference bit-for-bit; ``chunk_blocks`` controls how
    many such blocks form one device dispatch.
    """

    def __init__(
        self,
        samplerate: int,
        intype: str,
        outtype: str,
        scheduler: Scheduler,
        *,
        block_bytes: int = streaming.REFERENCE_BLOCK_BYTES,
        chunk_blocks: int = 256,
        quantize_ratio_f32: bool = True,
        reset_quirk: bool = True,
        flush_every_chunk: bool = True,
        drain_on_eof: bool = False,
        prefetch_chunks: int = 0,
        mesh=None,
    ):
        if samplerate <= 0:
            raise ValueError("samplerate must be positive")
        self.samplerate = int(samplerate)
        self.intype = intype
        self.outtype = outtype
        self.scheduler = scheduler
        self.block_bytes = int(block_bytes)
        self.chunk_blocks = int(chunk_blocks)
        self.quantize_ratio_f32 = quantize_ratio_f32
        self.reset_quirk = reset_quirk
        self.flush_every_chunk = flush_every_chunk
        self.drain_on_eof = drain_on_eof  # flush the FIR tail with zeros at EOF
        self._drained = False  # did THIS run reach EOF and flush the tail?
        self.prefetch_chunks = int(prefetch_chunks)  # staged-read queue depth
        self.nco_state = NCOState()   # the stream's entire resumable DSP state

        self._bps_in = streaming.bytes_per_sample(intype)
        self._bps_out = streaming.bytes_per_sample(outtype)
        if self.block_bytes % self._bps_in != 0:
            raise ValueError(
                f"block_bytes={block_bytes} not a multiple of the "
                f"{intype} sample size {self._bps_in}"
            )
        self.block_samples = self.block_bytes // self._bps_in
        self._sample_offset = 0  # absolute index of next input sample
        self.resampler = None

        # --mesh: shard the chunk over a (channel=1, time=T) device mesh.
        # The device program changes (shard_map + ppermute halos) but the
        # emitted bytes must not: sharded output is byte-identical to the
        # single-device run (tests/test_sharded_pipeline.py pins this).
        self.mesh = mesh
        self._sharded_mix_step = None
        self._sharded_rs_step = None
        if mesh is not None:
            if mesh.shape.get("channel", 1) != 1:
                raise ValueError(
                    "single-stream pipeline needs mesh channel=1 "
                    "(use channels mode for channel parallelism)"
                )
            n_time = mesh.shape["time"]
            if self.chunk_blocks % n_time:
                raise ValueError(
                    f"chunk_blocks={self.chunk_blocks} must be divisible by "
                    f"mesh time={n_time}"
                )

    def set_resampler(self, resampler) -> None:
        """Insert a post-mix resampler stage (see ops.resample).

        Under a time-sharded mesh only the single-stage resampler has a
        sharded step (the ppermute halo of :mod:`doppler_tpu.parallel.sharded`);
        a multi-stage cascade is refused rather than run on one device.
        """
        if self.mesh is None:
            self.resampler = resampler
            return
        n_time = self.mesh.shape["time"]
        if getattr(resampler, "bank", None) is None:
            if n_time > 1:
                raise ValueError(
                    f"a multi-stage resampler cannot be time-sharded "
                    f"(--mesh time={n_time}); use --resample-stages single, "
                    f"or channels mode with --mesh channel=N only")
            self.resampler = resampler
            return
        n_loc = self.chunk_blocks * self.block_samples // n_time
        if resampler.T - 1 > n_loc:
            raise ValueError(
                f"resampler history ({resampler.T - 1} samples) exceeds one "
                f"time shard ({n_loc} samples); use fewer/larger chunks"
            )
        if n_loc * resampler.P >= (1 << 30):
            raise ValueError("time shard too large for 32-bit phase math")
        self.resampler = resampler

    # -- multi-host seek -----------------------------------------------------

    def seek_history_blocks(self) -> int:
        """Raw capture blocks :meth:`seek_to_block` needs as ``history``
        (read them from just before the seek point).  1 for single-stage
        resamplers; for cascades, enough blocks to cover the replay's
        zero-history corrupt head plus the FIR history itself (heavy rates —
        e.g. config 5's 100 Msps → 48 ksps — need several reference
        blocks)."""
        rs = self.resampler
        if rs is None or rs.T <= 1:
            return 0
        if getattr(rs, "bank", None) is not None:
            return 1
        return -(-(2 * (rs.T - 1)) // self.block_samples)

    def seek_to_block(self, n_blocks: int, history: bytes | None = None) -> None:
        """Fast-forward a FRESH pipeline to block ``n_blocks`` without
        processing the prefix — the multi-host "distribute = seek" primitive
        (parallel/distributed.py; SURVEY §5 checkpoint/resume).

        Replays the scheduler and the exact NCO-counter emulation over the
        skipped prefix (O(blocks) host work, zero device work, zero
        communication), seeds the resampler's stream counters from
        absolute-index arithmetic, and reconstructs its FIR history by
        mixing ``history`` — the raw bytes of the
        :meth:`seek_history_blocks` blocks ending at ``n_blocks``, read
        straight from the shared capture — through the same per-block
        kernels the stream path uses.  A host seeded this way emits
        exactly the bytes the single-process run emits from that offset
        (tests/test_distributed.py pins this bitwise).
        """
        if n_blocks < 0:
            raise ValueError("n_blocks must be >= 0")
        if self._sample_offset:
            raise ValueError("seek_to_block needs a fresh pipeline")
        L = self.block_samples
        k_h = 0 if history is None else len(history) // self.block_bytes
        # rolling per-block plan tail for the history replay (each history
        # block needs its OWN plan constants)
        tail_fields = None
        done = 0
        while done < n_blocks:
            n = min(self.chunk_blocks, n_blocks - done)
            counts = [L] * n
            shifts = list(self.scheduler.shifts(counts))
            plan = plan_blocks(
                shifts, counts, self.samplerate, self.nco_state, L,
                quantize_f32=self.quantize_ratio_f32,
                reset_quirk=self.reset_quirk,
            )
            if k_h:
                fields = np.stack([
                    np.asarray(getattr(plan, f)) for f in
                    ("d_hi", "d_lo", "c1_hi", "c1_lo", "c2_hi", "c2_lo", "t")
                ])
                tail_fields = (
                    fields if tail_fields is None
                    else np.concatenate([tail_fields, fields], axis=1)
                )[:, -k_h:]
            done += n
        self._sample_offset = n_blocks * L
        rs = self.resampler
        if rs is None:
            return
        if getattr(rs, "bank", None) is None:
            self._seek_cascade(n_blocks, history, tail_fields)
            return
        s_lo = n_blocks * L
        rs.in_consumed = s_lo
        rs.m_next = -(-s_lo * rs.P // rs.Q)
        if rs.T <= 1 or n_blocks == 0:
            return
        if history is None or len(history) < self.block_bytes:
            raise ValueError(
                "seek with a resampler needs the raw bytes of the "
                "preceding full block as history"
            )
        # the single-stage path needs exactly one block — keep the last;
        # mix it with the stream's own kernel (bitwise chunk-width-stable,
        # pinned by the chunked-vs-streaming equality tests)
        mi, mq = self._mix_history(history[-self.block_bytes:],
                                   tail_fields[:, -1:])
        h = rs.T - 1
        rs._hist_i = mi[L - h:]
        rs._hist_q = mq[L - h:]

    def _mix_history(self, history: bytes, fields):
        """Mix ``k`` raw history blocks with their plan constants ``fields``
        (7, k) through the stream's mix kernel → planar f32 (i, q)."""
        k, L = fields.shape[1], self.block_samples
        if self.intype == "i16":
            staged = np.asarray(
                codec.bytes_to_i16_words(history)).reshape(k, L)
        else:
            staged = codec.bytes_to_f32_pairs(history).reshape(k, L, 2)
        out = _chunk_kernel(
            jnp.asarray(staged), *(jnp.asarray(a) for a in fields),
            intype=self.intype, outtype="f32",
        )
        flat_out = out.reshape(-1, 2)
        return flat_out[:, 0], flat_out[:, 1]

    def _seek_cascade(self, n_blocks: int, history: bytes | None,
                      tail_fields) -> None:
        """Cascade arm of :meth:`seek_to_block`: reconstruct every stage's
        FIR history from the raw history blocks (``tail_fields`` carries
        their per-block plan constants, (7, k_h)).

        The replay starts each stage with zero history, so its first
        ``rs.T − 1`` input-referred samples are corrupted; each stage's
        history is its last ``T − 1`` inputs, so ``2·(rs.T − 1)`` replayed
        samples suffice (checked).  The replay runs the cascade's own
        ``process`` — bitwise by its chunk-width stability — so a seeked
        host emits exactly the single-process bytes
        (tests/test_distributed.py).
        """
        rs = self.resampler
        L = self.block_samples
        n_in = n_blocks * L
        counters = []
        for st in rs.stages:
            n_out = -(-n_in * st.P // st.Q)
            counters.append((n_in, n_out))
            n_in = n_out
        if rs.T > 1 and n_blocks > 0:
            if (history is None or len(history) < self.block_bytes
                    or len(history) % self.block_bytes):
                raise ValueError(
                    "seek with a resampler needs whole raw capture blocks "
                    "as history (see seek_history_blocks)"
                )
            k_h = min(len(history) // self.block_bytes, tail_fields.shape[1])
            if k_h * L < 2 * (rs.T - 1):
                raise ValueError(
                    f"history ({k_h} blocks = {k_h * L} samples) too short "
                    f"to reconstruct the cascade's state (needs ≥ "
                    f"{2 * (rs.T - 1)}; see seek_history_blocks)"
                )
            mi, mq = self._mix_history(history[-k_h * self.block_bytes:],
                                       tail_fields[:, -k_h:])
            rs.process(mi, mq, k_h * L)
        for st, (c_in, c_out) in zip(rs.stages, counters):
            st.in_consumed = c_in
            st.m_next = c_out

    # -- staging ------------------------------------------------------------

    def _stage_in(self, data: bytes):
        """Raw chunk bytes → fixed-shape device-ready array: i16 → packed
        int32 words ``(B, L)``; f32 → interleaved ``(B, L, 2)``."""
        B, L = self.chunk_blocks, self.block_samples
        if self.intype == "i16":
            flat = np.zeros(B * L, dtype="<i4")
            words = codec.bytes_to_i16_words(data)
            flat[: words.size] = words
            return flat.reshape(B, L)
        pairs = codec.bytes_to_f32_pairs(data)
        flat = np.zeros((B * L, 2), dtype="<f4")
        flat[: pairs.shape[0]] = pairs
        return flat.reshape(B, L, 2)

    def _stage_out(self, out, total_samples: int) -> bytes:
        if self.outtype == "i16":
            flat = np.asarray(out).reshape(-1)
            return codec.i16_words_to_bytes(flat[:total_samples])
        flat = np.asarray(out).reshape(-1, 2)
        return codec.f32_pairs_to_bytes(flat[:total_samples])

    # -- main loop ----------------------------------------------------------

    def process_chunk(self, chunk: streaming.Chunk) -> bytes:
        """Process one chunk of blocks synchronously; returns output bytes."""
        return self._finalize(self._dispatch(chunk))

    def _finalize(self, pending) -> bytes:
        """Materialize a dispatched chunk's bytes (blocks on the device)."""
        if pending is None:
            return b""
        if isinstance(pending[0], str) and pending[0] == "sharded_rs":
            # (tag, (1, n_time, M_max[, 2]) device array, per-shard counts)
            _, out, out_counts = pending
            arr = np.asarray(out)
            if self.outtype == "i16":
                parts = [arr[0, k, :c] for k, c in enumerate(out_counts)]
                return codec.i16_words_to_bytes(np.concatenate(parts))
            parts = [arr[0, k, :c, :] for k, c in enumerate(out_counts)]
            return codec.f32_pairs_to_bytes(np.concatenate(parts))
        out, n_valid = pending
        return self._stage_out(out, n_valid)

    def _dispatch(self, chunk: streaming.Chunk):
        """Plan + launch one chunk on the device WITHOUT waiting for it.

        Returns an opaque pending handle for :meth:`_finalize`.  All host
        state (scheduler, NCO counter, resampler bookkeeping) advances here,
        so the next chunk can be dispatched while this one computes —
        one-chunk-deep software pipelining of host staging vs device work.
        """
        counts = [size // self._bps_in for size in chunk.block_sizes]
        total = sum(counts)
        if total == 0:
            # still advance the scheduler for empty tail blocks
            if counts:
                self.scheduler.shifts(counts)
            return None
        shifts = list(self.scheduler.shifts(counts))
        assert len(shifts) == len(counts)

        B = self.chunk_blocks
        plan = plan_blocks(
            shifts, counts, self.samplerate, self.nco_state, self.block_samples,
            quantize_f32=self.quantize_ratio_f32, reset_quirk=self.reset_quirk,
        )
        pad = B - len(counts)
        arrs = [plan.d_hi, plan.d_lo, plan.c1_hi, plan.c1_lo,
                plan.c2_hi, plan.c2_lo, plan.t]
        if pad:
            arrs = [np.pad(a, (0, pad)) for a in arrs]

        if self.mesh is not None:
            return self._dispatch_sharded(chunk, arrs, total)
        return self._dispatch_local(chunk, arrs, total)

    def _dispatch_local(self, chunk: streaming.Chunk, arrs, total: int):
        """Single-device chunk dispatch — also the mesh pipeline's path for
        partial EOF chunks, so those run the EXACT program the unsharded
        pipeline runs, keeping mesh output byte-identical."""
        mix_outtype = self.outtype if self.resampler is None else "f32"
        out = _chunk_kernel(
            jnp.asarray(self._stage_in(chunk.data)),
            *(jnp.asarray(a) for a in arrs),
            intype=self.intype,
            outtype=mix_outtype,
        )
        self._sample_offset += total
        if self.resampler is None:
            return (out, total)

        flat = out.reshape(-1, 2)
        yi, yq, n_out = self.resampler.process(
            flat[:, 0], flat[:, 1], total,
            M=self.resampler.max_out_for(self.chunk_blocks
                                         * self.block_samples),
        )
        return (_encode_kernel(yi, yq, outtype=self.outtype), n_out)

    def _dispatch_sharded(self, chunk: streaming.Chunk, arrs, total: int):
        """--mesh chunk dispatch: shard_map steps over the (1, time) mesh.

        Full chunks with a single-stage resampler run the sharded stream
        step (mix + ppermute halo + resample per shard); mix-only streams
        run the sharded mix step for every chunk.  The partial EOF chunk —
        and a cascade on a one-device mesh — take the single-device path,
        seeded with the mesh-maintained history, so the emitted bytes stay
        identical to an unsharded run.
        """
        from jax.sharding import NamedSharding, PartitionSpec as Spec

        from doppler_tpu.parallel.sharded import (
            make_wideband_mix_step,
            make_wideband_stream_step,
            stream_step_alignment,
        )

        B, L = self.chunk_blocks, self.block_samples
        rs = self.resampler
        n_time = self.mesh.shape["time"]
        single_stage = rs is not None and getattr(rs, "bank", None) is not None
        if rs is not None and not (single_stage and total == B * L):
            return self._dispatch_local(chunk, arrs, total)

        data_spec = (Spec("time", None) if self.intype == "i16"
                     else Spec("time", None, None))
        data = jax.device_put(
            jnp.asarray(self._stage_in(chunk.data)),
            NamedSharding(self.mesh, data_spec)
        )
        plan_sh = NamedSharding(self.mesh, Spec("channel", "time"))
        plans = [jax.device_put(jnp.asarray(a)[None], plan_sh) for a in arrs]

        if rs is None:
            if self._sharded_mix_step is None:
                self._sharded_mix_step = make_wideband_mix_step(
                    self.mesh, intype=self.intype, outtype=self.outtype, C=1
                )
            out = self._sharded_mix_step(data, *plans)
            self._sample_offset += total
            return (out, total)

        if self._sharded_rs_step is None:
            self._sharded_rs_step = make_wideband_stream_step(
                self.mesh, intype=self.intype, outtype=self.outtype,
                C=1, resampler=rs,
            )
        rem, off, out_counts = stream_step_alignment(
            rs, rs.in_consumed, B * L // n_time, n_time
        )
        hist_sh = NamedSharding(self.mesh, Spec("channel", None))
        hist_i = jax.device_put(jnp.asarray(rs._hist_i).reshape(1, -1), hist_sh)
        hist_q = jax.device_put(jnp.asarray(rs._hist_q).reshape(1, -1), hist_sh)
        out, tail_i, tail_q = self._sharded_rs_step(
            data, *plans, hist_i, hist_q, jnp.asarray(rem), jnp.asarray(off),
        )
        rs.m_next += sum(out_counts)
        rs.in_consumed += total
        rs._hist_i = tail_i[0, -1]
        rs._hist_q = tail_q[0, -1]
        self._sample_offset += total
        return ("sharded_rs", out, out_counts)

    def run(self, fin, fout, should_stop=None) -> Counters:
        """Pump ``fin`` → ``fout`` until EOF (short read), reference framing.

        ``should_stop``: optional callable polled between chunks — a graceful
        stop leaves the pipeline state consistent with the bytes written, so
        a checkpoint taken afterwards resumes exactly (no torn chunks).
        """
        reader = streaming.BlockReader(fin, self.block_bytes)
        if self.prefetch_chunks > 0:
            reader = streaming.ChunkPrefetcher(
                reader, self.chunk_blocks, depth=self.prefetch_chunks
            )
        counters = Counters()

        def emit(pending, bytes_in, blocks):
            out_bytes = self._finalize(pending)
            if out_bytes:
                fout.write(out_bytes)
                if self.flush_every_chunk:
                    fout.flush()
            counters.add(
                samples=len(out_bytes) // self._bps_out,
                bytes_in=bytes_in,
                bytes_out=len(out_bytes),
                blocks=blocks,
            )

        # one-chunk-deep pipelining: dispatch chunk k+1 while k materializes
        pending = None
        pending_meta = (0, 0)
        hit_eof = False
        while True:
            if should_stop is not None and should_stop():
                break
            chunk = reader.read_chunk(self.chunk_blocks)
            new_pending = self._dispatch(chunk)
            if pending is not None or pending_meta[1]:
                emit(pending, *pending_meta)
            pending = new_pending
            pending_meta = (len(chunk.data), chunk.n_blocks)
            if chunk.eof:
                hit_eof = True
                break
        emit(pending, *pending_meta)
        # drain ONLY on a true EOF exit: a should_stop (signal) break is a
        # mid-stream pause — flushing the FIR tail there would corrupt the
        # output and poison the checkpoint (round-5 review find)
        if hit_eof and self.resampler is not None and self.drain_on_eof:
            out_bytes = self._drain()
            self._drained = True   # checkpointed: a resumed run must not
            if out_bytes:          # append the FIR tail a second time
                fout.write(out_bytes)
                counters.add(
                    samples=len(out_bytes) // self._bps_out,
                    bytes_in=0, bytes_out=len(out_bytes), blocks=0,
                )
        fout.flush()
        return counters

    def _drain(self) -> bytes:
        """Flush the resampler's FIR tail by feeding T−1 zero samples —
        emits the outputs whose windows straddle the end of the stream
        (the reference ecosystem's liquid-dsp flush semantics)."""
        rs = self.resampler
        pad = rs.T - 1
        if pad <= 0:
            return b""
        zeros = np.zeros(pad, dtype=np.float32)
        yi, yq, n_out = rs.process(zeros, zeros, pad, M=rs.max_out_for(pad))
        if n_out == 0:
            return b""
        enc = _encode_kernel(yi, yq, outtype=self.outtype)
        return self._stage_out(enc, n_out)
