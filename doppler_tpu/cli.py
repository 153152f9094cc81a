"""``doppler``-compatible command line: const and track subcommands.

Mirrors the reference's full flag surface (SURVEY §5 "config/flag system";
reference ``src/usage.rs:117-224``):

- ``const``: ``-s/--samplerate``, ``-i/--intype {i16,f32}``,
  ``-o/--outtype`` (defaults to intype, usage.rs:268-270), ``--shift Hz``.
- ``track``: the same I/O flags plus ``--tlefile``, ``--tlename``,
  ``--location lat=..,lon=..,alt=..`` (usage.rs:85-115), ``--time UTC``
  (``%Y-%m-%dT%H:%M:%S``, usage.rs:303-313), ``--frequency Hz``,
  ``--offset Hz``.

Negative values work positionally (``--shift -15000``) — argparse handles
the ``=``-less form for long options, matching clap's AllowLeadingHyphen use.

Framework extensions (all optional, default to reference-compatible
behavior): ``--chunk-blocks``, ``--block-bytes``, ``--resample-to RATE``,
``--platform``, ``--log-level``, ``--exact-ratio``.

IQ bytes flow stdin → stdout; telemetry goes to stderr only (main.rs:212-233).
"""

from __future__ import annotations

import argparse
import calendar
import sys
import time as _time

__all__ = ["main", "build_parser", "parse_location"]


def stream_bps(dtype: str) -> int:
    from doppler_tpu.runtime.stream import bytes_per_sample

    return bytes_per_sample(dtype)


def parse_location(text: str):
    """``lat=58.64560,lon=23.15163,alt=8`` → (lat, lon, alt) floats.

    Mirrors usage.rs:85-115: keys may appear in any order; every key must
    parse as a float; otherwise a usage error.
    """
    if not ("lat" in text and "lon" in text and "alt" in text):
        raise ValueError(
            "--location should be defined as: lat=58.64560,lon=23.15163,alt=8"
        )
    vals: dict[str, float] = {}
    for part in text.split(","):
        if "=" not in part:
            continue
        key, _, raw = part.partition("=")
        key = key.strip()
        if key in ("lat", "lon", "alt"):
            try:
                vals[key] = float(raw)
            except ValueError:
                pass
    if set(vals) != {"lat", "lon", "alt"}:
        raise ValueError(
            f"{text!r} isn't a valid value for --location "
            "[use as: lat=58.64560,lon=23.15163,alt=8]"
        )
    return vals["lat"], vals["lon"], vals["alt"]


def parse_mesh(text: str) -> tuple[int, int]:
    """``time=2,channel=4`` → (time, channel); either key may be omitted."""
    vals = {"time": 1, "channel": 1}
    for part in text.split(","):
        key, _, raw = part.partition("=")
        key = key.strip()
        if key not in vals:
            raise ValueError(
                f"{text!r} isn't a valid value for --mesh "
                "[use as: time=2,channel=4]"
            )
        try:
            vals[key] = int(raw)
        except ValueError:
            raise ValueError(f"--mesh {key} must be an integer") from None
    if vals["time"] < 1 or vals["channel"] < 1:
        raise ValueError("--mesh axes must be >= 1")
    return vals["time"], vals["channel"]


def parse_time_utc(text: str) -> float:
    """``%Y-%m-%dT%H:%M:%S`` UTC → unix seconds (usage.rs:303-313)."""
    try:
        st = _time.strptime(text, "%Y-%m-%dT%H:%M:%S")
    except ValueError as e:
        raise ValueError(
            f"{e}. --time should be defined in Y-m-dTH:M:S format: "
            "eg. 2015-05-13T14:28:48"
        ) from None
    return float(calendar.timegm(st))


def _add_io_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-s", "--samplerate", type=int, required=True,
                   help="IQ data samplerate")
    p.add_argument("-i", "--intype", choices=["i16", "f32"], required=True,
                   help="IQ data input type")
    p.add_argument("-o", "--outtype", choices=["i16", "f32"],
                   help="IQ data output type (default: same as --intype)")
    # framework extensions
    p.add_argument("--block-bytes", type=int, default=8192,
                   help="stream framing block size in bytes (reference: "
                        "8192).  Large blocks trade samplenum-reset phase "
                        "fidelity for DMA efficiency on rounding-reset-"
                        "heavy ratios (see ops/phase_plan.py's multi-reset "
                        "policy note)")
    p.add_argument("--chunk-blocks", default=None,
                   help="blocks per device dispatch (int), or 'auto' to "
                        "target ~64 ms of stream per dispatch for live-SDR "
                        "latency (default: 'auto' in realtime track mode — "
                        "the Doppler curve updates once per dispatch, so the "
                        "chunk must stay wall-clock small, cf. the "
                        "reference's per-block update main.rs:188 — and 256 "
                        "everywhere else)")
    p.add_argument("--prefetch-chunks", type=int, default=0, metavar="DEPTH",
                   help="stage up to DEPTH input chunks on a reader thread "
                        "(overlaps stdin I/O with device compute; 0 = off)")
    p.add_argument("--resample-to", type=float, default=None, metavar="RATE",
                   help="polyphase-resample output to RATE sps after mixing "
                        "(non-integer rates are rationalized to <1e-9 rel. error)")
    p.add_argument("--resample-stages", choices=["single", "auto", "multi"],
                   default="auto",
                   help="resampler structure: 'auto' (default) uses the "
                        "halfband-cascade msresamp-style multi-stage design "
                        "when decimating ≥4x and single-stage polyphase "
                        "otherwise; 'single'/'multi' force one structure")
    p.add_argument("--resample-impl", choices=["auto", "conv", "window"],
                   default="auto",
                   help="resampler device formulation: banded windows-matmul "
                        "(conv) or gather+fixed-tree (window); auto picks "
                        "conv unless taps ≫ Q")
    p.add_argument("--exact-ratio", action="store_true",
                   help="use exact rational NCO rate instead of mirroring the "
                        "reference's f32-rounded shift/samplerate ratio")
    p.add_argument("--drain", action="store_true",
                   help="flush the resampler FIR tail with zeros at EOF")
    p.add_argument("--log-format", choices=["fern", "json"], default="fern",
                   help="stderr telemetry format")
    p.add_argument("--platform", choices=["cpu", "default"],
                   default="default",
                   help="'cpu' runs on the host CPU; 'default' runs on "
                        "JAX's default device (the GPU where there is one)")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="shard every chunk over a device mesh, e.g. "
                        "'time=4' or 'time=2,channel=4' (channel>1 only in "
                        "channels mode); emitted bytes are identical to the "
                        "unsharded run")
    p.add_argument("--input", metavar="FILE", default=None,
                   help="read IQ from a seekable file instead of stdin "
                        "(required with --distributed)")
    p.add_argument("--output", metavar="FILE", default=None,
                   help="write IQ to a file instead of stdout; under "
                        "--distributed host k writes FILE.partK and "
                        "concatenating the parts reproduces the "
                        "single-process stream bitwise")
    p.add_argument("--distributed", metavar="SPEC", default=None,
                   help="join a multi-host run: coordinator=HOST:PORT,"
                        "num_processes=N,process_id=K.  Hosts split the "
                        "capture by chunk-aligned byte ranges (channels "
                        "mode: by channel) with zero cross-host traffic — "
                        "state at each boundary is seeded exactly from "
                        "absolute stream position (resume = seek)")
    p.add_argument("--host-channels", type=int, default=None, metavar="HC",
                   help="channels mode: channel-parallel host count; must "
                        "equal num_processes (channels mode splits by "
                        "channel only — a time split of the channels grid "
                        "is not implemented).  Default: all hosts split "
                        "the channel axis")
    p.add_argument("--save-state", metavar="PATH", default=None,
                   help="write a resumable checkpoint (.npz) at EOF or on "
                        "SIGTERM/SIGINT; under --distributed host k writes "
                        "PATH.hK (state is host-local)")
    p.add_argument("--load-state", metavar="PATH", default=None,
                   help="resume from a checkpoint written by --save-state "
                        "(feed the stream from the saved byte offset); "
                        "under --distributed host k restores PATH.hK and "
                        "appends to its own part file")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="doppler",
        description="Compensates IQ data stream doppler shift based on TLE "
                    "information, also can be used for doing constant "
                    "baseband shifting (JAX implementation)",
    )
    # reference parity: clap's -V/--version (usage.rs:122)
    from doppler_tpu import __version__
    ap.add_argument("-V", "--version", action="version",
                    version=f"doppler_tpu {__version__} "
                            "(reference surface: cubehub/doppler 1.1.10)")
    sub = ap.add_subparsers(dest="mode", required=True)

    const = sub.add_parser("const", help="Constant shift mode")
    _add_io_args(const)
    const.add_argument("--shift", type=float, required=True,
                       help="frequency shift in Hz")

    track = sub.add_parser("track", help="Doppler tracking mode")
    _add_io_args(track)
    track.add_argument("--tlefile", required=True,
                       help="TLE file: eg. cubesat.txt")
    track.add_argument("--tlename", required=True,
                       help="TLE name in TLE file: eg. ESTCUBE 1")
    track.add_argument("--location", required=True,
                       help="Observer location: lat=<deg>,lon=<deg>,alt=<m>")
    track.add_argument("--time", default=None,
                       help="Observation start time UTC Y-m-dTH:M:S "
                            "(default: current time)")
    track.add_argument("--frequency", type=float, required=True,
                       help="Satellite transmitter frequency in Hz")
    track.add_argument("--offset", type=float, default=0.0,
                       help="Constant frequency shift in Hz added on top")

    chans = sub.add_parser(
        "channels",
        help="Multi-satellite batch: N channels from one wideband capture",
    )
    _add_io_args(chans)
    chans.add_argument("--config", required=True,
                       help="JSON channel config (see docs/channels.md)")
    chans.add_argument("--output-dir", default=".",
                       help="directory for per-channel <name>.iq outputs")
    return ap


def _select_platform(platform: str) -> None:
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")


def _resolve_chunk_blocks(arg, samplerate: int, block_samples: int,
                          realtime: bool = False) -> int:
    """'auto' targets ~64 ms of stream per device dispatch (live-SDR
    latency); otherwise parses an explicit block count.  Unset defaults to
    'auto' in realtime track mode — the Doppler curve is re-evaluated once
    per dispatch there (orbit/schedule.py RealtimeTrackScheduler), so large
    chunks would decimate the update rate far below the reference's
    per-8192-byte-block cadence (main.rs:188) — and to 256 otherwise."""
    if arg is None:
        arg = "auto" if realtime else "256"
    if isinstance(arg, str) and arg.lower() == "auto":
        return max(8, min(1024, round(0.064 * samplerate / block_samples)))
    n = int(arg)
    if n <= 0:
        raise ValueError("--chunk-blocks must be positive")
    return n


def main(argv=None, stdin=None, stdout=None) -> int:
    import logging

    from doppler_tpu.runtime.telemetry import setup_logger

    ap = build_parser()
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    log = setup_logger(getattr(logging, args.log_level.upper()),
                       fmt=getattr(args, "log_format", "fern"))
    _select_platform(args.platform)
    from doppler_tpu.runtime.device import device_summary, enable_compile_cache

    cache_dir = enable_compile_cache()

    # a sub-sample --block-bytes crashed deep inside the run loop (or a
    # ZeroDivisionError in 'auto' chunk sizing) — validate up front like
    # every other config error (round-5 review find)
    _bps = stream_bps(args.intype)
    if args.block_bytes < _bps or args.block_bytes % _bps:
        log.error("--block-bytes must be a positive multiple of %d "
                  "(the %s sample size); got %d",
                  _bps, args.intype, args.block_bytes)
        return 1

    dist_nproc, dist_pid = 1, 0
    if args.distributed:
        from doppler_tpu.parallel import distributed

        try:
            spec = distributed.parse_distributed_spec(args.distributed)
        except ValueError as e:
            log.error("%s", e)
            return 1
        import jax

        distributed.init(**spec)
        dist_nproc, dist_pid = jax.process_count(), jax.process_index()
        log.info("distributed: process %d of %d", dist_pid, dist_nproc)
        if dist_nproc > 1 and not args.input:
            log.error("--distributed needs --input FILE (hosts seek to "
                      "their own byte ranges; a pipe cannot be split)")
            return 1
        # --save/load-state under --distributed is per host: host k writes
        # PATH.hK (its pipeline state is host-local by construction — the
        # byte-range split has zero cross-host state) and a restarted host
        # k resumes from PATH.hK appending to its own part file, emitting
        # exactly the bytes the uninterrupted run would have (elastic
        # recovery, SURVEY §5; tests/test_distributed.py).

    dev = device_summary()
    log.info("device: platform=%s kind=%s count=%d (compile cache %s)",
             dev["platform"], dev["kind"], dev["count"], cache_dir)

    outtype = args.outtype or args.intype
    if args.input:
        try:
            stdin = open(args.input, "rb")
        except OSError as e:
            log.error("%s", e)
            return 1
    elif stdin is None:
        stdin = sys.stdin.buffer
    if args.output and args.mode != "channels":
        out_path = args.output
        # resume appends: the bytes written before the cut are exactly
        # consistent with the checkpoint (consistent-chunk stop), so the
        # resumed run completes the same file the uninterrupted run would
        # have produced (single-process and per-host part files alike)
        mode = "ab" if args.load_state else "wb"
        if dist_nproc > 1:
            out_path = f"{args.output}.part{dist_pid}"
        try:
            stdout = open(out_path, mode)
        except OSError as e:
            log.error("%s", e)
            return 1
    elif stdout is None:
        stdout = sys.stdout.buffer
    try:
        chunk_blocks = _resolve_chunk_blocks(
            args.chunk_blocks, args.samplerate,
            args.block_bytes // stream_bps(args.intype),
            realtime=(args.mode == "track"
                      and getattr(args, "time", None) is None),
        )
    except ValueError as e:
        log.error("%s", e)
        return 1

    from doppler_tpu.orbit.sgp4 import SGP4Error
    from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

    mesh = None
    if args.mesh:
        from doppler_tpu.parallel import make_mesh

        try:
            mesh_time, mesh_channel = parse_mesh(args.mesh)
            if mesh_channel > 1 and args.mode != "channels":
                raise ValueError(
                    "--mesh channel>1 needs channels mode "
                    "(a single stream has one channel)"
                )
            mesh = make_mesh(time=mesh_time, channel=mesh_channel)
        except ValueError as e:
            log.error("%s", e)
            return 1
        log.info("device mesh: time=%d channel=%d", mesh_time, mesh_channel)

    if args.mode == "channels":
        import os

        from doppler_tpu.runtime.channels import (
            MultiChannelPipeline,
            load_channel_config,
        )

        try:
            specs, cfg = load_channel_config(args.config, args.samplerate)
        except (OSError, KeyError, ValueError) as e:
            log.error("bad channel config: %s", e)
            return 1
        if dist_nproc > 1:
            from doppler_tpu.parallel.distributed import host_slice

            if (args.host_channels is not None
                    and args.host_channels != dist_nproc):
                # host_slice would form an (Hc × Ht) grid, but the channels
                # arm only consumes the channel axis — hosts sharing a
                # channel slice would silently reprocess the full capture
                # and race on the same output files (round-5 review find)
                log.error(
                    "--host-channels %d != num_processes %d: channels mode "
                    "splits by channel only (the time axis of the host grid "
                    "is not implemented here); drop --host-channels or set "
                    "it to num_processes", args.host_channels, dist_nproc)
                return 1
            try:
                shard = host_slice(
                    len(specs), 1,
                    process_index=dist_pid, process_count=dist_nproc,
                    channel_parallel_hosts=dist_nproc,
                )
            except ValueError as e:
                log.error("%s", e)
                return 1
            specs = specs[shard.channel_lo:shard.channel_hi]
            log.info("host %d owns channels [%d, %d)", dist_pid,
                     shard.channel_lo, shard.channel_hi)
            if not specs:
                log.info("host %d: no channels to process", dist_pid)
                return 0
        log.info("multi-channel mode: %d channels", len(specs))
        for s in specs:
            log.info("\tchannel %-16s center offset %+.0f Hz",
                     s.name, s.center_offset_hz)
        # realtime channel schedulers re-evaluate their Doppler curve once
        # per dispatch, exactly like realtime track mode — an unset
        # --chunk-blocks must shrink to the ~64 ms 'auto' target here too,
        # or per-channel updates decimate to one per chunk (advisor r2)
        from doppler_tpu.orbit import RealtimeTrackScheduler

        if args.chunk_blocks is None and any(
            isinstance(s.scheduler, RealtimeTrackScheduler) for s in specs
        ):
            chunk_blocks = _resolve_chunk_blocks(
                "auto", args.samplerate,
                args.block_bytes // stream_bps(args.intype),
            )
            log.info("realtime channel(s): chunk-blocks auto = %d",
                     chunk_blocks)
        try:
            mpipe = MultiChannelPipeline(
                args.samplerate, args.intype, outtype, specs,
                out_rate=args.resample_to,
                block_bytes=args.block_bytes,
                chunk_blocks=chunk_blocks,
                quantize_ratio_f32=not args.exact_ratio,
                mesh=mesh,
                drain_on_eof=args.drain,
                resample_stages=args.resample_stages,
            )
        except ValueError as e:
            log.error("%s", e)
            return 1

        from doppler_tpu.runtime import checkpoint

        if args.load_state:
            # per-host checkpoint under --distributed (host-local channel
            # slice), like the stream arm's PATH.hK convention
            ck_path = args.load_state
            if dist_nproc > 1:
                ck_path = f"{args.load_state}.h{dist_pid}"
            try:
                cmeta = checkpoint.restore_channels(ck_path, mpipe)
            except (ValueError, OSError) as e:
                log.error("%s", e)
                return 1
            resume_byte = cmeta["samples_in"] * stream_bps(args.intype)
            if cmeta.get("drained"):
                # the checkpointed run already hit EOF and flushed the FIR
                # tails into the per-channel files; re-running would drain
                # AGAIN and append duplicate tails (outputs open in append
                # mode) — a completed run is a no-op (ADVICE r4, the
                # channels analog of the stream arm's guard)
                size = os.stat(args.input).st_size if args.input else None
                if size is None or resume_byte >= size:
                    log.info("checkpoint is complete (drained); "
                             "nothing to do")
                    return 0
                log.error(
                    "checkpoint was written after an EOF drain but the "
                    "capture has grown since; the flushed FIR tail already "
                    "ended the output streams, so resuming would corrupt "
                    "them — reprocess the full capture instead")
                return 1
            if args.input:
                # seekable capture: fast-forward to the checkpoint so the
                # operator doesn't have to pre-trim the stream
                stdin.seek(resume_byte)
            log.info("resumed at input sample %d (byte %d)",
                     cmeta["samples_in"], resume_byte)

        stop_flag = {"stop": False}
        if args.save_state:
            import signal

            def _on_signal(signum, frame):
                stop_flag["stop"] = True

            signal.signal(signal.SIGTERM, _on_signal)
            signal.signal(signal.SIGINT, _on_signal)

        os.makedirs(args.output_dir, exist_ok=True)
        # resuming appends to the per-channel files written before the cut
        open_mode = "ab" if args.load_state else "wb"
        writers = [
            open(os.path.join(args.output_dir, f"{s.name}.iq"), open_mode)
            for s in specs
        ]
        try:
            counters = mpipe.run(stdin, writers,
                                 should_stop=lambda: stop_flag["stop"])
        except SGP4Error as e:
            log.error("orbit propagation failed: %s "
                      "(supply a current TLE, or a start time near the TLE "
                      "epoch)", e)
            return 1
        finally:
            for w in writers:
                w.close()
        if args.save_state:
            ck_path = args.save_state
            if dist_nproc > 1:
                ck_path = f"{args.save_state}.h{dist_pid}"
            checkpoint.save_channels(ck_path, mpipe)
            log.info("checkpoint written to %s", ck_path)
        if stop_flag["stop"]:
            log.warning("stopped by signal after a consistent chunk boundary")
            return 130
        log.info(
            "done: %d wideband samples × %d channels in %.3f s (%.3f Msps in)",
            counters.samples, len(specs), counters.elapsed(),
            counters.rate() / 1e6,
        )
        return 0

    if args.mode == "const":
        log.info("constant shift mode")
        log.info("\tIQ samplerate   : %d", args.samplerate)
        log.info("\tIQ input type   : %s", args.intype)
        log.info("\tIQ output type  : %s", outtype)
        log.info("\tfrequency shift : %s Hz", args.shift)
        scheduler = ConstScheduler(args.shift)
    else:
        try:
            lat, lon, alt = parse_location(args.location)
        except ValueError as e:
            log.error("%s", e)
            return 1
        start_time = None
        if args.time is not None:
            try:
                start_time = parse_time_utc(args.time)
            except ValueError as e:
                log.error("%s", e)
                return 1

        from doppler_tpu.orbit import make_track_scheduler

        log.info("tracking mode")
        log.info("\tIQ samplerate   : %d", args.samplerate)
        log.info("\tIQ input type   : %s", args.intype)
        log.info("\tIQ output type  : %s", outtype)
        log.info("\tTLE file        : %s", args.tlefile)
        log.info("\tTLE name        : %s", args.tlename)
        log.info("\tlocation        : lat=%s lon=%s alt=%s", lat, lon, alt)
        log.info("\tfrequency       : %s Hz", args.frequency)
        log.info("\toffset          : %s Hz", args.offset)
        try:
            scheduler = make_track_scheduler(
                tlefile=args.tlefile,
                tlename=args.tlename,
                lat=lat, lon=lon, alt=alt,
                frequency_hz=args.frequency,
                offset_hz=args.offset,
                samplerate=args.samplerate,
                start_time=start_time,
            )
        except (FileNotFoundError, ValueError) as e:
            log.error("%s", e)
            return 1

    try:
        pipe = Pipeline(
            args.samplerate,
            args.intype,
            outtype,
            scheduler,
            block_bytes=args.block_bytes,
            chunk_blocks=chunk_blocks,
            quantize_ratio_f32=not args.exact_ratio,
            drain_on_eof=args.drain,
            prefetch_chunks=args.prefetch_chunks,
            mesh=mesh,
        )
        if args.resample_to is not None:
            from doppler_tpu.ops.resample import attach_resampler

            attach_resampler(pipe, args.resample_to,
                             stages=args.resample_stages,
                             impl=args.resample_impl)
    except ValueError as e:
        log.error("%s", e)
        return 1

    if dist_nproc > 1:
        # Multi-host stream split (parallel/distributed.py): chunk-aligned
        # byte ranges so every host sees the same chunk boundaries the
        # single-process run has — concat(part files) is bitwise that run.
        import os as _os

        from doppler_tpu.parallel.distributed import host_slice
        from doppler_tpu.runtime.stream import ByteRangeReader

        if not args.output:
            log.error("--distributed needs --output FILE "
                      "(per-host part files)")
            return 1
        if args.mode == "track" and args.time is None:
            log.error("--distributed track mode needs --time "
                      "(wall-clock schedules are not host-splittable)")
            return 1
        size = _os.stat(args.input).st_size
        chunk_bytes = args.block_bytes * chunk_blocks
        n_chunks = max(1, -(-size // chunk_bytes))
        shard = host_slice(1, n_chunks, process_index=dist_pid,
                           process_count=dist_nproc)
        lo = shard.block_lo * chunk_bytes
        hi = min(size, shard.block_hi * chunk_bytes)
        if args.load_state:
            # elastic restart: this host's own checkpoint carries absolute
            # stream position + FIR state — restore replaces the seek
            from doppler_tpu.runtime import checkpoint

            try:
                meta = checkpoint.restore(
                    f"{args.load_state}.h{dist_pid}", pipe)
            except (ValueError, OSError) as e:
                log.error("%s", e)
                return 1
            resume_lo = meta["sample_offset"] * stream_bps(args.intype)
            if (not (lo <= resume_lo <= hi)
                    or (resume_lo % chunk_bytes and resume_lo != hi)):
                log.error(
                    "checkpoint at byte %d is outside this host's range "
                    "[%d, %d) or not chunk-aligned", resume_lo, lo, hi)
                return 1
            if meta.get("drained"):
                # this host already finished AND flushed the FIR tail in
                # the checkpointed run; re-running would hit EOF instantly
                # and append a duplicate tail to the .part file (the output
                # opens in append mode) — a completed host is a no-op
                # (ADVICE r4).  If the capture GREW since, the flushed tail
                # already ended this host's part stream, so resuming would
                # corrupt it — refuse, like the single-process/channels
                # arms (round-5 review find)
                if resume_lo >= hi:
                    log.info("host %d checkpoint is complete (drained); "
                             "nothing to do", dist_pid)
                    return 0
                log.error(
                    "host %d checkpoint was written after an EOF drain but "
                    "the capture has grown since; the flushed FIR tail "
                    "already ended the part stream — reprocess the full "
                    "capture instead", dist_pid)
                return 1
            lo = resume_lo
            log.info("host %d resumed at input sample %d",
                     dist_pid, meta["sample_offset"])
        else:
            history = None
            n_hist = (pipe.seek_history_blocks()
                      if pipe.resampler is not None else 0)
            if lo > 0 and n_hist:
                hist_bytes = n_hist * args.block_bytes
                if hist_bytes > lo:
                    log.error(
                        "host %d needs %d history blocks before byte %d "
                        "but the capture is shorter there", dist_pid,
                        n_hist, lo)
                    return 1
                with open(args.input, "rb") as hf:
                    hf.seek(lo - hist_bytes)
                    history = hf.read(hist_bytes)
            try:
                pipe.seek_to_block(shard.block_lo * chunk_blocks,
                                   history=history)
            except ValueError as e:
                log.error("%s", e)
                return 1
        # reuse the handle opened above (a second open leaked the first fd)
        stdin = ByteRangeReader(stdin, lo, hi)
        if dist_pid != dist_nproc - 1:
            pipe.drain_on_eof = False   # only the stream's last host drains
        log.info("host %d owns chunks [%d, %d) = bytes [%d, %d)",
                 dist_pid, shard.block_lo, shard.block_hi, lo, hi)

    if args.load_state and dist_nproc == 1:
        import os as _os2

        from doppler_tpu.runtime import checkpoint

        try:
            meta = checkpoint.restore(args.load_state, pipe)
        except (ValueError, OSError) as e:
            log.error("%s", e)
            return 1
        resume_byte = meta["sample_offset"] * stream_bps(args.intype)
        if meta.get("drained"):
            # completed run (EOF + FIR tail flushed): re-running would
            # drain again and append a duplicate tail (ADVICE r4; same
            # guard as the distributed and channels arms)
            size = _os2.stat(args.input).st_size if args.input else None
            if size is None or resume_byte >= size:
                log.info("checkpoint is complete (drained); nothing to do")
                return 0
            log.error(
                "checkpoint was written after an EOF drain but the capture "
                "has grown since; the flushed FIR tail already ended the "
                "output stream — reprocess the full capture instead")
            return 1
        if args.input:
            # seekable capture: fast-forward to the checkpoint (the
            # channels arm and --distributed already did; stdin-pipe
            # callers feed the remainder themselves)
            stdin.seek(resume_byte)
        log.info("resumed at input sample %d (byte %d)",
                 meta["sample_offset"], resume_byte)

    # graceful interruption: SIGTERM/SIGINT finish the in-flight chunk, then
    # stop — so a --save-state checkpoint is exactly consistent with the
    # bytes already written (elastic recovery, SURVEY §5)
    stop_flag = {"stop": False}
    if args.save_state:
        import signal

        def _on_signal(signum, frame):
            stop_flag["stop"] = True

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    try:
        counters = pipe.run(stdin, stdout,
                            should_stop=lambda: stop_flag["stop"])
    except SGP4Error as e:
        # mid-stream propagation failure (e.g. realtime track with a TLE so
        # stale the drag model decays the orbit before 'now'): clean exit
        # like the reference's config-error path (usage.rs:309), not a
        # traceback — the bytes already written stay valid
        log.error("orbit propagation failed: %s "
                  "(supply a current TLE, or --time near the TLE epoch)", e)
        return 1

    if args.save_state:
        from doppler_tpu.runtime import checkpoint

        state_path = args.save_state
        if dist_nproc > 1:
            state_path = f"{args.save_state}.h{dist_pid}"
        checkpoint.save(state_path, pipe)
        log.info("checkpoint written to %s", state_path)
    if stop_flag["stop"]:
        log.warning("stopped by signal after a consistent chunk boundary")
        return 130
    # report the INPUT rate (the reference's realtime contract is on the
    # capture rate; with a resampler the output count is P/Q of it)
    n_in = counters.bytes_in // stream_bps(args.intype)
    dt = counters.elapsed()
    log.info(
        "done: %d samples in, %d out in %.3f s (%.3f Msps in)",
        n_in, counters.samples, dt, (n_in / dt if dt > 0 else 0.0) / 1e6,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
