#!/usr/bin/env python
"""Trace one BASELINE config through the CLI and reduce the device trace.

    python tools/trace_config.py --config 3 --seconds 10 --out DIR
    python tools/trace_config.py --config 5 --seconds 0.25 --out DIR

Runs the config once to compile, then again in the same process under
``jax.profiler.trace`` with the run wrapped in a ``TraceAnnotation``.  The
reduction reads the ``.xplane.pb`` with ``jax.profiler.ProfileData``: on
each GPU plane, the events of its stream lines are the device's work.  It
prints the window (the annotated run on the host clock), the device's busy
time (union of those events) and idle share (1 − busy/window), and the top
device operations by total time, as one JSON line.

It refuses to run without a GPU (exit 1); ``--platform cpu`` rehearses the
same run on the host CPU, where no device plane exists.
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = "doppler_run"


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def reduce_trace(path: str, top: int = 12) -> dict:
    """Device busy/idle and top operations of one ``.xplane.pb``."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    window = None
    ops: dict[str, list] = {}
    intervals = []
    lines_seen = set()
    for plane in data.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == RUN:
                        window = (ev.start_ns, ev.end_ns)
            continue
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.end_ns))
                acc = ops.setdefault(ev.name, [0.0, 0])
                acc[0] += ev.duration_ns
                acc[1] += 1
    if window is None and intervals:
        window = (min(s for s, _ in intervals), max(e for _, e in intervals))
    if window is None:
        raise ValueError(f"{path}: no annotated run and no device events")
    inside = [(max(s, window[0]), min(e, window[1])) for s, e in intervals
              if e > window[0] and s < window[1]]
    busy = _union_ns(inside)
    span = window[1] - window[0]
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ms": span / 1e6,
        "device_busy_ms": busy / 1e6,
        "device_idle_share": 1.0 - busy / span if span else None,
        "device_lines": sorted(lines_seen),
        "top_ops": [{"name": n[:120], "total_ms": t / 1e6, "count": c}
                    for n, (t, c) in ranked],
    }


def config_run(config: int, seconds: float, tmp: str):
    """(argv, input bytes) of one config through the CLI."""
    from tools import conformance as cf

    if config == 3:
        n = 2048 * max(1, int(cf.FS3 * seconds) // 2048)
        return (cf.track_args(cf.FS3, cf.write_tle(tmp))
                + ["--resample-to", "48000"], cf.noise_i16(n, 3))
    if config == 5:
        n = 256 * 2048 * max(1, int(cf.FS5 * seconds) // (256 * 2048))
        shifts = cf.config5_channels(256)
        cfgf = os.path.join(tmp, "ch5.json")
        with open(cfgf, "w") as f:
            json.dump({"channels": [{"name": f"w{c}", "shift": s}
                                    for c, s in enumerate(shifts)]}, f)
        return (["channels", "-s", str(cf.FS5), "-i", "i16", "--config", cfgf,
                 "--output-dir", os.path.join(tmp, "out5"),
                 "--resample-to", "48000", "--chunk-blocks", "256"],
                cf.config5_capture(n, shifts, [0]))
    raise ValueError(f"no trace recipe for config {config}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=[3, 5], required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True, help="trace directory")
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="'cpu' rehearses on the host CPU (its idle share "
                         "is never a result about the card)")
    args = ap.parse_args(argv)

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from doppler_tpu.cli import main as cli_main
    from doppler_tpu.runtime.device import device_summary, enable_compile_cache

    dev = device_summary()
    if dev["platform"] != args.platform:
        print(f"trace_config: JAX found no {args.platform} (platform "
              f"{dev['platform']})", file=sys.stderr)
        return 1
    enable_compile_cache()
    with tempfile.TemporaryDirectory() as tmp:
        argv, raw = config_run(args.config, args.seconds, tmp)
        argv += ["--log-level", "warning"]
        for traced in (False, True):
            out = io.BytesIO()
            if traced:
                with jax.profiler.trace(args.out):
                    with jax.profiler.TraceAnnotation(RUN):
                        rc = cli_main(argv, stdin=io.BytesIO(raw), stdout=out)
            else:
                rc = cli_main(argv, stdin=io.BytesIO(raw), stdout=out)
            if rc:
                return rc
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    res = reduce_trace(path)
    res.update(config=args.config, seconds=args.seconds, device=dev)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
