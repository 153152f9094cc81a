#!/usr/bin/env python
"""Smoke run of the Doppler pipeline on the GPU, in one process.

    python chip_smoke.py                 # one card: configs 1-5 + invariants
    python chip_smoke.py --four-cards    # config 5 on --mesh channel=4 vs one card

Drives the CLI in-process (``doppler_tpu.cli.main(argv, stdin, stdout)``),
so no second JAX process ever opens a card.  Each BASELINE config runs at its
real rate and wire format and is scored against the reference model with the
builders and bar of ``tools/conformance.py``.  The MS/s printed per phase are
smoke timings (compilation included), not benchmark results.

Any failed phase exits non-zero without printing a result.  The last line of
a passing run is one JSON object naming the device JAX used:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
It refuses to run without a GPU; ``--platform cpu`` rehearses the same
phases on the host CPU at a size given by ``--seconds``/``--config5-chunks``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

C5_CHANNELS = 256
C5_BLOCKS = 256           # blocks of 2048 samples per chunk (config 5)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def run_cli(argv, data: bytes) -> bytes:
    """The CLI in this process: bytes in, bytes out; a non-zero exit fails
    the phase."""
    from doppler_tpu.cli import main

    out = io.BytesIO()
    rc = main(list(argv), stdin=io.BytesIO(data), stdout=out)
    if rc != 0:
        fail(f"CLI exited {rc}: {' '.join(argv)}")
    return out.getvalue()


def timed(label, n_in, fs, fn):
    """Run one phase; print its wall time and smoke MS/s (input samples)."""
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    print(f"{label}: {n_in / fs:.2f} s of stream, {dt:.2f} s wall, "
          f"{n_in / dt / 1e6:.2f} MS/s (smoke timing, compile included)")
    return res


def check(name, snr, size_ok):
    from tools.conformance import passes

    print(f"  {'PASS' if passes(snr, size_ok) else 'FAIL'} {name}: "
          f"SNR {snr:.1f} dB, lengths {'exact' if size_ok else 'WRONG'}")
    if not passes(snr, size_ok):
        fail(name)


def byte_diff(a: bytes, b: bytes):
    """(differing i16 samples, worst LSB) of two i16 streams."""
    if len(a) != len(b):
        return -1, -1
    xa = np.frombuffer(a, "<i2").astype(np.int32)
    xb = np.frombuffer(b, "<i2").astype(np.int32)
    d = np.abs(xa - xb)
    return int((d > 0).sum()), int(d.max()) if d.size else 0


def configs_1_to_4(tmp, seconds):
    from tools import conformance as cf

    n1 = int(cf.FS2 * seconds)
    check(*timed("config 1", n1, cf.FS2,
                 lambda: cf.config1(run_cli, n=n1)))
    b2 = -(-int(cf.FS2 * seconds) // 2048)
    check(*timed("config 2", 2048 * b2, cf.FS2,
                 lambda: cf.config2(tmp, run_cli, blocks=b2)))
    b3 = -(-int(cf.FS3 * seconds) // 2048)
    # 'auto' is the CLI default (the ÷8 + 3/8 cascade); 'single' the
    # single-stage polyphase filter
    for stages in ("auto", "single"):
        for ot in ("i16", "f32"):
            name, snr, ok = timed(
                f"config 3 {stages} -o {ot}", 2048 * b3, cf.FS3,
                lambda: cf.config3(tmp, run_cli, blocks=b3, outtype=ot,
                                   stages=stages))
            check(name, snr, ok)
            if ot == "f32" and not snr > 70.0:
                fail(f"{name} at {snr:.1f} dB: f32 products lost precision "
                     "(TF32?) — the contract is > 70 dB")
    n4 = 8192 * -(-int(cf.FS3 * seconds) // 8192)
    check(*timed("config 4", n4, cf.FS3,
                 lambda: cf.config4(tmp, run_cli, n=n4)))


def config5(tmp, chunks, n_channels=C5_CHANNELS, extra=()):
    """Config 5 through the channels CLI; its last channel sits on an evenly
    spaced plan's shift (``LATTICE_SHIFT5``), whose SNR is printed as a
    reading of a known departure and not held to the bar."""
    from tools import conformance as cf

    n = chunks * C5_BLOCKS * 2048
    shifts = cf.config5_channels(n_channels)
    shifts[-1] = cf.LATTICE_SHIFT5
    scored = sorted({0, n_channels * 3 // 10, n_channels // 2, n_channels - 2})
    name, snr, ok, outs, readings = timed(
        f"config 5 {' '.join(extra) or 'one card'} ({n_channels} ch)",
        n, cf.FS5,
        lambda: cf.config5(tmp, run_cli, n=n, shifts=shifts, scored=scored,
                           extra=("--chunk-blocks", str(C5_BLOCKS), *extra),
                           watched=[n_channels - 1]))
    check(name, snr, ok)
    print(f"  READING (known departure, not gated) lattice channel shift "
          f"{cf.LATTICE_SHIFT5:.0f} Hz: SNR {readings[n_channels - 1]:.1f} dB")
    return outs


def invariants(tmp, seconds):
    """Config-3 path (default cascade): checkpoint + resume and two
    chunk widths must reproduce the uninterrupted bytes exactly."""
    from tools import conformance as cf

    chunk = 256
    n_chunks = max(2, int(cf.FS3 * seconds) // (2048 * chunk))
    raw = cf.noise_i16(2048 * chunk * n_chunks, 6)
    tlef = cf.write_tle(tmp)
    base = cf.track_args(cf.FS3, tlef) + ["--resample-to", "48000"]
    full = os.path.join(tmp, "inv_full.iq")
    half = os.path.join(tmp, "inv_half.iq")
    with open(full, "wb") as f:
        f.write(raw)
    cut = 4 * 2048 * chunk * (n_chunks // 2)
    with open(half, "wb") as f:
        f.write(raw[:cut])
    whole = run_cli(base + ["--chunk-blocks", str(chunk)], raw)
    resumed = os.path.join(tmp, "inv_resumed.iq")
    ck = os.path.join(tmp, "inv.npz")
    run_cli(base + ["--chunk-blocks", str(chunk), "--input", half,
                    "--output", resumed, "--save-state", ck], b"")
    run_cli(base + ["--chunk-blocks", str(chunk), "--input", full,
                    "--output", resumed, "--load-state", ck], b"")
    with open(resumed, "rb") as f:
        got = f.read()
    other = run_cli(base + ["--chunk-blocks", str(chunk // 4 + 3)], raw)
    for what, b in (("checkpoint + resume", got),
                    (f"--chunk-blocks {chunk // 4 + 3} vs {chunk}", other)):
        n_diff, worst = byte_diff(whole, b)
        print(f"  {'PASS' if b == whole else 'FAIL'} invariant {what}: "
              f"{n_diff} samples differ, worst {worst} LSB"
              + ("" if n_diff >= 0 else " (lengths differ)"))
        if b != whole:
            fail(f"invariant {what}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="only config 5 under --mesh channel=4, compared "
                         "with the same input on one card")
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="'cpu' rehearses on the host CPU (never a result "
                         "about the card)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="stream length of configs 1-4 (default 10 s)")
    ap.add_argument("--config5-chunks", type=int, default=48,
                    help="config 5 input in chunks of 256 × 2048 samples")
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from doppler_tpu.runtime.device import (
        card_identity,
        device_summary,
        enable_compile_cache,
    )

    # phase 1: identity
    for line in card_identity():
        print(f"card: {line}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    dev = device_summary()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}")
    if dev["platform"] != args.platform:
        fail(f"JAX found no {args.platform} (platform {dev['platform']})")
    if args.four_cards and dev["count"] < 4:
        fail(f"--four-cards needs 4 devices, JAX sees {dev['count']}")
    from doppler_tpu.runtime import native

    if not native.available():
        fail("native host library not built (make -C native): the "
             "reference model would run at Python speed")
    print(f"compile cache: {enable_compile_cache()}")

    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            mesh = config5(tmp, args.config5_chunks,
                           extra=("--mesh", "channel=4"))
            one = config5(tmp, args.config5_chunks)
            worst, n_diff = 0, 0
            for a, b in zip(mesh, one):
                d, w = byte_diff(a, b)
                if d < 0:
                    fail("--mesh channel=4 lengths differ from one card")
                n_diff, worst = n_diff + d, max(worst, w)
            print(f"  {'PASS' if worst <= 1 else 'FAIL'} --mesh channel=4 vs "
                  f"one card: {n_diff} samples differ, worst {worst} LSB, "
                  "lengths identical")
            if worst > 1:
                fail("--mesh channel=4 differs from one card by > 1 LSB")
        else:
            configs_1_to_4(tmp, args.seconds)
            config5(tmp, args.config5_chunks)
            invariants(tmp, min(args.seconds, 4.0))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
