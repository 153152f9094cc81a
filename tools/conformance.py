#!/usr/bin/env python
"""Conformance harness: run the BASELINE eval configs against the oracle.

Exercises the baseline configs end-to-end through the real CLI surface
(bytes in → bytes out) and scores each against the bit-faithful model of the
reference binary (``doppler_tpu.oracle``, with its C++ twin
``runtime.native.reference_mix`` for long streams).

    python tools/conformance.py            # all five configs, on the CPU

Each ``configN`` takes the CLI runner as its first argument — a subprocess
on the CPU here, the in-process CLI in ``chip_smoke.py`` — and a size, so
the same builders and scoring serve a CPU miniature and a full-length run
on the card.

Configs (BASELINE.md):
  1. const −15 kHz @ 256 ksps, f32 → i16
  2. track: recorded overpass, 256 ksps i16, TLE + 5 kHz offset
     (the classic Spacetrack test TLE stands in for ESTCube-1 — no network)
  3. track + resample 1.024 Msps → 48 ksps
  4. 16-channel batch (channel outputs vs per-channel single runs)

Pass bar (:func:`passes`): > 60 dB SNR vs the golden model after i16
quantization (the reference's own f32 phase noise sits well below this) and
exact output lengths.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from doppler_tpu import oracle  # noqa: E402
from doppler_tpu.orbit import Observer, Predictor, Tle  # noqa: E402
from doppler_tpu.orbit.tle import _checksum  # noqa: E402

FS2 = 256000
FS3 = 1024000
FREQ = 437505000.0


def fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


L1 = fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
L2 = fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
START_UNIX = (2444514.48708465 - 2440587.5) * 86400.0 + 3600.0
LOCATION = "lat=58.26541,lon=26.46667,alt=76"


PASS_DB = 60.0


def passes(snr: float, size_ok: bool) -> bool:
    """The conformance bar shared by this tool and ``chip_smoke.py``."""
    return snr > PASS_DB and size_ok


def run_cli(args_list, data):
    """CPU runner: one ``python -m doppler_tpu`` subprocess per call."""
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu"] + args_list + ["--platform", "cpu"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.decode()[-2000:])
    return proc.stdout


def reference_track_shifts(block_counts, fs, offset):
    pred = Predictor(Tle.from_lines("TEST SAT", L1, L2),
                     Observer(58.26541, 26.46667, 76.0))
    sample_count, dt, out = 0, 0, []
    for count in block_counts:
        dop, _ = pred.doppler_hz(float(int(START_UNIX)) + dt, FREQ)
        out.append(float(np.float32(dop) + np.float32(offset)))
        dt = int(np.float32(np.float32(sample_count) / np.float32(fs)))
        sample_count += count
    return out


def reference_mix(x, samplenum, shift, fs):
    """The reference NCO over ``x`` (C++ twin of ``oracle`` when built)."""
    from doppler_tpu.runtime import native

    i, q, sn = native.reference_mix(x.real, x.imag, samplenum, shift, fs)
    return (i + 1j * q).astype(np.complex64), sn


def sequential_mix(xq, shifts, fs, block):
    out = np.empty_like(xq)
    sn = 0
    for k, s in enumerate(shifts):
        seg = xq[k * block:(k + 1) * block]
        out[k * block:(k + 1) * block], sn = reference_mix(seg, sn, s, fs)
    return out


def score_i16(got: bytes, want) -> tuple[float, bool]:
    """SNR of i16 CLI bytes against the golden complex stream, quantized the
    reference's way; (snr, lengths equal)."""
    want_c = oracle.decode_i16_bytes(oracle.encode_i16_bytes(want))
    got_c = oracle.decode_i16_bytes(got)
    if len(got_c) != len(want_c):
        return 0.0, False
    return oracle.snr_db(want_c, got_c), True


def score_f32(got: bytes, want) -> tuple[float, bool]:
    """SNR of f32 CLI bytes against the golden complex stream."""
    got_c = oracle.decode_f32_bytes(got)
    if len(got_c) != len(want):
        return 0.0, False
    return oracle.snr_db(want, got_c), True


def write_tle(tmp):
    tlef = os.path.join(tmp, "sat.txt")
    with open(tlef, "w") as f:
        f.write(f"TEST SAT\n{L1}\n{L2}\n")
    return tlef


def track_args(fs, tlef):
    start = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX))
    return ["track", "-s", str(fs), "-i", "i16",
            "--tlefile", tlef, "--tlename", "TEST SAT",
            "--location", LOCATION, "--frequency", str(int(FREQ)),
            "--offset", "5000", "--time", start]


def noise_i16(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=2 * n,
                        dtype=np.int16).astype("<i2").tobytes()


def config1(run=run_cli, n=65536):
    rng = np.random.default_rng(1)
    x = (0.3 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    got = run(["const", "-s", str(FS2), "-i", "f32", "-o", "i16",
               "--shift", "-15000"], oracle.encode_f32_bytes(x))
    want, _ = reference_mix(x, 0, -15000.0, FS2)
    return ("const -15kHz f32→i16", *score_i16(got, want))


def config2(tmp, run=run_cli, blocks=300):
    tlef = write_tle(tmp)
    n = 2048 * blocks
    raw = noise_i16(n, 2)
    got = run(track_args(FS2, tlef), raw)
    xq = oracle.decode_i16_bytes(raw)
    shifts = reference_track_shifts([2048] * blocks, FS2, 5000.0)
    want = sequential_mix(xq, shifts, FS2, 2048)
    return (f"track TLE+5kHz 256k i16 ({n / FS2:.1f} s)",
            *score_i16(got, want))


def resample_golden(z, stages):
    """Every stage's ``resample_oracle`` in turn (one stage or a cascade)."""
    from doppler_tpu.ops.resample import resample_oracle

    for st in stages:
        z = resample_oracle(z, st.P, st.Q, st.bank)
    return z.astype(np.complex64)


def config3(tmp, run=run_cli, blocks=512, outtype="i16", stages="single"):
    """``stages='single'`` pins the single-stage polyphase design;
    ``'auto'`` is the CLI default, the ÷8 + 3/8 cascade, scored against
    the per-stage golden."""
    tlef = write_tle(tmp)
    n = 2048 * blocks
    raw = noise_i16(n, 3)
    got = run(track_args(FS3, tlef) + [
        "-o", outtype, "--resample-to", "48000",
        "--resample-stages", stages], raw)
    # golden: sequential mix then the resampler oracle.
    #
    # SNR FLOOR ANALYSIS (why this gate reads ~71 dB and why no
    # filter-design margin can move it): the golden uses the
    # SAME bank as the CLI, so the filter's stopband attenuation cancels
    # entirely in this comparison.  What remains, measured on this exact
    # workload (round 5):
    #   - quantizing the golden itself (want vs i16(want)) scores 65.2 dB —
    #     decimated broadband noise has RMS ≈ 0.047 FS, so i16 truncation
    #     alone floors an UNCORRELATED comparison there;
    #   - the CLI's truncations are nearly identical to the oracle's
    #     (errors correlate; only boundary-crossing samples differ), which
    #     is why the measured score (70.9 dB) EXCEEDS the one-sided floor;
    #   - with -o f32 (no output quantization) the same run scores 77.7 dB
    #     = the f32-kernel-vs-f64-oracle arithmetic agreement over the
    #     T=370-tap window dot.
    # The gate is therefore structurally floored by output quantization of
    # a low-RMS decimated-noise signal over the ~78 dB f32/f64 arithmetic
    # delta — ops/filters.py's atten_db=70 design never enters.  (Drive
    # heavy-decimation configs with in-band tones, not broadband noise,
    # when the question is filter quality.)
    from doppler_tpu.ops.multistage import make_resampler

    xq = oracle.decode_i16_bytes(raw)
    shifts = reference_track_shifts([2048] * blocks, FS3, 5000.0)
    mixed = sequential_mix(xq, shifts, FS3, 2048)
    rs = make_resampler(FS3, 48000, stages=stages)
    want = resample_golden(mixed, getattr(rs, "stages", [rs]))
    # exact length: streaming Bresenham emits ceil(n·P/Q) − ceil(0) = n·P/Q,
    # the same closed form the oracle's full-buffer window count reduces to
    # (any off-by-one fails loudly)
    score = score_i16 if outtype == "i16" else score_f32
    return (f"track+resample 1.024M→48k {stages} -o {outtype}",
            *score(got, want))


def config4(tmp, run=run_cli, n=8192 * 8):
    raw = noise_i16(n, 4)
    cfg = {"channels": [
        {"name": f"ch{k}", "shift": -40000 + 10000 * k, "center_offset": 1000.0 * k}
        for k in range(16)
    ]}
    cfgf = os.path.join(tmp, "ch.json")
    with open(cfgf, "w") as f:
        json.dump(cfg, f)
    outdir = os.path.join(tmp, "out")
    run(["channels", "-s", str(FS3), "-i", "i16", "--config", cfgf,
         "--output-dir", outdir], raw)
    x = oracle.decode_i16_bytes(raw)
    worst, lengths_ok = float("inf"), True
    for k in range(16):
        with open(os.path.join(outdir, f"ch{k}.iq"), "rb") as f:
            got = f.read()
        shift = float(np.float32(np.float32(-40000 + 10000 * k))
                      + np.float32(1000.0 * k))
        want, _ = reference_mix(x, 0, shift, FS3)
        snr, size_ok = score_i16(got, want)
        worst, lengths_ok = min(worst, snr), lengths_ok and size_ok
    return "16-channel batch (worst channel)", worst, lengths_ok


FS5 = 100_000_000


def config5_capture(n, shifts, scored, seed=5):
    """A 100 Msps i16 capture with a narrowband downlink near the centre of
    each scored channel (a white-noise input would leave only 1/2083 of its
    power in the 48 k output band — the i16 OUTPUT quantization alone then
    floors the score at ~57 dB regardless of implementation fidelity)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n, dtype=np.float64)
    sig = np.zeros(n, dtype=np.complex128)
    offs = (5e3, 8e3, 3e3, 6e3)
    for j, c in enumerate(scored):
        sig += 0.22 * np.exp(2j * np.pi * ((shifts[c] + offs[j % 4]) / FS5) * k)
    sig += 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ix = np.empty(2 * n, dtype=np.int16)
    ix[0::2] = np.clip(np.trunc(sig.real * 32767), -32768, 32767)
    ix[1::2] = np.clip(np.trunc(sig.imag * 32767), -32768, 32767)
    return ix.astype("<i2").tobytes()


def config5_channels(n_channels, seed=55):
    """Channel centre shifts drawn over ±40 MHz of the 100 Msps capture
    (whole Hz, from a seed).  Evenly spaced plans k·80 MHz/(C−1) − 40 MHz
    put some channels on shifts the mixer does not yet match (see
    :data:`LATTICE_SHIFT5`)."""
    rng = np.random.default_rng(seed)
    return [float(np.float32(v)) for v in
            np.round(rng.uniform(-40e6, 40e6, n_channels))]


# Channel 17 of an evenly spaced 256-channel plan over ±40 MHz (ratio
# −0.3467).  At such shifts the samplenum counter runs ~10^5 samples
# without a reset and the mixer departs from the reference's f32 phase
# rounding: ~37 dB against the oracle, below the bar — an open question,
# read (not gated) by chip_smoke.py so the gap stays visible.
LATTICE_SHIFT5 = float(np.float32(-40e6 + 17 * 80e6 / 255))


def config5(tmp, run=run_cli, n=2048 * 256, shifts=None, scored=None,
            extra=(), watched=()):
    """BASELINE config 5: a 100 Msps wideband capture split into channels,
    each decimated by the cascade to 48 ksps (÷16 → ÷16 → 384/3125, the
    odd-Q rate) through the real channels CLI.  Every channel's length
    must be exact; the ``scored`` channels are compared with the reference
    mix + per-stage resampler oracles.  Returns the usual triple, the
    per-channel output bytes (for cross-run comparison) and ``{channel:
    SNR}`` of the ``watched`` channels, which are scored the same way but
    left out of the triple."""
    from doppler_tpu.ops.multistage import MultiStageResampler

    shifts = shifts or [-2_000_000.0, 500_000.0, 3_141_592.0]
    scored = list(range(len(shifts))) if scored is None else scored
    raw = config5_capture(n, shifts, [*scored, *watched])
    cfg = {"channels": [
        {"name": f"w{c}", "shift": s} for c, s in enumerate(shifts)
    ]}
    cfgf = os.path.join(tmp, "ch5.json")
    with open(cfgf, "w") as f:
        json.dump(cfg, f)
    outdir = os.path.join(tmp, "out5")
    run(["channels", "-s", str(FS5), "-i", "i16", "--config", cfgf,
         "--output-dir", outdir, "--resample-to", "48000",
         "--resample-stages", "auto", *extra], raw)
    ms = MultiStageResampler(FS5, 48000)
    n_want = ms.out_count_for(n)
    outs = []
    for c in range(len(shifts)):
        with open(os.path.join(outdir, f"w{c}.iq"), "rb") as f:
            outs.append(f.read())
    lengths_ok = all(len(o) == 4 * n_want for o in outs)
    x = oracle.decode_i16_bytes(raw)
    worst, readings = float("inf"), {}
    for c in [*scored, *watched]:
        z, _ = reference_mix(x, 0, shifts[c], FS5)
        snr, size_ok = score_i16(outs[c], resample_golden(z, ms.stages))
        lengths_ok = lengths_ok and size_ok
        if c in watched:
            readings[c] = snr
        else:
            worst = min(worst, snr)
    name = f"config 5: 100 Msps → 48 k, {len(shifts)} channels"
    return name, worst, lengths_ok, outs, readings


def main():
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for fn in (config1, lambda: config2(tmp), lambda: config3(tmp),
                   lambda: config4(tmp), lambda: config5(tmp)[:3]):
            name, snr, size_ok = fn()
            ok = passes(snr, size_ok)
            results.append((name, snr, ok))
            print(f"{'PASS' if ok else 'FAIL'}  {name:<42} SNR {snr:7.1f} dB",
                  file=sys.stderr)
    all_ok = all(r[2] for r in results)
    print(json.dumps({
        "conformance": "pass" if all_ok else "fail",
        "configs": [{"name": n, "snr_db": round(s, 1), "ok": o}
                    for n, s, o in results],
    }))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
