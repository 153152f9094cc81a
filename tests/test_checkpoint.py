"""Checkpoint/resume: restart mid-stream must reproduce the output bitwise."""

import io

import numpy as np

from doppler_tpu import oracle
from doppler_tpu.ops.resample import attach_resampler
from doppler_tpu.runtime import checkpoint
from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

RNG = np.random.default_rng(0xC4)
FS = 256000


def _mk_pipe(resample=False):
    p = Pipeline(FS, "i16", "i16", ConstScheduler(9660.609375), chunk_blocks=4)
    if resample:
        attach_resampler(p, 48000)
    return p


def _stream(n):
    raw = RNG.integers(-32768, 32768, size=2 * n, dtype=np.int16)
    return raw.astype("<i2").tobytes()


def _run(pipe, buf):
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    return out.getvalue()


def test_resume_mid_stream_bitwise(tmp_path):
    n = 2048 * 24  # crosses the samplenum rounding reset at 20802
    buf = _stream(n)
    whole = _run(_mk_pipe(), buf)

    cut = 2048 * 10 * 4  # byte offset at a chunk boundary
    p1 = _mk_pipe()
    first = _run(p1, buf[:cut])
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(ckpt, p1)

    p2 = _mk_pipe()
    meta = checkpoint.restore(ckpt, p2)
    assert meta["sample_offset"] == cut // 4
    second = _run(p2, buf[cut:])
    assert first + second == whole


def test_resume_with_resampler_bitwise(tmp_path):
    fs_pipe = _mk_pipe(resample=True)
    n = 2048 * 32
    buf = _stream(n)
    whole = _run(fs_pipe, buf)

    cut = 2048 * 12 * 4
    p1 = _mk_pipe(resample=True)
    first = _run(p1, buf[:cut])
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(ckpt, p1)

    p2 = _mk_pipe(resample=True)
    checkpoint.restore(ckpt, p2)
    second = _run(p2, buf[cut:])
    assert first + second == whole


def test_restore_rejects_mismatched_config(tmp_path):
    p1 = _mk_pipe()
    _run(p1, _stream(2048))
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(ckpt, p1)

    import pytest

    p_bad = Pipeline(512000, "i16", "i16", ConstScheduler(1.0))
    with pytest.raises(ValueError, match="samplerate"):
        checkpoint.restore(ckpt, p_bad)

    p_bad2 = _mk_pipe(resample=True)
    p_bad2.resampler = None
    checkpoint.restore(ckpt, p_bad2)  # no resampler on either side: fine

    p3 = _mk_pipe()
    checkpoint.save(ckpt, p3)
    p_needs = _mk_pipe(resample=True)
    # checkpoint without resampler state into pipeline with resampler:
    # allowed only if fresh; restore succeeds because has_resampler=False
    checkpoint.restore(ckpt, p_needs)


def test_resume_track_mode_bitwise(tmp_path):
    """Track-mode resume: scheduler staircase state (sample_count/dt) must
    restore so the resumed run continues the same Doppler curve bitwise."""
    from doppler_tpu.orbit import Observer, Predictor, Tle, TrackScheduler
    from doppler_tpu.orbit.tle import _checksum

    def fx(line):
        line = line.ljust(68)[:68]
        return line + str(_checksum(line))

    L1 = fx("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
    L2 = fx("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
    start = (2444514.48708465 - 2440587.5) * 86400.0 + 3600.0

    def mk():
        pred = Predictor(Tle.from_lines("T", L1, L2),
                         Observer(58.26541, 26.46667, 76.0))
        sched = TrackScheduler(pred, 437505000.0, 5000.0, FS, start,
                               telemetry=False)
        return Pipeline(FS, "i16", "i16", sched, chunk_blocks=8)

    n = 2048 * 280  # > 2 staircase steps
    buf = _stream(n)
    whole = _run(mk(), buf)

    cut = 2048 * 140 * 4
    p1 = mk()
    first = _run(p1, buf[:cut])
    ckpt = str(tmp_path / "trk.npz")
    checkpoint.save(ckpt, p1)
    p2 = mk()
    checkpoint.restore(ckpt, p2)
    second = _run(p2, buf[cut:])
    assert first + second == whole


def test_cli_single_process_resume_seeks_and_appends(tmp_path):
    """Single-process stream --load-state with --input/--output (round-5
    review find): the CLI must seek the capture to the checkpoint byte and
    APPEND to the output — previously it reprocessed from byte 0 with the
    restored mid-stream state and truncated the output."""
    import os
    import subprocess
    import sys

    import numpy as np

    rng = np.random.default_rng(0xCE)
    # 4 chunks of 16 blocks; first run sees a 2-chunk truncated copy
    chunk_bytes = 8192 * 16
    raw = rng.integers(-(1 << 15), 1 << 15, size=2 * 2048 * 16 * 4,
                       dtype=np.int64).astype("<i2").tobytes()
    full = tmp_path / "full.iq"
    full.write_bytes(raw)
    part = tmp_path / "part.iq"
    part.write_bytes(raw[: 2 * chunk_bytes])
    out = tmp_path / "out.iq"
    single = tmp_path / "single.iq"
    ck = tmp_path / "ck.npz"
    base = [sys.executable, "-m", "doppler_tpu.cli", "const",
            "-s", "1024000", "-i", "i16", "--shift", "-9000",
            "--resample-to", "48000", "--chunk-blocks", "16",
            "--platform", "cpu"]
    env = dict(os.environ)

    p = subprocess.run(base + ["--input", str(full), "--output", str(single)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]

    p = subprocess.run(base + ["--input", str(part), "--output", str(out),
                               "--save-state", str(ck)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]

    p = subprocess.run(base + ["--input", str(full), "--output", str(out),
                               "--load-state", str(ck)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert b"resumed at input sample" in p.stderr
    assert out.read_bytes() == single.read_bytes(), \
        "resumed output != uninterrupted run (seek/append broken)"


def test_cli_single_process_drained_resume_is_noop(tmp_path):
    """Single-process stream analog of the drained guard: --drain
    --save-state to EOF, then --load-state must be a no-op."""
    import os
    import subprocess
    import sys

    import numpy as np

    rng = np.random.default_rng(0xCF)
    raw = rng.integers(-(1 << 15), 1 << 15, size=2 * 2048 * 32,
                       dtype=np.int64).astype("<i2").tobytes()
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    out = tmp_path / "out.iq"
    ck = tmp_path / "ck.npz"
    base = [sys.executable, "-m", "doppler_tpu.cli", "const",
            "-s", "1024000", "-i", "i16", "--shift", "-9000",
            "--resample-to", "48000", "--drain", "--platform", "cpu",
            "--input", str(inp), "--output", str(out)]
    env = dict(os.environ)
    p = subprocess.run(base + ["--save-state", str(ck)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    first = out.read_bytes()
    p = subprocess.run(base + ["--load-state", str(ck)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert b"nothing to do" in p.stderr
    assert out.read_bytes() == first, "duplicate drain appended bytes"


def test_resume_f32_wire_bitwise(tmp_path):
    """f32 in/out through the resampler: a run cut at a chunk boundary and
    resumed is bitwise the uninterrupted run (the FIR history is f32 state
    independent of the wire format)."""
    fs = 1_024_000

    def mk():
        p = Pipeline(fs, "f32", "f32", ConstScheduler(9000.0),
                     chunk_blocks=4)
        attach_resampler(p, 48000)
        return p

    n = 1024 * 16
    buf = (0.4 * RNG.standard_normal(2 * n)).astype("<f4").tobytes()
    whole = _run(mk(), buf)

    cut = 8192 * 8  # chunk boundary (1024-sample blocks, 4-block chunks)
    p1 = mk()
    first = _run(p1, buf[:cut])
    ck = tmp_path / "f32.npz"
    checkpoint.save(str(ck), p1)
    p2 = mk()
    checkpoint.restore(str(ck), p2)
    second = _run(p2, buf[cut:])
    assert first + second == whole


def test_restore_rejects_changed_dsp_config(tmp_path):
    """Round-5 review find: the checkpoint must pin the DSP configuration
    (shift / track params / resample rate), not just the wire format — a
    resume with different flags previously produced output matching no
    uninterrupted run, silently."""
    import pytest

    p1 = _mk_pipe()
    _run(p1, _stream(2048))
    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(ckpt, p1)

    # different const shift
    p_bad = Pipeline(FS, "i16", "i16", ConstScheduler(3000.0), chunk_blocks=4)
    with pytest.raises(ValueError, match="scheduler config"):
        checkpoint.restore(ckpt, p_bad)

    # different resample rate
    p2 = _mk_pipe(resample=True)
    _run(p2, _stream(2048))
    checkpoint.save(ckpt, p2)
    p_bad2 = Pipeline(FS, "i16", "i16", ConstScheduler(9660.609375),
                      chunk_blocks=4)
    attach_resampler(p_bad2, 32000)
    with pytest.raises(ValueError, match="resampler config"):
        checkpoint.restore(ckpt, p_bad2)


def test_signal_stop_does_not_drain(tmp_path):
    """Round-5 review find: a should_stop (signal) break must NOT flush the
    FIR tail — that is an EOF-only action; draining mid-stream corrupted
    the output and poisoned the checkpoint's drained flag."""
    buf = _stream(2048 * 16)

    pfull = _mk_pipe(resample=True)
    pfull.drain_on_eof = True
    whole = _run(pfull, buf)

    p1 = _mk_pipe(resample=True)
    p1.drain_on_eof = True
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 2

    out = io.BytesIO()
    p1.run(io.BytesIO(buf), out, should_stop=stop)
    first = out.getvalue()
    assert not p1._drained
    assert whole.startswith(first) and len(first) < len(whole), \
        "mid-stream stop emitted non-prefix bytes (tail drained early?)"

    ck = str(tmp_path / "sig.npz")
    checkpoint.save(ck, p1)
    p2 = _mk_pipe(resample=True)
    p2.drain_on_eof = True
    meta = checkpoint.restore(ck, p2)
    consumed = meta["sample_offset"] * 4
    out2 = io.BytesIO()
    p2.run(io.BytesIO(buf[consumed:]), out2)
    assert first + out2.getvalue() == whole


def test_channels_signal_stop_does_not_drain():
    """Channels analog of the drain-on-signal fix."""
    from doppler_tpu.runtime.channels import (
        ChannelSpec,
        ConstScheduler as CConst,
        MultiChannelPipeline,
    )

    def mk():
        return MultiChannelPipeline(
            FS, "i16", "i16",
            [ChannelSpec(name="a", scheduler=CConst(-9000.0)),
             ChannelSpec(name="b", scheduler=CConst(4000.0))],
            out_rate=48000, chunk_blocks=4, drain_on_eof=True)

    buf = _stream(2048 * 16)
    writers = [io.BytesIO(), io.BytesIO()]
    mk().run(io.BytesIO(buf), writers)
    whole = [w.getvalue() for w in writers]

    mp = mk()
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 2

    writers2 = [io.BytesIO(), io.BytesIO()]
    mp.run(io.BytesIO(buf), writers2, should_stop=stop)
    assert not mp._drained
    for w, full in zip(writers2, whole):
        got = w.getvalue()
        assert full.startswith(got) and len(got) < len(full), \
            "channels mid-stream stop emitted non-prefix bytes"
