"""End-to-end const-mode tests: Pipeline + CLI vs the reference oracle."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from doppler_tpu import oracle
from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

RNG = np.random.default_rng(0xE2E)
FS = 256000


def make_f32_stream(n):
    x = (0.3 * (RNG.normal(size=n) + 1j * RNG.normal(size=n))).astype(np.complex64)
    return oracle.encode_f32_bytes(x), x


def make_i16_stream(n):
    raw = RNG.integers(-32768, 32768, size=2 * n, dtype=np.int16)
    return raw.astype("<i2").tobytes(), oracle.decode_i16_bytes(raw.tobytes())


def oracle_const(buf, intype, outtype, shift, fs):
    """Reference binary semantics for const mode over the whole stream."""
    dec = oracle.decode_i16_bytes if intype == "i16" else oracle.decode_f32_bytes
    enc = oracle.encode_i16_bytes if outtype == "i16" else oracle.encode_f32_bytes
    mixed, _ = oracle.shift_frequency_oracle(dec(buf), 0, shift, fs)
    return enc(mixed)


def run_pipeline(buf, intype, outtype, shift, fs=FS, chunk_blocks=4):
    pipe = Pipeline(fs, intype, outtype, ConstScheduler(shift),
                    chunk_blocks=chunk_blocks)
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    return out.getvalue()


def test_const_f32_to_i16_matches_oracle():
    # BASELINE config 1: const -15 kHz, f32 in, i16 out.
    buf, _ = make_f32_stream(3000)  # 24000 bytes: 2 full blocks + tail
    got = run_pipeline(buf, "f32", "i16", -15000.0)
    want = oracle_const(buf, "f32", "i16", -15000.0, FS)
    assert len(got) == len(want)
    snr = oracle.snr_db(oracle.decode_i16_bytes(want), oracle.decode_i16_bytes(got))
    assert snr > 60.0, snr
    # and the vast majority of i16 words should be bit-identical
    same = np.mean(
        np.frombuffer(got, dtype="<i2") == np.frombuffer(want, dtype="<i2")
    )
    assert same > 0.9, same


def test_const_i16_to_i16_matches_oracle():
    buf, _ = make_i16_stream(5000)
    got = run_pipeline(buf, "i16", "i16", 5000.0)
    want = oracle_const(buf, "i16", "i16", 5000.0, FS)
    assert len(got) == len(want)
    snr = oracle.snr_db(oracle.decode_i16_bytes(want), oracle.decode_i16_bytes(got))
    assert snr > 60.0, snr


def test_const_i16_to_f32_roundtrip_types():
    buf, x = make_i16_stream(2048)
    got = run_pipeline(buf, "i16", "f32", 0.0)
    # zero shift: output f32 must equal decoded input exactly
    np.testing.assert_array_equal(oracle.decode_f32_bytes(got), x)


def test_chunk_width_invariance():
    # Output must not depend on how many blocks form a device dispatch.
    buf, _ = make_f32_stream(6000)
    a = run_pipeline(buf, "f32", "f32", -12345.6, chunk_blocks=1)
    b = run_pipeline(buf, "f32", "f32", -12345.6, chunk_blocks=7)
    assert a == b


def test_empty_stream():
    assert run_pipeline(b"", "i16", "i16", 1000.0) == b""


def test_single_partial_block():
    buf, _ = make_i16_stream(10)
    got = run_pipeline(buf, "i16", "i16", 1000.0)
    want = oracle_const(buf, "i16", "i16", 1000.0, FS)
    assert len(got) == len(want) == 40


def test_cli_const_subprocess():
    """Full process-boundary check: bytes | python -m doppler_tpu | bytes."""
    buf, _ = make_f32_stream(2500)
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu", "const",
         "-s", str(FS), "-i", "f32", "-o", "i16",
         "--shift", "-15000", "--platform", "cpu", "--chunk-blocks", "4"],
        input=buf, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    want = run_pipeline(buf, "f32", "i16", -15000.0)
    assert proc.stdout == want
    # telemetry goes to stderr only
    assert b"constant shift mode" in proc.stderr


def test_cli_bad_location_errors():
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu", "track",
         "-s", "256000", "-i", "i16", "--tlefile", "/nonexistent",
         "--tlename", "X", "--location", "not-a-location",
         "--frequency", "437505000", "--platform", "cpu"],
        input=b"", stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        timeout=120,
    )
    assert proc.returncode == 1
    assert b"location" in proc.stderr.lower()


def test_cli_outtype_defaults_to_intype():
    """usage.rs:268-270: omitted -o means outtype = intype."""
    buf, x = make_i16_stream(1024)
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu", "const",
         "-s", str(FS), "-i", "i16", "--shift", "0",
         "--platform", "cpu", "--chunk-blocks", "2"],
        input=buf, stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    assert len(proc.stdout) == len(buf)          # still i16 (4 B/sample)
    got = oracle.decode_i16_bytes(proc.stdout)
    want = oracle.decode_i16_bytes(oracle.encode_i16_bytes(x))
    np.testing.assert_array_equal(got, want)      # zero shift: roundtrip only


def test_attach_resampler_keeps_float_rate():
    from doppler_tpu.ops.resample import attach_resampler

    pipe = Pipeline(1024000, "i16", "i16", ConstScheduler(0.0))
    attach_resampler(pipe, 11025.5)
    rs = pipe.resampler
    assert rs.out_rate == 11025.5
    assert abs(rs.P / rs.Q * 1024000 - 11025.5) < 1e-3


def test_cli_chunk_blocks_auto_and_impl_auto():
    """--chunk-blocks auto resolves on CPU and produces the same bytes as an
    explicit block count (the device formulation is not a flag)."""
    import subprocess
    import sys

    n = 8192 * 3
    raw = np.random.default_rng(11).integers(
        -20000, 20000, size=2 * n, dtype=np.int16
    )
    buf = raw.astype("<i2").tobytes()
    base = [sys.executable, "-m", "doppler_tpu.cli", "const", "-s", "256000",
            "-i", "i16", "--shift", "-15000", "--platform", "cpu"]
    a = subprocess.run(base + ["--chunk-blocks", "auto"], input=buf,
                       capture_output=True)
    assert a.returncode == 0, a.stderr.decode()[-2000:]
    b = subprocess.run(base + ["--chunk-blocks", "64"],
                       input=buf, capture_output=True)
    assert a.stdout == b.stdout


def test_cli_chunk_blocks_rejects_garbage():
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "-m", "doppler_tpu.cli", "const", "-s", "256000",
         "-i", "i16", "--shift", "0", "--chunk-blocks", "-3",
         "--platform", "cpu"],
        input=b"", capture_output=True,
    )
    assert p.returncode == 1
    assert b"chunk-blocks" in p.stderr




def _resample_golden(buf, intype, shift, fs, rs, tail_zeros=0):
    """Reference mix of the stream, then the single-stage oracle."""
    from doppler_tpu.ops.resample import resample_oracle
    from doppler_tpu.runtime import native

    x = (oracle.decode_i16_bytes(buf) if intype == "i16"
         else oracle.decode_f32_bytes(buf))
    i, q, _ = native.reference_mix(x.real, x.imag, 0, shift, fs)
    z = np.concatenate([i + 1j * q.astype(np.complex128),
                        np.zeros(tail_zeros, np.complex128)])
    return resample_oracle(z, rs.P, rs.Q, rs.bank).astype(np.complex64)


@pytest.mark.parametrize("intype,outtype",
                         [("i16", "i16"), ("i16", "f32"),
                          ("f32", "i16"), ("f32", "f32")])
def test_resample_wire_formats_match_oracle(intype, outtype):
    """Every wire-format pair through mix + single-stage resample, across
    chunks and a ragged tail, against the golden model (f32 output keeps
    the >70 dB exact-product contract)."""
    from doppler_tpu.ops.resample import attach_resampler

    fs = 1024000
    bps = 4 if intype == "i16" else 8
    n = (8192 // bps) * 17 + 300
    if intype == "i16":
        buf, _ = make_i16_stream(n)
    else:
        buf, _ = make_f32_stream(n)
    pipe = Pipeline(fs, intype, outtype, ConstScheduler(9000.0),
                    chunk_blocks=8)
    attach_resampler(pipe, 48000, stages="single")
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    want = _resample_golden(buf, intype, 9000.0, fs, pipe.resampler)
    if outtype == "i16":
        got = oracle.decode_i16_bytes(out.getvalue())
        want = oracle.decode_i16_bytes(oracle.encode_i16_bytes(want))
        bar = 60.0
    else:
        got = oracle.decode_f32_bytes(out.getvalue())
        bar = 70.0
    assert got.size == want.size
    assert oracle.snr_db(want, got) > bar


def test_resample_drain_after_partial_tail_matches_oracle():
    """--drain after an EOF-padded chunk flushes exactly the T−1-zero tail
    of the golden model: padding never reaches the FIR history."""
    from doppler_tpu.ops.resample import attach_resampler

    fs = 1024000
    buf, _ = make_i16_stream(2048 * 5)   # 5 blocks in an 8-block chunk
    pipe = Pipeline(fs, "i16", "f32", ConstScheduler(9000.0),
                    chunk_blocks=8, drain_on_eof=True)
    attach_resampler(pipe, 48000, stages="single")
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    rs = pipe.resampler
    want = _resample_golden(buf, "i16", 9000.0, fs, rs, tail_zeros=rs.T - 1)
    got = oracle.decode_f32_bytes(out.getvalue())
    assert got.size == want.size
    assert oracle.snr_db(want, got) > 70.0
