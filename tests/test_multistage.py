"""Multi-stage halfband-cascade resampler (ops.multistage)."""

import io

import numpy as np
import pytest

from doppler_tpu import oracle
from doppler_tpu.ops.multistage import (
    MultiStageResampler,
    halfband_taps_needed,
    make_resampler,
)
from doppler_tpu.ops.resample import RationalResampler

RNG = np.random.default_rng(0x35)
FS = 1024000


def run_stream(rs, x, chunk):
    """Feed complex x through a streaming resampler in `chunk`-sample pieces."""
    outs = []
    for k in range(0, len(x), chunk):
        piece = x[k : k + chunk]
        pad = chunk - len(piece)
        i = np.pad(piece.real.astype(np.float32), (0, pad))
        q = np.pad(piece.imag.astype(np.float32), (0, pad))
        yi, yq, n = rs.process(i, q, len(piece), rs.max_out_for(chunk))
        yi = np.asarray(yi)[..., :n]
        yq = np.asarray(yq)[..., :n]
        outs.append(yi + 1j * yq)
    return np.concatenate(outs)


def test_structure_and_tap_savings():
    ms = MultiStageResampler(FS, 48000)
    # 1.024M → 128k via one greedy ÷8 stage (round 4: larger stage factors
    # cut the fused kernel's MACs ~2.3× vs the classic 3-halfband chain),
    # then 3/8 rational
    assert len(ms.stages) == 2
    assert (ms.stages[0].P, ms.stages[0].Q) == (1, 8)
    assert (ms.stages[-1].P, ms.stages[-1].Q) == (3, 8)
    assert (ms.P, ms.Q) == (3, 64)
    # heavy front: 100M → 48k factors its ÷256 into just two ÷16 stages
    heavy = MultiStageResampler(100_000_000, 48000)
    assert [(st.P, st.Q) for st in heavy.stages] == [
        (1, 16), (1, 16), (384, 3125)]
    assert all(st.T <= 129 for st in heavy.stages[:-1])
    single = RationalResampler(FS, 48000)
    # the cascade's win: no stage carries a long filter — per-stage taps
    # memory, FIR history, and carry rows stay small even for huge ratios
    # (single-stage taps-per-phase grows with max(P,Q); each cascade stage
    # is bounded by its own gentle transition)
    assert max(st.T for st in ms.stages) < single.T // 4
    total_single = single.T * single.P           # prototype length
    total_multi = sum(st.T * st.P for st in ms.stages)
    assert total_multi < total_single            # less filter memory overall


def test_passband_tone_preserved_stopband_rejected():
    n = 1 << 17
    t = np.arange(n)
    ms = MultiStageResampler(FS, 48000)
    # passband tone (10 kHz < 24 kHz output Nyquist)
    x = np.exp(2j * np.pi * 10000.0 / FS * t).astype(np.complex64)
    y = run_stream(ms, x, n)
    settle = ms.T * 48 // FS + 64
    core = y[settle:-settle] if settle else y
    amp = np.abs(core)
    assert abs(np.mean(amp) - 1.0) < 0.01
    # the tone frequency is preserved
    sp = np.fft.fft(core)
    f_peak = np.fft.fftfreq(core.size, d=1.0 / 48000)[np.argmax(np.abs(sp))]
    assert abs(f_peak - 10000.0) < 48000 / core.size * 2

    # stopband tone (200 kHz, far above output Nyquist): attenuated ≥ 55 dB
    xs = np.exp(2j * np.pi * 200000.0 / FS * t).astype(np.complex64)
    ys = run_stream(MultiStageResampler(FS, 48000), xs, n)
    rms = np.sqrt(np.mean(np.abs(ys[settle:]) ** 2))
    assert 20 * np.log10(max(rms, 1e-12)) < -55.0


def test_chunked_equals_oneshot():
    n = 1 << 15
    x = (RNG.normal(size=n) + 1j * RNG.normal(size=n)).astype(np.complex64)
    whole = run_stream(MultiStageResampler(FS, 48000), x, n)
    split = run_stream(MultiStageResampler(FS, 48000), x, 4096)
    assert whole.size == split.size
    np.testing.assert_allclose(split, whole, atol=1e-6)


def test_output_count_matches_rate():
    ms = MultiStageResampler(FS, 48000)
    n = FS  # one second
    got = ms.out_count_for(n)
    assert abs(got - 48000) <= 1


def test_state_roundtrip_resumes_bitwise():
    n = 1 << 15
    x = (RNG.normal(size=n) + 1j * RNG.normal(size=n)).astype(np.complex64)
    ref = run_stream(MultiStageResampler(FS, 48000), x, 4096)

    a = MultiStageResampler(FS, 48000)
    first = run_stream(a, x[: n // 2], 4096)
    state = a.state_dict()
    b = MultiStageResampler(FS, 48000)
    b.load_state({k: np.asarray(v) for k, v in state.items()})
    second = run_stream(b, x[n // 2 :], 4096)
    resumed = np.concatenate([first, second])
    assert resumed.size == ref.size
    np.testing.assert_array_equal(resumed, ref)


def test_channels_batch_matches_single():
    n = 1 << 14
    C = 3
    xs = (RNG.normal(size=(C, n)) + 1j * RNG.normal(size=(C, n))).astype(
        np.complex64
    )
    ms = MultiStageResampler(FS, 48000, channels=C)
    i = xs.real.astype(np.float32)
    q = xs.imag.astype(np.float32)
    yi, yq, n_out = ms.process(i, q, n, None)
    batch = np.asarray(yi)[:, :n_out] + 1j * np.asarray(yq)[:, :n_out]
    for c in range(C):
        single = run_stream(MultiStageResampler(FS, 48000), xs[c], n)
        np.testing.assert_allclose(batch[c], single[:n_out], atol=1e-6)


def test_make_resampler_selection():
    assert isinstance(make_resampler(FS, 48000, stages="single"),
                      RationalResampler)
    assert isinstance(make_resampler(FS, 48000, stages="auto"),
                      MultiStageResampler)
    # light decimation: auto stays single-stage
    assert isinstance(make_resampler(48000, 44100, stages="auto"),
                      RationalResampler)
    assert isinstance(make_resampler(FS, 48000, stages="multi"),
                      MultiStageResampler)
    with pytest.raises(ValueError, match="single|auto|multi"):
        make_resampler(FS, 48000, stages="bogus")
    with pytest.raises(ValueError, match="decimation-only"):
        MultiStageResampler(48000, 96000)


def test_halfband_taps_monotonic():
    # later (lower-rate) stages need more taps: narrower relative transition
    t1 = halfband_taps_needed(1024000, 24000, 70.0)
    t3 = halfband_taps_needed(256000, 24000, 70.0)
    assert t3 > t1
    assert t1 % 2 == 1 and t3 % 2 == 1


def test_pipeline_cli_multistage(tmp_path):
    """End-to-end: const + --resample-stages multi through the CLI."""
    import subprocess
    import sys

    n = 8192 * 8
    raw = RNG.integers(-20000, 20000, size=2 * n, dtype=np.int16)
    buf = raw.astype("<i2").tobytes()
    p = subprocess.run(
        [sys.executable, "-m", "doppler_tpu.cli", "const", "-s", str(FS),
         "-i", "i16", "--shift", "9000", "--resample-to", "48000",
         "--resample-stages", "multi", "--platform", "cpu"],
        input=buf, capture_output=True,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    y = oracle.decode_i16_bytes(p.stdout)
    assert abs(y.size - n * 3 // 64) <= 2
    # compare against the single-stage output in the passband sense: both are
    # 70 dB anti-aliased decimators, so broadband noise energy should agree
    p2 = subprocess.run(
        [sys.executable, "-m", "doppler_tpu.cli", "const", "-s", str(FS),
         "-i", "i16", "--shift", "9000", "--resample-to", "48000",
         "--platform", "cpu"],
        input=buf, capture_output=True,
    )
    y2 = oracle.decode_i16_bytes(p2.stdout)
    r1 = np.sqrt(np.mean(np.abs(y) ** 2))
    r2 = np.sqrt(np.mean(np.abs(y2) ** 2))
    assert abs(r1 - r2) / r2 < 0.02


# ---------------------------------------------------------------------------
# The cascade inside the streaming pipeline: against the golden model
# (reference mix + per-stage polyphase oracle), across chunk widths,
# checkpoints and seeks, for integer and odd-Q (split) rates.


def _mk_pipe(fs=FS, out_rate=48000, chunk=8, shift=9000.0, intype="i16",
             outtype="i16", stages="multi"):
    from doppler_tpu.ops.resample import attach_resampler
    from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

    p = Pipeline(fs, intype, outtype, ConstScheduler(shift),
                 chunk_blocks=chunk)
    attach_resampler(p, out_rate, stages=stages)
    return p


def _run_bytes(pipe, raw):
    out = io.BytesIO()
    pipe.run(io.BytesIO(raw), out)
    return out.getvalue()


def _i16_raw(n, seed):
    return np.random.default_rng(seed).integers(
        -9000, 9000, size=2 * n, dtype=np.int16).astype("<i2").tobytes()


def _golden(raw, fs, shift, stages, intype="i16"):
    """Reference mix of the whole stream, then every stage's oracle."""
    from doppler_tpu.ops.resample import resample_oracle
    from doppler_tpu.runtime import native

    x = (oracle.decode_i16_bytes(raw) if intype == "i16"
         else oracle.decode_f32_bytes(raw))
    i, q, _ = native.reference_mix(x.real, x.imag, 0, shift, fs)
    z = i.astype(np.complex128) + 1j * q
    for st in stages:
        z = resample_oracle(z, st.P, st.Q, st.bank)
    return z.astype(np.complex64)


def _score(got, want, outtype):
    """SNR of the pipeline bytes against the golden model at the output
    format; lengths must be identical."""
    if outtype == "i16":
        got_c = oracle.decode_i16_bytes(got)
        want_c = oracle.decode_i16_bytes(oracle.encode_i16_bytes(want))
    else:
        got_c = oracle.decode_f32_bytes(got)
        want_c = want
    assert got_c.size == want_c.size > 0
    return oracle.snr_db(want_c, got_c)


def test_pipeline_cascade_chunk_width_bitwise():
    """The cascade's output does not depend on how many blocks form a
    device dispatch (ragged tail included)."""
    raw = _i16_raw(2048 * 33 + 500, 0x77)
    a = _run_bytes(_mk_pipe(chunk=8), raw)
    for chunk in (4, 3, 16):
        assert _run_bytes(_mk_pipe(chunk=chunk), raw) == a, chunk
    want = _golden(raw, FS, 9000.0, MultiStageResampler(FS, 48000).stages)
    assert _score(a, want, "i16") > 60.0


def test_pipeline_cascade_checkpoint_resume_bitwise(tmp_path):
    from doppler_tpu.runtime import checkpoint

    raw = _i16_raw(2048 * 32, 0x88)
    whole = _run_bytes(_mk_pipe(), raw)
    half = len(raw) // 2
    p1 = _mk_pipe()
    part1 = _run_bytes(p1, raw[:half])
    ck = str(tmp_path / "casc.npz")
    checkpoint.save(ck, p1)
    p2 = _mk_pipe()
    checkpoint.restore(ck, p2)
    part2 = _run_bytes(p2, raw[half:])
    assert part1 + part2 == whole


@pytest.mark.parametrize("outtype", ["f32", "i16"])
def test_cascade_f32_formats(outtype):
    """f32 input through the cascade, to f32 and to i16, against the
    golden model (>70 dB at f32 output: exact f32 products throughout)."""
    n = 1024 * 16 * 3
    raw = (0.4 * np.random.default_rng(0x99).standard_normal(2 * n)
           ).astype("<f4").tobytes()
    got = _run_bytes(_mk_pipe(intype="f32", outtype=outtype), raw)
    want = _golden(raw, FS, 9000.0, MultiStageResampler(FS, 48000).stages,
                   intype="f32")
    assert _score(got, want, outtype) > (70.0 if outtype == "f32" else 60.0)


def test_odd_q_rate_eligibility_story():
    """Rates whose reduced Q is odd (250 ksps → 48 k, Q=125): 'auto'
    routes the ~5.2x decimation through the cascade (÷2 front, odd-Q
    rational tail), 'single' keeps one polyphase stage; both produce a
    48 k stream of the same length up to filter delay."""
    from doppler_tpu.ops.resample import RationalResampler

    fs2 = 250000
    rs = RationalResampler(fs2, 48000)
    assert rs.Q == 125
    raw = _i16_raw(2048 * 8, 0xAA)
    p_auto = _mk_pipe(fs=fs2, chunk=4, shift=5000.0, stages="auto")
    a = _run_bytes(p_auto, raw)
    stages = p_auto.resampler.stages
    assert [st.Q for st in stages] == [2, 125]
    p_single = _mk_pipe(fs=fs2, chunk=4, shift=5000.0, stages="single")
    b = _run_bytes(p_single, raw)
    assert getattr(p_single.resampler, "stages", None) is None
    assert abs(len(a) - len(b)) <= 4 * 8
    assert len(a) > 0 and len(b) > 0


def _mk_split(fs, chunk=8):
    return _mk_pipe(fs=fs, chunk=chunk, shift=5000.0)


@pytest.mark.parametrize("fs", [250000, 6250000])
def test_split_cascade_matches_oracle(fs):
    """Q=125-class and Q=3125-class (config 5's own tail) rates: the odd-Q
    cascade matches the golden model and is chunk-width bitwise."""
    raw = _i16_raw(2048 * 24 + 300, 0xAB ^ fs)
    pa = _mk_split(fs)
    a = _run_bytes(pa, raw)
    assert pa.resampler.stages[-1].Q % 2 == 1      # odd-Q tail
    assert _run_bytes(_mk_split(fs, chunk=4), raw) == a
    assert _score(a, _golden(raw, fs, 5000.0, pa.resampler.stages),
                  "i16") > 60.0


def test_split_cascade_checkpoint_resume_bitwise(tmp_path):
    from doppler_tpu.runtime import checkpoint

    fs = 250000
    raw = _i16_raw(2048 * 32, 0xCE)
    whole = _run_bytes(_mk_split(fs), raw)
    half = len(raw) // 2
    p1 = _mk_split(fs)
    part1 = _run_bytes(p1, raw[:half])
    ck = str(tmp_path / "split.npz")
    checkpoint.save(ck, p1)
    p2 = _mk_split(fs)
    checkpoint.restore(ck, p2)
    part2 = _run_bytes(p2, raw[half:])
    assert part1 + part2 == whole


def test_split_cascade_seek_resumes_bitwise():
    fs = 250000
    bb = 8192
    raw = _i16_raw(2048 * 32, 0xCF)
    whole = _run_bytes(_mk_split(fs), raw)
    k = 16
    n_in = k * 2048
    p2 = _mk_split(fs)
    for st in p2.resampler.stages:
        n_in = -(-n_in * st.P // st.Q)
    h = p2.seek_history_blocks()
    p2.seek_to_block(k, history=raw[(k - h) * bb:k * bb])
    out = io.BytesIO()
    p2.run(io.BytesIO(raw[k * bb:]), out)
    assert out.getvalue() == whole[n_in * 4:] and out.getvalue()


@pytest.mark.parametrize("fs,out_rate", [
    (2_400_000, 48000),    # ÷16 front, 8/25 tail (Q=25)
    (768_000, 32000),      # ÷8 front, 1/3 tail (Q=3)
    (5_000_000, 125000),   # ÷8·÷2 front, 2/5 tail (Q=5)
])
def test_split_cascade_arbitrary_rates(fs, out_rate):
    """Rate fuzz for odd-Q tails behind different greedy fronts: each
    matches the golden model and is chunk-width bitwise."""
    ms = MultiStageResampler(fs, out_rate)
    assert ms.stages[-1].Q % 2 == 1          # odd-Q tail by construction
    raw = _i16_raw(2048 * 16, fs ^ out_rate)
    shift = fs / 100.0
    a = _run_bytes(_mk_pipe(fs=fs, out_rate=out_rate, shift=shift), raw)
    b = _run_bytes(_mk_pipe(fs=fs, out_rate=out_rate, shift=shift, chunk=4),
                   raw)
    assert a == b
    assert _score(a, _golden(raw, fs, shift, ms.stages), "i16") > 60.0


def test_split_cascade_f32_formats():
    """f32 wire formats through the odd-Q cascade, to f32 and to i16,
    against the golden model."""
    fs = 250000
    raw = (0.4 * np.random.default_rng(0xF5).standard_normal(
        2 * 1024 * 16 * 4)).astype("<f4").tobytes()
    for outtype in ("f32", "i16"):
        p = _mk_pipe(fs=fs, chunk=16, shift=5000.0, intype="f32",
                     outtype=outtype)
        got = _run_bytes(p, raw)
        want = _golden(raw, fs, 5000.0, p.resampler.stages, intype="f32")
        bar = 70.0 if outtype == "f32" else 60.0
        assert _score(got, want, outtype) > bar, outtype
