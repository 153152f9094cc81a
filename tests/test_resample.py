"""Polyphase resampler tests: filter quality, oracle equality, streaming."""

import io

import numpy as np
import pytest

from doppler_tpu import oracle as ref_oracle
from doppler_tpu.ops.filters import design_lowpass, design_polyphase_bank, kaiser_beta
from doppler_tpu.ops.resample import RationalResampler, resample_oracle
from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

RNG = np.random.default_rng(0x55)


def run_streaming(rs: RationalResampler, x: np.ndarray, chunk: int) -> np.ndarray:
    """Push x through the streaming resampler in fixed-size chunks."""
    outs = []
    M = rs.max_out_for(chunk)
    for s in range(0, len(x), chunk):
        blk = x[s : s + chunk]
        valid = len(blk)
        xi = np.zeros(chunk, dtype=np.float32)
        xq = np.zeros(chunk, dtype=np.float32)
        xi[:valid] = blk.real
        xq[:valid] = blk.imag
        yi, yq, n = rs.process(xi, xq, valid, M)
        outs.append(np.asarray(yi[:n]) + 1j * np.asarray(yq[:n]))
    return np.concatenate(outs) if outs else np.array([], np.complex64)


def test_lowpass_response():
    h = design_lowpass(256, 0.1, kaiser_beta(70.0))
    w = np.fft.rfftfreq(8192)
    H = np.abs(np.fft.rfft(h, 8192))
    passband = H[w < 0.07]
    stopband = H[w > 0.14]
    assert np.max(np.abs(20 * np.log10(passband))) < 0.1      # flat to 0.1 dB
    assert 20 * np.log10(np.max(stopband)) < -65.0            # ≥ 65 dB down


def test_bank_dc_gain():
    bank = design_polyphase_bank(3, 64, 16, 70.0)
    # each phase filter must pass DC with gain ~1 (sum of taps ≈ 1)
    np.testing.assert_allclose(bank.sum(axis=1), 1.0, atol=5e-3)


def test_streaming_matches_oracle_3_64():
    # BASELINE config 3 ratio: 1.024 Msps → 48 ksps = 3/64
    rs = RationalResampler(1024000, 48000)
    assert (rs.P, rs.Q) == (3, 64)
    x = (RNG.normal(size=40000) + 1j * RNG.normal(size=40000)).astype(np.complex64)
    got = run_streaming(rs, x, 8192)
    want = resample_oracle(x, rs.P, rs.Q, rs.bank)
    assert len(got) == len(want)
    snr = ref_oracle.snr_db(want, got)
    assert snr > 100.0, snr


def test_streaming_matches_oracle_interpolation():
    rs = RationalResampler(48000, 96000)  # 2/1 upsample
    x = (RNG.normal(size=5000) + 1j * RNG.normal(size=5000)).astype(np.complex64)
    got = run_streaming(rs, x, 1024)
    want = resample_oracle(x, rs.P, rs.Q, rs.bank)
    assert len(got) == len(want) == 10000
    assert ref_oracle.snr_db(want, got) > 100.0


def test_streaming_matches_oracle_awkward_ratio():
    rs = RationalResampler(1024000, 44100)  # P=441, Q=10240
    assert (rs.P, rs.Q) == (441, 10240)
    x = (RNG.normal(size=60000) + 1j * RNG.normal(size=60000)).astype(np.complex64)
    got = run_streaming(rs, x, 16384)
    want = resample_oracle(x, rs.P, rs.Q, rs.bank)
    assert len(got) == len(want)
    assert ref_oracle.snr_db(want, got) > 95.0


def test_chunk_size_invariance_bitwise():
    x = (RNG.normal(size=30000) + 1j * RNG.normal(size=30000)).astype(np.complex64)
    a = run_streaming(RationalResampler(1024000, 48000), x, 4096)
    b = run_streaming(RationalResampler(1024000, 48000), x, 7001)
    np.testing.assert_array_equal(a, b)


def test_tone_preserved_and_alias_rejected():
    fs_in, fs_out = 1024000, 48000
    rs = RationalResampler(fs_in, fs_out)
    n = 1 << 17
    t = np.arange(n) / fs_in
    tone = np.exp(2j * np.pi * 10000.0 * t)          # in the 24 kHz passband
    alias = 0.5 * np.exp(2j * np.pi * 100000.0 * t)  # far beyond Nyquist-out
    y = run_streaming(rs, (tone + alias).astype(np.complex64), 16384)
    y = y[len(y) // 4 :]  # skip transient
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    freqs = np.fft.fftfreq(len(y), 1.0 / fs_out)
    peak = freqs[int(np.argmax(spec))]
    assert abs(peak - 10000.0) < 25.0
    # alias folds to 100k − 2·48k = 4 kHz; measure rejection there
    tone_amp = spec[int(np.argmin(np.abs(freqs - 10000.0)))]
    alias_amp = spec[int(np.argmin(np.abs(freqs - 4000.0)))]
    assert 20 * np.log10(tone_amp / max(alias_amp, 1e-12)) > 60.0


def test_output_rate():
    rs = RationalResampler(1024000, 48000)
    x = np.zeros(1024000, dtype=np.complex64)  # 1 s of input
    y = run_streaming(rs, x, 65536)
    assert abs(len(y) - 48000) <= 1


def test_checkpoint_resume_bitwise():
    x = (RNG.normal(size=20000) + 1j * RNG.normal(size=20000)).astype(np.complex64)
    whole = run_streaming(RationalResampler(1024000, 48000), x, 5000)

    rs1 = RationalResampler(1024000, 48000)
    first = run_streaming(rs1, x[:10000], 5000)
    state = rs1.state_dict()
    rs2 = RationalResampler(1024000, 48000)
    rs2.load_state(state)
    second = run_streaming(rs2, x[10000:], 5000)
    np.testing.assert_array_equal(whole, np.concatenate([first, second]))


def test_pipeline_with_resampler_end_to_end():
    """const −15 kHz @ 1.024 Msps, f32 → resample to 48 k → i16 out."""
    fs_in, fs_out = 1024000, 48000
    n = 65536
    t = np.arange(n) / fs_in
    x = (0.5 * np.exp(2j * np.pi * (15000.0 + 5000.0) * t)).astype(np.complex64)
    buf = ref_oracle.encode_f32_bytes(x)

    pipe = Pipeline(fs_in, "f32", "i16", ConstScheduler(15000.0), chunk_blocks=4)
    from doppler_tpu.ops.resample import attach_resampler

    attach_resampler(pipe, fs_out)
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    y = ref_oracle.decode_i16_bytes(out.getvalue())
    assert abs(len(y) - n * 3 // 64) <= 2
    y = y[len(y) // 3 :]
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    freqs = np.fft.fftfreq(len(y), 1.0 / fs_out)
    # +20 kHz tone shifted down by 15 kHz → 5 kHz at the output rate
    assert abs(freqs[int(np.argmax(spec))] - 5000.0) < 30.0


def test_fast_path_matches_oracle():
    """Windows+matmul block formulation vs the NumPy oracle."""
    import jax.numpy as jnp

    from doppler_tpu.ops.resample import make_taps_matrix, resample_conv_block

    rs = RationalResampler(1024000, 48000)
    H = rs.T - 1
    N = 64 * 64
    x = (RNG.normal(size=N) + 1j * RNG.normal(size=N)).astype(np.complex64)
    xi = np.concatenate([np.zeros(H, np.float32), x.real.astype(np.float32)])
    xq = np.concatenate([np.zeros(H, np.float32), x.imag.astype(np.float32)])
    taps = jnp.asarray(make_taps_matrix(rs.bank, rs.P, rs.Q))
    yi, yq = resample_conv_block(
        jnp.asarray(xi), jnp.asarray(xq), taps, P=rs.P, Q=rs.Q, T=rs.T
    )
    got = np.asarray(yi) + 1j * np.asarray(yq)
    want = resample_oracle(x, rs.P, rs.Q, rs.bank)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6


def test_arbitrary_float_rate():
    """Non-integer target rates rationalize to sub-µHz accuracy (the
    liquid-dsp arbitrary-rate msresamp capability)."""
    rs = RationalResampler(1024000, 48000.5)
    assert abs(rs.P / rs.Q * 1024000 - 48000.5) < 1e-3
    x = (RNG.normal(size=20000) + 1j * RNG.normal(size=20000)).astype(np.complex64)
    y = run_streaming(rs, x, 8192)
    # rate check: outputs per input
    assert abs(len(y) / 20000 - 48000.5 / 1024000) < 1e-4

    rs2 = RationalResampler(1024000, 1024000 / 3.0)   # irrational-ish ratio
    assert abs(rs2.P / rs2.Q - 1 / 3.0) < 1e-9


def test_pipeline_drain_on_eof():
    """--drain flushes the FIR tail: total outputs ≈ ceil((n+T−1)·P/Q)."""
    fs_in, fs_out = 1024000, 48000
    n = 65536
    x = (0.3 * (RNG.normal(size=n) + 1j * RNG.normal(size=n))).astype(np.complex64)
    buf = ref_oracle.encode_f32_bytes(x)

    def run(drain):
        pipe = Pipeline(fs_in, "f32", "i16", ConstScheduler(0.0),
                        chunk_blocks=4, drain_on_eof=drain)
        from doppler_tpu.ops.resample import attach_resampler

        attach_resampler(pipe, fs_out)
        out = io.BytesIO()
        pipe.run(io.BytesIO(buf), out)
        return out.getvalue()

    plain = run(False)
    drained = run(True)
    rs = RationalResampler(fs_in, fs_out)
    extra = len(drained) // 4 - len(plain) // 4
    assert 0 < extra <= (rs.T - 1) * rs.P // rs.Q + 1
    # drained output must extend (not alter) the undrained prefix
    assert drained[: len(plain)] == plain
