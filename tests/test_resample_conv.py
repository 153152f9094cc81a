"""The banded-matmul conv resampler as the product path.

``resample_conv_stream`` generalizes the benched windows-matmul to arbitrary
mid-stream alignment (full polyphase cycles + dynamic slicing, zero padding
feeding only discarded outputs).  Pinned here: oracle accuracy, bitwise
chunking-invariance, agreement with the gather formulation, and multistage
cascades running conv stages.
"""

import io

import numpy as np
import pytest

from doppler_tpu import oracle
from doppler_tpu.ops.multistage import make_resampler
from doppler_tpu.ops.resample import RationalResampler, resample_oracle

RNG = np.random.default_rng(0xC0)


def _stream(n):
    return (0.4 * (RNG.standard_normal(n) + 1j * RNG.standard_normal(n))
            ).astype(np.complex64)


def _run(rs, x, splits):
    outs, pos = [], 0
    for n in splits:
        yi, yq, m = rs.process(
            x.real[pos:pos + n].copy(), x.imag[pos:pos + n].copy(),
            n, M=rs.max_out_for(n))
        outs.append(np.asarray(yi)[..., :m] + 1j * np.asarray(yq)[..., :m])
        pos += n
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("P,Q", [(3, 64), (147, 160), (2, 1), (5, 13)])
def test_conv_matches_oracle_and_window(P, Q):
    n = 30000
    x = _stream(n)
    splits = [8192, 9000, n - 8192 - 9000]
    yc = _run(RationalResampler(Q * 1000, P * 1000, impl="conv"), x, splits)
    yw = _run(RationalResampler(Q * 1000, P * 1000, impl="window"), x, splits)
    rs = RationalResampler(Q * 1000, P * 1000, impl="conv")
    want = resample_oracle(x, P, Q, rs.bank)
    m = min(len(yc), len(want))
    assert np.abs(yc[:m] - want[:m]).max() < 1e-5
    assert len(yc) == len(yw)
    assert np.abs(yc - yw).max() < 1e-5      # two valid f32 evaluations


@pytest.mark.parametrize("P,Q", [(3, 64), (147, 160)])
def test_conv_bitwise_chunking_invariant(P, Q):
    """SURVEY §4c pinned invariant, now under the conv formulation: any
    chunking of the same stream produces identical bits."""
    n = 50000
    x = _stream(n)

    def run(splits):
        return _run(RationalResampler(Q * 1000, P * 1000, impl="conv"),
                    x, splits)

    a = run([n])
    for splits in ([8192] * 6 + [n - 6 * 8192],
                   [10000, 12345, 1, 7, n - 22353]):
        b = run(splits)
        assert a.view(np.float32).tobytes() == b.view(np.float32).tobytes()


def test_conv_batched_channels():
    C, n = 3, 20000
    xs = np.stack([_stream(n) for _ in range(C)])
    rs = RationalResampler(1024000, 48000, channels=C, impl="conv")
    yi, yq, m = rs.process(xs.real.copy(), xs.imag.copy(), n,
                           M=rs.max_out_for(n))
    y = np.asarray(yi)[:, :m] + 1j * np.asarray(yq)[:, :m]
    for c in range(C):
        want = resample_oracle(xs[c], rs.P, rs.Q, rs.bank)
        mm = min(m, len(want))
        assert np.abs(y[c, :mm] - want[:mm]).max() < 1e-5


def test_auto_impl_resolution():
    # wideband decimation: few bands -> conv
    assert RationalResampler(1024000, 48000).impl == "conv"
    # halfband-shaped (taps >> Q): gather wins
    hb = RationalResampler(96000, 48000, taps_per_phase=40)
    assert hb.impl == ("window" if (hb.Q - 1 + hb.T + hb.Q - 1) // hb.Q > 8
                       else "conv")


def test_multistage_conv_stages_match_window_stages():
    n = 65536
    x = _stream(n)
    mc = make_resampler(1024000, 8000.0, stages="multi", impl="conv")
    mw = make_resampler(1024000, 8000.0, stages="multi", impl="window")
    yi, yq, m1 = mc.process(x.real.copy(), x.imag.copy(), n)
    y1 = np.asarray(yi)[:m1] + 1j * np.asarray(yq)[:m1]
    yi, yq, m2 = mw.process(x.real.copy(), x.imag.copy(), n)
    y2 = np.asarray(yi)[:m2] + 1j * np.asarray(yq)[:m2]
    assert m1 == m2
    assert np.abs(y1 - y2).max() < 2e-5


def test_pipeline_resample_impl_flag_byte_level():
    """--resample-impl window/conv both hold the oracle contract; the
    emitted bytes differ by at most 1 LSB."""
    from doppler_tpu.ops.resample import attach_resampler
    from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

    raw = RNG.integers(-20000, 20000, size=2 * 70000, dtype=np.int16
                       ).astype("<i2").tobytes()

    def run(impl):
        pipe = Pipeline(1024000, "i16", "i16", ConstScheduler(-15000.0),
                        chunk_blocks=16)
        attach_resampler(pipe, 48000.0, impl=impl)
        out = io.BytesIO()
        pipe.run(io.BytesIO(raw), out)
        return out.getvalue()

    a = np.frombuffer(run("conv"), "<i2").astype(np.int32)
    b = np.frombuffer(run("window"), "<i2").astype(np.int32)
    assert a.size == b.size
    assert np.abs(a - b).max() <= 1
    snr = oracle.snr_db(b.astype(np.float64), a.astype(np.float64))
    assert snr > 80.0
