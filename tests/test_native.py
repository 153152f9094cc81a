"""Native C++ library: must agree with the NumPy oracle bit-for-bit."""

import numpy as np
import pytest

from doppler_tpu import oracle
from doppler_tpu.runtime import native

RNG = np.random.default_rng(0xC0)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def test_i16_decode_matches_oracle():
    buf = RNG.integers(-32768, 32768, size=2 * 5000, dtype=np.int16).astype("<i2").tobytes()
    want = oracle.decode_i16_bytes(buf)
    i, q = native.i16_to_planar(buf)
    np.testing.assert_array_equal(i, want.real)
    np.testing.assert_array_equal(q, want.imag)


def test_i16_encode_matches_oracle():
    x = np.concatenate([
        RNG.normal(scale=0.6, size=5000),
        [1.5, -1.5, 1.0, -1.0, 0.0, np.nan],
    ]).astype(np.float32)
    z = (x + 1j * x[::-1]).astype(np.complex64)
    want = oracle.encode_i16_bytes(z)
    got = native.planar_to_i16(z.real, z.imag).tobytes()
    assert got == want


def test_reference_mix_matches_numpy_oracle():
    n = 30000  # crosses the 9660.609375/256000 rounding reset at 20802
    x = (0.3 * (RNG.normal(size=n) + 1j * RNG.normal(size=n))).astype(np.complex64)
    want, want_sn = oracle.shift_frequency_oracle(x, 0, 9660.609375, 256000)
    oi, oq, sn = native.reference_mix(x.real, x.imag, 0, 9660.609375, 256000)
    assert sn == want_sn
    got = oi + 1j * oq
    # libm sinf/cosf vs numpy's sin/cos on f32 can differ by ≤1 ulp
    snr = oracle.snr_db(want, got)
    assert snr > 120.0, snr


def test_reference_mix_samplenum_thread():
    x = np.ones(4096, dtype=np.complex64)
    _, _, sn1 = native.reference_mix(x.real, x.imag, 0, -15000.0, 256000)
    _, want_sn = oracle.shift_frequency_oracle(x, 0, -15000.0, 256000)
    assert sn1 == want_sn


def test_load_always_runs_make(monkeypatch):
    """The library is rebuilt from the tracked sources in every process
    (``make`` is a no-op when up to date), so a stale build is never
    loaded just because it exists."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native._LIB_PATH.exists()
    native._load()
    assert calls and calls[0][:2] == ["make", "-C"]


@pytest.mark.parametrize("error", [
    native.subprocess.CalledProcessError(2, ["make"]),   # sources broken
    FileNotFoundError("make"),                            # no toolchain
])
def test_failed_build_ignores_an_old_library(monkeypatch, error):
    """A library left in native/build/ by an earlier build is not loaded
    when make fails: the NumPy fallback runs instead."""
    def fake_run(cmd, **kw):
        raise error

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native._LIB_PATH.exists()
    assert native.available() is False
    x = np.array([0.5, -0.25, 1.5, -2.0], dtype=np.float32)
    got = native.planar_to_i16(x, x[::-1]).tobytes()
    assert got == oracle.encode_i16_bytes((x + 1j * x[::-1]).astype(np.complex64))
