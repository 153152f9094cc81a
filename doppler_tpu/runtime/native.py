"""ctypes loader for the native host library (``native/``).

Provides zero-copy NumPy wrappers over the C++ codecs and the fast
bit-faithful reference NCO.  Falls back to pure NumPy when the library isn't
built — everything works without it; it's a host-throughput acceleration
(SURVEY §7 "host I/O becoming the bottleneck").

Built from the tracked sources by ``make -C native`` on first use in every
process (a no-op when ``native/build/`` is up to date).  Only a library that
``make`` has just confirmed is loaded: when the build fails (no compiler,
sources that no longer compile), an older library left in ``native/build/``
is ignored and the NumPy fallback runs, with a warning.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "i16_to_planar",
    "planar_to_i16",
    "reference_mix",
]

_REPO = Path(__file__).resolve().parent.parent.parent
_LIB_PATH = _REPO / "native" / "build" / "libdoppler_native.so"
_lib = None


def _build() -> bool:
    """``make -C native``; True when the library is up to date with the
    tracked sources."""
    try:
        subprocess.run(
            ["make", "-C", str(_REPO / "native")],
            capture_output=True, timeout=120, check=True,
        )
        return True
    except (OSError, subprocess.SubprocessError) as e:
        from doppler_tpu.runtime.telemetry import get_logger

        get_logger("native").warning(
            "native library build failed (%s); using the NumPy fallback",
            e.__class__.__name__)
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if _build() and _LIB_PATH.exists():
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.dt_i16_to_planar_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p]
            lib.dt_planar_f32_to_i16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
            lib.dt_reference_mix.restype = ctypes.c_uint32
            lib.dt_reference_mix.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.dt_reference_counter_blocks.restype = ctypes.c_uint32
            lib.dt_reference_counter_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
            _lib = lib
        except OSError:
            _lib = False
    else:
        _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def i16_to_planar(buf: bytes | np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """LE interleaved i16 bytes → planar (i, q) float32."""
    raw = np.frombuffer(buf, dtype="<i2") if isinstance(buf, (bytes, bytearray, memoryview)) else np.ascontiguousarray(buf, dtype="<i2")
    n = raw.size // 2
    raw = raw[: 2 * n]
    lib = _load()
    if lib:
        i = np.empty(n, dtype=np.float32)
        q = np.empty(n, dtype=np.float32)
        lib.dt_i16_to_planar_f32(
            raw.ctypes.data, n, i.ctypes.data, q.ctypes.data
        )
        return i, q
    x = raw.astype(np.float32) * np.float32(1.0 / 32768.0)
    return np.ascontiguousarray(x[0::2]), np.ascontiguousarray(x[1::2])


def planar_to_i16(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Planar float32 → interleaved LE i16 with reference cast semantics."""
    i = np.ascontiguousarray(i, dtype=np.float32)
    q = np.ascontiguousarray(q, dtype=np.float32)
    n = i.size
    lib = _load()
    out = np.empty(2 * n, dtype="<i2")
    if lib:
        lib.dt_planar_f32_to_i16(i.ctypes.data, q.ctypes.data, n, out.ctypes.data)
        return out

    def sat(v):
        v = np.trunc(v * np.float32(32767.0))
        v = np.where(np.isnan(v), np.float32(0.0), v)
        return np.clip(v, -32768.0, 32767.0).astype(np.int16)

    out[0::2] = sat(i)
    out[1::2] = sat(q)
    return out


def reference_mix(
    i: np.ndarray, q: np.ndarray, samplenum: int, shift_hz: float, samplerate: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Fast bit-faithful reference NCO (the dsp.rs:117-134 loop in C++).

    Falls back to the slow NumPy oracle when the library isn't available.
    """
    lib = _load()
    i = np.ascontiguousarray(i, dtype=np.float32)
    q = np.ascontiguousarray(q, dtype=np.float32)
    n = i.size
    if lib:
        oi = np.empty(n, dtype=np.float32)
        oq = np.empty(n, dtype=np.float32)
        sn = lib.dt_reference_mix(
            i.ctypes.data, q.ctypes.data, n,
            ctypes.c_uint32(samplenum), ctypes.c_float(shift_hz),
            ctypes.c_uint32(samplerate), oi.ctypes.data, oq.ctypes.data,
        )
        return oi, oq, int(sn)
    from doppler_tpu import oracle

    mixed, sn = oracle.shift_frequency_oracle(
        (i + 1j * q).astype(np.complex64), samplenum, shift_hz, samplerate
    )
    return mixed.real.copy(), mixed.imag.copy(), sn


def reference_counter_blocks(
    shifts: np.ndarray, counts: np.ndarray, samplenum: int, samplerate: int
) -> tuple[np.ndarray, int]:
    """Advance the reference's samplenum counter through a per-block shift
    schedule (counter-only dsp.rs:117-134 loop — the long-stream soak's
    golden model).  Returns ``(per_block_start_counters, end_counter)``.
    Requires the native library (no NumPy fallback: a 2^32-sample soak is
    not feasible at scalar-Python speed) — callers should skip when
    :func:`available` is False.
    """
    lib = _load()
    if not lib:
        raise RuntimeError("native library unavailable")
    shifts = np.ascontiguousarray(shifts, dtype=np.float32)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    out = np.empty(shifts.size, dtype=np.uint32)
    end = lib.dt_reference_counter_blocks(
        shifts.ctypes.data, counts.ctypes.data, shifts.size,
        ctypes.c_uint32(samplenum), ctypes.c_uint32(samplerate),
        out.ctypes.data,
    )
    return out, int(end)


# ---------------------------------------------------------------------------
# Native SGP4 (near-earth) — see native/src/sgp4_native.cpp
# ---------------------------------------------------------------------------

# dt_sgp4_propagate / dt_doppler_curve return codes → the same SGP4Error
# messages the pure-Python propagator raises (orbit/sgp4.py), so callers
# (CLI error handling, schedulers) see ONE exception type for "this TLE
# cannot be propagated to that time" regardless of backend.
_SGP4_RC = {
    -1: "invalid elements",
    -4: "orbit decayed during propagation",
    -5: "semi-latus rectum < 0",
    -6: "satellite decayed (r < 1 ER)",
}


def _sgp4_error(tle, rc: int):
    from doppler_tpu.orbit.sgp4 import SGP4Error

    why = _SGP4_RC.get(rc, f"propagation failed (rc {rc})")
    return SGP4Error(f"{tle.name!r}: {why}")


def _load_sgp4():
    lib = _load()
    if not lib:
        return None
    if not hasattr(lib, "_sgp4_ready"):
        try:
            lib.dt_sgp4_init.restype = ctypes.c_int
            lib.dt_sgp4_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.dt_sgp4_propagate.restype = ctypes.c_int
            lib.dt_sgp4_propagate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.dt_doppler_curve.restype = ctypes.c_int
            lib.dt_doppler_curve.argtypes = [
                ctypes.c_void_p, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib._sgp4_ready = True
        except AttributeError:
            return None
    return lib


class NativeSGP4:
    """C++ near-earth SGP4 + full Doppler-curve evaluation.

    Mirrors ``orbit.sgp4.SGP4`` / ``orbit.observer.Predictor.doppler_hz``;
    the Python and C++ implementations cross-validate each other in
    tests/test_native_sgp4.py.  Raises ``RuntimeError`` when the native
    library is unavailable or the satellite needs the (Python-only) SDP4
    deep-space path.
    """

    def __init__(self, tle):
        lib = _load_sgp4()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self.tle = tle
        self._ctx = np.zeros(64, dtype=np.float64)
        el = np.array(
            [tle.no_kozai, tle.ecco, tle.inclo, tle.nodeo, tle.argpo,
             tle.mo, tle.bstar, tle.epoch_jd, 0.0, 0.0], dtype=np.float64)
        rc = lib.dt_sgp4_init(el.ctypes.data, self._ctx.ctypes.data)
        if rc == -3:
            raise RuntimeError("deep-space satellite: use the Python SDP4 path")
        if rc:
            raise RuntimeError(f"dt_sgp4_init failed ({rc})")

    def propagate(self, tsince_min):
        t = np.ascontiguousarray(np.atleast_1d(tsince_min), dtype=np.float64)
        r = np.empty((t.size, 3), dtype=np.float64)
        v = np.empty((t.size, 3), dtype=np.float64)
        rc = self._lib.dt_sgp4_propagate(
            self._ctx.ctypes.data, t.ctypes.data, t.size,
            r.ctypes.data, v.ctypes.data)
        if rc:
            raise _sgp4_error(self.tle, rc)
        return r, v

    def doppler_curve(self, unix_s, lat_deg, lon_deg, alt_m, frequency_hz):
        """unix times → (doppler_hz, range_km, range_rate, az_deg, el_deg)."""
        ts = np.ascontiguousarray(np.atleast_1d(unix_s), dtype=np.float64)
        out = [np.empty(ts.size, dtype=np.float64) for _ in range(5)]
        rc = self._lib.dt_doppler_curve(
            self._ctx.ctypes.data, ctypes.c_double(self.tle.epoch_jd),
            ctypes.c_double(lat_deg), ctypes.c_double(lon_deg),
            ctypes.c_double(alt_m),
            ts.ctypes.data, ts.size, ctypes.c_double(frequency_hz),
            *[o.ctypes.data for o in out])
        if rc:
            raise _sgp4_error(self.tle, rc)
        return tuple(out)
