"""Exact 64-bit fixed-point phase arithmetic on 32-bit integer lanes.

The reference NCO's emitted phase is a pure function of the absolute sample
index ``n`` (SURVEY §3.4; reference ``src/dsp.rs:117-134``):

    phase(n) = -2π · frac(r · n),   r = shift_hz / samplerate.

We represent ``frac(r)`` as an unsigned Q0.64 fixed-point word ``D`` and
compute ``(n · D) mod 2^64`` *exactly* with uint32 pair arithmetic — native
32-bit integer work on any accelerator, with no int64 or f64.  Modular
arithmetic makes the phase bit-identical regardless of how the sample axis
is sharded: any card computing sample ``n`` produces the same corrector, so
time-sharding needs **zero** communication for the mixer.

Accuracy: the only approximation is quantizing the rate to 2^-64 cycles.
Phase error after ``n`` samples is ≤ n·2^-65 cycles — below f32 resolution
for n < 2^40 (~3 hours of stream at 100 Msps per channel).  The reference's
own f32 phase error grows like ulp(r·n) and is orders of magnitude larger
(SURVEY §3.4 measures 6.5e-5 rad already at n ≤ 5000).
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

__all__ = [
    "rate_to_q64",
    "split_u64",
    "mul64_mod",
    "umulhi32",
    "phase_q32",
    "phase_cycles_f32",
]


def mul64_mod(n: int, d: int) -> int:
    """Host-side exact ``(n · d) mod 2^64`` (python ints)."""
    return (int(n) * int(d)) % (1 << 64)

_U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)


def rate_to_q64(shift_hz, samplerate, *, quantize_f32: bool = True) -> int:
    """Host-side: frequency ratio → unsigned Q0.64 phase increment.

    ``quantize_f32=True`` (default) first rounds ``shift_hz/samplerate`` to
    f32, mirroring the reference's ``shift_hz / samplerate as f32`` divide
    (dsp.rs:121) so long streams do not drift relative to the reference
    binary.  With integer inputs and ``quantize_f32=False`` the increment is
    the exactly-rounded rational ``frac(shift/fs)·2^64``.
    """
    if quantize_f32:
        r = float(np.float32(np.float32(shift_hz) / np.float32(samplerate)))
        frac = Fraction(r) % 1  # f64/f32 values are exact rationals
    else:
        frac = (Fraction(shift_hz) / Fraction(samplerate)) % 1
    d = round(frac * (1 << 64))
    return int(d % (1 << 64))


def split_u64(v: int) -> tuple[np.uint32, np.uint32]:
    """Host-side: 64-bit int → (hi32, lo32) numpy uint32 scalars."""
    v = int(v) % (1 << 64)
    return np.uint32(v >> 32), np.uint32(v & 0xFFFFFFFF)


def umulhi32(a, b):
    """High 32 bits of a 32×32→64 unsigned multiply, in pure uint32 ops.

    Replaces the reference's per-sample C FFI (``src/complex.c``) era with
    32-bit lane math: four 16×16 partial products with carry chaining.
    """
    a = a.astype(_U32)
    b = b.astype(_U32)
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16

    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi

    mid = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def phase_q32(n_hi, n_lo, d_hi, d_lo):
    """Bits 63..32 of ``(n · D) mod 2^64`` — the phase in Q0.32 cycles.

    ``n = n_hi·2^32 + n_lo`` is the absolute sample index, ``D`` the Q0.64
    increment from :func:`rate_to_q64`.  With n·D = n_lo·d_lo
    + (n_lo·d_hi + n_hi·d_lo)·2^32 (mod 2^64), the top word is
    ``umulhi(n_lo, d_lo) + n_lo·d_hi + n_hi·d_lo`` (mod 2^32) — exact.
    """
    n_hi = jnp.asarray(n_hi).astype(_U32)
    n_lo = jnp.asarray(n_lo).astype(_U32)
    d_hi = jnp.asarray(d_hi).astype(_U32)
    d_lo = jnp.asarray(d_lo).astype(_U32)
    return umulhi32(n_lo, d_lo) + n_lo * d_hi + n_hi * d_lo


def phase_cycles_f32(q32):
    """Q0.32 phase word → f32 cycles in [0, 1).

    Keeps the top 24 bits (f32 mantissa); resulting phase resolution is
    2^-24 cycles ≈ 3.7e-7 rad, far below the reference's f32 noise floor.
    """
    return q32.astype(jnp.float32) * jnp.float32(2.0 ** -32)
