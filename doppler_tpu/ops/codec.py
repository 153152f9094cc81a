"""IQ format codecs — device-side (jnp) and host-side (NumPy staging).

Reproduces the reference's IQ wire formats exactly (SURVEY §2 #3-4):

- **i16**: little-endian interleaved int16 pairs; decode scales by 1/32768
  (reference ``src/dsp.rs:85-99``), encode multiplies by 32767 and applies
  Rust's saturating truncate-toward-zero float→i16 cast
  (``src/main.rs:76-84``).  The deliberate 32768-in / 32767-out asymmetry
  (a ~1−1/32768 gain) and the truncation are part of the SNR contract.
- **f32**: little-endian interleaved float32 pairs, raw bit image
  (``src/dsp.rs:101-115``, ``src/main.rs:89-93``).

Device representation: **planar IQ** — separate ``(…, N)`` float32 arrays
for I and Q.  Interleaved complex layouts force stride-2 access; planar
arrays keep the last axis dense.  On the wire an i16 IQ pair is
exactly one little-endian int32 word, so device decode is a bitwise unpack of
an int32 vector (no strided gather): ``i = (w << 16) >> 16`` (sign-extended
low half), ``q = w >> 16`` (arithmetic shift).  Encode is the inverse pack.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "i16_words_to_iq",
    "iq_to_i16_words",
    "f32_pairs_to_iq",
    "iq_to_f32_pairs",
    "bytes_to_i16_words",
    "i16_words_to_bytes",
    "bytes_to_f32_pairs",
    "f32_pairs_to_bytes",
    "saturating_trunc_i16",
]

_INV_32768 = np.float32(1.0 / 32768.0)  # exact power of two
_SCALE_OUT = np.float32(32767.0)


# ---------------------------------------------------------------------------
# Device-side (jnp; also runs on CPU backend)
# ---------------------------------------------------------------------------

def i16_words_to_iq(words):
    """int32 words (one LE i16 IQ pair each) → planar (i, q) float32.

    Decode contract of dsp.rs:85-99: int16 value / 32768.
    """
    words = words.astype(jnp.int32)
    i = jnp.left_shift(words, 16) >> 16          # sign-extend low 16 bits
    q = words >> 16                              # arithmetic shift: high 16 bits
    return i.astype(jnp.float32) * _INV_32768, q.astype(jnp.float32) * _INV_32768


def saturating_trunc_i16(v):
    """Rust `as i16` on f32: truncate toward zero, saturate, NaN→0 (main.rs:77-78)."""
    v = jnp.trunc(v)
    v = jnp.where(jnp.isnan(v), jnp.float32(0.0), v)
    v = jnp.clip(v, jnp.float32(-32768.0), jnp.float32(32767.0))
    return v.astype(jnp.int32)


def iq_to_i16_words(i, q):
    """Planar (i, q) float32 → int32 words of LE i16 pairs (main.rs:76-84)."""
    iv = saturating_trunc_i16(i * _SCALE_OUT)
    qv = saturating_trunc_i16(q * _SCALE_OUT)
    return (iv & jnp.int32(0xFFFF)) | jnp.left_shift(qv, 16)


def f32_pairs_to_iq(pairs):
    """(…, N, 2) float32 interleaved pairs → planar (i, q)."""
    return pairs[..., 0], pairs[..., 1]


def iq_to_f32_pairs(i, q):
    """Planar (i, q) → (…, N, 2) float32 interleaved pairs."""
    return jnp.stack([i, q], axis=-1)


# ---------------------------------------------------------------------------
# Host-side staging (NumPy; zero-copy views where possible)
# ---------------------------------------------------------------------------

def bytes_to_i16_words(buf: bytes | bytearray | memoryview) -> np.ndarray:
    """Raw LE i16 IQ bytes → int32 word vector (one word per IQ pair)."""
    n = len(buf) - len(buf) % 4
    return np.frombuffer(buf, dtype="<i4", count=n // 4)

def i16_words_to_bytes(words: np.ndarray) -> bytes:
    return np.ascontiguousarray(words, dtype="<i4").tobytes()


def bytes_to_f32_pairs(buf: bytes | bytearray | memoryview) -> np.ndarray:
    """Raw LE f32 IQ bytes → (N, 2) float32 array."""
    n = len(buf) - len(buf) % 8
    flat = np.frombuffer(buf, dtype="<f4", count=n // 4)
    return flat.reshape(-1, 2)

def f32_pairs_to_bytes(pairs: np.ndarray) -> bytes:
    return np.ascontiguousarray(pairs, dtype="<f4").tobytes()
