"""Quarter-wave polynomial sincos on a Q0.24 phase word — THE framework NCO.

One numerical definition of the corrector tone, used by every mixer program
(``ops.nco``): integer-exact quadrant folding from the top 2 phase bits plus
a shared-x² polynomial pair on [0, π/2).

Why a polynomial instead of ``jnp.cos``/``jnp.sin``: libm transcendentals
are *implementation-defined* — XLA picks different vectorized approximations
depending on backend and fusion context, so the same phase can produce
1-ulp-different tones between a single-device and an SPMD-partitioned run of
the same program.  A fixed mul/add chain evaluates identically per element
regardless of sharding, fusion, or batch shape, which is what makes the
framework's sharding-equivalence contract *byte*-exact (SURVEY §4c) rather
than merely SNR-exact.  Max error ≈ 4.9e-7 (≈2 ulp) — the same order as the
libm calls, far below the reference's own f32 phase noise (SURVEY §3.4), and
roughly half the ALU ops of two range-reduced transcendental calls.

Replaces the reference's per-sample ``ccexpf`` C FFI (``src/complex.c:33-39``
called from ``src/dsp.rs:122``) on both compute paths.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["sincos_q24_neg", "mix_tone"]


def mix_tone(fi, fq, c, s):
    """``(fi·c − fq·s, fi·s + fq·c)`` — THE complex rotation, one definition
    shared by every mixer program (single stream, channel batch, sharded).

    Contraction boundary (VERDICT r2 #8, root-caused round 3): backends
    contract one of the multiplies into an FMA, and *which* one is a codegen
    choice that varies between program shapes and even between vectorizer
    main/remainder lanes within one program — measured on XLA CPU, where
    ``a*b − c*d`` compiles to ``fma(a, b, −(c·d))`` even across an
    ``optimization_barrier``, so the choice is not pinnable at the jaxpr
    level.  Consequences, pinned by tests:

    - within ONE compiled program the result is deterministic, so every
      replay/checkpoint/chunk-split guarantee (same kernel, same shapes)
      stays bitwise;
    - across differently shaped programs of the same math (a single stream
      vs a channel batch, C vs C/N channels per card), isolated samples may
      differ by 1 ulp — ≤ 1 LSB after encode, lengths identical, which is
      the contract the channel-sharded cascade is held to;
    - cross-shape *byte* equality where the framework promises it (time-
      sharded vs unsharded, mesh fallback) is enforced by byte-level tests,
      which would catch a backend whose contraction choice diverges there.
    """
    return fi * c - fq * s, fi * s + fq * c


def sincos_q24_neg(q24):
    """(cos θ, sin θ) for θ = −2π·q24·2⁻²⁴, q24 an int32 phase in [0, 2²⁴).

    The negative angle matches the reference mixer's corrector
    ``exp(-i·2π·frac(r·n))`` (dsp.rs:121-122).  Runs on any backend —
    pure elementwise jnp (no uint32→f32 casts, no libm).
    """
    quad = q24 >> 22                                       # 0..3
    frac = (q24 & jnp.int32(0x3FFFFF)).astype(jnp.float32)
    x = frac * jnp.float32((np.pi / 2) * 2.0 ** -22)       # [0, π/2)
    x2 = x * x
    s_p = x * (
        jnp.float32(0.9999999660) + x2 * (
            jnp.float32(-0.1666665247) + x2 * (
                jnp.float32(0.0083330520) + x2 * (
                    jnp.float32(-0.0001980742)
                    + x2 * jnp.float32(2.6019031e-06)))))
    c_p = jnp.float32(1.0) + x2 * (
        jnp.float32(-0.4999999963) + x2 * (
            jnp.float32(0.0416666418) + x2 * (
                jnp.float32(-0.0013888397) + x2 * (
                    jnp.float32(0.0000247609)
                    + x2 * jnp.float32(-2.605e-07)))))
    # Quadrant fold via ONE swap-select per output + sign-bit XOR (round 5):
    # bitwise-identical to the select-chain form (negation IS a sign-bit
    # flip in IEEE 754, including −0.0; pinned over all 2²⁴ phase words by
    # tests/test_nco.py::test_sincos_fold_bitwise_vs_select_chain) with a
    # shorter critical path.
    # cos θ picks ∓s_p on odd quadrants; its sign is −(quad∈{1,2}); the
    # returned −sin θ sign is −(quad∈{0,1}) — both fold into one XOR word.
    swap = (quad & jnp.int32(1)) == 1
    pick_c = jnp.where(swap, s_p, c_p)
    pick_s = jnp.where(swap, c_p, s_p)
    signc = jnp.left_shift((quad + jnp.int32(1)) & jnp.int32(2), 30)
    signs = jnp.left_shift((quad & jnp.int32(2)) ^ jnp.int32(2), 30)
    ci = jax.lax.bitcast_convert_type(pick_c, jnp.int32) ^ signc
    si = jax.lax.bitcast_convert_type(pick_s, jnp.int32) ^ signs
    return (jax.lax.bitcast_convert_type(ci, jnp.float32),
            jax.lax.bitcast_convert_type(si, jnp.float32))
