// doppler_tpu native host library.
//
// Replacements for the reference's native layer (SURVEY §2 #6-7:
// src/complex.c + build.rs). The per-sample cexpf FFI of the reference became
// on-device math; what remains on the host is byte-stream staging — and at
// multi-GS/s host rates the Python/NumPy staging path becomes the bottleneck,
// so the codecs live here as tight auto-vectorizable loops.
//
// Also included: a bit-faithful sequential reference NCO (the Rust
// dsp.rs:117-134 loop, f32 arithmetic + samplenum reset quirk) used as a fast
// golden model for long-stream verification — the NumPy scalar oracle is
// O(1 µs/sample), this is O(1 ns/sample).
//
// Build: `make -C native` → libdoppler_native.so, loaded via ctypes
// (doppler_tpu/runtime/native.py) with a pure-NumPy fallback.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Interleaved little-endian i16 IQ → planar f32, scale 1/32768 (dsp.rs:85-99).
void dt_i16_to_planar_f32(const int16_t* in, size_t n_pairs,
                          float* i_out, float* q_out) {
    const float k = 1.0f / 32768.0f;
    for (size_t n = 0; n < n_pairs; ++n) {
        i_out[n] = (float)in[2 * n] * k;
        q_out[n] = (float)in[2 * n + 1] * k;
    }
}

static inline int16_t sat_trunc_i16(float v) {
    // Rust `as i16` on f32: truncate toward zero, saturate, NaN → 0
    // (main.rs:77-78).
    if (std::isnan(v)) return 0;
    v = std::truncf(v);
    if (v <= -32768.0f) return -32768;
    if (v >= 32767.0f) return 32767;
    return (int16_t)v;
}

// Planar f32 → interleaved i16, ×32767 then saturating trunc (main.rs:76-84).
void dt_planar_f32_to_i16(const float* i_in, const float* q_in,
                          size_t n_pairs, int16_t* out) {
    for (size_t n = 0; n < n_pairs; ++n) {
        out[2 * n] = sat_trunc_i16(i_in[n] * 32767.0f);
        out[2 * n + 1] = sat_trunc_i16(q_in[n] * 32767.0f);
    }
}

// Bit-faithful sequential reference NCO: the dsp.rs:117-134 loop.
// All arithmetic in f32; phase via cexpf-equivalent cosf/sinf on the f32
// product; samplenum resets to 1 when fract((shift/fs)·n) == 0.
// Returns the final samplenum.
uint32_t dt_reference_mix(const float* i_in, const float* q_in, size_t n,
                          uint32_t samplenum, float shift_hz, uint32_t samplerate,
                          float* i_out, float* q_out) {
    const float ratio = shift_hz / (float)samplerate;
    const float neg_two_pi = -2.0f * 3.14159265358979323846f;
    uint32_t sn = samplenum;
    for (size_t k = 0; k < n; ++k) {
        float prod = ratio * (float)sn;
        float phase = neg_two_pi * prod;
        float c = cosf(phase);
        float s = sinf(phase);
        i_out[k] = i_in[k] * c - q_in[k] * s;
        q_out[k] = i_in[k] * s + q_in[k] * c;
        float frac = prod - truncf(prod);
        sn = (frac == 0.0f) ? 1u : sn + 1u;
    }
    return sn;
}

// Counter-only form of the reference loop over a per-block shift schedule
// (track mode threads ONE samplenum through every block, main.rs:177):
// advances sn through counts[b] samples at shifts[b] per block, recording
// each block's STARTING counter in out_sn.  Same f32 arithmetic as
// dt_reference_mix's update, minus the cos/sin — ~4 ops/sample, so a
// 2^32-sample soak (tests/test_soak_counter.py) runs in seconds instead of
// the mix loop's minutes.
uint32_t dt_reference_counter_blocks(const float* shifts,
                                     const uint32_t* counts, size_t nblocks,
                                     uint32_t samplenum, uint32_t samplerate,
                                     uint32_t* out_sn) {
    uint32_t sn = samplenum;
    for (size_t b = 0; b < nblocks; ++b) {
        if (out_sn) out_sn[b] = sn;
        const float ratio = shifts[b] / (float)samplerate;
        const uint32_t n = counts[b];
        for (uint32_t k = 0; k < n; ++k) {
            float prod = ratio * (float)sn;
            float frac = prod - truncf(prod);
            sn = (frac == 0.0f) ? 1u : sn + 1u;
        }
    }
    return sn;
}

}  // extern "C"
