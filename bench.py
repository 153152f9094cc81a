#!/usr/bin/env python
"""Device-program benchmark: XLA's rate at the pipeline's own shapes, on the GPU.

    python bench.py [--mode chain|mix|channels|split-xla] [--channels C]
                    [--samplerate FS] [--profile DIR]

Each mode jits one device step — decode → NCO mix [→ resample] → encode —
at a BASELINE config's shape and times it on device-resident inputs:
``--dispatches`` back-to-back steps, then ``jax.block_until_ready`` on
their outputs; the best of ``--iters`` such windows is reported.

- ``chain``     config 3's single-stage chain: 1.024 Msps → 48 ksps (3/64).
- ``mix``       the mixer alone (i16 → i16), config 1-2's device work.
- ``channels``  config 4: ``--channels`` channels of the config-3 chain.
- ``split-xla`` the multi-stage cascade at ``--samplerate`` (default config
                5's 100 Msps → 48 ksps: ÷16, ÷16, 384/3125) for
                ``--channels`` channels (default 1); ``--samplerate
                1024000`` is config 3's cascade.

Prints the card's name and power limit, then ONE JSON line with the rate in
input samples/s (× channels) and the device it ran on.  Refuses to run on
anything but a GPU unless ``--platform cpu`` is given (a CPU number is never
a device result).
"""

import argparse
import json
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--mode", choices=["chain", "mix", "channels", "split-xla"],
                    default="chain")
    ap.add_argument("--channels", type=int, default=None,
                    help="channel count (channels: 16, split-xla: 1)")
    ap.add_argument("--samplerate", type=int, default=None,
                    help="input rate for split-xla (default 100 Msps)")
    ap.add_argument("--samples", type=int, default=1 << 25,
                    help="input samples per step, over all channels")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--dispatches", type=int, default=16,
                    help="steps per timed window")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the timed windows")
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from doppler_tpu.ops import codec, nco
    from doppler_tpu.ops.multistage import MultiStageResampler
    from doppler_tpu.ops.phase_plan import NCOState, plan_blocks
    from doppler_tpu.ops.resample import (
        RationalResampler,
        conv_stream_geometry,
        make_taps_matrix,
        resample_conv_stream,
        window_dot,
    )
    from doppler_tpu.runtime.device import (
        card_identity,
        device_summary,
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = device_summary()
    if dev["platform"] != args.platform:
        print(f"bench: JAX found no {args.platform} (platform "
              f"{dev['platform']})", file=sys.stderr)
        return 1
    for line in card_identity():
        print(f"card: {line}", file=sys.stderr)

    split = args.mode == "split-xla"
    fs = (args.samplerate or 100_000_000) if split else 1_024_000
    C = args.channels or {"channels": 16}.get(args.mode, 1)
    L = 8192
    B = max(1, args.samples // C // L)
    N = B * L

    rng = np.random.default_rng(0xBE)
    data = jax.device_put(jnp.asarray(rng.integers(
        -(1 << 31), 1 << 31, size=(B, L), dtype=np.int64).astype(np.int32)))
    fields = np.zeros((7, C, B), dtype=np.uint32)
    for c in range(C):
        plan = plan_blocks([9000.0 + 120.0 * c - 0.01 * k for k in range(B)],
                           [L] * B, fs, NCOState(), L)
        for fi, f in enumerate(("d_hi", "d_lo", "c1_hi", "c1_lo",
                                "c2_hi", "c2_lo", "t")):
            fields[fi, c] = getattr(plan, f)
    plans = tuple(jax.device_put(jnp.asarray(a)) for a in fields)

    def mixed(data, plans):
        i, q = codec.i16_words_to_iq(data)
        i = jnp.broadcast_to(i[None], (C,) + i.shape)
        q = jnp.broadcast_to(q[None], (C,) + q.shape)
        i, q = nco.mix_blocks(i, q, *plans)
        return i.reshape(C, -1), q.reshape(C, -1)

    def resample(st, yi, yq):
        """One stage from zero history at zero alignment — the program
        ``RationalResampler.process`` runs for a chunk."""
        n, M = yi.shape[-1], st.max_out_for(yi.shape[-1])
        zeros = jnp.zeros((C, st.T - 1), jnp.float32)
        xi = jnp.concatenate([zeros, yi], axis=-1)
        xq = jnp.concatenate([zeros, yq], axis=-1)
        if st.impl == "conv":
            s0, p0, K, PADZ, TAIL = conv_stream_geometry(
                0, 0, M, n, P=st.P, Q=st.Q, T=st.T)
            return resample_conv_stream(
                xi, xq, jnp.asarray(make_taps_matrix(st.bank, st.P, st.Q)),
                jnp.int32(s0), jnp.int32(p0), P=st.P, Q=st.Q, T=st.T, K=K,
                M=M, PADZ=PADZ, TAIL=TAIL)
        return window_dot(xi, xq, jnp.asarray(st.bank[:, ::-1].copy()),
                          jnp.int32(0), jnp.int32(0), P=st.P, Q=st.Q, T=st.T,
                          M=M)

    if args.mode == "mix":
        stages = []
    elif split:
        stages = MultiStageResampler(fs, 48000).stages
    else:
        stages = [RationalResampler(fs, 48000)]
    print("stages: " + (" -> ".join(f"{st.P}/{st.Q}(T={st.T},{st.impl})"
                                    for st in stages) or "none"),
          file=sys.stderr)

    @jax.jit
    def step(data, *plans):
        yi, yq = mixed(data, plans)
        for st in stages:
            yi, yq = resample(st, yi, yq)
        return codec.iq_to_i16_words(yi, yq)

    t0 = time.perf_counter()
    jax.block_until_ready(step(data, *plans))
    compile_s = time.perf_counter() - t0

    def window():
        t = time.perf_counter()
        jax.block_until_ready([step(data, *plans)
                               for _ in range(args.dispatches)])
        return (time.perf_counter() - t) / args.dispatches

    if args.profile:
        with jax.profiler.trace(args.profile):
            times = [window() for _ in range(args.iters)]
    else:
        times = [window() for _ in range(args.iters)]
    best = min(times)
    rate = N * C / best
    print(f"bench {args.mode}: C={C} × {N} samples at {fs} sps: "
          f"{best * 1e3:.3f} ms/step best, {np.median(times) * 1e3:.3f} ms "
          f"median, compile+first {compile_s:.1f} s", file=sys.stderr)
    print(json.dumps({
        "metric": f"{args.mode}_xla_input_samples_per_s",
        "value": rate, "unit": "samples/s", "samplerate": fs,
        "channels": C, "realtime_x": rate / (fs * C), "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
