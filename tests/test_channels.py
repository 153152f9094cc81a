"""Multi-channel pipeline: batched run must match per-channel single runs."""

import io
import json
import subprocess
import sys

import numpy as np
import pytest

from doppler_tpu import oracle
from doppler_tpu.ops.phase_plan import NCOState
from doppler_tpu.ops.resample import attach_resampler
from doppler_tpu.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline

RNG = np.random.default_rng(0xCC)
FS = 1024000


def wideband(n):
    raw = RNG.integers(-8000, 8000, size=2 * n, dtype=np.int16)
    return raw.astype("<i2").tobytes()


def single_run(buf, shift, resample=None):
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(shift), chunk_blocks=16)
    if resample:
        attach_resampler(pipe, resample)
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    return out.getvalue()


def lsb_close(a: bytes, b: bytes, tol_frac=1e-3):
    """Outputs from differently-compiled graphs may flip 1 LSB at trunc
    boundaries; anything worse is a real bug."""
    xa = np.frombuffer(a, dtype="<i2").astype(np.int32)
    xb = np.frombuffer(b, dtype="<i2").astype(np.int32)
    assert xa.size == xb.size
    d = np.abs(xa - xb)
    assert d.max() <= 1, d.max()
    assert np.mean(d > 0) < tol_frac * 10 + 0.01


def test_multichannel_matches_single_runs():
    n = 8192 * 4
    buf = wideband(n)
    shifts = [-15000.0, 0.0, 120000.5]
    specs = [
        ChannelSpec("a", ConstScheduler(-20000.0), center_offset_hz=5000.0),
        ChannelSpec("b", ConstScheduler(0.0)),
        ChannelSpec("c", ConstScheduler(120000.5)),
    ]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=16)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    # channel a: -20000 + center 5000 folds to -15000
    for got, shift in zip(outs, shifts):
        want = single_run(buf, shift)
        lsb_close(got.getvalue(), want)


def test_multichannel_with_resampler():
    n = 8192 * 8
    buf = wideband(n)
    specs = [
        ChannelSpec("x", ConstScheduler(9000.0)),
        ChannelSpec("y", ConstScheduler(-7000.0)),
    ]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                              chunk_blocks=16)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    for got, shift in zip(outs, [9000.0, -7000.0]):
        want = single_run(buf, shift, resample=48000)
        assert len(got.getvalue()) == len(want)
        a = oracle.decode_i16_bytes(got.getvalue())
        b = oracle.decode_i16_bytes(want)
        assert oracle.snr_db(b, a) > 80.0


def test_per_channel_nco_state_independent():
    # channels with different shifts accumulate different samplenum states
    n = 8192 * 6  # crosses the rounding reset for the 9660.609375 ratio
    buf = wideband(n)
    specs = [
        ChannelSpec("r", ConstScheduler(9660.609375 * 4)),  # fs=1.024M: same ratio
        ChannelSpec("s", ConstScheduler(1000.0)),
    ]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=16)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    assert specs[0].state.samplenum != specs[1].state.samplenum


def test_cli_channels_subprocess(tmp_path):
    n = 8192 * 2
    buf = wideband(n)
    cfg = {
        "channels": [
            {"name": "one", "shift": -15000, "center_offset": 0},
            {"name": "two", "shift": 30000},
        ]
    }
    cfgfile = tmp_path / "ch.json"
    cfgfile.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu", "channels",
         "-s", str(FS), "-i", "i16", "--config", str(cfgfile),
         "--output-dir", str(tmp_path), "--platform", "cpu",
         "--chunk-blocks", "8"],
        input=buf, stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    for name, shift in [("one", -15000.0), ("two", 30000.0)]:
        got = (tmp_path / f"{name}.iq").read_bytes()
        lsb_close(got, single_run(buf, shift))
    assert b"multi-channel mode: 2 channels" in proc.stderr


def test_cli_channels_bad_config(tmp_path):
    cfgfile = tmp_path / "bad.json"
    cfgfile.write_text("{\"channels\": [{\"name\": \"x\"}]}")
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu", "channels",
         "-s", "1024000", "-i", "i16", "--config", str(cfgfile),
         "--platform", "cpu"],
        input=b"", stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=120,
    )
    assert proc.returncode == 1
    assert b"bad channel config" in proc.stderr


def test_per_channel_resample_rates():
    """Channels may override the pipeline out_rate; each must match the
    equivalent single-channel run at its own rate."""
    n = 8192 * 8
    buf = wideband(n)
    specs = [
        ChannelSpec("deflt", ConstScheduler(9000.0)),             # 48 ksps
        ChannelSpec("fast", ConstScheduler(-7000.0), out_rate=128000.0),
        ChannelSpec("raw", ConstScheduler(3000.0), out_rate=None),  # default
    ]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                              chunk_blocks=16)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    for got, shift, rate in zip(outs, [9000.0, -7000.0, 3000.0],
                                [48000, 128000, 48000]):
        want = single_run(buf, shift, resample=rate)
        assert len(got.getvalue()) == len(want)
        a = oracle.decode_i16_bytes(got.getvalue())
        b = oracle.decode_i16_bytes(want)
        assert oracle.snr_db(b, a) > 80.0


def test_per_channel_resample_mixed_with_unresampled():
    """A group with out_rate overrides alongside channels with NO resampling
    at all (pipeline default None)."""
    n = 8192 * 8
    buf = wideband(n)
    specs = [
        ChannelSpec("plain", ConstScheduler(9000.0)),               # raw rate
        ChannelSpec("deci", ConstScheduler(-7000.0), out_rate=48000.0),
    ]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=16)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)

    want_plain = single_run(buf, 9000.0)
    lsb_close(outs[0].getvalue(), want_plain)
    want_deci = single_run(buf, -7000.0, resample=48000)
    a = oracle.decode_i16_bytes(outs[1].getvalue())
    b = oracle.decode_i16_bytes(want_deci)
    assert a.size == b.size
    assert oracle.snr_db(b, a) > 80.0


def _mk_specs():
    return [
        ChannelSpec("a", ConstScheduler(-40000.0), center_offset_hz=500.0),
        ChannelSpec("b", ConstScheduler(12000.5)),
        ChannelSpec("c", ConstScheduler(90000.0)),
    ]


def _run_channels(buf, specs, out_rate=48000.0, drain=False):
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=out_rate,
                              chunk_blocks=16, drain_on_eof=drain)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    return mp, [o.getvalue() for o in outs]


def test_channels_checkpoint_resume_bitwise(tmp_path):
    """VERDICT r1 item 7: stop mid-stream, checkpoint, resume in a fresh
    pipeline → per-channel bytes identical to the uninterrupted run."""
    from doppler_tpu.runtime import checkpoint

    n = 2048 * 16 * 4
    buf = wideband(n)
    _, full = _run_channels(buf, _mk_specs())

    cut = 2048 * 16 * 2 * 4  # bytes: two whole chunks
    mp1, first = _run_channels(buf[:cut], _mk_specs())
    path = str(tmp_path / "ch.npz")
    checkpoint.save_channels(path, mp1)

    mp2 = MultiChannelPipeline(FS, "i16", "i16", _mk_specs(),
                               out_rate=48000.0, chunk_blocks=16)
    meta = checkpoint.restore_channels(path, mp2)
    assert meta["samples_in"] * 4 == cut
    outs = [io.BytesIO() for _ in range(3)]
    mp2.run(io.BytesIO(buf[cut:]), outs)
    for a, b, c in zip(first, (o.getvalue() for o in outs), full):
        assert a + b == c


def test_channels_checkpoint_mixed_rates_and_unresampled(tmp_path):
    """Groups with different rates (incl. rs=None) all round-trip."""
    from doppler_tpu.runtime import checkpoint

    def specs():
        return [
            ChannelSpec("x", ConstScheduler(-15000.0), out_rate=48000.0),
            ChannelSpec("y", ConstScheduler(7000.0)),          # unresampled
            ChannelSpec("z", ConstScheduler(30000.0), out_rate=128000.0),
        ]

    n = 2048 * 16 * 3
    buf = wideband(n)
    mp_full = MultiChannelPipeline(FS, "i16", "i16", specs(), chunk_blocks=16)
    fulls = [io.BytesIO() for _ in range(3)]
    mp_full.run(io.BytesIO(buf), fulls)

    cut = 2048 * 16 * 4
    mp1 = MultiChannelPipeline(FS, "i16", "i16", specs(), chunk_blocks=16)
    firsts = [io.BytesIO() for _ in range(3)]
    mp1.run(io.BytesIO(buf[:cut]), firsts)
    path = str(tmp_path / "mixed.npz")
    checkpoint.save_channels(path, mp1)

    mp2 = MultiChannelPipeline(FS, "i16", "i16", specs(), chunk_blocks=16)
    checkpoint.restore_channels(path, mp2)
    rests = [io.BytesIO() for _ in range(3)]
    mp2.run(io.BytesIO(buf[cut:]), rests)
    for f, r, full in zip(firsts, rests, fulls):
        assert f.getvalue() + r.getvalue() == full.getvalue()


def test_channels_checkpoint_rejects_mismatched_config(tmp_path):
    from doppler_tpu.runtime import checkpoint

    buf = wideband(2048 * 16)
    mp1, _ = _run_channels(buf, _mk_specs())
    path = str(tmp_path / "ch.npz")
    checkpoint.save_channels(path, mp1)

    renamed = _mk_specs()
    renamed[1] = ChannelSpec("other", ConstScheduler(12000.5))
    mp2 = MultiChannelPipeline(FS, "i16", "i16", renamed,
                               out_rate=48000.0, chunk_blocks=16)
    with pytest.raises(ValueError, match="channel set changed"):
        checkpoint.restore_channels(path, mp2)


def test_channels_drain_matches_single_pipeline_drain():
    """--drain in channels mode flushes each channel's FIR tail exactly as
    the single-stream pipeline does."""
    n = 2048 * 16 * 2 + 777
    buf = wideband(n)
    specs = _mk_specs()
    _, outs = _run_channels(buf, specs, drain=True)
    for spec, got in zip(_mk_specs(), outs):
        pipe = Pipeline(FS, "i16", "i16",
                        ConstScheduler(spec.scheduler.shift_hz
                                       + spec.center_offset_hz),
                        chunk_blocks=16, drain_on_eof=True)
        attach_resampler(pipe, 48000.0)
        want = io.BytesIO()
        pipe.run(io.BytesIO(buf), want)
        assert len(got) == len(want.getvalue())
        lsb_close(got, want.getvalue())


def test_cli_channels_save_load_state(tmp_path):
    """Full CLI surface: kill after N bytes via --save-state, resume with
    --load-state, concatenated outputs equal the single run."""
    cfg = {
        "channels": [
            {"name": "c0", "shift": -15000.0},
            {"name": "c1", "shift": 20000.0, "center_offset": 100.0},
        ]
    }
    cfg_path = tmp_path / "ch.json"
    cfg_path.write_text(json.dumps(cfg))
    buf = wideband(2048 * 16 * 4)
    outdir_full = tmp_path / "full"
    outdir_cut = tmp_path / "cut"

    def run_cli(data, outdir, extra):
        proc = subprocess.run(
            [sys.executable, "-m", "doppler_tpu", "channels",
             "--config", str(cfg_path), "-s", str(FS), "-i", "i16",
             "--resample-to", "48000", "--chunk-blocks", "16",
             "--output-dir", str(outdir), "--platform", "cpu"] + extra,
            input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            timeout=300,
        )
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]

    run_cli(buf, outdir_full, [])
    cut = 2048 * 16 * 2 * 4
    state = tmp_path / "state.npz"
    run_cli(buf[:cut], outdir_cut, ["--save-state", str(state)])
    run_cli(buf[cut:], outdir_cut, ["--load-state", str(state)])
    for name in ("c0", "c1"):
        a = (outdir_full / f"{name}.iq").read_bytes()
        b = (outdir_cut / f"{name}.iq").read_bytes()
        assert a == b and len(a) > 0


def test_channels_256_uniform_plan_lane(monkeypatch):
    """Config-5-shaped smoke (VERDICT r2 #6): 256 channels plan through the
    batched (C, B) uniform lane after genesis, and the wideband output stays
    identical to per-channel single runs."""
    from doppler_tpu.runtime import channels as ch_mod

    calls = {"uniform": 0}
    real = ch_mod.plan_fields_uniform

    def counting(*a, **k):
        out = real(*a, **k)
        if out is not None:
            calls["uniform"] += 1
        return out

    monkeypatch.setattr(ch_mod, "plan_fields_uniform", counting)

    C = 256
    n = 2048 * 12                      # 3 chunks of 4 blocks
    buf = wideband(n)
    # irrational-ish shifts: huge dyadic periods, so the closed-form lane
    # (rather than the small-q exact lane) carries every channel
    shifts = [9000.37 + 173.3 * c for c in range(C)]
    specs = [ChannelSpec(f"c{c:03d}", ConstScheduler(shifts[c]))
             for c in range(C)]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=4)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)

    # genesis chunk (samplenum 0 fires at sample 0) falls back; the steady
    # chunks must ride the batched lane
    assert calls["uniform"] >= 2, calls

    for c in (0, 1, 17, 128, 255):
        want = single_run(buf, float(np.float32(shifts[c])), )
        assert outs[c].getvalue() == want, f"channel {c} diverged"


def test_channels_cascade_matches_single_runs():
    """Uniform-rate multi-stage channels run ONE batched cascade, matching
    per-channel single-stream runs within the 1-LSB contract for
    differently batched programs."""
    from doppler_tpu.ops.resample import attach_resampler

    n = 8192 * 6 + 1000            # full chunks + ragged tail
    buf = wideband(n)
    shifts = [-15000.0, 0.0, 90000.5, 33000.25]
    specs = [ChannelSpec(f"c{k}", ConstScheduler(s))
             for k, s in enumerate(shifts)]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                              chunk_blocks=8, resample_stages="multi")
    assert getattr(mp.resampler, "stages", None) is not None
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)

    for got, shift in zip(outs, shifts):
        pipe = Pipeline(FS, "i16", "i16", ConstScheduler(shift),
                        chunk_blocks=8)
        attach_resampler(pipe, 48000, stages="multi")
        want = io.BytesIO()
        pipe.run(io.BytesIO(buf), want)
        lsb_close(got.getvalue(), want.getvalue())


def test_channels_cascade_checkpoint_resume_bitwise(tmp_path):
    """Per-stage cascade state round-trips through the channels checkpoint;
    the resumed run reproduces the uninterrupted bytes exactly."""
    from doppler_tpu.runtime import checkpoint

    n = 8192 * 8
    buf = wideband(n)
    shifts = [-12000.0, 44000.5]

    def mk():
        specs = [ChannelSpec(f"c{k}", ConstScheduler(s))
                 for k, s in enumerate(shifts)]
        return MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                                    chunk_blocks=8, resample_stages="multi")

    mp = mk()
    outs = [io.BytesIO() for _ in shifts]
    mp.run(io.BytesIO(buf), outs)
    whole = [o.getvalue() for o in outs]

    half = len(buf) // 2
    mp1 = mk()
    o1 = [io.BytesIO() for _ in shifts]
    mp1.run(io.BytesIO(buf[:half]), o1)
    ck = str(tmp_path / "ch_casc.npz")
    checkpoint.save_channels(ck, mp1)
    mp2 = mk()
    checkpoint.restore_channels(ck, mp2)
    o2 = [io.BytesIO() for _ in shifts]
    mp2.run(io.BytesIO(buf[half:]), o2)
    for c in range(len(shifts)):
        assert o1[c].getvalue() + o2[c].getvalue() == whole[c]


# ---------------------------------------------------------------------------
# f32 wire formats, and the split cascade (odd-Q final stage) in channels mode


def f32_wideband(n, seed=0xF32):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(2 * n)).astype("<f4").tobytes()


def _f32_close(a: bytes, b: bytes, tol=1e-6):
    xa = np.frombuffer(a, dtype="<f4")
    xb = np.frombuffer(b, dtype="<f4")
    assert xa.size == xb.size and xa.size > 0
    rel = np.sqrt(np.mean((xa - xb) ** 2)) / (np.sqrt(np.mean(xb ** 2)) + 1e-30)
    assert rel < tol, rel


def _single_stream(fs, buf, shift, intype, outtype, stages, chunk_blocks=16):
    pipe = Pipeline(fs, intype, outtype, ConstScheduler(shift),
                    chunk_blocks=chunk_blocks)
    attach_resampler(pipe, 48000, stages=stages)
    out = io.BytesIO()
    pipe.run(io.BytesIO(buf), out)
    return out.getvalue()


@pytest.mark.parametrize("stages", ["single", "multi"])
def test_channels_f32_paths(stages):
    """f32 in/out channels mode, single-stage and cascade, matches the
    per-channel single-stream runs to 1-ulp grade."""
    n = 1024 * 16 * 8            # f32 blocks are 1024 samples
    buf = f32_wideband(n)
    shifts = [9000.0, -7000.0]
    specs = [ChannelSpec(f"c{k}", ConstScheduler(s))
             for k, s in enumerate(shifts)]
    mp = MultiChannelPipeline(FS, "f32", "f32", specs, out_rate=48000,
                              chunk_blocks=16, resample_stages=stages)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    for got, shift in zip(outs, shifts):
        _f32_close(got.getvalue(),
                   _single_stream(FS, buf, shift, "f32", "f32", stages))


def test_channels_split_cascade_odd_q():
    """Channels mode with an odd-Q final stage (250 k→48 k: ÷2, then
    96/125) matches the per-channel single-stream cascade to ≤1 LSB."""
    fs2 = 250000
    n = 2048 * 16 * 4
    buf = wideband(n)
    shifts = [5000.0, -3000.0]
    specs = [ChannelSpec(f"c{k}", ConstScheduler(s))
             for k, s in enumerate(shifts)]
    mp = MultiChannelPipeline(fs2, "i16", "i16", specs, out_rate=48000,
                              chunk_blocks=16, resample_stages="multi")
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(buf), outs)
    assert mp.resampler.stages[-1].Q % 2 == 1
    for got, shift in zip(outs, shifts):
        lsb_close(got.getvalue(),
                  _single_stream(fs2, buf, shift, "i16", "i16", "multi"))


def test_channels_split_cascade_checkpoint_resume_bitwise(tmp_path):
    from doppler_tpu.runtime import checkpoint

    fs2 = 250000
    buf = wideband(2048 * 16 * 4)
    shifts = [-12000.0, 44000.5]

    def mk():
        specs = [ChannelSpec(f"c{k}", ConstScheduler(s))
                 for k, s in enumerate(shifts)]
        return MultiChannelPipeline(fs2, "i16", "i16", specs, out_rate=48000,
                                    chunk_blocks=16, resample_stages="multi")

    mp = mk()
    outs = [io.BytesIO() for _ in shifts]
    mp.run(io.BytesIO(buf), outs)
    assert len(mp.resampler.stages) == 2     # ÷2 front + odd-Q tail
    whole = [o.getvalue() for o in outs]

    half = len(buf) // 2
    mp1 = mk()
    o1 = [io.BytesIO() for _ in shifts]
    mp1.run(io.BytesIO(buf[:half]), o1)
    ck = str(tmp_path / "ch_split.npz")
    checkpoint.save_channels(ck, mp1)
    mp2 = mk()
    checkpoint.restore_channels(ck, mp2)
    o2 = [io.BytesIO() for _ in shifts]
    mp2.run(io.BytesIO(buf[half:]), o2)
    for c in range(len(shifts)):
        assert o1[c].getvalue() + o2[c].getvalue() == whole[c]


def test_channels_drained_checkpoint_restart_is_noop(tmp_path):
    """ADVICE r4 (channels analog): re-running --load-state against a
    checkpoint written after EOF + drain must NOT drain again and append
    duplicate FIR tails to the per-channel output files."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"channels": [
        {"name": "a", "shift": -9000.0},
        {"name": "b", "shift": 4000.0},
    ]}))
    rng = np.random.default_rng(0xD0)
    raw = rng.integers(-(1 << 15), 1 << 15, size=2 * 2048 * 32,
                       dtype=np.int64).astype("<i2").tobytes()
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    outdir = tmp_path / "out"
    ck = tmp_path / "ck.npz"
    base = [sys.executable, "-m", "doppler_tpu.cli", "channels",
            "-s", "1024000", "-i", "i16", "--config", str(cfg),
            "--resample-to", "48000", "--resample-stages", "single",
            "--drain", "--platform", "cpu",
            "--input", str(inp), "--output-dir", str(outdir)]
    env = dict(os.environ)

    p = subprocess.run(base + ["--save-state", str(ck)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    first = {n: (outdir / f"{n}.iq").read_bytes() for n in ("a", "b")}
    assert all(len(v) > 0 for v in first.values())

    p = subprocess.run(base + ["--load-state", str(ck)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert b"nothing to do" in p.stderr
    for n in ("a", "b"):
        assert (outdir / f"{n}.iq").read_bytes() == first[n], \
            f"channel {n}: duplicate drain appended bytes"
