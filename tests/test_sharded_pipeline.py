"""--mesh product-path tests: sharded runs must emit byte-identical streams.

VERDICT r1 item 1: the parallel/ package must be consumed by the actual
CLI/pipelines, and a mesh run must reproduce the single-device run *bytes*
(not just SNR) — guaranteed by the shared deterministic tone (ops.sincos)
and the shared resample formulation (ops.resample.window_dot), and pinned
here on the 8-fake-device CPU mesh (SURVEY §4c).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from doppler_tpu.parallel import make_mesh
from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline
from doppler_tpu.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu.ops.resample import attach_resampler

RNG = np.random.default_rng(0xD0)

FS = 1024000


class VaryScheduler:
    """Track-like schedule: per-block varying shifts incl. reset-quirk-prone
    rates (9660.609375/256000 fires rounding resets, SURVEY erratum)."""

    def __init__(self):
        self.k = 0

    def shifts(self, block_counts):
        out = []
        for _ in block_counts:
            out.append(9660.609375 - 3.25 * self.k)
            self.k += 1
        return out


def i16_stream(n):
    return RNG.integers(-20000, 20000, size=2 * n, dtype=np.int16).astype(
        "<i2"
    ).tobytes()


def f32_stream(n):
    return (0.4 * RNG.standard_normal(2 * n)).astype("<f4").tobytes()


def run_pipe(raw, mesh, *, intype="i16", outtype="i16", resample=None,
             scheduler=None, chunk_blocks=16):
    pipe = Pipeline(FS, intype, outtype,
                    scheduler or ConstScheduler(-15000.0),
                    chunk_blocks=chunk_blocks, mesh=mesh)
    if resample:
        attach_resampler(pipe, resample)
    out = io.BytesIO()
    pipe.run(io.BytesIO(raw), out)
    return out.getvalue()


@pytest.fixture(scope="module")
def devices_ok():
    assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"


def test_mesh_const_mix_identical(devices_ok):
    raw = i16_stream(2048 * 16 * 2 + 5000)   # 2 full chunks + partial tail
    a = run_pipe(raw, None)
    b = run_pipe(raw, make_mesh(time=4, channel=1))
    assert a == b and len(a) == len(raw)


def test_mesh_const_f32_identical(devices_ok):
    raw = f32_stream(1024 * 16 + 300)
    a = run_pipe(raw, None, intype="f32", outtype="f32")
    b = run_pipe(raw, make_mesh(time=2, channel=1), intype="f32",
                 outtype="f32")
    assert a == b


def test_mesh_resample_identical_any_width(devices_ok):
    raw = i16_stream(2048 * 16 * 3 + 4321)
    a = run_pipe(raw, None, resample=48000.0)
    for n_time in (2, 4, 8):
        b = run_pipe(raw, make_mesh(time=n_time, channel=1),
                     resample=48000.0)
        assert a == b, f"mesh time={n_time} diverged"


def test_mesh_track_schedule_identical(devices_ok):
    raw = i16_stream(2048 * 16 * 2 + 999)
    a = run_pipe(raw, None, scheduler=VaryScheduler(), resample=48000.0)
    b = run_pipe(raw, make_mesh(time=4, channel=1),
                 scheduler=VaryScheduler(), resample=48000.0)
    assert a == b


def test_mesh_checkpoint_resume_bitwise(devices_ok):
    """Stop a mesh run mid-stream, checkpoint, resume → identical bytes."""
    from doppler_tpu.runtime import checkpoint

    raw = i16_stream(2048 * 16 * 4)
    full = run_pipe(raw, None, resample=48000.0)

    cut = 2048 * 16 * 2 * 4  # bytes: 2 whole chunks
    mesh = make_mesh(time=4, channel=1)
    p1 = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                  chunk_blocks=16, mesh=mesh)
    attach_resampler(p1, 48000.0)
    out1 = io.BytesIO()
    p1.run(io.BytesIO(raw[:cut]), out1)
    state = io.BytesIO()
    checkpoint.save(state, p1)
    state.seek(0)

    p2 = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                  chunk_blocks=16, mesh=mesh)
    attach_resampler(p2, 48000.0)
    meta = checkpoint.restore(state, p2)
    assert meta["sample_offset"] * 4 == cut
    out2 = io.BytesIO()
    p2.run(io.BytesIO(raw[cut:]), out2)
    assert out1.getvalue() + out2.getvalue() == full


def test_mesh_channels_identical(devices_ok):
    raw = i16_stream(2048 * 16 * 2 + 3000)

    def specs():
        return [
            ChannelSpec(name=f"ch{k}",
                        scheduler=ConstScheduler(-40000.0 + 9000 * k),
                        center_offset_hz=500.0 * k)
            for k in range(8)
        ]

    def run(mesh, out_rate):
        mp = MultiChannelPipeline(FS, "i16", "i16", specs(),
                                  out_rate=out_rate, chunk_blocks=16,
                                  mesh=mesh)
        outs = [io.BytesIO() for _ in range(8)]
        mp.run(io.BytesIO(raw), outs)
        return [o.getvalue() for o in outs]

    for out_rate in (None, 48000):
        a = run(None, out_rate)
        b = run(make_mesh(time=2, channel=4), out_rate)
        assert a == b, f"channels mesh diverged (out_rate={out_rate})"


def test_mesh_validation_errors(devices_ok):
    with pytest.raises(ValueError, match="channel=1"):
        Pipeline(FS, "i16", "i16", ConstScheduler(0.0),
                 mesh=make_mesh(time=2, channel=2))
    with pytest.raises(ValueError, match="divisible"):
        Pipeline(FS, "i16", "i16", ConstScheduler(0.0), chunk_blocks=3,
                 mesh=make_mesh(time=2, channel=1))
    with pytest.raises(ValueError, match="divide over mesh"):
        MultiChannelPipeline(
            FS, "i16", "i16",
            [ChannelSpec(name="a", scheduler=ConstScheduler(0.0)),
             ChannelSpec(name="b", scheduler=ConstScheduler(0.0)),
             ChannelSpec(name="c", scheduler=ConstScheduler(0.0))],
            mesh=make_mesh(time=2, channel=2),
        )


def test_cli_mesh_flag_identical(devices_ok, tmp_path):
    """The full CLI surface: --mesh output == unmeshed output, bytes."""
    raw = i16_stream(2048 * 40 + 1234)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run_cli(extra):
        proc = subprocess.run(
            [sys.executable, "-m", "doppler_tpu", "const",
             "-s", str(FS), "-i", "i16", "--shift", "-15000",
             "--resample-to", "48000", "--resample-stages", "single",
             "--chunk-blocks", "16", "--platform", "cpu"] + extra,
            input=raw, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            timeout=300, cwd=repo, env=env,
        )
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        return proc.stdout

    a = run_cli([])
    b = run_cli(["--mesh", "time=4"])
    assert a == b and len(a) > 0


def test_cli_mesh_rejects_channel_outside_channels_mode(devices_ok):
    import logging

    from doppler_tpu.cli import main

    # main() installs the stderr handler and sets propagate=False on the
    # framework logger; restore it so later caplog-based tests still see
    # records (telemetry tests rely on propagation to the root logger).
    logger = logging.getLogger("doppler_tpu")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    try:
        rc = main(["const", "-s", "256000", "-i", "i16", "--shift", "-100",
                   "--mesh", "time=2,channel=2", "--platform", "cpu"],
                  stdin=io.BytesIO(b""), stdout=io.BytesIO())
        assert rc == 1
    finally:
        logger.handlers, logger.propagate = saved[0], saved[1]
        logger.setLevel(saved[2])




# ---------------------------------------------------------------------------
# Config-5 topology: the channel-sharded XLA cascade (--mesh channel=N)
# ---------------------------------------------------------------------------

def _channels_run(fs, mesh, raw, *, outtype="i16", n=8, stages="multi",
                  out_rate=48000, chunk_blocks=16, rates=None):
    specs = [ChannelSpec(name=f"ch{k}",
                         scheduler=ConstScheduler(-30000.0 + 8000 * k),
                         out_rate=None if rates is None else rates[k])
             for k in range(n)]
    mp = MultiChannelPipeline(fs, "i16", outtype, specs, out_rate=out_rate,
                              chunk_blocks=chunk_blocks, mesh=mesh,
                              resample_stages=stages)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(raw), outs)
    return mp, [o.getvalue() for o in outs]


def _assert_within_1lsb(a, b, dtype):
    """The contract for differently batched programs: identical lengths,
    ≤ 1 LSB (ops/sincos.py mix_tone)."""
    for x, y in zip(a, b):
        xa = np.frombuffer(x, dtype).astype(np.float64)
        xb = np.frombuffer(y, dtype).astype(np.float64)
        assert xa.size == xb.size and xa.size > 0
        if dtype == "<i2":
            assert np.abs(xa - xb).max() <= 1
        else:
            lsb = np.spacing(np.abs(xa).astype(np.float32)).astype(np.float64)
            assert (np.abs(xa - xb) <= lsb).all()


@pytest.mark.parametrize("outtype", ["i16", "f32"])
@pytest.mark.parametrize("n_chan", [2, 4, 8])
def test_mesh_channels_cascade_identical(devices_ok, n_chan, outtype):
    """--mesh channel=N with a multi-stage cascade runs the channel-sharded
    XLA cascade step and matches the unsharded run (≤1 LSB contract;
    identical lengths), full chunks and the partial EOF chunk alike."""
    raw = i16_stream(2048 * 16 * 2 + 1500)
    _, a = _channels_run(FS, None, raw, outtype=outtype)
    mp, b = _channels_run(FS, make_mesh(channel=n_chan), raw, outtype=outtype)
    assert ("casc", 0) in mp._sharded_steps, "sharded cascade not used"
    _assert_within_1lsb(a, b, "<i2" if outtype == "i16" else "<f4")


def test_mesh_channels_cascade_state_lives_on_owning_card(devices_ok):
    """Each stage's FIR history stays sharded over the channel axis after a
    sharded chunk (no gather to one device between chunks)."""
    raw = i16_stream(2048 * 16 * 2)
    mp, _ = _channels_run(FS, make_mesh(channel=4), raw)
    for st in mp.resampler.stages:
        for h in (st._hist_i, st._hist_q):
            assert h.shape == (8, st.T - 1)
            assert len(h.sharding.device_set) == 4
            assert h.sharding.spec[0] == "channel"


def test_mesh_channels_cascade_step_has_no_collective(devices_ok):
    """Channels are independent: the sharded cascade program exchanges
    nothing between cards."""
    import jax.numpy as jnp
    from doppler_tpu.ops.multistage import MultiStageResampler
    from doppler_tpu.parallel.sharded import make_cascade_channels_step

    ms = MultiStageResampler(FS, 48000, channels=4)
    step = make_cascade_channels_step(make_mesh(channel=4), intype="i16",
                                      outtype="i16", C=4, resampler=ms)
    B, L = 4, 2048
    args = ([jnp.zeros((B, L), jnp.int32)]
            + [jnp.zeros((4, B), jnp.uint32)] * 7
            + [jnp.zeros((4, st.T - 1), jnp.float32)
               for st in ms.stages for _ in range(2)]
            + [jnp.int32(0)] * (3 * len(ms.stages)))
    text = str(jax.make_jaxpr(step)(*args))
    for coll in ("ppermute", "psum", "all_gather", "all_to_all"):
        assert coll not in text, coll


def test_mesh_channels_cascade_and_split(devices_ok):
    """Channels --mesh with a multi-stage cascade, fully integer
    (1.024M→48k) and SPLIT (250k→48k, odd-Q rational tail): the
    channel-sharded step covers both, ≤1 LSB vs unsharded."""
    raw = i16_stream(2048 * 16 * 2 + 900)
    for fs in (1024000, 250000):
        _, a = _channels_run(fs, None, raw, n=4)
        mp, b = _channels_run(fs, make_mesh(channel=2), raw, n=4)
        if fs == 250000:
            assert mp.resampler.stages[-1].Q % 2 == 1
        assert ("casc", 0) in mp._sharded_steps
        _assert_within_1lsb(a, b, "<i2")


def test_mesh_channels_mixed_rates(devices_ok):
    """Mixed per-channel output rates dispatch per rate group on the mesh
    (each group's channels divide the channel axis), bytes equal to the
    unsharded run."""
    raw = i16_stream(2048 * 16 * 2 + 3000)

    def specs():
        return [
            ChannelSpec(name="a", scheduler=ConstScheduler(-30000.0),
                        out_rate=48000.0),
            ChannelSpec(name="b", scheduler=ConstScheduler(12000.0),
                        out_rate=48000.0),
            ChannelSpec(name="c", scheduler=ConstScheduler(50000.0),
                        out_rate=32000.0),
            ChannelSpec(name="d", scheduler=ConstScheduler(-4000.0),
                        out_rate=32000.0),
        ]

    def run(mesh):
        mp = MultiChannelPipeline(FS, "i16", "i16", specs(),
                                  chunk_blocks=16, mesh=mesh)
        outs = [io.BytesIO() for _ in range(4)]
        mp.run(io.BytesIO(raw), outs)
        return mp, [o.getvalue() for o in outs]

    _, a = run(None)
    mp, b = run(make_mesh(time=2, channel=2))
    assert a == b and all(len(x) > 0 for x in a)
    assert ("rs", 0) in mp._sharded_steps and ("rs", 1) in mp._sharded_steps


def test_mesh_channels_cascade_checkpoint_resume(devices_ok):
    """A channel-sharded cascade run cut at a chunk boundary, checkpointed
    and resumed (still sharded) reproduces the uninterrupted sharded run
    bitwise, and the unsharded run within the 1-LSB contract."""
    from doppler_tpu.runtime import checkpoint

    raw = i16_stream(2048 * 16 * 4)
    mesh = make_mesh(channel=4)
    _, full = _channels_run(FS, mesh, raw)
    _, ref = _channels_run(FS, None, raw)
    cut = 2048 * 16 * 2 * 4

    def mk():
        specs = [ChannelSpec(name=f"ch{k}",
                             scheduler=ConstScheduler(-30000.0 + 8000 * k))
                 for k in range(8)]
        return MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                                    chunk_blocks=16, mesh=mesh,
                                    resample_stages="multi")

    p1 = mk()
    o1 = [io.BytesIO() for _ in range(8)]
    p1.run(io.BytesIO(raw[:cut]), o1)
    state = io.BytesIO()
    checkpoint.save_channels(state, p1)
    state.seek(0)
    p2 = mk()
    meta = checkpoint.restore_channels(state, p2)
    assert meta["samples_in"] * 4 == cut
    o2 = [io.BytesIO() for _ in range(8)]
    p2.run(io.BytesIO(raw[cut:]), o2)
    got = [x.getvalue() + y.getvalue() for x, y in zip(o1, o2)]
    assert got == full
    _assert_within_1lsb(ref, got, "<i2")


def test_mesh_channels_cascade_mixed_rate_groups(devices_ok):
    """Rate groups of different kinds on one channel mesh: a cascade group,
    a single-stage group and an unresampled group each run their own
    sharded step, matching the unsharded run."""
    raw = i16_stream(2048 * 16 * 2 + 3000)
    rates = [48000.0, 48000.0, 512000.0, 512000.0, None, None]
    kw = dict(n=6, rates=rates, out_rate=None, stages="auto")
    mp0, a = _channels_run(FS, None, raw, **kw)
    mp, b = _channels_run(FS, make_mesh(channel=2), raw, **kw)
    kinds = {k for k, _ in mp._sharded_steps}
    assert kinds == {"casc", "rs", "mix"}, kinds
    _assert_within_1lsb(a, b, "<i2")


def test_mesh_config5_literal_rate_sharded(devices_ok):
    """BASELINE config 5's literal rate (100 Msps → 48 ksps: ÷16, ÷16,
    then 384/3125) on a channel=4 mesh: the sharded XLA cascade engages
    and matches the unsharded run (≤1 LSB, identical lengths)."""
    fs = 100_000_000
    raw = np.random.default_rng(5).integers(
        -9000, 9000, size=2 * 2048 * 64, dtype=np.int16
    ).astype("<i2").tobytes()

    def run(mesh):
        specs = [ChannelSpec(name=f"c{k}",
                             scheduler=ConstScheduler(1e6 * (k - 1.5)))
                 for k in range(4)]
        mp = MultiChannelPipeline(fs, "i16", "i16", specs, out_rate=48000,
                                  chunk_blocks=32, mesh=mesh,
                                  resample_stages="multi")
        outs = [io.BytesIO() for _ in specs]
        mp.run(io.BytesIO(raw), outs)
        return mp, [o.getvalue() for o in outs]

    mp, a = run(None)
    assert [(st.P, st.Q) for st in mp.resampler.stages] == [
        (1, 16), (1, 16), (384, 3125)]
    m, b = run(make_mesh(channel=4))
    assert ("casc", 0) in m._sharded_steps
    _assert_within_1lsb(a, b, "<i2")


@pytest.mark.parametrize("where", ["stream", "channels", "cli"])
def test_mesh_time_sharded_cascade_is_refused(devices_ok, where):
    """A cascade on a time-sharded mesh is a configuration error naming
    the alternatives — it never runs on the first device instead."""
    if where == "stream":
        pipe = Pipeline(FS, "i16", "i16", ConstScheduler(0.0),
                        chunk_blocks=16, mesh=make_mesh(time=2))
        with pytest.raises(ValueError, match="resample-stages single"):
            attach_resampler(pipe, 48000, stages="multi")
        assert pipe.resampler is None
    elif where == "channels":
        with pytest.raises(ValueError, match="channel=N only"):
            _channels_run(FS, make_mesh(time=2, channel=2), b"")
    else:
        import logging

        from doppler_tpu.cli import main

        logger = logging.getLogger("doppler_tpu")
        saved = (list(logger.handlers), logger.propagate, logger.level)
        try:
            rc = main(["const", "-s", str(FS), "-i", "i16", "--shift", "0",
                       "--resample-to", "48000", "--mesh", "time=2",
                       "--chunk-blocks", "16", "--platform", "cpu"],
                      stdin=io.BytesIO(i16_stream(2048)),
                      stdout=io.BytesIO())
            assert rc == 1
        finally:
            logger.handlers, logger.propagate = saved[0], saved[1]
            logger.setLevel(saved[2])


def test_mesh_channels_uneven_rate_group_is_refused(devices_ok):
    """A rate group whose channels do not divide over the channel axis has
    no sharded step; it is refused rather than run unsharded."""
    specs = [ChannelSpec(name=f"c{k}", scheduler=ConstScheduler(0.0),
                         out_rate=48000.0 if k < 3 else None)
             for k in range(4)]
    with pytest.raises(ValueError, match="rate group of 3"):
        MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=16,
                             mesh=make_mesh(channel=2))
