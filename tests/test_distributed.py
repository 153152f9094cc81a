"""Multi-host seam: spec parsing, byte-range readers, seek-based state
seeding, and a real two-process smoke over a localhost coordinator.

The host axis is decomposed with ZERO cross-host traffic (see
parallel/distributed.py): hosts split the capture by chunk-aligned byte
ranges and seed their state exactly from absolute stream position
(``Pipeline.seek_to_block`` — the "distribute = seek" corollary of
"resume = seek", SURVEY §5).  The two-process tests spawn real CLI
processes, each joining ``jax.distributed`` with 4 fake CPU devices
(gloo collectives), and assert the concatenated part files equal the
single-process run bitwise (VERDICT r2 item 2; BASELINE config 5 in
miniature).
"""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from doppler_tpu.parallel.distributed import (
    host_slice,
    parse_distributed_spec,
)
from doppler_tpu.runtime.pipeline import ConstScheduler, Pipeline
from doppler_tpu.runtime.stream import ByteRangeReader
from doppler_tpu.ops.resample import attach_resampler

RNG = np.random.default_rng(0xDC)
FS = 1024000
BB = 8192
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def i16_stream(n):
    return RNG.integers(-20000, 20000, size=2 * n, dtype=np.int16).astype(
        "<i2"
    ).tobytes()


def test_parse_distributed_spec():
    s = parse_distributed_spec(
        "coordinator=127.0.0.1:9999,num_processes=2,process_id=1"
    )
    assert s == {"coordinator_address": "127.0.0.1:9999",
                 "num_processes": 2, "process_id": 1}
    assert parse_distributed_spec("") == {}
    with pytest.raises(ValueError, match="isn't a valid"):
        parse_distributed_spec("nonsense")
    with pytest.raises(ValueError, match="integer"):
        parse_distributed_spec("num_processes=two")
    with pytest.raises(ValueError, match="unknown"):
        parse_distributed_spec("bogus=1")


def test_byte_range_reader():
    import tempfile

    data = bytes(range(256)) * 10
    with tempfile.NamedTemporaryFile() as f:
        f.write(data)
        f.flush()
        r = ByteRangeReader(open(f.name, "rb"), 100, 1100)
        got = b""
        while True:
            b = r.read(64)
            if not b:
                break
            got += b
        assert got == data[100:1100]
        r.close()
        r2 = ByteRangeReader(open(f.name, "rb"), 50, 60)
        assert r2.read() == data[50:60]
        assert r2.read() == b""
        r2.close()
    with pytest.raises(ValueError):
        ByteRangeReader(io.BytesIO(b""), 5, 2)


def _mk_pipe(scheduler=None, resample=True, intype="i16", stages="single"):
    p = Pipeline(FS, intype, intype, scheduler or ConstScheduler(-15000.0),
                 chunk_blocks=16)
    if resample:
        attach_resampler(p, 48000.0, stages=stages)
    return p


def _stream(intype, n):
    if intype == "i16":
        return i16_stream(n)
    return (0.4 * np.random.default_rng(n).standard_normal(2 * n)
            ).astype("<f4").tobytes()


@pytest.mark.parametrize("intype", ["i16", "f32"])
def test_seek_to_block_bitwise(intype):
    """prefix-run + seeked-suffix-run == full run, at chunk-aligned splits
    (the multi-host partition unit), for both wire formats."""
    L = BB // (4 if intype == "i16" else 8)
    raw = _stream(intype, L * 16 * 3 + 531)
    full_p = _mk_pipe(intype=intype)
    fo = io.BytesIO()
    full_p.run(io.BytesIO(raw), fo)
    full = fo.getvalue()

    split_blocks = 32                   # 2 chunks of 16
    cut = split_blocks * BB
    pre = _mk_pipe(intype=intype)
    po = io.BytesIO()
    pre.run(io.BytesIO(raw[:cut]), po)
    suf = _mk_pipe(intype=intype)
    suf.seek_to_block(split_blocks, history=raw[cut - BB:cut])
    so = io.BytesIO()
    suf.run(io.BytesIO(raw[cut:]), so)
    assert po.getvalue() + so.getvalue() == full


def test_seek_to_block_mix_only():
    raw = i16_stream(2048 * 16 * 2 + 99)
    full_p = _mk_pipe(resample=False)
    fo = io.BytesIO()
    full_p.run(io.BytesIO(raw), fo)
    cut = 16 * BB
    pre = _mk_pipe(resample=False)
    po = io.BytesIO()
    pre.run(io.BytesIO(raw[:cut]), po)
    suf = _mk_pipe(resample=False)
    suf.seek_to_block(16)               # no history needed without FIR state
    so = io.BytesIO()
    suf.run(io.BytesIO(raw[cut:]), so)
    assert po.getvalue() + so.getvalue() == fo.getvalue()


def test_seek_rejects_mid_stream_and_missing_history():
    p = _mk_pipe()
    with pytest.raises(ValueError, match="history"):
        p.seek_to_block(16)             # resampler but no history bytes
    p2 = _mk_pipe(resample=False)
    p2._sample_offset = 5
    with pytest.raises(ValueError, match="fresh"):
        p2.seek_to_block(16)


@pytest.mark.parametrize("intype", ["i16", "f32"])
def test_seek_cascade_resumes_bitwise(intype):
    """distribute = seek works for the multi-stage cascade too —
    ``seek_history_blocks()`` raw history blocks reconstruct every stage's
    FIR state, for both wire formats."""
    blocks = 48
    L = BB // (4 if intype == "i16" else 8)
    raw = _stream(intype, L * blocks)

    def mk():
        return _mk_pipe(scheduler=ConstScheduler(9000.0), intype=intype,
                        stages="multi")

    whole = io.BytesIO()
    mk().run(io.BytesIO(raw), whole)
    whole = whole.getvalue()

    k = 16                               # chunk-aligned split
    # output byte offset of the seeked host: chain per-stage ceil counts
    n_in = k * L
    for st in mk().resampler.stages:
        n_in = -(-n_in * st.P // st.Q)
    m_lo = n_in
    p2 = mk()
    h = p2.seek_history_blocks()
    p2.seek_to_block(k, history=raw[(k - h) * BB:k * BB])
    out2 = io.BytesIO()
    p2.run(io.BytesIO(raw[k * BB:]), out2)
    got = out2.getvalue()
    want = whole[m_lo * (4 if intype == "i16" else 8):]
    assert got == want and len(got) > 0


def test_seek_cascade_odd_row_geometry_bitwise():
    """A non-default block size (block_bytes=8704 → L=2176 samples, not a
    power of two) seeks the cascade bitwise: the history replay runs the
    stream's own mix kernel and cascade ``process``."""
    bb = 8704
    L = bb // 4
    blocks = 48
    raw = i16_stream(L * blocks)

    def mk():
        p = Pipeline(FS, "i16", "i16", ConstScheduler(9000.0),
                     chunk_blocks=16, block_bytes=bb)
        attach_resampler(p, 48000.0, stages="multi")
        return p

    whole = io.BytesIO()
    mk().run(io.BytesIO(raw), whole)
    whole = whole.getvalue()

    k = 16
    n_in = k * L
    for st in mk().resampler.stages:
        n_in = -(-n_in * st.P // st.Q)
    p2 = mk()
    h = p2.seek_history_blocks()
    p2.seek_to_block(k, history=raw[(k - h) * bb:k * bb])
    out2 = io.BytesIO()
    p2.run(io.BytesIO(raw[k * bb:]), out2)
    assert out2.getvalue() == whole[n_in * 4:] and out2.getvalue()


# ---------------------------------------------------------------------------
# two-process smoke (real coordinator, gloo CPU collectives)
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_cli(extra, env):
    return subprocess.Popen(
        [sys.executable, "-m", "doppler_tpu"] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env,
    )


def _run_two_hosts(base_args, tmp_path, n_local_devices=4):
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}"
    )
    procs = []
    for pid in range(2):
        dist = (f"coordinator=127.0.0.1:{port},"
                f"num_processes=2,process_id={pid}")
        procs.append(_spawn_cli(base_args + ["--distributed", dist], env))
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]


def test_two_process_stream_split(tmp_path):
    """Two CLI processes, one shared capture file, chunk-aligned byte-range
    split: concat(out.part0, out.part1) == the single-process output."""
    raw = i16_stream(2048 * 16 * 5 + 3111)   # 5 full chunks + ragged tail
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    out = tmp_path / "out.iq"
    base = ["const", "-s", str(FS), "-i", "i16", "--shift", "-15000",
            "--resample-to", "48000", "--chunk-blocks", "16",
            "--platform", "cpu", "--input", str(inp)]

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    single = tmp_path / "single.iq"
    p = _spawn_cli(base + ["--output", str(single)], env)
    _, err = p.communicate(timeout=420)
    assert p.returncode == 0, err.decode()[-3000:]

    _run_two_hosts(base + ["--output", str(out)], tmp_path)
    got = (tmp_path / "out.iq.part0").read_bytes() + (
        tmp_path / "out.iq.part1"
    ).read_bytes()
    assert got == single.read_bytes() and len(got) > 0


def test_two_process_elastic_checkpoint_restart(tmp_path):
    """Elastic recovery (round 4, VERDICT r3 next #6): host 0 of a
    two-process run is SIGTERMed mid-stream with --save-state; BOTH hosts
    are then relaunched with --load-state (per-host PATH.hK files), host 0
    appending to its part file from its checkpoint.  The concatenated parts
    must equal the single-process bytes — the uninterrupted output."""
    raw = i16_stream(2048 * 16 * 24)         # 24 chunks: long enough to
    inp = tmp_path / "in.iq"                 # interrupt host 0 mid-range
    inp.write_bytes(raw)
    out = tmp_path / "out.iq"
    ck = tmp_path / "ck.npz"
    base = ["const", "-s", str(FS), "-i", "i16", "--shift", "-15000",
            "--resample-to", "48000", "--chunk-blocks", "16",
            "--platform", "cpu", "--input", str(inp),
            "--output", str(out)]
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    single = tmp_path / "single.iq"
    p = _spawn_cli(base[:-1] + [str(single)], env)
    _, err = p.communicate(timeout=420)
    assert p.returncode == 0, err.decode()[-3000:]

    def spawn_round(extra):
        port = _free_port()
        procs = []
        for pid in range(2):
            dist = (f"coordinator=127.0.0.1:{port},"
                    f"num_processes=2,process_id={pid}")
            procs.append(_spawn_cli(
                base + extra + ["--distributed", dist], env))
        return procs

    # round 1: SIGTERM host 0 once its part file shows progress (the
    # signal handler is installed before the run loop starts writing)
    procs = spawn_round(["--save-state", str(ck)])
    part0 = tmp_path / "out.iq.part0"
    import time as _time
    deadline = _time.time() + 300
    while _time.time() < deadline:
        if part0.exists() and part0.stat().st_size > 0:
            break
        if procs[0].poll() is not None:
            break
        _time.sleep(0.05)
    if procs[0].poll() is None:
        import signal as _signal
        procs[0].send_signal(_signal.SIGTERM)
    outs = [p.communicate(timeout=420) for p in procs]
    assert procs[0].returncode in (0, 130), outs[0][1].decode()[-3000:]
    assert procs[1].returncode == 0, outs[1][1].decode()[-3000:]
    assert (tmp_path / "ck.npz.h0").exists()
    assert (tmp_path / "ck.npz.h1").exists()

    # round 2: both hosts restart from their checkpoints (fresh
    # coordinator), re-checkpointing on completion
    procs = spawn_round(["--load-state", str(ck), "--save-state", str(ck)])
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]

    got = part0.read_bytes() + (tmp_path / "out.iq.part1").read_bytes()
    assert got == single.read_bytes() and len(got) > 0

    # round 3 (ADVICE r4): re-running --load-state against checkpoints
    # written AFTER completion (resume_lo == hi, drained) must be a no-op —
    # the old behavior hit EOF instantly, drained AGAIN, and appended a
    # duplicate FIR tail to the .part file
    procs = spawn_round(["--load-state", str(ck)])
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    got = part0.read_bytes() + (tmp_path / "out.iq.part1").read_bytes()
    assert got == single.read_bytes(), \
        "completed-checkpoint restart appended bytes (duplicate drain)"


def test_two_process_channels_elastic_checkpoint(tmp_path):
    """Channels-mode elastic recovery: two channel-parallel hosts with
    per-host --save-state, host 0 SIGTERMed mid-stream, both relaunched
    with --load-state (the CLI seeks the --input capture to each host's
    checkpoint byte); per-channel outputs equal the single-process run."""
    import json
    import signal as _signal
    import time as _time

    raw = i16_stream(2048 * 16 * 20)
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    cfg = {"channels": [
        {"name": "c0", "shift": -15000.0},
        {"name": "c1", "shift": 20000.0},
    ]}
    cfg_path = tmp_path / "ch.json"
    cfg_path.write_text(json.dumps(cfg))
    ck = tmp_path / "ck.npz"
    outdir = tmp_path / "out"
    base = ["channels", "--config", str(cfg_path), "-s", str(FS),
            "-i", "i16", "--resample-to", "48000", "--chunk-blocks", "16",
            "--platform", "cpu", "--input", str(inp),
            "--output-dir", str(outdir)]
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    ref_dir = tmp_path / "ref"
    p = _spawn_cli(base[:-1] + [str(ref_dir)], env)
    _, err = p.communicate(timeout=420)
    assert p.returncode == 0, err.decode()[-3000:]

    def spawn_round(extra):
        port = _free_port()
        return [
            _spawn_cli(base + extra + [
                "--distributed",
                f"coordinator=127.0.0.1:{port},num_processes=2,"
                f"process_id={pid}"], env)
            for pid in range(2)
        ]

    procs = spawn_round(["--save-state", str(ck)])
    part0 = outdir / "c0.iq"          # host 0 owns channel c0
    deadline = _time.time() + 300
    while _time.time() < deadline:
        if part0.exists() and part0.stat().st_size > 0:
            break
        if procs[0].poll() is not None:
            break
        _time.sleep(0.05)
    if procs[0].poll() is None:
        procs[0].send_signal(_signal.SIGTERM)
    outs = [p.communicate(timeout=420) for p in procs]
    assert procs[0].returncode in (0, 130), outs[0][1].decode()[-3000:]
    assert procs[1].returncode == 0, outs[1][1].decode()[-3000:]
    assert (tmp_path / "ck.npz.h0").exists()

    procs = spawn_round(["--load-state", str(ck)])
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]

    for name in ("c0", "c1"):
        a = (ref_dir / f"{name}.iq").read_bytes()
        b = (outdir / f"{name}.iq").read_bytes()
        assert a == b and len(a) > 0, name


def test_two_process_channels_split(tmp_path):
    """Channels mode: hosts split the channel axis (zero communication);
    the union of per-channel files equals the single-process run."""
    import json

    raw = i16_stream(2048 * 16 * 2 + 777)
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    cfg = {"channels": [
        {"name": f"ch{k}", "shift": -30000.0 + 9000 * k,
         "center_offset": 250.0 * k}
        for k in range(4)
    ]}
    cfgp = tmp_path / "chan.json"
    cfgp.write_text(json.dumps(cfg))

    def base(outdir):
        return ["channels", "-s", str(FS), "-i", "i16",
                "--config", str(cfgp), "--resample-to", "48000",
                "--chunk-blocks", "16", "--platform", "cpu",
                "--input", str(inp), "--output-dir", str(outdir)]

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sdir = tmp_path / "single"
    p = _spawn_cli(base(sdir), env)
    _, err = p.communicate(timeout=420)
    assert p.returncode == 0, err.decode()[-3000:]

    ddir = tmp_path / "dist"
    _run_two_hosts(base(ddir), tmp_path)
    for k in range(4):
        a = (sdir / f"ch{k}.iq").read_bytes()
        b = (ddir / f"ch{k}.iq").read_bytes()
        assert a == b and len(a) > 0, f"ch{k} diverged"


@pytest.mark.parametrize("chunk_blocks", [32, 16])
def test_seek_multiblock_history_config5_rate(chunk_blocks):
    """distribute = seek at BASELINE config 5's literal rate
    (100 Msps → 48 ksps) — the cascade's input-referred FIR state spans
    several reference blocks, so seek_to_block takes
    ``seek_history_blocks()`` raw blocks of history (with their own plan
    constants), staying bitwise at any chunk width."""
    fs = 100_000_000

    def mk():
        p = Pipeline(fs, "i16", "i16", ConstScheduler(1e6),
                     chunk_blocks=chunk_blocks)
        attach_resampler(p, 48000, stages="multi")
        return p

    raw = np.random.default_rng(8).integers(
        -9000, 9000, size=2 * 2048 * 96, dtype=np.int16
    ).astype("<i2").tobytes()
    p0 = mk()
    n_hist = p0.seek_history_blocks()
    assert n_hist > 1        # the point of this test
    whole = io.BytesIO()
    p0.run(io.BytesIO(raw), whole)
    whole = whole.getvalue()

    k = 64
    n_in = k * 2048
    p2 = mk()
    for st in p2.resampler.stages:
        n_in = -(-n_in * st.P // st.Q)
    p2.seek_to_block(k, history=raw[(k - n_hist) * BB:k * BB])
    out = io.BytesIO()
    p2.run(io.BytesIO(raw[k * BB:]), out)
    assert out.getvalue() == whole[n_in * 4:] and out.getvalue()


def test_two_process_stream_split_heavy_rate(tmp_path):
    """Two-process split at a heavy odd-Q rate (6.25 Msps → 48 ksps): the
    CLI must read seek_history_blocks() whole raw blocks before each
    host's byte range (round 4 — one block cannot reconstruct the
    384/3125 tail's FIR state) and the concatenated parts must equal the
    single-process output bitwise."""
    fs5 = 6_250_000
    raw = i16_stream(2048 * 16 * 6)
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    out = tmp_path / "out.iq"
    base = ["const", "-s", str(fs5), "-i", "i16", "--shift", "100000",
            "--resample-to", "48000", "--chunk-blocks", "16",
            "--platform", "cpu", "--input", str(inp)]
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    # sanity: this rate really needs multi-block history
    p_heavy = Pipeline(fs5, "i16", "i16", ConstScheduler(100000.0),
                       chunk_blocks=16)
    attach_resampler(p_heavy, 48000.0, stages="multi")
    assert p_heavy.seek_history_blocks() > 1

    single = tmp_path / "single.iq"
    p = _spawn_cli(base + ["--output", str(single)], env)
    _, err = p.communicate(timeout=420)
    assert p.returncode == 0, err.decode()[-3000:]

    _run_two_hosts(base + ["--output", str(out)], tmp_path)
    got = (tmp_path / "out.iq.part0").read_bytes() + (
        tmp_path / "out.iq.part1"
    ).read_bytes()
    assert got == single.read_bytes() and len(got) > 0
