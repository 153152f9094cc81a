"""chip_smoke.py and the conformance builders it shares, on the CPU.

The smoke run itself needs a GPU; here it must refuse, and its phases and
scoring helpers run at tiny sizes through the same in-process CLI."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from doppler_tpu import oracle
from doppler_tpu.ops.resample import resample_oracle
from tools import conformance as cf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_chip_smoke_refuses_without_a_gpu():
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no gpu" in p.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo next to it, the script fails and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_bench_refuses_without_a_gpu():
    p = subprocess.run([sys.executable, "bench.py", "--samples", "65536"],
                       cwd=REPO, env=_cpu_env(), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_trace_config_refuses_without_a_gpu(tmp_path):
    """The tracing tool's idle share must never come from a CPU run by
    accident: without a GPU it exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "tools/trace_config.py", "--config",
                        "3", "--seconds", "0.1", "--out", str(tmp_path)],
                       cwd=REPO, env=_cpu_env(), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no gpu" in p.stderr.lower()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("a,b,want", [
    (b"\x01\x00\x02\x00", b"\x01\x00\x02\x00", (0, 0)),
    (b"\x01\x00\x02\x00", b"\x02\x00\x02\x00", (1, 1)),
    (b"\x01\x00\x02\x00", b"\x01\x00", (-1, -1)),
])
def test_byte_diff(a, b, want):
    assert cs.byte_diff(a, b) == want


@pytest.mark.parametrize("snr,size_ok,want", [
    (60.5, True, True), (59.9, True, False), (90.0, False, False),
])
def test_conformance_bar(snr, size_ok, want):
    assert cf.passes(snr, size_ok) is want


def test_scores_quantize_like_the_reference():
    x = (0.3 * np.exp(2j * np.pi * 0.01 * np.arange(500))).astype(np.complex64)
    assert cf.score_i16(oracle.encode_i16_bytes(x), x) == (float("inf"), True)
    assert cf.score_i16(oracle.encode_i16_bytes(x[:-1]), x) == (0.0, False)
    snr, ok = cf.score_f32(oracle.encode_f32_bytes(x * 1.001), x)
    assert ok and 55.0 < snr < 65.0


@pytest.mark.parametrize("P,Q,T", [(3, 64, 21), (1, 2, 7), (5, 7, 12)])
def test_resample_oracle_is_the_defining_sum(P, Q, T):
    """The batched golden model equals y[m] = Σ_l bank[(mQ)%P, l]·x[⌊mQ/P⌋−l]
    written out term by term."""
    rng = np.random.default_rng(P * 100 + Q)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300))
    bank = rng.standard_normal((P, T)).astype(np.float32)
    got = resample_oracle(x.astype(np.complex64), P, Q, bank)
    xc = x.astype(np.complex64)
    want = []
    for m in range(len(got)):
        n, p = (m * Q) // P, (m * Q) % P
        want.append(sum(float(bank[p, l]) * complex(xc[n - l])
                        for l in range(T) if n - l >= 0))
    assert (len(got) - 1) * Q // P <= len(x) - 1 < len(got) * Q // P + Q
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_config5_channels_are_seeded_in_band_f32():
    a, b = cf.config5_channels(256), cf.config5_channels(256)
    assert a == b and len(set(a)) == 256
    assert all(abs(s) <= 40e6 and float(np.float32(s)) == s for s in a)


@pytest.mark.parametrize("which", ["1", "2", "3-i16", "3-f32", "3auto-i16",
                                   "3auto-f32", "4", "5"])
def test_conformance_configs_in_process(which, tmp_path):
    """Each config builder, driven through the in-process CLI runner that
    chip_smoke.py uses, meets the conformance bar at a CPU size."""
    t = str(tmp_path)
    run = cs.run_cli
    if which == "1":
        res = cf.config1(run, n=20000)
    elif which == "2":
        res = cf.config2(t, run, blocks=24)
    elif which.startswith("3"):
        kind, ot = which.split("-")
        res = cf.config3(t, run, blocks=48, outtype=ot,
                         stages="auto" if kind == "3auto" else "single")
        if ot == "f32":
            assert res[1] > 70.0
    elif which == "4":
        res = cf.config4(t, run, n=8192 * 2)
    else:
        shifts = cf.config5_channels(4) + [cf.LATTICE_SHIFT5]
        *res, _, readings = cf.config5(t, run, n=2048 * 256, shifts=shifts,
                                       scored=[0, 3], watched=[4])
        assert list(readings) == [4] and np.isfinite(readings[4])
    name, snr, size_ok = res
    assert cf.passes(snr, size_ok), (name, snr, size_ok)


def test_invariants_phase_holds_on_cpu(tmp_path):
    cs.invariants(str(tmp_path), 0.3)


def test_four_card_phase_rehearsal(tmp_path):
    """The --four-cards comparison on four virtual CPU devices: config 5
    under --mesh channel=4 matches the one-device bytes within 1 LSB."""
    mesh = cs.config5(str(tmp_path), 1, 8, extra=("--mesh", "channel=4"))
    one = cs.config5(str(tmp_path), 1, 8)
    for a, b in zip(mesh, one):
        n_diff, worst = cs.byte_diff(a, b)
        assert n_diff >= 0 and worst <= 1
