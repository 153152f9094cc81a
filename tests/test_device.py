"""Process set-up shared by the CLI, bench.py and chip_smoke.py: the compile
cache location, the device identity line, and the platform flag."""

import io
import logging
import os
import subprocess

import pytest

import jax

from doppler_tpu.cli import build_parser, main
from doppler_tpu.runtime import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_uses_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    ignored = subprocess.run(["git", "check-ignore", "-q", path], cwd=REPO)
    assert ignored.returncode == 0, ".jax_cache must be git-ignored"


def test_enable_compile_cache_leaves_an_environment_dir_alone(monkeypatch,
                                                              tmp_path):
    """With the variable set, JAX reads it itself; the helper sets no
    other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_sets_the_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert device.enable_compile_cache() == str(device.REPO_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == str(
            device.REPO_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_summary_names_platform_kind_count():
    s = device.device_summary()
    assert s == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_cli_logs_device_identity():
    """Start-up telemetry names the platform, device kind and count."""
    logger = logging.getLogger("doppler_tpu")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    buf = io.StringIO()
    try:
        # main() installs its own stderr handler first (it configures the
        # logger only when none is present); ours captures the same records
        main(["const", "-s", "256000", "-i", "i16", "--shift", "100",
              "--platform", "cpu"],
             stdin=io.BytesIO(b""), stdout=io.BytesIO())
        logger.addHandler(logging.StreamHandler(buf))
        rc = main(["const", "-s", "256000", "-i", "i16", "--shift", "100",
                   "--platform", "cpu"],
                  stdin=io.BytesIO(b"\0" * 8192), stdout=io.BytesIO())
        assert rc == 0
    finally:
        logger.handlers, logger.propagate = saved[0], saved[1]
        logger.setLevel(saved[2])
    n = len(jax.devices())
    assert f"device: platform=cpu kind=cpu count={n}" in buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--platform", "t" + "pu"],
    ["--" + "impl", "pallas"],
    ["--precision", "fast"],
])
def test_cli_has_no_kernel_or_platform_flag(argv):
    """The device formulation is not a user flag, and the only platforms
    are the default device and the CPU."""
    with pytest.raises(SystemExit):
        build_parser().parse_args(
            ["const", "-s", "256000", "-i", "i16", "--shift", "0"] + argv)


def test_no_mosaic_code_or_tmp_cache_left():
    """No Mosaic kernel import, interpreter switch or temporary-directory
    compile cache remains in program, test or tool files."""
    bad = ["pallas.t" + "pu", "plt" + "pu", "interpret" + "=",
           "pallas" + "_interpret", "/tmp/" + "jax_cache"]
    files = subprocess.run(
        ["git", "ls-files", "doppler_tpu", "tests", "tools", "bench.py",
         "chip_smoke.py", "__graft_entry__.py"],
        cwd=REPO, capture_output=True, text=True, check=True).stdout.split()
    hits = []
    for f in files:
        path = os.path.join(REPO, f)
        if not f.endswith(".py") or not os.path.exists(path):
            continue
        text = open(path, encoding="utf-8").read()
        hits += [(f, b) for b in bad if b in text]
    assert not hits, hits
