"""The port's CLI: `python -m seaweedfs_tpu_torch.cli volume ...` starts a
volume server of the port that answers HTTP, with `-ecBackend cpu` on a
host without a CUDA device; `-ecBackend gpu` and `auto` fail at start-up
there and never serve EC on the CPU; modes and flags whose modules are
not ported yet exit with a message that says so."""

from __future__ import annotations

import asyncio
import os
import re
import subprocess
import sys
import time

import aiohttp
import pytest
import torch

from test_torch_cluster_util import dead_master

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDLE = b"served by the port's volume server\n" * 100


def _cli(*args: str) -> list[str]:
    return [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume",
            "-port", "0", "-master", dead_master(),
            "-timeline.interval", "0", *args]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the flag, not the environment, picks the engine
    env["SWTPU_TORCH_EC_BACKEND"] = "gpu"
    return env


def _read_url(proc: subprocess.Popen, deadline_s: float = 60.0) -> str:
    """The host:port of the server's 'listening on' line."""
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(r"listening on (\S+),", line)
        if m:
            return m.group(1)
    proc.kill()
    raise AssertionError(f"no 'listening on' line; stderr: "
                         f"{proc.stderr.read()[-2000:]}")


def test_cli_volume_serves_status_and_ec_generate(tmp_path):
    proc = subprocess.Popen(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path)), cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        url = _read_url(proc)

        async def drive():
            async with aiohttp.ClientSession() as http:
                async with http.get(f"http://{url}/status") as r:
                    assert r.status == 200
                    assert (await r.json())["volumes"] == []
                async with http.post(f"http://{url}/admin/volume/allocate",
                                     params={"volume": "3"}) as r:
                    assert r.status == 200
                async with http.post(f"http://{url}/3,1deadbeef",
                                     data=NEEDLE) as r:
                    assert r.status == 201
                async with http.post(f"http://{url}/admin/volume/readonly",
                                     params={"volume": "3"}) as r:
                    assert r.status == 200
                async with http.post(f"http://{url}/admin/ec/generate",
                                     params={"volume": "3"}) as r:
                    assert r.status == 200, await r.text()
                    body = await r.json()
                assert body["ok"] and body["dispatches"] >= 1
                async with http.get(f"http://{url}/3,1deadbeef") as r:
                    assert r.status == 200 and await r.read() == NEEDLE
        asyncio.run(drive())
        assert all(os.path.exists(tmp_path / ("3.ec%02d" % s))
                   for s in range(14))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


@pytest.mark.parametrize("backend", ["gpu", "auto"])
def test_cli_gpu_backend_without_a_card_fails_loudly(tmp_path, backend):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        _cli("-ecBackend", backend, "-dir", str(tmp_path)), cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "listening on" not in proc.stdout
    assert f"-ecBackend {backend}" in proc.stderr
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flags,names", [
    (["-workers", "2"], "worker supervisor"),
    (["-slo", "volume.read:p99<50ms@99.9"], "stats/slo.py"),
    (["-cpuprofile", "cpu.prof"], "util/pprof.py"),
    (["-profile.hz", "10"], "stats/profiler.py"),
])
def test_cli_unported_modes_exit_with_a_message(tmp_path, flags, names):
    proc = subprocess.run(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path), *flags), cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert names in proc.stderr
    assert "not ported to seaweedfs_tpu_torch yet" in proc.stderr
    assert "listening on" not in proc.stdout
