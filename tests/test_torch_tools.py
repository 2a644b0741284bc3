"""The port's operational drivers (seaweedfs_tpu_torch/tools/): copies of
the JAX package's tools/soak.py, tools/chaos.py, the three wire smokes
and their harness tools/procutil.py, pointed at the port's CLI. They
keep the reference's scenario names and exit codes, count bad reads as
it does, spawn only `python -m seaweedfs_tpu_torch.cli` with nothing
forced (SWTPU_TORCH_EC_BACKEND=cpu from the caller's environment is how
a test on a host without a card asks for the CPU), and the rebuild soak
runs end to end against the port with zero bad reads."""

from __future__ import annotations

import asyncio
import contextlib
import importlib.util
import io
import os
import random
import socket
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu_torch.tools import chaos, procutil, soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port_block(n: int, lo: int = 25000, hi: int = 30000) -> int:
    """The first of n consecutive free ports, below the kernel's
    ephemeral range (no port-0 bind or outgoing connection takes one
    there): the drivers place their daemons at fixed offsets from a base
    port. Each port is bound once, without SO_REUSEADDR, to prove it
    free, then released for the daemon that takes it."""
    rng = random.Random()
    for _ in range(200):
        start = rng.randrange(lo, hi - n)
        socks = []
        try:
            for p in range(start, start + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return start
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports in [{lo}, {hi})")


def _reference(name: str):
    """The JAX package's driver tools/<name>.py as a module (it puts
    tools/ on sys.path itself, for its `import procutil`)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _children() -> list[int]:
    """Pids whose parent is this process, from /proc."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid():
            out.append(int(pid))
    return out


def test_soak_scenarios_match_the_reference():
    ref = _reference("soak")
    assert list(soak.SCENARIOS) == list(ref.SCENARIOS)
    assert soak.BASE_PORT == ref.BASE_PORT == 21500
    assert (chaos.BASE_PORT, chaos.HA_PORT) == (23400, 23500)
    ref_chaos = _reference("chaos")
    assert (chaos.VOLUME_FAILPOINTS, chaos.VOLUME_LATENCY,
            chaos.MASTER_FAILPOINTS, chaos.HA_TIMEOUT, chaos.HA_PULSE) \
        == (ref_chaos.VOLUME_FAILPOINTS, ref_chaos.VOLUME_LATENCY,
            ref_chaos.MASTER_FAILPOINTS, ref_chaos.HA_TIMEOUT,
            ref_chaos.HA_PULSE)


def _driver_run(argv_ref: list[str], argv_port: list[str]):
    env = dict(os.environ, PYTHONPATH=REPO)
    ref = subprocess.run([sys.executable, *argv_ref], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    port = subprocess.run([sys.executable, "-m", *argv_port], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    return ref, port


@pytest.mark.parametrize("args", [["--help"], ["no-such-scenario"]])
def test_soak_exit_codes_match_the_reference(args):
    ref, port = _driver_run(["tools/soak.py", *args],
                            ["seaweedfs_tpu_torch.tools.soak", *args])
    assert ref.returncode == port.returncode == 1
    # the same refusal, naming every scenario in the same order
    assert port.stderr.strip() == ref.stderr.strip()
    assert "choose from: all, ec, vacuum-race, rebuild" in port.stderr


@pytest.mark.parametrize("args", [["--help"], ["ha", "--help"],
                                  ["no-such-scenario"],
                                  ["--no-such-flag"]])
def test_chaos_exit_codes_match_the_reference(args):
    ref, port = _driver_run(["tools/chaos.py", *args],
                            ["seaweedfs_tpu_torch.tools.chaos", *args])
    assert ref.returncode == port.returncode
    if args[-1] == "--help":
        assert ref.returncode == 0
        # the same options (the usage line names the program)
        opts = [ln.split()[0] for ln in port.stdout.splitlines()
                if ln.startswith("  -")]
        assert opts == [ln.split()[0] for ln in ref.stdout.splitlines()
                        if ln.startswith("  -")]
        assert "--quick" in opts and "--error-bound" in opts
    else:
        assert ref.returncode == 2
        assert port.stderr.splitlines()[-1].split(": ", 1)[1] \
            == ref.stderr.splitlines()[-1].split(": ", 1)[1]


class FakeClient:
    """upload_data hands out fids in call order; read answers a wrong
    body for the first fid, raises for the second and the stored body
    for every other."""

    def __init__(self):
        self.stored: dict[str, bytes] = {}

    async def upload_data(self, data: bytes, replication: str = "") -> str:
        fid = f"3,{len(self.stored):08x}"
        self.stored[fid] = data
        return fid

    async def read(self, fid: str) -> bytes:
        order = list(self.stored)
        if fid == order[0]:
            return self.stored[fid][:-1] + b"?"
        if fid == order[1]:
            raise ConnectionResetError("peer went away")
        return self.stored[fid]


def test_fill_and_verify_count_bad_reads_as_the_reference():
    ref = _reference("soak")
    seen = {}
    for name, mod in (("ref", ref), ("port", soak)):
        client, payloads = FakeClient(), {}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            asyncio.run(mod.fill(client, payloads, 40, random.Random(12),
                                 replication="000"))
            bad = asyncio.run(mod.verify(client, payloads, "after fill"))
        seen[name] = (payloads, bad, out.getvalue())
    assert seen["port"] == seen["ref"]
    payloads, bad, printed = seen["port"]
    assert len(payloads) == 40 and bad == 2
    assert "after fill: bad=2/40" in printed
    assert "MISMATCH" in printed and "ERR ConnectionResetError" in printed


def test_procs_spawns_the_port_cli_and_forces_nothing(monkeypatch,
                                                      tmp_path):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    procs = soak.Procs(str(tmp_path))
    assert "JAX_PLATFORMS" not in procs.env
    assert "SWTPU_TORCH_EC_BACKEND" not in procs.env
    assert procs.env["PYTHONPATH"] == REPO == procutil.REPO
    # the caller's choice passes through as it is
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    assert soak.Procs(str(tmp_path)).env["SWTPU_TORCH_EC_BACKEND"] == "cpu"

    spawned = []

    class Popen:
        def __init__(self, argv, **kw):
            spawned.append((argv, kw))
            self.pid = 0

    monkeypatch.setattr(procutil.subprocess, "Popen", Popen)
    asyncio.run(procs.spawn("master", "-port", "1"))
    argv, kw = spawned[0]
    assert argv == [sys.executable, "-m", "seaweedfs_tpu_torch.cli",
                    "master", "-port", "1"]
    assert kw["env"] is procs.env and kw["cwd"] == REPO
    assert os.path.exists(tmp_path / "proc0.log")


def test_procs_brings_up_a_port_cluster_and_kills_it(monkeypatch,
                                                     tmp_path):
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    port = free_port_block(2)
    master = f"127.0.0.1:{port}"

    async def drive() -> list:
        procs = procutil.Procs(str(tmp_path))
        try:
            await procs.spawn("master", "-port", str(port),
                              "-mdir", str(tmp_path / "m"),
                              "-pulseSeconds", "1")
            await procs.spawn("volume", "-port", str(port + 1),
                              "-dir", str(tmp_path / "v"), "-max", "4",
                              "-master", master, "-pulseSeconds", "1")
            await procutil.wait_assign(master, tries=60)
            assert all(p.poll() is None for p in procs.procs)
        finally:
            procs.kill_all()
        return procs.procs

    started = asyncio.run(drive())
    assert [p.returncode for p in started] == [-9, -9]
    assert not set(p.pid for p in started) & set(_children())
    with open(tmp_path / "proc1.log") as f:
        assert "volume server listening on" in f.read()


def test_a_volume_without_card_or_variable_is_never_assignable(
        monkeypatch, tmp_path):
    """With no SWTPU_TORCH_EC_BACKEND and no card, the volume server the
    harness spawns runs `auto` (the GPU) and exits at start-up: the
    driver fails in wait_assign and never falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    port = free_port_block(2)
    master = f"127.0.0.1:{port}"

    async def drive() -> None:
        procs = procutil.Procs(str(tmp_path))
        try:
            await procs.spawn("master", "-port", str(port),
                              "-mdir", str(tmp_path / "m"))
            vol = await procs.spawn("volume", "-port", str(port + 1),
                                    "-dir", str(tmp_path / "v"),
                                    "-master", master)
            await asyncio.to_thread(vol.wait, 120)
            with pytest.raises(RuntimeError, match="never became"):
                await procutil.wait_assign(master, tries=3)
        finally:
            procs.kill_all()

    asyncio.run(drive())
    with open(tmp_path / "proc1.log") as f:
        assert "-ecBackend auto" in f.read()


def test_rebuild_scenario_runs_against_the_port(monkeypatch, tmp_path):
    """scenario_rebuild end to end, in process: a port master and 4 port
    volume servers as subprocesses on a moved port block, 900 files,
    ec.encode, a SIGKILLed shard holder, ec.rebuild — 0 bad reads in all
    three verify passes, and no child left."""
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    base = free_port_block(5)
    monkeypatch.setattr(soak, "BASE_PORT", base - 20)
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        bad = asyncio.run(soak.scenario_rebuild(str(tmp_path)))
    printed = out.getvalue()
    assert bad == 0, printed
    for tag in ("after encode", "degraded (server killed)",
                "after ec.rebuild"):
        assert f"  {tag}: bad=0/900" in printed, printed
    assert time.monotonic() - t0 < 240
    assert _children() == []
    logs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".log"))
    assert logs == [f"proc{i}.log" for i in range(5)]
