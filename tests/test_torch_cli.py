"""The port's CLI: `python -m seaweedfs_tpu_torch.cli volume ...` starts a
volume server of the port that answers HTTP, with `-ecBackend cpu` on a
host without a CUDA device; `-ecBackend gpu` and `auto` fail at start-up
there and never serve EC on the CPU; `-workers 2` serves through one
shared port, `-slo` answers /debug/health, `-profile.hz` /debug/profile,
and `-cpuprofile` writes its dump at exit. The offline tools `compact`,
`fix`, `export` and `backup` leave the same bytes as the JAX package's
CLI on copies of one volume."""

from __future__ import annotations

import asyncio
import json
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


def test_cli_volume_without_the_flag_takes_the_environment(tmp_path):
    """With no -ecBackend, an inherited SWTPU_TORCH_EC_BACKEND picks the
    engine, as it does for `server`: the soak drivers spawn plain
    `volume` daemons and ask for the CPU through the environment. The
    default used to pin `auto` over it, so on a host without a card every
    such daemon exited at start-up. An explicit flag still wins."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(_env(), SWTPU_TORCH_EC_BACKEND="cpu")
    proc = subprocess.Popen(
        _cli("-dir", str(tmp_path / "v")), cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert _read_url(proc)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    pinned = subprocess.run(
        _cli("-ecBackend", "auto", "-dir", str(tmp_path / "w")), cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert pinned.returncode != 0
    assert "-ecBackend auto" in pinned.stderr
    assert "listening on" not in pinned.stdout


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


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_http(fn, deadline_s: float = 60.0):
    """fn() until it returns without raising, within deadline_s."""
    end = time.monotonic() + deadline_s
    while True:
        try:
            return fn()
        except (OSError, AssertionError, ValueError):
            if time.monotonic() > end:
                raise
            time.sleep(0.2)


def _fetch(method: str, url: str, data: bytes | None = None,
           timeout: float = 10.0) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _started(proc: subprocess.Popen, pattern: str,
             deadline_s: float = 60.0) -> re.Match:
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(pattern, line)
        if m:
            return m
    proc.kill()
    raise AssertionError(f"no line matching {pattern!r}; stderr: "
                         f"{proc.stderr.read()[-2000:]}")


def _stop(proc: subprocess.Popen) -> None:
    proc.terminate()
    proc.wait(timeout=30)


def test_cli_workers_serve_through_the_shared_port(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path), "-workers", "2",
             "-port", str(port)), cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _started(proc, r"volume supervisor: 2 workers sharing port")
        shared = f"http://127.0.0.1:{port}"

        def rows():
            st, body = _fetch("GET", f"{shared}/stats/workers")
            got = json.loads(body)["workers"]
            assert st == 200 and len(got) == 2 and all(
                w["alive"] for w in got)
            return got

        got = _wait_http(rows)
        pids = {w["index"]: w["pid"] for w in got}
        assert len(set(pids.values())) == 2

        def sibling_found(w):
            # a worker caches a sibling's missing state file for
            # STATE_TTL and answers 503 for the sibling's volumes until
            # then: ask each worker's private listener for a volume the
            # other owns, so no request below meets that window
            other = 3 if w["index"] == 0 else 4
            st, body = _fetch("GET", f"http://{w['ip']}:{w['port']}/admin/"
                                     f"volume/status?volume={other}")
            assert st != 503, (st, body)

        for w in got:
            _wait_http(lambda w=w: sibling_found(w))
        # volumes 3 and 4 land in different partitions (vid % 2)
        for vid in (3, 4):
            st, body = _wait_http(lambda vid=vid: _ok(_fetch(
                "POST", f"{shared}/admin/volume/allocate?volume={vid}")))
            st, body = _fetch("POST", f"{shared}/{vid},1deadbeef",
                              NEEDLE + bytes([vid]))
            assert st == 201, body
        for _ in range(6):  # whichever worker takes the connection
            for vid in (3, 4):
                st, body = _fetch("GET", f"{shared}/{vid},1deadbeef")
                assert st == 200 and body == NEEDLE + bytes([vid]), \
                    (st, body[:200])
    finally:
        _stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


def _ok(answer: tuple[int, bytes]) -> tuple[int, bytes]:
    assert answer[0] == 200, answer
    return answer


def test_cli_slo_answers_debug_health(tmp_path):
    proc = subprocess.Popen(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path),
             "-slo", "volume.read:p99<50ms@99.9",
             "-timeline.interval", "1"), cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = _read_url(proc)
        st, body = _fetch("GET", f"http://{url}/debug/health")
        assert st == 200, body
        health = json.loads(body)
        assert health["status"] == "ok"
        assert [o["spec"] for o in health["objectives"]] == [
            "volume.read:p99<50ms@99.9"]
    finally:
        _stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


def test_cli_profile_hz_answers_debug_profile(tmp_path):
    proc = subprocess.Popen(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path),
             "-profile.hz", "50"), cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = _read_url(proc)

        def sampled():
            st, body = _fetch("GET", f"http://{url}/debug/profile")
            prof = json.loads(body)
            assert st == 200 and prof["running"] and prof["samples"] > 0
            return prof

        prof = _wait_http(sampled)
        assert prof["hz"] == 50
    finally:
        _stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


def test_cli_cpuprofile_writes_its_dump_at_exit(tmp_path):
    import pstats
    dump = tmp_path / "cpu.prof"
    proc = subprocess.Popen(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path / "v"),
             "-cpuprofile", str(dump)), cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = _read_url(proc)
        assert _fetch("GET", f"http://{url}/status")[0] == 200
        assert not dump.exists()
    finally:
        _stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]
    assert dump.exists() and dump.stat().st_size > 0
    pstats.Stats(str(dump))  # a parseable cProfile dump


# -- the offline volume tools, against the JAX package's CLI --------------

VID = 7


def _run_cli(package: str, *args: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-m", f"{package}.cli", *args],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, (package, args, proc.stderr[-2000:])
    return proc.stdout


def _volume_with_garbage(d) -> None:
    """Volume VID, written by the JAX package: named needles, deletes,
    an overwrite."""
    from seaweedfs_tpu.storage.needle import Needle
    from seaweedfs_tpu.storage.volume import Volume
    v = Volume(str(d), "", VID)
    for i in range(1, 25):
        v.write_needle(Needle(cookie=i, id=i, data=bytes([i]) * (300 * i),
                              name=f"file{i}.bin".encode(),
                              mime=b"application/octet-stream"))
    for i in range(2, 25, 5):
        v.delete_needle(Needle(cookie=i, id=i))
    v.write_needle(Needle(cookie=3, id=3, data=b"overwritten",
                          name=b"file3.txt", mime=b"text/plain"))
    v.close()


def _two_copies(tmp_path):
    import shutil
    src = tmp_path / "src"
    _volume_with_garbage(src)
    dirs = {}
    for package in ("seaweedfs_tpu", "seaweedfs_tpu_torch"):
        dirs[package] = tmp_path / package
        shutil.copytree(src, dirs[package])
    return dirs


def _volume_files(d) -> dict:
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))
            if name.endswith((".dat", ".idx"))}


def test_cli_compact_equals_the_reference(tmp_path):
    dirs = _two_copies(tmp_path)
    outs = {p: _run_cli(p, "compact", "-dir", str(d), "-volumeId",
                        str(VID)) for p, d in dirs.items()}
    assert outs["seaweedfs_tpu_torch"] == outs["seaweedfs_tpu"]
    assert "compacted volume 7" in outs["seaweedfs_tpu_torch"]
    assert _volume_files(dirs["seaweedfs_tpu_torch"]) == \
        _volume_files(dirs["seaweedfs_tpu"])


def test_cli_fix_equals_the_reference(tmp_path):
    dirs = _two_copies(tmp_path)
    for d in dirs.values():
        (d / f"{VID}.idx").unlink()
    outs = {p: _run_cli(p, "fix", "-dir", str(d), "-volumeId", str(VID))
            for p, d in dirs.items()}
    assert outs["seaweedfs_tpu_torch"].replace(
        str(dirs["seaweedfs_tpu_torch"]), "D") == \
        outs["seaweedfs_tpu"].replace(str(dirs["seaweedfs_tpu"]), "D")
    assert _volume_files(dirs["seaweedfs_tpu_torch"]) == \
        _volume_files(dirs["seaweedfs_tpu"])


@pytest.mark.parametrize("flags", [
    [], ["-pattern", "file1*"], ["-limit", "5"], ["-o", "OUT"],
    ["-o", "OUT", "-fileNameFormat", "{id}-{mime}"]])
def test_cli_export_equals_the_reference(tmp_path, flags):
    dirs = _two_copies(tmp_path)
    outs, tars = {}, {}
    for p, d in dirs.items():
        tar = tmp_path / f"{p}.tar"
        args = [str(tar) if f == "OUT" else f for f in flags]
        outs[p] = _run_cli(p, "export", "-dir", str(d), "-volumeId",
                           str(VID), *args).replace(str(tar), "OUT")
        tars[p] = tar.read_bytes() if tar.exists() else None
    assert outs["seaweedfs_tpu_torch"] == outs["seaweedfs_tpu"]
    assert tars["seaweedfs_tpu_torch"] == tars["seaweedfs_tpu"]
    if flags[:1] == ["-o"]:
        assert tars["seaweedfs_tpu"] is not None
        assert "exported 19 files" in outs["seaweedfs_tpu"]
    else:
        assert outs["seaweedfs_tpu"].count("\n") >= 5


def test_cli_backup_equals_the_reference(tmp_path):
    """Both CLIs back up one volume of a port volume server: its tail into
    empty directories, the incremental tail after more writes and a
    delete, then a full copy once the server's vacuum has compacted the
    volume (a new compaction revision)."""
    proc = subprocess.Popen(
        _cli("-ecBackend", "cpu", "-dir", str(tmp_path / "server")),
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        url = _read_url(proc)
        base = f"http://{url}"
        assert _fetch("POST", f"{base}/admin/volume/allocate?volume="
                              f"{VID}")[0] == 200
        for i in range(1, 9):
            assert _fetch("POST", f"{base}/{VID},{i:x}0000abcd",
                          bytes([i]) * (1000 * i))[0] == 201
        dirs = {p: tmp_path / p for p in ("seaweedfs_tpu",
                                          "seaweedfs_tpu_torch")}
        for d in dirs.values():
            d.mkdir()

        def backup_both() -> dict:
            return {p: _run_cli(p, "backup", "-dir", str(d), "-volumeId",
                                str(VID), "-server", url)
                    for p, d in dirs.items()}

        outs = backup_both()
        assert outs["seaweedfs_tpu_torch"] == outs["seaweedfs_tpu"]
        assert "applied 8 records" in outs["seaweedfs_tpu"]
        assert _volume_files(dirs["seaweedfs_tpu_torch"]) == \
            _volume_files(dirs["seaweedfs_tpu"])
        assert _fetch("POST", f"{base}/{VID},90000abcd", b"later")[0] == 201
        assert _fetch("DELETE", f"{base}/{VID},20000abcd")[0] == 200
        outs = backup_both()
        assert outs["seaweedfs_tpu_torch"] == outs["seaweedfs_tpu"]
        assert "applied 2 records" in outs["seaweedfs_tpu"]
        assert _volume_files(dirs["seaweedfs_tpu_torch"]) == \
            _volume_files(dirs["seaweedfs_tpu"])
        for step in ("compact", "commit"):
            assert _fetch("POST", f"{base}/admin/vacuum/{step}?volume="
                                  f"{VID}")[0] == 200, step
        outs = backup_both()
        assert outs["seaweedfs_tpu_torch"] == outs["seaweedfs_tpu"]
        assert "full copy of volume 7" in outs["seaweedfs_tpu"]
        files = _volume_files(dirs["seaweedfs_tpu"])
        assert _volume_files(dirs["seaweedfs_tpu_torch"]) == files
        st, dat = _fetch("GET", f"{base}/admin/file?volume={VID}&ext=.dat")
        assert st == 200 and files[f"{VID}.dat"] == dat
    finally:
        _stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]


def test_mount_parser_has_the_reference_flags_and_defaults():
    """`mount` takes the reference's flags with its defaults: the common
    ones, -dir (required), -collection, -replication, -ttl,
    -chunkSizeLimitMB 4 and -filerStore memory."""
    from seaweedfs_tpu import cli as ref_cli
    from seaweedfs_tpu_torch import cli
    from test_torch_cli_gateways import _actions
    assert _actions(cli.build_parser(), "mount") == \
        _actions(ref_cli.build_parser(), "mount")
    argv = ["mount", "-dir", "/mnt/weed"]
    assert vars(cli.build_parser().parse_args(argv)) == \
        vars(ref_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["mount"])


def test_bench_ec_is_parsed_and_runs_the_ports_bench(monkeypatch):
    """`bench-ec` parses as in the reference (no flags of its own) and its
    runner starts `python -m seaweedfs_tpu_torch.tools.bench` with the
    checkout on PYTHONPATH, returning the bench's exit code."""
    from seaweedfs_tpu import cli as ref_cli
    from seaweedfs_tpu_torch import cli
    assert vars(cli.build_parser().parse_args(["bench-ec"])) == \
        vars(ref_cli.build_parser().parse_args(["bench-ec"]))
    seen = []

    class Done:
        returncode = 7

    def fake_run(argv, env=None, **kw):
        seen.append((argv, env))
        return Done()

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert cli.main(["bench-ec"]) == 7
    [(argv, env)] = seen
    assert argv == [sys.executable, "-m", "seaweedfs_tpu_torch.tools.bench"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root


def test_mount_dispatch_builds_what_the_reference_builds():
    """`cli mount` hands fuse_adapter.mount the same filer store, master,
    mount point and MountOptions in the port as in the reference (each
    run in a subprocess with fuse_adapter.mount replaced by a recorder,
    so nothing is mounted); the port's process loads no jax."""
    argv = ["mount", "-dir", "/mnt/weed", "-master", "10.0.0.1:9333",
            "-collection", "pics", "-replication", "001", "-ttl", "3d",
            "-chunkSizeLimitMB", "8", "-filerStore", "memory"]
    code = (
        "import dataclasses, importlib, json, sys\n"
        "pkg = sys.argv[1]\n"
        "fa = importlib.import_module(pkg + '.mount.fuse_adapter')\n"
        "seen = {}\n"
        "def record(filer, master, mountpoint, option=None, **kw):\n"
        "    seen.update(store=type(filer.store).__name__, master=master,\n"
        "                mountpoint=mountpoint,\n"
        "                option=dataclasses.asdict(option))\n"
        "fa.mount = record\n"
        "importlib.import_module(pkg + '.cli').main(sys.argv[2:])\n"
        "seen['jax'] = any(m.split('.')[0] in ('jax', 'jaxlib')\n"
        "                  for m in sys.modules)\n"
        "print(json.dumps(seen))\n")
    out = {}
    for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
        proc = subprocess.run([sys.executable, "-c", code, pkg, *argv],
                              cwd=REPO, env=_env(), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    port, ref = out["seaweedfs_tpu_torch"], out["seaweedfs_tpu"]
    assert port.pop("jax") is False
    ref.pop("jax")
    assert port == ref
    assert port["option"]["chunk_size_limit"] == 8 << 20
    assert port["master"] == "10.0.0.1:9333"
