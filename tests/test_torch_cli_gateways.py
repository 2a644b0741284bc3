"""The port's `s3`, `webdav`, `filer.replicate` and `server` subcommands.

Their parsers hold the reference's flags and defaults (seaweedfs_tpu/
cli.py). `server -filer -s3`, `s3` and `webdav` start as subprocesses of
`python -X importtime -m seaweedfs_tpu_torch.cli` (port 0,
SWTPU_TORCH_EC_BACKEND=cpu), answer a PUT and a GET, and exit 0 on
SIGINT; none of them imports jax or seaweedfs_tpu. The combined server
takes its notification queue from a notification.toml in its working
directory, as the reference's does, and `filer.replicate -once` replays
that sqlite queue into `local:`.
"""

from __future__ import annotations

import asyncio
import os
import re
import signal
import subprocess
import sys
import time

import aiohttp
import pytest

from seaweedfs_tpu import cli as ref_cli
from seaweedfs_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATEWAY_CMDS = ("s3", "webdav", "filer.replicate", "server")


def _actions(parser, cmd: str) -> list[tuple]:
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default), a.nargs,
         repr(a.const), a.required, getattr(a.type, "__name__", None),
         type(a).__name__)
        for a in sub.choices[cmd]._actions if a.dest != "help")


@pytest.mark.parametrize("cmd", GATEWAY_CMDS)
def test_parser_has_the_reference_flags_and_defaults(cmd):
    ours = _actions(cli.build_parser(), cmd)
    theirs = _actions(ref_cli.build_parser(), cmd)
    # the common flags' types are lambdas in both; compare by name only
    assert ours == theirs
    assert vars(cli.build_parser().parse_args([cmd])) == \
        vars(ref_cli.build_parser().parse_args([cmd]))


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["SWTPU_TORCH_EC_BACKEND"] = "cpu"
    return env


class Proc:
    """A CLI subprocess whose -X importtime log goes to a file (a pipe
    would fill and stall it) and whose stdout is read for its ready
    line."""

    def __init__(self, tmp_path, name: str, args: list[str], cwd: str):
        self.err_path = os.path.join(str(tmp_path), f"{name}.err")
        self.err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "seaweedfs_tpu_torch.cli", *args], cwd=cwd, env=_env(),
            stdout=subprocess.PIPE, stderr=self.err, text=True)

    def ready(self, pattern: str, deadline_s: float = 90.0) -> re.Match:
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            line = self.proc.stdout.readline()
            if not line:
                break
            m = re.search(pattern, line)
            if m:
                return m
        self.proc.kill()
        self.proc.wait()
        self.err.close()
        with open(self.err_path) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"no line matching {pattern!r}; stderr {tail}")

    def interrupt(self) -> int:
        """SIGINT, then the exit code (killed after 30 s)."""
        self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return -9
        finally:
            self.err.close()

    def imported(self) -> list[str]:
        with open(self.err_path) as f:
            return [line.rsplit("|", 1)[-1].strip() for line in f
                    if line.startswith("import time:")]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.err.closed:
            self.err.close()


def _forbidden(mods: list[str]) -> list[str]:
    return [m for m in mods
            if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]


def _run(coro):
    return asyncio.run(coro)


async def _put_get(http, put_url: str, get_url: str, data: bytes) -> None:
    async with http.put(put_url, data=data) as r:
        assert r.status in (200, 201), await r.text()
    async with http.get(get_url) as r:
        assert r.status == 200
        assert await r.read() == data


def test_server_s3_webdav_and_replicate_as_subprocesses(tmp_path):
    work = tmp_path / "server"
    work.mkdir()
    qpath = tmp_path / "events.db"
    # the combined server's filer takes its queue from a discovered
    # notification.toml, as the reference's does
    (work / "notification.toml").write_text(
        f'[notification.sqlite]\nenabled = true\npath = "{qpath}"\n')
    procs = []
    try:
        server = Proc(tmp_path, "server", [
            "server", "-dir", str(work / "data"), "-filer", "-s3",
            "-masterPort", "0", "-volumePort", "0", "-filerPort", "0",
            "-s3Port", "0", "-timeline.interval", "0"], cwd=str(work))
        procs.append(server)
        m = server.ready(r"server up: master=(\S+) volume=(\S+) "
                         r"filer=(\S+) s3=(\S+)")
        master, _, filer, s3 = m.groups()
        s3p = Proc(tmp_path, "s3", [
            "s3", "-port", "0", "-master", master, "-dbPath",
            str(tmp_path / "s3.db"), "-timeline.interval", "0"],
            cwd=str(tmp_path))
        procs.append(s3p)
        s3_alone = s3p.ready(r"s3 gateway listening on (\S+)").group(1)
        dav = Proc(tmp_path, "webdav", [
            "webdav", "-port", "0", "-master", master, "-dbPath",
            str(tmp_path / "dav.db"), "-collection", "dav",
            "-timeline.interval", "0"], cwd=str(tmp_path))
        procs.append(dav)
        dav_url = dav.ready(r"webdav listening on (\S+) ").group(1)
        objects = {f"d{i % 2}/o{i}.bin": os.urandom(1000 + 5000 * i)
                   for i in range(4)}

        async def body():
            async with aiohttp.ClientSession() as http:
                for base in (s3, s3_alone):
                    async with http.put(f"http://{base}/bk") as r:
                        assert r.status == 200
                    for key, data in objects.items():
                        await _put_get(http, f"http://{base}/bk/{key}",
                                       f"http://{base}/bk/{key}", data)
                # the combined server's filer serves what its s3 wrote
                key, data = next(iter(objects.items()))
                async with http.get(f"http://{filer}/buckets/bk/{key}") as r:
                    assert await r.read() == data
                async with http.request("MKCOL", f"http://{dav_url}/d") as r:
                    assert r.status == 201
                await _put_get(http, f"http://{dav_url}/d/f.bin",
                               f"http://{dav_url}/d/f.bin", data)

        _run(body())
        for p in (dav, s3p):
            assert p.interrupt() == 0
            assert _forbidden(p.imported()) == []
            assert "seaweedfs_tpu_torch.cli" in p.imported() or \
                "seaweedfs_tpu_torch.security.tls" in p.imported()
        # filer.replicate -once replays the combined filer's queue
        mirror = tmp_path / "mirror"
        rep = subprocess.run(
            [sys.executable, "-X", "importtime", "-m",
             "seaweedfs_tpu_torch.cli", "filer.replicate", "-notify",
             f"sqlite:{qpath}", "-sourceMaster", master, "-sourceDir",
             "/buckets/bk", "-sink", f"local:{mirror}", "-progress",
             str(tmp_path / "progress.json"), "-once"],
            cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
            timeout=120)
        assert rep.returncode == 0, rep.stderr[-3000:]
        assert re.search(r"replicated \d+ events", rep.stdout), rep.stdout
        imported = [line.rsplit("|", 1)[-1].strip()
                    for line in rep.stderr.splitlines()
                    if line.startswith("import time:")]
        assert imported and _forbidden(imported) == []
        for key, data in objects.items():
            with open(mirror / key, "rb") as f:
                assert f.read() == data
        assert server.interrupt() == 0
        assert _forbidden(server.imported()) == []
    finally:
        for p in procs:
            p.kill()


def test_server_refuses_to_start_without_an_ec_engine(tmp_path):
    """`server` has no -ecBackend: its volume server runs get_encoder
    ("auto"), which needs a card, so with neither a card nor
    SWTPU_TORCH_EC_BACKEND it exits at start-up."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: auto is the card")
    env = _env()
    env.pop("SWTPU_TORCH_EC_BACKEND")
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "server", "-dir",
         str(tmp_path), "-masterPort", "0", "-volumePort", "0",
         "-timeline.interval", "0"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "SWTPU_TORCH_EC_BACKEND=cpu" in proc.stderr
