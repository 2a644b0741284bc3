"""Shared process harness for the soak/chaos drivers: spawn
`seaweedfs_tpu_torch.cli` daemons with per-process log files (fork + file
open happen off the event loop) and wait for a cluster to become
assignable. One copy — a fix to spawning applies everywhere.

The daemons inherit the caller's environment with PYTHONPATH set to the
checkout root, and nothing else is forced: a volume server runs
`-ecBackend auto`, which is the GPU, unless the caller exports
SWTPU_TORCH_EC_BACKEND=cpu. Without a card and without that variable a
volume server exits at start-up and `wait_assign` fails; it never falls
back to the CPU."""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Procs:
    def __init__(self, tmp: str):
        self.tmp = tmp
        self.procs: list[subprocess.Popen] = []
        self.env = dict(os.environ, PYTHONPATH=REPO)

    def _spawn_sync(self, *args: str) -> subprocess.Popen:
        log = open(os.path.join(
            self.tmp, f"proc{len(self.procs)}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
            stdout=log, stderr=subprocess.STDOUT, env=self.env,
            cwd=REPO)
        self.procs.append(p)
        return p

    async def spawn(self, *args: str) -> subprocess.Popen:
        # log-file open + fork happen off the loop: drivers spawn
        # servers while foreground load is already in flight
        return await asyncio.to_thread(self._spawn_sync, *args)

    def kill_all(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in self.procs:
            p.wait(timeout=10)


async def wait_assign(master: str, params: str = "",
                      tries: int = 30) -> None:
    def probe() -> bool:
        try:
            with urllib.request.urlopen(
                    f"http://{master}/dir/assign?{params}",
                    timeout=3) as r:
                return b"fid" in r.read()
        except OSError:
            return False

    for _ in range(tries):
        if await asyncio.to_thread(probe):
            return
        await asyncio.sleep(1)
    raise RuntimeError("cluster never became assignable")
