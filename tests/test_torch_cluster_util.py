"""In-process cluster of the port's master and volume servers, for the
port's server tests (no test cases in this file).

The port of tests/cluster_util.py: one `seaweedfs_tpu_torch`
`MasterServer` and N `seaweedfs_tpu_torch` `VolumeServer`s on one event
loop, every one bound to port 0. A parity test of the wire passes the
JAX package's classes instead (`master_cls`, or `volume_cls` with
`store_cls`), so the same harness runs a reference master over port
volume servers, or reference volume servers under a port master. Set
`with_filer` before entering for a port `FilerServer` on a memory
`Filer`. While
the cluster is up, SWTPU_TORCH_EC_BACKEND is `cpu`, so the port's EC
handlers run the kernel's plain PyTorch version on this host, and torch
runs its CPU operators on one thread: several test processes share the
host, and an intra-op pool per process oversubscribes its cores. Both
are restored on exit.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import socket

import aiohttp
import torch

from seaweedfs_tpu_torch.ec.pipeline import BACKEND_ENV
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.store import Store


class Cluster:
    """Port master + N port volume servers (+ a port filer) on
    ephemeral ports."""

    def __init__(self, tmpdir: str, n_servers: int = 3,
                 racks: list[tuple[str, str]] | None = None,
                 pulse: float = 0.2, max_volumes: int = 16,
                 ec_large_block: int = 16 * 1024,
                 ec_small_block: int = 1024,
                 master_kwargs: dict | None = None,
                 master_cls=MasterServer, volume_cls=VolumeServer,
                 store_cls=Store):
        self.tmpdir = tmpdir
        self.n = n_servers
        self.racks = racks or [("dc1", "rack1")] * n_servers
        self.pulse = pulse
        self.max_volumes = max_volumes
        self.ec_large_block = ec_large_block
        self.ec_small_block = ec_small_block
        self.master_cls = master_cls
        self.volume_cls = volume_cls
        self.store_cls = store_cls
        self.master = None
        self.servers: list = []
        self.filer = None
        self.with_filer = False
        self.filer_chunk_size = 256 * 1024
        self.http: aiohttp.ClientSession | None = None
        self.master_kwargs = master_kwargs or {}
        self._env: str | None = None
        self._threads: int | None = None

    async def __aenter__(self) -> "Cluster":
        self._env = os.environ.get(BACKEND_ENV)
        os.environ[BACKEND_ENV] = "cpu"
        self._threads = torch.get_num_threads()
        torch.set_num_threads(1)
        self.master = self.master_cls(port=0, pulse_seconds=self.pulse,
                                      volume_size_limit_mb=64,
                                      **self.master_kwargs)
        await self.master.start()
        for i in range(self.n):
            d = os.path.join(self.tmpdir, f"srv{i}")
            store = self.store_cls(
                [d], max_volume_counts=[self.max_volumes],
                ec_large_block=self.ec_large_block,
                ec_small_block=self.ec_small_block)
            dc, rack = self.racks[i]
            vs = self.volume_cls(store, self.master.url, port=0,
                                 data_center=dc, rack=rack,
                                 pulse_seconds=self.pulse)
            await vs.start()
            await vs.heartbeat_once()
            self.servers.append(vs)
        if self.with_filer:
            self.filer = FilerServer(Filer("memory"), self.master.url,
                                     port=0,
                                     chunk_size=self.filer_chunk_size)
            await self.filer.start()
        self.http = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=30))
        return self

    async def __aexit__(self, *exc) -> None:
        if self.http:
            await self.http.close()
        if self.filer:
            with contextlib.suppress(Exception):
                await self.filer.stop()
        for vs in self.servers:
            with contextlib.suppress(Exception):
                await vs.stop()
        with contextlib.suppress(Exception):
            await self.master.stop()
        if self._env is None:
            os.environ.pop(BACKEND_ENV, None)
        else:
            os.environ[BACKEND_ENV] = self._env
        if self._threads is not None:
            torch.set_num_threads(self._threads)

    # -- client helpers --

    async def assign(self, **params) -> dict:
        async with self.http.get(
                f"http://{self.master.url}/dir/assign",
                params=params) as resp:
            return await resp.json()

    async def put(self, fid: str, url: str, data: bytes,
                  **params) -> tuple[int, dict]:
        async with self.http.post(f"http://{url}/{fid}", data=data,
                                  params=params) as resp:
            return resp.status, await resp.json()

    async def get(self, fid: str, url: str) -> tuple[int, bytes]:
        async with self.http.get(f"http://{url}/{fid}",
                                 allow_redirects=True) as resp:
            return resp.status, await resp.read()

    async def delete(self, fid: str, url: str) -> int:
        async with self.http.delete(f"http://{url}/{fid}") as resp:
            return resp.status

    async def heartbeat_all(self) -> None:
        for vs in self.servers:
            await vs.heartbeat_once()


def run(coro):
    return asyncio.run(coro)


def dead_master() -> str:
    """host:port where nothing listens, for a volume server started
    without a master: its heartbeats fail at once and retry."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"
