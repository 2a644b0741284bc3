"""WFS: the mount-wide state shared by all nodes.

Reference: weed/filesys/wfs.go:45-212 (options, handle registry, buffer
pool, deletion fan-out wfs_deletion.go:15-72). Nodes resolve metadata
through an in-proc Filer (the reference goes through filer gRPC; the node
semantics are identical) and chunk data through the master/volume tier via
WeedClient.

A copy of seaweedfs_tpu/mount/wfs.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from dataclasses import dataclass, field

from ..filer.filer import Filer
from ..util.client import WeedClient
from .dir import Dir


@dataclass
class MountOptions:
    """wfs.go Option struct (:25-43)."""
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    chunk_size_limit: int = 4 * 1024 * 1024
    data_center: str = ""
    entry_cache_ttl: float = 1.0
    gc_interval: float = 0.5


class WFS:
    def __init__(self, filer: Filer, master_url: str,
                 option: MountOptions | None = None):
        self.filer = filer
        self.master_url = master_url
        self.option = option or MountOptions()
        self.client = WeedClient(master_url)
        self.root = Dir("/", self)
        # open-handle registry keyed by full path (wfs.go:86-118)
        self.handles: dict[str, object] = {}
        # attr/entry cache with TTL (the reference leans on fuse attr
        # Valid=1s; here an explicit (entry, deadline) cache)
        self._entry_cache: dict[str, tuple[object, float]] = {}
        self._gc_task: asyncio.Task | None = None
        filer.chunk_deleter = self._queue_chunk_deletes
        self._pending_fids: list[str] = []

    async def start(self) -> None:
        await self.client.__aenter__()
        self._gc_task = asyncio.create_task(self._gc_loop())

    async def close(self) -> None:
        if self._gc_task:
            self._gc_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._gc_task
        await self.drain_deletes()
        await self.client.__aexit__()

    # ---- chunk data plane ----

    async def save_data_as_chunk(self, data: bytes) -> tuple[str, str]:
        """assign + upload; returns (fid, etag) (dirty_page.go:179-210)."""
        a = await self.client.assign(
            collection=self.option.collection,
            replication=self.option.replication,
            ttl=self.option.ttl, data_center=self.option.data_center)
        res = await self.client.upload(a["fid"], a["url"], data,
                                       ttl=self.option.ttl,
                                       auth=a.get("auth", ""))
        return a["fid"], res.get("eTag", "")

    async def read_chunk(self, fid: str, offset: int, size: int) -> bytes:
        return await self.client.read(fid, offset=offset, size=size)

    # ---- deletion fan-out (wfs_deletion.go:15-72) ----

    def _queue_chunk_deletes(self, fids: list[str]) -> None:
        self._pending_fids.extend(fids)

    async def drain_deletes(self) -> int:
        fids, self._pending_fids = self._pending_fids, []
        if not fids:
            return 0
        return await self.client.delete_fids(fids)

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(self.option.gc_interval)
            with contextlib.suppress(Exception):
                await self.drain_deletes()

    # ---- entry cache ----

    def cache_get(self, path: str):
        hit = self._entry_cache.get(path)
        if hit and time.monotonic() < hit[1]:
            return hit[0]
        self._entry_cache.pop(path, None)
        return None

    def cache_set(self, path: str, entry) -> None:
        self._entry_cache[path] = (
            entry, time.monotonic() + self.option.entry_cache_ttl)

    def cache_invalidate(self, path: str) -> None:
        self._entry_cache.pop(path, None)
