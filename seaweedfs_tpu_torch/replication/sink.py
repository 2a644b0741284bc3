"""Replication sinks.

Reference: weed/replication/sink/replication_sink.go:10-17 (contract),
filersink/ (re-upload chunks into the target cluster, incremental
UpdateEntry via MinusChunks — filer_sink.go:136-209), s3sink/, plus
gated stubs where the reference uses cloud SDKs (gcssink, azuresink,
b2sink).

A copy of seaweedfs_tpu/replication/sink.py in the PyTorch port.
"""

from __future__ import annotations

from ..security import tls

import asyncio
import os

import aiohttp

from ..filer.entry import Entry
from ..filer.filechunks import FileChunk, minus_chunks
from ..filer.stream import stream_chunk_views
from ..util import failpoints, tracing
from ..util.client import WeedClient
from .source import FilerSource


class ReplicationSink:
    """sink.ReplicationSink contract."""

    name = "base"

    def __init__(self) -> None:
        self.source: FilerSource | None = None

    def set_source(self, source: FilerSource) -> None:
        self.source = source

    @property
    def sink_dir(self) -> str:
        return "/"

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        pass

    async def create_entry(self, key: str, entry: Entry) -> None:
        raise NotImplementedError

    async def update_entry(self, key: str, old: Entry, new: Entry,
                           delete_chunks: bool) -> bool:
        """Returns True when an existing entry was updated in place."""
        raise NotImplementedError

    async def delete_entry(self, key: str, is_directory: bool,
                           delete_chunks: bool) -> None:
        raise NotImplementedError


class FilerSink(ReplicationSink):
    """Replicate into another cluster's filer.

    Chunk data is fetched from the source cluster and re-uploaded through
    the TARGET cluster's own master/volume tier, then the entry metadata
    is written via the target filer HTTP API (filersink/fetch_write.go:
    17-53 replicateChunks, filer_sink.go:84-133 CreateEntry).
    """

    name = "filer"

    def __init__(self, filer_url: str, target_master_url: str,
                 directory: str = "/", replication: str = "",
                 collection: str = "", ttl: str = ""):
        super().__init__()
        self.filer_url = filer_url
        self.master_url = target_master_url
        self.directory = directory.rstrip("/") or "/"
        self.replication = replication
        self.collection = collection
        self.ttl = ttl
        self._client: WeedClient | None = None
        self._http: aiohttp.ClientSession | None = None

    @property
    def sink_dir(self) -> str:
        return self.directory

    async def start(self) -> None:
        self._client = WeedClient(self.master_url)
        await self._client.__aenter__()
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=60))

    async def close(self) -> None:
        if self._client:
            await self._client.__aexit__()
        if self._http:
            await self._http.close()

    async def _replicate_chunks(
            self, chunks: list[FileChunk]) -> list[FileChunk]:
        from ..util import failpoints

        async def one(c: FileChunk) -> FileChunk:
            # chaos site: a flaky cross-cluster hop (FailpointError is
            # an OSError) surfaces to the runner, which retries the
            # whole entry — upload_data's own retry policy absorbs the
            # transient ones below it
            await failpoints.fail("replication.sink")
            data = await self.source.read_part(c.file_id)
            fid = await self._client.upload_data(
                data, collection=self.collection,
                replication=self.replication, ttl=self.ttl)
            return FileChunk(file_id=fid, offset=c.offset, size=c.size,
                             mtime=c.mtime, etag=c.etag)
        return list(await asyncio.gather(*(one(c) for c in chunks)))

    async def _find(self, key: str) -> Entry | None:
        await failpoints.fail("replication.sink.meta")
        async with self._http.get(
                tls.url(self.filer_url, "/__api__/lookup"),
                params={"path": key}) as resp:
            if resp.status != 200:
                return None
            body = await resp.json()
        return Entry(full_path=key, chunks=[
            FileChunk.from_dict(c) for c in body.get("chunks", [])])

    async def _write_meta(self, key: str, entry: Entry,
                          chunks: list[FileChunk]) -> None:
        payload = {
            "FullPath": key, "Mtime": entry.attr.mtime,
            "Crtime": entry.attr.crtime, "Mode": entry.attr.mode,
            "Uid": entry.attr.uid, "Gid": entry.attr.gid,
            "Mime": entry.attr.mime, "TtlSec": entry.attr.ttl_sec,
            "chunks": [c.to_dict() for c in chunks],
            "extended": entry.extended,
        }
        await failpoints.fail("replication.sink.meta")
        async with self._http.post(
                tls.url(self.filer_url, "/__api__/entry"),
                json=payload) as resp:
            if resp.status != 200:
                raise RuntimeError(
                    f"filer sink create_entry {key}: {await resp.text()}")

    async def create_entry(self, key: str, entry: Entry) -> None:
        if entry.is_directory:
            await self._write_meta(key, entry, [])
            return
        chunks = await self._replicate_chunks(entry.chunks)
        await self._write_meta(key, entry, chunks)

    async def update_entry(self, key: str, old: Entry, new: Entry,
                           delete_chunks: bool) -> bool:
        """Incremental diff (filer_sink.go:136-209): keep existing chunks
        minus deleted, append re-replicated new chunks."""
        existing = await self._find(key)
        if existing is None:
            return False
        deleted = minus_chunks(old.chunks, new.chunks)
        added = minus_chunks(new.chunks, old.chunks)
        kept = minus_chunks(existing.chunks, deleted)
        replicated = await self._replicate_chunks(added)
        await self._write_meta(key, new, kept + replicated)
        return True

    async def delete_entry(self, key: str, is_directory: bool,
                           delete_chunks: bool) -> None:
        params = {"recursive": "true"} if is_directory else {}
        await failpoints.fail("replication.sink.meta")
        async with self._http.delete(
                tls.url(self.filer_url, f"{key}"), params=params) as resp:
            if resp.status not in (200, 204, 404):
                raise RuntimeError(
                    f"filer sink delete {key}: {resp.status}")


class S3Sink(ReplicationSink):
    """Replicate objects into an S3-compatible endpoint (s3sink/) —
    whole-object PUTs assembled from the source chunk views."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, directory: str = "/"):
        super().__init__()
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.directory = directory.rstrip("/") or "/"
        self._http: aiohttp.ClientSession | None = None

    @property
    def sink_dir(self) -> str:
        return self.directory

    async def start(self) -> None:
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=60))
        await failpoints.fail("replication.s3")
        async with self._http.put(
                f"{self.endpoint}/{self.bucket}") as resp:
            if resp.status not in (200, 409):
                raise RuntimeError(
                    f"s3 sink: cannot ensure bucket: {resp.status}")

    async def close(self) -> None:
        if self._http:
            await self._http.close()

    def _url(self, key: str) -> str:
        return f"{self.endpoint}/{self.bucket}/{key.lstrip('/')}"

    async def _object_bytes(self, entry: Entry) -> bytes:
        buf = bytearray()
        async for block in stream_chunk_views(
                self.source.client, entry.chunks, 0, entry.size):
            buf.extend(block)
        return bytes(buf)

    async def create_entry(self, key: str, entry: Entry) -> None:
        if entry.is_directory:
            return  # S3 has no directories
        data = await self._object_bytes(entry)
        await failpoints.fail("replication.s3")
        async with self._http.put(self._url(key), data=data) as resp:
            if resp.status != 200:
                raise RuntimeError(f"s3 sink put {key}: {resp.status}")

    async def update_entry(self, key: str, old: Entry, new: Entry,
                           delete_chunks: bool) -> bool:
        await self.create_entry(key, new)  # whole-object overwrite
        return True

    async def delete_entry(self, key: str, is_directory: bool,
                           delete_chunks: bool) -> None:
        if is_directory:
            return
        await failpoints.fail("replication.s3")
        async with self._http.delete(self._url(key)) as resp:
            if resp.status not in (200, 204, 404):
                raise RuntimeError(f"s3 sink delete {key}: {resp.status}")


class LocalDirSink(ReplicationSink):
    """Materialize the replicated tree on the local filesystem — the
    simplest end-to-end sink (plays the role of the GoCDK file backends)."""

    name = "local"

    def __init__(self, root: str):
        super().__init__()
        self.root = root

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.lstrip("/"))

    async def create_entry(self, key: str, entry: Entry) -> None:
        p = self._path(key)
        if entry.is_directory:
            await tracing.run_in_executor(
                lambda: os.makedirs(p, exist_ok=True))
            return
        buf = bytearray()
        async for block in stream_chunk_views(
                self.source.client, entry.chunks, 0, entry.size):
            buf.extend(block)
        data = bytes(buf)

        def write() -> None:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(data)

        # the runner's loop also carries the source/sink http sessions:
        # disk writes leave it
        await tracing.run_in_executor(write)

    async def update_entry(self, key: str, old: Entry, new: Entry,
                           delete_chunks: bool) -> bool:
        if not os.path.exists(self._path(key)):
            return False
        await self.create_entry(key, new)
        return True

    async def delete_entry(self, key: str, is_directory: bool,
                           delete_chunks: bool) -> None:
        p = self._path(key)
        if is_directory:
            import shutil
            await tracing.run_in_executor(
                lambda: shutil.rmtree(p, ignore_errors=True))
        elif os.path.exists(p):
            await tracing.run_in_executor(os.unlink, p)


def _sinks() -> dict:
    from .cloud_sinks import AzureSink, B2Sink, GcsSink
    return {
        "filer": FilerSink,
        "s3": S3Sink,
        "local": LocalDirSink,
        "google_cloud_storage": GcsSink,
        "azure": AzureSink,
        "backblaze": B2Sink,
    }


SINKS: dict[str, type] = _sinks()
