"""File node + open-handle ops.

Reference: weed/filesys/file.go (Attr/Setattr-truncate/addChunks),
filehandle.go (Read via chunk-view gather, Write via dirty pages, Flush
persisting the entry through the filer).

A copy of seaweedfs_tpu/mount/file.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import time

from ..filer.entry import Entry
from ..filer.filechunks import (FileChunk, non_overlapping_visible_intervals,
                                total_size, view_from_visibles)
from .dir import MountError
from .dirty_pages import ContinuousDirtyPages


class File:
    def __init__(self, name: str, dir: "Dir", entry: Entry | None = None):
        self.name = name
        self.dir = dir
        self.wfs = dir.wfs
        self.entry = entry
        self._view_cache = None  # entryViewCache (file.go:32)
        self.is_open = False

    @property
    def full_path(self) -> str:
        return f"{self.dir.path.rstrip('/')}/{self.name}"

    async def maybe_load_entry(self) -> Entry:
        """file.go maybeLoadEntry (:76-93)."""
        if self.entry is None or not self.is_open:
            entry = self.wfs.filer.find_entry(self.full_path)
            if entry is None:
                raise MountError("ENOENT", self.full_path)
            self.entry = entry
        return self.entry

    async def attr(self) -> dict:
        """file.go Attr (:40-66): size is chunk extent."""
        entry = await self.maybe_load_entry()
        return {"mode": entry.attr.mode, "size": total_size(entry.chunks),
                "mtime": entry.attr.mtime, "uid": entry.attr.uid,
                "gid": entry.attr.gid}

    def open(self, uid: int = 0, gid: int = 0) -> "FileHandle":
        """file.go Open (:68-74): register a handle."""
        self.is_open = True
        fh = FileHandle(self, uid, gid)
        # registry keyed by a unique handle id: concurrent opens of one
        # path must not clobber each other
        self.wfs.handles[id(fh)] = fh
        return fh

    def add_chunks(self, chunks: list[FileChunk]) -> None:
        """file.go addChunks (:139-147): append + invalidate view."""
        self.entry.chunks.extend(chunks)
        self._view_cache = None

    def views(self, offset: int, size: int):
        if self._view_cache is None:
            self._view_cache = non_overlapping_visible_intervals(
                self.entry.chunks)
        return view_from_visibles(self._view_cache, offset, size)

    async def setattr(self, size: int | None = None,
                      mode: int | None = None, uid: int | None = None,
                      gid: int | None = None,
                      mtime: float | None = None) -> None:
        """file.go Setattr (:95-137); truncation clips the chunk list."""
        entry = await self.maybe_load_entry()
        if size is not None and size < total_size(entry.chunks):
            kept: list[FileChunk] = []
            dropped: list[FileChunk] = []
            for c in entry.chunks:
                if c.offset >= size:
                    dropped.append(c)
                    continue
                if c.offset + c.size > size:
                    c.size = size - c.offset
                kept.append(c)
            entry.chunks = kept
            self._view_cache = None
            if dropped:
                self.wfs.filer.delete_chunks([c.file_id for c in dropped])
        if mode is not None:
            entry.attr.mode = (entry.attr.mode & ~0o7777) | (mode & 0o7777)
        if uid is not None:
            entry.attr.uid = uid
        if gid is not None:
            entry.attr.gid = gid
        if mtime is not None:
            entry.attr.mtime = mtime
        self.wfs.filer.update_entry(None, entry)
        self.wfs.cache_invalidate(self.full_path)

    # xattr passthrough (xattr.go)

    async def get_xattr(self, name: str) -> bytes:
        from .dir import _get_xattr
        return await _get_xattr(self.wfs, self.full_path, name)

    async def set_xattr(self, name: str, value: bytes) -> None:
        from .dir import _set_xattr
        await _set_xattr(self.wfs, self.full_path, name, value)

    async def list_xattr(self) -> list[str]:
        from .dir import _list_xattr
        return await _list_xattr(self.wfs, self.full_path)

    async def remove_xattr(self, name: str) -> None:
        from .dir import _remove_xattr
        await _remove_xattr(self.wfs, self.full_path, name)


class FileHandle:
    """filehandle.go:18-181."""

    def __init__(self, file: File, uid: int = 0, gid: int = 0):
        self.file = file
        self.uid = uid
        self.gid = gid
        self.dirty_pages = ContinuousDirtyPages(file)
        self.dirty_metadata = False

    async def read(self, offset: int, size: int) -> bytes:
        """filehandle.go Read (:49-77): clip views, gather chunk reads
        concurrently, assemble in logical order."""
        entry = await self.file.maybe_load_entry()
        end = min(offset + size, total_size(entry.chunks))
        if end <= offset:
            return b""
        views = self.file.views(offset, size)
        parts = await asyncio.gather(*(
            self.file.wfs.read_chunk(v.file_id, v.offset, v.size)
            for v in views))
        # zero-filled buffer: sparse holes (incl. trailing ones) read as
        # zeros, consistent with the HTTP streamers
        buf = bytearray(end - offset)
        for v, part in zip(views, parts):
            at = v.logic_offset - offset
            buf[at:at + len(part)] = part
        return bytes(buf)

    async def write(self, offset: int, data: bytes) -> int:
        """filehandle.go Write (:80-113)."""
        await self.file.maybe_load_entry()
        flushed = await self.dirty_pages.add_page(offset, data)
        if flushed:
            self.file.add_chunks(flushed)
        self.dirty_metadata = True
        return len(data)

    async def flush(self) -> None:
        """filehandle.go Flush (:127-181): save dirty pages, persist the
        entry through the filer (CreateEntry dedups overwritten chunks)."""
        chunk = await self.dirty_pages.flush()
        if chunk is not None:
            self.file.add_chunks([chunk])
            self.dirty_metadata = True
        if not self.dirty_metadata:
            return
        entry = self.file.entry
        entry.attr.mtime = time.time()
        if not entry.attr.crtime:
            entry.attr.crtime = entry.attr.mtime
        self.file.wfs.filer.create_entry(entry)
        self.file.wfs.cache_invalidate(self.file.full_path)
        self.dirty_metadata = False

    async def release(self) -> None:
        """filehandle.go Release (:115-125)."""
        self.dirty_pages.release()
        self.file.is_open = False
        self.file.wfs.handles.pop(id(self), None)
