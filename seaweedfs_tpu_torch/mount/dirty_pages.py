"""Write-back cache of one contiguous dirty byte range per open file.

Reference: weed/filesys/dirty_page.go:17-220. Writes accumulate in a
single contiguous buffer; a write that is non-contiguous, overflows the
buffer, or exceeds the chunk size limit forces a flush (assign fid +
upload to a volume server), yielding FileChunks that overlay earlier ones
by mtime.

A copy of seaweedfs_tpu/mount/dirty_pages.py in the PyTorch port.
"""

from __future__ import annotations

import time

from ..filer.filechunks import FileChunk


class ContinuousDirtyPages:
    def __init__(self, file) -> None:
        self.file = file
        self.offset = 0
        self.size = 0
        self.data: bytearray | None = None

    @property
    def _limit(self) -> int:
        return self.file.wfs.option.chunk_size_limit

    async def add_page(self, offset: int, data: bytes) -> list[FileChunk]:
        """Buffer [offset, offset+len) and return any chunks flushed to
        make room (dirty_page.go:44-120)."""
        if len(data) > self._limit:
            # larger than the buffer can ever hold: flush what we have,
            # then save the oversized write directly, split into
            # chunk-size pieces (dirty_page.go flushAndSave :122-160)
            return await self._flush_and_save(offset, data)

        chunks: list[FileChunk] = []
        if self.data is None:
            self.data = bytearray(self._limit)

        out_of_range = (
            offset < self.offset
            or offset >= self.offset + self._limit
            or self.offset + self._limit < offset + len(data))
        if out_of_range:
            # out of the buffer window: flush and restart the window here
            # (dirty_page.go:62-83)
            saved = await self._save_existing()
            if saved is not None:
                chunks.append(saved)
            self.offset = offset
            self.data[:len(data)] = data
            self.size = len(data)
            return chunks

        if self.size == 0:
            # empty buffer (fresh handle, or just flushed): restart the
            # window wherever this write lands
            self.offset = offset
            self.data[:len(data)] = data
            self.size = len(data)
            return chunks

        if offset != self.offset + self.size:
            if offset == self.offset and self.size < len(data):
                # re-write from the start that extends the buffered range
                # (dirty_page.go:87-91)
                self.data[:len(data)] = data
                self.size = len(data)
                return chunks
            # non-append write inside the window: the buffer only holds
            # one contiguous run, so flush it and save this write as its
            # own chunk (dirty_page.go:92-97)
            return await self._flush_and_save(offset, data)

        start = offset - self.offset
        self.data[start:start + len(data)] = data
        self.size = start + len(data)
        return chunks

    async def _flush_and_save(self, offset: int,
                              data: bytes) -> list[FileChunk]:
        chunks: list[FileChunk] = []
        saved = await self._save_existing()
        if saved is not None:
            chunks.append(saved)
        for i in range(0, len(data), self._limit):
            piece = data[i:i + self._limit]
            chunks.append(await self._save_to_storage(offset + i, piece))
        return chunks

    async def flush(self) -> FileChunk | None:
        """Save any remaining buffered range (saveExistingPagesToStorage,
        dirty_page.go:162-177)."""
        return await self._save_existing()

    async def _save_existing(self) -> FileChunk | None:
        if self.size == 0 or self.data is None:
            return None
        chunk = await self._save_to_storage(
            self.offset, bytes(self.data[:self.size]))
        self.size = 0
        return chunk

    async def _save_to_storage(self, offset: int,
                               data: bytes) -> FileChunk:
        """assign + upload one chunk (dirty_page.go:179-210)."""
        wfs = self.file.wfs
        fid, etag = await wfs.save_data_as_chunk(data)
        return FileChunk(file_id=fid, offset=offset, size=len(data),
                         mtime=time.time_ns(), etag=etag)

    def release(self) -> None:
        self.data = None
        self.size = 0
