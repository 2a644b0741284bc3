"""Chunk overlay algebra: resolve overwrites among a file's chunk list.

Reference: weed/filer2/filechunks.go:121-222. Entries hold []FileChunk
(fid, offset, size, mtime); later-mtime chunks overwrite earlier byte
ranges. NonOverlappingVisibleIntervals folds chunks (sorted by mtime) into
a sorted list of visible intervals; ViewFromChunks clips that to a read
range, yielding (fid, offset-in-chunk, size, logical-offset) views.

A copy of seaweedfs_tpu/filer/filechunks.py in the PyTorch port.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FileChunk:
    file_id: str
    offset: int
    size: int
    mtime: int  # monotonically increasing per overwrite (ns)
    etag: str = ""

    def to_dict(self) -> dict:
        return {"file_id": self.file_id, "offset": self.offset,
                "size": self.size, "mtime": self.mtime, "etag": self.etag}

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(file_id=d["file_id"], offset=d["offset"], size=d["size"],
                   mtime=d["mtime"], etag=d.get("etag", ""))


@dataclass(frozen=True)
class VisibleInterval:
    start: int
    stop: int
    file_id: str
    mtime: int
    chunk_offset: int = 0  # where this interval starts inside its chunk
    is_full_chunk: bool = False


@dataclass(frozen=True)
class ChunkView:
    file_id: str
    offset: int       # start within the stored chunk blob
    size: int
    logic_offset: int  # position in the logical file
    is_full_chunk: bool = False


def total_size(chunks: list[FileChunk]) -> int:
    """Max covered extent (filechunks.go TotalSize)."""
    return max((c.offset + c.size for c in chunks), default=0)


def etag(chunks: list[FileChunk]) -> str:
    if not chunks:
        return ""
    if len(chunks) == 1:
        return chunks[0].etag
    import hashlib
    h = hashlib.md5()
    for c in chunks:
        h.update(c.etag.encode())
    return h.hexdigest()


def non_overlapping_visible_intervals(
        chunks: list[FileChunk]) -> list[VisibleInterval]:
    """Fold chunks by mtime into sorted non-overlapping visible intervals
    (filechunks.go:181-199)."""
    visibles: list[VisibleInterval] = []
    for c in sorted(chunks, key=lambda x: x.mtime):
        new_stop = c.offset + c.size
        out: list[VisibleInterval] = []
        for v in visibles:
            if v.start < c.offset and c.offset < v.stop:
                out.append(VisibleInterval(
                    v.start, c.offset, v.file_id, v.mtime,
                    chunk_offset=v.chunk_offset, is_full_chunk=False))
            if v.start < new_stop and new_stop < v.stop:
                out.append(VisibleInterval(
                    new_stop, v.stop, v.file_id, v.mtime,
                    chunk_offset=v.chunk_offset + (new_stop - v.start),
                    is_full_chunk=False))
            if new_stop <= v.start or v.stop <= c.offset:
                out.append(v)
        out.append(VisibleInterval(c.offset, new_stop, c.file_id, c.mtime,
                                   chunk_offset=0, is_full_chunk=True))
        out.sort(key=lambda v: v.start)
        visibles = out
    return visibles


def view_from_visibles(visibles: list[VisibleInterval], offset: int,
                       size: int) -> list[ChunkView]:
    """Clip visible intervals to [offset, offset+size)
    (filechunks.go:84-104)."""
    stop = offset + size
    views: list[ChunkView] = []
    for v in visibles:
        if offset >= stop:
            break
        if v.stop <= offset:
            continue
        # jump across a hole: sparse ranges read as zeros (the reference's
        # clip loop drops post-hole views — filechunks.go:89 — which loses
        # data on sparse files; assemblers here zero-fill instead)
        cur = max(offset, v.start)
        if cur >= stop:
            break
        end = min(v.stop, stop)
        views.append(ChunkView(
            file_id=v.file_id,
            offset=v.chunk_offset + (cur - v.start),
            size=end - cur,
            logic_offset=cur,
            is_full_chunk=(v.is_full_chunk and v.start == cur
                           and v.stop <= stop),
        ))
        offset = end
    return views


def view_from_chunks(chunks: list[FileChunk], offset: int,
                     size: int) -> list[ChunkView]:
    return view_from_visibles(
        non_overlapping_visible_intervals(chunks), offset, size)


def minus_chunks(a: list[FileChunk], b: list[FileChunk]) -> list[FileChunk]:
    """Chunks in a but not in b (by fid) — incremental replication diff
    (filechunks.go MinusChunks)."""
    b_ids = {c.file_id for c in b}
    return [c for c in a if c.file_id not in b_ids]
