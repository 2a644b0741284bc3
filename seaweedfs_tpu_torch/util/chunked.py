"""Chunk-manifest files on raw volumes (no filer required).

Reference: weed/operation/chunked_file.go (ChunkManifest json model,
LoadChunkManifest, DeleteChunks) + submit.go:112-199 (client-side
auto-split of uploads larger than maxMB into per-chunk fids plus one
manifest needle flagged FLAG_IS_CHUNK_MANIFEST, stored with ?cm=true).
The volume server resolves the manifest on GET
(volume_server_handlers_read.go:170-199 tryHandleChunkedFile) and
deletes the chunks with the manifest needle on DELETE.

A copy of seaweedfs_tpu/util/chunked.py in the PyTorch port.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field


@dataclass
class ChunkInfo:
    fid: str
    offset: int
    size: int

    def to_dict(self) -> dict:
        return {"fid": self.fid, "offset": self.offset, "size": self.size}


@dataclass
class ChunkManifest:
    name: str = ""
    mime: str = ""
    size: int = 0
    chunks: list[ChunkInfo] = field(default_factory=list)

    def marshal(self) -> bytes:
        return json.dumps({
            "name": self.name, "mime": self.mime, "size": self.size,
            "chunks": [c.to_dict() for c in self.chunks],
        }).encode()

    @classmethod
    def load(cls, buffer: bytes, is_gzipped: bool = False
             ) -> "ChunkManifest":
        if is_gzipped:
            buffer = gzip.decompress(buffer)
        d = json.loads(buffer)
        cm = cls(name=d.get("name", ""), mime=d.get("mime", ""),
                 size=int(d.get("size", 0)))
        cm.chunks = sorted(
            (ChunkInfo(c["fid"], int(c["offset"]), int(c["size"]))
             for c in d.get("chunks", [])),
            key=lambda c: c.offset)
        return cm

    def resolve(self, offset: int, size: int
                ) -> list[tuple[str, int, int, int]]:
        """Map a logical [offset, offset+size) range to
        (fid, chunk-local offset, length, logical offset) pieces."""
        out = []
        end = offset + size
        for c in self.chunks:
            lo = max(offset, c.offset)
            hi = min(end, c.offset + c.size)
            if lo < hi:
                out.append((c.fid, lo - c.offset, hi - lo, lo))
        return out

    async def delete_chunks(self, client) -> int:
        """DeleteChunks (chunked_file.go:76-89)."""
        return await client.delete_fids([c.fid for c in self.chunks])


async def upload_in_chunks(client, data: bytes, max_mb: int,
                           name: str = "", mime: str = "",
                           collection: str = "", replication: str = "",
                           ttl: str = "", data_center: str = ""
                           ) -> tuple[str, "ChunkManifest"]:
    """Client-side auto-split (submit.go:112-199): upload ceil(n/maxMB)
    chunk needles, then the manifest needle with ?cm=true. On any chunk
    failure the already-uploaded chunks are deleted. Returns
    (manifest fid, manifest)."""
    chunk_size = max_mb * 1024 * 1024
    cm = ChunkManifest(name=name, mime=mime, size=len(data))
    try:
        for i in range(0, len(data), chunk_size):
            piece = data[i:i + chunk_size]
            fid = await client.upload_data(
                piece, collection=collection, replication=replication,
                ttl=ttl, data_center=data_center)
            cm.chunks.append(ChunkInfo(fid, i, len(piece)))
        a = await client.assign(collection=collection,
                                replication=replication, ttl=ttl,
                                data_center=data_center)
        await client.upload_manifest(a["fid"], a["url"], cm, ttl=ttl,
                                     auth=a.get("auth", ""))
        return a["fid"], cm
    except Exception:
        # ANY mid-upload failure (network drop, timeout, bad assign
        # body — not just OperationError) must not orphan the
        # already-uploaded chunk needles
        await cm.delete_chunks(client)
        raise
