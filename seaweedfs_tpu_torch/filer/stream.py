"""Streaming read assembly over a chunk list.

Reference: weed/filer2/stream.go:12-47 (StreamContent). Yields the bytes
of [offset, offset+length) in order, zero-filling sparse holes between
visible intervals and any short tail so the byte count always matches the
declared length.

When the client carries a chunk cache (util/chunk_cache), each view
whose chunk fits the cache is served as a slice of the WHOLE cached
chunk (weed/filer/reader_at.go rides its chunk cache the same way): a
hot object's re-read never touches a volume server, and concurrent
cold readers of one chunk collapse into a single fetch through the
client's singleflight.

A copy of seaweedfs_tpu/filer/stream.py in the PyTorch port.
"""

from __future__ import annotations

from .filechunks import FileChunk, view_from_chunks

_ZERO_BLOCK = 64 * 1024


async def stream_chunk_views(client, chunks: list[FileChunk], offset: int,
                             length: int):
    """Async-generate data blocks for [offset, offset+length).

    Each view streams through `client.read_stream`, which carries the
    degraded-read failover: a replica dying mid-chunk rotates to the
    next location and resumes via Range, so the filer response keeps
    flowing instead of aborting. Only a full miss (every holder down)
    propagates to the caller (typically translated into a transport
    abort once headers are sent).
    """
    cc = getattr(client, "chunk_cache", None)
    sizes = {c.file_id: c.size for c in chunks} if cc is not None else {}
    pos = offset
    stop = offset + length
    for view in view_from_chunks(chunks, offset, length):
        while pos < view.logic_offset:  # hole: reads as zeros
            n = min(_ZERO_BLOCK, view.logic_offset - pos)
            yield b"\x00" * n
            pos += n
        whole = sizes.get(view.file_id, 0)
        if cc is not None and 0 < whole <= cc.max_item_size \
                and (2 * view.size >= whole
                     or cc.contains(view.file_id)):
            # whole-chunk path: cache + singleflight. Taken when the
            # chunk is already resident (a range of a hot chunk is a
            # free slice) or the view covers at least half of it —
            # a cold small range sticks to the ranged network stream
            # below instead of paying up-to-max_item_size
            # amplification to warm a chunk it may never revisit.
            # A short chunk yields fewer bytes and the hole/tail
            # zero-fill keeps the byte count exact, as before.
            data = await client.chunk_bytes(view.file_id, whole)
            block = data[view.offset:view.offset + view.size]
            if block:
                yield block
                pos += len(block)
            continue
        async for data in client.read_stream(view.file_id, view.offset,
                                             view.size):
            yield data
            pos += len(data)
    while pos < stop:  # tail hole / short chunk
        n = min(_ZERO_BLOCK, stop - pos)
        yield b"\x00" * n
        pos += n
