"""Incremental volume backup/sync by AppendAtNs watermark.

Reference: weed/storage/volume_backup.go — `IncrementalBackup` pulls the
tail of a remote volume newer than the local volume's last append
timestamp; `BinarySearchByAppendAtNs` (volume_backup.go:172-234) finds
the first .idx entry whose needle was appended after `since_ns`
(append-only volumes make the .idx time-ordered). Tombstone deletes are
replayed as deletes. `weed backup` (weed/command/backup.go) wraps this
with a full-copy fallback when compaction revisions diverge.

A copy of seaweedfs_tpu/storage/volume_backup.py in the PyTorch port.
"""

from __future__ import annotations

from typing import Iterator

from . import types as t
from .needle import Needle
from .needle_map import walk_index_file
from .volume import Volume


def read_append_at_ns(v: Volume, offset: int) -> int:
    """append_at_ns of the needle record at a .dat offset
    (volume_backup.go:236-247)."""
    with v._lock:
        v._dat.seek(offset)
        header = v._dat.read(t.NEEDLE_HEADER_SIZE)
        if len(header) < t.NEEDLE_HEADER_SIZE:
            return 0
        body_size = int.from_bytes(header[12:16], "big")
        v._dat.seek(offset)
        blob = v._dat.read(t.actual_size(body_size, v.version))
    n = Needle.from_bytes(blob, v.version, check_crc=False)
    return n.append_at_ns


def _idx_entries(v: Volume) -> list[tuple[int, int, int]]:
    entries: list[tuple[int, int, int]] = []
    path = v.file_name() + ".idx"
    walk_index_file(path, lambda k, o, s: entries.append((k, o, s)))
    return entries


def _first_entry_after(v: Volume, since_ns: int,
                       entries: list[tuple[int, int, int]]) -> int:
    """Index of the first .idx entry appended strictly after since_ns.

    Matches volume_backup.go:172-234: binary search over the time-ordered
    .idx entries, reading each probed needle's AppendAtNs from .dat.
    Tombstone entries carry the tombstone record's own offset, so they
    participate like any other append.
    """
    lo, hi = 0, len(entries)
    while lo < hi:
        mid = (lo + hi) // 2
        ts = read_append_at_ns(v, entries[mid][1])
        if ts > since_ns:
            hi = mid
        else:
            lo = mid + 1
    return lo


def binary_search_by_append_at_ns(v: Volume, since_ns: int) -> int | None:
    """.dat offset of the first record appended strictly after since_ns,
    or None when the volume has nothing newer."""
    entries = [(k, o, s) for (k, o, s) in _idx_entries(v) if o > 0]
    i = _first_entry_after(v, since_ns, entries)
    return entries[i][1] if i < len(entries) else None


def tail_records(v: Volume, since_ns: int) -> Iterator[tuple[Needle, bool]]:
    """Yield (record, is_delete) for every append after since_ns, in
    append order — the VolumeTailSender stream (volume_server.proto:47-50).

    Driven by the .idx (one locked read per record, no full .dat scan):
    delete markers are idx entries with size == TOMBSTONE_FILE_SIZE, which
    disambiguates tombstones from legitimate zero-byte file writes.
    """
    with v._lock:
        revision = v.super_block.compaction_revision
        entries = [(k, o, s) for (k, o, s) in _idx_entries(v) if o > 0]
        start = _first_entry_after(v, since_ns, entries)
    for key, offset, size in entries[start:]:
        is_delete = size == t.TOMBSTONE_FILE_SIZE
        body_size = 0 if is_delete else size
        with v._lock:
            if v.super_block.compaction_revision != revision:
                # vacuum commit swapped .dat under us: the snapshot
                # offsets are stale — abort; the receiver retries from
                # its watermark against the compacted file
                return
            v._dat.seek(offset)
            blob = v._dat.read(t.actual_size(body_size, v.version))
        n = Needle.from_bytes(blob, v.version, check_crc=False)
        if n.append_at_ns > since_ns:
            yield n, is_delete


def tail_needles(v: Volume, since_ns: int) -> Iterator[Needle]:
    for n, _ in tail_records(v, since_ns):
        yield n


def apply_needle(v: Volume, n: Needle, is_delete: bool = False) -> None:
    """Replay a tailed record into a local volume, preserving its original
    append_at_ns (VolumeTailReceiver -> replica write path)."""
    with v._lock:
        offset = v.data_size()
        blob = n.to_bytes(t.CURRENT_VERSION)
        v._dat.seek(offset)
        v._dat.write(blob)
        v._dat.flush()
        v.last_append_at_ns = max(v.last_append_at_ns, n.append_at_ns)
        if is_delete:
            v.nm.delete(n.id, offset)
        else:
            v.nm.put(n.id, offset, n.size)


def frame_needle(n: Needle, is_delete: bool = False) -> bytes:
    """Wire frame for the tail stream: [1B flags][4B len][v3 needle blob].
    The explicit delete flag disambiguates tombstones from zero-byte
    writes; the blob is always re-serialized as v3 so append_at_ns rides
    along regardless of the source volume's on-disk version."""
    blob = n.to_bytes(t.VERSION3)
    return bytes([1 if is_delete else 0]) + \
        len(blob).to_bytes(4, "big") + blob


class FrameDecoder:
    """Incremental decoder for frame_needle() streams; feed() chunks of
    arbitrary size, get back completed records. Lets async receivers
    apply records as they arrive instead of buffering whole tails."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list[tuple[Needle, bool]]:
        self._buf += chunk
        out: list[tuple[Needle, bool]] = []
        while True:
            if len(self._buf) < 5:
                break
            is_delete = self._buf[0] != 0
            ln = int.from_bytes(self._buf[1:5], "big")
            if len(self._buf) < 5 + ln:
                break
            blob = bytes(self._buf[5:5 + ln])
            del self._buf[:5 + ln]
            out.append((Needle.from_bytes(blob, t.VERSION3,
                                          check_crc=False), is_delete))
        return out


def iter_frames(data_iter) -> Iterator[tuple[Needle, bool]]:
    """Decode a stream of frame_needle()-framed records from a byte
    iterator (chunks of arbitrary size)."""
    dec = FrameDecoder()
    for chunk in data_iter:
        yield from dec.feed(chunk)
