"""Vacuum (GC/compaction): reclaim space from deleted/expired needles.

Reference: weed/storage/volume_vacuum.go — Compact/Compact2 copy live
needles to .cpd/.cpx while writes continue; CommitCompact replays writes
that raced the compaction (makeupDiff, :157-294) before atomically renaming
the copies over the originals. The superblock CompactionRevision increments
so stale replicas are detectable (super_block.go:28).

A copy of seaweedfs_tpu/storage/vacuum.py in the PyTorch port.
"""

from __future__ import annotations

import os
import struct
import time

from . import types as t
from .needle import Needle
from .needle_map import pack_entry, walk_index_blob
from .super_block import SuperBlock
from .volume import Volume

class VacuumError(Exception):
    pass


def compact(v: Volume) -> None:
    """Copy live needles to .cpd/.cpx based on the needle map (the
    Compact2 strategy, volume_vacuum.go:59-77). Leaves originals alive for
    concurrent traffic; remembers the watermark for makeup_diff."""
    base = v.file_name()
    from . import backend as _backend
    if v.is_remote or _backend.load_volume_info(base) is not None:
        raise VacuumError(
            f"volume {v.vid} is tiered; tier.download before compacting")
    v.last_compact_index_offset = v.nm.index_file_size()
    v.last_compact_revision = v.super_block.compaction_revision
    now = time.time()

    sb = SuperBlock(version=v.version,
                    replica_placement=v.super_block.replica_placement,
                    ttl=v.super_block.ttl,
                    compaction_revision=v.super_block.compaction_revision + 1)
    # separate read-only fd: never share seek state with live writers
    throttle = _Throttler(v.compaction_bytes_per_second)
    with open(base + ".dat", "rb") as src, \
            open(base + ".cpd", "wb") as dst, \
            open(base + ".cpx", "wb") as idx:
        dst.write(sb.to_bytes())
        new_offset = 8
        for key in sorted(v.nm.keys()):
            nv = v.nm.get(key)
            if nv is None or nv.offset == 0 or \
                    nv.size == t.TOMBSTONE_FILE_SIZE:
                continue
            blob_len = t.actual_size(nv.size, v.version)
            blob = os.pread(src.fileno(), blob_len, nv.offset)
            n = Needle.from_bytes(blob, v.version, check_crc=False)
            if n.has_expired(now):
                continue
            dst.write(blob)
            idx.write(pack_entry(key, new_offset, nv.size))
            new_offset += blob_len
            throttle.maybe_sleep(blob_len)


class _Throttler:
    """Compaction rate limiter (util/throttler.go): sleep whenever the
    copied-bytes budget for the elapsed wall time is exceeded, so vacuum
    doesn't starve live reads on the same spindle. 0 = unthrottled."""

    def __init__(self, bytes_per_second: int):
        self.bps = bytes_per_second
        self.start = time.monotonic()
        self.copied = 0

    def maybe_sleep(self, n: int) -> None:
        if self.bps <= 0:
            return
        self.copied += n
        # sleep the FULL deficit: capping per-call would let large
        # needles outrun the budget (the deficit is never drained)
        ahead = self.copied / self.bps - (time.monotonic() - self.start)
        if ahead > 0:
            time.sleep(ahead)


def commit_compact(v: Volume) -> None:
    """makeupDiff + rename + reload (CommitCompact, volume_vacuum.go:78-133).
    """
    base = v.file_name()
    if not os.path.exists(base + ".cpd"):
        raise VacuumError(f"no compaction in progress for volume {v.vid}")
    with v._lock:
        _makeup_diff(v, base + ".cpd", base + ".cpx",
                     base + ".dat", base + ".idx")
        v.nm.close()
        v._dat.close()
        os.rename(base + ".cpd", base + ".dat")
        os.rename(base + ".cpx", base + ".idx")
        v.reload()  # preserves v._lock (writers blocked on it stay safe)


def cleanup_compact(v: Volume) -> None:
    base = v.file_name()
    for ext in (".cpd", ".cpx"):
        if os.path.exists(base + ext):
            os.remove(base + ext)


def _makeup_diff(v: Volume, new_dat: str, new_idx: str,
                 old_dat: str, old_idx: str) -> None:
    """Replay idx entries appended after the compaction snapshot
    (makeupDiff, volume_vacuum.go:157-294)."""
    index_size = os.path.getsize(old_idx)
    watermark = getattr(v, "last_compact_index_offset", 0)
    if index_size == 0 or index_size <= watermark:
        return
    with open(old_dat, "rb") as f:
        f.seek(0)
        old_rev = SuperBlock.from_bytes(f.read(8)).compaction_revision
    if old_rev != getattr(v, "last_compact_revision", old_rev):
        raise VacuumError(
            f"old dat compact revision {old_rev} != expected "
            f"{v.last_compact_revision}")

    # newest entry per key among the racing appends (scan tail backwards)
    with open(old_idx, "rb") as f:
        f.seek(watermark)
        tail = f.read()
    updates: dict[int, tuple[int, int]] = {}
    for key, off, size in walk_index_blob(tail):
        updates[key] = (off, size)  # later entries win

    if not updates:
        return
    with open(new_dat, "rb+") as dst, open(new_idx, "ab") as idx, \
            open(old_dat, "rb") as src:
        dst.seek(0)
        new_rev = SuperBlock.from_bytes(dst.read(8)).compaction_revision
        if old_rev + 1 != new_rev:
            raise VacuumError(
                f"compacted dat revision {new_rev} != old {old_rev}+1")
        for key, (off, size) in updates.items():
            dst.seek(0, os.SEEK_END)
            pos = dst.tell()
            if pos % t.NEEDLE_PADDING_SIZE:
                pad = t.NEEDLE_PADDING_SIZE - pos % t.NEEDLE_PADDING_SIZE
                dst.write(b"\x00" * pad)
                pos += pad
            if off > 0 and size not in (0, t.TOMBSTONE_FILE_SIZE):
                src.seek(off)
                dst.write(src.read(t.actual_size(size, v.version)))
                idx.write(pack_entry(key, pos, size))
            else:
                tomb = Needle(cookie=0x12345678, id=key)
                dst.write(tomb.to_bytes(v.version))
                idx.write(pack_entry(key, 0, t.TOMBSTONE_FILE_SIZE))
