"""Needle maps: needleId -> (offset, size) within one volume.

Mirrors the reference's NeedleMapper contract (weed/storage/needle_map.go:
21-33) and its .idx append-log persistence (16-byte big-endian entries:
key(8) offset(4, units of 8B) size(4); tombstone size = 0xFFFFFFFF —
needle_map.go:50, idx/walk.go:44).

Kinds (needle_map.go:12-19): in-memory (the default; the reference's
CompactMap becomes a plain dict here with an optional C++ fast map in
native/), plus a read-only sorted-file map over .sdx used by tiered volumes
and the EC .ecx index (needle_map_sorted_file.go).

A copy of seaweedfs_tpu/storage/needle_map.py in the PyTorch port.
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass
from typing import Callable, Iterator

from . import types as t

_ENTRY4 = struct.Struct(">QII")  # key, offset/8, size (4-byte offsets)


def pack_entry(key: int, actual_offset: int, size: int) -> bytes:
    """One .idx/.ecx entry at the current offset width (idx/walk.go:44;
    5-byte layout per offset_5bytes.go)."""
    units = actual_offset // t.NEEDLE_PADDING_SIZE
    if units >= 1 << (8 * t.OFFSET_SIZE):
        raise OverflowError(
            f"offset {actual_offset} exceeds the {t.OFFSET_SIZE}-byte "
            f"index limit ({t.max_volume_size()} bytes); "
            f"use set_offset_size(5) / SWTPU_OFFSET_BYTES=5")
    if t.OFFSET_SIZE == 4:
        return _ENTRY4.pack(key, units, size)
    # reference 5BytesOffset layout (offset_5bytes.go:18-24): the LOW 32
    # bits big-endian in bytes[0..3], the high byte LAST in bytes[4] —
    # NOT a plain 5-byte big-endian integer
    return (key.to_bytes(t.NEEDLE_ID_SIZE, "big")
            + (units & 0xFFFFFFFF).to_bytes(4, "big")
            + bytes([units >> 32])
            + size.to_bytes(t.SIZE_SIZE, "big"))


def unpack_entry(blob: bytes, pos: int = 0) -> tuple[int, int, int]:
    """-> (key, actual_offset, size) from one entry at `pos`."""
    if t.OFFSET_SIZE == 4:
        key, units, size = _ENTRY4.unpack_from(blob, pos)
    else:
        key = int.from_bytes(blob[pos:pos + t.NEEDLE_ID_SIZE], "big")
        p = pos + t.NEEDLE_ID_SIZE
        units = (int.from_bytes(blob[p:p + 4], "big")
                 | (blob[p + 4] << 32))
        p += t.OFFSET_SIZE
        size = int.from_bytes(blob[p:p + t.SIZE_SIZE], "big")
    return key, units * t.NEEDLE_PADDING_SIZE, size


@dataclass
class NeedleValue:
    key: int
    offset: int  # actual byte offset
    size: int


def walk_index_blob(blob: bytes) -> Iterator[tuple[int, int, int]]:
    """Yield (key, actual_offset, size) per entry (idx/walk.go:12)."""
    n = len(blob) // t.NEEDLE_MAP_ENTRY_SIZE
    for i in range(n):
        yield unpack_entry(blob, i * t.NEEDLE_MAP_ENTRY_SIZE)


def walk_index_file(path: str,
                    fn: Callable[[int, int, int], None]) -> None:
    with open(path, "rb") as f:
        blob = f.read()
    for key, off, size in walk_index_blob(blob):
        fn(key, off, size)


class MemoryNeedleMap:
    """In-memory map + .idx append log (needle_map_memory.go)."""

    @staticmethod
    def _new_map():
        return {}

    def __init__(self, index_path: str | None = None):
        self.index_path = index_path
        self._m = self._new_map()
        self._idx: io.BufferedWriter | None = None
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.file_count = 0
        self.content_bytes = 0
        self.max_file_key = 0
        # (key, actual_offset, size) of the highest-offset logged record,
        # tombstones included — the true .dat tail for integrity checking.
        self.last_entry: tuple[int, int, int] | None = None
        if index_path:
            if os.path.exists(index_path):
                self._load(index_path)
            self._idx = open(index_path, "ab")

    def _load(self, path: str) -> None:
        def visit(key: int, offset: int, size: int) -> None:
            self._apply(key, offset, size)
        walk_index_file(path, visit)

    def _apply(self, key: int, offset: int, size: int) -> None:
        """Replay one idx entry into the in-memory state.

        Deletes keep a tombstone NeedleValue (size = TOMBSTONE_FILE_SIZE) so
        reads can distinguish "already deleted" from "never existed"
        (volume_read_write.go:147-149). The logged offset of a delete is the
        position of the tombstone record appended to .dat."""
        self.max_file_key = max(self.max_file_key, key)
        if offset > 0 and (self.last_entry is None
                           or offset > self.last_entry[1]):
            self.last_entry = (key, offset, size)
        if offset > 0 and size != t.TOMBSTONE_FILE_SIZE:
            old = self._m.get(key)
            if old is not None and old.size != t.TOMBSTONE_FILE_SIZE:
                self.deleted_count += 1
                self.deleted_bytes += old.size
            elif old is None:
                self.file_count += 1
            self.content_bytes += size
            self._m[key] = NeedleValue(key, offset, size)
        else:
            old = self._m.get(key)
            if old is not None and old.size != t.TOMBSTONE_FILE_SIZE:
                self.deleted_count += 1
                self.deleted_bytes += old.size
            self._m[key] = NeedleValue(key, 0, t.TOMBSTONE_FILE_SIZE)

    def _log(self, key: int, offset: int, size: int) -> None:
        if self._idx is not None:
            self._idx.write(pack_entry(key, offset, size))
            self._idx.flush()

    # -- NeedleMapper API --

    def put(self, key: int, offset: int, size: int) -> None:
        self._apply(key, offset, size)
        self._log(key, offset, size)

    def get(self, key: int) -> NeedleValue | None:
        return self._m.get(key)

    def delete(self, key: int, offset: int) -> None:
        """offset = position of the tombstone record appended to .dat."""
        self._apply(key, offset, t.TOMBSTONE_FILE_SIZE)
        self._log(key, offset, t.TOMBSTONE_FILE_SIZE)

    def close(self) -> None:
        if self._idx is not None:
            self._idx.close()
            self._idx = None

    def destroy(self) -> None:
        self.close()
        if self.index_path and os.path.exists(self.index_path):
            os.remove(self.index_path)

    def __len__(self) -> int:
        return len(self._m)

    def keys(self):
        return self._m.keys()

    def index_file_size(self) -> int:
        if self.index_path and os.path.exists(self.index_path):
            return os.path.getsize(self.index_path)
        return 0

    @property
    def content_size(self) -> int:
        return self.content_bytes

    @property
    def deleted_size(self) -> int:
        return self.deleted_bytes


class _NativeMapAdapter:
    """dict-shaped facade over native.needle_map.NativeMap, storing
    NeedleValue payloads at 16 bytes/entry instead of ~200 for a dict.
    Key 0 (reserved as the native empty marker) gets a sideband slot."""

    def __init__(self):
        from ..native.needle_map import NativeMap
        self._nm = NativeMap()
        self._zero: NeedleValue | None = None

    def get(self, key: int) -> NeedleValue | None:
        if key == 0:
            return self._zero
        r = self._nm.get(key)
        if r is None:
            return None
        # offsets are stored /8 like the .idx format: a raw byte offset
        # would wrap the native uint32 field past 4 GiB (volumes default
        # to 30 GB)
        return NeedleValue(key, r[0] * t.NEEDLE_PADDING_SIZE, r[1])

    def __setitem__(self, key: int, val: "NeedleValue") -> None:
        if key == 0:
            self._zero = val
            return
        assert val.offset % t.NEEDLE_PADDING_SIZE == 0, val.offset
        units = val.offset // t.NEEDLE_PADDING_SIZE
        if units > 0xFFFFFFFF:
            # the native store's offset field is uint32; ctypes would
            # silently truncate and later reads would return the wrong
            # needle (silent corruption) — refuse loudly instead
            raise OverflowError(
                f"needle offset {val.offset} exceeds the native compact "
                f"map's 32 GiB range; use -index memory/disk for volumes "
                f"above 32 GiB")
        self._nm.set(key, units, val.size)

    def __len__(self) -> int:
        return len(self._nm) + (1 if self._zero is not None else 0)

    def keys(self):
        if self._zero is not None:
            yield 0
        for k, _, _ in self._nm.items():
            yield k

    def close(self) -> None:
        self._nm.close()


class CompactNeedleMap(MemoryNeedleMap):
    """MemoryNeedleMap on the native compact store (needle_map.c) — the
    CompactMap analog (compact_map.go:14-40; its perf test budgets 100M
    entries/volume, far beyond what a Python dict can hold)."""

    @staticmethod
    def _new_map():
        return _NativeMapAdapter()

    def close(self) -> None:
        super().close()
        self._m.close()


class _SqliteMapAdapter:
    """dict-shaped facade over a sqlite table, same contract as
    _NativeMapAdapter — lets DiskNeedleMap inherit every line of the
    counter/tombstone bookkeeping instead of forking it."""

    def __init__(self, path: str):
        import sqlite3
        import threading
        self.path = path
        # served from event-loop AND executor threads: one shared
        # connection guarded by a lock (sqlite objects are
        # thread-affine by default)
        self._lock = threading.Lock()
        # autocommit + WAL: each put is durable without explicit commits
        self._db = sqlite3.connect(path, isolation_level=None,
                                   check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute("CREATE TABLE IF NOT EXISTS needles("
                         "key INTEGER PRIMARY KEY, offset INTEGER, "
                         "size INTEGER)")
        # the .idx replay repopulates from scratch on every open (the
        # reference replays only the stale tail; full replay is simpler
        # and the .idx stays the source of truth)
        self._db.execute("DELETE FROM needles")

    def get(self, key: int) -> NeedleValue | None:
        with self._lock:
            row = self._db.execute(
                "SELECT offset, size FROM needles WHERE key=?",
                (key,)).fetchone()
        return NeedleValue(key, row[0], row[1]) if row else None

    def __setitem__(self, key: int, val: "NeedleValue") -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO needles VALUES (?,?,?)",
                (key, val.offset, val.size))

    def __len__(self) -> int:
        with self._lock:
            return self._db.execute(
                "SELECT COUNT(*) FROM needles").fetchone()[0]

    def keys(self):
        with self._lock:
            ks = [k for (k,) in self._db.execute(
                "SELECT key FROM needles ORDER BY key")]
        yield from ks

    def close(self) -> None:
        with self._lock:
            if self._db is not None:
                self._db.close()
                self._db = None

    def destroy_files(self) -> None:
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(self.path + suffix):
                os.remove(self.path + suffix)


class DiskNeedleMap(MemoryNeedleMap):
    """Disk-backed needle map for memory-constrained servers — the role
    of LevelDbNeedleMap (needle_map_leveldb.go: key index on disk, only
    counters in RAM), on sqlite instead of leveldb (no cgo-free leveldb
    in this image)."""

    def _new_map(self):
        import tempfile
        import uuid
        path = ((self.index_path + ".sdb") if self.index_path
                else os.path.join(tempfile.gettempdir(),
                                  f"swtpu-nm-{uuid.uuid4()}.sdb"))
        return _SqliteMapAdapter(path)

    def close(self) -> None:
        super().close()
        self._m.close()

    def destroy(self) -> None:
        super().destroy()
        self._m.destroy_files()


def best_needle_map(index_path: str | None = None,
                    kind: str = "auto") -> MemoryNeedleMap:
    """NeedleMapType selection (storage/needle_map.go:12-19, the
    -index=memory|leveldb flag):
    auto    — native CompactNeedleMap when built, else dict map
    memory  — dict map
    compact — native map (raises if the toolchain is unavailable)
    disk    — sqlite-backed DiskNeedleMap (LevelDbNeedleMap analog,
              near-zero RAM per entry)"""
    if kind == "memory":
        return MemoryNeedleMap(index_path)
    if kind == "disk":
        return DiskNeedleMap(index_path)
    if kind == "compact":
        if t.OFFSET_SIZE != 4:
            raise ValueError(
                "the native compact map stores 32-bit offsets and cannot "
                "index 5-byte-offset volumes; use -index memory/disk")
        return CompactNeedleMap(index_path)
    from ..native import needle_map as native_nm
    if native_nm.available() and t.OFFSET_SIZE == 4:
        return CompactNeedleMap(index_path)
    return MemoryNeedleMap(index_path)


class SortedFileNeedleMap:
    """Binary search over a sorted 16B-entry index (.sdx/.ecx).

    Reference: needle_map_sorted_file.go, ec_volume.go:203-228
    (SearchNeedleFromSortedIndex). Open writable for the EC delete path,
    which tombstones entries in place (MarkNeedleDeleted,
    ec_volume_delete.go:13-25).
    """

    def __init__(self, path: str, writable: bool = False):
        self.path = path
        self.writable = writable
        self._f = open(path, "r+b" if writable else "rb")
        self._size = os.path.getsize(path)
        assert self._size % t.NEEDLE_MAP_ENTRY_SIZE == 0, path
        self.count = self._size // t.NEEDLE_MAP_ENTRY_SIZE

    def _entry(self, i: int) -> tuple[int, int, int]:
        self._f.seek(i * t.NEEDLE_MAP_ENTRY_SIZE)
        return unpack_entry(self._f.read(t.NEEDLE_MAP_ENTRY_SIZE))

    def locate(self, key: int) -> int | None:
        """Entry index of key, or None."""
        lo, hi = 0, self.count - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            k, _, _ = self._entry(mid)
            if k == key:
                return mid
            if k < key:
                lo = mid + 1
            else:
                hi = mid - 1
        return None

    def get_raw(self, key: int) -> tuple[int, int] | None:
        """(actual_offset, size) incl. tombstone sizes, or None if absent."""
        i = self.locate(key)
        if i is None:
            return None
        _, off, size = self._entry(i)
        return off, size

    def get(self, key: int) -> NeedleValue | None:
        raw = self.get_raw(key)
        if raw is None or raw[1] == t.TOMBSTONE_FILE_SIZE:
            return None
        return NeedleValue(key, raw[0], raw[1])

    def mark_deleted(self, key: int) -> bool:
        """Overwrite the entry's size with the tombstone marker in place."""
        assert self.writable, self.path
        i = self.locate(key)
        if i is None:
            return False
        self._f.seek(i * t.NEEDLE_MAP_ENTRY_SIZE + t.NEEDLE_ID_SIZE
                     + t.OFFSET_SIZE)
        self._f.write(t.TOMBSTONE_FILE_SIZE.to_bytes(4, "big"))
        self._f.flush()
        return True

    def close(self) -> None:
        self._f.close()


def write_sorted_index(entries: list[tuple[int, int, int]], path: str) -> None:
    """Write (key, actual_offset, size) entries as a sorted index file.

    Last entry per key wins (matching WriteSortedFileFromIdx semantics,
    ec_encoder.go:26-50: deleted needles keep their tombstone size).
    """
    latest: dict[int, tuple[int, int]] = {}
    for key, off, size in entries:
        latest[key] = (off, size)
    with open(path, "wb") as f:
        for key in sorted(latest):
            off, size = latest[key]
            f.write(pack_entry(key, off, size))
