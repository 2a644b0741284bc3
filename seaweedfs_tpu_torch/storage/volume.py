"""Volume: one append-only .dat blob file + .idx needle index.

Reference semantics: weed/storage/volume.go:21-45,
volume_read_write.go:66-172 (append-only writes, tombstone deletes, O(1)
reads via the needle map), volume_loading.go (load + integrity check),
volume_checking.go:14-78 (verify the last idx entry matches the data tail).

A copy of seaweedfs_tpu/storage/volume.py in the PyTorch port.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from . import types as t
from .needle import Needle, NeedleError
from .needle_map import best_needle_map
from .super_block import SuperBlock, ReplicaPlacement


class VolumeError(Exception):
    pass


class NotFound(VolumeError):
    pass


class AlreadyDeleted(VolumeError):
    pass


class NeedleRef:
    """Zero-copy handle to one needle's data region inside the .dat
    file: a private read-only file object (its own offset, its own
    lifetime — a vacuum swap renaming the .dat keeps the inode alive
    for in-flight sends) plus the byte window of the DATA field.
    The owner must close() it, normally after an os.sendfile-style
    kernel copy of exactly ``length`` bytes at ``offset``."""

    __slots__ = ("file", "offset", "length")

    def __init__(self, file, offset: int, length: int) -> None:
        self.file = file
        self.offset = offset
        self.length = length

    def slice(self, off: int, length: int) -> None:
        """Narrow to a sub-range of the data window (HTTP Range)."""
        self.offset += off
        self.length = length

    def close(self) -> None:
        try:
            self.file.close()
        except OSError:
            pass


class _Append:
    """One group-commit participant: the needle going in, and the
    result/exception coming back once the shared batch is durable."""

    __slots__ = ("needle", "result", "exc", "done", "batch")

    def __init__(self, needle: Needle) -> None:
        self.needle = needle
        self.result: tuple[int, int] | None = None
        self.exc: BaseException | None = None
        self.done = False
        self.batch = 1

    def finish(self, result: tuple[int, int]) -> None:
        self.result = result
        self.done = True

    def fail(self, exc: BaseException) -> None:
        self.exc = exc
        self.done = True


@dataclass
class VolumeStat:
    file_count: int
    deleted_count: int
    deleted_bytes: int
    size: int
    read_only: bool


class _ReadaheadCursor:
    """Window buffer over a positioned-read callable for sequential scans:
    each miss fetches one large chunk, so a remote .dat walk costs
    O(size/chunk) ranged GETs instead of two per record."""

    def __init__(self, pread, size: int, chunk: int = 4 << 20):
        self._pread = pread
        self._size = size
        self._chunk = chunk
        self._start = 0
        self._buf = b""

    def read(self, nbytes: int, offset: int) -> bytes:
        end = offset + nbytes
        if offset < self._start or end > self._start + len(self._buf):
            want = max(nbytes, self._chunk)
            self._buf = self._pread(min(want, self._size - offset), offset)
            self._start = offset
        lo = offset - self._start
        return self._buf[lo:lo + nbytes]


class Volume:
    """One volume on local disk: <dir>/<collection_><vid>.dat / .idx."""

    def __init__(self, dirname: str, collection: str, vid: int,
                 replica_placement: ReplicaPlacement | None = None,
                 ttl: t.TTL | None = None,
                 preallocate: int = 0,
                 create_if_missing: bool = True,
                 needle_map_kind: str = "auto"):
        self.needle_map_kind = needle_map_kind
        self.dir = dirname
        self.collection = collection
        self.vid = vid
        self.read_only = False
        self.last_append_at_ns = 0
        self.last_modified_ts = 0
        # vacuum copy rate limit, bytes/s; 0 = unthrottled
        # (compactionBytePerSecond flag + util/throttler.go)
        self.compaction_bytes_per_second = 0
        # fsync after every (group-committed) append before acking
        # writers (-fsync flag); off keeps the historical flush-only
        # durability point
        self.fsync = False
        self._lock = threading.RLock()

        base = self.file_name()
        dat_path = base + ".dat"
        exists = os.path.exists(dat_path)
        self.is_remote = False

        if not exists:
            # tiered volume? .vif sidecar says which backend holds .dat
            # (volume_tier.go LoadVolumeTierInfo)
            from . import backend as _backend
            vinfo = _backend.load_volume_info(base)
            if vinfo and vinfo.get("files"):
                fi = vinfo["files"][0]
                bs = _backend.get_backend(fi["backend_id"])
                self._dat = _backend.RemoteDatFile(
                    bs.new_storage_file(fi["key"],
                                        fi.get("file_size", -1)))
                self._dat.seek(0)
                self.super_block = SuperBlock.from_bytes(self._dat.read(8))
                self.is_remote = True
                self.read_only = True
                self.nm = best_needle_map(base + ".idx", self.needle_map_kind)
                last = self.nm.last_entry
                if last is not None and last[1] > 0:
                    try:
                        n = self._read_at(
                            last[1],
                            0 if last[2] == t.TOMBSTONE_FILE_SIZE
                            else last[2])
                        self.last_append_at_ns = n.append_at_ns
                    except (NeedleError, _backend.BackendError):
                        # a transient tier outage must not abort the load;
                        # the watermark is best-effort on tiered volumes
                        pass
                return
        if not exists and not create_if_missing:
            raise VolumeError(f"volume file missing: {dat_path}")

        if exists:
            self._dat = open(dat_path, "r+b")
            sb_raw = self._dat.read(8)
            if len(sb_raw) < 8:
                raise VolumeError(f"corrupt superblock in {dat_path}")
            self.super_block = SuperBlock.from_bytes(sb_raw)
            from . import backend as _backend
            if _backend.load_volume_info(base) is not None:
                # tiered with -keepLocal: serve reads from the local copy
                # but stay sealed — new writes would silently diverge
                # from the remote object recorded in the .vif
                self.read_only = True
        else:
            os.makedirs(dirname, exist_ok=True)
            self.super_block = SuperBlock(
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or t.TTL())
            self._dat = open(dat_path, "w+b")
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
            if preallocate:
                # FALLOC_FL_KEEP_SIZE (mode 1, volume_create_linux.go:19):
                # reserve blocks WITHOUT extending st_size — appends
                # derive their offset from the file size, so a plain
                # posix_fallocate would push every write past the
                # preallocated region
                try:
                    import ctypes
                    libc = ctypes.CDLL(None, use_errno=True)
                    # argtypes matter: off_t is 64-bit — the ctypes
                    # default int conversion would truncate any
                    # preallocation >= 2GB (incl. the 30GB default)
                    libc.fallocate.argtypes = [
                        ctypes.c_int, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_longlong]
                    libc.fallocate.restype = ctypes.c_int
                    if libc.fallocate(self._dat.fileno(), 1, 0,
                                      preallocate) != 0:
                        raise OSError(ctypes.get_errno(), "fallocate")
                except (OSError, AttributeError):
                    pass  # unsupported fs: run unallocated, like the
                    #       reference's non-linux build
        self.nm = best_needle_map(base + ".idx", self.needle_map_kind)
        self._check_integrity()

    def reload(self) -> None:
        """Re-open .dat/.idx after an external swap (vacuum commit).
        Must run under self._lock; keeps the existing lock object so
        writers already blocked on it serialize correctly."""
        base = self.file_name()
        self._dat = open(base + ".dat", "r+b")
        self.super_block = SuperBlock.from_bytes(self._dat.read(8))
        self.nm = best_needle_map(base + ".idx", self.needle_map_kind)
        from . import backend as _backend
        # a .vif means the volume is tiered (keep_local): stay sealed so
        # local writes can't diverge from the remote object
        self.read_only = _backend.load_volume_info(base) is not None
        self._check_integrity()

    # ---- naming ----

    def file_name(self) -> str:
        name = f"{self.collection}_{self.vid}" if self.collection else str(self.vid)
        return os.path.join(self.dir, name)

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def ttl(self) -> t.TTL:
        return self.super_block.ttl

    # ---- integrity (volume_checking.go:14-37) ----

    def _check_integrity(self) -> None:
        """Verify the last logged idx entry (tombstones included) points at
        a parseable needle at the data tail; truncate a torn tail write."""
        size = self.data_size()
        last = self.nm.last_entry
        if last is None:
            return
        key, offset, logged_size = last
        # tombstone records are empty-body needles on disk
        body_size = 0 if logged_size == t.TOMBSTONE_FILE_SIZE else logged_size
        expected_end = offset + t.actual_size(body_size, self.version)
        if expected_end > size:
            raise VolumeError(
                f"volume {self.vid}: index points past data end "
                f"({expected_end} > {size})")
        try:
            n = self._read_at(offset, body_size)
        except NeedleError as e:
            raise VolumeError(f"volume {self.vid}: tail needle corrupt: {e}")
        if n.id != key:
            raise VolumeError(
                f"volume {self.vid}: tail needle key mismatch "
                f"{n.id:x} != {key:x}")
        # restore the incremental-sync watermark (volume_backup.go relies
        # on lastAppendAtNs surviving restarts)
        self.last_append_at_ns = n.append_at_ns
        # ...and the modified watermark, or TTL volume reclamation
        # (store.go expired()) goes dead after a restart
        modified = n.last_modified or n.append_at_ns // 1_000_000_000
        if modified > self.last_modified_ts:
            self.last_modified_ts = modified
        if expected_end < size:
            # torn write past the last logged record: truncate it away
            self._dat.truncate(expected_end)

    # ---- I/O core ----

    def data_size(self) -> int:
        # fstat, NOT seek(END): this is called lock-free from the
        # heartbeat/stats paths, and moving the shared fd's position
        # would race a locked reader between its seek and read.
        # A tiered volume's _dat is a RemoteDatFile (no fileno); its
        # size() is a backend HEAD, equally position-free.
        fileno = getattr(self._dat, "fileno", None)
        if fileno is None:
            return self._dat.size()
        return os.fstat(fileno()).st_size

    def _pread(self, nbytes: int, offset: int) -> bytes:
        # positioned read: no shared seek state with writers or other
        # readers (the reference uses ReadAt for the same reason).
        # Tiered volumes route through RemoteDatFile.pread -> ranged GET
        # (s3_backend.go:113-146).
        fileno = getattr(self._dat, "fileno", None)
        if fileno is None:
            return self._dat.pread(nbytes, offset)
        return os.pread(fileno(), nbytes, offset)

    def _read_at(self, offset: int, size: int) -> Needle:
        blob = self._pread(t.actual_size(size, self.version), offset)
        return Needle.from_bytes(blob, self.version)

    def write_needle(self, n: Needle) -> tuple[int, int]:
        """Append a needle; returns (offset, size).

        volume_read_write.go:66-113: inherit volume TTL, verify existing
        cookie on overwrite, append, nm.Put.
        """
        with self._lock:
            if self.read_only:
                raise VolumeError(f"volume {self.vid} is read-only")
            if n.ttl.count == 0 and self.ttl.count != 0:
                n.ttl = self.ttl
            nv = self.nm.get(n.id)
            if (nv is not None and nv.offset > 0
                    and nv.size != t.TOMBSTONE_FILE_SIZE):
                existing = self._read_at(nv.offset, nv.size)
                if existing.cookie != n.cookie:
                    raise VolumeError(
                        f"mismatching cookie {n.cookie:x} for needle {n.id:x}")
            n.append_at_ns = time.time_ns()
            offset = self.data_size()
            blob = n.to_bytes(self.version)
            self._dat.seek(offset)
            self._dat.write(blob)
            self._dat.flush()
            self.last_append_at_ns = n.append_at_ns
            if nv is None or nv.offset < offset:
                self.nm.put(n.id, offset, n.size)
            modified = n.last_modified or n.append_at_ns // 1_000_000_000
            if modified > self.last_modified_ts:
                self.last_modified_ts = modified
            return offset, n.size

    def _validate_append(self, n: Needle):
        """Shared pre-append checks (under self._lock): TTL inherit +
        overwrite cookie verification. Returns the existing needle-map
        entry (or None)."""
        if n.ttl.count == 0 and self.ttl.count != 0:
            n.ttl = self.ttl
        nv = self.nm.get(n.id)
        if (nv is not None and nv.offset > 0
                and nv.size != t.TOMBSTONE_FILE_SIZE):
            existing = self._read_at(nv.offset, nv.size)
            if existing.cookie != n.cookie:
                raise VolumeError(
                    f"mismatching cookie {n.cookie:x} for needle {n.id:x}")
        return nv

    def append_needles(self, items: "list[_Append]") -> None:
        """Group-commit append: serialize every queued needle, land the
        whole batch with ONE vectored pwritev (single pwrite fallback)
        and ONE flush(+fsync when enabled), then publish the index
        entries — writers are acked only after the shared durable
        point. Per-needle validation errors fail only their own slot;
        an I/O error fails the batch and truncates the torn tail so the
        on-disk state never acknowledges bytes that didn't land."""
        with self._lock:
            if self.read_only:
                err = VolumeError(f"volume {self.vid} is read-only")
                for it in items:
                    it.fail(err)
                return
            offset = self.data_size()
            pos = offset
            blobs: list[bytes] = []
            metas: list[tuple[_Append, Needle, int, object]] = []
            for it in items:
                n = it.needle
                try:
                    nv = self._validate_append(n)
                    n.append_at_ns = time.time_ns()
                    blob = n.to_bytes(self.version)
                except (NeedleError, VolumeError, ValueError) as e:
                    it.fail(e)
                    continue
                metas.append((it, n, pos, nv))
                blobs.append(blob)
                pos += len(blob)
            if not blobs:
                return
            try:
                self._dat.flush()
                fileno = getattr(self._dat, "fileno", None)
                if fileno is None:
                    raise VolumeError(
                        f"volume {self.vid}: remote .dat is append-less")
                fd = fileno()
                self._pwrite_all(fd, blobs, offset)
                if self.fsync:
                    os.fsync(fd)
            except OSError as e:
                # torn batch: cut the tail back so a crashed/partial
                # vectored write can never be read as committed records
                try:
                    self._dat.truncate(offset)
                except OSError:
                    pass
                for it, _, _, _ in metas:
                    it.fail(e)
                return
            for it, n, at, nv in metas:
                self.last_append_at_ns = n.append_at_ns
                if nv is None or nv.offset < at:
                    self.nm.put(n.id, at, n.size)
                modified = n.last_modified or n.append_at_ns // 1_000_000_000
                if modified > self.last_modified_ts:
                    self.last_modified_ts = modified
                it.finish((at, n.size))

    @staticmethod
    def _pwrite_all(fd: int, blobs: list[bytes], offset: int) -> None:
        """Positioned vectored write of every blob, resilient to short
        writes and platforms without pwritev."""
        total = sum(len(b) for b in blobs)
        written = 0
        if hasattr(os, "pwritev"):
            # IOV_MAX-bounded slices; retry the remainder on any short
            # write by flattening what's left
            view = memoryview(b"")  # placeholder for the tail path
            idx = 0
            while idx < len(blobs) and written < total:
                group = blobs[idx:idx + 512]
                want = sum(len(b) for b in group)
                done = os.pwritev(fd, group, offset + written)
                written += done
                if done != want:
                    break
                idx += 512
            if written >= total:
                return
            view = memoryview(b"".join(blobs))[written:]
        else:
            view = memoryview(b"".join(blobs))
        while view:
            done = os.pwrite(fd, view, offset + written)
            written += done
            view = view[done:]

    # sendfile eligibility floor is the caller's business; this just
    # refuses refs when the map entry is too small to be worth one
    def read_needle_ref(self, needle_id: int, cookie: int | None = None,
                        min_bytes: int = 0
                        ) -> "tuple[Needle, NeedleRef] | None":
        """Zero-copy read: parse header + trailing metadata with two
        small preads and return the needle (``data`` EMPTY) plus a
        NeedleRef naming the data region in a PRIVATE file handle, so
        the body can go disk->socket via os.sendfile without entering
        Python. Returns None when a ref is not worth it / not possible
        (remote tier, v1-with-no-meta is fine, too small, torn record)
        — the caller then takes the buffered path. Raises exactly what
        read_needle raises for missing/deleted/expired/cookie-mismatch.

        The body CRC is NOT verified here (the bytes never enter
        userspace); the buffered path keeps CRC-on-read, and scrub
        (ec.verify) covers cold integrity."""
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is not None and nv.size == t.TOMBSTONE_FILE_SIZE:
                raise AlreadyDeleted(f"needle {needle_id:x} deleted")
            if nv is None or nv.offset == 0:
                raise NotFound(f"needle {needle_id:x} not found")
            if self.is_remote or nv.size < max(min_bytes, 32):
                return None
            fileno = getattr(self._dat, "fileno", None)
            if fileno is None:
                return None
            fd = fileno()
            head = os.pread(fd, t.NEEDLE_HEADER_SIZE + 4, nv.offset)
            if len(head) < t.NEEDLE_HEADER_SIZE + 4:
                return None
            n = Needle()
            n.cookie = int.from_bytes(head[0:4], "big")
            n.id = int.from_bytes(head[4:12], "big")
            n.size = int.from_bytes(head[12:16], "big")
            if n.id != needle_id or n.size != nv.size:
                return None          # map/record disagree: buffered path
            if self.version == t.VERSION1:
                data_len = n.size
                data_off = nv.offset + t.NEEDLE_HEADER_SIZE
                meta = b""
                footer_off = data_off + data_len
            else:
                data_len = int.from_bytes(head[16:20], "big")
                data_off = nv.offset + t.NEEDLE_HEADER_SIZE + 4
                meta_len = n.size - 4 - data_len
                if meta_len < 1:
                    return None      # corrupt body framing
                meta = os.pread(fd, meta_len, data_off + data_len)
                if len(meta) < meta_len:
                    return None
                footer_off = data_off + data_len + meta_len
            footer = os.pread(
                fd, 12 if self.version == t.VERSION3 else 4, footer_off)
            if len(footer) >= 4:
                n.checksum = int.from_bytes(footer[0:4], "big")
            if self.version == t.VERSION3 and len(footer) >= 12:
                n.append_at_ns = int.from_bytes(footer[4:12], "big")
            if meta:
                try:
                    self._parse_meta(n, meta)
                except (IndexError, ValueError):
                    return None
            # a PRIVATE handle: independent file offset (a dup'd fd
            # would share the append position with the writer) and an
            # inode pin across vacuum's .dat swap; opened under the
            # volume lock so the offsets and the file can't diverge
            try:
                f = open(self.file_name() + ".dat", "rb")
            except OSError:
                return None
        if cookie is not None and n.cookie != cookie:
            f.close()
            raise NotFound(f"cookie mismatch for needle {needle_id:x}")
        if n.has_expired():
            f.close()
            raise NotFound(f"needle {needle_id:x} expired")
        return n, NeedleRef(f, data_off, data_len)

    @staticmethod
    def _parse_meta(n: Needle, meta: bytes) -> None:
        """Post-data optional fields (flags name mime lm ttl pairs) —
        the tail of Needle._parse_body, for meta read without data."""
        from .needle import (FLAG_HAS_MIME, FLAG_HAS_NAME, FLAG_HAS_PAIRS,
                             FLAG_HAS_TTL, LAST_MODIFIED_BYTES)
        from .needle import FLAG_HAS_LAST_MODIFIED as _FLM
        idx = 0
        n.flags = meta[idx]
        idx += 1
        if n.has(FLAG_HAS_NAME):
            ln = meta[idx]
            idx += 1
            n.name = bytes(meta[idx:idx + ln])
            idx += ln
        if n.has(FLAG_HAS_MIME):
            ln = meta[idx]
            idx += 1
            n.mime = bytes(meta[idx:idx + ln])
            idx += ln
        if n.has(_FLM):
            n.last_modified = int.from_bytes(
                meta[idx:idx + LAST_MODIFIED_BYTES], "big")
            idx += LAST_MODIFIED_BYTES
        if n.has(FLAG_HAS_TTL):
            n.ttl = t.TTL.from_bytes(meta[idx:idx + 2])
            idx += 2
        if n.has(FLAG_HAS_PAIRS):
            ln = int.from_bytes(meta[idx:idx + 2], "big")
            idx += 2
            n.pairs = bytes(meta[idx:idx + ln])

    def delete_needle(self, n: Needle) -> int:
        """Tombstone delete; returns reclaimed byte count
        (volume_read_write.go:115-136)."""
        with self._lock:
            if self.read_only:
                raise VolumeError(f"volume {self.vid} is read-only")
            nv = self.nm.get(n.id)
            if nv is None or nv.size == t.TOMBSTONE_FILE_SIZE:
                return 0
            size = nv.size
            n.data = b""
            n.append_at_ns = time.time_ns()
            offset = self.data_size()
            self._dat.seek(offset)
            self._dat.write(n.to_bytes(self.version))
            self._dat.flush()
            if self.fsync:
                # -fsync must cover tombstones too, or an acked DELETE
                # could be lost on power failure while a concurrently
                # acked write in the same window is durable
                fileno = getattr(self._dat, "fileno", None)
                if fileno is not None:
                    os.fsync(fileno())
            self.last_append_at_ns = n.append_at_ns
            self.nm.delete(n.id, offset)
            return size

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        """O(1) read: nm.Get + one ReadAt (volume_read_write.go:139-172)."""
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is not None and nv.size == t.TOMBSTONE_FILE_SIZE:
                raise AlreadyDeleted(f"needle {needle_id:x} deleted")
            if nv is None or nv.offset == 0:
                raise NotFound(f"needle {needle_id:x} not found")
            n = self._read_at(nv.offset, nv.size)
        if cookie is not None and n.cookie != cookie:
            raise NotFound(f"cookie mismatch for needle {needle_id:x}")
        if n.has_expired():
            raise NotFound(f"needle {needle_id:x} expired")
        return n

    # ---- scanning (volume_read_write.go:174-230 ScanVolumeFile) ----

    def scan(self, visit) -> None:
        """visit(needle, offset) over every record incl. tombstones."""
        size = self.data_size()
        offset = 8  # past the superblock
        # sequential walk: on a tiered volume, coalesce the per-record
        # preads into few large ranged GETs instead of 2 round trips
        # per needle
        pread = (_ReadaheadCursor(self._pread, size).read
                 if self.is_remote else self._pread)
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            header = pread(t.NEEDLE_HEADER_SIZE, offset)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                break
            body_size = int.from_bytes(header[12:16], "big")
            rec_len = t.actual_size(body_size, self.version)
            blob = pread(rec_len, offset)
            if len(blob) < rec_len:
                break
            n = Needle.from_bytes(blob, self.version, check_crc=False)
            visit(n, offset)
            offset += rec_len

    # ---- stats / lifecycle ----

    def stat(self) -> VolumeStat:
        return VolumeStat(
            file_count=self.nm.file_count,
            deleted_count=self.nm.deleted_count,
            deleted_bytes=self.nm.deleted_size,
            size=self.data_size(),
            read_only=self.read_only,
        )

    def garbage_level(self) -> float:
        size = self.data_size()
        if size <= 8:
            return 0.0
        return self.nm.deleted_size / size

    def is_full(self, volume_size_limit: int) -> bool:
        return self.data_size() >= volume_size_limit

    def close(self) -> None:
        with self._lock:
            self.nm.close()
            self._dat.close()

    def destroy(self) -> None:
        with self._lock:
            self.nm.destroy()
            self._dat.close()
            base = self.file_name()
            # drop the remote object too (guarded on .vif presence, not
            # is_remote — a keep_local tiered volume reopened from its
            # local .dat has is_remote=False but still owns the object);
            # leftovers would otherwise orphan it, and the .vif would
            # resurrect an empty volume on restart
            from . import backend as _backend
            vinfo = _backend.load_volume_info(base)
            if vinfo and vinfo.get("files"):
                fi = vinfo["files"][0]
                try:
                    _backend.get_backend(fi["backend_id"]).delete_file(
                        fi["key"])
                except _backend.BackendError:
                    pass
            for ext in (".dat", ".vif"):
                p = base + ext
                if os.path.exists(p):
                    os.remove(p)
