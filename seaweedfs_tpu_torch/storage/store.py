"""Store: the per-volume-server manager of volumes and EC shards.

Reference: weed/storage/store.go:24-40 (DiskLocations, read/write/delete
routing, heartbeat building), disk_location.go (load volumes on start),
disk_location_ec.go (discover EC shards), store_ec.go (EC reads).

A copy of seaweedfs_tpu/storage/store.py in the PyTorch port.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time

from ..ec import gf
from ..ec.ec_volume import EcVolume, NotFoundError as EcNotFound
from ..ec.locate import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
from ..pb import messages as pb
from ..util import events, failpoints, tracing
from . import types as t
from .needle import Needle
from .super_block import ReplicaPlacement
from .volume import (AlreadyDeleted, NotFound, Volume, VolumeError,
                     _Append)


_VOL_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_EC_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ecx$")


class BatchBudgetExceeded(Exception):
    """Marker for batch-read rows beyond the response byte budget."""


class _VolumeAppender:
    """Group-commit coordinator for one volume: concurrent write_needle
    callers (executor threads) enqueue; whichever thread finds the
    commit slot free becomes the LEADER, drains the whole queue and
    lands it as one vectored append + one flush/fsync
    (Volume.append_needles). Natural batching: zero added latency for a
    lone writer, batches form exactly when writers contend. An optional
    window (-groupcommit.ms) makes the leader linger to deepen batches
    on bursty open-loop load."""

    __slots__ = ("cv", "queue", "busy", "window",
                 "batches", "appended", "max_batch")

    def __init__(self, window_s: float = 0.0) -> None:
        self.cv = threading.Condition()
        self.queue: list[_Append] = []
        self.busy = False
        self.window = window_s
        self.batches = 0
        self.appended = 0
        self.max_batch = 0

    def append(self, v: Volume, n: Needle) -> tuple[int, int, int]:
        item = _Append(n)
        with self.cv:
            self.queue.append(item)
            while self.busy and not item.done:
                self.cv.wait()
            if not item.done:
                self.busy = True      # this thread leads the next batch
        if not item.done:
            if self.window > 0:
                # deepen the batch: latecomers during the window join
                time.sleep(self.window)
            with self.cv:
                batch = self.queue
                self.queue = []
            try:
                for it in batch:
                    it.batch = len(batch)
                v.append_needles(batch)
                self.batches += 1
                self.appended += len(batch)
                if len(batch) > self.max_batch:
                    self.max_batch = len(batch)
                    if v.fsync and len(batch) > 1:
                        # deepest-yet batch sharing ONE durable fsync
                        # point: rate-bounded by construction (only
                        # new records journal), the flight recorder's
                        # view of group-commit behavior under load
                        events.record("fsync_upgrade", vid=v.vid,
                                      batch=len(batch))
            except BaseException as e:  # noqa: BLE001 — every waiter
                # must be released; append_needles only raises on bugs
                for it in batch:
                    if not it.done:
                        it.fail(e)
            finally:
                with self.cv:
                    self.busy = False
                    self.cv.notify_all()
        if item.exc is not None:
            raise item.exc
        assert item.result is not None
        # (offset, size, batch-size-this-write-rode-in)
        return item.result[0], item.result[1], item.batch

    def to_dict(self) -> dict:
        return {"batches": self.batches, "appended": self.appended,
                "max_batch": self.max_batch}


class Store:
    def __init__(self, dirs: list[str], ip: str = "localhost",
                 port: int = 0, public_url: str = "",
                 max_volume_counts: list[int] | None = None,
                 ec_large_block: int = LARGE_BLOCK_SIZE,
                 ec_small_block: int = SMALL_BLOCK_SIZE,
                 compaction_bytes_per_second: int = 0,
                 index_type: str = "auto",
                 partition: "tuple[int, int] | None" = None,
                 needle_cache_bytes: int = 0,
                 group_commit_window: float = 0.0,
                 fsync: bool = False,
                 ec_small_recover_bytes: int | None = None):
        # device-vs-host EC recover crossover (-ec.smallrecover flag);
        # None keeps EcVolume.SMALL_RECOVER_BYTES
        self.ec_small_recover_bytes = ec_small_recover_bytes
        # needle map kind for every owned volume (-index flag analog)
        self.index_type = index_type
        # hot-needle read cache (-cache.mem flag): parsed needles keyed
        # (vid, nid) under one byte budget, consulted by BOTH http paths
        # through read_needle/cached_needle; 0 disables every volume-side
        # read cache (needle + EC reconstruction)
        from ..util.chunk_cache import EcRecoverCache, NeedleCache
        # the configured budget is the TOTAL: hot needles get three
        # quarters, the EC reconstruction cache the remaining quarter —
        # an operator sizing -cache.mem must not find the process using
        # more than the flag says
        self.needle_cache = (NeedleCache(needle_cache_bytes * 3 // 4)
                             if needle_cache_bytes > 0 else None)
        # degraded-read reconstruction cache, shared across this store's
        # EC volumes (keys carry the vid): repeated reads of a lost
        # shard's hot intervals reuse the decoded bytes instead of
        # re-running the GF(256) transform
        self.ec_recover_cache = (EcRecoverCache(needle_cache_bytes // 4)
                                 if needle_cache_bytes > 0 else None)
        # (index, total) under -workers N: this store owns only volumes
        # with vid % total == index — workers sharing the data dirs open
        # disjoint volume sets, so needle maps and file handles stay
        # shared-nothing across processes (server/workers.py)
        if partition is not None and not 0 <= partition[0] < partition[1]:
            raise ValueError(f"bad store partition {partition}")
        self.partition = partition
        self.dirs = dirs
        # vacuum copy rate limit applied to every owned volume
        # (compactionBytePerSecond flag)
        self.compaction_bytes_per_second = compaction_bytes_per_second
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.max_volume_counts = max_volume_counts or [8] * len(dirs)
        from ..ec.locate import check_blocks
        check_blocks(ec_large_block, ec_small_block)
        self.ec_large_block = ec_large_block
        self.ec_small_block = ec_small_block
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        # note: _own() applies per-store volume policy on every Volume
        self._lock = threading.RLock()
        # deltas queued for the next heartbeat
        self.new_volumes: list[pb.VolumeInformationMessage] = []
        self.deleted_volumes: list[pb.VolumeInformationMessage] = []
        self.new_ec_shards: list[pb.VolumeEcShardInformationMessage] = []
        self.deleted_ec_shards: list[pb.VolumeEcShardInformationMessage] = []
        # group-commit append coordination: one appender per volume,
        # created lazily; window 0 = natural batching (-groupcommit.ms)
        self.group_commit_window = group_commit_window
        self.fsync = fsync
        self._appenders: dict[int, _VolumeAppender] = {}
        # remote shard readers injected by the volume server layer:
        # single-interval and batched (one request per holder) forms
        self.fetch_remote_shard = None
        self.fetch_remote_shard_batch = None
        # repair-planning hooks (volume server layer): peek the cached
        # holder map with no I/O (fn(vid) -> {sid: holder} | None) and
        # force one holder re-resolve after a failed batch gather
        # (fn(vid) -> None) — ec_volume._repair_plan / _recover_interval
        self.ec_holder_peek = None
        self.ec_refresh_holders = None
        # where report_ec_rot sends a survivor that a degraded read or
        # a rebuild pinned as rotten (the volume server's scrubber,
        # which the autopilot observes): fn(report) | None
        self.ec_rot_sink = None
        for d in dirs:
            os.makedirs(d, exist_ok=True)
            self._load_existing(d)

    def owns(self, vid: int) -> bool:
        """True when this store's partition covers the volume id."""
        return self.partition is None or \
            vid % self.partition[1] == self.partition[0]

    # ---- loading (disk_location.go:79-113, disk_location_ec.go:115-161) ----

    def _load_existing(self, d: str) -> None:
        for path in glob.glob(os.path.join(d, "*.dat")):
            m = _VOL_RE.match(os.path.basename(path))
            if not m:
                continue
            vid = int(m.group("vid"))
            if not self.owns(vid):
                continue
            col = m.group("col") or ""
            try:
                self.volumes[vid] = self._own(Volume(
                    d, col, vid, create_if_missing=False,
                    needle_map_kind=self.index_type))
            except VolumeError:
                continue
        for path in glob.glob(os.path.join(d, "*.vif")):
            # tiered volume: .dat lives on a remote backend (.vif sidecar)
            m = _VOL_RE.match(os.path.basename(path)[:-4] + ".dat")
            if not m:
                continue
            vid = int(m.group("vid"))
            if vid in self.volumes or not self.owns(vid):
                continue
            col = m.group("col") or ""
            try:
                self.volumes[vid] = self._own(Volume(
                    d, col, vid, create_if_missing=False,
                    needle_map_kind=self.index_type))
            except Exception as e:  # noqa: BLE001 — any backend shape
                # backend unreachable or not configured yet: skip, but
                # an operator must be able to see WHY a tiered volume
                # did not come up
                from ..util import glog
                glog.warning("tiered volume %d (%s): not loaded: %s",
                             vid, path, e)
                continue
        for path in glob.glob(os.path.join(d, "*.ecx")):
            m = _EC_RE.match(os.path.basename(path))
            if not m:
                continue
            vid = int(m.group("vid"))
            if vid in self.volumes or not self.owns(vid):
                continue
            col = m.group("col") or ""
            try:
                self._mount_ec(d, col, vid)
            except OSError:
                continue

    def _mount_ec(self, d: str, collection: str, vid: int) -> EcVolume:
        ev = EcVolume(d, collection, vid,
                      large_block=self.ec_large_block,
                      small_block=self.ec_small_block,
                      fetch_remote=self._make_remote_fetcher(vid),
                      fetch_remote_batch=self._make_remote_batch_fetcher(
                          vid),
                      recover_cache=self.ec_recover_cache,
                      holder_peek=self._make_holder_peek(vid),
                      refresh_holders=self._make_holder_refresh(vid),
                      small_recover_bytes=self.ec_small_recover_bytes,
                      report_rot=self.report_ec_rot)
        self.ec_volumes[vid] = ev
        return ev

    def report_ec_rot(self, report: dict) -> None:
        """Hand one found-rot report ({"volume", "window", "offset",
        "size", "shards": [c], ...}) to ec_rot_sink."""
        if self.ec_rot_sink is not None:
            self.ec_rot_sink(report)

    def _make_holder_peek(self, vid: int):
        def peek():
            if self.ec_holder_peek is None:
                return None
            return self.ec_holder_peek(vid)
        return peek

    def _make_holder_refresh(self, vid: int):
        def refresh():
            if self.ec_refresh_holders is not None:
                self.ec_refresh_holders(vid)
        return refresh

    def _make_remote_fetcher(self, vid: int):
        def fetch(shard_id: int, offset: int, size: int):
            if self.fetch_remote_shard is None:
                return None
            return self.fetch_remote_shard(vid, shard_id, offset, size)
        return fetch

    def _make_remote_batch_fetcher(self, vid: int):
        def fetch_batch(reads: "list[tuple[int, int, int]]"):
            if self.fetch_remote_shard_batch is None:
                return None
            return self.fetch_remote_shard_batch(vid, reads)
        return fetch_batch

    # ---- volume lifecycle ----

    def _own(self, v: Volume) -> Volume:
        v.compaction_bytes_per_second = self.compaction_bytes_per_second
        v.fsync = self.fsync
        return v

    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "", ttl: str = "",
                   preallocate: int = 0) -> Volume:
        with self._lock:
            if vid in self.volumes:
                raise VolumeError(f"volume {vid} already exists")
            if not self.owns(vid):
                raise VolumeError(
                    f"volume {vid} belongs to worker "
                    f"{vid % self.partition[1]}, not {self.partition[0]}")
            v = self._own(Volume(
                self.dirs[vid % len(self.dirs)], collection, vid,
                replica_placement=ReplicaPlacement.parse(replication),
                ttl=t.TTL.parse(ttl), preallocate=preallocate,
                needle_map_kind=self.index_type))
            self.volumes[vid] = v
            self.new_volumes.append(self._volume_message(v))
            events.record("volume_mount", vid=vid, kind="allocate",
                          collection=collection)
            return v

    def delete_volume(self, vid: int, collection: str = "") -> None:
        self.drop_cached_volume(vid)
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is not None:
                msg = self._volume_message(v)
                v.destroy()
                self.deleted_volumes.append(msg)
                events.record("volume_unmount", vid=vid, kind="delete")
                return
            # not mounted: still destroy the on-disk files — an unmount
            # followed by delete must not leave .dat/.idx behind to
            # resurrect the volume on the next mount or restart
            for d in self.dirs:
                base = os.path.join(
                    d, f"{collection}_{vid}" if collection else str(vid))
                # a tiered volume without keepLocal has no .dat — its
                # .vif/.idx still resurrect it on restart, so any sidecar
                # marks the volume as present for deletion
                if not any(os.path.exists(base + ext)
                           for ext in (".dat", ".vif", ".idx")):
                    continue
                try:
                    Volume(d, collection, vid, create_if_missing=False,
                           needle_map_kind=self.index_type).destroy()
                except Exception:  # noqa: BLE001 — damaged volume: the
                    # load path may refuse it, but delete must still win
                    for ext in (".dat", ".idx", ".vif", ".sdx",
                                ".cpd", ".cpx"):
                        p = base + ext
                        if os.path.exists(p):
                            os.remove(p)
                return
        raise VolumeError(f"volume {vid} not found")

    def mark_readonly(self, vid: int, read_only: bool = True) -> None:
        with self._lock:
            if vid in self.volumes:
                self.volumes[vid].read_only = read_only

    def mount_volume(self, collection: str, vid: int) -> None:
        """Load an on-disk volume (after a copy) — VolumeMount."""
        self.drop_cached_volume(vid)    # copied-in bytes may differ
        with self._lock:
            if vid in self.volumes:
                return
            if not self.owns(vid):
                raise VolumeError(
                    f"volume {vid} not in this worker's partition")
            for d in self.dirs:
                base = os.path.join(
                    d, f"{collection}_{vid}" if collection else str(vid))
                if os.path.exists(base + ".dat"):
                    v = self._own(Volume(d, collection, vid,
                                         create_if_missing=False,
                                         needle_map_kind=self.index_type))
                    self.volumes[vid] = v
                    self.new_volumes.append(self._volume_message(v))
                    events.record("volume_mount", vid=vid, kind="mount",
                                  collection=collection)
                    return
            raise VolumeError(f"volume {vid} not on disk")

    def unmount_volume(self, vid: int) -> None:
        self.drop_cached_volume(vid)
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is not None:
                self.deleted_volumes.append(self._volume_message(v))
                v.close()
                events.record("volume_unmount", vid=vid, kind="unmount")

    # ---- data plane ----

    def _appender_for(self, vid: int) -> _VolumeAppender:
        ap = self._appenders.get(vid)
        if ap is None:
            with self._lock:
                ap = self._appenders.setdefault(
                    vid, _VolumeAppender(self.group_commit_window))
        return ap

    def write_needle(self, vid: int, n: Needle) -> tuple[int, int]:
        # chaos site `store.write`: sits below BOTH wire shapes (the
        # unified wire layer feeds it from the aiohttp and raw
        # listeners alike), and fires per CALLER — an injected fault
        # fails only this writer, never the whole group-commit batch.
        # One dict-emptiness check when disarmed.
        failpoints.sync_fail("store.write")
        with tracing.start("store", "write", vid=vid) as sp:
            v = self.volumes.get(vid)
            if v is None:
                sp.status = "404"
                raise NotFound(f"volume {vid} not found")
            # group commit: concurrent writers to this volume coalesce
            # into one vectored append + one shared flush/fsync
            item = self._appender_for(vid).append(v, n)
            sp.nbytes = len(n.data)
            if item[2] > 1:
                sp.set("gc_batch", item[2])
            result = (item[0], item[1])
            # AFTER the durable append: dropping first would let a racing
            # reader re-populate the old bytes between drop and write
            if self.needle_cache is not None:
                self.needle_cache.invalidate(vid, n.id)
            return result

    def group_commit_stats(self) -> dict:
        """Aggregate group-commit counters across this store's volumes
        (whole-process view for /status and the wire smoke)."""
        out = {"batches": 0, "appended": 0, "max_batch": 0}
        for ap in list(self._appenders.values()):
            out["batches"] += ap.batches
            out["appended"] += ap.appended
            out["max_batch"] = max(out["max_batch"], ap.max_batch)
        return out

    def _cached(self, vid: int, needle_id: int, cookie: int | None,
                count_miss: bool = True,
                count_hit: bool = True) -> Needle | None:
        """Cache peek; None means the slow path must decide (miss,
        cookie mismatch, expiry — the disk read raises the right
        error for the last two). A hit is counted only AFTER the
        cookie/expiry checks pass, so unservable entries don't inflate
        the hit rate; the miss is counted once, by the slow path."""
        nc = self.needle_cache
        if nc is None:
            return None
        n = nc.peek(vid, needle_id)
        if n is None or (cookie is not None and n.cookie != cookie) \
                or n.has_expired():
            if count_miss:
                nc.miss()
            return None
        if count_hit:
            nc.hit(n)
        return n

    def cached_needle(self, vid: int, needle_id: int,
                      cookie: int | None = None,
                      count: bool = True) -> Needle | None:
        """Synchronous hot-path peek for the event-loop read handlers:
        a hit answers without the executor round-trip or any disk I/O.
        Declines (None) whenever the `store.read` chaos site is armed so
        injected read faults keep firing under cache-hot load.
        ``count=False`` defers all accounting to the caller — for the
        fasthttp path, whose replay-to-aiohttp branch would otherwise
        count the same client request twice."""
        if failpoints.pending("store.read"):
            return None
        # the slow path that follows a peek miss counts it; counting
        # here too would double every cold read's miss
        return self._cached(vid, needle_id, cookie, count_miss=False,
                            count_hit=count)

    def read_needle(self, vid: int, needle_id: int,
                    cookie: int | None = None) -> Needle:
        failpoints.sync_fail("store.read")  # chaos site (see store.write)
        # the store span records WHERE the bytes came from — cache,
        # pread, sendfile ref, or EC gather/reconstruct — the
        # per-request attribution the degraded-read literature says
        # dominates tail latency
        with tracing.start("store", "read", vid=vid) as sp:
            return self._read_inner(vid, needle_id, cookie, sp)

    def read_needle_ex(self, vid: int, needle_id: int,
                       cookie: int | None = None, ref_min: int = 0):
        """Read for the unified wire layer: when ``ref_min`` > 0 and
        the needle is a plain local-volume record at least that big,
        returns ``(meta_needle, NeedleRef)`` so the caller can
        zero-copy the body with sendfile; otherwise ``(needle, None)``
        via the exact buffered path. One failpoint fire, one span,
        one executor hop either way."""
        failpoints.sync_fail("store.read")
        with tracing.start("store", "read", vid=vid) as sp:
            if ref_min > 0:
                v = self.volumes.get(vid)
                if v is not None:
                    try:
                        got = v.read_needle_ref(needle_id, cookie,
                                                ref_min)
                    except (NotFound, AlreadyDeleted):
                        sp.status = "404"
                        raise
                    except OSError:
                        got = None   # racing unmount etc: buffered path
                    if got is not None:
                        n, ref = got
                        sp.set("source", "sendfile")
                        sp.nbytes = ref.length
                        return n, ref
            return self._read_inner(vid, needle_id, cookie, sp), None

    def read_needles(self, specs: "list[tuple[int, int, int | None]]",
                     byte_budget: "int | None" = None
                     ) -> "list[Needle | Exception]":
        """Batch read: resolve many (vid, needle_id, cookie) specs in
        ONE executor round trip — the per-request pread coalescing the
        batch GET endpoint rides. Per-needle failures come back as the
        exception instead of poisoning the whole batch; once the byte
        budget is spent, remaining rows come back BatchBudgetExceeded
        (the server must not buffer an unbounded response for one
        request — those rows fall back to streamed single GETs)."""
        out: "list[Needle | Exception]" = []
        used = 0
        for vid, needle_id, cookie in specs:
            if byte_budget is not None and used > byte_budget:
                out.append(BatchBudgetExceeded(
                    f"batch byte budget exhausted after {used} bytes"))
                continue
            try:
                n = self.read_needle(vid, needle_id, cookie)
                used += len(n.data)
                out.append(n)
            except Exception as e:  # noqa: BLE001 — per-row verdicts:
                # the caller maps each to its row's HTTP status
                out.append(e)
        return out

    def _read_inner(self, vid: int, needle_id: int,
                    cookie: int | None, sp) -> Needle:
        n = self._cached(vid, needle_id, cookie)
        if n is not None:
            sp.set("source", "cache")
            sp.nbytes = len(n.data)
            return n
        # snapshot the volume's mutation generation BEFORE the disk
        # read: a write/delete landing between our read and our put
        # bumps it, and put() then refuses the stale fill
        nc = self.needle_cache
        gen = nc.generation(vid) if nc is not None else 0
        v = self.volumes.get(vid)
        if v is not None:
            try:
                n = v.read_needle(needle_id, cookie)
            except OSError:
                if vid not in self.volumes:
                    # the volume was destroyed mid-read (TTL
                    # reclamation / admin delete): a clean 404, not
                    # a bad-file-descriptor 500
                    sp.status = "404"
                    raise NotFound(f"volume {vid} was removed")
                raise
            if nc is not None:
                nc.put(vid, needle_id, n, gen=gen)
            sp.set("source", "pread")
            sp.nbytes = len(n.data)
            return n
        ev = self.ec_volumes.get(vid)
        if ev is not None:
            try:
                n = ev.read_needle(needle_id, cookie)
            except EcNotFound as e:
                sp.status = "404"
                raise NotFound(str(e))
            if nc is not None:
                nc.put(vid, needle_id, n, gen=gen)
            sp.set("source", "ec")
            sp.nbytes = len(n.data)
            return n
        sp.status = "404"
        raise NotFound(f"volume {vid} not found")

    def delete_needle(self, vid: int, n: Needle) -> int:
        v = self.volumes.get(vid)
        if v is not None:
            size = v.delete_needle(n)
            if self.needle_cache is not None:
                self.needle_cache.invalidate(vid, n.id)
            return size
        ev = self.ec_volumes.get(vid)
        if ev is not None:
            ev.delete_needle(n.id)
            if self.needle_cache is not None:
                self.needle_cache.invalidate(vid, n.id)
            return 0
        raise NotFound(f"volume {vid} not found")

    def drop_cached_volume(self, vid: int) -> None:
        """Volume-wide cache invalidation: vacuum commit, tail-receive
        apply, unmount/delete — any event that may rewrite needles
        without going through write_needle/delete_needle."""
        if self.needle_cache is not None:
            self.needle_cache.drop_volume(vid)

    def commit_compaction(self, vid: int) -> None:
        """Vacuum commit + strict cache invalidation: the .dat/.idx
        swap moves every surviving needle, so all cached entries for
        the volume are dropped (a cached needle MUST miss after the
        volume is vacuumed)."""
        from . import vacuum
        v = self.volumes.get(vid)
        if v is None:
            raise NotFound(f"volume {vid} not found")
        vacuum.commit_compact(v)
        self.drop_cached_volume(vid)
        events.record("volume_vacuum", vid=vid)

    def has_volume(self, vid: int) -> bool:
        return vid in self.volumes or vid in self.ec_volumes

    # ---- EC shard lifecycle (server side of ec.encode/rebuild) ----

    def _drop_ec_recover(self, vid: int) -> None:
        """The reconstruction cache is store-wide, so entries outlive
        any one EcVolume object: a re-encoded volume remounted at the
        same vid must not serve the old generation's decoded bytes.
        drop_volume also bumps the vid's generation, which fences any
        reconstruction fill still in flight against the old shards."""
        if self.ec_recover_cache is not None:
            self.ec_recover_cache.drop_volume(vid)

    def mount_ec_shards(self, collection: str, vid: int) -> list[int]:
        self._drop_ec_recover(vid)
        self.drop_cached_volume(vid)
        with self._lock:
            if not self.owns(vid):
                raise VolumeError(
                    f"ec volume {vid} not in this worker's partition")
            ev = self.ec_volumes.get(vid)
            if ev is not None:
                ev.close()
            for d in self.dirs:
                base = os.path.join(
                    d, f"{collection}_{vid}" if collection else str(vid))
                if os.path.exists(base + ".ecx"):
                    ev = self._mount_ec(d, collection, vid)
                    bits = 0
                    for sid in ev.shards:
                        bits = pb.shard_bits_add(bits, sid)
                    self.new_ec_shards.append(
                        pb.VolumeEcShardInformationMessage(
                            id=vid, collection=collection,
                            ec_index_bits=bits))
                    events.record("ec_mount", vid=vid,
                                  shards=sorted(ev.shards))
                    return sorted(ev.shards)
            raise VolumeError(f"no .ecx found for ec volume {vid}")

    def unmount_ec_shards(self, vid: int, shard_ids: list[int] | None = None
                          ) -> None:
        self._drop_ec_recover(vid)
        self.drop_cached_volume(vid)
        with self._lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                return
            bits = 0
            removed = shard_ids if shard_ids is not None else list(ev.shards)
            for sid in removed:
                f = ev.shards.pop(sid, None)
                if f is not None:
                    f.close()
                bits = pb.shard_bits_add(bits, sid)
            # the missing-set changed: repair plans keyed on it are
            # stale (a plan could otherwise route a recover at a
            # just-closed local fd)
            ev.invalidate_plans()
            self.deleted_ec_shards.append(
                pb.VolumeEcShardInformationMessage(
                    id=vid, collection=ev.collection, ec_index_bits=bits))
            events.record("ec_unmount", vid=vid, shards=removed)
            if not ev.shards:
                ev.close()
                del self.ec_volumes[vid]

    def read_ec_shard_interval(self, vid: int, shard_id: int,
                               offset: int, size: int) -> bytes | None:
        ev = self.ec_volumes.get(vid)
        if ev is None:
            return None
        f = ev.shards.get(shard_id)
        if f is None:
            return None
        failpoints.sync_fail("store.ec_read")
        data = os.pread(f.fileno(), size, offset)
        return data + b"\x00" * (size - len(data))

    def read_ec_shard_intervals(
            self, vid: int, reads: "list[tuple[int, int, int]]"
            ) -> "list[bytes | None]":
        """Batched shard-interval reads for the wire batch path: one
        request (and one executor hop) gathers many (shard, offset,
        size) intervals — the k-fetch fan-out of a degraded read costs
        one round trip per HOLDER instead of one per interval."""
        return [self.read_ec_shard_interval(vid, sid, off, size)
                for sid, off, size in reads]

    # ---- heartbeat (store.go:165-219 CollectHeartbeat) ----

    def _volume_message(self, v: Volume) -> pb.VolumeInformationMessage:
        st = v.stat()
        return pb.VolumeInformationMessage(
            id=v.vid, size=st.size, collection=v.collection,
            file_count=st.file_count, delete_count=st.deleted_count,
            deleted_byte_count=st.deleted_bytes, read_only=v.read_only,
            replica_placement=v.super_block.replica_placement.to_byte(),
            version=v.version, ttl=v.ttl.to_uint32(),
            compact_revision=v.super_block.compaction_revision,
            remote=v.is_remote)

    # minutes an expired TTL volume lingers before its files are
    # destroyed (store.go MAX_TTL_VOLUME_REMOVAL_DELAY); actual delay is
    # min(this, ttl/10) like the reference's expiredLongEnough
    MAX_TTL_REMOVAL_DELAY_M = 10.0

    def _ttl_lived_minutes(self, v) -> float | None:
        """Minutes past this TTL volume's expiry, or None when the
        volume has no TTL / no content yet (volume.go expired())."""
        ttl_m = v.ttl.minutes
        if not ttl_m or not v.last_modified_ts or v.data_size() <= 8:
            return None
        lived_m = (time.time() - v.last_modified_ts) / 60
        return lived_m - ttl_m if lived_m > ttl_m else None

    def collect_heartbeat(self, data_center: str = "",
                          rack: str = "") -> pb.Heartbeat:
        with self._lock:
            # TTL volume reclamation rides the heartbeat walk like the
            # reference (store.go:165-200): an expired volume stops
            # being advertised immediately and its files are destroyed
            # once it has lingered past the removal delay
            expired_now: list[int] = []
            active = {}
            for vid, v in self.volumes.items():
                over_m = self._ttl_lived_minutes(v)
                if over_m is None:
                    active[vid] = v
                elif over_m > min(self.MAX_TTL_REMOVAL_DELAY_M,
                                  v.ttl.minutes / 10):
                    expired_now.append(vid)
                # else: expired but within the grace window — drop from
                # the advertised set, keep the files for now
            for vid in expired_now:
                v = self.volumes.pop(vid)
                self.deleted_volumes.append(self._volume_message(v))
                v.destroy()
                self.drop_cached_volume(vid)
            volumes = [self._volume_message(v) for v in active.values()]
            ec_msgs = []
            for vid, ev in self.ec_volumes.items():
                bits = 0
                for sid in ev.shards:
                    bits = pb.shard_bits_add(bits, sid)
                ec_msgs.append(pb.VolumeEcShardInformationMessage(
                    id=vid, collection=ev.collection, ec_index_bits=bits))
            max_key = max((v.nm.max_file_key
                           for v in self.volumes.values()), default=0)
            # under -workers the slot budget is split across the worker
            # fleet, or the master would see N× the real disk capacity
            slots = sum(self.max_volume_counts)
            if self.partition is not None:
                idx, total = self.partition
                slots = slots // total + (1 if idx < slots % total else 0)
            hb = pb.Heartbeat(
                ip=self.ip, port=self.port, public_url=self.public_url,
                max_volume_count=slots,
                max_file_key=max_key,
                data_center=data_center, rack=rack,
                volumes=volumes,
                new_volumes=self.new_volumes[:],
                deleted_volumes=self.deleted_volumes[:],
                ec_shards=ec_msgs,
                has_no_volumes=not volumes,
                has_no_ec_shards=not ec_msgs,
            )
            self.new_volumes.clear()
            self.deleted_volumes.clear()
            hb.new_ec_shards = self.new_ec_shards[:]
            hb.deleted_ec_shards = self.deleted_ec_shards[:]
            self.new_ec_shards.clear()
            self.deleted_ec_shards.clear()
            return hb

    def close(self) -> None:
        with self._lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
