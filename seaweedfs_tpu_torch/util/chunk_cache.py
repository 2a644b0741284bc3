"""Tiered byte-budgeted read caches for the hot data path.

Reference: weed/util/chunk_cache/ — `chunk_cache.go` fronts a small
in-memory tier (chunk_cache_in_memory.go) over size-classed mmap-backed
on-disk cache volumes (chunk_cache_on_disk.go, on_disk_cache_layer.go);
readers consult memory first, then the disk classes smallest-first.

This module provides the same shape as composable primitives:

  * ``CacheCounters``  — hit/miss/byte/eviction counters per named cache,
    mirrored into Prometheus (stats/metrics.py) when available so every
    cache shows up on ``/metrics`` (and sums across ``-workers`` siblings
    through the existing exposition merge).
  * ``LruByteCache``   — thread-safe LRU over arbitrary values with a
    byte budget (the in-memory tier, and the EC reconstruction cache).
  * ``DiskCacheLayer`` — size-classed ring of slots inside one
    preallocated mmap file per class (the disk tier).
  * ``TieredChunkCache`` — memory tier + optional disk tier keyed by
    file id, used by WeedClient/filer for whole-chunk caching.
  * ``NeedleCache``    — LRU of parsed needles keyed ``(vid, nid)`` for
    the volume server's hot-needle path, with volume-wide drops for
    vacuum/unmount invalidation.

Every cache here is an *optimisation overlay*: a ``None`` cache (or a
zero budget) must behave exactly like the code before this layer
existed, and correctness never depends on an entry being present.

A copy of seaweedfs_tpu/util/chunk_cache.py in the PyTorch port.
"""

from __future__ import annotations

import mmap
import os
import threading
from collections import OrderedDict


class CacheCounters:
    """Plain-int hit/miss counters, mirrored to Prometheus when present.

    The ints are authoritative for tests and ``to_dict()``; the
    Prometheus side is best-effort and lazily bound so importing this
    module never forces prometheus_client to load.
    """

    __slots__ = ("name", "hits", "misses", "hit_bytes", "evictions",
                 "used_bytes", "_prom")

    def __init__(self, name: str):
        self.name = name
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.evictions = 0
        self.used_bytes = 0
        self._prom = None

    def _labels(self):
        if self._prom is None:
            from ..stats import metrics
            if not metrics.HAVE_PROMETHEUS:
                self._prom = ()
            else:
                self._prom = (
                    metrics.CACHE_HITS.labels(self.name),
                    metrics.CACHE_MISSES.labels(self.name),
                    metrics.CACHE_HIT_BYTES.labels(self.name),
                    metrics.CACHE_EVICTIONS.labels(self.name),
                    metrics.CACHE_USED_BYTES.labels(self.name),
                )
        return self._prom

    def hit(self, nbytes: int) -> None:
        self.hits += 1
        self.hit_bytes += nbytes
        p = self._labels()
        if p:
            p[0].inc()
            p[2].inc(nbytes)

    def miss(self) -> None:
        self.misses += 1
        p = self._labels()
        if p:
            p[1].inc()

    def evicted(self, n: int = 1) -> None:
        self.evictions += n
        p = self._labels()
        if p:
            p[3].inc(n)

    def set_used(self, nbytes: int) -> None:
        self.used_bytes = nbytes
        p = self._labels()
        if p:
            p[4].set(nbytes)

    def set_budget(self, nbytes: int) -> None:
        """Export the configured byte budget so occupancy-vs-budget is
        one division on any scrape/timeline window (saturation.py)."""
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.CACHE_BUDGET_BYTES.labels(self.name).set(nbytes)

    def to_dict(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_bytes": self.hit_bytes, "evictions": self.evictions,
                "used_bytes": self.used_bytes,
                "hit_rate": (self.hits / total) if total else 0.0}


class LruByteCache:
    """Thread-safe LRU with a byte budget over opaque values.

    ``put`` evicts least-recently-used entries until the new entry fits;
    an entry larger than the whole budget is simply not cached (the
    caller's read path must not depend on residency).
    """

    def __init__(self, budget: int, name: str = "lru",
                 counters: CacheCounters | None = None):
        self.budget = max(0, int(budget))
        self.counters = counters or CacheCounters(name)
        self.counters.set_budget(self.budget)
        self._lock = threading.Lock()
        self._map: "OrderedDict[object, tuple[object, int]]" = OrderedDict()
        self._used = 0

    def __len__(self) -> int:
        return len(self._map)

    @property
    def used(self) -> int:
        return self._used

    def get(self, key, count: bool = True):
        """``count=False`` skips hit/miss accounting — for a fronting
        tier that counts once after consulting every layer."""
        with self._lock:
            item = self._map.get(key)
            if item is None:
                if count:
                    self.counters.miss()
                return None
            self._map.move_to_end(key)
            if count:
                self.counters.hit(item[1])
            return item[0]

    def peek_contains(self, key) -> bool:
        """Membership check with no counter/recency side effects."""
        with self._lock:
            return key in self._map

    def put(self, key, value, size: int | None = None,
            guard=None) -> None:
        """``guard`` (if given) is evaluated UNDER the cache lock and
        the insert is skipped when it returns False — callers use it to
        make a freshness check atomic with the insert (a check done
        outside the lock could pass, then an invalidation could run to
        completion before the insert re-pins the stale value)."""
        if size is None:
            size = len(value)
        if size > self.budget:
            return
        with self._lock:
            if guard is not None and not guard():
                return
            old = self._map.pop(key, None)
            if old is not None:
                self._used -= old[1]
            evicted = 0
            while self._used + size > self.budget and self._map:
                _, (_, esz) = self._map.popitem(last=False)
                self._used -= esz
                evicted += 1
            self._map[key] = (value, size)
            self._used += size
            if evicted:
                self.counters.evicted(evicted)
            self.counters.set_used(self._used)

    def delete(self, key) -> None:
        with self._lock:
            item = self._map.pop(key, None)
            if item is not None:
                self._used -= item[1]
                self.counters.set_used(self._used)

    def drop_where(self, pred) -> int:
        """Delete every entry whose key matches ``pred`` (vacuum /
        volume-unmount invalidation)."""
        with self._lock:
            dead = [k for k in self._map if pred(k)]
            for k in dead:
                self._used -= self._map.pop(k)[1]
            if dead:
                self.counters.set_used(self._used)
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._used = 0
            self.counters.set_used(0)


class DiskCacheLayer:
    """One size class of the disk tier: a ring of fixed-size slots in a
    single preallocated file, accessed through mmap.

    Mirrors the reference's on-disk cache volumes
    (chunk_cache_on_disk.go): inserting wraps around the ring, evicting
    whatever previously occupied the slot; lookups are an offset table
    plus one mmap slice. The file is a *cache* — it is recreated empty
    on every start and never fsynced.
    """

    def __init__(self, path: str, slot_size: int, slots: int):
        self.slot_size = slot_size
        self.slots = max(1, slots)
        self.path = path
        size = self.slot_size * self.slots
        with open(path, "wb") as f:
            f.truncate(size)
        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), size)
        self._index: dict[object, tuple[int, int]] = {}  # key -> (slot, len)
        self._owner: list[object | None] = [None] * self.slots
        self._cursor = 0

    def get(self, key) -> bytes | None:
        loc = self._index.get(key)
        if loc is None:
            return None
        slot, length = loc
        off = slot * self.slot_size
        return self._mm[off:off + length]

    def put(self, key, data: bytes) -> bool:
        if len(data) > self.slot_size:
            return False
        slot = self._cursor
        self._cursor = (self._cursor + 1) % self.slots
        old = self._owner[slot]
        if old is not None:
            self._index.pop(old, None)
        prev = self._index.pop(key, None)
        if prev is not None:
            self._owner[prev[0]] = None
        off = slot * self.slot_size
        self._mm[off:off + len(data)] = data
        self._owner[slot] = key
        self._index[key] = (slot, len(data))
        return old is not None

    def delete(self, key) -> None:
        loc = self._index.pop(key, None)
        if loc is not None:
            self._owner[loc[0]] = None

    @property
    def used(self) -> int:
        return sum(length for _, length in self._index.values())

    def close(self) -> None:
        self._mm.close()
        self._f.close()
        try:
            os.remove(self.path)
        except OSError:
            pass


# disk tier size classes (slot byte sizes); an item routes to the
# smallest class whose slot holds it — same ladder shape as the
# reference's 1MB/4MB on-disk layers, extended down to 256KB so the
# memory tier stays reserved for truly small chunks
DISK_SLOT_SIZES = (256 << 10, 1 << 20, 4 << 20)


class TieredChunkCache:
    """Whole-chunk cache keyed by file id: memory LRU for small chunks,
    size-classed disk tier for larger ones (weed/util/chunk_cache).

    Entries are immutable chunk bodies; ``delete`` exists for the rare
    same-fid overwrite/delete paths (read-your-writes through one
    client), mirroring the reference's assumption that chunk fids are
    content-stable.
    """

    def __init__(self, mem_bytes: int, disk_dir: str | None = None,
                 disk_bytes: int = 256 << 20,
                 mem_item_max: int | None = None,
                 name: str = "chunk"):
        self.counters = CacheCounters(name)
        if mem_item_max is None:
            # with a disk tier, memory stays reserved for small chunks
            # and the size classes catch the rest (reference layering);
            # memory-only must take larger chunks itself or a plain
            # object re-read caches nothing
            mem_item_max = (256 << 10) if disk_dir else (4 << 20)
        self.mem_item_max = min(mem_item_max, max(1, mem_bytes))
        # PER-FID mutation generations (a single global counter would
        # let every unrelated upload in flight suppress every fill —
        # near-zero hit rate under mixed load): fetchers snapshot
        # fill_token(fid) before the network read and set_if refuses
        # when it moved. The dict is bounded by an epoch sweep: clearing
        # it bumps the epoch, which conservatively invalidates every
        # outstanding token (a refused fill is always safe).
        self._gens: dict[str, int] = {}
        self._epoch = 0
        self._mem = LruByteCache(mem_bytes, counters=self.counters)
        self._lock = threading.Lock()
        self._disk: list[DiskCacheLayer] = []
        self._lock_f = None
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            # exclusive per-directory flock: a second daemon pointed at
            # the same -cache.dir would truncate files this process has
            # mmapped and every hit would silently serve zeros — fail
            # loudly at startup instead. flock on a held-open fd is
            # kernel-accurate liveness: released on any process death,
            # immune to recycled pids and torn lockfiles.
            import fcntl
            self._lock_f = open(os.path.join(disk_dir, ".cache_lock"),
                                "a+")
            try:
                fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self._lock_f.close()
                self._lock_f = None
                raise RuntimeError(
                    f"cache dir {disk_dir!r} already in use by another "
                    f"process; every daemon needs its own -cache.dir")
            per_class = max(disk_bytes // len(DISK_SLOT_SIZES),
                            max(DISK_SLOT_SIZES))
            for slot in DISK_SLOT_SIZES:
                self._disk.append(DiskCacheLayer(
                    os.path.join(disk_dir, f"cache_{slot}.dat"),
                    slot, per_class // slot))

    @property
    def has_disk(self) -> bool:
        """True when gets/sets may touch the mmap tier — callers on an
        event loop should then run them in an executor (a cold-page
        slice blocks on major page faults for up to a slot size)."""
        return bool(self._disk)

    @property
    def max_item_size(self) -> int:
        return self._disk[-1].slot_size if self._disk else self.mem_item_max

    def get(self, fid: str) -> bytes | None:
        data = self._mem.get(fid, count=False)
        if data is not None:
            self.counters.hit(len(data))
            return data
        if self._disk:
            with self._lock:
                for layer in self._disk:
                    data = layer.get(fid)
                    if data is not None:
                        self.counters.hit(len(data))
                        return data
        self.counters.miss()
        return None

    def set(self, fid: str, data: bytes) -> None:
        if len(data) <= self.mem_item_max:
            self._mem.put(fid, data)
            if self._disk:
                # the inner LRU published its memory-only total to the
                # shared used-bytes gauge; re-publish mem+disk so the
                # gauge never flaps by the disk tier's size
                with self._lock:
                    self._set_used_locked()
            return
        with self._lock:
            for layer in self._disk:
                if len(data) <= layer.slot_size:
                    if layer.put(fid, data):
                        self.counters.evicted()
                    self._set_used_locked()
                    return
        # larger than every class: not cacheable

    def fill_token(self, fid: str) -> tuple[int, int]:
        """Snapshot taken BEFORE a fetch; set_if refuses the fill when
        the fid was invalidated (or the gen table swept) in between."""
        return (self._epoch, self._gens.get(fid, 0))

    def set_if(self, fid: str, data: bytes,
               token: tuple[int, int]) -> bool:
        if token != (self._epoch, self._gens.get(fid, 0)):
            return False        # an overwrite/delete raced this fetch
        self.set(fid, data)
        return True

    def delete(self, fid: str) -> None:
        self._gens[fid] = self._gens.get(fid, 0) + 1
        if len(self._gens) > 4096:
            # bounded: the sweep moves the epoch so every outstanding
            # token — including ones whose per-fid counter we just
            # forgot — fails its set_if check
            self._gens.clear()
            self._epoch += 1
        self._mem.delete(fid)
        if self._disk:
            with self._lock:
                for layer in self._disk:
                    layer.delete(fid)
                self._set_used_locked()

    def _set_used_locked(self) -> None:
        self.counters.set_used(
            self._mem.used + sum(layer.used for layer in self._disk))

    def contains(self, fid: str) -> bool:
        """Residency peek with no counter or recency side effects."""
        if self._mem.peek_contains(fid):
            return True
        if self._disk:
            with self._lock:
                return any(fid in layer._index for layer in self._disk)
        return False

    def close(self) -> None:
        self._mem.clear()
        for layer in self._disk:
            layer.close()
        self._disk = []
        if self._lock_f is not None:
            # closing the fd releases the flock; the lockfile itself
            # stays (removing it would let two successors each lock a
            # different inode of the same path)
            self._lock_f.close()
            self._lock_f = None

    def to_dict(self) -> dict:
        return self.counters.to_dict()


class EcRecoverCache(LruByteCache):
    """LruByteCache with per-volume generations for keys shaped
    ``(vid, ...)``: drop_volume bumps the gen so a reconstruction fill
    racing an EC re-encode/remount is refused — the same fencing
    NeedleCache and TieredChunkCache use for their fill races."""

    def __init__(self, budget: int, name: str = "ec_recover"):
        super().__init__(budget, name=name)
        self._vid_gen: dict[int, int] = {}

    def generation(self, vid: int) -> int:
        return self._vid_gen.get(vid, 0)

    def put_fenced(self, key, value, gen: int) -> None:
        self.put(key, value,
                 guard=lambda: gen == self._vid_gen.get(key[0], 0))

    def drop_volume(self, vid: int) -> int:
        self._vid_gen[vid] = self._vid_gen.get(vid, 0) + 1
        return self.drop_where(lambda k: k[0] == vid)


# bookkeeping overhead charged per cached needle beyond its data bytes
# (parsed-object fields, dict slot) so the byte budget stays honest for
# many tiny needles
_NEEDLE_OVERHEAD = 256


class NeedleCache:
    """Hot-needle cache for the volume data plane: parsed ``Needle``
    objects keyed ``(vid, nid)`` under one byte budget.

    Serving a hit skips the disk pread, the record parse AND the CRC
    re-check — and, through ``Store.cached_needle``, the executor
    round-trip the read handlers otherwise pay. Strict invalidation
    (write/delete per needle, volume-wide on vacuum/unmount/tail-apply)
    keeps read-your-writes exact; the cookie stored in the needle is
    re-checked by the caller on every hit.
    """

    def __init__(self, budget: int, item_max: int | None = None,
                 name: str = "needle"):
        self.counters = CacheCounters(name)
        self._lru = LruByteCache(budget, counters=self.counters)
        self.item_max = item_max if item_max is not None \
            else max(64 << 10, budget // 64)
        # per-volume mutation generation: a fill racing an invalidation
        # must lose. Readers snapshot generation(vid) BEFORE the disk
        # read and put() refuses when it moved — otherwise a reader
        # that fetched old bytes could re-populate the cache AFTER the
        # writer's invalidate, leaving the stale entry pinned until the
        # next write. (GIL-atomic dict ops suffice: a lost concurrent
        # increment still leaves the value changed from any snapshot
        # taken before either bump; it can never move backwards.)
        self._gen: dict[int, int] = {}

    def peek(self, vid: int, nid: int):
        """Raw entry with NO counter updates — the caller validates
        cookie/expiry first and then reports hit()/miss(), so a
        present-but-unservable entry (wrong cookie, expired TTL) is
        never inflated into a hit."""
        return self._lru.get((vid, nid), count=False)

    def hit(self, needle) -> None:
        self.counters.hit(len(needle.data))

    def miss(self) -> None:
        self.counters.miss()

    def generation(self, vid: int) -> int:
        return self._gen.get(vid, 0)

    def put(self, vid: int, nid: int, needle,
            gen: int | None = None) -> None:
        size = len(needle.data) + _NEEDLE_OVERHEAD
        if size - _NEEDLE_OVERHEAD > self.item_max:
            return
        # the gen comparison runs UNDER the LRU lock, atomic with the
        # insert: checked outside, an invalidate() in another executor
        # thread could bump-and-delete entirely between the check and
        # the insert and the stale fill would land anyway. (If the bump
        # happens while we hold the lock, the invalidator's delete is
        # queued on the same lock and removes our entry right after.)
        guard = (None if gen is None
                 else lambda: gen == self._gen.get(vid, 0))
        self._lru.put((vid, nid), needle, size, guard=guard)

    def invalidate(self, vid: int, nid: int) -> None:
        self._gen[vid] = self._gen.get(vid, 0) + 1
        self._lru.delete((vid, nid))

    def drop_volume(self, vid: int) -> int:
        self._gen[vid] = self._gen.get(vid, 0) + 1
        return self._lru.drop_where(lambda k: k[0] == vid)

    def clear(self) -> None:
        self._lru.clear()

    def to_dict(self) -> dict:
        return self.counters.to_dict()
