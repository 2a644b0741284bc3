"""The port's tiered read caches (seaweedfs_tpu_torch/util/chunk_cache.py,
singleflight.py, aio.py) and their wiring into the port's Store and
EcVolume: the cases of tests/test_chunk_cache.py pointed at the port.

The cases there that drive util/client.py's WeedClient or the filer's
stream_chunk_views wait for those modules' port (ROADMAP M10). The
vacuum case runs on the port's storage/vacuum.py, beside a case of the
volume-wide cache drop it relies on.
"""

import asyncio
import os
import random

import pytest

from seaweedfs_tpu_torch.util.chunk_cache import (DISK_SLOT_SIZES,
                                                  LruByteCache, NeedleCache,
                                                  TieredChunkCache)
from seaweedfs_tpu_torch.util.singleflight import SingleFlight


def test_lru_evicts_at_byte_budget():
    c = LruByteCache(1000)
    for i in range(5):
        c.put(i, bytes(300))           # 1500B total: oldest two must go
    assert c.used <= 1000
    assert c.get(0) is None and c.get(1) is None
    assert c.get(4) == bytes(300)
    assert c.counters.evictions == 2


def test_lru_recency_and_overwrite():
    c = LruByteCache(600)
    c.put("a", b"x" * 200)
    c.put("b", b"y" * 200)
    assert c.get("a") is not None      # refresh "a": "b" becomes LRU
    c.put("c", b"z" * 300)             # overflow evicts "b"
    assert c.get("b") is None
    assert c.get("a") is not None
    c.put("a", b"w" * 100)             # overwrite re-accounts bytes
    assert c.used == 100 + 300


def test_lru_item_larger_than_budget_not_cached():
    c = LruByteCache(100)
    c.put("big", bytes(500))
    assert c.get("big") is None
    assert c.used == 0


def test_small_items_stay_in_memory(tmp_path):
    t = TieredChunkCache(1 << 20, disk_dir=str(tmp_path),
                         mem_item_max=1024)
    t.set("s", b"a" * 100)
    assert t.get("s") == b"a" * 100
    assert t._mem.used == 100          # memory tier holds it
    assert all(layer.used == 0 for layer in t._disk)
    t.close()


def test_large_items_route_to_disk_size_class(tmp_path):
    t = TieredChunkCache(1 << 20, disk_dir=str(tmp_path),
                         mem_item_max=1024)
    rng = random.Random(3)
    small_blob = rng.randbytes(100 << 10)     # > mem_item_max, class 0
    mid_blob = rng.randbytes(600 << 10)       # class 1 (1MB slots)
    t.set("small", small_blob)
    t.set("mid", mid_blob)
    assert t.get("small") == small_blob
    assert t.get("mid") == mid_blob
    assert t._mem.used == 0
    assert t._disk[0].used == len(small_blob)
    assert t._disk[1].used == len(mid_blob)
    # backing files exist, one per size class
    for slot in DISK_SLOT_SIZES:
        assert os.path.exists(str(tmp_path / f"cache_{slot}.dat"))
    # beyond the largest class: silently uncacheable
    t.set("huge", bytes((4 << 20) + 1))
    assert t.get("huge") is None
    t.delete("mid")
    assert t.get("mid") is None
    t.close()


def test_disk_ring_evicts_oldest(tmp_path):
    from seaweedfs_tpu_torch.util.chunk_cache import DiskCacheLayer
    layer = DiskCacheLayer(str(tmp_path / "ring.dat"), 1024, 2)
    layer.put("a", b"A" * 1000)
    layer.put("b", b"B" * 1000)
    layer.put("c", b"C" * 1000)        # ring wraps: "a" evicted
    assert layer.get("a") is None
    assert layer.get("b") == b"B" * 1000
    assert layer.get("c") == b"C" * 1000
    layer.close()


def test_mem_only_without_disk_dir():
    t = TieredChunkCache(1 << 20, mem_item_max=1024)
    assert t.max_item_size == 1024
    t.set("big", bytes(2048))          # over mem_item_max, no disk tier
    assert t.get("big") is None
    t.close()


def test_singleflight_collapses_concurrent_callers():
    sf = SingleFlight()
    calls = 0

    async def fn():
        nonlocal calls
        calls += 1
        await asyncio.sleep(0.02)
        return "payload"

    async def main():
        return await asyncio.gather(*(sf.do("k", fn) for _ in range(16)))

    results = asyncio.run(main())
    assert results == ["payload"] * 16
    assert calls == 1
    assert sf.collapsed == 15 and sf.calls == 1


def test_singleflight_propagates_errors_then_retries():
    sf = SingleFlight()
    calls = 0

    async def fn():
        nonlocal calls
        calls += 1
        await asyncio.sleep(0.01)
        if calls == 1:
            raise ValueError("boom")
        return 7

    async def main():
        round1 = await asyncio.gather(
            *(sf.do("k", fn) for _ in range(4)), return_exceptions=True)
        assert all(isinstance(r, ValueError) for r in round1)
        assert calls == 1              # the failure was shared, not retried
        assert await sf.do("k", fn) == 7   # next round runs fresh

    asyncio.run(main())


@pytest.fixture
def cached_store(tmp_path):
    from seaweedfs_tpu_torch.storage.store import Store
    s = Store([str(tmp_path / "v")], needle_cache_bytes=1 << 20)
    s.add_volume(1)
    yield s
    s.close()


def _needle(nid: int, data: bytes):
    from seaweedfs_tpu_torch.storage.needle import Needle
    return Needle(cookie=nid ^ 0x5A, id=nid, data=data)


def test_needle_cache_hit_and_cookie_check(cached_store):
    s = cached_store
    s.write_needle(1, _needle(7, b"hot bytes"))
    assert s.read_needle(1, 7, 7 ^ 0x5A).data == b"hot bytes"
    hits0 = s.needle_cache.counters.hits
    assert s.read_needle(1, 7, 7 ^ 0x5A).data == b"hot bytes"
    assert s.needle_cache.counters.hits == hits0 + 1
    # event-loop peek: hit without touching disk
    assert s.cached_needle(1, 7, 7 ^ 0x5A).data == b"hot bytes"
    # wrong cookie never served from cache
    assert s.cached_needle(1, 7, 0xBAD) is None


def test_needle_cache_invalidated_on_overwrite_and_delete(cached_store):
    from seaweedfs_tpu_torch.storage.volume import AlreadyDeleted
    s = cached_store
    s.write_needle(1, _needle(7, b"v1"))
    assert s.read_needle(1, 7).data == b"v1"       # populates
    s.write_needle(1, _needle(7, b"v2 new bytes"))
    assert s.read_needle(1, 7).data == b"v2 new bytes"  # never v1
    s.delete_needle(1, _needle(7, b""))
    with pytest.raises(AlreadyDeleted):
        s.read_needle(1, 7)
    assert s.cached_needle(1, 7) is None


def test_needle_cache_misses_after_volume_drop(cached_store):
    """What commit_compaction does once the vacuum swap is in: the
    volume-wide drop removes every cached entry, and the next read is a
    counted miss that returns the bytes on disk."""
    s = cached_store
    for i in range(1, 11):
        s.write_needle(1, _needle(i, b"data-%d" % i * 20))
    survivor = s.read_needle(1, 8)                 # cached now
    assert s.needle_cache._lru.peek_contains((1, 8))
    s.drop_cached_volume(1)
    assert not s.needle_cache._lru.peek_contains((1, 8))
    misses0 = s.needle_cache.counters.misses
    again = s.read_needle(1, 8)
    assert s.needle_cache.counters.misses == misses0 + 1
    assert again.data == survivor.data


def test_commit_compaction_needs_the_vacuum_port(cached_store):
    """The vacuum case of tests/test_chunk_cache.py, now that
    storage/vacuum.py is ported: Store.commit_compaction swaps in the
    port's compacted volume, every cached entry of it is gone (the swap
    moved every offset), and the next read is a counted miss that
    returns the survivor's bytes."""
    from seaweedfs_tpu_torch.storage import vacuum
    s = cached_store
    for i in range(1, 11):
        s.write_needle(1, _needle(i, b"data-%d" % i * 20))
    for i in range(1, 6):
        s.delete_needle(1, _needle(i, b""))
    survivor = s.read_needle(1, 8)                 # cached now
    assert s.needle_cache._lru.peek_contains((1, 8))
    vacuum.compact(s.volumes[1])
    s.commit_compaction(1)
    assert s.volumes[1].super_block.compaction_revision == 1
    assert not s.needle_cache._lru.peek_contains((1, 8))
    misses0 = s.needle_cache.counters.misses
    again = s.read_needle(1, 8)
    assert s.needle_cache.counters.misses == misses0 + 1
    assert again.data == survivor.data


def test_cached_needle_declines_when_read_failpoint_armed(cached_store):
    from seaweedfs_tpu_torch.util import failpoints
    s = cached_store
    s.write_needle(1, _needle(3, b"x"))
    s.read_needle(1, 3)
    assert s.cached_needle(1, 3) is not None
    failpoints.arm("store.read", "error:1")
    try:
        # armed chaos site: the peek must decline so the injected
        # fault actually fires on the slow path
        assert s.cached_needle(1, 3) is None
        with pytest.raises(failpoints.FailpointError):
            s.read_needle(1, 3)
    finally:
        failpoints.reset()


def test_ec_recover_cache_reuses_reconstruction(tmp_path, monkeypatch):
    from seaweedfs_tpu_torch.ec import ec_volume as ecv
    from seaweedfs_tpu_torch.ec import pipeline as pl
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    d = str(tmp_path)
    v = Volume(d, "", 5)
    rng = random.Random(11)
    contents = {}
    for i in range(1, 30):
        data = rng.randbytes(rng.randint(100, 3000))
        v.write_needle(Needle(cookie=i ^ 0x5A, id=i, data=data))
        contents[i] = data
    v.close()
    base = os.path.join(d, "5")
    enc = pl.get_encoder("cpu")
    pl.write_ec_files(base, encoder=enc, large_block=16 * 1024,
                      small_block=1024, buffer_size=1024)
    pl.write_sorted_file_from_idx(base)

    decodes = 0
    real = ecv._transform_buffers_async

    def counting(*a, **kw):
        nonlocal decodes
        decodes += 1
        return real(*a, **kw)

    monkeypatch.setattr(ecv, "_transform_buffers_async", counting)
    cache = LruByteCache(8 << 20, name="ec_recover_test")
    ev = ecv.EcVolume(d, "", 5, large_block=16 * 1024, small_block=1024,
                      encoder=enc, recover_cache=cache)
    ev.shards.pop(0).close()            # lose a data shard
    nid = next(iter(contents))
    first = ev.read_needle(nid)
    assert first.data == contents[nid]
    assert decodes > 0
    after_first = decodes
    second = ev.read_needle(nid)        # hot interval: decoder NOT re-run
    assert second.data == contents[nid]
    assert decodes == after_first
    assert cache.counters.hits > 0
    ev.close()


def test_needle_cache_refuses_fill_racing_a_write(cached_store):
    """A reader that fetched old bytes from disk must NOT re-populate
    the cache after a writer's invalidation (generation fencing)."""
    s = cached_store
    s.write_needle(1, _needle(9, b"old bytes"))
    nc = s.needle_cache
    gen = nc.generation(1)                 # reader snapshots...
    old = s.volumes[1].read_needle(9)      # ...and reads from disk
    s.write_needle(1, _needle(9, b"new bytes!"))   # racing write lands
    nc.put(1, 9, old, gen=gen)             # stale fill must be refused
    hit = s.cached_needle(1, 9)
    assert hit is None or hit.data == b"new bytes!"
    assert s.read_needle(1, 9).data == b"new bytes!"


def test_singleflight_leader_cancel_spares_followers():
    sf = SingleFlight()

    async def fn():
        await asyncio.sleep(0.05)
        return "shared"

    async def main():
        leader = asyncio.create_task(sf.do("k", fn))
        await asyncio.sleep(0.01)
        follower = asyncio.create_task(sf.do("k", fn))
        await asyncio.sleep(0.01)
        leader.cancel()                    # e.g. its client disconnected
        assert await follower == "shared"  # the round still completes

    asyncio.run(main())


def test_ec_recover_cache_dropped_on_ec_unmount(tmp_path):
    from seaweedfs_tpu_torch.storage.store import Store
    s = Store([str(tmp_path / "v")], needle_cache_bytes=1 << 20)
    s.ec_recover_cache.put((5, 0, 0, 10), b"x" * 10, 10)
    s.ec_recover_cache.put((6, 0, 0, 10), b"y" * 10, 10)
    s.unmount_ec_shards(5)
    assert s.ec_recover_cache.get((5, 0, 0, 10)) is None
    assert s.ec_recover_cache.get((6, 0, 0, 10)) == b"y" * 10
    s.close()


def test_needle_cache_guard_atomic_with_insert(cached_store):
    """The gen check runs under the LRU lock: a bump-and-delete that
    completes entirely between an outside check and the insert cannot
    happen, and a bump landing after the guarded insert still removes
    the entry via the invalidator's queued delete."""
    s = cached_store
    nc = s.needle_cache
    s.write_needle(1, _needle(4, b"old"))
    gen = nc.generation(1)
    old = s.volumes[1].read_needle(4)
    nc.invalidate(1, 4)                 # racing write's bump+delete
    nc.put(1, 4, old, gen=gen)
    assert not nc._lru.peek_contains((1, 4))


def test_cache_dir_exclusive_lock(tmp_path):
    a = TieredChunkCache(1 << 20, disk_dir=str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="already in use"):
        TieredChunkCache(1 << 20, disk_dir=str(tmp_path / "d"))
    a.close()
    # released on close; a stale lock from a dead pid is also taken over
    b = TieredChunkCache(1 << 20, disk_dir=str(tmp_path / "d"))
    b.close()


def test_fill_tokens_are_per_fid():
    """An unrelated fid's invalidation must NOT suppress this fid's
    fill (a global counter would zero the hit rate under mixed
    write/read load), while the same fid's invalidation must."""
    cc = TieredChunkCache(1 << 20)
    tok = cc.fill_token("a,1")
    cc.delete("b,2")                    # unrelated write traffic
    assert cc.set_if("a,1", b"mine", tok)
    assert cc.get("a,1") == b"mine"
    tok2 = cc.fill_token("a,1")
    cc.delete("a,1")                    # same-fid overwrite
    assert not cc.set_if("a,1", b"stale", tok2)
    assert cc.get("a,1") is None


def test_fill_token_epoch_sweep_is_conservative():
    cc = TieredChunkCache(1 << 20)
    tok = cc.fill_token("x")
    cc.delete("x")
    for i in range(5000):               # overflow the gen table
        cc.delete(f"fid-{i}")
    # the sweep forgot x's counter, but the epoch moved: still refused
    assert not cc.set_if("x", b"stale", tok)


def test_needle_cache_unservable_entry_not_a_hit(cached_store):
    s = cached_store
    s.write_needle(1, _needle(6, b"x"))
    s.read_needle(1, 6)                 # populate
    h0, m0 = (s.needle_cache.counters.hits, s.needle_cache.counters.misses)
    assert s.cached_needle(1, 6, 0xBAD) is None   # wrong cookie
    assert s.needle_cache.counters.hits == h0     # NOT a hit
    assert s.needle_cache.counters.misses == m0   # peek defers the miss


def test_ec_recover_fill_fenced_against_remount():
    from seaweedfs_tpu_torch.util.chunk_cache import EcRecoverCache
    rc = EcRecoverCache(1 << 20)
    gen = rc.generation(5)
    rc.drop_volume(5)           # re-encode/remount raced the gather
    rc.put_fenced((5, 0, 0, 4), b"old!", gen)
    assert rc.get((5, 0, 0, 4)) is None
    rc.put_fenced((5, 0, 0, 4), b"new!", rc.generation(5))
    assert rc.get((5, 0, 0, 4)) == b"new!"


def test_cache_mem_budget_is_total(tmp_path):
    """-cache.mem is the TOTAL volume-side budget: needle 3/4 + EC 1/4,
    never more than the flag."""
    from seaweedfs_tpu_torch.storage.store import Store
    s = Store([str(tmp_path / "v")], needle_cache_bytes=16 << 20)
    assert (s.needle_cache._lru.budget
            + s.ec_recover_cache.budget) == 16 << 20
    s.close()


def test_aio_detach_survives_caller_and_consumes_exception():
    """util.aio.detach is the one sanctioned detachment spelling: the
    handle is retained until the task settles, cancelling the caller
    does not cancel the work, and a terminal exception is consumed
    even when no awaiter ever looks at it."""
    from seaweedfs_tpu_torch.util import aio

    async def main():
        ran = []

        async def work():
            await asyncio.sleep(0.02)
            ran.append(True)
            return "done"

        async def caller():
            t = aio.detach(work())
            assert aio.detached_count() >= 1
            await asyncio.sleep(1)           # cancelled long before

        c = asyncio.create_task(caller())
        await asyncio.sleep(0.005)
        c.cancel()                           # caller dies...
        await asyncio.sleep(0.05)
        assert ran == [True]                 # ...the work does not
        assert aio.detached_count() == 0     # handle released on settle

        async def boom():
            raise ValueError("nobody awaits me")

        aio.detach(boom())
        await asyncio.sleep(0.01)            # settles; exception is
        assert aio.detached_count() == 0     # consumed, not logged

    asyncio.run(main())
