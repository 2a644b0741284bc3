"""Native compact needle map vs the dict-based oracle.

Mirrors the reference's compact_map_test.go (correctness incl. overwrite
and tombstone replay) and a scaled-down compact_map_perf_test.go
(bulk-insert throughput + lookups over a million keys).

The cases of tests/test_native_needle_map.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import random
import time

import pytest

from seaweedfs_tpu_torch.native import needle_map as native_nm
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle_map import (CompactNeedleMap,
                                              MemoryNeedleMap,
                                              best_needle_map)

pytestmark = pytest.mark.skipif(
    not native_nm.available(), reason="native toolchain unavailable")


def test_native_map_basics():
    m = native_nm.NativeMap()
    try:
        assert m.get(1) is None
        assert m.set(1, 100, 10) is None
        assert m.set(2, 200, 20) is None
        assert m.get(1) == (100, 10)
        old = m.set(1, 300, 30)  # overwrite returns previous
        assert old == (100, 10)
        assert m.get(1) == (300, 30)
        assert len(m) == 2
        assert sorted(m.items()) == [(1, 300, 30), (2, 200, 20)]
    finally:
        m.close()


def test_native_map_survives_growth_and_random_ops():
    m = native_nm.NativeMap()
    oracle: dict[int, tuple[int, int]] = {}
    rng = random.Random(7)
    try:
        for _ in range(50_000):
            k = rng.randrange(1, 20_000)
            v = (rng.randrange(2**32), rng.randrange(2**32))
            m.set(k, *v)
            oracle[k] = v
        assert len(m) == len(oracle)
        for k, v in oracle.items():
            assert m.get(k) == v
        assert m.get(999_999_999) is None
    finally:
        m.close()


def test_compact_needle_map_matches_dict_map(tmp_path):
    """Same .idx replay (puts, overwrites, tombstones) must produce
    identical state through both map kinds."""
    ops = []
    rng = random.Random(3)
    for i in range(1, 500):
        ops.append(("put", i, i * 8, 100 + i))
    for i in range(1, 500, 7):
        ops.append(("del", i, 50_000 + i))
    for i in range(1, 500, 13):
        ops.append(("put", i, 100_000 + i * 8, 300))

    def replay(map_cls, path):
        nm = map_cls(path)
        for op in ops:
            if op[0] == "put":
                nm.put(op[1], op[2], op[3])
            else:
                nm.delete(op[1], op[2])
        return nm

    a = replay(MemoryNeedleMap, str(tmp_path / "a.idx"))
    b = replay(CompactNeedleMap, str(tmp_path / "b.idx"))
    try:
        assert len(a) == len(b)
        assert a.file_count == b.file_count
        assert a.deleted_count == b.deleted_count
        assert a.deleted_bytes == b.deleted_bytes
        assert a.max_file_key == b.max_file_key
        for k in range(1, 500):
            va, vb = a.get(k), b.get(k)
            assert (va is None) == (vb is None), k
            if va is not None:
                assert (va.offset, va.size) == (vb.offset, vb.size), k
        # reload from the .idx files written by each
        a2 = MemoryNeedleMap(str(tmp_path / "b.idx"))  # cross-read
        for k in range(1, 500):
            va, vb = a2.get(k), b.get(k)
            assert (va is None) == (vb is None), k
    finally:
        a.close()
        b.close()


def test_native_map_bulk_million():
    """Scaled compact_map_perf_test: 1M ascending keys, then lookups."""
    m = native_nm.NativeMap()
    try:
        n = 1_000_000
        t0 = time.perf_counter()
        for k in range(1, n + 1):
            m.set(k, k & 0xFFFFFFFF, 128)
        insert_s = time.perf_counter() - t0
        assert len(m) == n
        t0 = time.perf_counter()
        for k in range(1, n + 1, 97):
            assert m.get(k) is not None
        lookup_s = time.perf_counter() - t0
        # loose sanity bound: a million ctypes inserts should be seconds,
        # not minutes (the C side itself is ~10ns/op)
        assert insert_s < 30 and lookup_s < 5, (insert_s, lookup_s)
    finally:
        m.close()


def test_offsets_past_4gib_survive(tmp_path):
    """Raw byte offsets past 4 GiB must round-trip (stored /8 like .idx;
    a raw uint32 store would wrap silently)."""
    nm = CompactNeedleMap(str(tmp_path / "big.idx"))
    try:
        big = (1 << 32) + 8 * 123  # > 4 GiB, 8-byte aligned
        nm.put(42, big, 512)
        got = nm.get(42)
        assert got is not None and got.offset == big and got.size == 512
        # tombstone with offset at the high end too
        nm.delete(42, big + 1024)
        assert nm.get(42).size == t.TOMBSTONE_FILE_SIZE
    finally:
        nm.close()


def test_best_needle_map_selects_native(tmp_path):
    nm = best_needle_map(str(tmp_path / "x.idx"))
    assert isinstance(nm, CompactNeedleMap)
    nm.put(5, 80, 64)
    assert nm.get(5).offset == 80
    nm.close()
