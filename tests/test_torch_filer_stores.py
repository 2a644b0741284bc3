"""FilerStore contract matrix over every live store implementation.

Reference test model: weed/filer2/leveldb/leveldb_store_test.go +
leveldb2/… run the same CRUD/listing assertions against throwaway store
dirs; here one parametrized matrix covers memory, sqlite, the embedded
log-structured leveldb-class store, its 8-way sharded variant, and the
abstract_sql (sqlite dialect) store. Driver-gated stores (redis, mysql,
postgres, etcd, cassandra) register only when their client libraries
import.

The cases of tests/test_filer_stores.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

import time

import pytest

from seaweedfs_tpu_torch.filer.entry import Attr, Entry, new_directory_entry
from seaweedfs_tpu_torch.filer.filechunks import FileChunk
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filerstore import available_stores, create_store

LIVE_STORES = ["memory", "sqlite", "leveldb", "leveldb2", "sql"]


def _mk(name, tmp_path):
    kwargs = {
        "memory": {},
        "sqlite": {"path": str(tmp_path / "s.db")},
        "leveldb": {"dir": str(tmp_path / "ldb")},
        "leveldb2": {"dir": str(tmp_path / "ldb2")},
        "sql": {"path": str(tmp_path / "sql.db")},
    }[name]
    return create_store(name, **kwargs)


def _file_entry(path, n=1):
    return Entry(path, Attr(mtime=time.time(), mode=0o660),
                 chunks=[FileChunk(f"1,{n:08x}", 0, 10 * n, n)])


def test_registry_lists_live_stores():
    avail = available_stores()
    for name in LIVE_STORES:
        assert name in avail, f"{name} not registered ({avail})"


def _run_contract(s):
    """The shared CRUD+listing+subtree contract every store must satisfy
    (leveldb_store_test.go pattern)."""
    try:
        # insert + find
        s.insert_entry(new_directory_entry("/d"))
        s.insert_entry(_file_entry("/d/b.txt", 1))
        s.insert_entry(_file_entry("/d/a.txt", 2))
        s.insert_entry(_file_entry("/d/c.txt", 3))
        got = s.find_entry("/d/a.txt")
        assert got is not None and got.chunks[0].file_id == "1,00000002"
        assert s.find_entry("/d/zzz") is None

        # update overwrites
        e = _file_entry("/d/a.txt", 9)
        s.update_entry(e)
        assert s.find_entry("/d/a.txt").chunks[0].file_id == "1,00000009"

        # sorted listing + pagination (start_file exclusive/inclusive)
        names = [x.name for x in s.list_directory_entries("/d", "", False, 10)]
        assert names == ["a.txt", "b.txt", "c.txt"]
        names = [x.name for x in s.list_directory_entries(
            "/d", "a.txt", False, 10)]
        assert names == ["b.txt", "c.txt"]
        names = [x.name for x in s.list_directory_entries(
            "/d", "b.txt", True, 1)]
        assert names == ["b.txt"]

        # delete one
        s.delete_entry("/d/b.txt")
        assert s.find_entry("/d/b.txt") is None
        assert len(s.list_directory_entries("/d", "", False, 10)) == 2

        # delete_folder_children clears the subtree
        s.insert_entry(new_directory_entry("/d/sub"))
        s.insert_entry(_file_entry("/d/sub/x", 4))
        s.delete_folder_children("/d")
        assert s.list_directory_entries("/d", "", False, 10) == []
        assert s.find_entry("/d/sub/x") is None
    finally:
        s.close()


@pytest.mark.parametrize("store_name", LIVE_STORES)
def test_store_contract(store_name, tmp_path):
    _run_contract(_mk(store_name, tmp_path))


@pytest.mark.parametrize("store_name", ["leveldb", "leveldb2", "sql"])
def test_store_durability_across_reopen(store_name, tmp_path):
    s = _mk(store_name, tmp_path)
    s.insert_entry(new_directory_entry("/p"))
    for i in range(20):
        s.insert_entry(_file_entry(f"/p/f{i:02d}", i + 1))
    s.delete_entry("/p/f00")
    s.close()

    s2 = _mk(store_name, tmp_path)
    try:
        assert s2.find_entry("/p/f00") is None
        assert s2.find_entry("/p/f07").chunks[0].file_id == "1,00000008"
        assert len(s2.list_directory_entries("/p", "", False, 100)) == 19
    finally:
        s2.close()


def test_leveldb_wal_replay_without_compaction(tmp_path):
    """Kill-without-close: state must rebuild from the WAL alone."""
    s = _mk("leveldb", tmp_path)
    s.insert_entry(new_directory_entry("/w"))
    s.insert_entry(_file_entry("/w/a", 1))
    s.insert_entry(_file_entry("/w/b", 2))
    s.delete_entry("/w/a")
    s._log.flush()  # simulate crash: no close(), no snapshot

    s2 = _mk("leveldb", tmp_path)
    try:
        assert s2.find_entry("/w/a") is None
        assert s2.find_entry("/w/b") is not None
    finally:
        s2.close()


@pytest.mark.parametrize("store_name", ["leveldb2", "sql"])
def test_filer_over_store(store_name, tmp_path):
    """The Filer core drives the store through mkdir -p + recursive
    delete paths."""
    f = Filer(_mk(store_name, tmp_path))
    f.create_entry(_file_entry("/a/b/c/file.bin", 5))
    assert f.find_entry("/a/b/c").is_directory
    assert f.find_entry("/a/b/c/file.bin").chunks[0].size == 50
    f.delete_entry("/a", recursive=True)
    assert f.find_entry("/a/b/c/file.bin") is None
    assert f.drain_pending_chunk_deletes() == ["1,00000005"]
    f.close()


# ---------------------------------------------------------------------------
# Driver-gated stores through in-memory fake drivers: the SAME contract
# executes in CI without redis/etcd/cassandra/tikv servers. The fake
# modules are injected into sys.modules before the store module imports,
# so the real adapter code (key layout, CQL, scans) runs end-to-end.
# ---------------------------------------------------------------------------

import importlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402


class FakeRedis:
    def __init__(self, **_):
        self.kv = {}
        self.zsets = {}

    def set(self, k, v):
        self.kv[k] = v.encode() if isinstance(v, str) else v

    def get(self, k):
        return self.kv.get(k)

    def delete(self, *keys):
        for k in keys:
            self.kv.pop(k, None)
            self.zsets.pop(k, None)

    def zadd(self, key, mapping):
        self.zsets.setdefault(key, set()).update(mapping)

    def zrem(self, key, member):
        self.zsets.get(key, set()).discard(member)

    def zrange(self, key, lo, hi):
        names = sorted(self.zsets.get(key, set()))
        if hi == -1:
            hi = len(names) - 1
        return [n.encode() for n in names[lo:hi + 1]]

    def zrangebylex(self, key, lo, hi):
        names = sorted(self.zsets.get(key, set()))
        if lo != "-":
            start = lo[1:]  # "[name" inclusive
            names = [n for n in names if n >= start]
        return [n.encode() for n in names]

    def close(self):
        pass


class FakeEtcd3Client:
    def __init__(self, **_):
        self.kv = {}

    def put(self, k, v):
        self.kv[k] = v.encode() if isinstance(v, str) else v

    def get(self, k):
        return self.kv.get(k), None

    def delete(self, k):
        self.kv.pop(k, None)

    def delete_prefix(self, p):
        for k in [k for k in self.kv if k.startswith(p)]:
            del self.kv[k]

    def get_prefix(self, p, sort_order=None):
        for k in sorted(k for k in self.kv if k.startswith(p)):
            yield self.kv[k], None


class _CassRow:
    def __init__(self, meta):
        self.meta = meta


class _CassResult(list):
    def one(self):
        return self[0] if self else None


class FakeCassSession:
    """Understands exactly the CQL statements cassandra_store issues."""

    def __init__(self):
        self.table = {}  # (directory, name) -> meta

    def set_keyspace(self, ks):
        pass

    def execute(self, stmt, params=None):
        s = " ".join(stmt.split())
        if s.startswith("CREATE"):
            return _CassResult()
        if s.startswith("INSERT"):
            d, n, meta = params
            self.table[(d, n)] = meta
            return _CassResult()
        if s.startswith("DELETE"):
            self.table.pop(tuple(params), None)
            return _CassResult()
        if "name >" in s or "name >=" in s:
            cmp_inclusive = "name >=" in s
            limit = int(re.search(r"LIMIT (\d+)", s).group(1))
            d, start = params
            rows = sorted((n, m) for (dd, n), m in self.table.items()
                          if dd == d and (n >= start if cmp_inclusive
                                          else n > start))
            return _CassResult(_CassRow(m) for _, m in rows[:limit])
        if s.startswith("SELECT"):
            meta = self.table.get(tuple(params))
            return _CassResult([] if meta is None else [_CassRow(meta)])
        raise AssertionError(f"unexpected CQL: {s}")


class FakeCassCluster:
    def __init__(self, hosts):
        self._session = FakeCassSession()

    def connect(self):
        return self._session

    def shutdown(self):
        pass


class FakeTikvClient:
    def __init__(self):
        self.kv = {}

    def put(self, k, v):
        self.kv[bytes(k)] = bytes(v)

    def get(self, k):
        return self.kv.get(bytes(k))

    def delete(self, k):
        self.kv.pop(bytes(k), None)

    def delete_range(self, start, end):
        for k in [k for k in self.kv if start <= k < end]:
            del self.kv[k]

    def scan(self, start, end, limit):
        out = [(k, v) for k, v in sorted(self.kv.items())
               if start <= k < end]
        return out[:limit]


def _fake_module(name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def _import_with_fake(monkeypatch, driver_mods, store_mod):
    for name, mod in driver_mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    modname = f"seaweedfs_tpu_torch.filer.stores.{store_mod}"
    sys.modules.pop(modname, None)
    return importlib.import_module(modname)


def test_redis_store_contract_with_fake_driver(monkeypatch):
    mod = _import_with_fake(
        monkeypatch, {"redis": _fake_module("redis", Redis=FakeRedis)},
        "redis_store")
    _run_contract(mod.RedisStore())


def test_etcd_store_contract_with_fake_driver(monkeypatch):
    fake = FakeEtcd3Client()
    mod = _import_with_fake(
        monkeypatch,
        {"etcd3": _fake_module("etcd3", client=lambda **kw: fake)},
        "etcd_store")
    _run_contract(mod.EtcdStore())


def test_cassandra_store_contract_with_fake_driver(monkeypatch):
    cassandra = _fake_module("cassandra")
    cluster_mod = _fake_module("cassandra.cluster", Cluster=FakeCassCluster)
    cassandra.cluster = cluster_mod
    mod = _import_with_fake(
        monkeypatch,
        {"cassandra": cassandra, "cassandra.cluster": cluster_mod},
        "cassandra_store")
    _run_contract(mod.CassandraStore())


def test_tikv_store_contract_with_fake_driver(monkeypatch):
    fake = FakeTikvClient()
    tikv = _fake_module(
        "tikv_client",
        RawClient=types.SimpleNamespace(connect=lambda addr: fake))
    mod = _import_with_fake(monkeypatch, {"tikv_client": tikv},
                            "tikv_store")
    _run_contract(mod.TikvStore())


def test_tikv_store_with_injected_client():
    """tikv registers via _load_builtin once importable, and accepts an
    injected client (the fake-driver pattern the other adapters use)."""
    from seaweedfs_tpu_torch.filer.stores.tikv_store import TikvStore

    s = TikvStore(client=FakeTikvClient())
    s.insert_entry(new_directory_entry("/t"))
    s.insert_entry(_file_entry("/t/q", 1))
    assert s.find_entry("/t/q") is not None
    s.delete_folder_children("/t")
    assert s.find_entry("/t/q") is None
