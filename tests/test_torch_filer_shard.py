"""Sharded filer metadata plane: shard-map algebra, the
raft CAS apply, redirect hints, merged cross-shard pagination, the
journaled two-phase move's crash replay, limit clamps and the
singleflight listing fence.

The cases of tests/test_filer_shard.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

import asyncio
import contextlib
import json

import aiohttp
import pytest

from test_torch_cluster_util import run
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.shard import (ShardMap, apply_map_op, covers,
                                       merge_entry_lists)
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.util import failpoints


# -- pure map algebra --------------------------------------------------

def test_covers_is_boundary_aware():
    assert covers("/", "/anything")
    assert covers("/a", "/a")
    assert covers("/a", "/a/b/c")
    assert not covers("/a", "/ab")       # sibling, not child
    assert not covers("/a/b", "/a")


def test_route_longest_prefix_wins():
    m = ShardMap(rules=[["/", 0], ["/a", 1], ["/a/b", 2]],
                 owners={0: "h:0", 1: "h:1", 2: "h:2"})
    assert m.route("/a/b/c") == 2
    assert m.route("/a/x") == 1
    assert m.route("/ax") == 0           # /a must not cover /ax
    assert m.route("/z") == 0
    assert m.matched_prefix("/a/b/c") == "/a/b"
    assert m.shards_under("/a") == {2}   # rules STRICTLY below /a
    assert m.shards_under("/") == {1, 2}


def test_apply_map_op_split_lifecycle():
    m = ShardMap(rules=[["/", 0]], owners={0: "h:0", 1: "h:1"})
    m = apply_map_op(m, {"op": "split_intent", "prefix": "/hot",
                         "to": 1})
    mv = m.move_by_id("split:/hot")
    assert mv is not None and mv["state"] == "copy"
    assert m.route("/hot/x") == 0        # routing unchanged pre-flip
    # idempotent re-submit: a deposed leader's replayed proposal
    assert apply_map_op(m, {"op": "split_intent", "prefix": "/hot",
                            "to": 1}).moves == m.moves
    m = apply_map_op(m, {"op": "commit_move", "id": "split:/hot"})
    assert m.route("/hot/x") == 1        # the one-apply flip
    assert m.move_by_id("split:/hot")["state"] == "cleanup"
    with pytest.raises(ValueError):      # past the flip: no abort
        apply_map_op(m, {"op": "abort_move", "id": "split:/hot"})
    m = apply_map_op(m, {"op": "move_done", "id": "split:/hot"})
    assert m.moves == []
    assert m.route("/hot/x") == 1
    # move_done twice: idempotent completion, not an error
    assert apply_map_op(m, {"op": "move_done",
                            "id": "split:/hot"}).moves == []


def test_apply_map_op_rejects_invalid_transitions():
    m = ShardMap(rules=[["/", 0]], owners={0: "h:0", 1: "h:1"})
    with pytest.raises(ValueError):      # self-split
        apply_map_op(m, {"op": "split_intent", "prefix": "/x",
                         "to": 0})
    with pytest.raises(ValueError):      # the root rule is load-bearing
        apply_map_op(m, {"op": "set", "rules": [["/a", 1]]})
    with pytest.raises(ValueError):
        apply_map_op(m, {"op": "commit_move", "id": "split:/nope"})
    with pytest.raises(ValueError):
        apply_map_op(m, {"op": "frobnicate"})
    m = apply_map_op(m, {"op": "split_intent", "prefix": "/x",
                         "to": 1})
    with pytest.raises(ValueError):      # overlapping concurrent move
        apply_map_op(m, {"op": "rename_intent", "src": "/x/f",
                         "dst": "/y/f"})


# -- k-way merged pagination ------------------------------------------

def _e(path: str, mtime: float = 1.0) -> Entry:
    return Entry(full_path=path, attr=Attr(mtime=mtime))


def test_merge_exactly_once_in_order_across_boundary():
    s0 = [_e("/d/a"), _e("/d/m"), _e("/d/z")]
    s1 = [_e("/d/b"), _e("/d/sub")]
    got = merge_entry_lists([s0, s1], "", False, 10)
    assert [e.name for e in got] == ["a", "b", "m", "sub", "z"]
    # pagination: resume exclusive after 'b', limit 2
    got = merge_entry_lists([s0, s1], "b", False, 2)
    assert [e.name for e in got] == ["m", "sub"]
    # inclusive resume re-serves the boundary name exactly once
    got = merge_entry_lists([s0, s1], "m", True, 10)
    assert [e.name for e in got] == ["m", "sub", "z"]


def test_merge_dedups_preferring_route_owner():
    # dual-write window of an in-flight move: both shards hold /d/x —
    # the copy from the shard the map routes the path to must win
    m = ShardMap(rules=[["/", 0], ["/d/x", 1]],
                 owners={0: "h:0", 1: "h:1"})
    stale = _e("/d/x", mtime=1.0)      # left behind on shard 0
    fresh = _e("/d/x", mtime=9.0)      # the routed owner's copy
    got = merge_entry_lists([[stale], [fresh]], "", False, 10,
                            sources=[0, 1], prefer=m)
    assert len(got) == 1 and got[0].attr.mtime == 9.0
    # order independence: the routed-owner page wins either way
    got = merge_entry_lists([[fresh], [stale]], "", False, 10,
                            sources=[1, 0], prefer=m)
    assert len(got) == 1 and got[0].attr.mtime == 9.0


# -- raft-committed apply: the epoch CAS ------------------------------

def test_election_shard_map_cas(tmp_path):
    async def body():
        m = MasterServer(port=0, meta_dir=str(tmp_path))
        await m.start()
        try:
            el = m.election
            base = el.applied_shard_epoch
            # a deposed leader's proposal carries a stale base: no-op
            el._apply_shard_map({"base": base + 7, "map": {
                "rules": [["/", 0], ["/evil", 1]], "owners": {},
                "moves": []}})
            assert el.applied_shard_epoch == base
            assert m.shard_map is None or not any(
                p == "/evil" for p, _ in m.shard_map["rules"])
            # the current base applies, bumps the epoch, mirrors into
            # the server's adopt hook
            el._apply_shard_map({"base": base, "map": {
                "rules": [["/", 0], ["/good", 1]],
                "owners": {"1": "h:1"}, "moves": []}})
            assert el.applied_shard_epoch == base + 1
            assert ["/good", 1] in m.shard_map["rules"]
            assert m.shard_map["epoch"] == base + 1
        finally:
            await m.stop()
    run(body())


def test_master_shards_endpoint_cas_and_400(tmp_path):
    async def body():
        m = MasterServer(port=0, meta_dir=str(tmp_path))
        await m.start()
        try:
            async with aiohttp.ClientSession() as http:
                async def post(op, status=200):
                    async with http.post(
                            f"http://{m.url}/cluster/shards",
                            json=op) as r:
                        assert r.status == status, await r.text()
                        return await r.json()

                body1 = await post({"op": "register", "shard": 1,
                                    "url": "h:1"})
                e1 = body1["map"]["epoch"]
                await post({"op": "set", "rules": [["/a", 1]]},
                           status=400)       # no root rule
                await post({"op": "split_intent", "prefix": "/a",
                            "to": 0}, status=400)  # self-split
                body2 = await post({"op": "split_intent",
                                    "prefix": "/a", "to": 1})
                assert body2["map"]["moves"]
                # idempotent re-submit answers ok without a new move
                body3 = await post({"op": "split_intent",
                                    "prefix": "/a", "to": 1})
                assert len(body3["map"]["moves"]) == 1
                assert body3["map"]["epoch"] > e1
                async with http.get(
                        f"http://{m.url}/cluster/shards") as r:
                    got = await r.json()
                assert got["moves"] and "leader" in got
        finally:
            await m.stop()
    run(body())


# -- live sharded cluster ---------------------------------------------

class ShardCluster:
    """Master + N in-proc sharded FilerServers (memory store)."""

    def __init__(self, tmpdir: str, n: int = 2):
        self.tmpdir = tmpdir
        self.n = n
        self.master: MasterServer | None = None
        self.filers: list[FilerServer] = []
        self.http: aiohttp.ClientSession | None = None

    async def __aenter__(self) -> "ShardCluster":
        self.master = MasterServer(port=0, meta_dir=self.tmpdir)
        await self.master.start()
        for sid in range(self.n):
            f = FilerServer(Filer("memory"), self.master.url, port=0,
                            shard_id=sid, shard_of=self.n,
                            shard_split_mbps=64.0)
            await f.start()
            self.filers.append(f)
        self.http = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=20))
        for _ in range(200):
            async with self.http.get(
                    f"http://{self.master.url}/cluster/shards") as r:
                body = await r.json()
            if len(body.get("owners", {})) == self.n:
                return self
            await asyncio.sleep(0.05)
        raise AssertionError("shards never registered")

    async def __aexit__(self, *exc) -> None:
        if self.http:
            await self.http.close()
        for f in self.filers:
            with contextlib.suppress(Exception):
                await f.stop()
        with contextlib.suppress(Exception):
            await self.master.stop()

    async def set_rules(self, rules: list) -> None:
        async with self.http.post(
                f"http://{self.master.url}/cluster/shards",
                json={"op": "set", "rules": rules}) as r:
            assert r.status == 200, await r.text()
        await self.refresh()

    async def refresh(self) -> None:
        for f in self.filers:
            await f.shard.routes.refresh(f.shard._http, force=True)

    async def create(self, filer: FilerServer, path: str,
                     mtime: float = 1.0) -> int:
        async with self.http.post(
                f"http://{filer.url}/__api__/entry",
                json={"FullPath": path, "Mtime": mtime},
                allow_redirects=False) as r:
            return r.status

    async def wait_moves_drained(self, tries: int = 300) -> None:
        for _ in range(tries):
            for f in self.filers:
                f.shard._executor_wake.set()
            async with self.http.get(
                    f"http://{self.master.url}/cluster/shards") as r:
                body = await r.json()
            if not body.get("moves"):
                await self.refresh()
                return
            await asyncio.sleep(0.1)
        raise AssertionError(f"moves never drained: {body['moves']}")


def test_redirect_hints_and_routed_create(tmp_path):
    async def body():
        async with ShardCluster(str(tmp_path)) as c:
            await c.set_rules([["/", 0], ["/s1", 1]])
            f0, f1 = c.filers
            # foreign create answers 307 + the learnable hint trio
            async with c.http.post(
                    f"http://{f0.url}/__api__/entry",
                    json={"FullPath": "/s1/a", "Mtime": 5.0},
                    allow_redirects=False) as r:
                assert r.status == 307
                assert r.headers["X-Shard-Owner"] == f1.url
                assert r.headers["X-Shard-Prefix"] == "/s1"
                assert int(r.headers["X-Shard-Epoch"]) >= 1
            assert await c.create(f1, "/s1/a", 5.0) == 200
            # entry lives on shard 1 only
            assert f1.filer.find_entry("/s1/a") is not None
            assert f0.filer.find_entry("/s1/a") is None
            # a routed GET through the WRONG shard follows the hint
            async with c.http.get(
                    f"http://{f0.url}/__api__/lookup",
                    params={"path": "/s1/a"}) as r:
                assert r.status == 200
                assert (await r.json())["Mtime"] == 5.0
    run(body())


def test_merged_listing_exactly_once_across_boundary(tmp_path):
    async def body():
        async with ShardCluster(str(tmp_path)) as c:
            await c.set_rules([["/", 0], ["/d/sub", 1]])
            f0, f1 = c.filers
            for p in ("/d/a", "/d/m", "/d/z"):
                assert await c.create(f0, p) == 200
            assert await c.create(f1, "/d/sub/x") == 200
            # the /d/sub DIRECTORY row lives on shard 1; a listing of
            # /d through shard 0 must merge it in, exactly once, in
            # name order — paged at limit=1 across the shard boundary
            seen = []
            start = ""
            while True:
                async with c.http.get(
                        f"http://{f0.url}/__api__/list",
                        params={"path": "/d", "startFile": start,
                                "limit": "1"}) as r:
                    assert r.status == 200
                    page = (await r.json())["entries"]
                if not page:
                    break
                seen.extend(e["FullPath"] for e in page)
                start = page[-1]["FullPath"].rsplit("/", 1)[1]
            assert seen == ["/d/a", "/d/m", "/d/sub", "/d/z"]
            # and via the foreign shard: redirected, same answer
            async with c.http.get(
                    f"http://{f1.url}/__api__/list",
                    params={"path": "/d", "limit": "10"}) as r:
                assert r.status == 200
                names = [e["FullPath"]
                         for e in (await r.json())["entries"]]
            assert names == ["/d/a", "/d/m", "/d/sub", "/d/z"]
    run(body())


def test_online_split_moves_and_tombstones(tmp_path):
    async def body():
        async with ShardCluster(str(tmp_path)) as c:
            f0, f1 = c.filers
            paths = [f"/hot/d/f{i:02d}" for i in range(20)]
            for i, p in enumerate(paths):
                assert await c.create(f0, p, mtime=100.0 + i) == 200
            async with c.http.post(
                    f"http://{c.master.url}/cluster/shards",
                    json={"op": "split_intent", "prefix": "/hot",
                          "to": 1}) as r:
                assert r.status == 200, await r.text()
            await c.refresh()
            await c.wait_moves_drained()
            # routing flipped, data landed, source tombstoned
            assert f0.shard.map.route("/hot/d/f00") == 1
            for i, p in enumerate(paths):
                e = f1.filer.find_entry(p)
                assert e is not None and e.attr.mtime == 100.0 + i
                assert f0.filer.find_entry(p) is None
            assert f0.filer.find_entry("/hot") is None
            assert f0.shard.counters["moved"] >= len(paths)
            assert f1.shard.counters["ingest"] >= len(paths)
            # the moved prefix still answers through EITHER shard
            async with c.http.get(
                    f"http://{f0.url}/__api__/lookup",
                    params={"path": paths[0]}) as r:
                assert r.status == 200
    run(body())


def test_cross_shard_rename_replays_from_journal(tmp_path):
    async def body():
        async with ShardCluster(str(tmp_path)) as c:
            await c.set_rules([["/", 0], ["/s1", 1]])
            f0, f1 = c.filers
            assert await c.create(f0, "/src/f", mtime=123.0) == 200
            # commit the intent WITHOUT a foreground requester: this
            # is the crash-replay path — a journaled move with no one
            # driving it must be picked up by the source's executor
            async with c.http.post(
                    f"http://{c.master.url}/cluster/shards",
                    json={"op": "rename_intent", "src": "/src/f",
                          "dst": "/s1/f"}) as r:
                assert r.status == 200, await r.text()
            await c.refresh()
            await c.wait_moves_drained()
            e = f1.filer.find_entry("/s1/f")
            assert e is not None and e.attr.mtime == 123.0
            assert f0.filer.find_entry("/src/f") is None
            assert f0.shard.counters["replayed"] >= 1
    run(body())


def test_rename_replay_resumes_from_cleanup_state(tmp_path):
    async def body():
        async with ShardCluster(str(tmp_path)) as c:
            await c.set_rules([["/", 0], ["/s1", 1]])
            f0, f1 = c.filers
            assert await c.create(f0, "/src2/g", mtime=7.0) == 200
            # block every executor commit hop: the copy lands but the
            # intent cannot advance (a SIGKILL between copy and commit
            # leaves exactly this state in the committed map)
            failpoints.arm("filer.shard.move", "error")
            try:
                async with c.http.post(
                        f"http://{c.master.url}/cluster/shards",
                        json={"op": "rename_intent", "src": "/src2/g",
                              "dst": "/s1/g"}) as r:
                    assert r.status == 200
                await c.refresh()
                f0.shard._executor_wake.set()
                await asyncio.sleep(0.5)
                # advance the journal to cleanup OURSELVES (the crashed
                # executor's commit, replayed by the operator/master)
                async with c.http.post(
                        f"http://{c.master.url}/cluster/shards",
                        json={"op": "commit_move",
                              "id": "rename:/src2/g:/s1/g"}) as r:
                    assert r.status == 200
            finally:
                failpoints.disarm("filer.shard.move")
            await c.refresh()
            await c.wait_moves_drained()
            # resumed from cleanup: catch-up copy + tombstone + done
            e = f1.filer.find_entry("/s1/g")
            assert e is not None and e.attr.mtime == 7.0
            assert f0.filer.find_entry("/src2/g") is None
            assert f1.filer.find_entry("/s1/g").attr.mtime == 7.0
    run(body())


# -- limit clamps and the singleflight fence (unsharded filer) ---------

class OneFiler:
    """Master + a single UNSHARDED in-proc filer."""

    def __init__(self, tmpdir: str, **kw):
        self.tmpdir = tmpdir
        self.kw = kw
        self.master: MasterServer | None = None
        self.filer: FilerServer | None = None
        self.http: aiohttp.ClientSession | None = None

    async def __aenter__(self) -> "OneFiler":
        self.master = MasterServer(port=0, meta_dir=self.tmpdir)
        await self.master.start()
        self.filer = FilerServer(Filer("memory"), self.master.url,
                                 port=0, **self.kw)
        await self.filer.start()
        self.http = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=20))
        return self

    async def __aexit__(self, *exc) -> None:
        if self.http:
            await self.http.close()
        with contextlib.suppress(Exception):
            await self.filer.stop()
        with contextlib.suppress(Exception):
            await self.master.stop()


def test_negative_limit_clamps_not_unlimited(tmp_path):
    async def body():
        async with OneFiler(str(tmp_path), dir_list_limit=3) as c:
            f = c.filer
            for i in range(5):
                async with c.http.post(
                        f"http://{f.url}/__api__/entry",
                        json={"FullPath": f"/dir/f{i}"}) as r:
                    assert r.status == 200
            # SQLite reads LIMIT -1 as unlimited: a negative client
            # value must clamp to the cap, on BOTH listing surfaces
            for limit in ("-1", "0", "-999"):
                async with c.http.get(
                        f"http://{f.url}/dir",
                        params={"limit": limit},
                        headers={"Accept": "application/json"}) as r:
                    assert r.status == 200
                    assert len((await r.json())["Entries"]) == 3
                async with c.http.get(
                        f"http://{f.url}/__api__/list",
                        params={"path": "/dir", "limit": limit}) as r:
                    assert r.status == 200
                    assert len((await r.json())["entries"]) == 3
            # pagination edge: resume AT the cap boundary, no repeat
            async with c.http.get(
                    f"http://{f.url}/__api__/list",
                    params={"path": "/dir", "limit": "2",
                            "startFile": "f1"}) as r:
                names = [e["FullPath"]
                         for e in (await r.json())["entries"]]
            assert names == ["/dir/f2", "/dir/f3"]
    run(body())


def test_singleflight_listing_collapses_and_fences(tmp_path):
    async def body():
        async with OneFiler(str(tmp_path)) as c:
            f = c.filer
            for i in range(3):
                async with c.http.post(
                        f"http://{f.url}/__api__/entry",
                        json={"FullPath": f"/sf/f{i}"}) as r:
                    assert r.status == 200
            calls = {"n": 0}
            gate = asyncio.Event()
            real = f.filer.list_directory_entries

            def slow_list(*a, **kw):
                calls["n"] += 1
                # block the fill in its executor thread until every
                # concurrent caller has had time to pile onto the key
                import time as _t
                while not gate.is_set():
                    _t.sleep(0.01)
                return real(*a, **kw)

            f.filer.list_directory_entries = slow_list
            try:
                tasks = [asyncio.create_task(
                    f._list_entries("/sf", "", False, 100))
                    for _ in range(6)]
                await asyncio.sleep(0.3)
                gate.set()
                pages = await asyncio.gather(*tasks)
                # one underlying store query served all six callers
                assert calls["n"] == 1
                assert all(len(p) == 3 for p in pages)
                assert f._list_sf.collapsed >= 5
                # write-invalidation fence: a mutation bumps the dir
                # generation, so the next listing cannot reuse the
                # collapsed round's key
                f.bump_gen_fence("/sf")
                gate.set()
                again = await f._list_entries("/sf", "", False, 100)
                assert calls["n"] == 2
                assert len(again) == 3
            finally:
                f.filer.list_directory_entries = real
    run(body())
