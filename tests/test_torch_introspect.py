"""Cluster-scope introspection (stats/introspect.py + the master's
/debug/cluster/* surface):

- assemble_trace is pure and deterministic: span dedupe across nodes
  (finished beats in-flight), self-time rollups per tier AND host, one
  nested tree, byte-identical output regardless of node arrival order;
- cluster_nodes enumerates self + quorum peers + topology volume
  servers + shard-map filers + ?extra= nodes, deduped, in a stable
  order;
- fanout degrades, never hangs: an armed introspect.fanout failpoint
  or an unreachable member becomes an explicit missing_nodes row
  inside the per-node deadline;
- end-to-end on the in-proc cluster: one traced read assembles into a
  single tree through /debug/cluster/trace/<id>, the timeline/health
  views merge every member, and a degraded pull retries to the
  byte-identical complete body once the fault clears.

The cases of tests/test_introspect.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest

from seaweedfs_tpu_torch.stats import introspect
from seaweedfs_tpu_torch.util import failpoints as fp
from seaweedfs_tpu_torch.util import tracing

from test_torch_cluster_util import Cluster, run


@pytest.fixture(autouse=True)
def _clean():
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    fp.reset()
    introspect.init()
    yield
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    fp.reset()
    introspect.init()


# ---------------------------------------------------------------------------
# assemble_trace (pure)


def _span(sid: str, parent: str, tier: str, start: float, dur: float,
          inflight: bool = False) -> dict:
    d = {"span": sid, "parent": parent, "tier": tier, "op": "x",
         "start_ms": start, "dur_ms": dur}
    if inflight:
        d["inflight"] = True
    return d


def test_assemble_dedupes_and_attributes_self_time():
    # host h2 saw span "b" only in-flight; h1 has the finished record
    payloads = [
        ("h1:1", {"spans": [_span("a", "", "s3", 0.0, 10.0),
                            _span("b", "a", "volume", 1.0, 6.0)]}),
        ("h2:1", {"spans": [_span("b", "a", "volume", 1.0, 2.0,
                                  inflight=True),
                            _span("c", "b", "store", 2.0, 4.0)]}),
    ]
    out = introspect.assemble_trace("t" * 32, payloads)
    assert out["spans"] == 3 and out["inflight"] == 0
    by_id = {}
    stack = list(out["tree"])
    while stack:
        n = stack.pop()
        by_id[n["span"]] = n
        stack.extend(n.get("children", ()))
    # the finished record won the dedupe (dur 6, not 2) and kept h1
    assert by_id["b"]["dur_ms"] == 6.0 and by_id["b"]["host"] == "h1:1"
    # one chain a -> b -> c
    assert out["tree"][0]["span"] == "a"
    assert out["tree"][0]["children"][0]["span"] == "b"
    assert out["tree"][0]["children"][0]["children"][0]["span"] == "c"
    # self-time: a=10-6, b=6-4, c=4
    assert by_id["a"]["self_ms"] == 4.0
    assert by_id["b"]["self_ms"] == 2.0
    assert out["tiers"] == {"s3": 4.0, "store": 4.0, "volume": 2.0}
    # host attribution follows the deduped winner
    assert out["hosts"] == {"h1:1": 6.0, "h2:1": 4.0}
    assert out["complete"] and out["missing_nodes"] == []


def test_assemble_byte_identical_across_arrival_order():
    payloads = [
        ("h1:1", {"spans": [_span("a", "", "s3", 0.0, 9.0)]}),
        ("h2:1", {"spans": [_span("b", "a", "volume", 1.0, 5.0)]}),
        ("h3:1", {"spans": [_span("c", "a", "filer", 2.0, 2.0)]}),
    ]
    missing = [{"node": "h9:1", "kind": "volume", "error": "timeout"}]
    first = json.dumps(
        introspect.assemble_trace("ab" * 16, payloads, list(missing)),
        sort_keys=True)
    again = json.dumps(
        introspect.assemble_trace("ab" * 16, list(reversed(payloads)),
                                  list(missing)),
        sort_keys=True)
    assert first == again
    body = json.loads(first)
    assert not body["complete"]
    assert body["missing_nodes"] == missing


def test_assemble_orphan_parent_becomes_root_and_cycles_terminate():
    # b's parent never reported (lost host) -> b roots; a cycle between
    # d and e must not recurse forever
    payloads = [("h1:1", {"spans": [
        _span("b", "ghost", "volume", 1.0, 3.0),
        _span("d", "e", "s3", 2.0, 1.0),
        _span("e", "d", "s3", 3.0, 1.0)]})]
    out = introspect.assemble_trace("cd" * 16, payloads)
    roots = {n["span"] for n in out["tree"]}
    assert "b" in roots
    assert out["spans"] == 3


# ---------------------------------------------------------------------------
# cluster_nodes


class _FakeNode:
    def __init__(self, url):
        self.url = url


class _FakeMaster:
    url = "m0:9333"
    _peers = ["m1:9333", "m0:9333"]

    class topo:
        @staticmethod
        def all_nodes():
            return [_FakeNode("v0:8080"), _FakeNode("v1:8080")]

    def _shard_map_dict(self):
        return {"owners": {"1": "f1:8888", "0": "f0:8888",
                           "2": "f0:8888"}}


def test_cluster_nodes_enumeration_dedupe_and_extra():
    nodes = introspect.cluster_nodes(
        _FakeMaster(), extra="s3:gw:8333,v0:8080,wd:9999")
    addrs = [(n["node"], n["kind"]) for n in nodes]
    assert addrs == [("m0:9333", "master"), ("m1:9333", "master"),
                     ("v0:8080", "volume"), ("v1:8080", "volume"),
                     ("f0:8888", "filer"), ("f1:8888", "filer"),
                     ("gw:8333", "s3"), ("wd:9999", "volume")]
    assert nodes[0]["local"]
    # the path-shadowing tiers get the reserved prefix
    prefixes = {n["node"]: n["prefix"] for n in nodes}
    assert prefixes["f0:8888"] == "/__debug__"
    assert prefixes["gw:8333"] == "/__debug__"
    assert prefixes["v0:8080"] == "/debug"


def test_cluster_nodes_equals_the_reference_on_one_shard_map():
    """The same two masters as the parity tests (equal heartbeats), each
    with filers registered in its committed shard map through POST
    /cluster/shards: the port's cluster_nodes and the reference's list
    the same nodes, each master's own address masked."""
    from seaweedfs_tpu.stats import introspect as ref_introspect
    from test_torch_master_parity import _norm, _with_masters

    async def body(http, ref, port):
        for sid, url in ((1, "f1:8888"), (0, "f0:8888"), (2, "f0:8888")):
            for m in (ref, port):
                async with http.post(
                        f"http://{m.url}/cluster/shards",
                        json={"op": "register", "shard": sid,
                              "url": url}) as r:
                    assert r.status == 200, await r.text()
        extra = "s3:gw:8333,wd:9999"
        want = _norm(ref_introspect.cluster_nodes(ref, extra=extra),
                     ref.url)
        got = _norm(introspect.cluster_nodes(port, extra=extra), port.url)
        assert got == want
        assert [n["node"] for n in got if n["kind"] == "filer"] == \
            ["f0:8888", "f1:8888"]
    run(_with_masters(1, body))


# ---------------------------------------------------------------------------
# fanout degradation (no servers needed: every node is unreachable)


def test_fanout_failpoint_degrades_to_missing_rows():
    import aiohttp

    async def go():
        fp.arm("introspect.fanout", "error")
        nodes = [{"node": "a:1", "kind": "volume", "prefix": "/debug"},
                 {"node": "b:2", "kind": "filer",
                  "prefix": "/__debug__"},
                 {"node": "self:0", "kind": "master",
                  "prefix": "/debug", "local": True}]
        async with aiohttp.ClientSession() as http:
            results, missing = await introspect.fanout(
                nodes, "/traces", http, deadline=2.0,
                local=lambda: {"spans": []})
        # the local node never rides the network: it still answered
        assert [nd["node"] for nd, _ in results] == ["self:0"]
        assert [m["node"] for m in missing] == ["a:1", "b:2"]
        assert all(m["error"] for m in missing)
    run(go())


def test_fanout_unreachable_member_is_bounded_by_deadline():
    import aiohttp

    async def go():
        # RFC 5737 TEST-NET: never routable -> connect hangs, the
        # per-node deadline must cut it
        nodes = [{"node": "192.0.2.1:9", "kind": "volume",
                  "prefix": "/debug"}]
        async with aiohttp.ClientSession() as http:
            t0 = time.monotonic()
            results, missing = await introspect.fanout(
                nodes, "/timeline", http, deadline=0.5)
            elapsed = time.monotonic() - t0
        assert results == [] and len(missing) == 1
        assert missing[0]["error"]
        assert elapsed < 3.0, elapsed
    run(go())


# ---------------------------------------------------------------------------
# end-to-end: the master's /debug/cluster/* surface


def test_cluster_trace_assembles_one_tree(tmp_path):
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"cluster-scope")
            assert st == 201
            tracing.reset()
            tid = "5a" * 16
            tp = f"00-{tid}-{'1b' * 8}-01"
            async with c.http.get(f"http://{a['url']}/{a['fid']}",
                                  headers={"traceparent": tp}) as r:
                assert r.status == 200

            m = c.master.url
            async with c.http.get(
                    f"http://{m}/debug/cluster/trace/{tid}") as r:
                assert r.status == 200
                body = await r.json()
            assert body["trace_id"] == tid
            assert body["spans"] >= 1
            assert "volume" in body["tiers"], body["tiers"]
            assert body["complete"] and body["missing_nodes"] == []
            # every span in the tree carries its reporting host
            assert all(n.get("host") for n in body["tree"])

            # the index names the views and the member enumeration
            async with c.http.get(f"http://{m}/debug/cluster") as r:
                idx = await r.json()
            assert "/debug/cluster/health" in idx["views"]
            assert len(idx["nodes"]) == 3       # master + 2 volumes
            assert idx["deadline_s"] == introspect.deadline_s()

            # empty trace id -> 400, not a fan-out
            async with c.http.get(
                    f"http://{m}/debug/cluster/trace/%20") as r:
                assert r.status == 400
    run(go())


def test_cluster_timeline_health_and_events_merge_members(tmp_path):
    async def go():
        from seaweedfs_tpu_torch.stats import timeline
        timeline.init(interval_s=1.0, ring=64)
        timeline.reset()
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"merge-me")
            assert st == 201
            timeline.snap()
            await c.get(a["fid"], a["url"])
            timeline.snap()
            m = c.master.url
            async with c.http.get(
                    f"http://{m}/debug/cluster/timeline",
                    params={"n": "10"}) as r:
                assert r.status == 200
                tl = await r.json()
            assert tl["nodes"] == 3 and tl["missing_nodes"] == []
            # in-proc the members share one registry: same-wall windows
            # fold instead of double-counting
            assert "windows" in tl
            async with c.http.get(
                    f"http://{m}/debug/cluster/health") as r:
                assert r.status == 200
                h = await r.json()
            assert h["nodes"] == 3 and h["missing_nodes"] == []
            assert "status" in h and "objectives" in h
            async with c.http.get(
                    f"http://{m}/debug/cluster/events",
                    params={"n": "50"}) as r:
                assert r.status == 200
                ev = await r.json()
            assert ev["nodes"] == 3
            # every merged row carries its origin node
            assert all("node" in row for row in ev.get("events", []))
    run(go())


def test_cluster_trace_degraded_then_byte_identical_retry(tmp_path):
    """A member failing mid-fanout degrades to a missing_nodes row
    inside the deadline; once the fault clears, two consecutive pulls
    of the completed trace return byte-identical bodies."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"degrade-me")
            assert st == 201
            tracing.reset()
            tid = "7c" * 16
            tp = f"00-{tid}-{'2d' * 8}-01"
            async with c.http.get(f"http://{a['url']}/{a['fid']}",
                                  headers={"traceparent": tp}) as r:
                assert r.status == 200

            m = c.master.url
            # every non-local pull fails while armed (the local master
            # node still answers) -> partial tree, explicit rows, 200
            fp.arm("introspect.fanout", "error:100")
            t0 = time.monotonic()
            async with c.http.get(
                    f"http://{m}/debug/cluster/trace/{tid}") as r:
                assert r.status == 200
                degraded = await r.json()
            elapsed = time.monotonic() - t0
            assert elapsed < introspect.deadline_s() + 2.0, elapsed
            assert not degraded["complete"]
            assert len(degraded["missing_nodes"]) == 2
            assert {mr["error"] for mr in degraded["missing_nodes"]}

            fp.reset()
            async with c.http.get(
                    f"http://{m}/debug/cluster/trace/{tid}") as r:
                first = await r.read()
            async with c.http.get(
                    f"http://{m}/debug/cluster/trace/{tid}") as r:
                second = await r.read()
            assert first == second
            body = json.loads(first)
            assert body["complete"] and body["missing_nodes"] == []
            assert body["spans"] >= degraded["spans"]
    run(go())
