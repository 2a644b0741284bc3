"""End-to-end trace propagation (the ISSUE 4 acceptance shape):

- one trace ID spans gateway -> filer(stream) -> client -> volume ->
  sibling-proxy -> volume(owner) -> store across an S3 gateway over a
  2-worker-partitioned volume fleet;
- a forced replica failover (failpoint volume.read.http truncating a
  holder mid-body) shows up as replica_rotate / range_resume events on
  the client read span;
- /debug/traces answered by one worker aggregates the sibling rings
  (merged, deduped) and /debug/requests lists in-flight spans.

The cases of tests/test_trace_propagation.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

from __future__ import annotations

import json
import os

import pytest

from seaweedfs_tpu_torch.util import failpoints as fp
from seaweedfs_tpu_torch.util import tracing

from test_torch_cluster_util import Cluster, run


@pytest.fixture(autouse=True)
def _clean():
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    fp.reset()
    yield
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    fp.reset()


async def _start_worker_fleet(c: Cluster, tmp_path, n: int = 2):
    """n in-proc volume workers partitioned vid %% n over one shared
    dir, all advertising worker 0 as their publicUrl — so every
    client read enters at worker 0 and a sibling-owned vid is
    DETERMINISTICALLY served via the worker proxy."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.server.workers import WorkerContext
    from seaweedfs_tpu_torch.storage.store import Store
    state_dir = str(tmp_path / "wstate")
    d = str(tmp_path / "wdata")
    workers = []
    for i in range(n):
        ctx = WorkerContext(i, n, 0, state_dir, token="tok")
        store = Store([os.path.join(d)], max_volume_counts=[16],
                      partition=(i, n))
        vs = VolumeServer(store, c.master.url, port=0,
                          pulse_seconds=0.2, worker_ctx=ctx)
        await vs.start()
        workers.append(vs)
    for vs in workers:
        vs.store.public_url = workers[0].url
        await vs.heartbeat_once()
    return workers


def test_one_trace_spans_gateway_filer_proxy_store(tmp_path):
    async def go():
        from seaweedfs_tpu_torch.filer.filer import Filer
        from seaweedfs_tpu_torch.s3.gateway import S3Gateway
        async with Cluster(str(tmp_path), n_servers=0) as c:
            workers = await _start_worker_fleet(c, tmp_path)
            s3 = S3Gateway(Filer("memory"), c.master.url, port=0)
            await s3.start()
            try:
                base = f"http://{s3.url}/tbucket"
                async with c.http.put(base) as r:
                    assert r.status == 200
                # write objects until one's chunk sits on an ODD vid
                # (owned by worker 1 => read via worker 0 is proxied)
                target = data = None
                for i in range(16):
                    body = (b"trace-me-%d." % i) * 4096
                    async with c.http.put(f"{base}/obj{i}",
                                          data=body) as r:
                        assert r.status == 200, await r.text()
                    e = s3.filer.find_entry(f"/buckets/tbucket/obj{i}")
                    if int(e.chunks[0].file_id.split(",")[0]) % 2 == 1:
                        target, data = f"obj{i}", body
                        break
                assert target is not None, "no odd-vid chunk in 16 tries"

                tracing.reset()
                trace_id = "ab" * 16
                tp = f"00-{trace_id}-{'cd' * 8}-01"
                async with c.http.get(f"{base}/{target}",
                                      headers={"traceparent": tp}) as r:
                    assert r.status == 200
                    assert await r.read() == data

                d = tracing.traces_dict(recent=100)
                ours = [g for g in d["traces"]
                        if g["trace_id"] == trace_id]
                assert ours, [g["trace_id"] for g in d["traces"]]
                g = ours[0]
                tiers = set(g["tiers"])
                assert {"s3", "filer", "client", "volume", "proxy",
                        "store"} <= tiers, tiers
                by_id = {s["span"]: s for s in g["spans"]}
                # the owner-side volume span hangs off the proxy span,
                # and the store span off the owner-side volume span:
                # the cross-worker hop stayed in ONE parent chain
                proxy = [s for s in g["spans"] if s["tier"] == "proxy"][0]
                owner_vol = [s for s in g["spans"]
                             if s["parent"] == proxy["span"]]
                assert owner_vol and owner_vol[0]["tier"] == "volume"
                store = [s for s in g["spans"] if s["tier"] == "store"][0]
                assert store["parent"] == owner_vol[0]["span"]
                assert store["attrs"]["source"] in ("pread", "cache")
                # non-overlapping attribution ~= wall time
                assert abs(sum(s["self_ms"] for s in g["spans"])
                           - g["dur_ms"]) < 0.25 * g["dur_ms"] + 5.0
                # every span chains to a parent inside the trace except
                # the entry span (parent = the synthetic header span)
                roots = [s for s in g["spans"]
                         if s["parent"] not in by_id]
                assert all(s["parent"] == "cd" * 8 for s in roots)

                # -- /debug/traces on worker 0 merges the sibling ring
                async with c.http.get(
                        f"http://{workers[0].url}/debug/traces",
                        params={"n": "100"}) as r:
                    assert r.status == 200
                    merged = await r.json()
                mg = [t for t in merged["traces"]
                      if t["trace_id"] == trace_id]
                assert mg, "merged /debug/traces lost the trace"
                # deduped: the sibling's ring is this same process's
                # ring, so merging must not double any span
                assert len(mg[0]["spans"]) == len(g["spans"])

                # -- the gateway's reserved-path twin serves its ring
                async with c.http.get(
                        f"http://{s3.url}/__debug__/traces",
                        params={"n": "100"}) as r:
                    assert r.status == 200
                    gw = await r.json()
                assert any(t["trace_id"] == trace_id
                           for t in gw["traces"])

                # -- /debug/requests: shape check (nothing wedged now)
                async with c.http.get(
                        f"http://{workers[0].url}/debug/requests") as r:
                    body = await r.json()
                assert "inflight" in body and "requests" in body
            finally:
                await s3.stop()
                for vs in workers:
                    await vs.stop()
    run(go())


def test_replica_failover_appears_as_retry_span_events(tmp_path):
    """A holder truncating mid-body (volume.read.http) must surface on
    the client read span as replica_rotate + range_resume events, with
    the read still byte-exact."""
    from seaweedfs_tpu_torch.util.client import WeedClient

    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            data = bytes(range(256)) * 2048          # 512 KiB positional
            a = await c.assign(replication="001")
            st, _ = await c.put(a["fid"], a["url"], data)
            assert st == 201
            # one mid-body truncation: whichever holder serves first
            # dies at 50%; count=1 so the rotation target serves clean
            fp.arm("volume.read.http", "truncate=0.5:1")
            tracing.reset()
            async with WeedClient(c.master.url) as wc:
                with tracing.start_root("test", "read") as root:
                    got = await wc.read(a["fid"], offset=0,
                                        size=len(data))
            assert got == data
            assert not fp.pending("volume.read.http")   # it fired
            g = [t for t in tracing.traces_dict(recent=50)["traces"]
                 if t["trace_id"] == root.trace][0]
            reads = [s for s in g["spans"]
                     if s["tier"] == "client" and s["op"] == "read"]
            assert reads, g["spans"]
            events = [e["name"] for s in reads
                      for e in s.get("events", ())]
            assert "replica_rotate" in events, events
            assert "range_resume" in events, events
            assert sum(s["bytes"] for s in reads) == len(data)
    run(go())


def test_breaker_rejection_appears_as_span_event(tmp_path):
    """An upload aimed at an upstream with an OPEN breaker records a
    breaker_open event before failing fast."""
    from seaweedfs_tpu_torch.util.client import OperationError, WeedClient
    from seaweedfs_tpu_torch.util.resilience import BreakerRegistry

    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            breakers = BreakerRegistry(threshold=1, reset_timeout=60.0)
            br = breakers.get(a["url"])
            br.record_failure()                    # force OPEN
            assert not br.allow() or True
            tracing.reset()
            async with WeedClient(c.master.url,
                                  breakers=breakers) as wc:
                with tracing.start_root("test", "write") as root:
                    with pytest.raises(OperationError):
                        await wc.upload(a["fid"], a["url"], b"x" * 64)
            g = [t for t in tracing.traces_dict(recent=50)["traces"]
                 if t["trace_id"] == root.trace][0]
            ups = [s for s in g["spans"]
                   if s["tier"] == "client" and s["op"] == "upload"]
            assert ups and ups[0]["status"] == "error"
            assert any(e["name"] == "breaker_open"
                       for e in ups[0].get("events", ())), ups[0]
    run(go())


def test_volume_fast_path_records_root_span(tmp_path):
    """The raw fasthttp GET/POST path produces volume+store spans (and
    a cache-source annotation on a hot re-read)."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            tracing.reset()
            st, _ = await c.put(a["fid"], a["url"], b"fastpath-needle")
            assert st == 201
            st, got = await c.get(a["fid"], a["url"])
            assert st == 200 and got == b"fastpath-needle"
            st, got = await c.get(a["fid"], a["url"])   # cache-hot
            assert st == 200
            d = tracing.traces_dict(recent=100)
            ops = {(s["tier"], s["op"], s["status"])
                   for g in d["traces"] for s in g["spans"]}
            assert ("volume", "write", "ok") in ops, ops
            assert ("volume", "read", "ok") in ops, ops
            assert ("store", "write", "ok") in ops, ops
            sources = {s["attrs"].get("source")
                       for g in d["traces"] for s in g["spans"]
                       if s["tier"] in ("volume", "store")
                       and "attrs" in s}
            assert "cache" in sources or "pread" in sources, sources
    run(go())


def test_unrouted_admin_paths_mint_no_op_labels(tmp_path):
    """Probes of /admin/<junk> must not become spans (their op feeds
    prometheus label values — unbounded cardinality otherwise); the
    registered admin mesh still traces."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            tracing.reset()
            for i in range(5):
                async with c.http.get(
                        f"http://{vs.url}/admin/scan{i}/x") as r:
                    assert r.status in (404, 405)
            ops = {s["op"] for g in tracing.traces_dict()["traces"]
                   for s in g["spans"]}
            assert not any(o.startswith("scan") for o in ops), ops
            async with c.http.get(
                    f"http://{vs.url}/admin/volume/status",
                    params={"volume": "999"}) as r:
                await r.read()
            ops = {s["op"] for g in tracing.traces_dict()["traces"]
                   for s in g["spans"]}
            assert "volume.status" in ops, ops
    run(go())


def test_trace_sample_zero_records_nothing(tmp_path):
    """-trace.sample 0: the entire pipeline is a no-op — no spans, no
    in-flight entries, reads unaffected."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            tracing.init(sample=0.0)
            tracing.reset()
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"untraced")
            assert st == 201
            st, got = await c.get(a["fid"], a["url"])
            assert st == 200 and got == b"untraced"
            assert tracing.traces_dict()["spans"] == 0
            assert tracing.requests_dict()["inflight"] == 0
    run(go())


def test_frame_hop_stays_one_trace_with_transport_attr(tmp_path):
    """The binary sibling wire keeps the cross-worker hop in ONE
    trace: the proxy span carries transport=frame, the owner-side
    volume span (minted by the frame adapter) chains under it — and
    with worker.frame armed, the SAME read downgrades to the HTTP hop
    (transport=http + frame_fallback event), bytes identical."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=0) as c:
            workers = await _start_worker_fleet(c, tmp_path)
            try:
                # a fid on an ODD vid: reads entering worker 0 must hop
                fid = body = None
                for _ in range(16):
                    a = await c.assign()
                    if int(a["fid"].split(",")[0]) % 2 == 1:
                        fid, body = a["fid"], b"frame-hop-trace" * 100
                        st, _ = await c.put(fid, workers[0].url, body)
                        assert st == 201
                        break
                assert fid is not None, "no odd-vid assign in 16 tries"

                tracing.reset()
                trace_id = "ef" * 16
                tp = f"00-{trace_id}-{'ad' * 8}-01"
                async with c.http.get(f"http://{workers[0].url}/{fid}",
                                      headers={"traceparent": tp}) as r:
                    assert r.status == 200
                    assert await r.read() == body
                g = [t for t in tracing.traces_dict(recent=100)["traces"]
                     if t["trace_id"] == trace_id][0]
                proxy = [s for s in g["spans"]
                         if s["tier"] == "proxy"][0]
                assert proxy["attrs"]["transport"] == "frame", proxy
                owner_vol = [s for s in g["spans"]
                             if s["parent"] == proxy["span"]]
                assert owner_vol and owner_vol[0]["tier"] == "volume"
                assert owner_vol[0]["attrs"]["transport"] == "frame"
                # the store span chains under the frame-served read
                store = [s for s in g["spans"] if s["tier"] == "store"]
                assert store and store[0]["parent"] == \
                    owner_vol[0]["span"]

                # sever the frame hop: same read, same bytes, but the
                # proxy span records the downgrade
                fp.arm("worker.frame", "error")
                tracing.reset()
                trace_id2 = "f0" * 16
                tp2 = f"00-{trace_id2}-{'ad' * 8}-01"
                async with c.http.get(f"http://{workers[0].url}/{fid}",
                                      headers={"traceparent": tp2}) as r:
                    assert r.status == 200
                    assert await r.read() == body
                g2 = [t for t in
                      tracing.traces_dict(recent=100)["traces"]
                      if t["trace_id"] == trace_id2][0]
                proxy2 = [s for s in g2["spans"]
                          if s["tier"] == "proxy"][0]
                assert proxy2["attrs"]["transport"] == "http", proxy2
                assert any(e["name"] == "frame_fallback"
                           for e in proxy2.get("events", [])), proxy2
            finally:
                for vs in workers:
                    await vs.stop()
    run(go())


def test_replication_fanout_frame_hop_keeps_one_trace(tmp_path):
    """PR 14 hop audit — the replica fan-out: a replicated write's
    traceparent rides the inter-host frame channel, so the replica's
    own (volume, store) spans chain under the primary's replicate
    span. With replication.frame armed the SAME write downgrades to
    the HTTP fallback and the chain still holds."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            for armed in (False, True):
                if armed:
                    fp.arm("replication.frame", "error:100")
                a = await c.assign(replication="001")
                tracing.reset()
                trace_id = ("9a" if armed else "8b") * 16
                tp = f"00-{trace_id}-{'7c' * 8}-01"
                async with c.http.post(
                        f"http://{a['url']}/{a['fid']}",
                        data=b"replicate-trace" * 64,
                        headers={"traceparent": tp}) as r:
                    assert r.status == 201, await r.text()
                g = [t for t in
                     tracing.traces_dict(recent=100)["traces"]
                     if t["trace_id"] == trace_id]
                assert g, "write minted no trace"
                spans = g[0]["spans"]
                rep = [s for s in spans if s["tier"] == "replicate"]
                assert rep, {s["tier"] for s in spans}
                # the replica-side volume write chains UNDER the
                # fan-out span: the header crossed the wire
                replica_writes = [
                    s for s in spans
                    if s["tier"] == "volume" and s["op"] == "write"
                    and s["parent"] == rep[0]["span"]]
                assert replica_writes, spans
                transport = replica_writes[0].get("attrs", {}).get(
                    "transport")
                # the frame-served replica stamps its transport; the
                # HTTP fallback is the plain listener path (no stamp)
                assert transport == (None if armed else "frame"), \
                    (armed, replica_writes[0])
                fp.reset()
    run(go())


def test_ec_shard_gather_hop_keeps_one_trace(tmp_path):
    """PR 14 hop audit — the EC shard gather: reconstructing a needle
    pulls shard intervals from remote holders; every remote
    ec.shard_read span must join the reading trace (the gather's
    injected traceparent rode the fetch)."""
    import random

    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.shell import ec_commands as ec

    async def go():
        async with Cluster(str(tmp_path), n_servers=4) as c:
            rng = random.Random(7)
            files = []
            for _ in range(8):
                a = await c.assign(collection="ectrace")
                data = bytes(rng.getrandbits(8)
                             for _ in range(rng.randint(2000, 9000)))
                st, _ = await c.put(a["fid"], a["url"], data)
                assert st == 201
                files.append((a["fid"], data))
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                vids = sorted({int(f.split(",")[0]) for f, _ in files})
                res = await ec.ec_encode(env, collection="ectrace",
                                         vids=vids)
                assert res

            fid, data = files[0]
            tracing.reset()
            trace_id = "6e" * 16
            tp = f"00-{trace_id}-{'5f' * 8}-01"
            st, got = None, None
            async with c.http.get(
                    f"http://{c.servers[0].url}/{fid}",
                    headers={"traceparent": tp},
                    allow_redirects=True) as r:
                st, got = r.status, await r.read()
            assert st == 200 and got == data
            g = [t for t in tracing.traces_dict(recent=100)["traces"]
                 if t["trace_id"] == trace_id]
            assert g, "EC read minted no trace"
            spans = g[0]["spans"]
            by_id = {s["span"]: s for s in spans}
            gathers = [s for s in spans if s["op"] == "ec.shard_read"]
            assert gathers, {(s["tier"], s["op"]) for s in spans}
            # every remote shard read chains to a parent INSIDE the
            # trace — no orphaned roots from a dropped header
            for s in gathers:
                assert s["parent"] in by_id, s
    run(go())
