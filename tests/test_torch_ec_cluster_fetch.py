"""Degraded GETs whose survivors come from peers, on the port's own
cluster: four volume servers, `ec.encode` spreading one volume's shards
4,4,3,3, and one server holding 4 of them stopped.

Every needle GET over HTTP from the encode's source (which keeps 3
shards) equals the written bytes and the plain reference's decode
(benchmark/reference/ec_rs.py) of the live servers' shard files. Traced, every
GET's trace holds `ec.fetch` spans, one a holder asked, with `holder`,
`transport` and `bytes`, and the holders' shard_read spans join it; the
port's SeaweedFS_ec_fetches_total and SeaweedFS_ec_fetch_bytes_total
rise by the requests and the bytes the spans count, by transport."""

import asyncio
import time

import numpy as np

from test_torch_cluster_util import Cluster, run

from benchmark.reference import ec_rs
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.shell import ec_commands as ec
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.util import tracing

VID = 7
# each needle spans 5 or more 1 KiB blocks, so each GET reads intervals
# of shards the source does not hold
SIZES = (4100, 9000, 12500, 5200, 21000, 7700, 15500, 6200, 26000, 8000)
TRANSPORTS = ("frame", "http")


def counters() -> dict:
    get = metrics.REGISTRY.get_sample_value
    return {(name, t): get(name, {"transport": t}) or 0.0
            for name in ("SeaweedFS_ec_fetches_total",
                         "SeaweedFS_ec_fetch_bytes_total")
            for t in TRANSPORTS}


async def ec_lookup(c: Cluster) -> dict:
    async with c.http.get(f"http://{c.master.url}/vol/ec_lookup",
                          params={"volumeId": str(VID)}) as r:
        return (await r.json())["shards"]


def test_gets_gather_survivors_from_peers(tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "_sample", 1.0)

    async def body():
        async with Cluster(str(tmp_path), n_servers=4) as c:
            source = c.servers[0]
            store = source.store
            store.add_volume(VID)
            rng = np.random.default_rng(2 ** 33 + 7)
            written = {}
            for nid, n in enumerate(SIZES, 1):
                data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                store.write_needle(VID, Needle(cookie=nid * 3, id=nid,
                                               data=data))
                written[nid] = data
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                (res,) = await ec.ec_encode(env, vids=[VID])
            await c.heartbeat_all()
            spread = res["assignments"]
            assert sorted(map(len, spread.values())) == [3, 3, 4, 4]
            assert sorted(spread[source.url]) == [3, 7, 11]

            lost = next(vs for vs in c.servers[1:]
                        if len(spread[vs.url]) == 4)
            await lost.stop()
            deadline = time.monotonic() + 30
            while any(lost.url in urls
                      for urls in (await ec_lookup(c)).values()):
                assert time.monotonic() < deadline, "the master kept it"
                await asyncio.sleep(0.1)
            live = [vs for vs in c.servers if vs is not lost]
            survivors = {
                sid: vs.store.ec_volumes[VID].base_name + pl.to_ext(sid)
                for vs in live for sid in vs.store.ec_volumes[VID].shards}
            assert len(survivors) == 10
            ecx = store.ec_volumes[VID].base_name + ".ecx"

            tracing.reset()
            before = counters()
            traces = {}
            for nid, data in written.items():
                fid = f"{VID},{nid:x}{nid * 3:08x}"
                with tracing.start_root("test", "get") as sp:
                    async with c.http.get(
                            f"http://{source.url}/{fid}",
                            headers={"traceparent": sp.traceparent()}) as r:
                        status, got = r.status, await r.read()
                traces[nid] = sp.trace
                assert status == 200 and got == data, nid
                assert ec_rs.decode_needle(
                    survivors, ecx, nid, large_block=c.ec_large_block,
                    small_block=c.ec_small_block) == data, nid
            after = counters()

            spans = {t: 0.0 for t in TRANSPORTS}
            requests = {t: 0 for t in TRANSPORTS}
            for nid, trace in traces.items():
                got = tracing.trace_spans_dict(trace)["spans"]
                fetch = [s for s in got
                         if (s["tier"], s["op"]) == ("ec", "fetch")]
                assert fetch, nid
                peers = {lv.url for lv in live if lv is not source}
                for s in fetch:
                    a = s["attrs"]
                    assert a["holder"] in peers, a
                    assert a["transport"] in TRANSPORTS, a
                    assert s["bytes"] > 0 and a["intervals"] >= 1, s
                    spans[a["transport"]] += s["bytes"]
                    requests[a["transport"]] += 1
                # the holders' shard_read spans joined the GET's trace,
                # each under the fetch that asked for it
                ids = {s["span"] for s in fetch}
                served = [s for s in got
                          if (s["tier"], s["op"]) == ("volume",
                                                      "ec.shard_read")]
                assert served and {s["parent"] for s in served} <= ids
            for t in TRANSPORTS:
                assert after[("SeaweedFS_ec_fetch_bytes_total", t)] - \
                    before[("SeaweedFS_ec_fetch_bytes_total", t)] \
                    == spans[t], t
                assert after[("SeaweedFS_ec_fetches_total", t)] - \
                    before[("SeaweedFS_ec_fetches_total", t)] \
                    == requests[t], t
            assert sum(spans.values()) > 0

    run(body())
