"""Cluster integration tests: assign/write/read/delete, replication,
redirects, topology — against a real in-proc master + volume servers.

These exercise the distributed paths the reference leaves untested
(SURVEY.md §4): heartbeat-driven topology sync, on-demand volume growth,
replica fan-out.

The cases of tests/test_cluster.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

import asyncio

from test_torch_cluster_util import Cluster, run


def test_assign_write_read_delete(tmp_path):
    async def body():
        async with Cluster(str(tmp_path)) as c:
            a = await c.assign()
            assert "fid" in a, a
            st, r = await c.put(a["fid"], a["url"], b"hello cluster")
            assert st == 201, r
            st, data = await c.get(a["fid"], a["publicUrl"])
            assert st == 200 and data == b"hello cluster"
            # wrong cookie -> 404
            vid, rest = a["fid"].split(",")
            bad = f"{vid},{rest[:-8]}{'0'*8}"
            st, _ = await c.get(bad, a["publicUrl"])
            assert st == 404
            assert await c.delete(a["fid"], a["url"]) == 200
            st, _ = await c.get(a["fid"], a["publicUrl"])
            assert st == 404
    run(body())


def test_topology_status(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=3,
                           racks=[("dc1", "r1"), ("dc1", "r2"),
                                  ("dc2", "r1")]) as c:
            async with c.http.get(
                    f"http://{c.master.url}/dir/status") as resp:
                topo = (await resp.json())["topology"]
            dcs = {d["id"] for d in topo["datacenters"]}
            assert dcs == {"dc1", "dc2"}
            n_nodes = sum(len(r["nodes"]) for d in topo["datacenters"]
                          for r in d["racks"])
            assert n_nodes == 3
    run(body())


def test_replication_001(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=3) as c:
            a = await c.assign(replication="001")
            assert "fid" in a, a
            st, _ = await c.put(a["fid"], a["url"], b"replicated!")
            assert st == 201
            await c.heartbeat_all()
            # find the two servers holding the volume
            vid = int(a["fid"].split(",")[0])
            holders = [vs for vs in c.servers
                       if vid in vs.store.volumes]
            assert len(holders) == 2
            for vs in holders:
                n = vs.store.read_needle(
                    vid, int(a["fid"].split(",")[1][:-8], 16))
                assert n.data == b"replicated!"
            # delete propagates to both replicas
            assert await c.delete(a["fid"], a["url"]) == 200
            for vs in holders:
                st, _ = await c.get(a["fid"], vs.url)
                assert st == 404
    run(body())


def test_read_redirect_from_wrong_server(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"redirect me")
            assert st == 201
            await c.heartbeat_all()
            other = next(vs for vs in c.servers if vs.url != a["url"])
            st, data = await c.get(a["fid"], other.url)  # follows 301
            assert st == 200 and data == b"redirect me"
    run(body())


def test_lookup_and_growth(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign(collection="photos")
            vid = a["fid"].split(",")[0]
            async with c.http.get(f"http://{c.master.url}/dir/lookup",
                                  params={"volumeId": vid}) as resp:
                locs = (await resp.json())["locations"]
            assert locs and locs[0]["url"] == a["url"]
            # unknown vid -> 404
            async with c.http.get(f"http://{c.master.url}/dir/lookup",
                                  params={"volumeId": "9999"}) as resp:
                assert resp.status == 404
    run(body())


def test_placement_rejects_impossible_replication(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            # 2 servers in one rack cannot satisfy diff-DC replication
            a = await c.assign(replication="100")
            assert "error" in a
    run(body())


def test_sequencer_syncs_from_heartbeat(tmp_path):
    async def body():
        async with Cluster(str(tmp_path)) as c:
            a1 = await c.assign()
            await c.put(a1["fid"], a1["url"], b"x")
            key1 = int(a1["fid"].split(",")[1][:-8], 16)
            await c.heartbeat_all()
            a2 = await c.assign()
            key2 = int(a2["fid"].split(",")[1][:-8], 16)
            assert key2 > key1
    run(body())


def test_conditional_reads_304(tmp_path):
    """ETag + Last-Modified conditional GETs
    (volume_server_handlers_read.go:102-116)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"conditional-body")
            assert st == 201
            url = f"http://{a['url']}/{a['fid']}"
            async with c.http.get(url) as resp:
                assert resp.status == 200
                etag = resp.headers["Etag"]
                lm = resp.headers["Last-Modified"]
            async with c.http.get(
                    url, headers={"If-None-Match": etag}) as resp:
                assert resp.status == 304
                assert await resp.read() == b""
            async with c.http.get(
                    url, headers={"If-None-Match": '"deadbeef"'}) as resp:
                assert resp.status == 200
            async with c.http.get(
                    url, headers={"If-Modified-Since": lm}) as resp:
                assert resp.status == 304
            async with c.http.get(
                    url, headers={"If-Modified-Since":
                                  "Thu, 01 Jan 1970 00:00:00 GMT"}) as resp:
                assert resp.status == 200
            # garbage date: served normally, not an error
            async with c.http.get(
                    url, headers={"If-Modified-Since": "not-a-date"}) as resp:
                assert resp.status == 200
    run(body())


def test_pairs_headers_and_md5_etag(tmp_path):
    """Seaweed-* upload headers round-trip as needle pairs and come back
    as response headers (needle.go:19 PairNamePrefix,
    volume_server_handlers_read.go:117-132)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            url = f"http://{a['url']}/{a['fid']}"
            async with c.http.post(
                    url, data=b"paired",
                    headers={"Seaweed-X-Trace": "t-123",
                             "Seaweed-Owner": "alice"}) as resp:
                assert resp.status == 201, await resp.text()
            async with c.http.get(url) as resp:
                assert resp.status == 200
                assert resp.headers["Seaweed-X-Trace"] == "t-123"
                assert resp.headers["Seaweed-Owner"] == "alice"
                crc_etag = resp.headers["Etag"]
            import hashlib
            async with c.http.get(
                    url, headers={"ETag-MD5": "True"}) as resp:
                md5 = hashlib.md5(b"paired").hexdigest()
                assert resp.headers["Etag"] == f'"{md5}"'
                assert resp.headers["Etag"] != crc_etag

            # lowercase prefix counts (Go canonicalizes header casing)
            a2 = await c.assign()
            url2 = f"http://{a2['url']}/{a2['fid']}"
            async with c.http.post(
                    url2, data=b"x",
                    headers={"seaweed-lower": "yes"}) as resp:
                assert resp.status == 201
            async with c.http.get(url2) as resp:
                assert resp.headers["Seaweed-Lower"] == "yes"

            # >64KB of pair headers: clean 400, not an unhandled 500
            a3 = await c.assign()
            async with c.http.post(
                    f"http://{a3['url']}/{a3['fid']}", data=b"x",
                    headers={f"Seaweed-K{i}": "v" * 7000
                             for i in range(10)}) as resp:
                assert resp.status == 400
                assert "pairs" in (await resp.json())["error"]
    run(body())


def test_filename_disposition_and_mime_guess(tmp_path):
    """Needle-name-derived Content-Disposition / mime, ?dl=true download
    (writeResponseContent, volume_server_handlers_read.go:229-248)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            import aiohttp
            a = await c.assign()
            url = f"http://{a['url']}/{a['fid']}"
            form = aiohttp.FormData()
            # no part content-type: mime must be guessed from the name
            form.add_field("file", b"<html></html>", filename="page.html")
            async with c.http.post(url, data=form) as resp:
                assert resp.status == 201, await resp.text()
            async with c.http.get(url) as resp:
                assert resp.status == 200
                assert resp.content_type == "text/html"
                assert resp.headers["Content-Disposition"] == \
                    'inline; filename="page.html"'
            async with c.http.get(url + "?dl=true") as resp:
                assert resp.headers["Content-Disposition"].startswith(
                    "attachment;")
    run(body())


def test_batch_delete_endpoint(tmp_path):
    """Server-side batch tombstone with per-fid results
    (volume_grpc_batch_delete.go:13-75)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            fids = []
            for i in range(3):
                a = await c.assign()
                st, _ = await c.put(a["fid"], a["url"], b"bd-%d" % i)
                assert st == 201
                fids.append((a["fid"], a["url"]))
            url = fids[0][1]
            gone = fids[0][0].split(",")[0] + ",ffffff00000000"
            async with c.http.post(
                    f"http://{url}/admin/batch_delete",
                    json={"fileIds": [f for f, _ in fids]
                          + ["not-a-fid", gone]}) as resp:
                assert resp.status == 200
                results = (await resp.json())["results"]
            by_fid = {r["fileId"]: r for r in results}
            for f, _ in fids:
                assert by_fid[f]["status"] == 202
                assert by_fid[f]["size"] > 0
            assert by_fid["not-a-fid"]["status"] == 400
            assert by_fid[gone]["status"] == 404
            for f, u in fids:
                st, _ = await c.get(f, u)
                assert st == 404
    run(body())
