"""Master HTTP surface parity: /submit, /{fid} redirect, /vol/status,
/vol/vacuum (master_server.go:108-121 route table).

The cases of tests/test_master_http.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

from test_torch_cluster_util import Cluster, run


def test_submit_and_fid_redirect(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            murl = f"http://{c.master.url}"
            # raw-body submit
            async with c.http.post(f"{murl}/submit",
                                   data=b"submitted-bytes") as resp:
                assert resp.status == 200, await resp.text()
                sub = await resp.json()
            assert sub["size"] == 15 and "," in sub["fid"]

            # GET master/<fid> redirects to a volume server that serves it
            async with c.http.get(f"{murl}/{sub['fid']}",
                                  allow_redirects=False) as resp:
                assert resp.status == 301
                loc = resp.headers["Location"]
            async with c.http.get(loc) as resp:
                assert resp.status == 200
                assert await resp.read() == b"submitted-bytes"

            # multipart submit keeps the client file name in the reply
            import aiohttp
            form = aiohttp.FormData()
            form.add_field("file", b"mp-bytes", filename="hello.bin",
                           content_type="application/x-thing")
            async with c.http.post(f"{murl}/submit", data=form) as resp:
                assert resp.status == 200, await resp.text()
                sub2 = await resp.json()
            assert sub2["fileName"] == "hello.bin" and sub2["size"] == 8

            # unknown volume 404s instead of redirecting
            async with c.http.get(f"{murl}/999,deadbeef",
                                  allow_redirects=False) as resp:
                assert resp.status == 404

            # /vol/status mirrors the topology dump
            async with c.http.get(f"{murl}/vol/status") as resp:
                assert resp.status == 200
                assert (await resp.json())["nodes"]

    run(body())


def test_heartbeat_does_not_self_admit_whitelist(tmp_path):
    """ADVICE round 5: an empty POST to /cluster/heartbeat used to
    record req.remote into _peer_ips BEFORE any validation, letting any
    client self-admit past -whiteList on /dir/lookup. Now only a
    parseable volume-server registration admits the sender."""
    import aiohttp

    from seaweedfs_tpu_torch.master.server import MasterServer

    async def body():
        m = MasterServer(port=0, white_list=["10.9.9.9"])
        await m.start()
        try:
            async with aiohttp.ClientSession() as http:
                murl = f"http://{m.url}"
                # garbage heartbeats: rejected, nothing admitted
                for payload in (b"", b"{}", b"[1,2]", b"{\"ip\": \"\"}"):
                    async with http.post(f"{murl}/cluster/heartbeat",
                                         data=payload) as resp:
                        assert resp.status == 400, await resp.text()
                assert not m._peer_ips
                async with http.get(
                        f"{murl}/dir/lookup",
                        params={"volumeId": "1"}) as resp:
                    assert resp.status == 401   # still whitelisted out
                # a real registration DOES admit the volume server
                from seaweedfs_tpu_torch.pb import messages as pb
                hb = pb.Heartbeat(ip="127.0.0.1", port=12345,
                                  public_url="127.0.0.1:12345")
                async with http.post(f"{murl}/cluster/heartbeat",
                                     json=hb.to_dict()) as resp:
                    assert resp.status == 200
                assert "127.0.0.1" in m._peer_ips
                async with http.get(
                        f"{murl}/dir/lookup",
                        params={"volumeId": "1"}) as resp:
                    assert resp.status == 404   # past the guard now
        finally:
            await m.stop()

    run(body())


def test_http_vacuum_trigger(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            murl = f"http://{c.master.url}"
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"x" * 2000)
            assert st == 201
            # a second needle in the same volume, then delete the first:
            # the volume now holds reclaimable garbage
            a2 = await c.assign()
            fid2 = f"{a['fid'].split(',')[0]},{a2['fid'].split(',')[1]}"
            await c.put(fid2, a["url"], b"y" * 100)
            assert await c.delete(a["fid"], a["url"]) in (200, 202)

            async with c.http.post(
                    f"{murl}/vol/vacuum",
                    params={"garbageThreshold": "0.01"}) as resp:
                assert resp.status == 200, await resp.text()
                out = await resp.json()
            vacuumed = {v["volume"] for v in out["vacuumed"]
                        if v.get("vacuumed")}
            assert int(a["fid"].split(",")[0]) in vacuumed
            # survivor still readable, deleted needle gone
            st, data = await c.get(fid2, a["url"])
            assert (st, data) == (200, b"y" * 100)
            st, _ = await c.get(a["fid"], a["url"])
            assert st == 404

    run(body())
