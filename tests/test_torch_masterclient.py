"""wdclient MasterClient: watch-stream-fed vid→location map.

Reference: weed/wdclient/masterclient.go (KeepConnected consumer w/
failover) + vid_map.go (round-robin lookup).

The cases of tests/test_masterclient.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
The filer case runs the port's filer (and its MasterClient) against the
port's master and volume servers, and a case of the port's own client
(util/client.py attach_master_client) reads through the port's
MasterClient.
"""

import asyncio

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.util.masterclient import MasterClient


def test_masterclient_sync_and_deltas(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            # create a volume before the client connects (snapshot path)
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"watch me")
            assert st == 201
            vid = int(a["fid"].split(",")[0])

            mc = MasterClient(c.master.url, name="test")
            await mc.start()
            try:
                await mc.wait_synced()
                locs = mc.lookup(vid)
                assert any(loc.url == a["url"] for loc in locs)

                # lookup_file_id returns a URL that serves the blob
                url = mc.lookup_file_id(a["fid"])
                assert url is not None
                async with c.http.get(url) as resp:
                    assert resp.status == 200
                    assert await resp.read() == b"watch me"

                # delta path: grow a new volume after connect
                a2 = await c.assign(collection="wc")
                vid2 = int(a2["fid"].split(",")[0])
                for _ in range(50):
                    if mc.lookup(vid2):
                        break
                    await asyncio.sleep(0.1)
                assert mc.lookup(vid2), "new volume never reached watcher"

                # unknown vid
                assert mc.lookup(99999) == []
                assert mc.lookup_file_id("99999,deadbeef01") is None
            finally:
                await mc.stop()
    run(body())


def test_masterclient_round_robin(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign(replication="001")
            st, _ = await c.put(a["fid"], a["url"], b"rr")
            assert st == 201
            await c.heartbeat_all()
            vid = int(a["fid"].split(",")[0])
            mc = MasterClient(c.master.url)
            await mc.start()
            try:
                await mc.wait_synced()
                for _ in range(50):
                    if len(mc.lookup(vid)) == 2:
                        break
                    await asyncio.sleep(0.1)
                locs = mc.lookup(vid)
                assert len(locs) == 2
                # round-robin alternates replicas
                urls = {mc.lookup_file_id(a["fid"]) for _ in range(4)}
                assert len(urls) == 2
            finally:
                await mc.stop()
    run(body())


def test_filer_uses_watch_map(tmp_path):
    """Filer reads flow through the attached MasterClient map (the
    port's filer, under the port's master)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            from seaweedfs_tpu_torch.filer.filer import Filer
            from seaweedfs_tpu_torch.server.filer_server import FilerServer
            fs = FilerServer(Filer("memory"), c.master.url, port=0,
                             chunk_size=1024)
            await fs.start()
            try:
                await fs.master_client.wait_synced()
                payload = b"z" * 3000  # 3 chunks
                async with c.http.post(
                        f"http://{fs.url}/d/file.bin",
                        data=payload) as resp:
                    assert resp.status in (200, 201)
                async with c.http.get(
                        f"http://{fs.url}/d/file.bin") as resp:
                    assert resp.status == 200
                    assert await resp.read() == payload
                # the freshly-grown volume reaches the watch map once the
                # volume server's next heartbeat reports it
                for _ in range(50):
                    if fs.master_client.vid_count > 0:
                        break
                    await asyncio.sleep(0.1)
                assert fs.master_client.vid_count > 0
            finally:
                await fs.stop()
    run(body())


def test_client_uses_watch_map(tmp_path):
    """The port's WeedClient routes lookups through an attached port
    MasterClient: once the watch map holds the volume, a read needs no
    /dir/lookup round trip."""
    from seaweedfs_tpu_torch.util.client import WeedClient

    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            mc = MasterClient(c.master.url, name="client")
            await mc.start()
            try:
                async with WeedClient(c.master.url) as wc:
                    wc.attach_master_client(mc)
                    fid = await wc.upload_data(b"mapped bytes")
                    await c.heartbeat_all()
                    vid = int(fid.split(",")[0])
                    for _ in range(50):
                        if mc.lookup(vid):
                            break
                        await asyncio.sleep(0.1)
                    assert mc.lookup(vid)

                    async def no_master(vid):
                        raise AssertionError(f"/dir/lookup for {vid}")

                    wc._lookup_master = no_master
                    assert await wc.read(fid) == b"mapped bytes"
                    locs = await wc.lookup(str(vid))
                    assert [loc["url"] for loc in locs] == \
                        [loc.url for loc in mc.lookup(vid)]
            finally:
                await mc.stop()
    run(body())
