"""Tiered storage: move sealed .dat to an S3-compatible remote; reads
flow through ranged GETs transparently.

Reference: weed/storage/backend/ (BackendStorage abstraction,
s3_backend.go ReadAt-over-ranged-GET), weed/storage/volume_tier.go,
server/volume_grpc_tier_upload.go/_download.go. The remote here is this
package's own S3 gateway — dogfooding the gateway as the object tier.

The cases of tests/test_tier.py pointed at the port's
storage/volume_tier.py, its storage backends and failpoints and its
volume servers (tests/test_torch_cluster_util.py). The remote store is
the port's own S3 gateway on the port's Filer."""

import asyncio
import concurrent.futures
import os
import time

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.s3.gateway import S3Gateway
from seaweedfs_tpu_torch.storage import backend as bk
from seaweedfs_tpu_torch.storage import volume_tier
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume, VolumeError
from seaweedfs_tpu_torch.util import failpoints
from seaweedfs_tpu_torch.util.batchframe import parse_all


@pytest.fixture(autouse=True)
def _clean_backends():
    bk.clear_backends()
    yield
    bk.clear_backends()


def test_tier_upload_read_download(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            # stand up an S3 gateway on the same cluster as the tier target
            s3 = S3Gateway(Filer("memory"), c.master.url, port=0)
            await s3.start()
            try:
                bk.load_backends({"s3": {"default": {
                    "endpoint": s3.url, "bucket": "tier"}}})
                # write some needles
                a = await c.assign()
                fids = [a["fid"]]
                st, _ = await c.put(a["fid"], a["url"], b"tiered-0")
                assert st == 201
                vid = a["fid"].split(",")[0]
                for i in range(1, 4):
                    f2 = f"{vid},{i+1:02x}deadbeef"
                    st, _ = await c.put(f2, a["url"], f"tiered-{i}".encode())
                    assert st == 201
                    fids.append(f2)

                # upload the volume's .dat to the s3 tier
                async with c.http.post(
                        f"http://{a['url']}/admin/tier/upload",
                        params={"volume": vid,
                                "backend": "s3.default"}) as resp:
                    body_ = await resp.json()
                    assert resp.status == 200, body_
                    assert body_["uploaded"] > 0
                vs = c.servers[0]
                v = vs.store.volumes[int(vid)]
                assert v.is_remote
                base = v.file_name()
                assert not os.path.exists(base + ".dat")  # moved away
                assert os.path.exists(base + ".vif")

                # reads now go through ranged GETs against the gateway
                for i, fid in enumerate(fids):
                    stc, data = await c.get(fid, a["publicUrl"])
                    assert stc == 200 and data == f"tiered-{i}".encode()

                # writes are rejected: volume is sealed
                st, _ = await c.put(f"{vid},77feedface", a["url"], b"nope")
                assert st in (409, 500)

                # bring it back down
                async with c.http.post(
                        f"http://{a['url']}/admin/tier/download",
                        params={"volume": vid}) as resp:
                    body_ = await resp.json()
                    assert resp.status == 200, body_
                assert not v.is_remote
                assert os.path.exists(base + ".dat")
                assert not os.path.exists(base + ".vif")
                stc, data = await c.get(fids[2], a["publicUrl"])
                assert stc == 200 and data == b"tiered-2"
            finally:
                await s3.stop()
    run(body())


def test_remote_volume_reload_from_vif(tmp_path):
    """A store restart re-opens tiered volumes from .idx + .vif alone."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            s3 = S3Gateway(Filer("memory"), c.master.url, port=0)
            await s3.start()
            try:
                bk.load_backends({"s3": {"default": {
                    "endpoint": s3.url, "bucket": "tier2"}}})
                vdir = str(tmp_path / "offline")

                # sync volume I/O does blocking HTTP to the in-loop
                # gateway, so it must run off the event loop
                def offline_work() -> None:
                    v = Volume(vdir, "", 9)
                    v.write_needle(
                        Needle(cookie=1, id=5, data=b"persisted"))
                    volume_tier.tier_upload(v, "s3.default")
                    v.close()
                    # reopen purely from .idx/.vif
                    v2 = Volume(vdir, "", 9, create_if_missing=False)
                    assert v2.is_remote
                    assert v2.read_needle(5).data == b"persisted"
                    with pytest.raises(VolumeError):
                        v2.write_needle(Needle(cookie=1, id=6, data=b"x"))
                    v2.close()

                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, offline_work)
            finally:
                await s3.stop()
    run(body())


def test_mmap_backend_tier_roundtrip(tmp_path):
    """The memory-mapped local backend (backend.py MmapBackendStorage,
    reference weed/storage/backend/memory_map/) as a tier target:
    upload -> mmap reads -> scan -> download, proving BackendStorage
    factory plurality beyond s3."""
    bk.load_backends({"mmap": {"hot": {"dir": str(tmp_path / "ram")}}})
    vdir = str(tmp_path / "vols")
    v = Volume(vdir, "", 6)
    for i in range(1, 6):
        v.write_needle(Needle(cookie=3, id=i, data=bytes([i]) * 500))
    uploaded = volume_tier.tier_upload(v, "mmap.hot")
    assert uploaded > 0
    assert v.is_remote
    assert not os.path.exists(os.path.join(vdir, "6.dat"))
    # reads flow through the mmap
    for i in range(1, 6):
        assert v.read_needle(i).data == bytes([i]) * 500
    # sequential scan over the mapped file
    seen = {}
    v.scan(lambda n, off: seen.__setitem__(n.id, len(n.data)))
    assert seen == {i: 500 for i in range(1, 6)}
    with pytest.raises(VolumeError):
        v.write_needle(Needle(cookie=3, id=9, data=b"x"))
    # bring it back
    volume_tier.tier_download(v)
    assert not v.is_remote and not v.read_only
    assert v.read_needle(2).data == b"\x02" * 500
    v.write_needle(Needle(cookie=3, id=9, data=b"back-home"))
    assert v.read_needle(9).data == b"back-home"
    v.close()


def test_remote_volume_scan_readahead(tmp_path):
    """scan() over a tiered volume walks every record through coalesced
    ranged GETs (the export/fix CLI path)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            s3 = S3Gateway(Filer("memory"), c.master.url, port=0)
            await s3.start()
            try:
                bk.load_backends({"s3": {"default": {
                    "endpoint": s3.url, "bucket": "tier4"}}})
                vdir = str(tmp_path / "scanme")

                def work():
                    v = Volume(vdir, "", 4)
                    for i in range(1, 21):
                        v.write_needle(Needle(
                            cookie=7, id=i, data=bytes([i]) * (100 * i)))
                    volume_tier.tier_upload(v, "s3.default")
                    v.close()
                    v2 = Volume(vdir, "", 4, create_if_missing=False)
                    assert v2.is_remote
                    gets = 0
                    inner = v2._pread

                    def counting(nbytes, offset):
                        nonlocal gets
                        gets += 1
                        return inner(nbytes, offset)
                    v2._pread = counting
                    seen = {}
                    v2.scan(lambda n, off: seen.__setitem__(n.id, n.data))
                    assert set(seen) == set(range(1, 21))
                    assert seen[20] == b"\x14" * 2000
                    # coalesced: whole ~30 KB volume in one ranged GET,
                    # not 2 per record
                    assert gets < 5, gets
                    v2.close()

                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, work)
            finally:
                await s3.stop()
    run(body())


def test_tier_read_failpoint_surfaces_error_not_hang(tmp_path):
    """Satellite: a degraded remote tier (tier.read armed with error /
    latency) must surface as a bounded read error through the normal
    OSError paths — never a wedged executor thread or a stale byte."""
    bk.load_backends({"mmap": {"hot": {"dir": str(tmp_path / "ram")}}})
    v = Volume(str(tmp_path / "vols"), "", 8)
    v.write_needle(Needle(cookie=4, id=1, data=b"cold-bytes" * 50))
    volume_tier.tier_upload(v, "mmap.hot")
    assert v.read_needle(1).data == b"cold-bytes" * 50
    try:
        failpoints.arm("tier.read", "error:*")
        t0 = time.monotonic()
        with pytest.raises(OSError):
            v.read_needle(1)
        assert time.monotonic() - t0 < 5.0, "degraded read hung"
        # latency action delays but completes, bytes still correct
        failpoints.arm("tier.read", "latency=50:2")
        assert v.read_needle(1).data == b"cold-bytes" * 50
    finally:
        failpoints.reset()
    assert v.read_needle(1).data == b"cold-bytes" * 50
    v.close()


def test_degraded_tier_read_keeps_server_responsive(tmp_path):
    """Cluster-level: with the remote tier erroring, reads of the
    tiered volume fail fast with an HTTP error while reads of a
    healthy local volume on the same server keep succeeding."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            bk.load_backends({"mmap": {"hot": {
                "dir": str(tmp_path / "ram")}}})
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"tiered-data")
            assert st == 201
            vid = a["fid"].split(",")[0]
            # a second volume that stays local
            b = await c.assign(collection="hot")
            st, _ = await c.put(b["fid"], b["url"], b"local-data")
            assert st == 201
            async with c.http.post(
                    f"http://{a['url']}/admin/tier/upload",
                    params={"volume": vid,
                            "backend": "mmap.hot"}) as resp:
                assert resp.status == 200, await resp.text()
            try:
                failpoints.arm("tier.read", "error:*")
                t0 = time.monotonic()
                stc, _ = await c.get(a["fid"], a["publicUrl"])
                assert stc >= 500, stc     # surfaced, not hung/stale
                assert time.monotonic() - t0 < 10.0
                stc, data = await c.get(b["fid"], b["publicUrl"])
                assert stc == 200 and data == b"local-data"
            finally:
                failpoints.reset()
            stc, data = await c.get(a["fid"], a["publicUrl"])
            assert stc == 200 and data == b"tiered-data"
    run(body())


def test_tier_upload_racing_reads_offline(tmp_path):
    """Satellite: tier_upload sealing a volume while reader threads
    hammer read_needle must stay byte-identical before/during/after
    the local->remote switch."""
    bk.load_backends({"mmap": {"hot": {"dir": str(tmp_path / "ram")}}})
    v = Volume(str(tmp_path / "vols"), "", 9)
    want = {i: bytes([i % 251]) * (400 + i * 13) for i in range(1, 41)}
    for i, data in want.items():
        v.write_needle(Needle(cookie=2, id=i, data=data))
    stop = False
    mismatches = []
    reads = [0]

    def reader():
        while not stop:
            for i, data in want.items():
                got = v.read_needle(i).data
                reads[0] += 1
                if got != data:
                    mismatches.append(i)
                    return

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(reader) for _ in range(3)]
        time.sleep(0.05)
        volume_tier.tier_upload(v, "mmap.hot")
        time.sleep(0.15)            # readers cross the switch
        stop = True
        for f in futs:
            f.result(timeout=30)
    assert not mismatches, mismatches
    assert reads[0] > len(want), "readers never overlapped the switch"
    assert v.is_remote
    for i, data in want.items():    # and after
        assert v.read_needle(i).data == data
    v.close()


def test_tier_upload_racing_batch_reads_cluster(tmp_path):
    """Satellite: concurrent single-GET and /batch requests in flight
    while /admin/tier/upload seals the volume stay byte-identical."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            bk.load_backends({"mmap": {"hot": {
                "dir": str(tmp_path / "ram")}}})
            a = await c.assign()
            vid = a["fid"].split(",")[0]
            fids = [a["fid"]]
            want = {a["fid"]: b"race-0" * 100}
            st, _ = await c.put(a["fid"], a["url"], want[a["fid"]])
            assert st == 201
            for i in range(1, 12):
                fid = f"{vid},{i + 1:02x}0badc0de"
                data = f"race-{i}".encode() * 100
                st, _ = await c.put(fid, a["url"], data)
                assert st == 201
                fids.append(fid)
                want[fid] = data
            stop = asyncio.Event()
            bad = []

            async def single_reader():
                while not stop.is_set():
                    for fid in fids:
                        stc, got = await c.get(fid, a["url"])
                        if stc != 200 or got != want[fid]:
                            bad.append(("single", fid, stc))
                            return

            async def batch_reader():
                url = f"http://{a['url']}/batch?fids=" + ",".join(fids)
                while not stop.is_set():
                    async with c.http.get(url) as resp:
                        blob = await resp.read()
                        if resp.status != 200:
                            bad.append(("batch", resp.status))
                            return
                    for meta, body_ in parse_all(blob):
                        if meta.get("status") != 200 or \
                                body_ != want[meta["fid"]]:
                            bad.append(("batch-row", meta))
                            return

            readers = [asyncio.create_task(single_reader()),
                       asyncio.create_task(batch_reader())]
            await asyncio.sleep(0.05)
            async with c.http.post(
                    f"http://{a['url']}/admin/tier/upload",
                    params={"volume": vid,
                            "backend": "mmap.hot"}) as resp:
                assert resp.status == 200, await resp.text()
            await asyncio.sleep(0.3)   # reads keep racing post-switch
            stop.set()
            await asyncio.gather(*readers)
            assert not bad, bad
            # and afterwards, straight through the remote tier
            for fid in fids:
                stc, got = await c.get(fid, a["url"])
                assert stc == 200 and got == want[fid]
    run(body())


def test_keep_local_stays_sealed_after_reopen(tmp_path):
    """tier.upload -keepLocal keeps the local .dat, but a restart must not
    resurrect the volume as writable (it would diverge from the remote)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            s3 = S3Gateway(Filer("memory"), c.master.url, port=0)
            await s3.start()
            try:
                bk.load_backends({"s3": {"default": {
                    "endpoint": s3.url, "bucket": "tier3"}}})
                vdir = str(tmp_path / "keep")

                def work():
                    v = Volume(vdir, "", 3)
                    v.write_needle(Needle(cookie=9, id=1, data=b"kept"))
                    volume_tier.tier_upload(v, "s3.default",
                                            keep_local=True)
                    v.close()
                    assert os.path.exists(os.path.join(vdir, "3.dat"))
                    v2 = Volume(vdir, "", 3, create_if_missing=False)
                    assert v2.read_only  # sealed via .vif presence
                    assert v2.read_needle(1).data == b"kept"
                    with pytest.raises(VolumeError):
                        v2.write_needle(Needle(cookie=9, id=2, data=b"x"))
                    # download restores writability and drops the .vif
                    volume_tier.tier_download(v2)
                    assert not v2.read_only
                    v2.write_needle(Needle(cookie=9, id=2, data=b"y"))
                    v2.close()

                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, work)
            finally:
                await s3.stop()
    run(body())
