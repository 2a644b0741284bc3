"""Chunk-manifest files on raw volumes (no filer): auto-split upload,
manifest-resolved reads (full + ranged), cascading delete.

Reference: operation/submit.go:112-199, chunked_file.go,
volume_server_handlers_read.go:170-199.

The cases of tests/test_chunk_manifest.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries. A last case holds the manifest bytes and range
resolution to the JAX package's.
"""

import os

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.util.chunked import (ChunkInfo, ChunkManifest,
                                        upload_in_chunks)
from seaweedfs_tpu_torch.util.client import WeedClient


def test_manifest_marshal_load_resolve():
    cm = ChunkManifest(name="f.bin", mime="application/x-thing", size=25,
                       chunks=[ChunkInfo("1,02", 10, 10),
                               ChunkInfo("1,01", 0, 10),
                               ChunkInfo("1,03", 20, 5)])
    back = ChunkManifest.load(cm.marshal())
    assert back.size == 25 and back.name == "f.bin"
    assert [c.fid for c in back.chunks] == ["1,01", "1,02", "1,03"]  # sorted
    # range resolution straddling chunk boundaries
    pieces = back.resolve(5, 12)
    assert pieces == [("1,01", 5, 5, 5), ("1,02", 0, 7, 10)]
    assert back.resolve(0, 25)[-1] == ("1,03", 0, 5, 20)
    # gzip-aware load (LoadChunkManifest)
    import gzip
    assert ChunkManifest.load(gzip.compress(cm.marshal()),
                              is_gzipped=True).size == 25


def test_chunked_upload_read_range_delete(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            blob = os.urandom(300_000)
            async with WeedClient(c.master.url, session=c.http) as wc:
                fid, cm = await upload_in_chunks(
                    wc, blob, max_mb=1, name="big.bin",
                    mime="application/x-big")
                assert len(cm.chunks) == 1  # 300KB fits one 1MB chunk

                url = await wc.lookup_file_id(fid)
                # full read resolves the manifest transparently
                async with c.http.get(url) as resp:
                    assert resp.status == 200
                    assert resp.content_type == "application/x-big"
                    assert await resp.read() == blob

                # cm=false returns the raw manifest JSON
                async with c.http.get(url, params={"cm": "false"}) as resp:
                    body_ = await resp.read()
                    assert b'"chunks"' in body_

                # manifest fid reports the LOGICAL size on HEAD
                async with c.http.head(url) as resp:
                    assert int(resp.headers["Content-Length"]) == len(blob)
    run(body())


def test_chunked_multichunk_range_and_cascade_delete(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            blob = os.urandom(3 * 1024 * 1024 + 12345)  # 4 chunks at 1MB
            async with WeedClient(c.master.url, session=c.http) as wc:
                fid, cm = await upload_in_chunks(
                    wc, blob, max_mb=1, name="huge.bin")
                assert len(cm.chunks) == 4
                url = await wc.lookup_file_id(fid)

                async with c.http.get(url) as resp:
                    assert await resp.read() == blob

                # ranged read straddling a chunk boundary
                lo, ln = 1024 * 1024 - 100, 200
                async with c.http.get(
                        url, headers={"Range":
                                      f"bytes={lo}-{lo + ln - 1}"}) as resp:
                    assert resp.status == 206
                    assert await resp.read() == blob[lo:lo + ln]
                # suffix range
                async with c.http.get(
                        url, headers={"Range": "bytes=-50"}) as resp:
                    assert resp.status == 206
                    assert await resp.read() == blob[-50:]

                # deleting the manifest cascades to every chunk
                chunk_fids = [ch.fid for ch in cm.chunks]
                async with c.http.delete(url) as resp:
                    assert resp.status == 200
                for cf in chunk_fids:
                    curl = await wc.lookup_file_id(cf)
                    async with c.http.get(
                            curl, params={"cm": "false"}) as resp:
                        assert resp.status == 404, cf
    run(body())


def test_manifest_equals_the_reference():
    """The JAX package's ChunkManifest and the port's marshal the same
    manifest to the same bytes, load each other's, and resolve the same
    ranges to the same pieces."""
    import random
    from seaweedfs_tpu.util.chunked import ChunkInfo as RefChunkInfo
    from seaweedfs_tpu.util.chunked import ChunkManifest as RefChunkManifest
    rng = random.Random(6)
    for _ in range(20):
        sizes = [rng.randint(1, 50) for _ in range(rng.randint(1, 8))]
        offs = [sum(sizes[:i]) for i in range(len(sizes))]
        fids = [f"{rng.randint(1, 9)},{rng.getrandbits(40):x}"
                for _ in sizes]
        order = rng.sample(range(len(sizes)), len(sizes))
        port = ChunkManifest(name="f.bin", mime="a/b", size=sum(sizes),
                             chunks=[ChunkInfo(fids[i], offs[i], sizes[i])
                                     for i in order])
        ref = RefChunkManifest(name="f.bin", mime="a/b", size=sum(sizes),
                               chunks=[RefChunkInfo(fids[i], offs[i],
                                                    sizes[i])
                                       for i in order])
        assert port.marshal() == ref.marshal()
        assert ChunkManifest.load(ref.marshal()).marshal() == \
            RefChunkManifest.load(port.marshal()).marshal()
        for _ in range(10):
            off = rng.randint(0, sum(sizes) - 1)
            ln = rng.randint(1, sum(sizes) - off)
            assert ChunkManifest.load(port.marshal()).resolve(off, ln) == \
                RefChunkManifest.load(ref.marshal()).resolve(off, ln)
