"""WebDAV gateway protocol tests.

Reference behaviors: weed/server/webdav_server.go (FS ops over filer,
chunked file bodies) exercised through the DAV HTTP surface.

The cases of tests/test_webdav.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

import xml.etree.ElementTree as ET

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

DAV = "{DAV:}"


def _hrefs(xml_body: str) -> list[str]:
    root = ET.fromstring(xml_body)
    return [r.findtext(f"{DAV}href") for r in root.findall(f"{DAV}response")]


def test_webdav_crud_and_propfind(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            wd = WebDavServer(Filer("memory"), c.master.url, port=0,
                              chunk_size=64)  # force multi-chunk bodies
            await wd.start()
            base = f"http://{wd.url}"
            try:
                # OPTIONS advertises DAV compliance
                async with c.http.options(base + "/") as r:
                    assert r.status == 200
                    assert "PROPFIND" in r.headers["Allow"]
                    assert r.headers["DAV"].startswith("1")

                # MKCOL + nested MKCOL + missing-parent 409
                async with c.http.request("MKCOL", base + "/docs") as r:
                    assert r.status == 201
                async with c.http.request("MKCOL", base + "/docs/a") as r:
                    assert r.status == 201
                async with c.http.request("MKCOL", base + "/no/parent") as r:
                    assert r.status == 409

                # PUT a body larger than chunk_size -> multiple chunks
                payload = bytes(range(256)) * 3  # 768B over 64B chunks
                async with c.http.put(base + "/docs/a/file.bin",
                                      data=payload) as r:
                    assert r.status == 201
                entry = wd.filer.find_entry("/docs/a/file.bin")
                assert entry is not None and len(entry.chunks) > 1

                # GET full + ranged
                async with c.http.get(base + "/docs/a/file.bin") as r:
                    assert r.status == 200
                    assert await r.read() == payload
                async with c.http.get(
                        base + "/docs/a/file.bin",
                        headers={"Range": "bytes=100-199"}) as r:
                    assert r.status == 206
                    assert await r.read() == payload[100:200]

                # PROPFIND depth 1 on /docs lists the child dir
                async with c.http.request(
                        "PROPFIND", base + "/docs",
                        headers={"Depth": "1"}) as r:
                    assert r.status == 207
                    hrefs = _hrefs(await r.text())
                assert "/docs/" in hrefs and "/docs/a/" in hrefs
                # depth 0: only self
                async with c.http.request(
                        "PROPFIND", base + "/docs",
                        headers={"Depth": "0"}) as r:
                    assert len(_hrefs(await r.text())) == 1

                # getcontentlength is reported
                async with c.http.request(
                        "PROPFIND", base + "/docs/a/file.bin") as r:
                    body_txt = await r.text()
                assert f"{len(payload)}" in body_txt

                # MOVE (rename)
                async with c.http.request(
                        "MOVE", base + "/docs/a/file.bin",
                        headers={"Destination":
                                 base + "/docs/renamed.bin"}) as r:
                    assert r.status == 201
                async with c.http.get(base + "/docs/renamed.bin") as r:
                    assert await r.read() == payload
                async with c.http.get(base + "/docs/a/file.bin") as r:
                    assert r.status == 404

                # COPY makes an independent replica
                async with c.http.request(
                        "COPY", base + "/docs/renamed.bin",
                        headers={"Destination": base + "/docs/copy.bin"}
                        ) as r:
                    assert r.status == 201
                async with c.http.delete(base + "/docs/renamed.bin") as r:
                    assert r.status == 204
                async with c.http.get(base + "/docs/copy.bin") as r:
                    assert r.status == 200
                    assert await r.read() == payload

                # LOCK/UNLOCK round-trip
                async with c.http.request(
                        "LOCK", base + "/docs/copy.bin") as r:
                    assert r.status == 200
                    token = r.headers["Lock-Token"]
                    assert "opaquelocktoken" in token
                async with c.http.request(
                        "UNLOCK", base + "/docs/copy.bin",
                        headers={"Lock-Token": token}) as r:
                    assert r.status == 204

                # DELETE a directory tree
                async with c.http.delete(base + "/docs") as r:
                    assert r.status == 204
                async with c.http.request(
                        "PROPFIND", base + "/docs") as r:
                    assert r.status == 404

                # overwrite PUT returns 204 and supersedes content
                async with c.http.put(base + "/x.txt", data=b"v1") as r:
                    assert r.status == 201
                async with c.http.put(base + "/x.txt", data=b"v2!") as r:
                    assert r.status == 204
                async with c.http.get(base + "/x.txt") as r:
                    assert await r.read() == b"v2!"
            finally:
                await wd.stop()
    run(body())


def test_webdav_overwrite_false_precondition(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            wd = WebDavServer(Filer("memory"), c.master.url, port=0)
            await wd.start()
            base = f"http://{wd.url}"
            try:
                await c.http.put(base + "/a.txt", data=b"a")
                await c.http.put(base + "/b.txt", data=b"b")
                async with c.http.request(
                        "MOVE", base + "/a.txt",
                        headers={"Destination": base + "/b.txt",
                                 "Overwrite": "F"}) as r:
                    assert r.status == 412
                async with c.http.request(
                        "MOVE", base + "/a.txt",
                        headers={"Destination": base + "/b.txt"}) as r:
                    assert r.status == 204  # overwrote existing
                async with c.http.get(base + "/b.txt") as r:
                    assert await r.read() == b"a"
            finally:
                await wd.stop()
    run(body())


def test_put_chunks_are_exact(tmp_path):
    """A PUT whose body arrives in small pieces is stored in chunks of
    exactly chunk_size, the last one shorter: the port gathers each chunk
    before it uploads it (the reference uploads each short read)."""
    import asyncio

    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            wd = WebDavServer(Filer("memory"), c.master.url, port=0,
                              chunk_size=4096)
            await wd.start()
            payload = bytes(range(256)) * 70  # 17,920 B: 4 chunks + 1536

            async def trickle():
                for i in range(0, len(payload), 1000):
                    yield payload[i:i + 1000]
                    await asyncio.sleep(0.002)

            try:
                async with c.http.put(f"http://{wd.url}/slow.bin",
                                      data=trickle()) as r:
                    assert r.status == 201
                entry = wd.filer.find_entry("/slow.bin")
                assert [ch.size for ch in sorted(
                    entry.chunks, key=lambda ch: ch.offset)] == \
                    [4096] * 4 + [1536]
                async with c.http.get(f"http://{wd.url}/slow.bin") as r:
                    assert await r.read() == payload
            finally:
                await wd.stop()
    run(body())
