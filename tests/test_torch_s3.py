"""S3 gateway e2e: buckets, objects, listing, multipart, copy, bulk delete.

Mirrors the coverage intent of s3api/filer_multipart_test.go and
s3api_objects_list_handlers_test.go, but against a live gateway + cluster.

The cases of tests/test_s3.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

import xml.etree.ElementTree as ET

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.s3.gateway import S3Gateway


class S3Cluster(Cluster):
    async def __aenter__(self):
        await super().__aenter__()
        self.s3 = S3Gateway(Filer("memory"), self.master.url, port=0,
                            chunk_size=128 * 1024)
        await self.s3.start()
        return self

    async def __aexit__(self, *exc):
        await self.s3.stop()
        await super().__aexit__(*exc)


def _tags(xml_body: bytes, tag: str) -> list[str]:
    root = ET.fromstring(xml_body)
    return [el.text for el in root.iter() if el.tag.endswith(tag)]


def test_bucket_and_object_lifecycle(tmp_path):
    async def body():
        async with S3Cluster(str(tmp_path)) as c:
            s3 = f"http://{c.s3.url}"
            async with c.http.put(f"{s3}/mybucket") as r:
                assert r.status == 200
            async with c.http.get(f"{s3}/") as r:
                assert "mybucket" in _tags(await r.read(), "Name")
            # put / get / head
            async with c.http.put(f"{s3}/mybucket/hello.txt",
                                  data=b"hello s3",
                                  headers={"Content-Type": "text/plain"}) as r:
                assert r.status == 200
                assert r.headers["ETag"]
            async with c.http.get(f"{s3}/mybucket/hello.txt") as r:
                assert r.status == 200
                assert await r.read() == b"hello s3"
                assert r.headers["Content-Type"].startswith("text/plain")
            async with c.http.head(f"{s3}/mybucket/hello.txt") as r:
                assert r.status == 200
                assert r.headers["Content-Length"] == "8"
            # range
            async with c.http.get(f"{s3}/mybucket/hello.txt",
                                  headers={"Range": "bytes=6-7"}) as r:
                assert r.status == 206
                assert await r.read() == b"s3"
            # delete
            async with c.http.delete(f"{s3}/mybucket/hello.txt") as r:
                assert r.status == 204
            async with c.http.get(f"{s3}/mybucket/hello.txt") as r:
                assert r.status == 404
            # missing bucket put
            async with c.http.put(f"{s3}/nobucket/x", data=b"z") as r:
                assert r.status == 404
    run(body())


def test_listing_prefix_delimiter(tmp_path):
    async def body():
        async with S3Cluster(str(tmp_path)) as c:
            s3 = f"http://{c.s3.url}"
            await c.http.put(f"{s3}/b")
            for key in ("docs/a.txt", "docs/b.txt", "docs/sub/c.txt",
                        "top.txt"):
                async with c.http.put(f"{s3}/b/{key}", data=b"x") as r:
                    assert r.status == 200
            # full listing (v2)
            async with c.http.get(f"{s3}/b", params={"list-type": "2"}) as r:
                keys = _tags(await r.read(), "Key")
            assert keys == ["docs/a.txt", "docs/b.txt", "docs/sub/c.txt",
                            "top.txt"]
            # prefix
            async with c.http.get(f"{s3}/b",
                                  params={"prefix": "docs/"}) as r:
                keys = _tags(await r.read(), "Key")
            assert keys == ["docs/a.txt", "docs/b.txt", "docs/sub/c.txt"]
            # delimiter folds directories
            async with c.http.get(
                    f"{s3}/b", params={"prefix": "docs/",
                                       "delimiter": "/"}) as r:
                body = await r.read()
            assert _tags(body, "Key") == ["docs/a.txt", "docs/b.txt"]
            assert _tags(body, "Prefix")[-1] == "docs/sub/"
            # max-keys truncation
            async with c.http.get(f"{s3}/b", params={"max-keys": "2",
                                                     "list-type": "2"}) as r:
                body = await r.read()
            assert _tags(body, "IsTruncated") == ["true"]
            assert len(_tags(body, "Key")) == 2
    run(body())


def test_multipart_upload(tmp_path):
    async def body():
        async with S3Cluster(str(tmp_path)) as c:
            s3 = f"http://{c.s3.url}"
            await c.http.put(f"{s3}/mp")
            async with c.http.post(f"{s3}/mp/big.bin",
                                   params={"uploads": ""}) as r:
                upload_id = _tags(await r.read(), "UploadId")[0]
            p1, p2 = b"A" * 200_000, b"B" * 123_456
            for num, data in ((1, p1), (2, p2)):
                async with c.http.put(
                        f"{s3}/mp/big.bin",
                        params={"partNumber": str(num),
                                "uploadId": upload_id},
                        data=data) as r:
                    assert r.status == 200
            async with c.http.get(f"{s3}/mp/big.bin",
                                  params={"uploadId": upload_id}) as r:
                assert _tags(await r.read(), "PartNumber") == ["1", "2"]
            # the in-progress upload shows in ListMultipartUploads
            async with c.http.get(f"{s3}/mp",
                                  params={"uploads": ""}) as r:
                body_ = await r.read()
                assert _tags(body_, "UploadId") == [upload_id]
                assert _tags(body_, "Key") == ["big.bin"]
            # ...scoped to its own bucket
            await c.http.put(f"{s3}/other")
            async with c.http.get(f"{s3}/other",
                                  params={"uploads": ""}) as r:
                assert _tags(await r.read(), "UploadId") == []
            async with c.http.post(f"{s3}/mp/big.bin",
                                   params={"uploadId": upload_id}) as r:
                assert r.status == 200
            async with c.http.get(f"{s3}/mp/big.bin") as r:
                got = await r.read()
            assert got == p1 + p2
            # parts dir cleaned up
            assert c.s3.filer.find_entry(
                f"/buckets/.uploads/{upload_id}") is None
    run(body())


def test_copy_and_bulk_delete(tmp_path):
    async def body():
        async with S3Cluster(str(tmp_path)) as c:
            s3 = f"http://{c.s3.url}"
            await c.http.put(f"{s3}/src")
            await c.http.put(f"{s3}/dst")
            async with c.http.put(f"{s3}/src/orig", data=b"copy me") as r:
                assert r.status == 200
            async with c.http.put(
                    f"{s3}/dst/copied",
                    headers={"x-amz-copy-source": "/src/orig"}) as r:
                assert r.status == 200
            async with c.http.get(f"{s3}/dst/copied") as r:
                assert await r.read() == b"copy me"
            # bulk delete
            xml_body = (b"<Delete><Object><Key>orig</Key></Object>"
                        b"<Object><Key>ghost</Key></Object></Delete>")
            async with c.http.post(f"{s3}/src", params={"delete": ""},
                                   data=xml_body) as r:
                deleted = _tags(await r.read(), "Key")
            assert "orig" in deleted
            async with c.http.get(f"{s3}/src/orig") as r:
                assert r.status == 404
            # copy unaffected by source delete
            async with c.http.get(f"{s3}/dst/copied") as r:
                assert await r.read() == b"copy me"
    run(body())


def test_virtual_host_style_addressing(tmp_path):
    """-domainName: Host: <bucket>.<domain> addressing
    (s3api_server.go:35-37)."""
    async def body():
        async with S3Cluster(str(tmp_path)) as c:
            c.s3.domain_name = "s3.example.com"
            s3 = f"http://{c.s3.url}"
            vh = {"Host": "vbuck.s3.example.com"}
            # PUT bucket.domain/ creates the bucket
            async with c.http.put(f"{s3}/", headers=vh) as r:
                assert r.status == 200
            # object lifecycle entirely host-style, incl. a nested key
            # whose first segment must not be mistaken for a bucket
            async with c.http.put(f"{s3}/a/b.txt", headers=vh,
                                  data=b"vh-bytes") as r:
                assert r.status in (200, 201), await r.text()
            async with c.http.get(f"{s3}/a/b.txt", headers=vh) as r:
                assert r.status == 200
                assert await r.read() == b"vh-bytes"
            # path-style still works side by side
            async with c.http.get(f"{s3}/vbuck/a/b.txt") as r:
                assert r.status == 200
                assert await r.read() == b"vh-bytes"
            # host-style bucket listing sees the key
            async with c.http.get(f"{s3}/", headers=vh,
                                  params={"list-type": "2"}) as r:
                assert "a/b.txt" in _tags(await r.read(), "Key")
            # a plain Host (no domain suffix) still lists buckets
            async with c.http.get(f"{s3}/") as r:
                assert "vbuck" in _tags(await r.read(), "Name")
            # host-style single-segment key (the h_bucket route)
            async with c.http.put(f"{s3}/top.txt", headers=vh,
                                  data=b"t") as r:
                assert r.status in (200, 201), await r.text()
            async with c.http.get(f"{s3}/top.txt", headers=vh) as r:
                assert await r.read() == b"t"
    run(body())


def test_standalone_chunk_gc_keeps_deleting(tmp_path):
    """A gateway with no FilerServer beside it drains its own chunk GC:
    the chunks of an object deleted seconds after start-up are deleted
    from the volume servers (the reference's loop drops every chunk freed
    after its first second)."""
    import asyncio

    async def body():
        async with S3Cluster(str(tmp_path)) as c:
            s3 = f"http://{c.s3.url}"
            async with c.http.put(f"{s3}/gcb") as r:
                assert r.status == 200
            async with c.http.put(f"{s3}/gcb/obj", data=b"x" * 300000) as r:
                assert r.status == 200
            fids = [ch.file_id for ch in c.s3.filer.find_entry(
                "/buckets/gcb/obj").chunks]
            await asyncio.sleep(2.5)  # past the GC loop's first rounds
            async with c.http.delete(f"{s3}/gcb/obj") as r:
                assert r.status == 204
            for _ in range(50):
                await asyncio.sleep(0.1)
                statuses = []
                for fid in fids:
                    locs = await c.s3.client.lookup(fid.split(",")[0])
                    st, _ = await c.get(fid, locs[0]["url"])
                    statuses.append(st)
                if all(st == 404 for st in statuses):
                    break
            assert statuses == [404] * len(fids)
    run(body())
