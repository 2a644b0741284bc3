"""Filer server e2e over the in-proc cluster: auto-chunked uploads,
streaming range reads, listings, rename, recursive delete + chunk GC.

The cases of tests/test_filer_server.py pointed at the port's filer, its
master and its volume servers (tests/test_torch_cluster_util.py), and a
twin case: the same requests to a reference FilerServer on the
reference's cluster (tests/cluster_util.py) and to the port's on the
port's give the same statuses and bodies. Masked: chunk file ids (each
master assigns its own keys and random cookies) and the clock (Mtime,
Crtime, a chunk's mtime, Last-Modified and Date headers)."""

import asyncio
import json
import random

import cluster_util
from test_torch_cluster_util import Cluster, run


def _cluster(tmp_path, **kw):
    c = Cluster(str(tmp_path), **kw)
    c.with_filer = True
    return c


def test_upload_download_multi_chunk(tmp_path):
    async def body():
        async with _cluster(tmp_path) as c:
            f = c.filer
            rng = random.Random(9)
            # 3.5 chunks worth of data (chunk_size = 256KB)
            data = bytes(rng.getrandbits(8)
                         for _ in range(int(3.5 * 256 * 1024)))
            async with c.http.post(
                    f"http://{f.url}/docs/big.bin", data=data) as resp:
                assert resp.status == 201, await resp.text()
            # entry has 4 chunks
            async with c.http.get(f"http://{f.url}/__api__/lookup",
                                  params={"path": "/docs/big.bin"}) as resp:
                meta = await resp.json()
            assert len(meta["chunks"]) == 4
            assert meta["FileSize"] == len(data)
            # full read
            async with c.http.get(f"http://{f.url}/docs/big.bin") as resp:
                assert resp.status == 200
                got = await resp.read()
            assert got == data
            # range read across a chunk boundary
            start, ln = 256 * 1024 - 100, 300
            async with c.http.get(
                    f"http://{f.url}/docs/big.bin",
                    headers={"Range": f"bytes={start}-{start+ln-1}"}) as resp:
                assert resp.status == 206
                assert await resp.read() == data[start:start + ln]
            # suffix range
            async with c.http.get(
                    f"http://{f.url}/docs/big.bin",
                    headers={"Range": "bytes=-100"}) as resp:
                assert await resp.read() == data[-100:]
    run(body())


def test_listing_and_rename_and_delete(tmp_path):
    async def body():
        async with _cluster(tmp_path) as c:
            f = c.filer
            for name in ("a.txt", "b.txt"):
                async with c.http.post(f"http://{f.url}/dir/{name}",
                                       data=b"data-" + name.encode()) as r:
                    assert r.status == 201
            # directory listing
            async with c.http.get(f"http://{f.url}/dir") as resp:
                listing = await resp.json()
            assert [e["FullPath"] for e in listing["Entries"]] == \
                ["/dir/a.txt", "/dir/b.txt"]
            # rename directory
            async with c.http.post(f"http://{f.url}/moved",
                                   params={"mv.from": "/dir"}) as resp:
                assert resp.status == 200
            async with c.http.get(f"http://{f.url}/moved/a.txt") as resp:
                assert await resp.read() == b"data-a.txt"
            # recursive delete queues chunk GC
            async with c.http.delete(f"http://{f.url}/moved",
                                     params={"recursive": "true"}) as resp:
                assert resp.status == 204
            async with c.http.get(f"http://{f.url}/moved/a.txt") as resp:
                assert resp.status == 404
            # chunk GC drains: blobs eventually deleted from volume servers
            for _ in range(30):
                await asyncio.sleep(0.2)
                if not f._pending:
                    break
            assert not f._pending
    run(body())


def test_overwrite_gc_and_mkdir(tmp_path):
    async def body():
        async with _cluster(tmp_path) as c:
            f = c.filer
            async with c.http.post(f"http://{f.url}/f.bin",
                                   data=b"version-1") as r:
                assert r.status == 201
            async with c.http.get(f"http://{f.url}/__api__/lookup",
                                  params={"path": "/f.bin"}) as r:
                old_fid = (await r.json())["chunks"][0]["file_id"]
            async with c.http.post(f"http://{f.url}/f.bin",
                                   data=b"version-2!") as r:
                assert r.status == 201
            async with c.http.get(f"http://{f.url}/f.bin") as r:
                assert await r.read() == b"version-2!"
            assert old_fid in f._pending  # queued for GC
            # mkdir
            async with c.http.post(f"http://{f.url}/newdir",
                                   params={"mkdir": "true"}) as r:
                assert r.status == 201
            async with c.http.get(f"http://{f.url}/__api__/lookup",
                                  params={"path": "/newdir"}) as r:
                assert (await r.json())["IsDirectory"] is True
            # multipart upload form
            import aiohttp
            form = aiohttp.FormData()
            form.add_field("file", b"formdata", filename="form.txt",
                           content_type="text/plain")
            async with c.http.post(f"http://{f.url}/up.txt",
                                   data=form) as r:
                assert r.status == 201
            async with c.http.get(f"http://{f.url}/up.txt") as r:
                assert await r.read() == b"formdata"
                assert r.headers["Content-Type"].startswith("text/plain")
    run(body())


def test_sparse_file_streams_zero_filled_holes(tmp_path):
    """A hole between chunks must read back as zeros with a full-length
    body (filer2/stream.go semantics; the view clip jumps holes)."""
    async def body():
        async with _cluster(tmp_path) as c:
            f = c.filer
            from seaweedfs_tpu_torch.filer.filechunks import FileChunk
            from seaweedfs_tpu_torch.filer.entry import Attr, Entry
            import time as _t

            # store two real chunks, then register an entry whose chunk
            # list leaves a hole [10, 20)
            async with c.http.post(f"http://{f.url}/tmp/a", data=b"A" * 10) as r:
                assert r.status == 201
            async with c.http.post(f"http://{f.url}/tmp/b", data=b"B" * 10) as r:
                assert r.status == 201
            ea = f.filer.find_entry("/tmp/a")
            eb = f.filer.find_entry("/tmp/b")
            sparse = Entry("/sparse.bin", Attr(mtime=_t.time()), chunks=[
                FileChunk(ea.chunks[0].file_id, 0, 10, 1),
                FileChunk(eb.chunks[0].file_id, 20, 10, 2),
            ])
            f.filer.create_entry(sparse)
            async with c.http.get(f"http://{f.url}/sparse.bin") as resp:
                assert resp.status == 200
                got = await resp.read()
            assert got == b"A" * 10 + b"\x00" * 10 + b"B" * 10
            # range read starting inside the hole
            async with c.http.get(
                    f"http://{f.url}/sparse.bin",
                    headers={"Range": "bytes=15-24"}) as resp:
                assert resp.status == 206
                assert await resp.read() == b"\x00" * 5 + b"B" * 5
    run(body())


def test_filer_knobs_redirect_listing(tmp_path):
    """-redirectOnRead / -disableDirListing / -dirListLimit
    (command/filer.go:50-53)."""
    async def body():
        c = Cluster(str(tmp_path))
        c.with_filer = True
        async with c:
            f = c.filer
            async with c.http.post(f"http://{f.url}/d/one.bin",
                                   data=b"single-chunk") as r:
                assert r.status == 201
            # single-chunk GET redirects straight to the volume server
            f.redirect_on_read = True
            async with c.http.get(f"http://{f.url}/d/one.bin",
                                  allow_redirects=False) as resp:
                assert resp.status == 302
                loc = resp.headers["Location"]
            async with c.http.get(loc) as resp:
                assert await resp.read() == b"single-chunk"
            # ...but range reads still proxy (the redirect would lose
            # the filer's chunk-overlay semantics)
            async with c.http.get(
                    f"http://{f.url}/d/one.bin", allow_redirects=False,
                    headers={"Range": "bytes=0-5"}) as resp:
                assert resp.status == 206
            f.redirect_on_read = False

            # listing cap + kill switch
            f.dir_list_limit = 1
            async with c.http.get(f"http://{f.url}/d/",
                                  params={"limit": "1000"}) as resp:
                body_ = await resp.json()
                assert len(body_["Entries"]) == 1
            f.dir_list_limit = 100_000
            f.disable_dir_listing = True
            async with c.http.get(f"http://{f.url}/d/") as resp:
                assert resp.status == 405
            f.disable_dir_listing = False
    run(body())


_MASKED = {"file_id", "fileId", "fid", "mtime", "Mtime", "Crtime"}


def _mask(body):
    if isinstance(body, dict):
        return {k: ("masked" if k in _MASKED else _mask(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [_mask(v) for v in body]
    return body


async def _filer_transcript(c) -> list:
    """Writes (single- and multi-chunk), whole and
    Range reads across chunk boundaries, lookups, listings with paging,
    mkdir, rename of a file and of a directory, deletes, a 404."""
    f, http = c.filer, c.http
    rng = random.Random(21)
    files = {f"/t/d{i % 3}/f{i}.bin": rng.randbytes(rng.choice(
        [10, 1000, 1024, 2500, 5000])) for i in range(12)}
    out = []

    async def call(method, path, **kw):
        async with http.request(method, f"http://{f.url}{path}",
                                **kw) as r:
            body = await r.read()
            hdrs = {k: r.headers[k] for k in ("Content-Range",
                                              "Content-Length", "ETag")
                    if k in r.headers}
            try:
                # a JSON body's length moves with the masked fids
                body = _mask(json.loads(body))
                hdrs.pop("Content-Length", None)
            except ValueError:
                pass
            out.append([method, path, kw.get("params"),
                        kw.get("headers"), r.status, hdrs, body])

    # raw bodies: the reference's chunks of a multipart upload depend on
    # read timing (test_multipart_chunks_are_exact below)
    for path, data in sorted(files.items()):
        await call("POST", path, data=data)
    for path in sorted(files):
        await call("GET", path)
        await call("GET", "/__api__/lookup", params={"path": path})
        n = len(files[path])
        for start, end in ((0, 0), (1000, 1100), (1020, 2050),
                           (n - 5, n + 10)):
            await call("GET", path, headers={"Range": f"bytes={start}-{end}"})
        await call("GET", path, headers={"Range": "bytes=-300"})
    for d in ("/t", "/t/d0", "/t/d1"):
        await call("GET", d, params={"limit": "3"})
        await call("GET", d, params={"limit": "2", "lastFileName": "f3.bin"})
        await call("GET", "/__api__/list", params={"path": d})
    await call("POST", "/t/newdir/", params={})
    await call("POST", "/t/moved.bin", params={"mv.from": "/t/d0/f0.bin"})
    await call("POST", "/t/d9", params={"mv.from": "/t/d1"})
    await call("GET", "/t/moved.bin")
    await call("GET", "/t/d9/f4.bin")
    await call("GET", "/t/d1/f4.bin")
    await call("DELETE", "/t/d2/f2.bin")
    await call("DELETE", "/t/d9")
    await call("DELETE", "/t/d9", params={"recursive": "true"})
    await call("GET", "/t", params={"limit": "100"})
    await call("GET", "/nope")
    return out


def test_filer_server_twin_of_the_reference(tmp_path):
    """The same requests to a reference FilerServer (its cluster) and to
    the port's (the port's cluster), chunk size 1 KiB so that files span
    up to 5 chunks: equal statuses, headers and bodies."""
    async def body():
        out = {}
        for name, cls in (("ref", cluster_util.Cluster), ("port", Cluster)):
            c = cls(str(tmp_path / name), n_servers=2)
            c.with_filer = True
            c.filer_chunk_size = 1024
            async with c:
                out[name] = await _filer_transcript(c)
        assert len(out["port"]) == len(out["ref"])
        for got, want in zip(out["port"], out["ref"]):
            assert got == want
    run(body())


def test_multipart_chunks_are_exact(tmp_path):
    """A multipart upload (filer.copy's form) is cut into chunks of
    exactly the chunk size but the last, whatever sizes the multipart
    reader hands back: the port keeps a read's excess for the next
    chunk (the reference's chunks can run over by up to one read)."""
    async def body():
        c = _cluster(tmp_path, n_servers=1)
        c.filer_chunk_size = 4096
        async with c:
            f = c.filer
            rng = random.Random(4)
            for i, n in enumerate((1, 4095, 4096, 4097, 70_000, 200_001)):
                data = rng.randbytes(n)
                form = __import__("aiohttp").FormData()
                form.add_field("file", data, filename=f"m{i}.bin")
                async with c.http.post(f"http://{f.url}/m/m{i}.bin",
                                       data=form) as r:
                    assert r.status == 201, await r.text()
                async with c.http.get(f"http://{f.url}/__api__/lookup",
                                      params={"path": f"/m/m{i}.bin"}) as r:
                    meta = await r.json()
                sizes = [ch["size"] for ch in sorted(
                    meta["chunks"], key=lambda ch: ch["offset"])]
                assert sizes == [4096] * (n // 4096) + (
                    [n % 4096] if n % 4096 else []), (n, sizes)
                async with c.http.get(f"http://{f.url}/m/m{i}.bin") as r:
                    assert await r.read() == data
    run(body())
