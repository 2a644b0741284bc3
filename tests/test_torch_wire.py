"""Unified wire layer (server/wire.py) through BOTH listeners.

The volume public port speaks the raw fast protocol; the aiohttp app
serves the same connection after an in-place upgrade. Both now route
GET/POST/DELETE/batch through ONE shared module — these tests pin that
the semantics (Range incl. suffix/open-ended/416/mid-body resume,
batch framing, zero-copy sendfile reads, group-commit writes) are
IDENTICAL regardless of which listener answers.

A request is forced onto the aiohttp path by sending a duplicate
header: the fast parser refuses duplicate headers and upgrades the
connection, byte-for-byte semantics preserved.

The cases of tests/test_wire.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from test_torch_cluster_util import Cluster, run
from seaweedfs_tpu_torch.util.batchframe import parse_all


async def _raw(host: str, port: int, payload: bytes,
               expect_responses: int, timeout: float = 8.0) -> bytes:
    r, w = await asyncio.open_connection(host, port)
    w.write(payload)
    await w.drain()
    out = b""
    got = 0
    try:
        while got < expect_responses:
            chunk = await asyncio.wait_for(r.read(65536), timeout)
            if not chunk:
                break
            out += chunk
            got = out.count(b"HTTP/1.1 ")
    finally:
        w.close()
    return out


def _req(method: str, path: str, host: str, body: bytes = b"",
         extra: str = "", cold: bool = False) -> bytes:
    """cold=True adds a duplicate header so the fast parser upgrades
    the connection to aiohttp — the way to A/B the two listeners."""
    if cold:
        extra += "X-Force-Cold: 1\r\nX-Force-Cold: 2\r\n"
    head = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
            + (f"Content-Length: {len(body)}\r\n" if body or
               method in ("POST", "PUT") else "")
            + extra + "\r\n")
    return head.encode() + body


def _split_one(out: bytes) -> tuple[int, dict, bytes]:
    """(status, lower-cased headers, body) of the FIRST response."""
    head, _, rest = out.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = int(lines[0].split()[1])
    headers: dict = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    cl = int(headers.get("content-length", "0"))
    return status, headers, rest[:cl]


async def _get(port: int, path: str, host: str, extra: str = "",
               cold: bool = False) -> tuple[int, dict, bytes]:
    """One GET over a fresh connection, reading the FULL body (large
    sendfile responses span many TCP chunks)."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(_req("GET", path, host, extra=extra, cold=cold))
    await w.drain()
    try:
        head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 8)
        status, headers, _ = _split_one(head + b"")
        cl = int(headers.get("content-length", "0"))
        body = await asyncio.wait_for(r.readexactly(cl), 8) if cl \
            else b""
    finally:
        w.close()
    return status, headers, body


def test_range_semantics_identical_on_both_listeners(tmp_path):
    """The PR-2 failover contract: suffix ranges, open-ended ranges,
    invalid-range 416 (with Content-Range total), and mid-body resume
    via Range — asserted byte-identical through the raw listener and
    the aiohttp listener."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            vs = c.servers[0]
            host = f"127.0.0.1:{vs.port}"
            fid = a["fid"]
            payload = bytes(range(256)) * 4          # 1024 bytes
            async with c.http.post(f"http://{a['url']}/{fid}",
                                   data=payload) as resp:
                assert resp.status == 201

            cases = [
                ("bytes=5-9", 206, payload[5:10], "bytes 5-9/1024"),
                ("bytes=1000-", 206, payload[1000:],
                 "bytes 1000-1023/1024"),          # open-ended tail
                ("bytes=-24", 206, payload[-24:],
                 "bytes 1000-1023/1024"),          # suffix range
                ("bytes=0-2000", 206, payload, "bytes 0-1023/1024"),
                ("", 200, payload, None),
            ]
            for hdr, want_status, want_body, want_cr in cases:
                for cold in (False, True):
                    extra = f"Range: {hdr}\r\n" if hdr else ""
                    st, hs, got = await _get(vs.port, f"/{fid}", host,
                                             extra=extra, cold=cold)
                    assert st == want_status, (hdr, cold, st)
                    assert got == want_body, (hdr, cold)
                    if want_cr:
                        assert hs.get("content-range") == want_cr, \
                            (hdr, cold, hs)
                    assert hs.get("accept-ranges") == "bytes"

            # invalid ranges: past-the-end and malformed => 416 with
            # the total in Content-Range, through both listeners
            for bad in ("bytes=2048-", "bytes=junk-x", "bytes=9-5"):
                for cold in (False, True):
                    st, hs, _ = await _get(vs.port, f"/{fid}", host,
                                           extra=f"Range: {bad}\r\n",
                                           cold=cold)
                    assert st == 416, (bad, cold)
                    assert hs.get("content-range") == "bytes */1024", \
                        (bad, cold, hs)

            # mid-body resume: read a prefix, then resume from the
            # exact byte reached — the replica-failover shape
            st, _, first = await _get(vs.port, f"/{fid}", host,
                                      extra="Range: bytes=0-511\r\n")
            assert st == 206 and first == payload[:512]
            for cold in (False, True):
                st, _, rest = await _get(
                    vs.port, f"/{fid}", host,
                    extra=f"Range: bytes={len(first)}-\r\n", cold=cold)
                assert st == 206 and first + rest == payload, cold

            # ETag parity across listeners (sendfile path derives it
            # from the stored footer checksum)
            st, h1, _ = await _get(vs.port, f"/{fid}", host)
            st, h2, _ = await _get(vs.port, f"/{fid}", host, cold=True)
            assert h1["etag"] == h2["etag"]

    run(body())


def test_batch_get_both_listeners_and_cache_hits(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            # the in-proc cluster store has no cache by default; arm
            # one so the hot round exercises inline batch cache hits
            from seaweedfs_tpu_torch.util.chunk_cache import NeedleCache
            vs.store.needle_cache = NeedleCache(8 << 20)
            host = f"127.0.0.1:{vs.port}"
            fids: list[str] = []
            bodies: dict[str, bytes] = {}
            for i in range(5):
                a = await c.assign()
                data = f"needle-{i}".encode() * (i + 1)
                async with c.http.post(f"http://{a['url']}/{a['fid']}",
                                       data=data) as resp:
                    assert resp.status == 201
                fids.append(a["fid"])
                bodies[a["fid"]] = data
            missing = fids[0].split(",")[0] + ",ffffffffdeadbeef"
            ask = fids[:3] + [missing] + fids[3:]

            for cold in (False, True):
                st, hs, raw = await _get(
                    vs.port, "/batch?fids=" + ",".join(ask), host,
                    cold=cold)
                assert st == 200, (cold, raw[:200])
                assert hs.get("x-batch-count") == str(len(ask))
                rows = parse_all(raw)
                assert [m["fid"] for m, _ in rows] == ask  # order kept
                for meta, got in rows:
                    if meta["fid"] == missing:
                        assert meta["status"] == 404
                    else:
                        assert meta["status"] == 200
                        assert got == bodies[meta["fid"]]
                        # etag identical to the single-GET etag
                        st2, h2, _ = await _get(
                            vs.port, f"/{meta['fid']}", host)
                        assert f'"{meta["etag"]}"' == h2["etag"]

            # POSTed JSON body form (long fid lists)
            async with c.http.post(
                    f"http://{host}/batch",
                    json={"fileIds": fids}) as resp:
                assert resp.status == 200
                rows = parse_all(await resp.read())
            assert [m["status"] for m, _ in rows] == [200] * len(fids)

            # second round is cache-hot: hits answered inline
            nc = vs.store.needle_cache
            hits_before = nc.counters.hits
            st, _, raw = await _get(
                vs.port, "/batch?fids=" + ",".join(fids), host)
            assert st == 200
            assert nc.counters.hits > hits_before

            # over -batch.max is refused, not truncated
            vs.batch_max = 3
            st, _, raw = await _get(
                vs.port, "/batch?fids=" + ",".join(ask), host)
            assert st == 413
            vs.batch_max = 256

    run(body())


def test_sendfile_cold_read_zero_copy(tmp_path):
    """A cold large needle on the raw listener goes out via the
    zero-copy ref path: identical bytes/ETag to the buffered aiohttp
    path, correct Range slicing, and the span says source=sendfile."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            vs.sendfile_min = 4096            # force the path w/o 64K+
            host = f"127.0.0.1:{vs.port}"
            a = await c.assign()
            fid = a["fid"]
            payload = bytes((i * 31 + 7) % 256 for i in range(100_000))
            async with c.http.post(f"http://{a['url']}/{fid}",
                                   data=payload) as resp:
                assert resp.status == 201
            # cold: the write invalidated any cache entry, so the read
            # below takes the ref/sendfile path on the raw listener
            from seaweedfs_tpu_torch.util import tracing
            st, hs, got = await _get(vs.port, f"/{fid}", host)
            assert st == 200 and got == payload
            spans = [s for tr in tracing.traces_dict(
                         recent=50, slowest=0)["traces"]
                     for s in tr["spans"]
                     if s.get("attrs", {}).get("source") == "sendfile"]
            assert spans, "no sendfile-attributed span recorded"
            # aiohttp twin (cold header upgrades the connection): the
            # app now drains the same NeedleRef via StreamResponse +
            # loop.sendfile — identical bytes/ETag, and the span still
            # says source=sendfile through THIS listener too
            vs.store.drop_cached_volume(
                int(fid.split(",")[0]))
            tracing.reset()
            st2, hs2, got2 = await _get(vs.port, f"/{fid}", host,
                                        cold=True)
            assert st2 == 200 and got2 == payload
            assert hs["etag"] == hs2["etag"]
            assert hs["content-length"] == hs2["content-length"]
            spans2 = [s for tr in tracing.traces_dict(
                          recent=50, slowest=0)["traces"]
                      for s in tr["spans"]
                      if s.get("attrs", {}).get("source") == "sendfile"]
            assert spans2, "aiohttp read did not take the ref path"
            # ranged aiohttp sendfile: kernel copy sliced
            vs.store.drop_cached_volume(int(fid.split(",")[0]))
            st2r, _, got2r = await _get(
                vs.port, f"/{fid}", host,
                extra="Range: bytes=90000-\r\n", cold=True)
            assert st2r == 206 and got2r == payload[90000:]
            # ranged sendfile: slice of the data region
            vs.store.drop_cached_volume(int(fid.split(",")[0]))
            st3, hs3, got3 = await _get(
                vs.port, f"/{fid}", host,
                extra="Range: bytes=90000-\r\n")
            assert st3 == 206 and got3 == payload[90000:]

            # pipelined request AFTER a sendfile response on the same
            # connection: the kernel copy must not desync the stream
            vs.store.drop_cached_volume(int(fid.split(",")[0]))
            r, w = await asyncio.open_connection("127.0.0.1", vs.port)
            w.write(_req("GET", f"/{fid}", host)
                    + _req("GET", f"/{fid}", host,
                           extra="Range: bytes=0-9\r\n"))
            await w.drain()
            blob = b""
            want = len(payload) + 10
            while blob.count(b"HTTP/1.1 ") < 2 or \
                    len(blob) < want:
                chunk = await asyncio.wait_for(r.read(65536), 8)
                if not chunk:
                    break
                blob += chunk
            w.close()
            assert blob.count(b"HTTP/1.1 200 ") == 1
            assert blob.count(b"HTTP/1.1 206 ") == 1
            assert blob.endswith(payload[:10])

    run(body())


def test_delete_on_raw_listener(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            host = f"127.0.0.1:{vs.port}"
            a = await c.assign()
            fid = a["fid"]
            out = await _raw(
                "127.0.0.1", vs.port,
                _req("POST", f"/{fid}", host, b"to-be-deleted")
                + _req("DELETE", f"/{fid}", host)
                + _req("GET", f"/{fid}", host), 3)
            assert out.count(b"HTTP/1.1 201 ") == 1
            assert b'"size"' in out
            assert out.count(b"HTTP/1.1 404 ") == 1

    run(body())


def test_group_commit_coalesces_concurrent_writes(tmp_path):
    """Concurrent writers to one volume land as shared batches: every
    write acked AND readable, and the appender saw batches bigger than
    one (the window makes coalescing deterministic under load)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            vs.store.group_commit_window = 0.02
            a = await c.assign(count=1)
            host = f"http://{a['url']}"
            fids = []
            for _ in range(24):
                aa = await c.assign()
                fids.append((aa["fid"], aa["url"]))

            async def put(fid: str, url: str, data: bytes):
                async with c.http.post(f"http://{url}/{fid}",
                                       data=data) as resp:
                    assert resp.status == 201, await resp.text()

            await asyncio.gather(*(
                put(fid, url, f"gc-{i}".encode() * 10)
                for i, (fid, url) in enumerate(fids)))
            stats = vs.store.group_commit_stats()
            assert stats["appended"] >= 24
            assert stats["max_batch"] > 1, stats
            # every acked write is durable + readable (cold, via raw)
            for i, (fid, url) in enumerate(fids):
                vs.store.drop_cached_volume(int(fid.split(",")[0]))
                async with c.http.get(f"http://{url}/{fid}") as resp:
                    assert resp.status == 200
                    assert await resp.read() == f"gc-{i}".encode() * 10

    run(body())


def test_group_commit_cookie_mismatch_fails_only_its_slot(tmp_path):
    """A bad write in a batch (wrong cookie on overwrite) fails alone;
    the good writes in the same group commit still land."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            vs.store.group_commit_window = 0.02
            a = await c.assign()
            fid = a["fid"]
            async with c.http.post(f"http://{a['url']}/{fid}",
                                   data=b"original") as resp:
                assert resp.status == 201
            vid = fid.split(",")[0]
            bad_fid = f"{vid},{fid.split(',')[1][:-8]}00000000"
            good = await c.assign()

            async def post(f, url, data):
                async with c.http.post(f"http://{url}/{f}",
                                       data=data) as resp:
                    return resp.status

            statuses = await asyncio.gather(
                post(bad_fid, a["url"], b"evil"),
                post(good["fid"], good["url"], b"fine"),
                post(fid, a["url"], b"overwrite-ok"))
            assert 409 in statuses        # cookie mismatch refused
            assert statuses.count(201) == 2
            async with c.http.get(
                    f"http://{a['url']}/{fid}") as resp:
                assert await resp.read() == b"overwrite-ok"

    run(body())


def test_manifest_conditional_304_and_batch_byte_budget(tmp_path):
    """A chunked-manifest GET honors If-None-Match with a 304 (the
    conditional checks run BEFORE manifest assembly, as in the
    reference), and /batch refuses to buffer past the byte budget —
    over-budget rows answer 413 so clients fall back to streamed
    single GETs."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            from seaweedfs_tpu_torch.util.chunked import upload_in_chunks
            from seaweedfs_tpu_torch.util.client import WeedClient
            host = f"127.0.0.1:{vs.port}"
            data = bytes((i * 13 + 5) % 256 for i in range(3_000_000))
            async with WeedClient(c.master.url) as wc:
                mfid, _ = await upload_in_chunks(wc, data, 1)
            st, hs, got = await _get(vs.port, f"/{mfid}", host)
            assert st == 200 and got == data      # assembled
            etag = hs["etag"]
            for cold in (False, True):
                st, _, got = await _get(
                    vs.port, f"/{mfid}", host,
                    extra=f"If-None-Match: {etag}\r\n", cold=cold)
                assert st == 304 and got == b"", cold
            # batch byte budget: three 1MB-ish chunk needles against a
            # 1.5MB budget -> some rows 413, none buffered past budget
            vs.batch_bytes_max = 1_500_000
            chunk_fids = []
            async with c.http.get(f"http://{host}/{mfid}?cm=false") as r:
                import json as _json
                man = _json.loads(await r.read())
                chunk_fids = [ch["fid"] for ch in man["chunks"]]
            st, _, raw = await _get(
                vs.port, "/batch?fids=" + ",".join(chunk_fids), host)
            assert st == 200
            rows = parse_all(raw)
            statuses = [m["status"] for m, _ in rows]
            assert 413 in statuses and 200 in statuses, statuses
            served = sum(len(b) for _, b in rows)
            assert served <= 1_500_000 + 1_048_576   # ≤ budget + 1 row
            vs.batch_bytes_max = 64 << 20

    run(body())


def test_conditional_and_pairs_identical_on_both_listeners(tmp_path):
    """304 (If-None-Match / If-Modified-Since) and stored-pairs
    headers behave identically through both listeners — they used to
    be two separate handler bodies."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            host = f"127.0.0.1:{vs.port}"
            a = await c.assign()
            fid = a["fid"]
            async with c.http.post(
                    f"http://{a['url']}/{fid}", data=b"cond-needle",
                    headers={"Seaweed-Color": "green"}) as resp:
                assert resp.status == 201
            st, hs, _ = await _get(vs.port, f"/{fid}", host)
            etag = hs["etag"]
            assert hs.get("seaweed-color") == "green"
            for cold in (False, True):
                st, hs2, got = await _get(
                    vs.port, f"/{fid}", host,
                    extra=f"If-None-Match: {etag}\r\n", cold=cold)
                assert st == 304 and got == b"", cold
                assert hs2.get("seaweed-color") == "green", cold
                lm = hs.get("last-modified")
                st, _, _ = await _get(
                    vs.port, f"/{fid}", host,
                    extra=f"If-Modified-Since: {lm}\r\n", cold=cold)
                assert st == 304, cold

    run(body())
