"""Wire-level tests of the needle fast path (server/fasthttp.py).

Raw sockets, no HTTP client library: these pin the hand-rolled parser's
behaviors — keep-alive sequencing, pipelined requests, the in-place
upgrade to aiohttp for cold requests (and BACK-comparison that both
paths serve identical bytes), mid-request replay upgrade (needle with
pairs), whitelist 401 on the fast write path, ts/ttl query handling.

The cases of tests/test_fasthttp.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
Its master assign case waits for the port's master.
"""

from __future__ import annotations

import asyncio
import json

from test_torch_cluster_util import Cluster, run


async def _raw(host: str, port: int, payload: bytes,
               expect_responses: int, timeout: float = 8.0) -> bytes:
    r, w = await asyncio.open_connection(host, port)
    w.write(payload)
    await w.drain()
    out = b""
    got = 0
    try:
        while got < expect_responses:
            # wait_for, not asyncio.timeout: 3.10 compatibility
            chunk = await asyncio.wait_for(r.read(65536), timeout)
            if not chunk:
                break
            out += chunk
            got = out.count(b"HTTP/1.1 ")
    finally:
        w.close()
    return out


def _req(method: str, path: str, host: str, body: bytes = b"",
         extra: str = "") -> bytes:
    head = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
            + (f"Content-Length: {len(body)}\r\n" if body or
               method in ("POST", "PUT") else "")
            + extra + "\r\n")
    return head.encode() + body


def test_fast_path_wire_behaviors(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            vs = c.servers[0]
            host = f"127.0.0.1:{vs.port}"
            fid = a["fid"]

            # 1. fast POST (raw body) then TWO pipelined GETs on one
            # connection — all three served by the fast protocol
            data = b"wire-level needle"
            blob = (_req("POST", f"/{fid}", host, data)
                    + _req("GET", f"/{fid}", host)
                    + _req("GET", f"/{fid}", host))
            out = await _raw("127.0.0.1", vs.port, blob, 3)
            assert out.count(b"HTTP/1.1 201 ") == 1
            assert out.count(b"HTTP/1.1 200 ") == 2
            assert out.count(data) == 2
            assert b'"eTag"' in out

            # 2. ts query param on the fast write path (a 2009 ts with a
            # TTL would read back expired, so ts is tested alone)
            a2 = await c.assign()
            blob = _req("POST", f"/{a2['fid']}?ts=1234567890",
                        host, b"ts-needle")
            out = await _raw("127.0.0.1", vs.port, blob, 1)
            assert b"201" in out.split(b"\r\n", 1)[0]
            n = vs.store.read_needle(
                int(a2["fid"].split(",")[0]),
                int(a2["fid"].split(",")[1][:-8], 16))
            assert n.last_modified == 1234567890
            # ...and ttl= flows into the stored needle
            a2b = await c.assign(ttl="5m")
            blob = _req("POST", f"/{a2b['fid']}?ttl=5m", host, b"ttlset")
            out = await _raw("127.0.0.1", vs.port, blob, 1)
            assert b"201" in out.split(b"\r\n", 1)[0]
            from seaweedfs_tpu_torch.storage import types as t
            n2 = vs.store.read_needle(
                int(a2b["fid"].split(",")[0]),
                int(a2b["fid"].split(",")[1][:-8], 16))
            assert n2.ttl == t.TTL.parse("5m")

            # 3. cold GET (Range header) upgrades in place and still
            # answers on the SAME connection, then a fast GET after the
            # upgrade keeps working through aiohttp
            blob = (_req("GET", f"/{fid}", host,
                         extra="Range: bytes=5-9\r\n")
                    + _req("GET", f"/{fid}", host))
            out = await _raw("127.0.0.1", vs.port, blob, 2)
            assert b"HTTP/1.1 206 " in out
            assert b"level" in out          # bytes 5-9 of the payload
            assert out.count(b"HTTP/1.1 200 ") == 1

            # 4. mid-request replay upgrade: a needle with pairs headers
            # must come back with its pair headers via the full handler
            a3 = await c.assign()
            async with c.http.post(
                    f"http://{a3['url']}/{a3['fid']}", data=b"paired",
                    headers={"Seaweed-Flavor": "umami"}) as resp:
                assert resp.status == 201
            out = await _raw("127.0.0.1", vs.port,
                             _req("GET", f"/{a3['fid']}", host), 1)
            assert b"Seaweed-Flavor: umami" in out
            assert b"paired" in out

            # 5. whitelist 401 applies on the fast write path — and its
            # declared Content-Length matches the body EXACTLY, so a
            # keep-alive client can fire a pipelined request right after
            # without blocking on a phantom byte (ADVICE round 5: the
            # header said 33 for a 32-byte body)
            from seaweedfs_tpu_torch.security.guard import Guard
            vs.guard = Guard(["10.9.9.9"])
            out = await _raw("127.0.0.1", vs.port,
                             _req("POST", f"/{fid}", host, b"x")
                             + _req("POST", f"/{fid}", host, b"y"), 2)
            assert out.count(b"401") >= 2
            hdr, rest = out.split(b"\r\n\r\n", 1)
            declared = int(hdr.lower().split(b"content-length: ")[1]
                           .split(b"\r\n")[0])
            body_1 = rest.split(b"HTTP/1.1", 1)[0]
            assert len(body_1) == declared == \
                len(b'{"error": "ip not in whitelist"}')
            vs.guard = Guard(())

            # 5b. a handler that dies before answering must CLOSE the
            # connection instead of wedging it busy forever (the
            # create_task done-callback); later connections still work
            real_count = vs.count
            vs.count = lambda *a: (_ for _ in ()).throw(
                RuntimeError("boom"))
            try:
                r2, w2 = await asyncio.open_connection(
                    "127.0.0.1", vs.port)
                w2.write(_req("GET", f"/{fid}", host))
                await w2.drain()
                eof = await asyncio.wait_for(r2.read(), 8)
                assert eof == b""       # closed, not hung
                w2.close()
            finally:
                vs.count = real_count
            out = await _raw("127.0.0.1", vs.port,
                             _req("GET", f"/{fid}", host), 1)
            assert out.startswith(b"HTTP/1.1 200 ")

            # 6. 404 for a missing needle stays on the fast path
            missing = fid.split(",")[0] + ",ffffffffdeadbeef"
            out = await _raw("127.0.0.1", vs.port,
                             _req("GET", f"/{missing}", host), 1)
            assert out.startswith(b"HTTP/1.1 404 ")

    run(body())

