"""Hop-by-hop header discipline on the sibling proxy (satellite of the
binary-wire PR): RFC 7230 §6.1 connection-scoped headers and the
hop-specific entity headers (Content-Length, Content-Encoding, Date,
Server) must be stripped in BOTH directions by `proxy_request` (the
HTTP hop) and `proxy_request_frame` (the frame hop) — and the
mid-body-death path must abort the client transport instead of
splicing a 502 into needle bytes.

The cases of tests/test_hop_headers.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import asyncio
import json

import pytest
from aiohttp import web

from test_torch_cluster_util import run
from seaweedfs_tpu_torch.server import workers as wk
from seaweedfs_tpu_torch.util import tracing
from seaweedfs_tpu_torch.util.frame import (HELLO, HELLO_OK, MAGIC, REQ, RESP,
                                      FrameChannel, FrameDecoder,
                                      encode_frame)

# hop headers a peer might emit; each must never cross the proxy
_REQ_HOP = {
    "Connection": "keep-alive",
    "Keep-Alive": "timeout=7",
    "Proxy-Authorization": "Basic c3B5",
    "TE": "trailers",
    "Trailer": "X-T",
    "Upgrade": "h2c",
}
_RESP_HOP = {
    "Keep-Alive": "timeout=9",
    "Proxy-Authenticate": "Basic realm=x",
    "X-Entity": "survives",           # a normal header DOES cross
}


@pytest.fixture(autouse=True)
def _tracing_on():
    # the real worker middleware always has the proxy span open when
    # it forwards, which is what makes tracing.inject stamp the hop
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    yield
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()


async def _echo_sibling() -> tuple[web.AppRunner, str]:
    """Fake sibling: echoes the received request headers in its JSON
    body and emits hop-by-hop RESPONSE headers that must be eaten."""

    async def h(req: web.Request) -> web.Response:
        body = json.dumps({"seen": dict(req.headers),
                           "path": req.path}).encode()
        resp = web.Response(body=body, content_type="application/json")
        for k, v in _RESP_HOP.items():
            resp.headers[k] = v
        return resp

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", h)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"127.0.0.1:{port}"


async def _front(handler) -> tuple[web.AppRunner, int]:
    """Minimal aiohttp front whose handler proxies to the sibling —
    gives the proxy functions a REAL web.Request/transport."""
    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1]


def _assert_request_headers_clean(seen: dict) -> None:
    lower = {k.lower() for k in seen}
    for k in _REQ_HOP:
        assert k.lower() not in lower, f"request hop header {k} crossed"
    assert "x-custom" in lower           # ordinary headers DO cross
    assert "traceparent" in lower        # trace propagation rides along


def test_proxy_request_strips_hop_headers_both_directions(tmp_path):
    async def body():
        import aiohttp
        sib_runner, sib = await _echo_sibling()

        async def handler(req: web.Request):
            async with aiohttp.ClientSession() as session:
                with tracing.start_root("volume", "read"), \
                        tracing.start("proxy", "sibling"):
                    return await wk.proxy_request(req, session, sib,
                                                  "tok")

        front_runner, port = await _front(handler)
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get(
                        f"http://127.0.0.1:{port}/3,01deadbeef",
                        headers={**_REQ_HOP, "X-Custom": "yes"},
                        skip_auto_headers=("User-Agent",)) as r:
                    assert r.status == 200
                    got = json.loads(await r.read())
                    # direction 1: request hop headers never reached
                    # the sibling; the worker token DID
                    _assert_request_headers_clean(got["seen"])
                    assert got["seen"].get(wk.WORKER_HEADER) == "tok"
                    # direction 2: sibling's hop response headers were
                    # eaten, its entity header survived
                    assert "Proxy-Authenticate" not in r.headers
                    assert r.headers.get("Keep-Alive") != "timeout=9"
                    assert r.headers["X-Entity"] == "survives"
        finally:
            await front_runner.cleanup()
            await sib_runner.cleanup()
    run(body())


def test_proxy_request_frame_strips_hop_headers_both_directions():
    async def body():
        # frame echo sibling: replies with the received meta headers
        # in the body and hop headers in its response meta
        writers = set()

        async def conn(reader, writer):
            writers.add(writer)
            dec = FrameDecoder()
            try:
                while True:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                    if chunk.startswith(MAGIC):
                        chunk = chunk[len(MAGIC):]
                    for fr in dec.feed(chunk):
                        if fr.type == HELLO:
                            writer.write(encode_frame(
                                HELLO_OK, fr.req_id, {"v": 1}))
                        elif fr.type == REQ:
                            writer.write(encode_frame(
                                RESP, fr.req_id,
                                {"s": 200, "h": dict(_RESP_HOP),
                                 "ct": "application/json"},
                                json.dumps(
                                    {"seen": fr.meta.get("h", {}),
                                     "path": fr.meta.get("p")}
                                ).encode()))
                    await writer.drain()
            except (OSError, asyncio.CancelledError):
                pass
            finally:
                writers.discard(writer)
                writer.close()

        srv = await asyncio.start_server(conn, "127.0.0.1", 0)
        sport = srv.sockets[0].getsockname()[1]
        ch = FrameChannel(target=f"127.0.0.1:{sport}")

        async def handler(req: web.Request):
            with tracing.start_root("volume", "read"), \
                    tracing.start("proxy", "sibling"):
                return await wk.proxy_request_frame(req, ch)

        front_runner, port = await _front(handler)
        try:
            import aiohttp
            async with aiohttp.ClientSession() as http:
                async with http.get(
                        f"http://127.0.0.1:{port}/3,01deadbeef",
                        headers={**_REQ_HOP, "X-Custom": "yes"},
                        skip_auto_headers=("User-Agent",)) as r:
                    assert r.status == 200
                    got = json.loads(await r.read())
                    _assert_request_headers_clean(got["seen"])
                    # the frame hop carries the client address exactly
                    # like the HTTP hop
                    assert wk.FORWARDED_HEADER.lower() in got["seen"]
                    assert "Proxy-Authenticate" not in r.headers
                    assert r.headers.get("Keep-Alive") != "timeout=9"
                    assert r.headers["X-Entity"] == "survives"
        finally:
            await ch.close()
            await front_runner.cleanup()
            srv.close()
            await srv.wait_closed()
            for w in list(writers):
                w.close()
    run(body())


def test_proxy_mid_body_death_aborts_never_splices_502():
    """Sibling dies after the headers and part of the body: the proxy
    must sever the client transport (torn read), never emit a 502
    JSON — and the pre-body-death 502 must carry no hop headers."""
    async def body():
        import aiohttp

        async def conn(reader, writer):
            # raw sibling: declare 100 bytes, send 10, die
            await reader.read(65536)
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n"
                         b"Keep-Alive: timeout=9\r\n\r\n0123456789")
            await writer.drain()
            writer.close()

        srv = await asyncio.start_server(conn, "127.0.0.1", 0)
        sport = srv.sockets[0].getsockname()[1]

        async def handler(req: web.Request):
            async with aiohttp.ClientSession() as session:
                return await wk.proxy_request(
                    req, session, f"127.0.0.1:{sport}", "tok")

        front_runner, port = await _front(handler)
        try:
            async with aiohttp.ClientSession() as http:
                with pytest.raises((aiohttp.ClientError,
                                    asyncio.TimeoutError)):
                    async with http.get(
                            f"http://127.0.0.1:{port}/3,01beef",
                            timeout=aiohttp.ClientTimeout(total=10)
                            ) as r:
                        # headers may arrive (200, CL=100) but the
                        # body MUST tear — reading it raises
                        body_ = await r.read()
                        # a spliced 502 would surface as a short but
                        # "complete" read; reject that explicitly
                        assert len(body_) == 100, "spliced body"
        finally:
            await front_runner.cleanup()
            srv.close()
            await srv.wait_closed()

        # pre-body death (sibling unreachable): a clean 502 JSON with
        # no hop headers
        async def handler2(req: web.Request):
            async with aiohttp.ClientSession() as session:
                return await wk.proxy_request(
                    req, session, "127.0.0.1:9", "tok")

        front2, port2 = await _front(handler2)
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get(
                        f"http://127.0.0.1:{port2}/3,01beef") as r:
                    assert r.status == 502
                    assert "error" in await r.json()
                    for k in ("Keep-Alive", "Proxy-Authenticate",
                              "Transfer-Encoding"):
                        assert k not in r.headers
        finally:
            await front2.cleanup()
    run(body())
