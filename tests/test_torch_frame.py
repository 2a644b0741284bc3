"""Binary frame wire (util/frame.py + server/frameserver.py).

Codec hardening (partial reassembly, torn/oversized/garbage corpus,
request-id reuse), the multiplexed channel (out-of-order completion,
FLAG_FALLBACK, fail-fast reconnect backoff), the sync pools'
max-idle/stale-retry discipline (the satellite connpool fix), and —
the acceptance bar — frame-vs-HTTP semantic parity against a REAL
in-proc volume server: byte-equal bodies through both transports,
Range/conditional/sendfile included, manifests downgrading to HTTP.

The cases of tests/test_frame.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio
import json
import random
import socket
import threading
import time

import pytest

from test_torch_cluster_util import Cluster, run
from seaweedfs_tpu_torch.util import failpoints as fp
from seaweedfs_tpu_torch.util.frame import (
    FLAG_FALLBACK, Frame, FrameChannel, FrameChannelError, FrameDecoder,
    FrameError, FrameFallback, FrameHub, HEADER_SIZE, HELLO, HELLO_OK,
    MAGIC, MAX_FRAME, MAX_META, REQ, RESP, encode_frame, overhead_model)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.reset()
    yield
    fp.reset()


# ---------------------------------------------------------------- codec

def test_codec_roundtrip_meta_payload_flags():
    raw = encode_frame(REQ, 7, {"m": "GET", "p": "/3,01ab",
                                "q": {"x": "1"}}, b"payload", flags=1)
    dec = FrameDecoder()
    frames = dec.feed(raw)
    assert len(frames) == 1
    f = frames[0]
    assert (f.type, f.flags, f.req_id) == (REQ, 1, 7)
    assert f.meta == {"m": "GET", "p": "/3,01ab", "q": {"x": "1"}}
    assert f.payload == b"payload"
    assert not dec.pending


def test_codec_empty_meta_and_payload():
    frames = FrameDecoder().feed(encode_frame(HELLO_OK, 0))
    assert frames[0].meta == {} and frames[0].payload == b""


def test_partial_reassembly_byte_by_byte():
    raw = encode_frame(RESP, 3, {"s": 200}, b"x" * 100)
    dec = FrameDecoder()
    out = []
    for i in range(len(raw)):
        out += dec.feed(raw[i:i + 1])
        if i < len(raw) - 1:
            assert not out, f"frame completed early at byte {i}"
    assert len(out) == 1 and out[0].payload == b"x" * 100
    assert not dec.pending


def test_many_frames_single_feed_and_split_boundary():
    frames_raw = b"".join(encode_frame(REQ, i, {"m": "GET"}, b"b%d" % i)
                          for i in range(5))
    dec = FrameDecoder()
    # split at a deliberately frame-misaligned point
    cut = HEADER_SIZE + 3
    got = dec.feed(frames_raw[:cut]) + dec.feed(frames_raw[cut:])
    assert [f.req_id for f in got] == list(range(5))
    assert [f.payload for f in got] == [b"b%d" % i for i in range(5)]


def test_torn_oversized_garbage_frames_raise():
    import struct
    # declared length below the 12-byte fixed section
    torn = struct.pack(">IBBHQ", 4, REQ, 0, 0, 1)
    with pytest.raises(FrameError):
        FrameDecoder().feed(torn)
    # oversized declared length
    huge = struct.pack(">IBBHQ", MAX_FRAME + 1, REQ, 0, 0, 1)
    with pytest.raises(FrameError):
        FrameDecoder().feed(huge)
    # meta length exceeding the frame
    lying = struct.pack(">IBBHQ", 20, REQ, 0, 4000, 1) + b"\0" * 16
    with pytest.raises(FrameError):
        FrameDecoder().feed(lying)
    # meta that is not JSON
    bad = struct.pack(">IBBHQ", 12 + 4, REQ, 0, 4, 1) + b"!!!!"
    with pytest.raises(FrameError):
        FrameDecoder().feed(bad)
    # meta that is JSON but not an object
    arr = b"[1]"
    bad2 = struct.pack(">IBBHQ", 12 + len(arr), REQ, 0, len(arr), 1) + arr
    with pytest.raises(FrameError):
        FrameDecoder().feed(bad2)
    # oversized meta blob refused at encode time too
    with pytest.raises(FrameError):
        encode_frame(REQ, 1, {"k": "v" * (MAX_META + 1)})


def test_garbage_corpus_never_hangs_or_leaks_exceptions():
    """Fuzz-ish corpus: random byte streams fed in random-sized chunks
    either decode (improbable) or raise FrameError — never any other
    exception, never an infinite loop. Seeded => deterministic."""
    rng = random.Random(0xF7A3E)
    for case in range(200):
        blob = bytes(rng.getrandbits(8)
                     for _ in range(rng.randrange(1, 400)))
        dec = FrameDecoder()
        pos = 0
        try:
            while pos < len(blob):
                step = rng.randrange(1, 64)
                dec.feed(blob[pos:pos + step])
                pos += step
        except FrameError:
            continue                  # the expected refusal
        # stream happened to parse as incomplete/valid frames: fine


def test_valid_frames_then_garbage_tear():
    raw = encode_frame(RESP, 1, {"s": 200}, b"ok") + b"\xffGARBAGE" * 4
    dec = FrameDecoder()
    with pytest.raises(FrameError):
        dec.feed(raw)


def test_decoder_counts_overhead_not_payload():
    dec = FrameDecoder()
    dec.feed(encode_frame(RESP, 1, {"s": 200}, b"z" * 500))
    meta_len = len(json.dumps({"s": 200}, separators=(",", ":")))
    assert dec.overhead_bytes == HEADER_SIZE + meta_len
    assert dec.frames == 1


def test_overhead_model_is_deterministic_and_small():
    a = overhead_model("GET", "/3,01637037d6",
                       resp_headers={"Etag": '"5f328b31"'})
    b = overhead_model("GET", "/3,01637037d6",
                       resp_headers={"Etag": '"5f328b31"'})
    assert a == b
    # the point of the wire: per-needle protocol overhead far below
    # a typical HTTP request+response header pair (~350+ bytes)
    assert a < 200


# ------------------------------------------------- channel (loopback)

class _EchoFrameServer:
    """Minimal in-test frame peer with scriptable behaviors."""

    def __init__(self):
        self.server = None
        self.port = 0
        self.delay_ids: dict[int, float] = {}
        self.drop_ids: set[int] = set()
        self.fallback_ids: set[int] = set()
        self.reverse_batch = 0       # answer every N reqs in reverse
        self._batch: list = []
        self.seen_req_ids: list[int] = []
        self._writers: set = set()

    async def __aenter__(self):
        self.server = await asyncio.start_server(
            self._conn, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self.server.close()
        await self.server.wait_closed()
        for w in list(self._writers):  # sever live connections too
            w.close()

    async def _conn(self, reader, writer):
        self._writers.add(writer)
        dec = FrameDecoder()
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    return
                if dec.frames == 0 and bytes(dec._buf) == b"" and \
                        chunk.startswith(MAGIC):
                    chunk = chunk[len(MAGIC):]
                for fr in dec.feed(chunk):
                    await self._handle(fr, writer)
        except (FrameError, OSError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _handle(self, fr: Frame, writer):
        if fr.type == HELLO:
            writer.write(encode_frame(HELLO_OK, fr.req_id, {"v": 1}))
            await writer.drain()
            return
        if fr.type != REQ:
            return
        self.seen_req_ids.append(fr.req_id)
        if fr.req_id in self.drop_ids:
            return                    # never answer: client times out
        if fr.req_id in self.fallback_ids:
            writer.write(encode_frame(RESP, fr.req_id, {"s": 421},
                                      flags=FLAG_FALLBACK))
            await writer.drain()
            return
        resp = encode_frame(
            RESP, fr.req_id,
            {"s": 200, "h": {"x-echo": fr.meta.get("p", "")}},
            fr.payload or fr.meta.get("p", "").encode())
        if self.reverse_batch > 1:
            self._batch.append((fr.req_id, resp))
            if len(self._batch) >= self.reverse_batch:
                for _, r in reversed(self._batch):
                    writer.write(r)
                self._batch.clear()
                await writer.drain()
            return
        delay = self.delay_ids.get(fr.req_id, 0)
        if delay:
            await asyncio.sleep(delay)
        writer.write(resp)
        await writer.drain()


def test_channel_pipelines_and_completes_out_of_order():
    async def body():
        async with _EchoFrameServer() as srv:
            srv.reverse_batch = 4     # hold 4, answer newest-first
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                results = await asyncio.gather(*(
                    ch.request("GET", f"/path-{i}") for i in range(4)))
                for i, (st, hdrs, body_) in enumerate(results):
                    assert st == 200
                    assert body_ == f"/path-{i}".encode()
                    assert hdrs["x-echo"] == f"/path-{i}"
                # all four multiplexed over ONE connection
                assert ch.stats.connects == 1
                assert ch.stats.requests == 4
            finally:
                await ch.close()
    run(body())


def test_channel_flag_fallback_raises_framefallback():
    async def body():
        async with _EchoFrameServer() as srv:
            srv.fallback_ids = {1}
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                with pytest.raises(FrameFallback):
                    await ch.request("GET", "/x")
                # FrameFallback IS a FrameChannelError (single except
                # arm downgrades to HTTP in every caller)
                assert issubclass(FrameFallback, FrameChannelError)
                st, _, _ = await ch.request("GET", "/y")  # channel fine
                assert st == 200
            finally:
                await ch.close()
    run(body())


def test_request_id_reuse_after_timeout_and_wraparound():
    """A timed-out id must not poison its successor: the late response
    for the dead id is discarded, and the 32-bit id counter wraps
    through (skipping 0) without colliding."""
    async def body():
        async with _EchoFrameServer() as srv:
            srv.drop_ids = {1}
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                with pytest.raises(FrameChannelError):
                    await ch.request("GET", "/dead", timeout=0.2)
                # id 1 timed out; later reuse of the SLOT is clean
                st, _, got = await ch.request("GET", "/alive")
                assert st == 200 and got == b"/alive"
                # wraparound: next id after 0xFFFFFFFF is 1, never 0
                # (and the reused id 1 must answer normally now)
                srv.drop_ids = set()
                ch._next_id = 0xFFFFFFFF
                st, _, _ = await ch.request("GET", "/wrap")
                assert st == 200
                assert ch._next_id == 1
                st, _, _ = await ch.request("GET", "/wrapped")
                assert st == 200
                assert srv.seen_req_ids[-2:] == [0xFFFFFFFF, 1]
            finally:
                await ch.close()
    run(body())


def test_channel_fail_fast_backoff_then_reconnect():
    async def body():
        async with _EchoFrameServer() as srv:
            port = srv.port
            ch = FrameChannel(target=f"127.0.0.1:{port}")
            st, _, _ = await ch.request("GET", "/up")
            assert st == 200
            await srv.__aexit__()
            # sever: in-flight-free channel notices on next use
            with pytest.raises(FrameChannelError):
                await ch.request("GET", "/down", timeout=1.0)
            # backoff window open: fails in microseconds, no connect
            t0 = time.monotonic()
            with pytest.raises(FrameChannelError):
                await ch.request("GET", "/fast-fail")
            assert time.monotonic() - t0 < 0.05
            # peer returns on the same port; after the window, the
            # channel transparently reconnects
            srv2 = _EchoFrameServer()
            srv2.server = await asyncio.start_server(
                srv2._conn, "127.0.0.1", port)
            try:
                deadline = time.monotonic() + 5
                while True:
                    try:
                        st, _, _ = await ch.request("GET", "/back")
                        break
                    except FrameChannelError:
                        assert time.monotonic() < deadline
                        await asyncio.sleep(0.05)
                assert st == 200 and ch.stats.connects == 2
            finally:
                await ch.close()
                srv2.server.close()
                await srv2.server.wait_closed()
    run(body())


def test_worker_frame_failpoint_fires_on_request():
    async def body():
        async with _EchoFrameServer() as srv:
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                fp.arm("worker.frame", "error:1")
                with pytest.raises(OSError):
                    await ch.request("GET", "/x")
                st, _, _ = await ch.request("GET", "/x")
                assert st == 200
            finally:
                await ch.close()
    run(body())


def test_hub_caches_and_bounds_channels():
    async def body():
        hub = FrameHub()
        try:
            a = hub.get(target="127.0.0.1:1")
            assert hub.get(target="127.0.0.1:1") is a
            for i in range(2, FrameHub.MAX_CHANNELS + 2):
                hub.get(target=f"127.0.0.1:{i}")
            assert len(hub._channels) <= FrameHub.MAX_CHANNELS
        finally:
            await hub.close()
    run(body())


# ------------------------------------------------- sync pools

def test_idle_pool_max_idle_eviction():
    from seaweedfs_tpu_torch.util.connpool import _IdlePool

    class _C:
        closed = False

        def close(self):
            self.closed = True

    pool = _IdlePool(per_target=4, max_idle_s=0.05)
    c1 = _C()
    pool.give("t", c1)
    assert pool.take("t") is c1       # fresh: reused
    pool.give("t", c1)
    time.sleep(0.08)
    assert pool.take("t") is None     # parked too long: evicted...
    assert c1.closed                  # ...and closed, not leaked


def test_idle_pool_drop_target_closes_all():
    from seaweedfs_tpu_torch.util.connpool import _IdlePool

    class _C:
        closed = False

        def close(self):
            self.closed = True

    pool = _IdlePool(per_target=4, max_idle_s=60)
    conns = [_C() for _ in range(3)]
    for c in conns:
        pool.give("t", c)
    pool.give("other", _C())
    pool.drop_target("t")
    assert all(c.closed for c in conns)
    assert pool.take("t") is None
    assert pool.take("other") is not None   # other targets untouched


def _http_server_that_closes_after_each_response():
    """Keep-alive-claiming HTTP server that actually closes every
    connection after one response — the respawned-sibling shape that
    poisons a pooled socket."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    served = []

    def loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                conn.recv(65536)
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n"
                             b"\r\nok")
                served.append(1)
            finally:
                conn.close()

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return srv, port, served


def test_sync_http_pool_retries_stale_and_drains_target():
    from seaweedfs_tpu_torch.util.connpool import SyncHttpPool
    srv, port, served = _http_server_that_closes_after_each_response()
    try:
        pool = SyncHttpPool(timeout=5)
        target = f"127.0.0.1:{port}"
        st, body = pool.request(target, "/a")
        assert (st, body) == (200, b"ok")
        # server closed the socket; the pool may have parked it (the
        # response did not declare close) — next request must retry
        # fresh instead of surfacing the stale-socket error
        st, body = pool.request(target, "/b")
        assert (st, body) == (200, b"ok")
        pool.close()
    finally:
        srv.close()


def test_sync_frame_pool_refuses_http_peer_as_unsupported():
    from seaweedfs_tpu_torch.util.connpool import (FrameUnsupported,
                                             SyncFramePool)
    srv, port, _ = _http_server_that_closes_after_each_response()
    try:
        pool = SyncFramePool(timeout=5)
        with pytest.raises(FrameUnsupported):
            pool.request(f"127.0.0.1:{port}", "/admin/ec/shard_read",
                         query={"volume": "1", "reads": "0:0:10"})
        pool.close()
    finally:
        srv.close()


def test_sync_frame_pool_roundtrip_and_stale_retry(tmp_path):
    """SyncFramePool against the REAL frame listener: a pooled
    connection severed between uses is retried fresh (the respawn
    shape), and the reads come back byte-equal."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            vs = c.servers[0]
            payload = b"sync-frame-pool" * 10
            st, _ = await c.put(a["fid"], a["url"], payload)
            assert st == 201
            from seaweedfs_tpu_torch.util.connpool import SyncFramePool
            pool = SyncFramePool(timeout=10)
            target = f"127.0.0.1:{vs.port}"

            def fetch():
                return pool.request(target, "/" + a["fid"])

            st, body_ = await asyncio.to_thread(fetch)
            assert (st, body_) == (200, payload)
            # sever the parked connection under the pool
            for _, conn in pool._pool._idle.get(target, []):
                conn.sock.close()
            st, body_ = await asyncio.to_thread(fetch)
            assert (st, body_) == (200, payload)
            pool.close()
    run(body())


# --------------------------------------- frame vs HTTP semantic parity

async def _frame_get(ch, path, headers=None):
    return await ch.request("GET", path, headers=headers)


def test_frame_parity_with_http_listener(tmp_path):
    """The acceptance bar: the SAME needles served over the frame
    adapter and the HTTP listeners are byte-equal — plain, ranged
    (suffix/open-ended), conditional 304, HEAD, 404 and the sendfile
    cold path included."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            vs = c.servers[0]
            fid = a["fid"]
            payload = bytes(range(256)) * 4
            st, _ = await c.put(fid, a["url"], payload)
            assert st == 201
            big = await c.assign()
            bigbody = bytes((i * 131 + 17) % 256 for i in range(300_000))
            st, _ = await c.put(big["fid"], big["url"], bigbody)
            assert st == 201

            ch = FrameChannel(target=f"127.0.0.1:{vs.port}")
            try:
                # plain read
                fst, fh, fbody = await _frame_get(ch, "/" + fid)
                async with c.http.get(
                        f"http://{a['url']}/{fid}") as r:
                    hbody = await r.read()
                    assert (fst, fbody) == (r.status, hbody)
                    assert fh["Etag"] == r.headers["Etag"]
                # ranges: suffix, open-ended, bounded
                for rng, want in (("bytes=5-9", payload[5:10]),
                                  ("bytes=1000-", payload[1000:]),
                                  ("bytes=-24", payload[-24:])):
                    fst, fh, fbody = await _frame_get(
                        ch, "/" + fid, headers={"range": rng})
                    async with c.http.get(
                            f"http://{a['url']}/{fid}",
                            headers={"Range": rng}) as r:
                        assert fst == r.status == 206
                        assert fbody == await r.read() == want
                        assert fh["Content-Range"] == \
                            r.headers["Content-Range"]
                # conditional 304
                fst, fh, fbody = await _frame_get(ch, "/" + fid)
                etag = fh["Etag"]
                fst, _, fbody = await _frame_get(
                    ch, "/" + fid, headers={"if-none-match": etag})
                assert (fst, fbody) == (304, b"")
                # HEAD: headers, no body — parity with the HTTP
                # listener's HEAD answer (same status, same Etag)
                hst, hh, hb = await ch.request("HEAD", "/" + fid)
                assert hst == 200 and hb == b""
                async with c.http.head(
                        f"http://{a['url']}/{fid}") as r:
                    assert r.status == 200
                    assert hh["Etag"] == r.headers["Etag"]
                # 404
                missing = fid.split(",")[0] + ",ffffffffdeadbeef"
                fst, _, _ = await _frame_get(ch, "/" + missing)
                assert fst == 404
                # sendfile cold path: large body, frame-declared
                # length, byte-equal with the HTTP listener
                fst, fh, fbody = await _frame_get(ch, "/" + big["fid"])
                assert fst == 200 and fbody == bigbody
                assert ch.stats.payload_in >= len(bigbody)
                # ranged sendfile slice
                fst, _, fbody = await _frame_get(
                    ch, "/" + big["fid"],
                    headers={"range": "bytes=250000-"})
                assert fst == 206 and fbody == bigbody[250000:]
                # pipelined-after-sendfile: the frame stream stays in
                # sync after a sendfile payload
                results = await asyncio.gather(
                    _frame_get(ch, "/" + big["fid"]),
                    _frame_get(ch, "/" + fid),
                    _frame_get(ch, "/" + fid))
                assert results[0][2] == bigbody
                assert results[1][2] == results[2][2] == payload
                assert ch.stats.connects == 1
            finally:
                await ch.close()
    run(body())


def test_frame_write_delete_parity(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            ch = FrameChannel(target=f"127.0.0.1:{vs.port}")
            try:
                a = await c.assign()
                st, _, body_ = await ch.request(
                    "POST", "/" + a["fid"], body=b"frame-written")
                assert st == 201, body_
                fsize = json.loads(body_)["size"]
                # same-length HTTP write reports the same stored size
                b2 = await c.assign()
                hst, hbody = await c.put(b2["fid"], b2["url"],
                                         b"http--written")
                assert hst == 201 and hbody["size"] == fsize
                # readback over BOTH transports
                fst, _, fbody = await ch.request("GET", "/" + a["fid"])
                async with c.http.get(
                        f"http://{a['url']}/{a['fid']}") as r:
                    assert fbody == await r.read() == b"frame-written"
                    assert fst == r.status == 200
                st, _, _ = await ch.request("DELETE", "/" + a["fid"])
                assert st == 200
                fst, _, _ = await ch.request("GET", "/" + a["fid"])
                assert fst == 404
            finally:
                await ch.close()
    run(body())


def test_frame_manifest_read_downgrades_to_http(tmp_path):
    """A chunked-manifest GET cannot stream over one frame: the server
    answers FLAG_FALLBACK and the client retries over HTTP — the
    exact degradation an old peer produces."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            from seaweedfs_tpu_torch.util.chunked import upload_in_chunks
            from seaweedfs_tpu_torch.util.client import WeedClient
            data = bytes((i * 13 + 5) % 256 for i in range(300_000))
            async with WeedClient(c.master.url) as wc:
                mfid, _ = await upload_in_chunks(wc, data, 1)
            ch = FrameChannel(target=f"127.0.0.1:{vs.port}")
            try:
                with pytest.raises(FrameFallback):
                    await ch.request("GET", "/" + mfid)
                assert ch.stats.fallbacks == 1
                # HTTP serves the assembled file
                async with c.http.get(
                        f"http://127.0.0.1:{vs.port}/{mfid}") as r:
                    assert r.status == 200
                    assert await r.read() == data
            finally:
                await ch.close()
    run(body())


def test_frame_batch_parity(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            fids = {}
            for i in range(5):
                a = await c.assign()
                body_ = f"batch-{i}-".encode() * 20
                st, _ = await c.put(a["fid"], a["url"], body_)
                assert st == 201
                fids[a["fid"]] = body_
            ask = list(fids)
            from seaweedfs_tpu_torch.util.batchframe import parse_all
            ch = FrameChannel(target=f"127.0.0.1:{vs.port}")
            try:
                fst, _, fraw = await ch.request(
                    "GET", "/batch", query={"fids": ",".join(ask)})
                async with c.http.get(
                        f"http://127.0.0.1:{vs.port}/batch",
                        params={"fids": ",".join(ask)}) as r:
                    hraw = await r.read()
                    assert fst == r.status == 200
                # byte-equal framing through both transports
                assert fraw == hraw
                rows = parse_all(fraw)
                assert [m["fid"] for m, _ in rows] == ask
                assert all(fids[m["fid"]] == b for m, b in rows)
            finally:
                await ch.close()
    run(body())


# --------------------------------------- client pipelined multi-read

def test_weedclient_pipelined_read(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            from seaweedfs_tpu_torch.util.client import WeedClient
            async with WeedClient(c.master.url) as wc:
                fids = {}
                for i in range(12):
                    a = await c.assign()
                    body_ = f"pipe-{i}-".encode() * 10
                    st, _ = await c.put(a["fid"], a["url"], body_)
                    assert st == 201
                    fids[a["fid"]] = body_
                missing = next(iter(fids)).split(",")[0] + \
                    ",ffffffffdeadbeef"
                ask = list(fids) + [missing]
                got = await wc.pipelined_read(ask, depth=4)
                assert got[missing] is None
                for fid, body_ in fids.items():
                    assert got[fid] == body_
                # all needles rode ONE multiplexed connection (the
                # hub also holds a master channel now that lookups
                # ride frames — pick the busy data channel)
                stats = max(wc.frame_hub.stats_dict().values(),
                            key=lambda s: s["requests"])
                assert stats["connects"] == 1
                assert stats["requests"] == len(ask)
                assert stats["fallbacks"] == 0
    run(body())


def test_weedclient_pipelined_read_falls_back_on_channel_fault(tmp_path):
    """client.pipeline failpoint severs every frame request: the
    results must still be correct, served via the HTTP path."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            from seaweedfs_tpu_torch.util.client import WeedClient
            async with WeedClient(c.master.url) as wc:
                fids = {}
                for i in range(4):
                    a = await c.assign()
                    body_ = f"fb-{i}-".encode() * 10
                    st, _ = await c.put(a["fid"], a["url"], body_)
                    assert st == 201
                    fids[a["fid"]] = body_
                fp.arm("client.pipeline", "error")
                got = await wc.pipelined_read(list(fids), depth=2)
                for fid, body_ in fids.items():
                    assert got[fid] == body_
    run(body())


# ------------------------------------------------- review hardening

def test_sibling_forward_gates_external_mutations(tmp_path):
    """On a jwt-secured cluster an identity-less frame HELLO is
    refused outright (GOAWAY before any payload is served): an
    untokened client never reaches the token-marked sibling forward
    at all, and a properly-identified channel confirms the needle was
    genuinely never written."""
    async def body():
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.server.workers import WorkerContext
        from seaweedfs_tpu_torch.storage.store import Store
        async with Cluster(str(tmp_path), n_servers=0) as c:
            import os as _os
            state_dir = str(tmp_path / "wstate")
            d = str(tmp_path / "wdata")
            workers = []
            for i in range(2):
                ctx = WorkerContext(i, 2, 0, state_dir, token="tok")
                store = Store([d], max_volume_counts=[16],
                              partition=(i, 2))
                vs = VolumeServer(store, c.master.url, port=0,
                                  pulse_seconds=0.2, worker_ctx=ctx,
                                  jwt_key="secret")
                await vs.start()
                workers.append(vs)
            for vs in workers:
                vs.store.public_url = workers[0].url
                await vs.heartbeat_once()
            try:
                # a fid on an ODD vid => worker 0 must forward it
                fid = None
                for _ in range(16):
                    a = await c.assign()
                    if int(a["fid"].split(",")[0]) % 2 == 1:
                        fid = a["fid"]
                        break
                assert fid is not None
                ch = FrameChannel(
                    target=f"127.0.0.1:{workers[0].port}")
                try:
                    # write AND delete for the sibling-owned vid: the
                    # identity-less HELLO is refused before any
                    # payload is served
                    with pytest.raises(FrameChannelError,
                                       match="handshake refused"):
                        await ch.request("POST", "/" + fid,
                                         body=b"laundered?")
                    with pytest.raises(FrameChannelError):
                        await ch.request("DELETE", "/" + fid)
                finally:
                    await ch.close()
                # the needle was genuinely never written: ask over a
                # channel carrying a verifiable jwt identity
                ch2 = FrameChannel(
                    target=f"127.0.0.1:{workers[0].port}",
                    jwt_key="secret")
                try:
                    st, _, _ = await ch2.request("GET", "/" + fid)
                    assert st == 404
                finally:
                    await ch2.close()
            finally:
                for vs in workers:
                    await vs.stop()
    run(body())


def test_oversized_response_downgrades_not_tears(tmp_path, monkeypatch):
    """A body that would exceed the peer decoder's MAX_FRAME answers
    FLAG_FALLBACK (one request rides HTTP) instead of emitting a
    frame that kills the whole multiplexed channel."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            from seaweedfs_tpu_torch.server import frameserver
            monkeypatch.setattr(frameserver, "MAX_FRAME", (1 << 20) + 4096)
            vs = c.servers[0]
            a = await c.assign()
            small = await c.assign()
            big = b"x" * 8192            # > (MAX_FRAME - 1MB) = 4096
            st, _ = await c.put(a["fid"], a["url"], big)
            assert st == 201
            st, _ = await c.put(small["fid"], small["url"], b"tiny")
            assert st == 201
            ch = FrameChannel(target=f"127.0.0.1:{vs.port}")
            try:
                with pytest.raises(FrameFallback):
                    await ch.request("GET", "/" + a["fid"])
                # the channel survived: other requests still answer
                st, _, got = await ch.request("GET", "/" + small["fid"])
                assert (st, got) == (200, b"tiny")
                assert ch.stats.connects == 1
            finally:
                await ch.close()
    run(body())


def test_oversize_meta_does_not_leak_pending():
    """encode_frame rejecting an oversized meta must leave _pending
    empty — a leaked entry would flip the reader loop onto the 30s
    response timeout and tear healthy channels."""
    async def body():
        async with _EchoFrameServer() as srv:
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                st, _, _ = await ch.request("GET", "/warm")
                assert st == 200
                from seaweedfs_tpu_torch.util.frame import MAX_META
                with pytest.raises(FrameError):
                    await ch.request(
                        "GET", "/x",
                        headers={"h": "v" * (MAX_META + 1)})
                assert not ch._pending
                st, _, _ = await ch.request("GET", "/still-fine")
                assert st == 200
            finally:
                await ch.close()
    run(body())


def test_teardown_fails_pending_even_without_error():
    """The idle-close race: a future registered as the reader loop
    idles out must be failed by _teardown, not left to its 30s
    request timeout."""
    async def body():
        async with _EchoFrameServer() as srv:
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                st, _, _ = await ch.request("GET", "/warm")
                assert st == 200
                loop = asyncio.get_running_loop()
                fut = loop.create_future()
                ch._pending[99] = fut
                ch._teardown(ch._writer, None)       # idle path: no err
                assert fut.done()
                with pytest.raises(FrameChannelError):
                    fut.result()
            finally:
                await ch.close()
    run(body())


def test_cancelled_request_leaves_no_pending_entry():
    """The PR-20 cancel-leak fix: a requester cancelled while awaiting
    its response must pop its _pending registration on the way out
    (finally), not leak it until response arrival or teardown — a
    leaked entry pins the reader loop's timeout accounting."""
    async def body():
        async with _EchoFrameServer() as srv:
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                st, _, _ = await ch.request("GET", "/warm")
                assert st == 200
                next_id = srv.seen_req_ids[-1] + 1
                srv.drop_ids = {next_id}     # never answered
                t = asyncio.create_task(ch.request("GET", "/hang"))
                await asyncio.sleep(0.05)    # parked awaiting the resp
                assert next_id in ch._pending
                t.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await t
                assert not ch._pending       # registration dropped
                assert ch._inflight == 0     # slot released too
                st, _, _ = await ch.request("GET", "/still-fine")
                assert st == 200
            finally:
                await ch.close()
    run(body())


def test_cancelled_window_waiter_does_not_shrink_window():
    """The PR-20 _acquire_slot fix: a waiter cancelled while parked on
    the congestion window must leave the queue AND give back any slot
    reserved for it in the same tick — the old shape permanently
    shrank the window by one per cancelled waiter."""
    async def body():
        async with _EchoFrameServer() as srv:
            ch = FrameChannel(target=f"127.0.0.1:{srv.port}")
            try:
                st, _, _ = await ch.request("GET", "/warm")
                assert st == 200
                ch._cwnd = 1.0               # one slot total
                slow_id = srv.seen_req_ids[-1] + 1
                srv.delay_ids = {slow_id: 0.2}
                t1 = asyncio.create_task(ch.request("GET", "/slow"))
                await asyncio.sleep(0.05)    # t1 owns the only slot
                t2 = asyncio.create_task(ch.request("GET", "/parked"))
                await asyncio.sleep(0.05)    # t2 queued on the window
                assert len(ch._win_waiters) == 1
                t2.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await t2
                assert not ch._win_waiters   # queue entry dropped
                st, _, _ = await t1
                assert st == 200
                assert ch._inflight == 0     # window fully restored
                st, _, _ = await ch.request("GET", "/after")
                assert st == 200
            finally:
                await ch.close()
    run(body())


class _Fleet:
    """A frame server that hands each connection to a worker drawn at
    random, as SO_REUSEPORT does for a `-workers` fleet, and names it
    in HELLO_OK, with the fleet's size when `workers` is set. Each
    response's body is the worker that served it."""

    def __init__(self, workers: int | None, seed: int = 7):
        self.workers = workers
        self.rng = random.Random(seed)
        self.dials = 0
        self.writers: list = []
        self.port = 0
        self._server = None

    async def __aenter__(self):
        self._server = await asyncio.start_server(self._conn,
                                                  "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self.drop()
        self._server.close()
        await self._server.wait_closed()

    def drop(self) -> None:
        for w in self.writers:
            w.close()
        self.writers.clear()

    async def _conn(self, reader, writer):
        self.dials += 1
        worker = self.rng.randrange(self.workers or 1)
        self.writers.append(writer)
        dec = FrameDecoder()
        first = True
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    return
                if first:
                    chunk = chunk[len(MAGIC):]
                    first = False
                for fr in dec.feed(chunk):
                    if fr.type == HELLO:
                        meta = {"v": 1, "worker": worker}
                        if self.workers:
                            meta["workers"] = self.workers
                        writer.write(encode_frame(HELLO_OK, 0, meta))
                    elif fr.type == REQ:
                        writer.write(encode_frame(
                            RESP, fr.req_id, {"s": 200},
                            str(worker).encode()))
        except OSError:
            pass
        finally:
            writer.close()


@pytest.mark.parametrize("workers", [2, 3])
def test_hub_spreads_a_client_over_a_fleets_workers(workers):
    """FrameHub.pick against a fleet: the first request takes the one
    channel, whatever worker it reached; once that handshake reports
    the fleet's size, requests take one channel per worker in turn,
    each pinned to its worker (dialled again until the handshake names
    it), and they stay pinned after the fleet drops every connection."""
    async def body():
        async with _Fleet(workers) as fleet:
            hub = FrameHub()
            target = f"127.0.0.1:{fleet.port}"

            async def turns(n: int) -> list[int]:
                got = []
                for _ in range(n):
                    st, _, b = await hub.pick(target).request("GET", "/x")
                    assert st == 200
                    got.append(int(b))
                return got

            try:
                first = await turns(1)
                spread = await turns(2 * workers)
                fleet.drop()
                await asyncio.sleep(0.05)
                again = await turns(2 * workers)
                chans = list(hub._channels.values())
            finally:
                await hub.close()
            return first, spread, again, chans

    first, spread, again, chans = run(body())
    assert first[0] in range(workers)
    assert spread == list(range(workers)) * 2
    assert again == list(range(workers)) * 2
    assert len(chans) == workers
    assert sorted(ch.worker for ch in chans) == list(range(workers))
    assert all(ch.peer_worker == ch.worker for ch in chans)


def test_hub_keeps_one_channel_without_a_fleet_size():
    """A server whose HELLO_OK names no fleet size (no `-workers`
    fleet, or the reference's frame server) keeps the client on one
    channel and one connection."""
    async def body():
        async with _Fleet(None) as fleet:
            hub = FrameHub()
            target = f"127.0.0.1:{fleet.port}"
            try:
                chans = set()
                for _ in range(6):
                    ch = hub.pick(target)
                    st, _, _ = await ch.request("GET", "/x")
                    assert st == 200
                    chans.add(id(ch))
                return chans, fleet.dials, list(hub._channels.values())
            finally:
                await hub.close()

    chans, dials, held = run(body())
    assert len(chans) == 1 and dials == 1
    assert held[0].peer_workers == 1 and held[0].worker is None
