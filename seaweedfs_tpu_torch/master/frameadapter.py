"""Frame-protocol listener adapter for the MASTER.

The volume side terminates frames in server/frameserver.py over the
unified wire layer; the master has no wire layer — its handlers are
plain aiohttp coroutines. This adapter is the thin shim that lets the
control plane ride the same frame fabric: a connection opening with
the frame MAGIC on the master's public port (sniffed by
FastAssignProtocol) lands here, and each REQ frame is served by the
EXISTING aiohttp handler through a minimal request shim — so raft
durability rules (flush-before-reply), leader redirects (307 +
X-Raft-Leader), heartbeat delta publication and the assign path stay
wired exactly once.

Frame-served routes (everything else answers ``FLAG_FALLBACK`` and
the caller retries over HTTP):

* ``POST /raft/vote|/raft/heartbeat|/raft/snapshot`` — the raft mesh;
* ``POST /cluster/heartbeat`` — volume-server heartbeats;
* ``GET/POST /dir/lookup``, ``GET /dir/assign`` — the client hot path.

HELLO discipline matches the volume side: worker launch token or a
verified jwt identity claim; on a jwt-secured cluster an identity-less
HELLO is refused with GOAWAY before any request is served. The
-whiteList guard is applied per request exactly like the aiohttp
middleware (including the heartbeat-learned peer exemption on
/dir/lookup).

A copy of seaweedfs_tpu/master/frameadapter.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import urllib.parse

from ..security.guard import path_guarded
from ..util import glog
from ..util.frame import (FLAG_FALLBACK, FrameDecoder, FrameError,
                          GOAWAY, HELLO, HELLO_OK, MAGIC, REQ, RESP,
                          encode_frame)

# (method, path) -> MasterServer handler attribute. Deliberately a
# closed whitelist: streaming responses (/cluster/watch), multipart
# (/submit) and the bulk of the debug surfaces stay aiohttp-only.
# /debug/traces is the one debug route admitted: cluster trace
# assembly (stats/introspect.py) pulls peer masters' span rings over
# the fabric, and its bounded-JSON body fits the frame contract.
_FRAME_ROUTES = {
    ("POST", "/raft/vote"): "h_raft_vote",
    ("POST", "/raft/heartbeat"): "h_raft_heartbeat",
    ("POST", "/raft/snapshot"): "h_raft_snapshot",
    ("POST", "/cluster/heartbeat"): "h_heartbeat",
    ("GET", "/dir/lookup"): "h_lookup",
    ("POST", "/dir/lookup"): "h_lookup",
    ("GET", "/dir/assign"): "h_assign",
    ("GET", "/debug/traces"): "h_traces",
}


class _ShimRequest:
    """The minimal aiohttp-Request surface the frame-served master
    handlers actually touch: .method/.path/.path_qs/.query/.headers/
    .remote plus async json()/read()/text()."""

    __slots__ = ("method", "path", "query", "headers", "remote",
                 "_body")

    def __init__(self, method: str, path: str, query: dict,
                 headers, remote: str | None, body: bytes) -> None:
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.remote = remote
        self._body = body

    @property
    def path_qs(self) -> str:
        if not self.query:
            return self.path
        return self.path + "?" + urllib.parse.urlencode(self.query)

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode(errors="replace")

    async def json(self):
        import json
        return json.loads(self._body or b"{}")


class MasterFrameProtocol(asyncio.Protocol):
    """Per-connection frame terminator for the master (control plane
    twin of server/frameserver.FrameServerProtocol)."""

    __slots__ = ("ms", "transport", "peer_ip", "dec", "hop", "authed",
                 "_hello", "_closed", "_tasks", "_write_lock", "_pre")

    def __init__(self, ms) -> None:
        self.ms = ms
        self.transport = None
        self.peer_ip: str | None = None
        self.dec = FrameDecoder()
        self.hop = False
        self.authed = False
        self._hello = False
        self._closed = False
        self._tasks: set = set()
        self._write_lock = asyncio.Lock()
        self._pre: bytearray | None = bytearray()

    # -- asyncio.Protocol --

    def connection_made(self, transport) -> None:
        self.transport = transport
        if not hasattr(self.ms, "_fast_conns"):
            self.ms._fast_conns = set()
        self.ms._fast_conns.add(transport)
        peer = transport.get_extra_info("peername")
        self.peer_ip = peer[0] if isinstance(peer, tuple) and peer \
            else None

    def connection_lost(self, exc) -> None:
        self._closed = True
        getattr(self.ms, "_fast_conns", set()).discard(self.transport)
        for task in self._tasks:
            task.cancel()

    def data_received(self, data: bytes) -> None:
        if self._pre is not None:
            self._pre += data
            if self._pre[:1] == MAGIC[:1] and \
                    len(self._pre) < len(MAGIC) and \
                    MAGIC.startswith(bytes(self._pre)):
                return
            data = bytes(self._pre)
            self._pre = None
            if data.startswith(MAGIC):
                data = data[len(MAGIC):]
            if not data:
                return
        try:
            frames = self.dec.feed(data)
        except FrameError as e:
            glog.V(1).infof("master frame conn from %s: %s",
                            self.peer_ip, e)
            self._goaway(str(e))
            return
        for fr in frames:
            self._handle(fr)

    # -- dispatch --

    def _goaway(self, msg: str) -> None:
        if self._closed:
            return
        try:
            self.transport.write(encode_frame(GOAWAY, 0,
                                              {"error": msg}))
        except OSError:
            pass
        self._closed = True
        self.transport.close()

    def _verify_identity(self, ident: str) -> bool:
        key = getattr(self.ms, "jwt_key", "")
        if not key or not ident:
            return False
        from ..security.jwt import JwtError, decode_jwt
        from ..util.frame import HELLO_IDENTITY_FID
        try:
            return decode_jwt(key, ident).get(
                "fid") == HELLO_IDENTITY_FID
        except JwtError:
            return False

    def _hop_label(self) -> str:
        return "sibling" if (self.hop or self.peer_ip is None) \
            else "interhost"

    def _handle(self, fr) -> None:
        if not self._hello:
            if fr.type != HELLO:
                self._goaway("expected HELLO")
                return
            wc = self.ms.worker_ctx
            token = str(fr.meta.get("token", "") or "")
            self.hop = wc is not None and wc.token_ok(token)
            self.authed = self.hop or self._verify_identity(
                str(fr.meta.get("id", "") or ""))
            if getattr(self.ms, "jwt_key", "") and not self.authed:
                # same refusal the volume side gives: on jwt-secured
                # clusters no payload is served to an identity-less
                # connection
                self._goaway("hello identity required "
                             "(jwt-secured cluster)")
                return
            self._hello = True
            self.transport.write(encode_frame(
                HELLO_OK, fr.req_id,
                {"v": 1, "worker": wc.index if wc else 0}))
            return
        if fr.type != REQ:
            return
        task = asyncio.get_running_loop().create_task(self._serve(fr))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _serve(self, fr) -> None:
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FRAME_REQUESTS.labels(
                "server", self._hop_label()).inc()
        req_id = fr.req_id
        method = str(fr.meta.get("m", "GET")).upper()
        path = str(fr.meta.get("p", ""))
        query = fr.meta.get("q") or {}
        if not isinstance(query, dict):
            query = {}
        headers = {str(k).lower(): str(v)
                   for k, v in (fr.meta.get("h") or {}).items()}
        handler_name = _FRAME_ROUTES.get((method, path))
        if handler_name is None:
            await self._send_fallback(req_id)
            return
        ms = self.ms
        # the aiohttp guard middleware, replayed: guarded paths check
        # -whiteList against the real peer; /dir/lookup admits
        # heartbeat-learned cluster members
        guarded = path_guarded(path, ms._GUARDED) and not (
            path == "/dir/lookup" and ms._is_peer(self.peer_ip))
        if guarded and not ms.guard.empty \
                and not ms.guard.allows(self.peer_ip):
            await self._send_json(req_id, 401, {},
                                  b'{"error": "ip not in whitelist"}')
            return
        shim = _ShimRequest(method, path, query, headers,
                            self.peer_ip, fr.payload)
        try:
            resp = await getattr(ms, handler_name)(shim)
        except asyncio.CancelledError:
            raise
        except Exception as e:      # a handler bug must not wedge
            glog.warning("master frame %s %s: %s: %s", method, path,
                         type(e).__name__, e)
            await self._send_json(
                req_id, 500, {},
                b'{"error": "internal frame handler error"}')
            return
        hdrs = {k: v for k, v in resp.headers.items()
                if k.lower() not in ("content-length", "content-type",
                                     "date", "server")}
        body = resp.body
        if body is None:
            body = b""
        elif not isinstance(body, (bytes, bytearray)):
            body = bytes(body)
        await self._send_json(req_id, resp.status, hdrs, bytes(body),
                              ct=resp.content_type or
                              "application/json")

    # -- response rendering --

    async def _send_fallback(self, req_id: int) -> None:
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FRAME_FALLBACKS.labels(self._hop_label()).inc()
        async with self._write_lock:
            if not self._closed:
                self.transport.write(encode_frame(
                    RESP, req_id, {"s": 421}, flags=FLAG_FALLBACK))

    async def _send_json(self, req_id: int, status: int, headers: dict,
                         body: bytes,
                         ct: str = "application/json") -> None:
        meta = {"s": status, "h": headers, "ct": ct}
        async with self._write_lock:
            if not self._closed:
                self.transport.write(
                    encode_frame(RESP, req_id, meta, body))
