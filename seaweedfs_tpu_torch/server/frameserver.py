"""Frame-protocol listener adapter for the volume server.

A connection that opens with the frame MAGIC (util/frame.py) — on the
public/private TCP port (sniffed by the raw HTTP fast path) or on the
per-worker unix socket — lands here. This is the THIRD transport
adapter over the unified wire layer (server/wire.py), beside the raw
HTTP listener and the aiohttp app: it builds the same
:class:`WireRequest`, calls the same serve_read/serve_write/
serve_delete/serve_batch, and renders the :class:`WireResponse` as a
RESP frame — so the needle cache, tracing, failpoints, Range/
conditional semantics, replication fan-out and group commit stay
wired exactly once. Cold bodies still go disk->socket: a sendfile
response writes the frame header, then ``loop.sendfile``s the needle
region into the SAME frame's payload slot.

Request routing over frames:

* ``/<vid>,<fid>`` GET/HEAD/POST/PUT/DELETE — the needle API;
* ``/batch`` — the pipelined multi-needle GET;
* ``/admin/ec/shard_read`` — the batched EC shard gather.

Anything the frame transport cannot express (chunked-manifest
assembly, jwt-guarded writes on an identity-less connection,
multipart) answers with ``FLAG_FALLBACK`` and the caller retries over
HTTP — the exact degradation a peer that predates the protocol
produces. Replica fan-out writes (x-raw-needle) and replicate-typed
deletes are served over frames under the same -whiteList policy the
HTTP listeners apply; on jwt-secured clusters the HELLO handshake
itself refuses connections without a verified identity claim.

Under ``-workers``, a frame request for a sibling-owned vid arriving
WITHOUT the launch token is forwarded over the server's own sibling
frame channel (the frame twin of the aiohttp worker-routing
middleware), so an external pipelining client never pays an HTTP
downgrade just because SO_REUSEPORT handed it the wrong worker.

A copy of seaweedfs_tpu/server/frameserver.py in the PyTorch port, with
three changes: a multipart write that a sibling worker forwards over
its frame hop falls back to the HTTP hop, where it is parsed (the
reference's copy stores the raw multipart body as the needle); the
forward of a frame client's request to the owning sibling goes through
the HTTP routing middleware's breaker and `worker.proxy` chaos site, in
a span of its own (the reference's skips all three); and HELLO_OK names
the fleet's size beside the worker, so a client can spread its channels
over the workers (util/frame.py FrameHub.pick).
"""

from __future__ import annotations

import asyncio

from ..storage import types as t
from ..util import failpoints, glog, tracing
from ..util.frame import (FLAG_FALLBACK, FrameChannelError, FrameDecoder,
                          FrameError, GOAWAY, HELLO, HELLO_OK, MAGIC,
                          MAX_FRAME, REQ, RESP, encode_frame)
from . import wire

_OPS = {"GET": "read", "HEAD": "read", "POST": "write", "PUT": "write",
        "DELETE": "delete"}


def _count_frames(side: str, hop: str, n: int = 1) -> None:
    from ..stats import metrics
    if metrics.HAVE_PROMETHEUS:
        metrics.FRAME_REQUESTS.labels(side, hop).inc(n)


class FrameServerProtocol(asyncio.Protocol):
    """Per-connection frame terminator (server side)."""

    __slots__ = ("vs", "transport", "peer_ip", "dec", "hop", "authed",
                 "_hello", "_closed", "_tasks", "_write_lock", "_pre")

    def __init__(self, vs) -> None:
        self.vs = vs
        self.transport = None
        self.peer_ip: str | None = None
        self.dec = FrameDecoder()
        self.hop = False              # token-authenticated worker hop
        # cluster identity: worker token OR a verified jwt HELLO claim
        # (frames from a peer holding the cluster signing key)
        self.authed = False
        self._hello = False
        self._closed = False
        self._tasks: set = set()
        # clients always open with the MAGIC preamble; the raw TCP
        # listener strips it while sniffing, but connections landing
        # here directly (the unix socket) still carry it — buffer just
        # enough to strip an optional leading MAGIC
        self._pre: bytearray | None = bytearray()
        # responses interleave across request tasks, but each frame's
        # bytes (and a sendfile region inside one) must hit the
        # transport contiguously
        self._write_lock = asyncio.Lock()

    # -- asyncio.Protocol --

    def connection_made(self, transport) -> None:
        self.transport = transport
        if not hasattr(self.vs, "_fast_conns"):
            self.vs._fast_conns = set()
        self.vs._fast_conns.add(transport)
        peer = transport.get_extra_info("peername")
        self.peer_ip = peer[0] if isinstance(peer, tuple) and peer \
            else None
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                import socket as _s
                if sock.family == getattr(_s, "AF_INET", None) or \
                        sock.family == getattr(_s, "AF_INET6", None):
                    sock.setsockopt(_s.IPPROTO_TCP, _s.TCP_NODELAY, 1)
            except OSError:
                pass

    def connection_lost(self, exc) -> None:
        self._closed = True
        getattr(self.vs, "_fast_conns", set()).discard(self.transport)
        for task in self._tasks:
            task.cancel()

    def data_received(self, data: bytes) -> None:
        if self._pre is not None:
            self._pre += data
            if self._pre[:1] == MAGIC[:1] and \
                    len(self._pre) < len(MAGIC) and \
                    MAGIC.startswith(bytes(self._pre)):
                return                # preamble still arriving
            data = bytes(self._pre)
            self._pre = None
            if data.startswith(MAGIC):
                data = data[len(MAGIC):]
            # anything else goes to the decoder as-is: a real frame
            # starts with a small big-endian length, garbage draws a
            # FrameError -> GOAWAY below
            if not data:
                return
        try:
            frames = self.dec.feed(data)
        except FrameError as e:
            glog.V(1).infof("frame conn from %s: %s", self.peer_ip, e)
            self._goaway(str(e))
            return
        for fr in frames:
            self._handle(fr)

    # -- frame dispatch --

    def _goaway(self, msg: str) -> None:
        if self._closed:
            return
        try:
            self.transport.write(encode_frame(GOAWAY, 0, {"error": msg}))
        except OSError:
            pass
        self._closed = True
        self.transport.close()

    def _handle(self, fr) -> None:
        if not self._hello:
            if fr.type != HELLO:
                self._goaway("expected HELLO")
                return
            wc = self.vs.worker_ctx
            token = str(fr.meta.get("token", "") or "")
            self.hop = wc is not None and wc.token_ok(token)
            self.authed = self.hop or self._verify_identity(
                str(fr.meta.get("id", "") or ""))
            if getattr(self.vs, "jwt_key", "") and not self.authed:
                # jwt-secured cluster: an unauthenticated (or wrong-
                # identity) HELLO is refused BEFORE any payload is
                # served — connection identity is part of the security
                # model, not a courtesy
                self._goaway("hello identity required "
                             "(jwt-secured cluster)")
                return
            self._hello = True
            self.transport.write(encode_frame(
                HELLO_OK, fr.req_id,
                {"v": 1, "worker": wc.index if wc else 0,
                 "workers": wc.total if wc else 1}))
            return
        if fr.type != REQ:
            return                    # unknown/late types ignored
        task = asyncio.get_running_loop().create_task(self._serve(fr))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _verify_identity(self, ident: str) -> bool:
        """A HELLO ``id`` claim: a jwt minted from the cluster signing
        key, bound to the fixed handshake fid (util/frame.py
        HELLO_IDENTITY_FID) so per-needle write tokens can never be
        replayed as channel identities."""
        key = getattr(self.vs, "jwt_key", "")
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
        """Low-cardinality hop classification for the server-side
        counters: the launch-token worker hop and unix-socket
        connections are intra-host siblings, everything else is the
        inter-host fabric."""
        return "sibling" if (self.hop or self.peer_ip is None) \
            else "interhost"

    async def _serve(self, fr) -> None:
        _count_frames("server", self._hop_label())
        req_id = fr.req_id
        method = str(fr.meta.get("m", "GET")).upper()
        path = str(fr.meta.get("p", ""))
        query = fr.meta.get("q") or {}
        headers = {str(k).lower(): str(v)
                   for k, v in (fr.meta.get("h") or {}).items()}
        if not isinstance(query, dict):
            query = {}
        try:
            resp = await self._route(method, path, query, headers,
                                     fr.payload)
        except asyncio.CancelledError:
            raise
        except Exception as e:        # a handler bug must not wedge
            glog.warning("frame request %s %s: %s: %s", method, path,
                         type(e).__name__, e)
            resp = wire.json_err(500, f"{type(e).__name__}: {e}")
        if resp is None:
            await self._send_fallback(req_id)
            return
        await self._send_response(req_id, resp)

    async def _route(self, method: str, path: str, query: dict,
                     headers: dict, body: bytes):
        """Returns a WireResponse, or None => FLAG_FALLBACK."""
        vs = self.vs
        wc = vs.worker_ctx
        if path == "/batch":
            wr = wire.WireRequest(
                method="GET", fid_s="", query=query, headers=headers,
                peer_ip=self.peer_ip, body=body or None, raw=True,
                worker_hop=self.hop)
            with tracing.start_root("volume", "batch",
                                    headers=headers) as sp:
                sp.set("transport", "frame")
                resp = await wire.serve_batch(vs, wr)
                sp.status = "ok" if resp.status < 400 \
                    else str(resp.status)
                return resp
        if path.startswith("/admin/ec/shard_read"):
            return await self._serve_ec_shard_read(query, headers)
        fid_s = path.lstrip("/")
        try:
            fid = t.FileId.parse(fid_s)
        except ValueError as e:
            return wire.json_err(400, str(e))
        if wc is not None and not self.hop \
                and not wc.owns(fid.volume_id):
            # SO_REUSEPORT handed a pipelining client the wrong
            # worker: forward over the sibling frame channel (token-
            # marked), falling back to FLAG_FALLBACK when the sibling
            # hop is down — the client then retries over HTTP, where
            # the aiohttp routing middleware owns the recovery.
            # CRITICAL: the write/delete gates run HERE first — the
            # sibling channel carries the launch token, so an
            # unguarded forward would launder an external client's
            # write past jwt/whitelist exactly like a real hop
            if method not in ("GET", "HEAD"):
                gate = self._external_mutation_gate(method, query,
                                                   headers)
                if gate is not True:
                    return gate
            return await self._forward_sibling(
                wc.owner_index(fid.volume_id), method, path, query,
                headers, body)
        if method in ("GET", "HEAD"):
            return await self._serve_read(fid_s, method, query, headers)
        if method in ("POST", "PUT"):
            return await self._serve_write(fid_s, query, headers, body)
        if method == "DELETE":
            return await self._serve_delete(fid_s, query, headers)
        return wire.json_err(400, f"method {method} not framed")

    def _external_mutation_gate(self, method: str, query: dict,
                                headers: dict):
        """Write/delete gating for UNTOKENED frame connections, wired
        once for the local-serve and sibling-forward paths, mirroring
        the aiohttp listener's _guarded_request policy: a connection
        with cluster identity (worker token or verified jwt HELLO)
        proceeds — wire.py's per-needle jwt checks still run; on a
        jwt-secured cluster an identity-less mutation answers None =>
        FLAG_FALLBACK (belt-and-braces: the HELLO refusal already
        severed such connections); multipart framing stays
        aiohttp-only; everything else — including replica fan-out
        writes (x-raw-needle) and replicate-typed deletes, which the
        HTTP listeners serve under the same whitelist — is gated on
        -whiteList exactly like HTTP. A whitelist miss is a hard 401.
        Returns True when the mutation may proceed."""
        vs = self.vs
        if self.authed:
            return True
        if vs.jwt_key:
            return None
        if method in ("POST", "PUT") and headers.get(
                "content-type", "").startswith("multipart/"):
            return None
        if not vs.guard.empty and not vs.guard.allows(self.peer_ip):
            return wire.json_err(401, "ip not in whitelist")
        return True

    def _wire_request(self, method: str, fid_s: str, query: dict,
                      headers: dict,
                      body: bytes | None = None) -> wire.WireRequest:
        return wire.WireRequest(
            method=method, fid_s=fid_s, query=query, headers=headers,
            peer_ip=self.peer_ip, body=body, raw=True,
            worker_hop=self.hop)

    async def _serve_read(self, fid_s: str, method: str, query: dict,
                          headers: dict):
        vs = self.vs
        wr = self._wire_request(method, fid_s, query, headers)
        with tracing.start_root("volume", "read",
                                headers=headers) as sp:
            sp.set("transport", "frame")
            resp = await wire.serve_read(vs, wr)
            if resp.upgrade:
                # chunked-manifest assembly (or another aiohttp-only
                # shape): the frame transport cannot stream it
                sp.cancel()
                return None
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            return resp

    async def _serve_write(self, fid_s: str, query: dict, headers: dict,
                           body: bytes):
        vs = self.vs
        if headers.get("content-type", "").startswith("multipart/"):
            # multipart framing is parsed by the aiohttp handler only,
            # also for a sibling hop (a worker forwarding a client's
            # multipart upload): FLAG_FALLBACK sends it over HTTP, where
            # it is parsed, instead of storing the raw multipart body
            return None
        wr = self._wire_request("POST", fid_s, query, headers, body)
        if not self.hop:
            # mirror the raw listener's fast-write gate
            gate = self._external_mutation_gate("POST", query, headers)
            if gate is not True:
                return gate
        with tracing.start_root("volume", "write",
                                headers=headers) as sp:
            sp.set("transport", "frame")
            resp = await wire.serve_write(vs, wr)
            if resp.upgrade:
                sp.cancel()
                return None
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            return resp

    async def _serve_delete(self, fid_s: str, query: dict,
                            headers: dict):
        vs = self.vs
        wr = self._wire_request("DELETE", fid_s, query, headers)
        if not self.hop:
            gate = self._external_mutation_gate("DELETE", query,
                                                headers)
            if gate is not True:
                return gate
        with tracing.start_root("volume", "delete",
                                headers=headers) as sp:
            sp.set("transport", "frame")
            resp = await wire.serve_delete(vs, wr)
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            return resp

    async def _serve_ec_shard_read(self, query: dict, headers: dict):
        """Frame twin of h_ec_shard_read's batched form: the EC shard
        gather's one-request-per-holder round trip, minus the HTTP
        envelope."""
        from ..util import batchframe
        vs = self.vs
        try:
            vid = int(query.get("volume", ""))
            reads = batchframe.parse_reads_spec(
                str(query.get("reads", "")))
        except ValueError:
            return wire.json_err(400, "bad reads spec")
        wc = vs.worker_ctx
        if wc is not None and not self.hop and not wc.owns(vid):
            return await self._forward_sibling(
                wc.owner_index(vid), "GET", "/admin/ec/shard_read",
                query, headers, b"")
        with tracing.start_root("volume", "ec.shard_read",
                                headers=headers) as sp:
            sp.set("transport", "frame")
            datas = await vs._in_executor(
                vs.store.read_ec_shard_intervals, vid, reads)
            out = batchframe.encode_shard_rows(reads, datas)
            sp.nbytes = len(out)
            return wire.WireResponse(
                body=out, content_type=batchframe.CONTENT_TYPE)

    async def _forward_sibling(self, owner: int, method: str, path: str,
                               query: dict, headers: dict, body: bytes):
        """The frame twin of the aiohttp worker-routing middleware's
        hop, in a `proxy sibling` span of its own and through the same
        gate (VolumeServer.sibling_gate): the sibling's breaker and the
        `worker.proxy` chaos site. Without a channel to the sibling the
        answer is FLAG_FALLBACK before the gate, so the client's HTTP
        leg crosses it once, in the middleware. A channel that fails
        mid-request counts against the breaker, as the HTTP hop's 502
        does (a half-open probe must have its answer), and falls back
        the same way."""
        vs = self.vs
        target = vs.worker_ctx.sibling_addr(owner)
        ch = vs.sibling_frame_channel(owner)
        if ch is None or target is None:
            return None
        with tracing.start_root("proxy", "sibling", headers=headers,
                                target=target, worker=owner) as sp:
            sp.set("transport", "frame")
            br, refused = await vs.sibling_gate(
                target, f"worker {owner} (sibling)", sp)
            if refused is not None:
                return wire.json_err(*refused)
            fwd = dict(headers)
            tracing.inject(fwd, sp)
            try:
                status, hdrs, payload = await ch.request(
                    method, path, query=query, headers=fwd, body=body)
            except FrameChannelError as e:
                br.record_failure()
                sp.event("frame_fallback", error=str(e)[:120])
                return None
            br.record_success()
            sp.status = "ok" if status < 400 else str(status)
        ct = hdrs.pop("content-type",
                      hdrs.pop("Content-Type", wire.OCTET))
        return wire.WireResponse(status=status, headers=hdrs,
                                 body=payload, content_type=ct)

    # -- response rendering --

    async def _send_fallback(self, req_id: int) -> None:
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FRAME_FALLBACKS.labels(self._hop_label()).inc()
        async with self._write_lock:
            if not self._closed:
                self.transport.write(encode_frame(
                    RESP, req_id, {"s": 421}, flags=FLAG_FALLBACK))

    async def _send_response(self, req_id: int,
                             resp: wire.WireResponse) -> None:
        if resp.drop:
            # injected connection drop: sever, don't answer
            self._closed = True
            self.transport.close()
            return
        if resp.upgrade or resp.manifest is not None:
            await self._send_fallback(req_id)
            return
        if resp.content_length > MAX_FRAME - (1 << 20):
            # a body this size would exceed the peer decoder's
            # MAX_FRAME and tear the whole multiplexed channel —
            # downgrade this one request to HTTP instead
            if resp.sendfile is not None:
                resp.sendfile.close()
            await self._send_fallback(req_id)
            return
        meta = {"s": resp.status, "h": resp.headers,
                "ct": resp.content_type}
        if resp.truncate_to >= 0:
            # chaos truncate: declared full payload length, partial
            # bytes, dead socket — frame readers see a torn stream
            # exactly like the HTTP listeners' clients
            async with self._write_lock:
                if not self._closed:
                    head = encode_frame(RESP, req_id, meta, resp.body)
                    cut = len(head) - len(resp.body) + resp.truncate_to
                    self.transport.write(head[:cut])
                self._closed = True
                self.transport.close()
            return
        if resp.head:
            # HEAD strips the payload but must still advertise the
            # body length, like the HTTP listeners' Content-Length
            hdrs = dict(resp.headers)
            hdrs.setdefault("Content-Length", str(resp.content_length))
            meta = {"s": resp.status, "h": hdrs,
                    "ct": resp.content_type}
            resp = wire.WireResponse(status=resp.status, headers=hdrs,
                                     content_type=resp.content_type)
        if resp.sendfile is not None:
            await self._send_sendfile(req_id, meta, resp)
            return
        async with self._write_lock:
            if not self._closed:
                self.transport.write(
                    encode_frame(RESP, req_id, meta, resp.body))

    async def _send_sendfile(self, req_id: int, meta: dict,
                             resp: wire.WireResponse) -> None:
        """Zero-copy frame payload: the frame header declares the full
        payload length, then the needle region goes disk->socket with
        loop.sendfile INSIDE the frame (kernel copy; asyncio falls
        back to executor-chunked reads where sendfile is unavailable,
        e.g. TLS transports)."""
        ref = resp.sendfile
        try:
            async with self._write_lock:
                if self._closed:
                    return
                head = encode_frame(RESP, req_id, meta)
                # grow the declared length by the payload to come
                import struct
                length = struct.unpack_from(">I", head)[0] + ref.length
                self.transport.write(
                    struct.pack(">I", length) + head[4:])
                try:
                    await asyncio.get_running_loop().sendfile(
                        self.transport, ref.file, ref.offset,
                        ref.length, fallback=True)
                except (OSError, RuntimeError):
                    # mid-send failure: the declared frame length can
                    # no longer be honored — sever so the peer sees a
                    # torn frame, never a desynced stream
                    self._closed = True
                    self.transport.close()
        finally:
            ref.close()
