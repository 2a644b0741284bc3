"""Hand-rolled HTTP/1.1 fast path for the needle data plane.

Reference: the reference serves its public needle API straight off Go's
net/http (volume_server_handlers_read.go:30-140,
volume_server_handlers_write.go:19-73) and its published benchmark
(README.md:463-495) is set by per-request HTTP cost, not by the O(1)
needle engine. BENCH_NEEDLE.md measured the same here: the engine does
54k reads/s isolated while aiohttp's parse+route+response machinery
caps the served rate at ~3.8k/s on this single core.

This module is a raw `asyncio.Protocol` that parses just enough HTTP
for the hot shapes — `GET/POST/PUT/DELETE /<vid>,<fid>` and the
multi-needle `GET /batch?fids=...` — and hands them to the UNIFIED wire
layer (server/wire.py), the same parse/handle/respond code the aiohttp
listener uses, then renders the WireResponse as preformatted bytes.
Cold needle bodies go disk->socket with `loop.sendfile` (zero-copy;
`source=sendfile` in the trace). EVERYTHING the shared layer marks
`upgrade` (chunked-manifest assembly, multipart, JWT'd writes,
sibling-owned volumes) is handed to the full aiohttp application by
swapping the connection's protocol in place (`transport.set_protocol`),
so those requests keep byte-for-byte the semantics of the full
handlers; the swap preserves the real peer address, so IP guards keep
working. A connection that leaves the fast path stays on aiohttp for
its lifetime.

A copy of seaweedfs_tpu/server/fasthttp.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import json
import re

from ..master.sequence import SequenceBehind
from ..util import tracing
from ..util.failpoints import pending as _fp_pending
from ..util.frame import MAGIC as _FRAME_MAGIC
from . import wire

_REQ_LINE = re.compile(
    rb"^(GET|POST|PUT|DELETE) /(\d+,[0-9a-fA-F]+)"
    rb"((?:\?[^ ]*)?) HTTP/1\.1$")
_BATCH_LINE = re.compile(rb"^GET /batch((?:\?[^ ]*)?) HTTP/1\.1$")

_R401_BODY = b"{\"error\": \"ip not in whitelist\"}"
# built from len(): a hand-counted Content-Length that disagrees with
# the body desyncs every spec-conformant keep-alive client
_R401_IP = (b"HTTP/1.1 401 Unauthorized\r\n"
            b"Content-Type: application/json; charset=utf-8\r\n"
            b"Content-Length: " + str(len(_R401_BODY)).encode()
            + b"\r\n\r\n" + _R401_BODY)


def _json_err(status: int, reason: str, msg: str) -> bytes:
    body = json.dumps({"error": msg}).encode()
    return (b"HTTP/1.1 %d %s\r\n"
            b"Content-Type: application/json; charset=utf-8\r\n"
            b"Content-Length: %d\r\n\r\n"
            % (status, reason.encode(), len(body))) + body


def _parse_query(q: bytes) -> dict | None:
    """Simple query bytes -> dict; None when the full parser must take
    over (%-escapes, '+' spaces)."""
    if q in (b"", b"?"):
        return {}
    if b"%" in q or b"+" in q:
        return None
    out: dict = {}
    for kv in q[1:].split(b"&"):
        if not kv:
            continue
        k, _, v = kv.partition(b"=")
        try:
            out[k.decode("ascii")] = v.decode("ascii")
        except UnicodeDecodeError:
            return None
    return out


class FastNeedleProtocol(asyncio.Protocol):
    """Per-connection fast parser; upgrades to aiohttp on anything cold."""

    __slots__ = ("vs", "buf", "transport", "peer_ip", "_busy", "_closed",
                 "_task")

    def __init__(self, vs) -> None:
        self.vs = vs
        self.buf = bytearray()
        self.transport = None
        self.peer_ip: str | None = None
        self._busy = False        # an async handler owns the buffer head
        self._closed = False
        self._task: asyncio.Task | None = None

    # -- asyncio.Protocol --

    def connection_made(self, transport) -> None:
        self.transport = transport
        if not hasattr(self.vs, "_fast_conns"):
            self.vs._fast_conns = set()
        self.vs._fast_conns.add(transport)
        peer = transport.get_extra_info("peername")
        self.peer_ip = peer[0] if peer else None
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                import socket as _s
                sock.setsockopt(_s.IPPROTO_TCP, _s.TCP_NODELAY, 1)
            except OSError:
                pass

    def connection_lost(self, exc) -> None:
        self._closed = True
        getattr(self.vs, "_fast_conns", set()).discard(self.transport)

    def data_received(self, data: bytes) -> None:
        self.buf += data
        if not self._busy:
            self._pump()

    # -- request pump --

    def _pump(self) -> None:
        """Handle complete fast requests at the head of the buffer;
        upgrade the connection on the first cold one."""
        while not self._closed:
            if self.buf[:1] == _FRAME_MAGIC[:1]:
                # binary frame preamble (util/frame.py): no HTTP method
                # starts with this byte, so the connection is either a
                # frame client or garbage — swap protocols in place
                # once the magic is complete (frameserver drops
                # mismatches with GOAWAY via its decoder)
                if self.buf.startswith(_FRAME_MAGIC):
                    self._upgrade_frames()
                    return
                if len(self.buf) < len(_FRAME_MAGIC) and \
                        _FRAME_MAGIC.startswith(bytes(self.buf)):
                    return            # preamble still arriving
                self._upgrade()       # same first byte, not the magic:
                return                # let the full parser answer
            head_end = self.buf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(self.buf) > 32 * 1024:
                    self._upgrade()      # oversized header block: not ours
                return
            line_end = self.buf.find(b"\r\n")
            req_line = bytes(self.buf[:line_end])
            m = _REQ_LINE.match(req_line)
            bm = None if m else _BATCH_LINE.match(req_line)
            if m is None and bm is None:
                self._upgrade()
                return
            headers = self._parse_headers(head_end, line_end)
            if headers is None:
                self._upgrade()
                return
            if bm is not None:
                query = _parse_query(bm.group(1))
                if query is None:
                    self._upgrade()
                    return
                del self.buf[:head_end + 4]
                self._spawn(self._do_batch(query, headers))
                return
            method = m.group(1)
            query = _parse_query(m.group(3))
            if query is None:
                self._upgrade()
                return
            fid_s = m.group(2).decode()
            if method == b"GET":
                del self.buf[:head_end + 4]
                self._spawn(self._do_get(fid_s, m.group(3), headers,
                                         query))
                return
            if method == b"DELETE":
                if headers.get("content-length", "0") != "0" \
                        or "transfer-encoding" in headers:
                    self._upgrade()  # bodied DELETE: full parser's job
                    return
                del self.buf[:head_end + 4]
                self._spawn(self._do_delete(fid_s, m.group(3), headers,
                                            query))
                return
            # POST/PUT
            if not self._write_is_fast(headers):
                self._upgrade()
                return
            clen = int(headers.get("content-length", "0"))
            total = head_end + 4 + clen
            if len(self.buf) < total:
                return               # body still in flight
            body = bytes(self.buf[head_end + 4:total])
            del self.buf[:total]
            self._spawn(self._do_post(fid_s, m.group(3), headers, query,
                                      body))
            return

    def _spawn(self, coro) -> None:
        """Run an async handler for the request at the buffer head.
        The task handle is retained (an unreferenced asyncio task may be
        garbage-collected mid-flight) and a done-callback closes the
        connection if the handler died before answering — otherwise
        `_busy` would stay set and the connection would wedge silently."""
        self._busy = True
        self._task = asyncio.get_running_loop().create_task(coro)
        self._task.add_done_callback(self._handler_done)

    def _handler_done(self, task: asyncio.Task) -> None:
        if self._task is task:
            # _finish -> _pump may already have spawned the NEXT
            # request's task; never clobber that newer reference
            self._task = None
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None and not self._closed:
            # no response was written for the consumed request: the
            # stream is desynced, closing is the only coherent answer
            self._closed = True
            self._busy = False
            self.transport.close()

    def _parse_headers(self, head_end: int, line_end: int
                       ) -> dict | None:
        """Lower-cased header dict, or None when the block needs the
        full parser (duplicates, continuations, anything malformed)."""
        headers: dict = {}
        block = bytes(self.buf[line_end + 2:head_end])
        if not block:
            return headers
        for raw in block.split(b"\r\n"):
            i = raw.find(b":")
            if i <= 0 or raw[:1] in (b" ", b"\t"):
                return None
            try:
                k = raw[:i].decode("ascii").lower()
                if k in headers:
                    return None   # duplicate headers: full parser's job
                headers[k] = raw[i + 1:].strip().decode("latin-1")
            except UnicodeDecodeError:
                return None
        return headers

    def _write_is_fast(self, headers: dict) -> bool:
        """Writes the shared wire layer can take straight from a raw
        body; the rest (JWT checks, multipart parse, replica-framed
        bodies, chunked uploads) go to the full aiohttp handler."""
        vs = self.vs
        if vs.jwt_key:
            return False             # token checks stay with aiohttp
        if "transfer-encoding" in headers or "expect" in headers:
            return False
        clen = headers.get("content-length")
        if clen is None or not clen.isdigit() or int(clen) > (4 << 20):
            return False
        if headers.get("content-type", "").startswith("multipart/"):
            return False             # multipart parse: cold
        if "x-raw-needle" in headers:
            return False             # replica write framing: cold
        return True

    def _worker_hop(self, headers: dict) -> bool:
        wc = self.vs.worker_ctx
        return wc is not None and \
            wc.token_ok(headers.get("x-swtpu-worker"))

    def _wire_request(self, method: str, fid_s: str, query: dict,
                      headers: dict, body: bytes | None = None
                      ) -> wire.WireRequest:
        return wire.WireRequest(
            method=method, fid_s=fid_s, query=query, headers=headers,
            peer_ip=self.peer_ip, body=body, raw=True,
            worker_hop=self._worker_hop(headers))

    # -- fast handlers (adapters over server/wire.py) --

    async def _do_get(self, fid_s: str, q: bytes, headers: dict,
                      query: dict) -> None:
        vs = self.vs
        wr = self._wire_request("GET", fid_s, query, headers)
        # volume-tier entry span for the fast path; a request that
        # replays into aiohttp cancels it (the full handler's
        # middleware records its own, joined to the same traceparent)
        sp = tracing.start_root("volume", "read", headers=headers)
        with sp:
            resp = await wire.serve_read(vs, wr)
            if resp.upgrade:
                sp.cancel()
                self._upgrade_replay(b"GET", fid_s, headers, q)
                return
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            await self._respond(resp)

    async def _do_post(self, fid_s: str, q: bytes, headers: dict,
                       query: dict, body: bytes) -> None:
        vs = self.vs
        wr = self._wire_request("POST", fid_s, query, headers, body)
        # an intra-host worker hop carries the launch token: the entry
        # worker already ran the guard against the real client IP
        if not wr.worker_hop and not vs.guard.empty \
                and not vs.guard.allows(self.peer_ip):
            self._finish(_R401_IP)
            return
        wc = vs.worker_ctx
        vid_s = fid_s.split(",", 1)[0]
        if wc is not None and not wr.worker_hop \
                and not wc.owns(int(vid_s)):
            self._upgrade_replay(b"POST", fid_s, headers, q, body)
            return
        with tracing.start_root("volume", "write", headers=headers) as sp:
            resp = await wire.serve_write(vs, wr)
            if resp.upgrade:
                sp.cancel()
                self._upgrade_replay(b"POST", fid_s, headers, q, body)
                return
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            await self._respond(resp)

    async def _do_delete(self, fid_s: str, q: bytes, headers: dict,
                         query: dict) -> None:
        vs = self.vs
        wr = self._wire_request("DELETE", fid_s, query, headers)
        if vs.jwt_key:
            # token checks stay with aiohttp (shared guard exemptions)
            self._upgrade_replay(b"DELETE", fid_s, headers, q)
            return
        if not wr.worker_hop and not vs.guard.empty \
                and not vs.guard.allows(self.peer_ip):
            self._finish(_R401_IP)
            return
        wc = vs.worker_ctx
        vid_s = fid_s.split(",", 1)[0]
        if wc is not None and not wr.worker_hop \
                and not wc.owns(int(vid_s)):
            self._upgrade_replay(b"DELETE", fid_s, headers, q)
            return
        with tracing.start_root("volume", "delete",
                                headers=headers) as sp:
            resp = await wire.serve_delete(vs, wr)
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            await self._respond(resp)

    async def _do_batch(self, query: dict, headers: dict) -> None:
        vs = self.vs
        wr = self._wire_request("GET", "", query, headers)
        with tracing.start_root("volume", "batch",
                                headers=headers) as sp:
            resp = await wire.serve_batch(vs, wr)
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            await self._respond(resp)

    # -- response rendering --

    def _encode_head(self, resp: wire.WireResponse) -> bytes:
        out = [b"HTTP/1.1 %d %s\r\n"
               % (resp.status, wire.reason(resp.status).encode())]
        body_len = (len(resp.body) if resp.truncate_to >= 0
                    else resp.content_length)
        if not resp.head or resp.status not in (301, 304):
            out.append(b"Content-Type: "
                       + resp.content_type.encode() + b"\r\n")
        out.append(b"Content-Length: " + str(body_len).encode()
                   + b"\r\n")
        for k, v in resp.headers.items():
            out.append(k.encode("latin-1") + b": "
                       + str(v).encode("latin-1") + b"\r\n")
        out.append(b"\r\n")
        return b"".join(out)

    async def _respond(self, resp: wire.WireResponse) -> None:
        if resp.drop:
            # injected connection drop: sever, don't answer
            self._closed = True
            self._busy = False
            self.transport.close()
            return
        if resp.truncate_to >= 0:
            # failpoint truncate: full Content-Length, partial body,
            # dead socket — the mid-read death degraded reads survive
            if not self._closed:
                self.transport.write(self._encode_head(resp))
                self.transport.write(resp.body[:resp.truncate_to])
            self._closed = True
            self._busy = False
            self.transport.close()
            return
        if resp.sendfile is not None:
            await self._respond_sendfile(resp)
            return
        head = self._encode_head(resp)
        if resp.head or not resp.body:
            self._finish(head)
        elif len(resp.body) < 64 * 1024:
            self._finish(head + resp.body)  # one syscall for small reads
        else:
            self._finish(head, resp.body)

    async def _respond_sendfile(self, resp: wire.WireResponse) -> None:
        """Zero-copy body: headers via transport.write, then the needle
        data region goes disk->socket with loop.sendfile (kernel copy;
        asyncio falls back to executor-chunked reads where sendfile is
        unavailable, e.g. TLS transports)."""
        ref = resp.sendfile
        try:
            if self._closed:
                return
            self.transport.write(self._encode_head(resp))
            try:
                await asyncio.get_running_loop().sendfile(
                    self.transport, ref.file, ref.offset, ref.length,
                    fallback=True)
            except (OSError, RuntimeError):
                # mid-send failure: the declared Content-Length can no
                # longer be honored — sever so the client sees a short
                # body, exactly like a buffered write tear
                self._closed = True
                self.transport.close()
                return
        finally:
            ref.close()
        self._busy = False
        if self.buf and not self._closed:
            self._pump()

    # -- plumbing --

    def _finish(self, out: bytes, body: bytes = b"") -> None:
        if not self._closed:
            self.transport.write(out)
            if body:
                self.transport.write(body)
        self._busy = False
        if self.buf and not self._closed:
            self._pump()

    def _upgrade(self) -> None:
        """Swap this connection onto the full aiohttp protocol, replaying
        any buffered bytes. Keeps the real transport (and so the real
        peer IP) — this is the in-process websocket-upgrade pattern, not
        a proxy hop."""
        proto = self.vs._runner.server()
        raw = bytes(self.buf)
        self.buf.clear()
        self._closed = True          # this protocol is done
        getattr(self.vs, "_fast_conns", set()).discard(self.transport)
        self.transport.set_protocol(proto)
        proto.connection_made(self.transport)
        if raw:
            proto.data_received(raw)

    def _upgrade_frames(self) -> None:
        """Swap this connection onto the frame-protocol terminator
        (server/frameserver.py) — the binary sibling wire — keeping
        the real transport and peer address like the aiohttp upgrade."""
        from .frameserver import FrameServerProtocol
        proto = FrameServerProtocol(self.vs)
        raw = bytes(self.buf[len(_FRAME_MAGIC):])
        self.buf.clear()
        self._closed = True          # this protocol is done
        getattr(self.vs, "_fast_conns", set()).discard(self.transport)
        self.transport.set_protocol(proto)
        proto.connection_made(self.transport)
        if raw:
            proto.data_received(raw)

    def _upgrade_replay(self, method: bytes, fid_s: str,
                        headers: dict, q: bytes = b"",
                        body: bytes = b"") -> None:
        """Upgrade when the fast path discovered mid-request that the
        full handler must serve it: reconstruct the consumed request at
        the FRONT of the buffer, then upgrade."""
        hdr_blob = b"".join(
            k.title().encode() + b": " + v.encode("latin-1") + b"\r\n"
            for k, v in headers.items())
        req = (method + b" /" + fid_s.encode() + q + b" HTTP/1.1\r\n"
               + hdr_blob + b"\r\n" + body)
        self.buf[:0] = req
        self._upgrade()


class FastAssignProtocol(asyncio.Protocol):
    """Master-side fast path for `GET /dir/assign` — the other half of
    every data-plane write (the reference answers it from an in-memory
    VolumeLayout pick + sequencer bump, master_server_handlers.go:60-99;
    that is exactly what runs here, with no HTTP framework between the
    socket and the pick). Leader-less, growth-needing, guarded-rejected
    and every non-assign request upgrade to the aiohttp app unchanged.

    The whole decision is synchronous, so a cold request is detected
    BEFORE any state changes and the original bytes simply stay in the
    buffer for aiohttp — no replay reconstruction needed."""

    _RE = re.compile(rb"^GET /dir/assign((?:\?[^ ]*)?) HTTP/1\.1$")

    __slots__ = ("ms", "buf", "transport", "peer_ip", "_closed")

    def __init__(self, ms) -> None:
        self.ms = ms
        self.buf = bytearray()
        self.transport = None
        self.peer_ip: str | None = None
        self._closed = False

    def connection_made(self, transport) -> None:
        self.transport = transport
        if not hasattr(self.ms, "_fast_conns"):
            self.ms._fast_conns = set()
        self.ms._fast_conns.add(transport)
        peer = transport.get_extra_info("peername")
        self.peer_ip = peer[0] if peer else None

    def connection_lost(self, exc) -> None:
        self._closed = True
        getattr(self.ms, "_fast_conns", set()).discard(self.transport)

    def data_received(self, data: bytes) -> None:
        self.buf += data
        while not self._closed:
            if self.buf[:1] == _FRAME_MAGIC[:1]:
                # binary frame preamble (util/frame.py): raft RPCs,
                # volume heartbeats and client lookups ride the frame
                # fabric onto this same public port — swap protocols
                # in place once the magic is complete, exactly like
                # the volume side's raw listener
                if self.buf.startswith(_FRAME_MAGIC):
                    self._upgrade_frames()
                    return
                if len(self.buf) < len(_FRAME_MAGIC) and \
                        _FRAME_MAGIC.startswith(bytes(self.buf)):
                    return            # preamble still arriving
                self._upgrade()       # same first byte, not the magic
                return
            head_end = self.buf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(self.buf) > 32 * 1024:
                    self._upgrade()
                return
            m = self._RE.match(bytes(self.buf[:self.buf.find(b"\r\n")]))
            if m is None:
                self._upgrade()
                return
            out = self._assign(m.group(1))
            if out is None:
                self._upgrade()     # cold: bytes stay buffered
                return
            del self.buf[:head_end + 4]
            self.transport.write(out)

    def _assign(self, q: bytes) -> bytes | None:
        """Synchronous assign; None => let aiohttp handle it."""
        ms = self.ms
        if _fp_pending("master.assign"):
            return None             # armed failpoint: full handler fires it
        if not ms.is_leader:
            return None             # leader proxy path
        count_s = collection = replication = ttl = b""
        if q not in (b"", b"?"):
            for kv in q[1:].split(b"&"):
                k, _, val = kv.partition(b"=")
                if k == b"count":
                    count_s = val
                elif k == b"collection":
                    collection = val
                elif k == b"replication":
                    replication = val
                elif k == b"ttl":
                    ttl = val
                elif k not in (b"dataCenter", b""):
                    return None     # unknown knob: full handler decides
                elif k == b"dataCenter" and val:
                    return None     # dc-constrained growth: cold
        if b"%" in q or b"+" in q:
            return None             # urlencoded values: full parser
        if not ms.guard.empty and not ms.guard.allows(self.peer_ip):
            return _R401_IP
        try:
            count = int(count_s or 1)
        except ValueError:
            return None
        coll = collection.decode()
        repl = replication.decode() or ms.default_replication
        ttl_s = ttl.decode()
        try:
            from ..storage.super_block import ReplicaPlacement
            rp = ReplicaPlacement.parse(repl)
        except ValueError as e:
            return _json_err(400, "Bad Request", str(e))
        from ..storage import types as t
        lay = ms._layout(coll, repl, ttl_s)
        vid = lay.pick_for_write(ms.topo, rp.copy_count)
        if vid is None:
            return None             # growth: serialized in aiohttp
        try:
            key = ms.seq.next_file_id(count)
        except SequenceBehind:
            # committed fid window spent: the full handler raft-commits
            # a fresh reservation before answering (multi-master)
            return None
        ms.count_assign()
        fid = str(t.FileId(vid, key, t.random_cookie()))
        node = ms.topo.lookup(vid)[0]
        out = {"fid": fid, "url": node.url, "publicUrl": node.public_url,
               "count": count}
        if ms.jwt_key:
            from ..security.jwt import gen_jwt
            out["auth"] = gen_jwt(ms.jwt_key, fid)
        body = json.dumps(out).encode()
        return (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/json; charset=utf-8\r\n"
                b"Content-Length: " + str(len(body)).encode()
                + b"\r\n\r\n" + body)

    def _upgrade(self) -> None:
        proto = self.ms._runner.server()
        raw = bytes(self.buf)
        self.buf.clear()
        self._closed = True
        getattr(self.ms, "_fast_conns", set()).discard(self.transport)
        self.transport.set_protocol(proto)
        proto.connection_made(self.transport)
        if raw:
            proto.data_received(raw)

    def _upgrade_frames(self) -> None:
        """Swap onto the master's frame terminator
        (master/frameadapter.py). The assign ACCELERATOR worker has no
        frame surface (its `ms` is not a MasterServer) — there a frame
        preamble upgrades onto the proxy app, which closes the
        connection and the client's channel falls back to HTTP."""
        factory = getattr(self.ms, "frame_protocol", None)
        if factory is None:
            self._upgrade()
            return
        proto = factory()
        raw = bytes(self.buf[len(_FRAME_MAGIC):])
        self.buf.clear()
        self._closed = True
        getattr(self.ms, "_fast_conns", set()).discard(self.transport)
        self.transport.set_protocol(proto)
        proto.connection_made(self.transport)
        if raw:
            proto.data_received(raw)


class AcceleratorAssignProtocol(FastAssignProtocol):
    """Raw listener of a master assign-accelerator worker
    (server/workers.py AssignAccelerator): identical wire discipline to
    FastAssignProtocol (the `ms` slot holds the accelerator, which
    exposes the same `_runner`/`_fast_conns` surface), but the assign
    decision comes from the accelerator's leased ids + writable-set
    snapshot instead of the live topology, and a cold request upgrades
    onto the accelerator's transparent proxy app."""

    __slots__ = ()

    def _assign(self, q: bytes) -> bytes | None:
        return self.ms.fast_assign(q, self.peer_ip)
