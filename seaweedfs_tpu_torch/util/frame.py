"""Binary framed RPC for the cluster data fabric: ONE wire, no HTTP.

The `-workers` sibling hop (and the client's pipelined multi-read)
used to re-serialize a full HTTP request/response per needle through
aiohttp — per-hop header parsing, header re-emission and one
round-trip per request. This module replaces that hop — and, since
the frame-fabric PR, every inter-host hop (replication fan-out,
client uploads/deletes, EC shard gather, master heartbeat/lookup,
raft vote/append/snapshot) — with a compact length-prefixed frame
spoken over persistent connections:

    u32  length      bytes after this field (= 12 + meta + payload)
    u8   type        HELLO / HELLO_OK / REQ / RESP / GOAWAY
    u8   flags       FLAG_FALLBACK: peer cannot serve this over frames
    u16  meta_len    compact-JSON meta blob length
    u64  req_id      multiplexing id (responses interleave freely)
    meta bytes       {"m","p","q","h"} request / {"s","h","ct"} response
    payload bytes    raw body — never escaped, never chunked

A connection opens with the ``MAGIC`` preamble (not a valid HTTP
method, so the volume server's raw listener — and the master's fast
assign listener — sniffs it and swaps the connection onto the frame
protocol in place), then a HELLO frame carrying the worker launch
token (empty for plain clients — reads are open exactly like the HTTP
listeners; JWT write tokens ride in the request meta headers like any
other header) and, on jwt-secured clusters, a signed ``id`` claim
minted from the cluster signing key: a HELLO presenting neither a
valid worker token nor a valid identity is refused with GOAWAY before
any payload is served. Requests are MULTIPLEXED: many in-flight
req_ids per connection, responses complete out of order, and a
pipelining client keeps the socket full instead of paying a round
trip per needle. The in-flight window is congestion-aware: an AIMD
controller fed by per-request round-trip times shrinks it when RTTs
rise above the channel's observed floor (queue building at the peer)
and grows it additively as responses drain; the floor expires when the
requests written with none of the channel's others in flight show the
peer's service time stepping up.

Server side terminates frames in server/frameserver.py — a thin
adapter over server/wire.py exactly like the two HTTP listeners, so
cache/span/failpoint/Range/group-commit semantics stay wired once.

Failure discipline: `worker.frame` failpoint at every request send;
transport errors raise :class:`FrameChannelError` (an OSError) and the
callers fall back to the HTTP hop, so a peer that predates the
protocol — or a chaos run severing it — degrades to exactly the
pre-frame behavior. Each channel shares util/resilience.py's
CircuitBreaker: repeated channel failures open the breaker so callers
fail fast to HTTP, and the half-open probe re-tries frames instead of
downgrading forever.

A copy of seaweedfs_tpu/util/frame.py in the PyTorch port, with two
changes: the RTT floor expires when the peer's service time steps up
(the reference's lasts the connection's life), and FrameHub.pick spreads
a client over the workers of a `-workers` fleet.
"""

from __future__ import annotations

import asyncio
import collections
import json
import struct

from . import failpoints, glog
from .resilience import Backoff, BreakerRegistry, CircuitBreaker

MAGIC = b"SWFR1\n"

# the fid-shaped claim a HELLO identity token is minted for
# (security/jwt.py gen_jwt binds every token to a fid; the handshake's
# "fid" is this constant, so a stolen per-needle write token can never
# double as a channel identity)
HELLO_IDENTITY_FID = "frame:hello"
HELLO_IDENTITY_TTL_S = 30

HELLO = 1
HELLO_OK = 2
REQ = 3
RESP = 4
GOAWAY = 7

# RESP flag: the peer understood the request but cannot serve it over
# frames (manifest assembly, jwt-guarded write on a token-less hop,
# ...) — the caller must retry over HTTP
FLAG_FALLBACK = 1

VERSION = 1

_HDR = struct.Struct(">IBBHQ")
HEADER_SIZE = _HDR.size            # 16 incl. the length field itself

# one frame may carry a whole /batch response (64MB budget) plus meta
MAX_FRAME = (64 << 20) + (1 << 20)
MAX_META = 256 * 1024

_COMPACT = {"separators": (",", ":")}


class FrameError(ValueError):
    """Corrupt/hostile frame stream: torn header, oversized or
    negative lengths, non-JSON meta. The connection must be dropped —
    framing never resynchronizes."""


class FrameChannelError(OSError):
    """Transport-level channel failure (peer down, handshake refused,
    timeout): the caller's cue to fall back to the HTTP hop."""


def encode_frame(ftype: int, req_id: int, meta: dict | None = None,
                 payload: bytes = b"", flags: int = 0) -> bytes:
    mb = json.dumps(meta, **_COMPACT).encode() if meta else b""
    if len(mb) > MAX_META:
        raise FrameError(f"meta blob {len(mb)}B exceeds {MAX_META}")
    return _HDR.pack(12 + len(mb) + len(payload), ftype, flags,
                     len(mb), req_id) + mb + payload


class Frame:
    __slots__ = ("type", "flags", "req_id", "meta", "payload")

    def __init__(self, ftype: int, flags: int, req_id: int,
                 meta: dict, payload: bytes) -> None:
        self.type = ftype
        self.flags = flags
        self.req_id = req_id
        self.meta = meta
        self.payload = payload


class FrameDecoder:
    """Incremental frame reassembler: feed() arbitrary chunks, get the
    complete frames back. Raises :class:`FrameError` on anything a
    well-formed peer could never send (the stream is then garbage and
    the connection must close — there is no resync point)."""

    __slots__ = ("_buf", "overhead_bytes", "frames")

    def __init__(self) -> None:
        self._buf = bytearray()
        self.overhead_bytes = 0        # header+meta bytes decoded
        self.frames = 0

    def feed(self, data: bytes) -> list[Frame]:
        self._buf += data
        out: list[Frame] = []
        while len(self._buf) >= HEADER_SIZE:
            length, ftype, flags, meta_len, req_id = _HDR.unpack_from(
                self._buf)
            if length < 12:
                raise FrameError(f"frame length {length} < fixed 12")
            if length > MAX_FRAME:
                raise FrameError(f"frame length {length} exceeds "
                                 f"{MAX_FRAME}")
            if meta_len > length - 12 or meta_len > MAX_META:
                raise FrameError(f"meta length {meta_len} exceeds "
                                 f"frame {length}")
            total = 4 + length
            if len(self._buf) < total:
                return out
            meta: dict = {}
            if meta_len:
                try:
                    meta = json.loads(bytes(self._buf[16:16 + meta_len]))
                except ValueError as e:
                    raise FrameError(f"bad frame meta: {e}") from e
                if not isinstance(meta, dict):
                    raise FrameError("frame meta is not an object")
            payload = bytes(self._buf[16 + meta_len:total])
            del self._buf[:total]
            self.overhead_bytes += HEADER_SIZE + meta_len
            self.frames += 1
            out.append(Frame(ftype, flags, req_id, meta, payload))
        return out

    @property
    def pending(self) -> bool:
        return bool(self._buf)


class FrameFallback(FrameChannelError):
    """The peer answered FLAG_FALLBACK: this request must ride HTTP."""


class ChannelStats:
    """Deterministic per-channel accounting (tools/bench_needle.py's
    sibling-hop scoreboard): every number is a plain event count, so
    two runs of the same workload produce the same values."""

    __slots__ = ("requests", "responses", "overhead_out", "overhead_in",
                 "payload_out", "payload_in", "connects", "writes",
                 "reads", "fallbacks", "window_shrinks", "window_grows",
                 "service_steps")

    def __init__(self) -> None:
        self.requests = 0
        self.responses = 0
        self.overhead_out = 0          # header+meta bytes sent
        self.overhead_in = 0           # header+meta bytes received
        self.payload_out = 0
        self.payload_in = 0
        self.connects = 0
        self.writes = 0                # socket write calls
        self.reads = 0                 # socket read calls with data
        self.fallbacks = 0
        self.window_shrinks = 0        # AIMD multiplicative decreases
        self.window_grows = 0          # AIMD additive increases
        self.service_steps = 0         # floor expired: service stepped

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class FrameChannel:
    """One persistent multiplexed frame connection to a peer.

    ``request()`` is safe to call concurrently — that IS the pipeline:
    each call takes the next req_id, registers a future and writes its
    frame; the single reader task completes futures as RESP frames
    arrive, in whatever order the peer answers.

    Reconnects lazily with jittered backoff (util/resilience.Backoff):
    while the backoff window is open, requests fail fast with
    :class:`FrameChannelError` so callers hit their HTTP fallback in
    microseconds instead of a connect timeout. An idle connection
    (no traffic for ``idle_s``) is closed client-side and transparently
    reopened by the next request.

    The in-flight window is congestion-aware (AIMD): every completed
    request feeds its round-trip time to :meth:`_observe_rtt`; RTTs
    rising past twice the channel's observed floor shrink the window
    multiplicatively, drained responses grow it additively. Requests
    written with none of the channel's others in flight measure the
    peer's service time, so a step up in that moves the floor instead
    of pinning the window at one request. Callers
    that pipeline harder than the window simply queue on the channel,
    bounded by the request timeout.

    ``worker`` pins the channel to one worker of a ``-workers`` fleet
    (FrameHub.pick): SO_REUSEPORT hands each connection to any worker,
    and the handshake names the one it reached."""

    CWND_INIT = 8.0
    CWND_MIN = 1
    CWND_MAX = 64

    def __init__(self, target: str = "", uds_path: str = "",
                 token: str = "", connect_timeout: float = 5.0,
                 request_timeout: float = 30.0, idle_s: float = 60.0,
                 ssl=None, jwt_key: str = "", hop: str = "",
                 breaker: CircuitBreaker | None = None,
                 worker: int | None = None):
        if not target and not uds_path:
            raise ValueError("FrameChannel needs a tcp target or a "
                             "unix socket path")
        self.target = target            # "ip:port" (TCP fallback)
        self.uds_path = uds_path        # preferred intra-host transport
        self.token = token
        self.jwt_key = jwt_key          # mints the HELLO identity claim
        # sibling = intra-host worker hop, interhost = cluster fabric
        self.hop = hop or ("sibling" if uds_path else "interhost")
        self.breaker = breaker
        self.worker = worker            # fleet worker to reach, or any
        self.peer_worker: int | None = None   # from the last handshake
        self.peer_workers = 1                 # the peer fleet's size
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.idle_s = idle_s
        self._ssl = ssl
        self.stats = ChannelStats()
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 1
        self._conn_lock = asyncio.Lock()
        self._backoff = Backoff(base=0.05, cap=2.0)
        self._retry_at = 0.0            # monotonic fail-fast gate
        self._closed = False
        self._cwnd = float(self.CWND_INIT)
        self._rtt_best = float("inf")   # per-connection RTT floor
        # the latest RTTs of requests written with nothing of ours
        # pending: the window over which the floor may expire
        self._lone: collections.deque[float] = collections.deque(
            maxlen=int(self.CWND_INIT))
        self._inflight = 0
        self._win_waiters: collections.deque[asyncio.Future] = \
            collections.deque()
        self._gauge_open = False

    @property
    def connected(self) -> bool:
        return self._writer is not None

    @property
    def window(self) -> int:
        """Current congestion window (max in-flight requests)."""
        return max(self.CWND_MIN, int(self._cwnd))

    def _label(self) -> str:
        return self.uds_path or self.target

    # ---- congestion window (AIMD) ----

    def _observe_rtt(self, rtt: float, alone: bool = False) -> None:
        """One completed request's round trip. RTT above 2x the
        channel's floor means queueing at the peer: shrink the window
        multiplicatively; otherwise grow it additively (classic AIMD,
        deterministic given the sample sequence). At CWND_MIN an RTT
        over the bound changes nothing: growing there only to shrink
        on the next response is a cycle, not a probe.

        The floor is the lowest RTT seen, until the peer's service time
        steps up (a slower disk, a pause, a cold cache). ``alone`` says
        no other request of this channel was at the peer when this one
        was written, so it queued behind none of ours. When the last
        CWND_INIT lone RTTs all exceed twice the floor, the floor
        becomes the lowest of them, a windowed minimum as BBR's min-RTT
        filter keeps one. No single sample moves it, and queueing that
        other channels cause at a shared peer raises it only to what
        this channel's requests, one at a time, still see. The window
        then grows back additively. A floor kept for the connection's
        life would read every later RTT as queueing and hold the window
        at one request until a reconnect."""
        if alone:
            self._lone.append(rtt)
        if rtt < self._rtt_best:
            self._rtt_best = rtt
        elif len(self._lone) == self._lone.maxlen \
                and min(self._lone) > self._rtt_best * 2:
            self._rtt_best = min(self._lone)
            self.stats.service_steps += 1
        if rtt > self._rtt_best * 2:
            if self._cwnd > self.CWND_MIN:
                self._cwnd = max(float(self.CWND_MIN), self._cwnd * 0.7)
                self.stats.window_shrinks += 1
        elif self._cwnd < self.CWND_MAX:
            self._cwnd = min(float(self.CWND_MAX),
                             self._cwnd + 1.0 / max(self._cwnd, 1.0))
            self.stats.window_grows += 1
        self._wake_waiters()

    def _wake_waiters(self) -> None:
        while self._win_waiters and self._inflight < self.window:
            fut = self._win_waiters.popleft()
            if not fut.done():
                # reserve the slot for the woken waiter so a burst of
                # releases cannot over-admit past the window
                self._inflight += 1
                fut.set_result(None)

    async def _acquire_slot(self, timeout: float) -> None:
        if self._inflight < self.window:
            self._inflight += 1
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._win_waiters.append(fut)
        acquired = False
        try:
            await asyncio.wait_for(fut, timeout)
            acquired = True
        except asyncio.TimeoutError as e:
            raise FrameChannelError(
                f"frame channel {self._label()}: congestion window "
                f"wait timed out (window={self.window}, "
                f"in flight={self._inflight})") from e
        finally:
            if not acquired:
                # timeout OR caller cancellation must leave no trace:
                # drop the queue entry, and if _wake_waiters already
                # reserved a slot for this fut in the same tick, give
                # the slot back — a cancelled waiter used to leak its
                # reservation and permanently shrink the window
                try:
                    self._win_waiters.remove(fut)
                except ValueError:
                    if fut.done() and not fut.cancelled() \
                            and fut.exception() is None:
                        self._release_slot()

    def _release_slot(self) -> None:
        self._inflight -= 1
        self._wake_waiters()

    async def _connect(self) -> None:
        loop = asyncio.get_running_loop()
        if self._retry_at and loop.time() < self._retry_at:
            raise FrameChannelError(
                f"frame channel {self._label()}: reconnect backoff "
                f"window open")
        # a channel pinned to a worker dials again while SO_REUSEPORT
        # hands it another; after 4 dials a worker it keeps what it
        # got, so a worker that is down or respawning stops nothing
        dials = 0
        while True:
            reader, writer, dec, frames = await self._dial(loop)
            dials += 1
            meta = frames[0].meta or {}
            got, n = meta.get("worker"), meta.get("workers")
            self.peer_worker = got if isinstance(got, int) else None
            self.peer_workers = n if isinstance(n, int) and n > 0 else 1
            if self.worker is None or got == self.worker \
                    or dials >= 4 * self.peer_workers:
                break
            writer.close()
        self._backoff.reset()
        self._retry_at = 0.0
        self._writer = writer
        self.stats.connects += 1
        self._rtt_best = float("inf")  # fresh RTT floor per connection
        self._lone.clear()
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS and not self._gauge_open:
            metrics.FRAME_OPEN_CHANNELS.labels(self._label()).inc()
            self._gauge_open = True
        self._reader_task = loop.create_task(
            self._read_loop(reader, writer, dec))
        # frames the peer pipelined behind HELLO_OK in the same chunk
        for fr in frames[1:]:
            self._dispatch(fr)

    async def _dial(self, loop):
        """One connection and its handshake: (reader, writer, decoder,
        frames), the first frame the peer's HELLO_OK."""
        writer = None
        try:
            if self.uds_path:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(self.uds_path),
                    self.connect_timeout)
            else:
                host, _, port = self.target.rpartition(":")
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port),
                                            ssl=self._ssl),
                    self.connect_timeout)
            hello_meta: dict = {"v": VERSION, "token": self.token}
            if self.jwt_key:
                from ..security.jwt import gen_jwt
                hello_meta["id"] = gen_jwt(self.jwt_key,
                                           HELLO_IDENTITY_FID,
                                           HELLO_IDENTITY_TTL_S)
            writer.write(MAGIC + encode_frame(HELLO, 0, hello_meta))
            await asyncio.wait_for(writer.drain(), self.connect_timeout)
            dec = FrameDecoder()
            frames: list[Frame] = []
            while not frames:
                chunk = await asyncio.wait_for(reader.read(65536),
                                               self.connect_timeout)
                if not chunk:
                    raise FrameChannelError(
                        f"frame channel {self._label()}: peer closed "
                        f"during handshake (predates the protocol?)")
                frames = dec.feed(chunk)
            hello = frames[0]
            if hello.type != HELLO_OK:
                why = str((hello.meta or {}).get("error", "")) \
                    if hello.type == GOAWAY else ""
                raise FrameChannelError(
                    f"frame channel {self._label()}: handshake "
                    f"refused (type {hello.type}"
                    + (f": {why}" if why else "") + ")")
        except (OSError, asyncio.TimeoutError, FrameError,
                asyncio.IncompleteReadError) as e:
            # the just-opened socket must not leak on a failed
            # handshake (a pre-frame peer holds it open forever)
            if writer is not None:
                try:
                    writer.close()
                except OSError:
                    pass
            self._retry_at = loop.time() + self._backoff.next()
            if isinstance(e, FrameChannelError):
                raise
            raise FrameChannelError(
                f"frame channel {self._label()}: {e}") from e
        return reader, writer, dec, frames

    async def _read_loop(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         dec: FrameDecoder) -> None:
        err: BaseException | None = None
        try:
            while True:
                try:
                    chunk = await asyncio.wait_for(
                        reader.read(1 << 18),
                        self.idle_s if not self._pending else
                        self.request_timeout)
                except asyncio.TimeoutError:
                    if self._pending:
                        err = FrameChannelError(
                            f"frame channel {self._label()}: response "
                            f"timeout with {len(self._pending)} "
                            f"in flight")
                        return
                    return                     # idle: close quietly
                if not chunk:
                    err = FrameChannelError(
                        f"frame channel {self._label()}: peer closed")
                    return
                self.stats.reads += 1
                before = dec.overhead_bytes
                for fr in dec.feed(chunk):
                    self._dispatch(fr)
                self.stats.overhead_in += dec.overhead_bytes - before
        except FrameError as e:
            err = FrameChannelError(
                f"frame channel {self._label()}: {e}")
        except asyncio.CancelledError:
            err = FrameChannelError(
                f"frame channel {self._label()}: closed")
            raise
        finally:
            self._teardown(writer, err)

    def _dispatch(self, fr: Frame) -> None:
        fut = self._pending.pop(fr.req_id, None)
        if fut is None or fut.done():
            return                      # late response for a timed-out id
        self.stats.responses += 1
        self.stats.payload_in += len(fr.payload)
        if fr.flags & FLAG_FALLBACK:
            self.stats.fallbacks += 1
            fut.set_exception(FrameFallback(
                f"frame peer {self._label()} asked for HTTP fallback"))
            return
        hdrs = dict(fr.meta.get("h") or {})
        ct = fr.meta.get("ct")
        if ct and not any(k.lower() == "content-type" for k in hdrs):
            hdrs["content-type"] = str(ct)
        fut.set_result((int(fr.meta.get("s", 500)), hdrs, fr.payload,
                        fr.meta))

    def _teardown(self, writer: asyncio.StreamWriter,
                  err: BaseException | None) -> None:
        if self._writer is writer:
            self._writer = None
            self._reader_task = None
            if self._gauge_open:
                from ..stats import metrics
                if metrics.HAVE_PROMETHEUS:
                    metrics.FRAME_OPEN_CHANNELS.labels(
                        self._label()).dec()
                self._gauge_open = False
        try:
            writer.close()
        except OSError:
            pass
        # ALWAYS fail whatever is pending — a request that raced the
        # idle close (registered after the reader's last pending
        # check) must fall back to HTTP now, not stall to its 30s
        # response timeout on a dead socket
        if self._pending:
            msg = str(err) if err is not None else \
                f"frame channel {self._label()}: closed while idle"
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(FrameChannelError(msg))
            self._pending.clear()

    async def request(self, method: str, path: str,
                      query: dict | None = None,
                      headers: dict | None = None, body: bytes = b"",
                      timeout: float | None = None
                      ) -> tuple[int, dict, bytes]:
        """One multiplexed request; returns (status, headers, body).
        Raises FrameFallback when the peer wants this over HTTP and
        FrameChannelError on any transport-level failure. A transport
        failure is an HTTP downgrade THIS process observed, counted in
        SeaweedFS_frame_fallbacks_total — the severed-wire alert
        signal (FLAG_FALLBACK answers are counted by the SERVER that
        sent them, so one logical downgrade never counts twice on a
        merged host). An open circuit breaker (repeated channel
        failures) fails fast here without touching the socket; its
        half-open window admits a probe so frames resume on their own
        once the peer heals."""
        br = self.breaker
        if br is not None and not br.allow():
            from ..stats import metrics
            if metrics.HAVE_PROMETHEUS:
                metrics.FRAME_FALLBACKS.labels(self.hop).inc()
            raise FrameChannelError(
                f"frame channel {self._label()}: circuit open")
        try:
            out = await self._request(method, path, query, headers,
                                      body, timeout)
        except FrameFallback:
            # server-advised downgrade: the peer is alive and counted
            # it — not a channel failure, the breaker stays closed
            if br is not None:
                br.record_success()
            raise
        except FrameChannelError:
            from ..stats import metrics
            if metrics.HAVE_PROMETHEUS:
                metrics.FRAME_FALLBACKS.labels(self.hop).inc()
            if br is not None:
                br.record_failure()
            raise
        if br is not None:
            br.record_success()
        return out

    async def _request(self, method: str, path: str,
                       query: dict | None, headers: dict | None,
                       body: bytes, timeout: float | None
                       ) -> tuple[int, dict, bytes]:
        if self._closed:
            raise FrameChannelError(
                f"frame channel {self._label()}: closed")
        # chaos site: injected frame-hop faults take the exact
        # fallback-to-HTTP path a dead sibling does (FailpointError is
        # a plain OSError — rewrap so callers' single except arm sees
        # a channel failure)
        try:
            await failpoints.fail("worker.frame")
        except OSError as e:
            raise FrameChannelError(
                f"frame channel {self._label()}: {e}") from e
        deadline = timeout if timeout is not None else \
            self.request_timeout
        await self._acquire_slot(deadline)
        try:
            if self._writer is None:
                async with self._conn_lock:
                    if self._writer is None and not self._closed:
                        await self._connect()
            writer = self._writer
            if writer is None:
                raise FrameChannelError(
                    f"frame channel {self._label()}: not connected")
            req_id = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF or 1
            meta: dict = {"m": method, "p": path}
            if query:
                meta["q"] = query
            if headers:
                meta["h"] = headers
            # encode BEFORE registering the future: an oversize-meta
            # FrameError must not leak a pending entry (which would
            # flip the reader loop onto the response timeout forever)
            frame = encode_frame(REQ, req_id, meta, body)
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            alone = not self._pending   # none of ours ahead at the peer
            self._pending[req_id] = fut
            self.stats.requests += 1
            from ..stats import metrics
            if metrics.HAVE_PROMETHEUS:
                metrics.FRAME_REQUESTS.labels("client", self.hop).inc()
            self.stats.overhead_out += len(frame) - len(body)
            self.stats.payload_out += len(body)
            self.stats.writes += 1
            t0 = loop.time()
            try:
                writer.write(frame)
                await writer.drain()
                status, hdrs, payload, _ = await asyncio.wait_for(
                    fut, deadline)
                self._observe_rtt(loop.time() - t0, alone)
                return status, hdrs, payload
            except asyncio.TimeoutError as e:
                raise FrameChannelError(
                    f"frame channel {self._label()}: request timeout") \
                    from e
            except (OSError, ConnectionResetError) as e:
                if isinstance(e, FrameChannelError):
                    raise
                raise FrameChannelError(
                    f"frame channel {self._label()}: {e}") from e
            finally:
                # drop the pending entry on EVERY exit — the success
                # path's _dispatch already popped it (idempotent), but
                # a caller cancelled inside drain()/wait_for() used to
                # leak the entry until response arrival or teardown,
                # pinning the reader loop's timeout accounting
                self._pending.pop(req_id, None)
        finally:
            self._release_slot()

    async def close(self) -> None:
        self._closed = True
        task = self._reader_task
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except OSError as e:
                glog.V(2).infof("frame channel %s close: %s",
                                self._label(), e)
        writer = self._writer
        if writer is not None:
            self._teardown(writer, FrameChannelError("channel closed"))


class FrameHub:
    """Channel cache keyed by destination — the per-sibling (and
    per-volume-server, for client pipelining) persistent connections.
    Bounded; replacing a key (a sibling respawned on a new private
    port / unix socket) schedules the old channel's close."""

    MAX_CHANNELS = 64

    def __init__(self, token: str = "", request_timeout: float = 30.0,
                 ssl=None, jwt_key: str = "",
                 breakers: BreakerRegistry | None = None):
        self.token = token
        self.jwt_key = jwt_key
        self.request_timeout = request_timeout
        self._ssl = ssl
        # repeated channel failures open the per-peer breaker: callers
        # fail fast to HTTP, the half-open probe re-tries frames
        # (threshold/reset sized to match the connect Backoff cap)
        self.breakers = breakers if breakers is not None else \
            BreakerRegistry(threshold=5, reset_timeout=2.0,
                            half_open_max=2)
        self._channels: dict[str, FrameChannel] = {}
        self._turns: dict[str, int] = {}

    def get(self, target: str = "", uds_path: str = "",
            hop: str = "", worker: int | None = None) -> FrameChannel:
        key = uds_path or target
        if worker is not None:
            key = f"{key}#w{worker}"
        ch = self._channels.get(key)
        if ch is None:
            if len(self._channels) >= self.MAX_CHANNELS:
                old_key, old = next(iter(self._channels.items()))
                del self._channels[old_key]
                _close_soon(old)
            ch = self._channels[key] = FrameChannel(
                target=target, uds_path=uds_path, token=self.token,
                request_timeout=self.request_timeout, ssl=self._ssl,
                jwt_key=self.jwt_key, hop=hop,
                breaker=self.breakers.get(f"frame:{key}"),
                worker=worker)
        return ch

    def pick(self, target: str) -> FrameChannel:
        """The channel for one request to the server at ``target``,
        spread over the workers of a ``-workers`` fleet as an HTTP
        client's pooled connections are. SO_REUSEPORT hands each
        connection to one worker, so with one channel every request of
        this client would enter at that worker, and each request for
        another worker's volume would cross its sibling hop. Once the
        first channel's handshake reports N workers, requests take N
        channels in turn, each pinned to its worker. A server that is
        no fleet, or does not report its size, keeps the one channel."""
        ch = self.get(target=target)
        n = ch.peer_workers
        if n <= 1:
            return ch
        if ch.worker is None:
            ch.worker = ch.peer_worker      # its worker, on a redial too
        turn = self._turns.get(target, 0)
        self._turns[target] = (turn + 1) % n
        if turn == ch.worker:
            return ch
        return self.get(target=target, worker=turn)

    def stats_dict(self) -> dict:
        return {key: ch.stats.to_dict()
                for key, ch in self._channels.items()}

    async def close(self) -> None:
        chans = list(self._channels.values())
        self._channels.clear()
        for ch in chans:
            await ch.close()


def _close_soon(ch: FrameChannel) -> None:
    """Schedule an evicted channel's close without awaiting it (the
    eviction happens inside a sync get()); the task handle is retained
    on the channel so it cannot be GC'd mid-close."""
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        return
    ch._close_task = loop.create_task(ch.close())  # type: ignore[attr-defined]


def overhead_model(method: str, path: str, query: dict | None = None,
                   headers: dict | None = None,
                   resp_headers: dict | None = None,
                   resp_ct: str = "application/octet-stream") -> int:
    """Deterministic frame protocol overhead (bytes) for one logical
    request+response, excluding payload — the frame side of
    bench_needle's sibling-hop accounting, computed from the real
    codec so it can never drift from the wire."""
    req = encode_frame(REQ, 1, {"m": method, "p": path,
                                **({"q": query} if query else {}),
                                **({"h": headers} if headers else {})})
    resp = encode_frame(RESP, 1, {"s": 200, "h": resp_headers or {},
                                  "ct": resp_ct})
    return len(req) + len(resp)
