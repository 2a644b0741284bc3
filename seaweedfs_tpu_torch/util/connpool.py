"""Keep-alive connection pools for SYNC (executor-thread) fetches.

The EC degraded-read path runs inside executor threads and cannot use
the server's aiohttp session; it used to open a fresh
urllib/TCP(+TLS) connection PER shard interval — exactly the k-fetch
fan-out cost the repair-bandwidth literature (arxiv 1309.0186) says
dominates recovery. These pools keep idle connections per target so a
degraded-read burst pays one handshake per holder, not one per
interval.

Two pools share the same discipline (thread-safe take/give, max-idle
age eviction, retry-once-on-stale so a respawned peer's poisoned
sockets never surface to the caller):

* :class:`SyncHttpPool` — `http.client` keep-alive HTTP.
* :class:`SyncFramePool` — the binary frame protocol (util/frame.py)
  over raw sockets: the same shard gather with per-request overhead
  measured in tens of bytes instead of HTTP headers. A peer that does
  not speak frames raises :class:`FrameUnsupported` and the caller
  falls back to the HTTP pool.

A copy of seaweedfs_tpu/util/connpool.py in the PyTorch port.
"""

from __future__ import annotations

import http.client
import random
import socket
import threading
import time

from ..security import tls
from . import events, glog
from .frame import (FrameDecoder, FrameError, HELLO, HELLO_IDENTITY_FID,
                    HELLO_IDENTITY_TTL_S, HELLO_OK, MAGIC, REQ, RESP,
                    VERSION, encode_frame)


class PoolError(OSError):
    pass


class FrameUnsupported(PoolError):
    """The target refused the frame handshake (predates the protocol
    or chaos severed it): retry this request over HTTP."""


class FrameProbeGate:
    """Per-target frame-downgrade bookkeeping with jittered
    exponential backoff — the fix for the old sticky 60s HTTP
    downgrade, where one transient peer restart silenced frames for a
    full minute with no signal. Each refusal doubles the re-probe
    delay (jittered +/-50% so a fleet of fetchers doesn't re-probe in
    lockstep) up to ``cap_s``; a frame success resets the target.
    Every downgrade is journaled as a ``frame_downgrade`` event.
    Thread-safe: the EC gather calls this from executor threads."""

    def __init__(self, base_s: float = 1.0, cap_s: float = 60.0,
                 max_targets: int = 256, rng=None, clock=time.monotonic):
        self.base_s = base_s
        self.cap_s = cap_s
        self.max_targets = max_targets
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        # target -> (monotonic re-probe time, consecutive refusals)
        self._state: dict[str, tuple[float, int]] = {}
        self._lock = threading.Lock()

    def allow(self, target: str) -> bool:
        """True when frames should be tried for this target (never
        refused, or its backoff window has expired)."""
        with self._lock:
            st = self._state.get(target)
            return st is None or self._clock() >= st[0]

    def refused(self, target: str, reason: str = "") -> float:
        """Record a frame refusal; returns the chosen re-probe delay
        and journals the downgrade so it is never silent."""
        with self._lock:
            if target not in self._state \
                    and len(self._state) >= self.max_targets:
                self._state.clear()
            strikes = self._state.get(target, (0.0, 0))[1] + 1
            delay = min(self.cap_s,
                        self.base_s * (2 ** min(strikes - 1, 16)))
            delay = min(self.cap_s,
                        delay * (0.5 + self._rng.random()))
            self._state[target] = (self._clock() + delay, strikes)
        events.record("frame_downgrade", target=target,
                      retry_in_s=round(delay, 3), strikes=strikes,
                      reason=reason[:160])
        return delay

    def ok(self, target: str) -> None:
        """A frame request succeeded: clear the target's downgrade."""
        with self._lock:
            self._state.pop(target, None)


class _IdlePool:
    """Shared idle-connection store: per-target LIFO stacks with a
    max-idle age. A connection parked longer than ``max_idle_s`` is
    closed instead of reused — a sibling worker respawn (new process,
    same address) otherwise leaves every pooled socket pointing at a
    dead peer until each one surfaces an error to a caller."""

    def __init__(self, per_target: int, max_idle_s: float):
        self._idle: dict[str, list[tuple[float, object]]] = {}
        self._lock = threading.Lock()
        self.per_target = per_target
        self.max_idle_s = max_idle_s

    def take(self, target: str):
        now = time.monotonic()
        stale: list = []
        conn = None
        with self._lock:
            conns = self._idle.get(target)
            while conns:
                parked_at, c = conns.pop()
                if now - parked_at <= self.max_idle_s:
                    conn = c
                    break
                stale.append(c)
        for c in stale:
            _quiet_close(c)
        return conn

    def give(self, target: str, conn) -> None:
        with self._lock:
            conns = self._idle.setdefault(target, [])
            if len(conns) < self.per_target:
                conns.append((time.monotonic(), conn))
                return
        _quiet_close(conn)

    def drop_target(self, target: str) -> None:
        """Drain every idle connection for one target — called when a
        pooled connection turns out stale, because its siblings from
        the same dead peer are stale too."""
        with self._lock:
            conns = self._idle.pop(target, [])
        for _, c in conns:
            _quiet_close(c)

    def close(self) -> None:
        with self._lock:
            all_conns = [c for conns in self._idle.values()
                         for _, c in conns]
            self._idle.clear()
        for c in all_conns:
            _quiet_close(c)


def _quiet_close(conn) -> None:
    try:
        conn.close()
    except OSError:
        pass


class SyncHttpPool:
    def __init__(self, timeout: float = 30.0, per_target: int = 4,
                 max_idle_s: float = 30.0):
        self._pool = _IdlePool(per_target, max_idle_s)
        self.timeout = timeout

    def _connect(self, target: str) -> http.client.HTTPConnection:
        host, _, port = target.rpartition(":")
        ctx = tls.client_ctx()
        if ctx is not None:
            return http.client.HTTPSConnection(
                host, int(port), timeout=self.timeout, context=ctx)
        return http.client.HTTPConnection(
            host, int(port), timeout=self.timeout)

    def request(self, target: str, path: str,
                headers: dict | None = None,
                method: str = "GET") -> tuple[int, bytes]:
        """One request over a pooled keep-alive connection; a stale
        idle connection (peer closed/respawned between uses) is
        retried once on a fresh one, and its idle siblings are drained
        so the respawn poisons at most one round trip per caller, not
        one per pooled socket. Raises OSError flavors on failure."""
        for attempt in (0, 1):
            conn = self._pool.take(target)
            fresh = conn is None
            if fresh:
                conn = self._connect(target)
            try:
                conn.request(method, path, headers=headers or {})
                resp = conn.getresponse()
                body = resp.read()
                status = resp.status
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                if fresh or attempt:
                    raise PoolError(
                        f"{method} {target}{path}: {e}") from e
                glog.V(2).infof("connpool %s: stale keep-alive (%s), "
                                "retrying fresh", target, e)
                self._pool.drop_target(target)
                continue
            if resp.will_close:
                conn.close()
            else:
                self._pool.give(target, conn)
            return status, body
        raise PoolError(f"{method} {target}{path}: unreachable")

    def close(self) -> None:
        self._pool.close()


class _FrameConn:
    """One handshaken sync frame connection (a single request in
    flight at a time — executor threads don't pipeline; the async
    FrameChannel is the multiplexed form)."""

    __slots__ = ("sock", "dec", "queue", "next_id")

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.dec = FrameDecoder()
        self.queue: list = []          # decoded-but-unconsumed frames
        self.next_id = 1

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class SyncFramePool:
    """Frame-protocol twin of SyncHttpPool for executor-thread
    fetches (the EC shard gather). Same pooling/stale-retry/idle
    discipline; handshake failures raise :class:`FrameUnsupported` so
    the caller downgrades the TARGET to the HTTP pool."""

    def __init__(self, timeout: float = 30.0, per_target: int = 4,
                 max_idle_s: float = 30.0, token: str = "",
                 jwt_key: str = ""):
        self._pool = _IdlePool(per_target, max_idle_s)
        self.timeout = timeout
        self.token = token
        self.jwt_key = jwt_key          # mints the HELLO identity claim

    def _connect(self, target: str) -> _FrameConn:
        host, _, port = target.rpartition(":")
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=self.timeout)
        except OSError as e:
            raise PoolError(f"frame connect {target}: {e}") from e
        ctx = tls.client_ctx()
        if ctx is not None:
            try:
                sock = ctx.wrap_socket(sock, server_hostname=host)
            except OSError as e:
                _quiet_close(sock)
                raise PoolError(f"frame tls {target}: {e}") from e
        conn = _FrameConn(sock)
        try:
            hello_meta: dict = {"v": VERSION, "token": self.token}
            if self.jwt_key:
                from ..security.jwt import gen_jwt
                hello_meta["id"] = gen_jwt(self.jwt_key,
                                           HELLO_IDENTITY_FID,
                                           HELLO_IDENTITY_TTL_S)
            sock.sendall(MAGIC + encode_frame(HELLO, 0, hello_meta))
            fr = self._read_frame(conn)
            if fr.type != HELLO_OK:
                raise FrameUnsupported(
                    f"frame handshake with {target}: type {fr.type}")
        except FrameUnsupported:
            conn.close()
            raise
        except (OSError, FrameError) as e:
            conn.close()
            # anything short of HELLO_OK — an old peer parsing the
            # magic as garbage HTTP, a torn stream — means "speak HTTP
            # to this target"
            raise FrameUnsupported(
                f"frame handshake with {target}: {e}") from e
        return conn

    def _read_frame(self, conn: _FrameConn):
        while not conn.queue:
            chunk = conn.sock.recv(1 << 18)
            if not chunk:
                raise PoolError("peer closed frame stream")
            conn.queue.extend(conn.dec.feed(chunk))
        return conn.queue.pop(0)

    def request(self, target: str, path: str,
                headers: dict | None = None, method: str = "GET",
                query: dict | None = None) -> tuple[int, bytes]:
        """One frame request over a pooled connection; stale pooled
        sockets retried once fresh (and the target's idle set
        drained), exactly like the HTTP pool."""
        for attempt in (0, 1):
            conn = self._pool.take(target)
            fresh = conn is None
            if fresh:
                conn = self._connect(target)
            req_id = conn.next_id
            conn.next_id = (conn.next_id + 1) & 0xFFFFFFFF or 1
            meta: dict = {"m": method, "p": path}
            if query:
                meta["q"] = query
            if headers:
                meta["h"] = headers
            try:
                conn.sock.sendall(encode_frame(REQ, req_id, meta))
                while True:
                    fr = self._read_frame(conn)
                    if fr.type == RESP and fr.req_id == req_id:
                        break
            except (OSError, FrameError) as e:
                conn.close()
                if fresh or attempt:
                    raise PoolError(
                        f"frame {method} {target}{path}: {e}") from e
                glog.V(2).infof("framepool %s: stale connection (%s), "
                                "retrying fresh", target, e)
                self._pool.drop_target(target)
                continue
            if conn.dec.pending or conn.queue:
                # leftover bytes/frames would desync the next request
                conn.close()
            else:
                self._pool.give(target, conn)
            from .frame import FLAG_FALLBACK
            if fr.flags & FLAG_FALLBACK:
                raise FrameUnsupported(
                    f"frame {method} {target}{path}: peer asked for "
                    f"HTTP fallback")
            return int(fr.meta.get("s", 500)), fr.payload
        raise PoolError(f"frame {method} {target}{path}: unreachable")

    def close(self) -> None:
        self._pool.close()
