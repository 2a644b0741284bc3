"""Multi-core data plane: SO_REUSEPORT process-per-core workers.

Reference: the reference scales one process across cores via the Go
runtime (README.md:457-507 benchmarks on 4 cores); CPython cannot, so
`weed-tpu volume -workers N` (and `master -workers N`) runs N forked
worker PROCESSES that all listen on the same public port with
SO_REUSEPORT — the kernel load-balances accepted connections across
them and the hot path shares no state between cores at all.

Volume side: ownership is partitioned `volume_id % N` (storage/store.py
`partition`). Each worker is a full volume server with its own needle
maps and file handles (shared-nothing), registered with the master
under its own private port so master-directed traffic goes straight to
the owner; a request that lands on the wrong worker (kernel balancing
is connection-, not volume-aware) is proxied to the owning sibling over
loopback, authenticated by a per-launch shared token.

Master side: worker 0 is the full master (topology, raft, heartbeats —
necessarily single-process state); workers 1..N-1 are *assign
accelerators* that answer `GET /dir/assign` from a leased block of file
ids plus a sub-second cache of the writable-volume set, and
transparently proxy every other request to the primary. The hot
assign+write path therefore never serializes on one core.

The parent process is a plain supervisor: it spawns the workers,
restarts the ones that die (with backoff), and owns no socket — worker
state files under the state dir are the discovery plane for siblings,
metrics aggregation, and operators.

A copy of seaweedfs_tpu/server/workers.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import re
import signal
import time

from ..security import tls
from ..util import failpoints, glog

# Shared-secret header marking an intra-host worker-to-worker hop. The
# token is minted per launch by the supervisor and travels via this
# environment variable, never argv (argv is world-readable in /proc).
WORKER_TOKEN_ENV = "SWTPU_WORKER_TOKEN"
WORKER_HEADER = "X-Swtpu-Worker"
FORWARDED_HEADER = "X-Forwarded-For"

# hop-by-hop (plus hop-specific entity) headers never forwarded verbatim
_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailer", "transfer-encoding",
    "upgrade", "host", "content-length",
}
_HOP_RESPONSE_EXTRA = {"content-encoding", "date", "server"}


class WorkerContext:
    """One worker's identity + sibling discovery.

    Sibling addresses come from per-worker JSON state files in
    `state_dir` (written atomically on start/restart), so discovery
    survives a sibling respawning on a new ephemeral private port."""

    STATE_TTL = 0.5  # seconds a cached sibling state file read lives

    def __init__(self, index: int, total: int, public_port: int,
                 state_dir: str, token: str = ""):
        if not 0 <= index < total:
            raise ValueError(f"worker index {index} not in [0, {total})")
        self.index = index
        self.total = total
        self.public_port = public_port
        self.state_dir = state_dir
        self.token = token or os.environ.get(WORKER_TOKEN_ENV, "")
        self._cache: dict[int, tuple[float, dict | None]] = {}

    # -- partition --

    def owns(self, vid: int) -> bool:
        return vid % self.total == self.index

    def owner_index(self, vid: int) -> int:
        return vid % self.total

    def token_ok(self, value: str | None) -> bool:
        return bool(self.token) and \
            hmac.compare_digest(self.token, value or "")

    # -- state files --

    def state_path(self, index: int | None = None) -> str:
        i = self.index if index is None else index
        return os.path.join(self.state_dir, f"worker{i}.json")

    def write_state(self, **info) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        info = {"index": self.index, "pid": os.getpid(),
                "public_port": self.public_port, **info}
        path = self.state_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, path)
        self._cache.pop(self.index, None)

    def read_state(self, index: int) -> dict | None:
        now = time.monotonic()
        hit = self._cache.get(index)
        if hit is not None and now - hit[0] < self.STATE_TTL:
            return hit[1]
        st: dict | None = None
        try:
            with open(self.state_path(index)) as f:
                st = json.load(f)
        except (OSError, ValueError):
            st = None
        self._cache[index] = (now, st)
        return st

    def sibling_addr(self, index: int) -> str | None:
        """ip:private_port of worker `index`, or None while it is down
        or still starting."""
        st = self.read_state(index)
        if not st or "ip" not in st or "port" not in st:
            return None
        return f"{st['ip']}:{st['port']}"

    def sibling_frame(self, index: int) -> tuple[str, str]:
        """(unix socket path, tcp ip:port) for worker `index`'s frame
        listener — the intra-host binary wire. Either may be empty:
        the unix socket when the worker could not bind one (path too
        long for sockaddr_un), both while the worker is down."""
        st = self.read_state(index)
        if not st:
            return "", ""
        tcp = f"{st['ip']}:{st['port']}" \
            if "ip" in st and "port" in st else ""
        return str(st.get("frame_sock", "") or ""), tcp

    def owner_addr(self, vid: int) -> str | None:
        return self.sibling_addr(self.owner_index(vid))

    def all_states(self) -> list[dict | None]:
        return [self.read_state(i) for i in range(self.total)]


async def proxy_request(req, session, target: str, token: str,
                        fire_failpoint: bool = True):
    """Stream one aiohttp request to a sibling worker and its response
    back — the in-worker proxy for needles/volumes owned by another
    partition. Small bodies are buffered so the sibling's raw fast path
    can serve them; large ones stream (chunked) and land on the
    sibling's aiohttp app."""
    import aiohttp
    from aiohttp import web
    from ..util import failpoints
    if fire_failpoint:
        try:
            # chaos site: injected sibling-hop faults (FailpointError
            # and FailpointDrop are OSErrors) take the same 502 path a
            # crashed worker does, which is what trips the caller's
            # breaker. The volume worker middleware fires this site
            # ITSELF (before its frame-first attempt) and passes
            # fire_failpoint=False so one hop never burns two counts.
            await failpoints.fail("worker.proxy")
        except OSError as e:
            return web.json_response(
                {"error": f"worker proxy to {target}: {e}"}, status=502)
    headers = {k: v for k, v in req.headers.items()
               if k.lower() not in _HOP_HEADERS
               and k.lower() != "accept-encoding"}
    headers[WORKER_HEADER] = token
    if req.remote:
        headers[FORWARDED_HEADER] = req.remote
    # trace propagation: the caller's proxy span (set on the context by
    # the routing middleware) becomes the parent of the sibling's
    # server span, so a cross-worker hop stays ONE trace — this
    # overrides the client's original traceparent, which the proxy
    # span already chains to
    from ..util import tracing
    tracing.inject(headers)
    body = None
    if req.method not in ("GET", "HEAD"):
        cl = req.headers.get("Content-Length", "")
        if cl.isdigit() and int(cl) <= (8 << 20):
            body = await req.read()
        else:
            body = req.content           # stream large/unsized bodies
    resp = None
    try:
        async with session.request(
                req.method, tls.url(target, req.path_qs),
                data=body, headers=headers,
                allow_redirects=False) as r:
            out_headers = [
                (k, v) for k, v in r.headers.items()
                if k.lower() not in _HOP_HEADERS
                and k.lower() not in _HOP_RESPONSE_EXTRA]
            resp = web.StreamResponse(status=r.status, reason=r.reason)
            for k, v in out_headers:
                resp.headers.add(k, v)
            if "Content-Length" in r.headers and \
                    "Content-Encoding" not in r.headers:
                resp.content_length = int(r.headers["Content-Length"])
            await resp.prepare(req)
            async for chunk in r.content.iter_chunked(1 << 16):
                await resp.write(chunk)
            await resp.write_eof()
            return resp
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
        if resp is not None and resp.prepared:
            # the sibling died MID-BODY: headers (and part of the
            # body) are already on the wire — abort the connection so
            # the client sees a transport error, never a 502 JSON
            # spliced into the needle bytes
            glog.warning("worker proxy to %s died mid-body: %s",
                         target, e)
            if req.transport is not None:
                req.transport.close()
            return resp
        return web.json_response(
            {"error": f"worker proxy to {target}: {e}"}, status=502)


# frame-path proxy ceiling: bodies above this stream over the HTTP
# hop (frames buffer one request per frame)
FRAME_PROXY_MAX_BODY = 8 << 20


def frame_eligible(req) -> bool:
    """May this sibling-bound request ride the binary frame hop?
    Needle-path methods only (admin tail/copy stream GBs and keep the
    chunked HTTP hop), with a small declared body."""
    if not re.match(r"^/\d+,", req.path):
        return False
    if req.method in ("GET", "HEAD"):
        return True
    if req.method in ("POST", "PUT"):
        cl = req.headers.get("Content-Length", "")
        return cl.isdigit() and int(cl) <= FRAME_PROXY_MAX_BODY
    if req.method == "DELETE":
        # normally bodyless (no Content-Length), but any declared
        # body is buffered into ONE frame — cap it like writes, and
        # refuse chunked (unsized) bodies outright, so an oversized
        # payload can never emit a frame the peer's decoder must
        # reject (tearing the multiplexed channel)
        if "Transfer-Encoding" in req.headers:
            return False
        cl = req.headers.get("Content-Length", "") or "0"
        return cl.isdigit() and int(cl) <= FRAME_PROXY_MAX_BODY
    return False


async def proxy_request_frame(req, ch):
    """Frame-path twin of :func:`proxy_request`: one multiplexed frame
    to the owning sibling instead of a full HTTP request. Hop-by-hop
    (and hop-specific entity) headers are stripped in BOTH directions
    exactly like the HTTP hop. Raises FrameChannelError/FrameFallback
    for the caller's HTTP fallback — nothing has touched the client
    connection yet at that point."""
    from aiohttp import web
    from ..util import tracing
    headers = {k.lower(): v for k, v in req.headers.items()
               if k.lower() not in _HOP_HEADERS
               and k.lower() != "accept-encoding"}
    if req.remote:
        headers[FORWARDED_HEADER.lower()] = req.remote
    # trace propagation: same discipline as the HTTP hop — the proxy
    # span on the context parents the sibling's server span
    tracing.inject(headers)
    body = b""
    if req.method not in ("GET", "HEAD"):
        body = await req.read()
    status, out_headers, payload = await ch.request(
        req.method, req.path, query=dict(req.query), headers=headers,
        body=body)
    resp = web.Response(status=status, body=payload)
    ct = None
    for k, v in out_headers.items():
        lk = k.lower()
        if lk in _HOP_HEADERS or lk in _HOP_RESPONSE_EXTRA:
            continue
        if lk == "content-type":
            ct = v
            continue
        resp.headers.add(k, v)
    if ct:
        resp.content_type = ct.partition(";")[0]
        charset = ct.partition("charset=")[2].strip()
        if charset:
            resp.charset = charset
    return resp


class Supervisor:
    """Parent of the worker fleet: spawn, monitor, respawn with backoff.

    No socket lives here — the workers own the SO_REUSEPORT listeners —
    so a supervisor restart (or even its death) never drops the data
    plane; it only suspends crash recovery."""

    def __init__(self, build_argv, total: int, env: dict | None = None,
                 min_backoff: float = 0.5, max_backoff: float = 10.0,
                 stable_s: float = 30.0):
        self.build_argv = build_argv       # callable(index) -> argv list
        self.total = total
        self.env = env
        self.min_backoff = min_backoff
        self.max_backoff = max_backoff
        self.stable_s = stable_s
        self.procs: dict[int, asyncio.subprocess.Process] = {}
        self.restarts = 0
        self._respawns: dict[int, int] = {}
        self._stopping = False
        self._tasks: list[asyncio.Task] = []

    async def start(self) -> None:
        for i in range(self.total):
            await self._spawn(i)
        self._tasks = [asyncio.get_running_loop().create_task(
            self._monitor(i)) for i in range(self.total)]

    async def _spawn(self, index: int) -> None:
        argv = self.build_argv(index)
        env = self.env
        n = self._respawns.get(index, 0)
        if n:
            # the respawned worker journals its own worker_respawn
            # event at boot (cli.main): the supervisor serves no HTTP,
            # so an event recorded HERE would be unobservable
            env = dict(env if env is not None else os.environ)
            env["WEED_WORKER_RESPAWNS"] = str(n)
        self.procs[index] = await asyncio.create_subprocess_exec(
            *argv, env=env)
        glog.info("worker %d spawned (pid %d)", index,
                  self.procs[index].pid)

    async def _monitor(self, index: int) -> None:
        backoff = self.min_backoff
        while not self._stopping:
            p = self.procs[index]
            t0 = time.monotonic()
            rc = await p.wait()
            if self._stopping:
                return
            if time.monotonic() - t0 > self.stable_s:
                backoff = self.min_backoff   # it ran fine for a while
            glog.warning("worker %d (pid %d) exited rc=%s; respawning "
                         "in %.1fs", index, p.pid, rc, backoff)
            self.restarts += 1
            # the respawn event is journaled by the respawned worker at
            # boot (WEED_WORKER_RESPAWNS via _spawn): the supervisor
            # serves no HTTP, so a ring entry here would be unobservable
            self._respawns[index] = self._respawns.get(index, 0) + 1
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.max_backoff)
            if not self._stopping:
                await self._spawn(index)

    async def stop(self, sig: int = signal.SIGTERM) -> None:
        self._stopping = True
        for task in self._tasks:
            task.cancel()
        for p in self.procs.values():
            if p.returncode is None:
                try:
                    p.send_signal(sig)
                except ProcessLookupError:
                    pass
        for p in self.procs.values():
            try:
                await asyncio.wait_for(p.wait(), timeout=10)
            except asyncio.TimeoutError:
                p.kill()
                await p.wait()


def fresh_state_dir(path: str) -> str:
    """Create the worker-state directory, dropping stale state files
    from a previous launch (their private ports are dead)."""
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(path):
        if name.startswith("worker") and name.endswith(".json"):
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass
    return path


# ---------------------------------------------------------------------------
# master-side assign accelerator (workers 1..N-1 of `master -workers N`)


class _AssignState:
    """Writable-volume snapshot for one layout key."""

    __slots__ = ("ts", "entries", "rr")

    def __init__(self, entries: list[dict]):
        self.ts = time.monotonic()
        self.entries = entries
        self.rr = 0


class AssignAccelerator:
    """SO_REUSEPORT sibling of the primary master that serves the one
    hot master route — `GET /dir/assign` — without touching the
    primary: file ids come from leased blocks (`/cluster/seq_lease`)
    and volume picks from a sub-second snapshot of the writable set
    (`/cluster/assign_state`). Anything it cannot answer (growth
    needed, unknown knobs, cold routes, heartbeats, raft) is
    transparently proxied to the primary's private listener, so the
    cluster behaves exactly like a single master."""

    STATE_TTL = 0.7          # seconds an assign-state snapshot stays hot
    LEASE_BLOCK = 4096       # file ids leased per refill round-trip
    LEASE_LOW = 256          # refill in the background below this

    def __init__(self, ip: str, port: int, ctx: WorkerContext,
                 white_list: list[str] | None = None, jwt_key: str = "",
                 default_replication: str = "000"):
        from aiohttp import web
        from ..security.guard import Guard
        self.ip = ip
        self.port = port
        self.ctx = ctx
        self.guard = Guard(white_list or ())
        self.jwt_key = jwt_key
        self.default_replication = default_replication
        self._states: dict[tuple, _AssignState] = {}
        self._lease_next = 0
        self._lease_end = 0
        self._jobs: set = set()          # in-flight refresh/refill keys
        self._job_tasks: set = set()     # strong refs (loop holds weak)
        self._http = None
        self._runner = None
        self._server = None
        self.assigned = 0                # fast assigns answered here
        self.proxied = 0                 # requests handed to the primary
        app = web.Application(client_max_size=64 * 1024 * 1024)
        app.router.add_route("*", "/{tail:.*}", self._h_proxy)
        self.app = app

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def primary_addr(self) -> str | None:
        return self.ctx.sibling_addr(0)

    async def start(self) -> None:
        import aiohttp
        from aiohttp import web
        # total=None: /cluster/watch subscribers stream through this
        # proxy for their whole lifetime
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        from .fasthttp import AcceleratorAssignProtocol
        self._server = await asyncio.get_running_loop().create_server(
            lambda: AcceleratorAssignProtocol(self), self.ip, self.port,
            ssl=tls.server_ctx(), reuse_address=True, reuse_port=True)
        self.ctx.write_state(ip=self.ip, port=self.port, role="assign")
        self._schedule(("lease",), self._refill())
        self._schedule(("state", "", self.default_replication, ""),
                       self._refresh("", self.default_replication, ""))

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for tr in list(getattr(self, "_fast_conns", ())):
                tr.close()
        if self._http:
            await self._http.close()
        if self._runner:
            await self._runner.cleanup()

    # -- background state/lease maintenance --

    def _schedule(self, key: tuple, coro) -> None:
        """At most one in-flight job per key; the task handle is
        retained until done (an unreferenced task may be GC'd)."""
        if key in self._jobs:
            coro.close()
            return
        self._jobs.add(key)
        task = asyncio.get_running_loop().create_task(coro)
        self._job_tasks.add(task)

        def done(_t) -> None:
            self._jobs.discard(key)
            self._job_tasks.discard(task)

        task.add_done_callback(done)

    async def _refresh(self, collection: str, replication: str,
                       ttl: str) -> None:
        import aiohttp
        target = self.primary_addr()
        if target is None:
            return
        try:
            await failpoints.fail("master.lease")
            async with self._http.get(
                    tls.url(target, "/cluster/assign_state"),
                    params={"collection": collection,
                            "replication": replication, "ttl": ttl},
                    headers={WORKER_HEADER: self.ctx.token},
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                if r.status != 200:
                    return
                body = await r.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            return
        if len(self._states) > 256:
            # layout keys come from client query params: bound the cache
            self._states.clear()
        self._states[(collection, replication, ttl)] = \
            _AssignState(body.get("entries", []))

    async def _refill(self) -> None:
        import aiohttp
        target = self.primary_addr()
        if target is None:
            return
        try:
            await failpoints.fail("master.lease")
            async with self._http.get(
                    tls.url(target, "/cluster/seq_lease"),
                    params={"count": str(self.LEASE_BLOCK)},
                    headers={WORKER_HEADER: self.ctx.token},
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                if r.status != 200:
                    return
                body = await r.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            return
        # the remainder of the old lease is abandoned — ids are sparse
        # by design and a gap is cheaper than interleaving blocks
        self._lease_next = int(body["start"])
        self._lease_end = self._lease_next + int(body["count"])

    # -- the synchronous hot path (called from the raw protocol) --

    def fast_assign(self, q: bytes, peer_ip: str | None) -> bytes | None:
        """Answer GET /dir/assign from local state; None => proxy."""
        from ..storage import types as t
        from .fasthttp import _R401_IP
        # guard FIRST, against the real client socket: every later
        # `return None` proxies to the primary with this worker's token,
        # and the primary trusts that hop — so nothing may be proxied
        # that did not already pass the whitelist here
        if not self.guard.empty and not self.guard.allows(peer_ip):
            return _R401_IP
        count_s = collection = replication = ttl = b""
        if q not in (b"", b"?"):
            if b"%" in q or b"+" in q:
                return None
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
                elif k not in (b"",):
                    return None       # dataCenter etc: primary decides
        try:
            count = int(count_s or 1)
        except ValueError:
            return None
        if count < 1:
            return None
        key = (collection.decode(),
               replication.decode() or self.default_replication,
               ttl.decode())
        st = self._states.get(key)
        now = time.monotonic()
        if st is None or now - st.ts > self.STATE_TTL:
            self._schedule(("state",) + key,
                           self._refresh(*key))
        if st is None or not st.entries:
            return None               # growth / first touch: primary
        if self._lease_end - self._lease_next < count:
            self._schedule(("lease",), self._refill())
            return None
        if self._lease_end - self._lease_next < self.LEASE_LOW:
            self._schedule(("lease",), self._refill())
        pick = st.entries[st.rr % len(st.entries)]
        st.rr += 1
        file_key = self._lease_next
        self._lease_next += count
        fid = str(t.FileId(int(pick["vid"]), file_key,
                           t.random_cookie()))
        out = {"fid": fid, "url": pick["url"],
               "publicUrl": pick["publicUrl"], "count": count}
        if self.jwt_key:
            from ..security.jwt import gen_jwt
            out["auth"] = gen_jwt(self.jwt_key, fid)
        self.assigned += 1
        body = json.dumps(out).encode()
        return (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/json; charset=utf-8\r\n"
                b"Content-Length: " + str(len(body)).encode()
                + b"\r\n\r\n" + body)

    async def _h_proxy(self, req):
        from aiohttp import web
        target = self.primary_addr()
        if target is None:
            return web.json_response(
                {"error": "primary master worker unavailable"},
                status=503)
        self.proxied += 1
        return await proxy_request(req, self._http, target,
                                   self.ctx.token)
