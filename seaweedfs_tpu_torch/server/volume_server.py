"""Volume server: data-plane node.

Reference: weed/server/volume_server.go:18-35 (public needle HTTP +
admin RPC), volume_server_handlers_read.go:30-169 (GET incl. cookie/TTL
checks, mime, etag), volume_server_handlers_write.go:19-73 (POST/DELETE w/
replication), volume_grpc_client_to_master.go:23-177 (heartbeat loop w/
leader chasing), volume_grpc_erasure_coding.go (EC shard lifecycle RPCs),
topology/store_replicate.go (replica fan-out).

The port of seaweedfs_tpu/server/volume_server.py, a copy with three
changes: the EC handlers run the port's EC engine, which
SWTPU_TORCH_EC_BACKEND picks (the CLI's -ecBackend: gpu, the CUDA
kernel, or cpu, its plain PyTorch version; SWTPU_TORCH_EC_METHOD=mxu
sends its batched and recover transforms through the GF(2) bit-matrix
product); start() resolves the port's native host library off the
event loop; and a -workers worker sends its first heartbeat only once
every sibling listens (_await_siblings), where the reference's fleet
registers with its first worker and fails what it proxies to a sibling
still starting.
"""

from __future__ import annotations

import asyncio
import gzip
import json
import os
import random
import re
import time
import urllib.parse

import aiohttp
from aiohttp import web

from .. import qos
from ..ec import gf
from ..ec import pipeline as ecpl
from ..ec.ec_volume import EcVolumeError
from ..pb import messages as pb
from ..util import batchframe, failpoints, glog, tracing
from ..util.resilience import BreakerRegistry
from ..storage import types as t
from ..storage.needle import CrcMismatch, Needle, NeedleError
from ..storage.backend import BackendError
from ..storage.store import Store
from ..storage.volume import AlreadyDeleted, NotFound, VolumeError
from ..security import tls
from . import wire


def _wk():
    """Lazy server.workers import (only -workers mode pays for it)."""
    from . import workers
    return workers


_FID_PATH = re.compile(r"^/(\d+),")


def _request_vid(req: "web.Request") -> int | None:
    """Volume id a request targets, for worker-partition routing:
    needle paths (`/<vid>,<fid>`) and admin routes carrying a
    volume/volumeId query param."""
    m = _FID_PATH.match(req.path)
    if m:
        return int(m.group(1))
    v = req.query.get("volume", "") or req.query.get("volumeId", "")
    return int(v) if v.isdigit() else None


class VolumeServer:
    # the longest a -workers worker holds its first heartbeat for a
    # sibling that is still starting (_await_siblings)
    SIBLING_START_S = 30.0

    def __init__(self, store: Store, master_url: str,
                 ip: str = "127.0.0.1", port: int = 8080,
                 data_center: str = "", rack: str = "",
                 pulse_seconds: float = 5.0,
                 read_redirect: bool = True,
                 jwt_key: str = "",
                 white_list: list[str] | None = None,
                 public_url: str = "",
                 worker_ctx=None,
                 batch_max: int = wire.BATCH_MAX_DEFAULT,
                 sendfile_min: int = wire.SENDFILE_MIN,
                 scrub_mbps: float = 8.0,
                 scrub_interval: float = 0.0,
                 scrub_pause_ms: float = 50.0,
                 scrub_batch: int | None = None):
        # -workers N process-per-core mode (server/workers.py): this
        # server is worker `ctx.index` of `ctx.total`, sharing the
        # public port via SO_REUSEPORT and owning vids % total == index
        self.worker_ctx = worker_ctx
        self.public_url = public_url
        # unified-wire knobs: most fids per /batch request (-batch.max),
        # the buffered-response byte budget one batch may hold, and the
        # zero-copy floor for raw-listener cold reads
        self.batch_max = batch_max
        self.batch_bytes_max = 64 << 20
        self.sendfile_min = sendfile_min
        from ..security.guard import Guard
        # -whiteList (volume.go:87,125): IP guard over the admin surface
        # and needle writes; reads stay open like the reference's public
        # port
        self.guard = Guard(white_list or ())
        self.jwt_key = jwt_key
        self.store = store
        # comma-separated seed list: chase the leader hint, rotate seeds on
        # total failure (volume_grpc_client_to_master.go:33-53)
        from ..util.client import parse_master_seeds
        self.master_seeds = parse_master_seeds(master_url)
        self.master_url = self.master_seeds[0]
        self._seed_idx = 0
        self.ip = ip
        self.port = port
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self.read_redirect = read_redirect
        self.volume_size_limit = 30_000 * 1024 * 1024
        self._runner: web.AppRunner | None = None
        self._tasks: list[asyncio.Task] = []
        self._http: aiohttp.ClientSession | None = None
        self._hb_lock = asyncio.Lock()
        # per-sibling breakers: a crashed worker is answered 503 in
        # microseconds instead of a connect timeout per proxied request
        self._sibling_breakers = BreakerRegistry(
            threshold=3, reset_timeout=2.0)
        from .ec_locations import EcLocationCache
        self._ec_locations = EcLocationCache(self._lookup_ec_locations)
        # shared keep-alive pool for SYNC (executor-thread) shard/meta
        # fetches — one handshake per holder, not one per interval
        from ..util.connpool import SyncFramePool, SyncHttpPool
        self._sync_pool = SyncHttpPool(timeout=30.0)
        # binary sibling wire (util/frame.py): persistent multiplexed
        # frame channels to sibling workers (and, for the EC gather,
        # to remote shard holders) with automatic HTTP fallback
        from ..util.frame import FrameHub
        self.frame_hub = FrameHub(
            token=worker_ctx.token if worker_ctx is not None else "",
            ssl=tls.client_ctx(), jwt_key=jwt_key)
        self._sync_frames = SyncFramePool(
            timeout=30.0,
            token=worker_ctx.token if worker_ctx is not None else "",
            jwt_key=jwt_key)
        # targets that refused the frame handshake: jittered-backoff
        # re-probe gate (journals `frame_downgrade`), replacing the
        # old sticky 60s HTTP downgrade
        from ..util.connpool import FrameProbeGate
        self._frame_gate = FrameProbeGate()
        self._frame_uds = ""
        self._frame_server = None
        # per-vid serialization for /admin/ec/rebuild_shard: an
        # executor retry racing a still-running rebuild of the same
        # volume must queue behind it, never interleave fetches and
        # output writes into the same shard files
        self._rebuild_locks: dict[int, asyncio.Lock] = {}
        # paced background parity scrubber (-scrub.interval > 0 starts
        # the loop; the object always exists so POST /debug/scrub?run=1
        # can force a cycle even when the loop is off)
        from ..ec.scrub import Scrubber
        self.scrubber = Scrubber(store, mbps=scrub_mbps,
                                 interval_s=scrub_interval,
                                 pause_ms=scrub_pause_ms,
                                 batch_windows=scrub_batch)
        # bandwidth arbiter adoption (-qos.mbps): scrub pacing becomes
        # foreground-aware — the bucket swap is invisible to Scrubber
        arb = qos.arbiter()
        if arb is not None:
            self.scrubber.bucket = arb.adopt(
                "scrub", self.scrubber.bucket)
        self.app = self._build_app()
        store.fetch_remote_shard = None  # wired after start (needs loop)

    def _guarded_request(self, req: web.Request) -> bool:
        # needle writes: /admin/* is the inter-server mesh (master
        # allocate/vacuum, peer copy/EC — mTLS-scoped like the
        # reference's gRPC), so it is exempt ONLY while mTLS is actually
        # active; with -whiteList but no security.toml, an unlisted
        # client 401'd on public DELETE could otherwise still tombstone
        # needles via /admin/batch_delete or drop volumes via
        # /admin/volume/delete. When mTLS is off, /admin mutations are
        # guarded too and the master/peers must be whitelisted (warned
        # at start()). Replica forwards come from peer volume servers an
        # operator's client whitelist won't include, so they are exempt
        # ONLY when the cluster enforces write JWTs (the forwarded
        # per-fid token still authenticates them); without a jwt key the
        # exemption would be a trivial guard bypass, so peers must then
        # be whitelisted
        if req.method not in ("POST", "PUT", "DELETE"):
            return False
        if self.worker_ctx is not None and self.worker_ctx.token_ok(
                req.headers.get(_wk().WORKER_HEADER)):
            # intra-host worker hop: the entry worker already ran the
            # guard against the real client IP before proxying
            return False
        if req.path.startswith("/admin/") and tls.server_ctx() is not None:
            return False
        if req.query.get("type") == "replicate" and self.jwt_key:
            return False
        return True

    _TRACE_OPS = {"GET": "read", "HEAD": "read", "POST": "write",
                  "PUT": "write", "DELETE": "delete"}

    @web.middleware
    async def _trace_mw(self, req: web.Request, handler):
        """Volume-tier entry span for the aiohttp (cold) path — needle
        requests and the /admin mesh, never the introspection surface
        (/debug, /metrics, /status, ...). Outermost middleware, so the
        guard and the sibling-proxy hop are both inside the span.
        Only REGISTERED /admin routes derive an op label: the op feeds
        prometheus label values, and a scanner probing /admin/<junk>
        (this runs before the guard, and for 404s) must not mint
        unbounded label children in the registry."""
        p = req.path
        if _FID_PATH.match(p):
            op = self._TRACE_OPS.get(req.method, req.method.lower())
        elif p == "/batch":
            op = "batch"
        elif p in self._traced_admin:
            op = p[len("/admin/"):].replace("/", ".")
        else:
            return await handler(req)
        sp = tracing.start_root("volume", op, headers=req.headers)
        if not sp:
            return await handler(req)
        with sp:
            try:
                resp = await handler(req)
            except web.HTTPException as e:
                sp.status = str(e.status)
                raise
            sp.status = "ok" if resp.status < 400 else str(resp.status)
            if resp.content_length:
                sp.nbytes = resp.content_length
            return resp

    async def _in_executor(self, fn, *args):
        """Executor round-trip that carries the tracing context into
        the worker thread, so store/EC spans parent under the request
        span (tracing.run_in_executor)."""
        return await tracing.run_in_executor(fn, *args)

    @web.middleware
    async def _worker_route_mw(self, req: web.Request, handler):
        """-workers partition routing: a request for a volume owned by
        a sibling worker is proxied to that sibling's private listener.
        Runs AFTER the guard middleware so the entry worker enforces
        the whitelist against the real client IP; the hop itself is
        authenticated by the launch token (never re-proxied)."""
        wk = _wk()
        wc = self.worker_ctx
        if wc is None or wc.token_ok(req.headers.get(wk.WORKER_HEADER)):
            return await handler(req)
        vid = _request_vid(req)
        if vid is None or wc.owns(vid):
            return await handler(req)
        target = wc.owner_addr(vid)
        if target is None:
            return web.json_response(
                {"error": f"worker {wc.owner_index(vid)} (owner of "
                          f"volume {vid}) unavailable"}, status=503)
        br = self._sibling_breakers.get(target)
        if not br.allow():
            sp = tracing.current()
            sp.event("breaker_open", upstream=target)
            return web.json_response(
                {"error": f"worker {wc.owner_index(vid)} (owner of "
                          f"volume {vid}) circuit open"}, status=503)
        # the cross-worker hop is its own span, and proxy_request stamps
        # its traceparent on the forwarded request so the sibling's
        # server span nests under it — one trace across both workers.
        # The binary frame hop is tried first (transport=frame on the
        # span); any channel failure falls back to the HTTP hop, which
        # is also where streaming/oversized bodies always go.
        with tracing.start("proxy", "sibling", target=target,
                           worker=wc.owner_index(vid)) as sp:
            # the sibling-hop chaos site fires for BOTH transports —
            # an armed worker.proxy fault must keep tripping this
            # breaker exactly as it did when the hop was HTTP-only
            # (tools/soak.py slo depends on it), so it runs before
            # the frame attempt and takes the same 502 path
            try:
                await failpoints.fail("worker.proxy")
            except OSError as e:
                br.record_failure()
                sp.status = "502"
                return web.json_response(
                    {"error": f"worker proxy to {target}: {e}"},
                    status=502)
            from ..util.frame import FrameChannelError
            ch = self.sibling_frame_channel(wc.owner_index(vid))
            if ch is not None and wk.frame_eligible(req):
                try:
                    resp = await wk.proxy_request_frame(req, ch)
                except FrameChannelError as e:
                    # dead channel / peer predates frames / injected
                    # worker.frame fault: the HTTP hop is authoritative
                    sp.event("frame_fallback", error=str(e)[:120])
                else:
                    sp.set("transport", "frame")
                    br.record_success()
                    sp.status = "ok" if resp.status < 400 \
                        else str(resp.status)
                    return resp
            sp.set("transport", "http")
            resp = await wk.proxy_request(req, self._http, target,
                                          wc.token,
                                          fire_failpoint=False)
            if resp.status == 502:
                br.record_failure()
                sp.status = "502"
            else:
                br.record_success()
                sp.status = "ok" if resp.status < 400 else str(resp.status)
            return resp

    def _build_app(self) -> web.Application:
        from ..security.guard import middleware as guard_mw
        middlewares = [self._trace_mw,
                       guard_mw(lambda: self.guard,
                                self._guarded_request)]
        if self.worker_ctx is not None:
            middlewares.append(self._worker_route_mw)
        app = web.Application(
            client_max_size=1024 * 1024 * 1024,
            middlewares=middlewares)
        # admin API (gRPC-analog)
        app.router.add_post("/admin/volume/allocate", self.h_allocate)
        app.router.add_post("/admin/volume/delete", self.h_volume_delete)
        app.router.add_post("/admin/volume/readonly", self.h_readonly)
        app.router.add_post("/admin/volume/mount", self.h_volume_mount)
        app.router.add_post("/admin/volume/unmount", self.h_volume_unmount)
        app.router.add_post("/admin/volume/copy", self.h_volume_copy)
        app.router.add_get("/admin/volume/status", self.h_volume_status)
        app.router.add_get("/admin/volume/tail", self.h_volume_tail)
        app.router.add_post("/admin/volume/tail_receive",
                            self.h_volume_tail_receive)
        app.router.add_post("/admin/vacuum/check", self.h_vacuum_check)
        app.router.add_post("/admin/vacuum/compact", self.h_vacuum_compact)
        app.router.add_post("/admin/vacuum/commit", self.h_vacuum_commit)
        app.router.add_post("/admin/vacuum/cleanup", self.h_vacuum_cleanup)
        app.router.add_post("/admin/ec/generate", self.h_ec_generate)
        app.router.add_post("/admin/ec/generate_batch",
                            self.h_ec_generate_batch)
        app.router.add_post("/admin/ec/rebuild", self.h_ec_rebuild)
        app.router.add_post("/admin/ec/rebuild_shard",
                            self.h_ec_rebuild_shard)
        app.router.add_post("/admin/ec/verify", self.h_ec_verify)
        app.router.add_post("/admin/ec/mount", self.h_ec_mount)
        app.router.add_post("/admin/ec/unmount", self.h_ec_unmount)
        app.router.add_post("/admin/ec/copy", self.h_ec_copy)
        app.router.add_post("/admin/ec/delete_shards", self.h_ec_delete_shards)
        app.router.add_post("/admin/ec/to_volume", self.h_ec_to_volume)
        app.router.add_get("/admin/ec/shard_read", self.h_ec_shard_read)
        app.router.add_post("/admin/batch_delete", self.h_batch_delete)
        app.router.add_get("/admin/file", self.h_admin_file)
        app.router.add_post("/admin/query", self.h_query)
        app.router.add_post("/admin/tier/upload", self.h_tier_upload)
        app.router.add_post("/admin/tier/download", self.h_tier_download)
        app.router.add_route("*", "/debug/failpoints", self.h_failpoints)
        app.router.add_route("*", "/debug/scrub", self.h_scrub)
        app.router.add_get("/debug/breakers", self.h_breakers)
        app.router.add_get("/debug/traces", self.h_traces)
        app.router.add_get("/debug/requests", self.h_requests)
        # flight recorder: metrics timelines, event journal, SLO health
        app.router.add_get("/debug/timeline", self.h_timeline)
        app.router.add_post("/debug/timeline", self.h_timeline)
        app.router.add_get("/debug/events", self.h_events)
        app.router.add_get("/debug/health", self.h_health)
        app.router.add_get("/debug/qos", self.h_qos)
        # continuous sampling profiler + on-demand pprof dumps, both
        # -workers merged/fanned like every debug surface
        app.router.add_get("/debug/profile", self.h_profile)
        app.router.add_get("/debug/pprof", self.h_pprof)
        app.router.add_get("/status", self.h_status)
        app.router.add_get("/metrics", self.h_metrics)
        app.router.add_get("/stats/workers", self.h_stats_workers)
        app.router.add_get("/ui", self.h_ui)
        # pipelined multi-needle GET (unified wire batch path); POST
        # form carries long fid lists as a JSON body
        app.router.add_get("/batch", self.h_batch)
        app.router.add_post("/batch", self.h_batch)
        # public needle API — catch-all LAST
        app.router.add_route("GET", "/{fid:[^/]+}", self.h_get)
        app.router.add_route("HEAD", "/{fid:[^/]+}", self.h_get)
        app.router.add_route("POST", "/{fid:[^/]+}", self.h_post)
        app.router.add_route("PUT", "/{fid:[^/]+}", self.h_post)
        app.router.add_route("DELETE", "/{fid:[^/]+}", self.h_delete)
        # the registered admin routes are the ONLY paths the trace
        # middleware will turn into an op label (bounded cardinality)
        self._traced_admin = frozenset(
            res.canonical for res in app.router.resources()
            if res.canonical.startswith("/admin/"))
        return app

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    async def start(self) -> None:
        if not self.guard.empty and tls.server_ctx() is None:
            glog.warning(
                "-whiteList without security.toml mTLS: /admin "
                "mutations are whitelist-guarded too — the master and "
                "peer volume servers must be in the whitelist")
        # the port resolves its native host library (CRC32C, the host
        # GF(256)) at the first call, not at import, and may build it
        # with g++ then: do it here, off the loop, before a request's
        # etag or CRC check would do it on the loop
        from ..util import crc32c
        await self._in_executor(crc32c.warm)
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=60))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        # the public listener speaks the hand-rolled needle fast path
        # (fasthttp.py); cold requests upgrade in place onto the aiohttp
        # app served by self._runner
        from .fasthttp import FastNeedleProtocol
        loop = asyncio.get_running_loop()
        wc = self.worker_ctx
        self._server = await loop.create_server(
            lambda: FastNeedleProtocol(self), self.ip,
            wc.public_port if wc is not None else self.port,
            ssl=tls.server_ctx(), reuse_address=True,
            reuse_port=wc is not None)
        if wc is not None:
            # worker mode: the shared SO_REUSEPORT port is the public
            # face; a second private listener is this worker's identity
            # — the master registers it as its own node, so
            # master-directed traffic goes straight to the owner and
            # siblings/supervisor can address this worker specifically
            self._priv_server = await loop.create_server(
                lambda: FastNeedleProtocol(self), self.ip, 0,
                ssl=tls.server_ctx(), reuse_address=True)
            self.port = self._priv_server.sockets[0].getsockname()[1]
        elif self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self.store.ip = self.ip
        self.store.port = self.port
        if self.public_url:
            # -publicUrl (volume.go:60): the externally reachable
            # address advertised in heartbeats/locations
            self.store.public_url = self.public_url
        elif wc is not None:
            self.store.public_url = f"{self.ip}:{wc.public_port}"
        elif not self.store.public_url or \
                self.store.public_url.endswith(":0"):
            self.store.public_url = self.url
        if wc is not None:
            # per-worker unix-socket frame listener: the preferred
            # intra-host transport for the binary sibling wire (TCP to
            # the private port, magic-sniffed, is the fallback). Bound
            # only when the path fits sockaddr_un.
            from .frameserver import FrameServerProtocol
            sock_path = os.path.join(wc.state_dir,
                                     f"w{wc.index}.sock")
            if len(sock_path) < 100 and hasattr(loop,
                                                "create_unix_server"):
                try:
                    await self._in_executor(self._unlink_quiet,
                                            sock_path)
                    self._frame_server = await loop.create_unix_server(
                        lambda: FrameServerProtocol(self), sock_path)
                    self._frame_uds = sock_path
                except OSError as e:
                    glog.warning("frame unix listener %s: %s (TCP "
                                 "fallback only)", sock_path, e)
            wc.write_state(ip=self.ip, port=self.port, role="volume",
                           frame_sock=self._frame_uds)
        # remote EC shard reads run inside executor threads, so they use a
        # synchronous client (readRemoteEcShardInterval, store_ec.go:211+);
        # the batched form gathers one request per holder
        self.store.fetch_remote_shard = self._sync_fetch_remote_shard
        self.store.fetch_remote_shard_batch = \
            self._sync_fetch_remote_shard_batch
        # repair-planning hooks: holder grouping from the location
        # cache (no I/O) and the refresh-once-on-failed-batch-gather
        # re-resolve (ec_volume._recover_interval)
        self.store.ec_holder_peek = self._peek_ec_holders
        self.store.ec_refresh_holders = self._ec_locations.invalidate
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        if self.scrubber.interval_s > 0:
            # long-lived paced loop: handle retained here and cancelled
            # in stop() (the orphan-task discipline for background
            # scrub-pattern tasks)
            self._tasks.append(asyncio.create_task(self.scrubber.run()))

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        if self._http:
            await self._http.close()
        if getattr(self, "_server", None) is not None:
            self._server.close()
            # NOT wait_closed(): since 3.12 it waits for every open
            # keep-alive connection; drop fast-path transports directly
            for tr in list(getattr(self, "_fast_conns", ())):
                tr.close()
        if getattr(self, "_priv_server", None) is not None:
            self._priv_server.close()
        if self._frame_server is not None:
            self._frame_server.close()
        await self.frame_hub.close()
        if self._runner:
            await self._runner.cleanup()
        if self._frame_uds:
            await self._in_executor(self._unlink_quiet, self._frame_uds)
        self._sync_pool.close()
        self._sync_frames.close()
        self.store.close()

    @staticmethod
    def _unlink_quiet(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def sibling_frame_channel(self, idx: int):
        """Persistent frame channel to sibling worker `idx` (unix
        socket preferred, private TCP fallback), or None while the
        sibling is down / frames are unavailable. Channels are cached
        per destination, so a respawned sibling (new socket path or
        port) transparently gets a fresh channel."""
        wc = self.worker_ctx
        if wc is None:
            return None
        uds, tcp = wc.sibling_frame(idx)
        if not uds and not tcp:
            return None
        return self.frame_hub.get(target=tcp, uds_path=uds)

    _counters: dict = None  # type: ignore[assignment]

    def count(self, op: str, status: str) -> None:
        """Cheap request-counter hook for the fast path (labels cached)."""
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        if self._counters is None:
            self._counters = {}
        c = self._counters.get((op, status))
        if c is None:
            c = self._counters[(op, status)] = \
                metrics.VOLUME_REQUEST_COUNTER.labels(op, status)
        c.inc()

    def _lookup_ec_locations(self, vid: int) -> dict | None:
        """One master /vol/ec_lookup call (executor threads only),
        over the shared keep-alive pool."""
        import json as _json
        failpoints.sync_fail("volume.ec_fetch")
        status, body = self._sync_pool.request(
            self.master_url, f"/vol/ec_lookup?volumeId={vid}")
        if status != 200:
            raise OSError(f"ec_lookup {vid}: http {status}")
        return _json.loads(body)["shards"]

    def _peek_ec_holders(self, vid: int) -> dict | None:
        """{sid: first non-self holder} from the location cache with NO
        lookup I/O — the repair planner's grouping input. None when the
        cache has nothing yet (the plan degrades to sid order and the
        actual fetch resolves holders as before)."""
        locs = self._ec_locations.peek(vid)
        if locs is None:
            return None
        out: dict[int, str] = {}
        for sid_s, urls in locs.items():
            for u in urls:
                if u != self.url:
                    out[int(sid_s)] = u
                    break
        return out

    def _sync_shard_fetch(self, target: str, query: dict,
                          headers: dict) -> tuple[int, bytes]:
        """One /admin/ec/shard_read fetch (executor threads only):
        frame path first — tens of bytes of protocol overhead per
        gather instead of HTTP headers — with a jittered-backoff
        re-probe gate when the holder refused the frame handshake
        (predates the protocol; journaled as `frame_downgrade`), and a
        one-shot HTTP retry when the frame transport failed
        mid-flight."""
        from ..util.connpool import FrameUnsupported, PoolError
        path = "/admin/ec/shard_read"
        http_path = path + "?" + urllib.parse.urlencode(query)
        if self._frame_gate.allow(target):
            try:
                # chaos site: injected inter-host EC gather frame
                # faults take the exact ride-HTTP-this-request path a
                # mid-flight transport failure does
                failpoints.sync_fail("ec.fetch.frame")
                out = self._sync_frames.request(
                    target, path, headers=headers, query=query)
                self._frame_gate.ok(target)
                return out
            except FrameUnsupported as e:
                self._frame_gate.refused(target, str(e))
            except (PoolError, OSError) as e:
                # transport failure, not a protocol refusal: this
                # request rides HTTP, the next one retries frames
                glog.V(1).infof("shard fetch %s over frames: %s; "
                                "retrying over HTTP", target, e)
        return self._sync_pool.request(target, http_path,
                                       headers=headers)

    def _sync_fetch_remote_shard(self, vid: int, shard_id: int,
                                 offset: int, size: int) -> bytes | None:
        """Blocking remote shard interval fetch; locations come from the
        staleness-tiered cache (store_ec.go:218-259) so a degraded-read
        burst costs one master lookup, not one per interval, and the
        connection comes from the shared keep-alive pool so it costs
        one handshake per holder, not one per interval."""
        shards = self._ec_locations.get(vid)
        if shards is None:
            return None
        # runs inside the executor thread whose context the read path
        # copied in, so the store span is current here — stamping the
        # traceparent keeps the remote holder's shard_read span in THIS
        # request's trace
        trace_headers: dict = {}
        tracing.inject(trace_headers)
        attempted = False
        for target in shards.get(str(shard_id), []):
            if target == self.url:
                continue
            attempted = True
            try:
                failpoints.sync_fail("volume.ec_fetch")
                status, body = self._sync_shard_fetch(
                    target,
                    {"volume": str(vid),
                     "reads": f"{shard_id}:{offset}:{size}"},
                    trace_headers)
                if status == 200:
                    rows = batchframe.parse_all(body)
                    if rows and rows[0][0].get("status") == 200 \
                            and len(rows[0][1]) == size:
                        return rows[0][1]
                glog.warning("remote ec shard %d.%d from %s: "
                             "status %d, %d bytes", vid, shard_id,
                             target, status, len(body))
            except (OSError, ValueError) as e:
                # PoolError/timeouts/torn framing: a swallowed holder
                # failure must be visible
                glog.warning("remote ec shard %d.%d from %s: %s",
                             vid, shard_id, target, e)
                continue
        if attempted or not shards.get(str(shard_id)):
            # a listed holder failed to serve — or the map lists NO
            # holder for this shard: either way the topology may have
            # moved under us (the autopilot re-hosts lost shards, and
            # a map cached during the outage window would otherwise
            # hide the repaired shard for the full TTL), so make the
            # next read re-resolve. invalidate() is rate-bounded to
            # one forced lookup per FRESH_S per vid, so a genuinely
            # lost shard costs one master round trip per 11s, not one
            # per probe; this read still reconstructs as before.
            self._ec_locations.invalidate(vid)
        return None

    def _sync_fetch_remote_shard_batch(
            self, vid: int, reads: "list[tuple[int, int, int]]"
            ) -> "dict[int, bytes] | None":
        """Batched remote shard gather for the recover path: group the
        wanted (shard, offset, size) intervals by HOLDER and issue one
        `/admin/ec/shard_read?reads=...` per holder — the k-fetch
        network fan-out of a degraded read collapses to one round trip
        per surviving server (arxiv 1309.0186's recovery-cost shape)."""
        shards = self._ec_locations.get(vid)
        if shards is None:
            return None
        by_holder: dict[str, list[tuple[int, int, int]]] = {}
        for sid, off, size in reads:
            for target in shards.get(str(sid), []):
                if target != self.url:
                    by_holder.setdefault(target, []).append(
                        (sid, off, size))
                    break
        if not by_holder:
            # none of the wanted shards has a (non-self) listed holder:
            # same stale-outage-map hazard as the single fetch above —
            # schedule a rate-bounded re-resolve so a just-re-hosted
            # shard becomes visible within FRESH_S, not TTL_S
            self._ec_locations.invalidate(vid)
            return None
        trace_headers: dict = {}
        tracing.inject(trace_headers)
        out: dict[int, bytes] = {}
        failed = False
        for target, group in by_holder.items():
            spec = ",".join(f"{sid}:{off}:{size}"
                            for sid, off, size in group)
            try:
                failpoints.sync_fail("volume.ec_fetch")
                status, body = self._sync_shard_fetch(
                    target, {"volume": str(vid), "reads": spec},
                    trace_headers)
                if status != 200:
                    raise OSError(f"status {status}")
                rows = batchframe.parse_all(body)
            except (OSError, ValueError) as e:
                glog.warning("batched ec gather %d from %s (%d "
                             "intervals): %s", vid, target,
                             len(group), e)
                failed = True
                continue
            for (sid, _, size), (meta, data) in zip(group, rows):
                if meta.get("status") == 200 and len(data) == size:
                    out[sid] = data
                else:
                    failed = True
        if failed:
            self._ec_locations.invalidate(vid)
        return out or None

    # ---- heartbeat loop ----

    def _requeue_deltas(self, hb) -> None:
        """Put consumed heartbeat deltas back so they reach the master on
        the next successful pulse."""
        self.store.new_volumes.extend(hb.new_volumes)
        self.store.deleted_volumes.extend(hb.deleted_volumes)
        self.store.new_ec_shards.extend(hb.new_ec_shards)
        self.store.deleted_ec_shards.extend(hb.deleted_ec_shards)

    async def _frame_master_json(self, method: str, path: str,
                                 query: dict | None = None,
                                 payload: dict | None = None,
                                 deadline: float = 10.0):
        """One master control-plane request over the persistent frame
        channel, parsed as JSON; None when the frame leg is
        unavailable (peer predates frames, channel severed, breaker
        open, non-JSON answer) so the caller rides HTTP. Failure here
        never raises: the HTTP leg is the one whose errors drive
        seed rotation / retry policy."""
        try:
            # chaos site: worker.frame (also armed inside the channel
            # send itself) severs this control-plane frame leg so the
            # HTTP fallback is exercised
            await failpoints.fail("worker.frame")
            chan = self.frame_hub.get(target=self.master_url)
            status, _, raw = await chan.request(
                method, path, query=query,
                headers={"content-type": "application/json"}
                if payload is not None else None,
                body=json.dumps(payload).encode()
                if payload is not None else b"",
                timeout=deadline)
            if status >= 500:
                return None
            return json.loads(raw)
        except (asyncio.TimeoutError, OSError, ValueError):
            return None

    async def _frame_master_post(self, path: str, payload: dict,
                                 deadline: float):
        return await self._frame_master_json("POST", path,
                                             payload=payload,
                                             deadline=deadline)

    async def heartbeat_once(self) -> bool:
        """Returns True when the (leader) master accepted the state;
        False when a follower redirected us (deltas requeued, master_url
        now points at the leader). Serialized: a stale full-state
        snapshot posted concurrently could land AFTER a newer one and
        un-register just-mounted shards (register_heartbeat replaces the
        node's state wholesale)."""
        async with self._hb_lock:
            from ..stats import metrics
            if metrics.HAVE_PROMETHEUS:
                metrics.VOLUME_COUNT.set(len(self.store.volumes))
            hb = self.store.collect_heartbeat(self.data_center, self.rack)
            hb_dict = hb.to_dict()
            # ride the pulse: report this node's foreground byte rate
            # so the leader's bandwidth arbiter sees cluster-wide
            # pressure, and pick up the published budget on the way back
            arb = qos.arbiter()
            if arb is not None:
                hb_dict["qos_fg_bps"] = round(arb.foreground_bps(), 1)
            try:
                # injected heartbeat faults (FailpointError is an
                # OSError) take the exact requeue-and-rotate path a
                # real dead master does
                await failpoints.fail("volume.heartbeat")
                # per-request timeout: a master that accepts the TCP
                # connect but never answers must not wedge the pulse
                # loop for the session default
                deadline = max(10.0, 4 * self.pulse_seconds)
                body = await self._frame_master_post(
                    "/cluster/heartbeat", hb_dict, deadline)
                if body is not None and body.get("rejected") \
                        and body.get("leader") \
                        and body["leader"] != self.master_url:
                    # follower hint over frames: re-home and re-send
                    # THIS pulse on the leader's channel, so frame
                    # re-homing costs zero pulses exactly like the
                    # HTTP path's auto-followed 307
                    self.master_url = body["leader"]
                    body = await self._frame_master_post(
                        "/cluster/heartbeat", hb_dict, deadline)
                if body is None:
                    async with self._http.post(
                            tls.url(self.master_url,
                                    "/cluster/heartbeat"),
                            json=hb_dict,
                            timeout=aiohttp.ClientTimeout(
                                total=deadline,
                                connect=5, sock_read=max(
                                    5.0, 2 * self.pulse_seconds))) as resp:
                        body = await resp.json()
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                self._requeue_deltas(hb)
                raise
            leader = body.get("leader")
            if body.get("rejected"):
                # a follower master refused registration: requeue deltas
                # and chase the leader it pointed at
                self._requeue_deltas(hb)
                if leader:
                    self.master_url = leader
                    return False
                # rejected with no leader known: treat as failure so the
                # heartbeat loop rotates to another seed master
                raise OSError(
                    f"master {self.master_url} rejected heartbeat, "
                    f"no leader")
            self.volume_size_limit = body.get(
                "volume_size_limit", self.volume_size_limit)
            if arb is not None and "qos_mbps" in body:
                arb.set_budget_mbps(body["qos_mbps"])
            if leader and leader != self.master_url:
                glog.info("volume %s: chasing new master leader %s "
                          "(was %s)", self.url, leader, self.master_url)
                self.master_url = leader
            return True

    async def _await_siblings(self) -> None:
        """Hold a -workers worker's first heartbeat until every sibling
        listens (a worker writes its state file once its listeners are
        bound). The master then offers the fleet only when any worker
        can reach the owner of any vid: a worker that registered alone
        took allocates and merged /debug reads it had to send to a
        sibling still starting, and answered them 500 or with itself
        alone. A sibling that never comes up holds it SIBLING_START_S
        at most."""
        wc = self.worker_ctx

        def all_listen() -> bool:
            # the files themselves, not sibling_addr: its cache would
            # keep "still starting" for the first requests after
            return all(os.path.exists(wc.state_path(i))
                       for i in range(wc.total))

        deadline = time.monotonic() + self.SIBLING_START_S
        while time.monotonic() < deadline and \
                not await self._in_executor(all_listen):
            await asyncio.sleep(0.1)

    async def _heartbeat_loop(self) -> None:
        if self.worker_ctx is not None:
            await self._await_siblings()
        while True:
            try:
                await self.heartbeat_once()
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                # current master unreachable: rotate through seed masters
                # (with one seed this still resets master_url back to the
                # configured seed after a learned leader dies)
                glog.V(1).infof("volume %s: heartbeat to %s failed (%s); "
                                "rotating seed", self.url,
                                self.master_url, e)
                self._seed_idx = (self._seed_idx + 1) \
                    % len(self.master_seeds)
                self.master_url = self.master_seeds[self._seed_idx]
            # ±20% jitter: a restarted master must not be hit by the
            # whole fleet's pulses in one synchronized herd
            await asyncio.sleep(
                self.pulse_seconds * random.uniform(0.8, 1.2))

    # ---- public needle handlers (adapters over server/wire.py) ----

    @staticmethod
    def _parse_fid(fid: str) -> t.FileId:
        return t.FileId.parse(fid)

    def _wire_request(self, req: web.Request,
                      body: bytes | None = None) -> wire.WireRequest:
        return wire.WireRequest(
            method=req.method, fid_s=req.match_info.get("fid", ""),
            query=dict(req.query),
            headers={k.lower(): v for k, v in req.headers.items()},
            peer_ip=req.remote, body=body, raw=False,
            worker_hop=self._is_worker_hop(req))

    async def _wire_response(self, req: web.Request,
                             resp: wire.WireResponse
                             ) -> web.StreamResponse:
        """Render a WireResponse through aiohttp — the transport-level
        twin of the raw listener's byte renderer."""
        if resp.drop:
            # injected connection drop: sever, don't answer
            if req.transport is not None:
                req.transport.close()
            return web.Response(status=500)
        if resp.manifest is not None:
            # resolve the manifest into the assembled file
            # (tryHandleChunkedFile, volume_server_handlers_read.go:170)
            return await self._serve_chunked_file(req, resp.manifest,
                                                  resp.headers)
        if resp.truncate_to >= 0:
            # chaos truncate: full Content-Length, partial body, dead
            # socket — the mid-read death degraded reads must survive
            sr = web.StreamResponse(status=resp.status, headers={
                **resp.headers, "Content-Length": str(len(resp.body))})
            sr.content_type = resp.content_type
            await sr.prepare(req)
            await sr.write(resp.body[:resp.truncate_to])
            if req.transport is not None:
                req.transport.close()
            return sr
        if resp.sendfile is not None:
            # zero-copy on the aiohttp listener too: a StreamResponse
            # drains the NeedleRef region via loop.sendfile (the same
            # shape aiohttp's own FileResponse uses), with a buffered
            # executor-pread fallback where the transport refuses
            return await self._respond_sendfile_web(req, resp)
        ct, _, rest = resp.content_type.partition(";")
        charset = rest.partition("charset=")[2].strip() or None
        if resp.head or resp.status in (304, 301):
            if not resp.head:
                return web.Response(status=resp.status,
                                    headers=resp.headers)
            return web.Response(status=resp.status, headers=resp.headers,
                                content_type=ct, charset=charset)
        return web.Response(body=resp.body, status=resp.status,
                            headers=resp.headers,
                            content_type=ct, charset=charset)

    async def _respond_sendfile_web(self, req: web.Request,
                                    resp: wire.WireResponse
                                    ) -> web.StreamResponse:
        """Drain a NeedleRef through aiohttp: kernel sendfile on plain
        TCP transports (after the headers flush, exactly like
        web.FileResponse), executor-chunked preads through the normal
        writer where the transport refuses (TLS, tests' mocked
        transports)."""
        ref = resp.sendfile
        try:
            ct, _, rest = resp.content_type.partition(";")
            sr = web.StreamResponse(status=resp.status,
                                    headers=resp.headers)
            sr.content_type = ct
            charset = rest.partition("charset=")[2].strip()
            if charset:
                sr.charset = charset
            sr.content_length = ref.length
            await sr.prepare(req)
            transport = req.transport
            kernel_ok = (transport is not None
                         and transport.get_extra_info("sslcontext")
                         is None
                         and transport.get_extra_info("socket")
                         is not None)
            if kernel_ok:
                try:
                    await asyncio.get_running_loop().sendfile(
                        transport, ref.file, ref.offset, ref.length,
                        fallback=False)
                    await sr.write_eof()
                    return sr
                except (NotImplementedError, RuntimeError,
                        AttributeError):
                    pass              # transport refused: buffered path
                except OSError:
                    # mid-send tear: the declared Content-Length can no
                    # longer be honored — sever like a buffered tear
                    transport.close()
                    return sr
            off, remaining = ref.offset, ref.length
            fd = ref.file.fileno()
            while remaining:
                chunk = await self._in_executor(
                    os.pread, fd, min(1 << 20, remaining), off)
                if not chunk:
                    break             # truncated under us: short body
                await sr.write(chunk)
                off += len(chunk)
                remaining -= len(chunk)
            await sr.write_eof()
            return sr
        finally:
            ref.close()

    async def h_get(self, req: web.Request) -> web.StreamResponse:
        wr = self._wire_request(req)
        return await self._wire_response(
            req, await wire.serve_read(self, wr))

    async def h_batch(self, req: web.Request) -> web.StreamResponse:
        """Pipelined multi-needle GET (`/batch?fids=...` or a POSTed
        {"fileIds": [...]}) — wire.serve_batch: cache hits inline,
        cold preads coalesced, sibling fan-out by vid ownership."""
        body = None
        if req.method == "POST" and req.can_read_body:
            body = await req.read()
        wr = self._wire_request(req, body)
        return await self._wire_response(
            req, await wire.serve_batch(self, wr))

    def _weed_client(self):
        """Lazily-built client for chunk fetches (lookup-cached)."""
        if getattr(self, "_wclient", None) is None:
            from ..util.client import WeedClient
            self._wclient = WeedClient(self.master_url,
                                       session=self._http,
                                       jwt_key=self.jwt_key)
        # track master failover: the heartbeat loop reassigns
        # self.master_url when the leader changes
        self._wclient.master_url = self.master_url
        return self._wclient

    async def _serve_chunked_file(self, req: web.Request, n: Needle,
                                  extra_headers: dict | None = None
                                  ) -> web.StreamResponse:
        """tryHandleChunkedFile (volume_server_handlers_read.go:170-199):
        the needle body is a ChunkManifest; stream the assembled bytes,
        honoring Range so large files never fully buffer."""
        from ..util.chunked import ChunkManifest
        from ..util.client import OperationError
        from ..util.httprange import RangeError, parse_range
        try:
            cm = ChunkManifest.load(n.data, n.is_gzipped)
        except (ValueError, KeyError) as e:
            return web.json_response(
                {"error": f"bad chunk manifest: {e}"}, status=500)
        headers = {"Accept-Ranges": "bytes", "Etag": f'"{n.etag()}"'}
        if extra_headers:
            # pairs + Last-Modified computed by h_get ride along
            headers.update(extra_headers)
        ct = cm.mime or (n.mime.decode() if n.mime
                         else "application/octet-stream")
        if cm.name:
            if not cm.mime and not n.mime:
                ct = wire._guess_mime(cm.name, ct)
            headers["Content-Disposition"] = wire._disposition(
                dict(req.query), cm.name)
        try:
            rng = parse_range(req.headers.get("Range", ""), cm.size)
        except RangeError:
            return web.Response(
                status=416,
                headers={"Content-Range": f"bytes */{cm.size}"})
        off, ln = rng if rng is not None else (0, cm.size)
        status = 206 if rng is not None else 200
        if rng is not None:
            headers["Content-Range"] = f"bytes {off}-{off+ln-1}/{cm.size}"
        headers["Content-Length"] = str(ln)
        if req.method == "HEAD":
            return web.Response(status=status, headers=headers,
                                content_type=ct)
        resp = web.StreamResponse(status=status, headers=headers)
        resp.content_type = ct
        await resp.prepare(req)
        client = self._weed_client()
        pieces = cm.resolve(off, ln)
        sizes = {c.fid: c.size for c in cm.chunks}
        i = 0
        truncated = False
        while i < len(pieces) and not truncated:
            # WHOLE small chunks batch into one multi-needle GET per
            # window (bounded bytes so large files never fully buffer);
            # partial/large pieces keep the ranged single-GET path
            win: list = []
            win_bytes = 0
            while i < len(pieces) and len(win) < 32 \
                    and win_bytes < (4 << 20):
                fid, c_off, c_len, _ = pieces[i]
                if c_off == 0 and c_len == sizes.get(fid) \
                        and c_len <= (1 << 20):
                    win.append(pieces[i])
                    win_bytes += c_len
                    i += 1
                else:
                    break
            if len(win) > 1:
                got = await client.batch_read([p[0] for p in win])
                for fid, _, _, _ in win:
                    piece = got.get(fid)
                    if piece is None:
                        truncated = True
                        break  # stream truncates; client sees short body
                    await resp.write(piece)
                continue
            if win:
                fid, c_off, c_len, _ = win[0]
            else:
                fid, c_off, c_len, _ = pieces[i]
                i += 1
            try:
                piece = await client.read(fid, offset=c_off, size=c_len)
            except OperationError:
                break  # stream truncates; client sees short body
            await resp.write(piece)
        await resp.write_eof()
        return resp

    async def h_post(self, req: web.Request) -> web.StreamResponse:
        """Write adapter: only TRANSPORT framing is unpacked here
        (multipart parts vs raw body); needle build, jwt guard, the
        group-commit store append and replication fan-out are
        wire.serve_write — the same code the raw listener runs."""
        # token guard BEFORE any body parsing: an unauthenticated
        # client must not get to drive multipart/EXIF work (or read
        # build-time diagnostics) on a jwt-protected server
        denied = wire.check_jwt(self, self._wire_request(req))
        if denied is not None:
            return await self._wire_response(req, denied)
        ctype = req.headers.get("Content-Type", "")
        n = None
        body = None
        if req.headers.get("X-Raw-Needle") == "1":
            body = await req.read()
        elif ctype.startswith("multipart/form-data"):
            name = b""
            mime = b""
            data = b""
            reader = await req.multipart()
            async for part in reader:
                if part.name in ("file", "upload", None) or part.filename:
                    data = await part.read(decode=False)
                    if part.filename:
                        name = part.filename.encode()
                    pct = part.headers.get("Content-Type", "")
                    if pct and pct != "application/octet-stream":
                        mime = pct.encode()
                    break
            try:
                fid = self._parse_fid(req.match_info["fid"])
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            wr = self._wire_request(req)
            try:
                n = wire.build_needle(fid, wr, data, name=name,
                                      mime=mime)
            except (NeedleError, ValueError) as e:
                return web.json_response({"error": str(e)}, status=400)
        else:
            body = await req.read()
        wr = self._wire_request(req, body)
        return await self._wire_response(
            req, await wire.serve_write(self, wr, n))

    async def h_delete(self, req: web.Request) -> web.StreamResponse:
        wr = self._wire_request(req)
        return await self._wire_response(
            req, await wire.serve_delete(self, wr))

    async def h_batch_delete(self, req: web.Request) -> web.Response:
        """One request tombstones many needles locally, with a per-fid
        result row (BatchDelete, volume_grpc_batch_delete.go:13-75).
        Replica/EC fan-out is the CLIENT's job — delete_content.go groups
        fids by holding server — so this endpoint never cascades; chunk
        manifests are rejected for the same reason."""
        try:
            body = await req.json()
        except ValueError:
            body = None
        if not isinstance(body, dict) or \
                not isinstance(body.get("fileIds", []), list):
            return web.json_response({"error": "bad json body"},
                                     status=400)
        fids = body.get("fileIds", [])
        tokens = body.get("tokens", {})
        if not isinstance(tokens, dict):
            tokens = {}

        def one(fid_s) -> dict:
            if not isinstance(fid_s, str):
                return {"fileId": str(fid_s), "status": 400,
                        "error": "fileId must be a string"}
            if self.jwt_key:
                # the batch path must not bypass the write-token guard
                # the public DELETE enforces (handlers_write.go:41-44)
                from ..security.jwt import JwtError, check_write_jwt
                try:
                    check_write_jwt(self.jwt_key,
                                    str(tokens.get(fid_s, "")), fid_s)
                except JwtError as e:
                    return {"fileId": fid_s, "status": 401,
                            "error": str(e)}
            try:
                fid = self._parse_fid(fid_s)
            except ValueError as e:
                return {"fileId": fid_s, "status": 400, "error": str(e)}
            try:
                existing = self.store.read_needle(
                    fid.volume_id, fid.key, fid.cookie)
            except (NotFound, AlreadyDeleted) as e:
                return {"fileId": fid_s, "status": 404,
                        "error": str(e) or "not found"}
            except (CrcMismatch, VolumeError, BackendError) as e:
                return {"fileId": fid_s, "status": 500, "error": str(e)}
            if existing.is_chunked_manifest:
                return {"fileId": fid_s, "status": 406, "error":
                        "ChunkManifest: not allowed in batch delete mode."}
            try:
                size = self.store.delete_needle(
                    fid.volume_id, Needle(cookie=fid.cookie, id=fid.key))
            except (NotFound, VolumeError) as e:
                return {"fileId": fid_s, "status": 500, "error": str(e)}
            return {"fileId": fid_s, "status": 202, "size": size}

        wc = self.worker_ctx
        if wc is None or self._is_worker_hop(req):
            results = await self._in_executor(lambda: [one(f) for f in fids])
            return web.json_response({"results": results})
        # -workers: a batch spans partitions — split by owning worker,
        # delete the local group here, forward each sibling its group,
        # and reassemble results in request order
        groups: dict[int, list] = {}
        for f in fids:
            try:
                idx = wc.owner_index(int(str(f).split(",")[0]))
            except ValueError:
                idx = wc.index       # malformed: local path 400s it
            groups.setdefault(idx, []).append(f)
        by_fid: dict[str, dict] = {}
        local = groups.pop(wc.index, [])
        for r in await self._in_executor(lambda: [one(f) for f in local]):
            by_fid[r["fileId"]] = r

        async def forward(idx: int, group: list) -> None:
            addr = wc.sibling_addr(idx)
            sub = {"fileIds": group,
                   "tokens": {str(f): tokens[str(f)] for f in group
                              if str(f) in tokens}}
            rows = None
            if addr is not None:
                try:
                    await failpoints.fail("worker.forward")
                    async with self._http.post(
                            tls.url(addr, "/admin/batch_delete"),
                            json=sub,
                            headers={_wk().WORKER_HEADER: wc.token},
                            timeout=aiohttp.ClientTimeout(
                                total=30)) as resp:
                        if resp.status == 200:
                            rows = (await resp.json())["results"]
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError, ValueError, KeyError):
                    rows = None
            if rows is None:
                rows = [{"fileId": str(f), "status": 503,
                         "error": f"worker {idx} unavailable"}
                        for f in group]
            for r in rows:
                by_fid[r["fileId"]] = r

        await asyncio.gather(*(forward(i, g) for i, g in groups.items()))
        results = [by_fid.get(str(f),
                              {"fileId": str(f), "status": 500,
                               "error": "no result"}) for f in fids]
        return web.json_response({"results": results})

    async def _ec_delete_broadcast(self, vid: int, fid: str,
                                   auth: str = "") -> None:
        try:
            await failpoints.fail("volume.ec_broadcast")
            async with self._http.get(
                    tls.url(self.master_url, "/vol/ec_lookup"),
                    params={"volumeId": str(vid)}) as resp:
                if resp.status != 200:
                    return
                shards = (await resp.json())["shards"]
        except aiohttp.ClientError:
            return
        targets = {u for urls in shards.values() for u in urls} - {self.url}

        headers = {"Authorization": auth} if auth else {}

        async def one(target: str) -> None:
            try:
                await failpoints.fail("volume.ec_broadcast")
                async with self._http.delete(
                        tls.url(target, f"/{fid}"),
                        params={"type": "replicate"},
                        headers=headers) as r:
                    await r.read()
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                # best-effort broadcast, but a holder that kept its
                # shard tombstone-free must be visible in the logs
                glog.warning("ec delete %s: broadcast to %s failed: %s",
                             fid, target, e)

        await asyncio.gather(*(one(u) for u in targets))

    async def _replicate(self, fid: str, method: str,
                         raw_needle: bytes | None,
                         auth: str = "") -> bool:
        """Fan out to the other replica locations
        (distributedOperation, store_replicate.go:140-155)."""
        vid = fid.split(",")[0]
        locs = None
        body = await self._frame_master_json("GET", "/dir/lookup",
                                             query={"volumeId": vid},
                                             deadline=10.0)
        if isinstance(body, dict):
            locs = body.get("locations")
        if locs is None:
            try:
                async with self._http.get(
                        tls.url(self.master_url, "/dir/lookup"),
                        params={"volumeId": vid}) as resp:
                    if resp.status != 200:
                        return False
                    locs = (await resp.json())["locations"]
            except aiohttp.ClientError:
                return False
        targets = [l["url"] for l in locs if l["url"] != self.url]

        extra = {"Authorization": auth} if auth else {}
        # the fan-out is one replicate-tier span; each replica hop is
        # an event, and the forwarded traceparent makes every replica's
        # own (volume, store) spans part of the same trace
        rsp = tracing.start("replicate", "fanout", fid=fid,
                            targets=len(targets))
        if rsp:
            tracing.inject(extra, rsp)

        async def frame_one(target: str, body: bytes | None) -> bool | None:
            """The fan-out hop over the persistent frame channel to
            `target`; None means the frame leg is unavailable and the
            caller rides HTTP (the channel breaker fails fast here, so
            a severed peer costs microseconds, not a connect timeout).
            The replica end enforces the same per-fid jwt and
            -whiteList policy wire applies to the HTTP form."""
            from ..util.frame import FrameChannelError
            try:
                # chaos site: forces the inter-host replication frame
                # leg down so chaos/soak prove the fan-out stays
                # correct on the HTTP fallback
                await failpoints.fail("replication.frame")
                chan = self.frame_hub.get(target=target)
                if method == "POST":
                    status, _, _b = await chan.request(
                        "POST", f"/{fid}",
                        query={"type": "replicate"},
                        headers={"X-Raw-Needle": "1", **extra},
                        body=body or b"", timeout=30.0)
                    ok = status in (200, 201)
                else:
                    status, _, _b = await chan.request(
                        "DELETE", f"/{fid}",
                        query={"type": "replicate"},
                        headers=extra, timeout=30.0)
                    ok = status == 200
                if not ok:
                    glog.warning("replicate %s to %s (frame): "
                                 "status %d", fid, target, status)
                    rsp.event("replica_failed", target=target,
                              status=status)
                return ok
            except (FrameChannelError, asyncio.TimeoutError, OSError):
                return None     # severed/refused/breaker-open -> HTTP

        async def one(target: str) -> bool:
            try:
                # chaos sites: `volume.replicate` injects transport
                # faults on the fan-out hop; `volume.replicate.body`
                # truncates the serialized needle so the replica's CRC
                # check rejects the torn write (the acknowledged copy
                # is then the only durable one — exactly the shape the
                # degraded-read soak must survive)
                await failpoints.fail("volume.replicate")
                body = None
                if method == "POST":
                    body = failpoints.corrupt("volume.replicate.body",
                                              raw_needle)
                framed = await frame_one(target, body)
                if framed is not None:
                    return framed
                if method == "POST":
                    async with self._http.post(
                            tls.url(target, f"/{fid}"),
                            params={"type": "replicate"},
                            data=body,
                            headers={"X-Raw-Needle": "1", **extra}) as r:
                        ok = r.status in (200, 201)
                        if not ok:
                            glog.warning(
                                "replicate %s to %s: http %d", fid,
                                target, r.status)
                            rsp.event("replica_failed", target=target,
                                      status=r.status)
                        return ok
                async with self._http.delete(
                        tls.url(target, f"/{fid}"),
                        params={"type": "replicate"},
                        headers=extra) as r:
                    return r.status == 200
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                glog.warning("replicate %s to %s: %s", fid, target, e)
                rsp.event("replica_failed", target=target,
                          error=f"{type(e).__name__} {e}"[:120])
                return False

        try:
            results = await asyncio.gather(*(one(x) for x in targets))
            rsp.status = "ok" if all(results) else "error"
            return all(results)
        finally:
            rsp.finish()

    # ---- admin handlers ----

    def _is_worker_hop(self, req: web.Request) -> bool:
        wc = self.worker_ctx
        return wc is not None and \
            wc.token_ok(req.headers.get(_wk().WORKER_HEADER))

    async def _sibling_fetch(self, path: str, method: str,
                             timeout_s: float) -> "list[tuple[int, bytes]]":
        """Fetch `path` from every live sibling worker (token-marked so
        they answer locally instead of re-aggregating)."""
        wc = self.worker_ctx
        out: list[tuple[int, bytes]] = []

        async def one(i: int) -> None:
            addr = wc.sibling_addr(i)
            if addr is None:
                return
            try:
                await failpoints.fail("worker.fanout")
                async with self._http.request(
                        method, tls.url(addr, path),
                        headers={_wk().WORKER_HEADER: wc.token},
                        timeout=aiohttp.ClientTimeout(
                            total=timeout_s)) as r:
                    if r.status == 200:
                        out.append((i, await r.read()))
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                # aggregation proceeds without the sibling, but the gap
                # must be visible: an operator reading summed /metrics
                # would otherwise see a silently smaller fleet
                glog.V(1).infof("sibling %d %s unreachable: %s",
                                i, path, e)

        await asyncio.gather(*(one(i) for i in range(wc.total)
                               if i != wc.index))
        return out

    async def _sibling_get(self, path: str) -> "list[tuple[int, bytes]]":
        return await self._sibling_fetch(path, "GET", 3)

    async def h_metrics(self, req: web.Request) -> web.Response:
        """/metrics; under -workers, any worker answers for the whole
        host by summing its siblings' registries, so scrapers keep one
        whole-host target on the shared public port."""
        from ..stats.metrics import merge_metrics_texts, metrics_text
        if self.worker_ctx is None or self._is_worker_hop(req):
            return web.Response(body=metrics_text(),
                                content_type="text/plain")
        texts = [metrics_text()]
        texts += [body for _, body in await self._sibling_get("/metrics")]
        return web.Response(body=merge_metrics_texts(texts),
                            content_type="text/plain")

    async def h_failpoints(self, req: web.Request) -> web.Response:
        """/debug/failpoints with -workers fan-out: failpoint state is
        per-process, and the public port is SO_REUSEPORT-balanced, so
        an arm/disarm that landed on one worker must propagate to every
        sibling or the fleet would inject faults on ~1/N of requests
        (and a follow-up GET would report nothing armed). Query-param
        arming only — a consumed JSON body is not replayed."""
        resp = await failpoints.handle_debug(req)
        wc = self.worker_ctx
        if wc is None or self._is_worker_hop(req) \
                or req.method == "GET" or resp.status != 200:
            return resp

        async def one(i: int) -> None:
            addr = wc.sibling_addr(i)
            if addr is None:
                return
            try:
                async with self._http.request(
                        req.method, tls.url(addr, "/debug/failpoints"),
                        params=req.query,
                        headers={_wk().WORKER_HEADER: wc.token},
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
                    await r.read()
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                glog.warning("failpoint fan-out to worker %d: %s", i, e)

        await asyncio.gather(*(one(i) for i in range(wc.total)
                               if i != wc.index))
        return resp

    async def h_traces(self, req: web.Request) -> web.Response:
        """/debug/traces: recent + slowest-N traces from the in-memory
        span ring; under -workers, any worker answers for the whole
        host by merging its siblings' rings (like /metrics).
        ``?trace=<id>`` instead pulls every span of ONE trace (ring +
        in-flight) — the per-node feed cluster assembly fans over."""
        tid = str(req.query.get("trace", "") or "").strip()[:64]
        if tid:
            payload = tracing.trace_spans_dict(tid)
            wc = self.worker_ctx
            if wc is not None and not self._is_worker_hop(req):
                payloads = [payload]
                for _, body in await self._sibling_get(
                        f"/debug/traces?trace={tid}"):
                    try:
                        payloads.append(json.loads(body))
                    except ValueError:
                        continue
                payload = tracing.merge_trace_payloads(payloads)
            return web.json_response(payload)
        try:
            recent = tracing.clamp_count(req.query.get("n", 20))
            slowest = tracing.clamp_count(req.query.get("slowest", 10))
            payload = tracing.traces_dict(recent=recent, slowest=slowest)
        except ValueError:
            return web.json_response({"error": "bad n/slowest"},
                                     status=400)
        wc = self.worker_ctx
        if wc is not None and not self._is_worker_hop(req):
            payloads = [payload]
            for _, body in await self._sibling_get(
                    f"/debug/traces?n={recent}&slowest={slowest}"):
                try:
                    payloads.append(json.loads(body))
                except ValueError:
                    continue
            payload = tracing.merge_payloads(payloads, recent=recent,
                                             slowest=slowest)
        return web.json_response(payload)

    async def h_requests(self, req: web.Request) -> web.Response:
        """/debug/requests: currently in-flight spans with their age —
        the wedged-request detector; -workers aggregated like above."""
        payload = tracing.requests_dict()
        wc = self.worker_ctx
        if wc is not None and not self._is_worker_hop(req):
            rows = payload["requests"]
            for i, body in await self._sibling_get("/debug/requests"):
                try:
                    sib = json.loads(body)
                except ValueError:
                    continue
                for r in sib.get("requests", ()):
                    r["worker"] = i
                    rows.append(r)
            rows.sort(key=lambda r: -r.get("age_ms", 0))
            payload = {"inflight": len(rows), "requests": rows}
        return web.json_response(payload)

    # ---- flight recorder (stats/timeline.py, util/events.py,
    # stats/slo.py): every surface whole-host merged under -workers
    # with the same discipline as /metrics ----

    async def _merged_timeline(self, req: web.Request, n: int,
                               force_snap: bool = False,
                               render: bool = True) -> dict:
        """This worker's timeline, merged with every sibling's under
        -workers (rates/gauges/histogram buckets summed per wall
        bucket, quantiles recomputed from the summed buckets).

        ``render=False`` (the h_health path) skips the per-window
        quantile interpolation end-to-end: the SLO engine reads only
        the raw hist deltas, and the merge recomputes quantiles from
        summed buckets anyway, so rendering inputs is pure waste."""
        from ..stats import timeline
        if force_snap:
            timeline.snap()
        wc = self.worker_ctx
        if wc is None or self._is_worker_hop(req):
            # merge INPUTS never need rendering (the entry worker
            # recomputes from the summed buckets); only a final
            # payload handed straight to a caller does
            merging = wc is not None
            return timeline.timeline_dict(
                n=n, render=render and not merging)
        payloads = [timeline.timeline_dict(n=n, render=False)]
        snap_q = "&snap=1" if force_snap else ""
        path = f"/debug/timeline?n={n}{snap_q}"
        for _, body in await (
                self._sibling_post(path) if force_snap
                else self._sibling_get(path)):
            try:
                payloads.append(json.loads(body))
            except ValueError:
                continue
        return timeline.merge_payloads(payloads, n=n, render=render)

    async def _sibling_post(self, path: str) -> "list[tuple[int, bytes]]":
        """POST twin of _sibling_get (forced timeline snapshots; the
        longer timeout pays for the sibling's synchronous snap)."""
        return await self._sibling_fetch(path, "POST", 5)

    async def h_timeline(self, req: web.Request) -> web.Response:
        """/debug/timeline: the metrics-timeline ring; GET ?n= windows,
        POST ?snap=1 forces a snapshot NOW (fanned out to siblings so a
        forced whole-host window aligns)."""
        from ..stats import timeline
        force = req.method == "POST"
        if force and req.query.get("snap", "") not in ("1", "true"):
            return web.json_response({"error": "POST wants ?snap=1"},
                                     status=400)
        try:
            n = tracing.clamp_count(req.query.get("n", 60), cap=10_000)
        except ValueError:
            return web.json_response({"error": "bad n"}, status=400)
        return web.json_response(
            await self._merged_timeline(req, n, force_snap=force))

    async def _merged_events(self, req: web.Request,
                             query) -> dict:
        from ..util import events
        payload = events.events_query(query)
        wc = self.worker_ctx
        if wc is None or self._is_worker_hop(req):
            return payload
        # tag COPIES: events_query hands out the live journal rows, and
        # stamping them in place would rewrite every ring entry's shape
        # for all later surfaces (worker-hop responses, slo evidence)
        payload["events"] = [{**r, "worker": wc.index}
                             for r in payload["events"]]
        payloads = [payload]
        # urlencode, not raw interpolation: a type/since_ms value with
        # a reserved char would 400 on the sibling and its rows would
        # silently vanish from the merged journal
        qs = urllib.parse.urlencode(query)
        for i, body in await self._sibling_get(
                "/debug/events" + (f"?{qs}" if qs else "")):
            try:
                sib = json.loads(body)
            except ValueError:
                continue
            for r in sib.get("events", ()):
                r["worker"] = i
            payloads.append(sib)
        return events.merge_payloads(
            payloads, n=int(query.get("n", 100) or 100))

    async def h_events(self, req: web.Request) -> web.Response:
        """/debug/events: the structured event journal (breaker trips,
        holder refreshes, scrub corruptions, mounts, respawns, ...)
        with wall stamps and trace ids; -workers merged, rows tagged
        with their worker index."""
        try:
            payload = await self._merged_events(req, dict(req.query))
        except ValueError:
            return web.json_response({"error": "bad n/type/since_ms"},
                                     status=400)
        return web.json_response(payload)

    async def h_health(self, req: web.Request) -> web.Response:
        """/debug/health: the SLO burn-rate verdict (ok/warn/page) with
        evidence, evaluated over the WHOLE-HOST merged timeline and
        journal under -workers — the one machine-readable answer soaks
        and operators assert against."""
        from ..stats import slo
        eng = slo.engine()
        if eng is None or not eng.specs:
            # no objectives armed: health_dict ignores its arguments
            # and returns the ok stub — don't pay the sibling
            # timeline/journal fan-out just to discard it
            return web.json_response(slo.health_dict([]))
        timeline_payload, events_payload = await asyncio.gather(
            self._merged_timeline(req, slo.windows_needed(),
                                  render=False),
            self._merged_events(req, {"n": "500"}))
        return web.json_response(slo.health_dict(
            timeline_payload["windows"],
            events=events_payload["events"]))

    async def h_qos(self, req: web.Request) -> web.Response:
        """/debug/qos: per-tenant admission counters, shed level and
        bandwidth-arbiter ledger; -workers merged (counters sum, shed
        level takes the worst worker) like /debug/timeline."""
        payload = qos.qos_dict()
        wc = self.worker_ctx
        if wc is None or self._is_worker_hop(req):
            return web.json_response(payload)
        payloads = [payload]
        for _, body in await self._sibling_get("/debug/qos"):
            try:
                payloads.append(json.loads(body))
            except ValueError:
                continue
        return web.json_response(qos.merge_payloads(payloads))

    async def h_profile(self, req: web.Request) -> web.Response:
        """/debug/profile: the continuous sampling profiler's folded
        stacks (?seconds=N records a fresh window; ?format=folded for
        flamegraph-ready text); -workers merged by summing folded
        counts — each worker samples only itself."""
        from ..stats import profiler
        try:
            payload = await profiler.profile_query(req.query)
        except ValueError:
            return web.json_response({"error": "bad seconds/hz"},
                                     status=400)
        wc = self.worker_ctx
        if wc is not None and not self._is_worker_hop(req):
            payloads = [payload]
            qs = urllib.parse.urlencode(
                {k: req.query[k] for k in ("seconds", "hz")
                 if k in req.query})
            # a ?seconds=N window makes the sibling block for N: pad
            # the fan-out timeout past the window instead of 3s
            secs = float(req.query.get("seconds", 0) or 0)
            for _, body in await self._sibling_fetch(
                    "/debug/profile" + (f"?{qs}" if qs else ""),
                    "GET", max(3.0, secs + 5.0)):
                try:
                    payloads.append(json.loads(body))
                except ValueError:
                    continue
            payload = profiler.merge_payloads(payloads)
        if req.query.get("format") == "folded":
            from ..stats.profiler import folded_text
            return web.Response(text=folded_text(payload),
                                content_type="text/plain")
        return web.json_response(payload)

    async def h_pprof(self, req: web.Request) -> web.Response:
        """/debug/pprof: which -cpuprofile/-memprofile collectors are
        armed; ?dump=1 snapshots them to disk NOW (fanned across
        -workers so every sibling's profile lands, not just the worker
        the balancer picked)."""
        from ..util import pprof
        dump = req.query.get("dump", "") in ("1", "true")
        payload: dict = {"workers": {}} if self.worker_ctx else {}
        # executor hop: the mem dump writes a file
        body = await tracing.run_in_executor(
            lambda: pprof.pprof_dict(dump=dump))
        wc = self.worker_ctx
        if wc is None or self._is_worker_hop(req):
            return web.json_response(body)
        payload["workers"][str(wc.index)] = body
        qs = "?dump=1" if dump else ""
        for i, raw in await self._sibling_get("/debug/pprof" + qs):
            try:
                payload["workers"][str(i)] = json.loads(raw)
            except ValueError:
                continue
        return web.json_response(payload)

    async def h_scrub(self, req: web.Request) -> web.Response:
        """/debug/scrub: paced-scrubber status; POST ?run=1 forces one
        full cycle NOW and returns its report (how tests and the scrub
        soak drive deterministic passes). Under -workers, GET merges
        every sibling's status like /status — each worker scrubs its
        own partition."""
        if req.method == "POST":
            if req.query.get("run", "") not in ("1", "true"):
                return web.json_response(
                    {"error": "POST wants ?run=1"}, status=400)
            report = await self.scrubber.run_cycle()
            out = {"cycle": report, "status": self.scrubber.status()}
            wc = self.worker_ctx
            if wc is not None and not self._is_worker_hop(req):
                # each worker scrubs only its own vid partition: a
                # forced cycle must fan out to every sibling or ~1/N
                # of the host's volumes silently go unscanned
                out = {"workers": {str(wc.index): out}}

                async def one(i: int) -> None:
                    addr = wc.sibling_addr(i)
                    if addr is None:
                        return
                    try:
                        await failpoints.fail("scrub.fanout")
                        async with self._http.post(
                                tls.url(addr, "/debug/scrub"),
                                params={"run": "1"},
                                headers={_wk().WORKER_HEADER: wc.token},
                                timeout=aiohttp.ClientTimeout(
                                    total=600)) as r:
                            out["workers"][str(i)] = await r.json()
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError, ValueError) as e:
                        glog.warning("scrub fan-out to worker %d: %s",
                                     i, e)
                        out["workers"][str(i)] = {"error": str(e)}

                await asyncio.gather(*(one(i) for i in range(wc.total)
                                       if i != wc.index))
            return web.json_response(out)
        if req.method != "GET":
            return web.json_response({"error": "method not allowed"},
                                     status=405)
        payload: dict = {"scrub": self.scrubber.status()}
        wc = self.worker_ctx
        if wc is not None and not self._is_worker_hop(req):
            payload["workers"] = {str(wc.index): payload.pop("scrub")}
            for i, body in await self._sibling_get("/debug/scrub"):
                try:
                    sib = json.loads(body)
                except ValueError:
                    continue
                if "scrub" in sib:
                    payload["workers"][str(i)] = sib["scrub"]
        return web.json_response(payload)

    async def h_breakers(self, req: web.Request) -> web.Response:
        """Circuit-breaker states of this server's upstream hops
        (sibling workers + the lazily-built weed client), for chaos
        runs and operators probing a brown-out."""
        out = {"siblings": self._sibling_breakers.to_dict()}
        wc = getattr(self, "_wclient", None)
        if wc is not None:
            out["client"] = wc.breakers.to_dict()
        return web.json_response(out)

    async def h_status(self, req: web.Request) -> web.Response:
        vols = [self.store._volume_message(v).to_dict()
                for v in self.store.volumes.values()]
        ec = {vid: sorted(ev.shards)
              for vid, ev in self.store.ec_volumes.items()}
        out = {"version": "seaweedfs_tpu 0.1", "volumes": vols,
               "ecVolumes": ec}
        caches = {}
        if self.store.needle_cache is not None:
            caches["needle"] = self.store.needle_cache.to_dict()
        if self.store.ec_recover_cache is not None:
            caches["ec_recover"] = \
                self.store.ec_recover_cache.counters.to_dict()
        if caches:
            out["caches"] = caches
        gc = self.store.group_commit_stats()
        if gc["batches"]:
            out["group_commit"] = gc
        wc = self.worker_ctx
        frames = self.frame_hub.stats_dict()
        if frames:
            # this worker's outbound frame channels (sibling hops +
            # EC gathers), nested per worker index: the deterministic
            # accounting the sibling bench scrapes
            out["frames"] = {f"w{wc.index if wc else 0}": frames}
        if wc is not None and not self._is_worker_hop(req):
            # whole-host view: fold in every sibling's partition
            out["workers"] = wc.total
            out["worker"] = wc.index
            for _, body in await self._sibling_get("/status"):
                try:
                    sib = json.loads(body)
                except ValueError:
                    continue
                vols.extend(sib.get("volumes", []))
                ec.update(sib.get("ecVolumes", {}))
                if sib.get("frames"):
                    out.setdefault("frames", {}).update(sib["frames"])
            vols.sort(key=lambda m: m.get("id", 0))
        return web.json_response(out)

    async def h_stats_workers(self, req: web.Request) -> web.Response:
        """Worker-fleet view: one row per configured worker slot, from
        the shared state files (works no matter which worker answers)."""
        wc = self.worker_ctx
        if wc is None:
            return web.json_response({"workers": [], "total": 1})
        rows = []
        for i, st in enumerate(wc.all_states()):
            row = {"index": i, "alive": False}
            if st:
                row.update({k: st[k] for k in
                            ("pid", "ip", "port", "public_port", "role")
                            if k in st})
                try:
                    os.kill(st["pid"], 0)
                    row["alive"] = True
                except ProcessLookupError:
                    row["stale_state"] = True  # dead pid: alive=False IS
                    # the signal; marked so operators can tell a dead
                    # worker from a never-started one
                except (PermissionError, KeyError):
                    # EPERM: the pid exists but isn't ours to signal
                    row["alive"] = "pid" in st
            if i == wc.index:
                row["volumes"] = sorted(self.store.volumes)
            rows.append(row)
        return web.json_response({"workers": rows, "total": wc.total})

    async def h_ui(self, req: web.Request) -> web.Response:
        """Live volume status page (server/volume_server_ui/)."""
        from html import escape
        rows = []
        for v in self.store.volumes.values():
            m = self.store._volume_message(v)
            # collection names come from user-controlled assign params:
            # escape to keep the admin page XSS-free
            rows.append(
                f"<tr><td>{m.id}</td><td>{escape(m.collection) or '-'}</td>"
                f"<td>{m.size}</td><td>{m.file_count}</td>"
                f"<td>{m.delete_count}</td>"
                f"<td>{'ro' if m.read_only else 'rw'}</td></tr>")
        ec_rows = [f"<tr><td>{vid}</td><td>{sorted(ev.shards)}</td></tr>"
                   for vid, ev in self.store.ec_volumes.items()]
        html = f"""<!DOCTYPE html><html><head><title>seaweedfs_tpu volume
</title></head><body><h1>seaweedfs_tpu volume server {escape(self.url)}</h1>
<p>master: {escape(self.master_url)} | dc: {escape(self.data_center) or '-'}
| rack: {escape(self.rack) or '-'}</p>
<h2>Volumes</h2><table border=1 cellpadding=4><tr><th>Id</th>
<th>Collection</th><th>Size</th><th>Files</th><th>Deleted</th><th>Mode</th>
</tr>{''.join(rows)}</table>
<h2>EC shards</h2><table border=1 cellpadding=4><tr><th>Volume</th>
<th>Shards</th></tr>{''.join(ec_rows)}</table></body></html>"""
        return web.Response(text=html, content_type="text/html")

    async def h_allocate(self, req: web.Request) -> web.Response:
        q = req.query
        try:
            self.store.add_volume(
                int(q["volume"]), q.get("collection", ""),
                q.get("replication", ""), q.get("ttl", ""),
                int(q.get("preallocate", 0) or 0))
        except VolumeError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"ok": True})

    async def h_volume_delete(self, req: web.Request) -> web.Response:
        try:
            self.store.delete_volume(int(req.query["volume"]),
                                     req.query.get("collection", ""))
        except VolumeError as e:
            # a delete that found nothing must not report success
            return web.json_response({"error": str(e)}, status=404)
        # the master must drop this location before the next pulse, or
        # lookups keep routing reads at a volume that no longer exists
        await self._heartbeat_now()
        return web.json_response({"ok": True})

    async def h_readonly(self, req: web.Request) -> web.Response:
        self.store.mark_readonly(int(req.query["volume"]))
        return web.json_response({"ok": True})

    async def h_volume_mount(self, req: web.Request) -> web.Response:
        """Load an on-disk volume into the store (VolumeMount)."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        try:
            await self._in_executor(lambda: self.store.mount_volume(collection, vid))
        except VolumeError as e:
            return web.json_response({"error": str(e)}, status=404)
        await self._heartbeat_now()
        return web.json_response({"ok": True})

    async def h_volume_unmount(self, req: web.Request) -> web.Response:
        self.store.unmount_volume(int(req.query["volume"]))
        await self._heartbeat_now()
        return web.json_response({"ok": True})

    async def h_volume_copy(self, req: web.Request) -> web.Response:
        """Pull .idx then .dat from a source server, then mount
        (VolumeCopy, server/volume_grpc_copy.go). .idx is copied first so a
        racing write at most leaves extra .dat tail beyond the last copied
        index entry, which the mount-time integrity check truncates."""
        q = req.query
        vid = int(q["volume"])
        collection = q.get("collection", "")
        source = q["source"]
        if vid in self.store.volumes:
            return web.json_response({"error": "already have volume"},
                                     status=409)
        d = self.store.dirs[0]
        base = os.path.join(
            d, f"{collection}_{vid}" if collection else str(vid))

        async def fetch(ext: str) -> str | None:
            try:
                await failpoints.fail("volume.copy.fetch")
                async with self._http.get(
                        tls.url(source, "/admin/file"),
                        params={"volume": str(vid), "collection": collection,
                                "ext": ext}) as resp:
                    if resp.status != 200:
                        return f"fetch {ext}: {resp.status}"
                    # a .dat can be GBs: open/write/close all leave the
                    # event loop so in-flight reads don't stall behind
                    # this admin copy
                    f = await self._in_executor(open, base + ext, "wb")
                    try:
                        async for chunk in resp.content.iter_chunked(
                                1 << 20):
                            await self._in_executor(f.write, chunk)
                    finally:
                        await self._in_executor(f.close)
                    return None
            except (aiohttp.ClientError, OSError) as e:
                return str(e)

        err = await fetch(".idx") or await fetch(".dat")
        if err:
            for ext in (".idx", ".dat"):
                if os.path.exists(base + ext):
                    await self._in_executor(os.remove, base + ext)
            return web.json_response({"error": err}, status=502)
        return await self.h_volume_mount(req)

    # ---- incremental backup / tail (volume_backup.go) ----

    async def h_volume_status(self, req: web.Request) -> web.Response:
        """Per-volume sync metadata (VolumeSyncStatus RPC analog)."""
        vid = int(req.query["volume"])
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({
            "volume": vid,
            "collection": v.collection,
            "last_append_at_ns": v.last_append_at_ns,
            "compaction_revision": v.super_block.compaction_revision,
            "replication": str(v.super_block.replica_placement),
            "ttl": str(v.ttl),
            "data_size": v.data_size(),
        })

    async def h_volume_tail(self, req: web.Request) -> web.StreamResponse:
        """VolumeTailSender (volume_server.proto:47-50): stream framed
        needle records appended after since_ns."""
        from ..storage import volume_backup as vb
        vid = int(req.query["volume"])
        since_ns = int(req.query.get("since_ns", 0))
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        resp = web.StreamResponse(
            headers={"Content-Type": "application/octet-stream"})
        await resp.prepare(req)
        # stream record-by-record: each iteration does one short locked
        # read in the executor, so large tails neither hold the volume
        # lock across awaits nor buffer the whole tail in RAM
        it = vb.tail_records(v, since_ns)
        while True:
            item = await self._in_executor(lambda: next(it, None))
            if item is None:
                break
            n, is_delete = item
            await resp.write(vb.frame_needle(n, is_delete))
        await resp.write_eof()
        return resp

    async def h_volume_tail_receive(self, req: web.Request) -> web.Response:
        """VolumeTailReceiver: pull a source volume's tail into the local
        copy (used by replica catch-up)."""
        from ..storage import volume_backup as vb
        q = req.query
        vid = int(q["volume"])
        source = q["source"]
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        since = v.last_append_at_ns
        applied = 0
        dec = vb.FrameDecoder()

        def apply_batch(recs) -> int:
            nc = self.store.needle_cache
            for n, is_delete in recs:
                vb.apply_needle(v, n, is_delete)
                if nc is not None:
                    # tail apply bypasses store.write/delete: each
                    # replayed record must still invalidate its entry
                    nc.invalidate(vid, n.id)
            return len(recs)

        try:
            await failpoints.fail("volume.tail")
            async with self._http.get(
                    tls.url(source, "/admin/volume/tail"),
                    params={"volume": str(vid),
                            "since_ns": str(since)}) as resp:
                if resp.status != 200:
                    return web.json_response(
                        {"error": f"tail from {source}: {resp.status}"},
                        status=502)
                # apply as chunks arrive — no whole-tail buffering
                async for chunk in resp.content.iter_chunked(1 << 20):
                    recs = dec.feed(chunk)
                    if recs:
                        applied += await self._in_executor(lambda: apply_batch(recs))
        except (aiohttp.ClientError, OSError) as e:
            return web.json_response({"error": str(e)}, status=502)
        return web.json_response({"applied": applied})

    # ---- tiered storage (volume_grpc_tier_upload.go/_download.go) ----

    async def h_tier_upload(self, req: web.Request) -> web.Response:
        """VolumeTierMoveDatToRemote: ship .dat to a configured backend."""
        from ..storage import volume_tier
        from ..storage.backend import BackendError
        q = req.query
        vid = int(q["volume"])
        backend_id = q.get("backend", "s3.default")
        keep_local = q.get("keep_local", "") == "1"
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        try:
            size = await self._in_executor(lambda: volume_tier.tier_upload(
                    v, backend_id, keep_local))
        except (BackendError, VolumeError) as e:
            return web.json_response({"error": str(e)}, status=502)
        return web.json_response({"uploaded": size, "backend": backend_id})

    async def h_tier_download(self, req: web.Request) -> web.Response:
        """VolumeTierMoveDatFromRemote: bring the .dat back to disk."""
        from ..storage import volume_tier
        from ..storage.backend import BackendError
        vid = int(req.query["volume"])
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        try:
            size = await self._in_executor(lambda: volume_tier.tier_download(v))
        except (BackendError, VolumeError) as e:
            return web.json_response({"error": str(e)}, status=502)
        return web.json_response({"downloaded": size})

    # ---- vacuum (volume_vacuum.go + topology_vacuum.go protocol) ----

    async def h_vacuum_check(self, req: web.Request) -> web.Response:
        vid = int(req.query["volume"])
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"garbage_ratio": v.garbage_level()})

    async def h_vacuum_compact(self, req: web.Request) -> web.Response:
        from ..storage import vacuum
        vid = int(req.query["volume"])
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        await self._in_executor(lambda: vacuum.compact(v))
        return web.json_response({"ok": True})

    async def h_vacuum_commit(self, req: web.Request) -> web.Response:
        from ..storage import vacuum
        vid = int(req.query["volume"])
        v = self.store.volumes.get(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        try:
            # store-level commit: swaps .dat/.idx AND drops this
            # volume's hot-needle cache entries (offsets all moved)
            await self._in_executor(lambda: self.store.commit_compaction(vid))
        except vacuum.VacuumError as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"ok": True})

    async def h_vacuum_cleanup(self, req: web.Request) -> web.Response:
        from ..storage import vacuum
        vid = int(req.query["volume"])
        v = self.store.volumes.get(vid)
        if v is not None:
            # unlinks .cpd/.cpx leftovers — disk metadata ops belong
            # on the executor like every other blocking call here
            await self._in_executor(vacuum.cleanup_compact, v)
        return web.json_response({"ok": True})

    def _base_name(self, vid: int, collection: str) -> str | None:
        for d in self.store.dirs:
            base = os.path.join(
                d, f"{collection}_{vid}" if collection else str(vid))
            if os.path.exists(base + ".dat") or os.path.exists(base + ".ecx") \
                    or any(os.path.exists(base + ecpl.to_ext(i))
                           for i in range(gf.TOTAL_SHARDS)):
                return base
        return None

    async def h_ec_generate(self, req: web.Request) -> web.Response:
        """VolumeEcShardsGenerate (volume_grpc_erasure_coding.go:39-67):
        .dat -> 14 shards + .ecx, via the EC engine (the CUDA kernel
        under -ecBackend gpu)."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        v = self.store.volumes.get(vid)
        base = v.file_name() if v else self._base_name(vid, collection)
        if base is None:
            return web.json_response({"error": f"volume {vid} not found"},
                                     status=404)

        stats: dict = {}

        def work():
            ecpl.encode_volume(base,
                               large_block=self.store.ec_large_block,
                               small_block=self.store.ec_small_block,
                               stats=stats)
            ecpl.write_sorted_file_from_idx(base)
        await self._in_executor(work)
        return web.json_response({"ok": True,
                                  "windows": stats.get("windows", 0),
                                  "dispatches": stats.get("dispatches", 0)})

    async def h_ec_generate_batch(self, req: web.Request) -> web.Response:
        """Batched VolumeEcShardsGenerate over several local volumes: one
        kernel launch carries buffer groups from every volume (the
        rack-encode shape; pipeline.write_ec_files_batched)."""
        vids = [int(x) for x in req.query["volumes"].split(",") if x]
        collection = req.query.get("collection", "")
        wc = self.worker_ctx
        if wc is not None and not self._is_worker_hop(req):
            # split the batch across owning workers; each owner still
            # batches ITS volumes through one kernel launch
            mine = [v for v in vids if wc.owns(v)]
            failed: list[str] = []

            async def forward(idx: int, group: list[int]) -> None:
                addr = wc.sibling_addr(idx)
                try:
                    if addr is None:
                        raise OSError(f"worker {idx} unavailable")
                    await failpoints.fail("worker.forward")
                    async with self._http.post(
                            tls.url(addr, "/admin/ec/generate_batch"),
                            params={"volumes": ",".join(map(str, group)),
                                    "collection": collection},
                            headers={_wk().WORKER_HEADER: wc.token},
                            timeout=aiohttp.ClientTimeout(
                                total=600)) as resp:
                        if resp.status != 200:
                            failed.append(await resp.text())
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError) as e:
                    failed.append(str(e))

            groups: dict[int, list[int]] = {}
            for v in vids:
                if not wc.owns(v):
                    groups.setdefault(wc.owner_index(v), []).append(v)
            jobs = [forward(i, g) for i, g in groups.items()]
            if mine:
                from multidict import CIMultiDict
                h = CIMultiDict(req.headers)
                h[_wk().WORKER_HEADER] = wc.token
                sub = req.clone(
                    rel_url=req.rel_url.update_query(
                        volumes=",".join(map(str, mine))),
                    headers=h)
                jobs.append(self.h_ec_generate_batch(sub))
            done = await asyncio.gather(*jobs, return_exceptions=True)
            for d in done:
                if isinstance(d, Exception):
                    failed.append(str(d))
                elif isinstance(d, web.Response) and d.status != 200:
                    failed.append(d.text or "")
            if failed:
                return web.json_response(
                    {"error": "; ".join(failed)}, status=502)
            return web.json_response({"ok": True, "volumes": vids})
        bases = []
        for vid in vids:
            v = self.store.volumes.get(vid)
            base = v.file_name() if v else self._base_name(vid, collection)
            if base is None:
                return web.json_response(
                    {"error": f"volume {vid} not found"}, status=404)
            bases.append(base)

        def work():
            ecpl.write_ec_files_batched(
                bases, large_block=self.store.ec_large_block,
                small_block=self.store.ec_small_block)
            for base in bases:
                ecpl.write_sorted_file_from_idx(base)
        await self._in_executor(work)
        return web.json_response({"ok": True, "volumes": vids})

    async def h_ec_rebuild(self, req: web.Request) -> web.Response:
        """VolumeEcShardsRebuild (volume_grpc_erasure_coding.go:70-97)."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        base = self._base_name(vid, collection)
        if base is None:
            return web.json_response({"error": f"ec volume {vid} not found"},
                                     status=404)
        try:
            rebuilt = await self._in_executor(lambda: ecpl.rebuild_ec_files(base))
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"rebuilt": rebuilt})

    async def _fetch_shard_file(self, source: str, vid: int,
                                collection: str, ext: str,
                                base: str) -> str | None:
        """Pull one shard/index file from a holder via /admin/file
        (the ec.copy fetch shape); returns an error string or None.
        Streams into a temp file and renames only on a COMPLETE body:
        a source dying mid-stream must never leave a truncated shard
        file that a later pass would mount or feed into a rebuild."""
        tmp = base + ext + ".fetch"
        try:
            await failpoints.fail("volume.ec_copy.fetch")
            async with self._http.get(
                    tls.url(source, "/admin/file"),
                    params={"volume": str(vid),
                            "collection": collection, "ext": ext},
                    timeout=aiohttp.ClientTimeout(total=600)) as resp:
                if resp.status != 200:
                    return f"fetch {ext} from {source}: {resp.status}"
                f = await self._in_executor(open, tmp, "wb")
                try:
                    async for chunk in resp.content.iter_chunked(1 << 20):
                        await self._in_executor(f.write, chunk)
                finally:
                    await self._in_executor(f.close)
            await self._in_executor(os.replace, tmp, base + ext)
            return None
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            await self._in_executor(self._unlink_quiet, tmp)
            return str(e)

    async def h_ec_rebuild_shard(self, req: web.Request) -> web.Response:
        """Rebuild-to-target shard placement — the autopilot's repair
        primitive (no reference RPC; command_ec_rebuild.go gathers on
        the freest node via N shell round trips, this does the same
        server-side in ONE call so the planner owns placement):

        POST ?volume=&collection=&shards=2,5&sources=0:host:port,...

        This node regenerates the requested shards HERE: k clean
        inputs are gathered from the source holders (currently-MOUNTED
        local survivors are free), a local (rotten) copy of a
        requested shard is set aside only once the inputs are
        confirmed, the requested rows come out of one stripe-batched
        rebuild over exactly the validated inputs, borrowed inputs are
        dropped, and the result is mounted + registered. Serialized
        per vid: an executor retry racing a still-running rebuild of
        the same volume queues instead of interleaving file writes."""
        q = req.query
        vid = int(q["volume"])
        collection = q.get("collection", "")
        if not self.store.owns(vid):
            # wrong -workers partition: refuse BEFORE streaming GBs of
            # inputs the final mount would reject anyway — the
            # executor falls over to its next ranked target
            return web.json_response(
                {"error": f"volume {vid} not in this worker's "
                          f"partition"}, status=409)
        want = sorted({int(x) for x in q.get("shards", "").split(",")
                       if x})
        if not want:
            return web.json_response({"error": "no shards requested"},
                                     status=400)
        sources: dict[int, str] = {}
        for part in q.get("sources", "").split(","):
            if not part:
                continue
            sid_s, _, url = part.partition(":")
            try:
                sources[int(sid_s)] = url
            except ValueError:
                return web.json_response(
                    {"error": f"bad sources entry {part!r}"}, status=400)
        if len(self._rebuild_locks) > 1024:  # id-space leak bound
            self._rebuild_locks = {
                v: lk for v, lk in self._rebuild_locks.items()
                if lk.locked()}
        lock = self._rebuild_locks.setdefault(vid, asyncio.Lock())
        async with lock:
            return await self._rebuild_shard_locked(
                vid, collection, want, sources)

    async def _rebuild_shard_locked(self, vid: int, collection: str,
                                    want: list,
                                    sources: dict) -> web.Response:
        base = self._base_name(vid, collection)
        if base is None:
            base = os.path.join(
                self.store.dirs[0],
                f"{collection}_{vid}" if collection else str(vid))
        # 1. the sorted needle index must exist locally before mount
        if not os.path.exists(base + ".ecx"):
            holders = sorted(set(sources.values()))
            err = f"no source holders for .ecx of volume {vid}"
            for holder in holders:
                err = await self._fetch_shard_file(
                    holder, vid, collection, ".ecx", base)
                if err is None:
                    # the delete journal may legitimately not exist
                    await self._fetch_shard_file(
                        holder, vid, collection, ".ecj", base)
                    break
            if err is not None:
                return web.json_response({"error": err}, status=502)
        # 2. gather until k distinct clean inputs are on local disk
        # (planner-listed survivors only; currently-MOUNTED local
        # shards are free — an unmounted leftover file could be a
        # stale generation, so anything else streams fresh from its
        # listed holder, overwriting the leftover via the tmp+rename).
        # Gathering runs BEFORE any local copy of a requested shard is
        # touched: a failed gather must leave a rotten-but-mostly-good
        # shard serving, never convert one corrupt window into a lost
        # shard
        ev0 = self.store.ec_volumes.get(vid)
        mounted_now = set(ev0.shards) if ev0 is not None else set()
        fetched: list[int] = []
        inputs: list[int] = []
        for sid in sorted(sources):
            if sid in want:
                continue
            if len(inputs) >= gf.DATA_SHARDS:
                break
            if sid in mounted_now \
                    and os.path.exists(base + ecpl.to_ext(sid)):
                inputs.append(sid)
                continue
            err = await self._fetch_shard_file(
                sources[sid], vid, collection, ecpl.to_ext(sid), base)
            if err is not None:
                glog.warning("rebuild_shard vid=%d: input %d: %s",
                             vid, sid, err)
                continue
            fetched.append(sid)
            inputs.append(sid)

        async def drop_fetched() -> None:
            for sid in fetched:
                p = base + ecpl.to_ext(sid)
                if os.path.exists(p):
                    await self._in_executor(os.remove, p)

        if len(inputs) < gf.DATA_SHARDS:
            await drop_fetched()
            return web.json_response(
                {"error": f"unrepairable here: only {len(inputs)} "
                          f"inputs gathered, need {gf.DATA_SHARDS}"},
                status=409)
        # 3. k inputs confirmed on disk — NOW a requested shard hosted
        # here (in-place rot repair) is unmounted and its file set
        # ASIDE (atomic rename, not delete): if the rebuild itself
        # fails, the rotten-but-mostly-good copy is restored and
        # remounted rather than lost outright
        ev = self.store.ec_volumes.get(vid)
        mounted_want = [sid for sid in want
                        if ev is not None and sid in ev.shards]
        if mounted_want:
            self.store.unmount_ec_shards(vid, mounted_want)
        aside: list[int] = []
        for sid in want:
            p = base + ecpl.to_ext(sid)
            if os.path.exists(p):
                await self._in_executor(os.replace, p, p + ".rot")
                aside.append(sid)
        # 4. regenerate ONLY the requested rows from ONLY the
        # validated clean inputs (one batched dispatch per window
        # block), 5. return the borrowed inputs' disk space
        try:
            rebuilt = await self._in_executor(
                lambda: ecpl.rebuild_ec_files(base, targets=want,
                                              use=inputs))
        except (ValueError, OSError) as e:
            for sid in aside:       # restore + remount the old copies
                p = base + ecpl.to_ext(sid)
                await self._in_executor(os.replace, p + ".rot", p)
            await drop_fetched()
            if aside:
                try:
                    self.store.mount_ec_shards(collection, vid)
                except VolumeError as e2:
                    glog.warning("rebuild_shard vid=%d: restore "
                                 "remount: %s", vid, e2)
                await self._heartbeat_now()
            return web.json_response({"error": str(e)}, status=500)
        for sid in aside:
            await self._in_executor(self._unlink_quiet,
                                    base + ecpl.to_ext(sid) + ".rot")
        await drop_fetched()
        # 6. mount what this node now hosts and register it NOW — a
        # degraded read anywhere in the cluster must find the repaired
        # shard without waiting out a pulse
        try:
            shards = self.store.mount_ec_shards(collection, vid)
        except VolumeError as e:
            # nothing got mounted: don't leave just-rebuilt shard
            # files orphaned on disk to be resurrected as a stale
            # generation later
            for sid in rebuilt:
                await self._in_executor(self._unlink_quiet,
                                        base + ecpl.to_ext(sid))
            return web.json_response({"error": str(e)}, status=409)
        await self._heartbeat_now()
        return web.json_response({"rebuilt": rebuilt, "mounted": shards,
                                  "fetched_inputs": fetched})

    async def h_ec_verify(self, req: web.Request) -> web.Response:
        """Parity scrub of a mounted EC volume (EcVolume.verify_parity):
        recomputes RS(10,4) parity for every stripe window through the
        configured encoder (the CUDA kernel under -ecBackend gpu) and
        reports corrupt window offsets. No reference RPC — its
        integrity checking stops at per-needle CRC on read
        (needle/crc.go)."""
        vid = int(req.query["volume"])
        ev = self.store.ec_volumes.get(vid)
        if ev is None:
            return web.json_response({"error": f"ec volume {vid} not "
                                      f"mounted"}, status=404)
        window = int(req.query.get("windowMB", 1)) << 20
        try:
            report = await self._in_executor(lambda: ev.verify_parity(window))
        except (OSError, EcVolumeError) as e:
            return web.json_response({"error": str(e)}, status=500)
        report["volume"] = vid
        return web.json_response(report)

    async def h_ec_mount(self, req: web.Request) -> web.Response:
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        try:
            shards = self.store.mount_ec_shards(collection, vid)
        except VolumeError as e:
            return web.json_response({"error": str(e)}, status=404)
        # push the registration NOW, not at the next pulse: a read that
        # lands anywhere in the cluster within the pulse window needs
        # the master to know these shard locations, or reconstruction
        # fails with too few sources (the reference's delta heartbeat
        # channel, volume_grpc_client_to_master.go:120-177)
        await self._heartbeat_now()
        return web.json_response({"shards": shards})

    async def _heartbeat_now(self) -> None:
        try:
            if not await self.heartbeat_once():
                # a follower redirected us: the LEADER must learn the
                # new state now, not at the next pulse
                await self.heartbeat_once()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            glog.warning("immediate heartbeat failed: %s", e)

    async def h_ec_unmount(self, req: web.Request) -> web.Response:
        vid = int(req.query["volume"])
        ids = req.query.get("shards", "")
        shard_ids = [int(x) for x in ids.split(",") if x] if ids else None
        self.store.unmount_ec_shards(vid, shard_ids)
        await self._heartbeat_now()
        return web.json_response({"ok": True})

    async def h_ec_copy(self, req: web.Request) -> web.Response:
        """VolumeEcShardsCopy (volume_grpc_erasure_coding.go:100-148):
        pull shard files (and optionally .ecx/.ecj) from a source server."""
        q = req.query
        vid = int(q["volume"])
        collection = q.get("collection", "")
        source = q["source"]
        shard_ids = [int(x) for x in q.get("shards", "").split(",") if x]
        copy_ecx = q.get("copy_ecx", "") == "1"
        d = self.store.dirs[0]
        base = os.path.join(
            d, f"{collection}_{vid}" if collection else str(vid))
        exts = [ecpl.to_ext(sid) for sid in shard_ids]
        if copy_ecx:
            exts += [".ecx", ".ecj"]
        for ext in exts:
            try:
                await failpoints.fail("volume.ec_copy.fetch")
                async with self._http.get(
                        tls.url(source, "/admin/file"),
                        params={"volume": str(vid),
                                "collection": collection,
                                "ext": ext}) as resp:
                    if resp.status != 200:
                        if ext == ".ecj":  # journal may not exist yet
                            continue
                        return web.json_response(
                            {"error": f"fetch {ext} from {source}: "
                                      f"{resp.status}"}, status=502)
                    # shard files are volume-sized: file I/O off-loop
                    f = await self._in_executor(open, base + ext, "wb")
                    try:
                        async for chunk in resp.content.iter_chunked(
                                1 << 20):
                            await self._in_executor(f.write, chunk)
                    finally:
                        await self._in_executor(f.close)
            except (aiohttp.ClientError, OSError) as e:
                return web.json_response({"error": str(e)}, status=502)
        return web.json_response({"ok": True})

    async def h_ec_delete_shards(self, req: web.Request) -> web.Response:
        q = req.query
        vid = int(q["volume"])
        collection = q.get("collection", "")
        shard_ids = [int(x) for x in q.get("shards", "").split(",") if x]
        base = self._base_name(vid, collection)
        if base:
            exts = [ecpl.to_ext(sid) for sid in shard_ids]
            if q.get("ecx", "") == "1":  # full teardown (ec.decode)
                exts += [".ecx", ".ecj"]
            for ext in exts:
                p = base + ext
                if os.path.exists(p):
                    await self._in_executor(os.remove, p)
        return web.json_response({"ok": True})

    async def h_ec_to_volume(self, req: web.Request) -> web.Response:
        """VolumeEcShardsToVolume (volume_grpc_erasure_coding.go:350-379):
        collected data shards + .ecx -> .dat + .idx on disk, ready for
        /admin/volume/mount. The ec.decode shell command gathers the
        shards here first (command_ec_decode.go)."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        base = self._base_name(vid, collection)
        if base is None:
            return web.json_response({"error": f"ec volume {vid} not found"},
                                     status=404)

        def work():
            dat_size = ecpl.find_dat_file_size(base)
            ecpl.write_dat_file(base, dat_size,
                                large_block=self.store.ec_large_block,
                                small_block=self.store.ec_small_block)
            ecpl.write_idx_file_from_ec_index(base)
            return dat_size
        try:
            dat_size = await self._in_executor(work)
        except FileNotFoundError as e:
            # a data shard is absent on this node: the caller must gather
            # or rebuild shards 0..9 here first
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"ok": True, "dat_size": dat_size})

    async def h_ec_shard_read(self, req: web.Request) -> web.Response:
        """VolumeEcShardRead (volume_grpc_erasure_coding.go:254-320).
        The batched form `?reads=sid:off:size,...` answers many
        intervals in one round trip using the shared batch framing —
        a degraded read's gather costs one request per holder."""
        q = req.query
        vid = int(q["volume"])
        if "reads" in q:
            try:
                reads = batchframe.parse_reads_spec(q["reads"])
            except ValueError:
                return web.json_response(
                    {"error": "bad reads spec"}, status=400)
            datas = await self._in_executor(
                self.store.read_ec_shard_intervals, vid, reads)
            return web.Response(
                body=batchframe.encode_shard_rows(reads, datas),
                content_type=batchframe.CONTENT_TYPE)
        data = await self._in_executor(lambda: self.store.read_ec_shard_interval(
                vid, int(q["shard"]), int(q["offset"]), int(q["size"])))
        if data is None:
            return web.json_response({"error": "shard not found"},
                                     status=404)
        return web.Response(body=data,
                            content_type="application/octet-stream")

    async def h_query(self, req: web.Request) -> web.StreamResponse:
        """Query pushdown (server/volume_grpc_query.go:12-67): stream
        JSONL of records from the listed fids matching a JSON filter."""
        from ..query import Filter, query_json
        from ..query.json_query import OPERANDS
        body = await req.json()
        fids = body.get("fromFileIds", body.get("fids", []))
        flt = Filter.from_dict(body.get("filter"))
        if flt is not None and flt.operand not in OPERANDS:
            return web.json_response(
                {"error": f"unknown operand {flt.operand!r}"}, status=400)
        selections = body.get("selections") or []
        resp = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(req)
        import json as _json

        def read_and_query(f: t.FileId) -> list[dict]:
            n = self.store.read_needle(f.volume_id, f.key, f.cookie)
            data = n.data
            if n.is_gzipped:
                data = gzip.decompress(data)
            return query_json(data, flt, selections)

        for fid_str in fids:
            try:
                fid = self._parse_fid(fid_str)
                recs = await self._in_executor(lambda: read_and_query(fid))
            except (ValueError, NotFound, AlreadyDeleted, VolumeError,
                    CrcMismatch, gzip.BadGzipFile, OSError, BackendError):
                continue
            for rec in recs:
                await resp.write(_json.dumps(rec).encode() + b"\n")
        await resp.write_eof()
        return resp

    async def h_admin_file(self, req: web.Request) -> web.Response:
        """Stream a raw volume/shard file (CopyFile analog for ec.copy)."""
        q = req.query
        vid = int(q["volume"])
        collection = q.get("collection", "")
        ext = q["ext"]
        allowed = {".dat", ".idx", ".ecx", ".ecj"} | {
            ecpl.to_ext(i) for i in range(gf.TOTAL_SHARDS)}
        if ext not in allowed:
            return web.json_response({"error": "bad ext"}, status=400)
        base = self._base_name(vid, collection)
        path = (base + ext) if base else None
        if not path or not os.path.exists(path):
            return web.json_response({"error": "file not found"}, status=404)
        return web.FileResponse(path)
