"""Filer server: POSIX-ish HTTP namespace over the volume tier.

Reference: weed/server/filer_server_handlers_read.go:21-260 (streaming +
range reads over chunks), _write.go + _write_autochunk.go (auto-chunked
uploads, default 256MB chunks), filer_grpc_server.go (metadata API incl.
AtomicRenameEntry). The gRPC surface maps to JSON endpoints under /__api__/.

A copy of seaweedfs_tpu/server/filer_server.py in the PyTorch port, with
one change: a multipart part's read_chunk may return more bytes than it
was asked for, and _read_up_to keeps that excess for the next chunk, so
every chunk of an upload but its last is exactly the chunk size (the
reference's chunks of a multipart upload run over it by up to one read,
which makes a volume's layout depend on read timing).
"""

from __future__ import annotations

import asyncio
import time

import aiohttp
from aiohttp import web

from ..filer.entry import Attr, Entry
from ..filer.filechunks import (FileChunk, etag as chunks_etag, total_size)
from ..filer.filer import Filer, FilerError
from ..filer.stream import stream_chunk_views
from ..storage import types as t
from ..util.client import OperationError, WeedClient
from ..util.httprange import RangeError, parse_range
from ..util.singleflight import SingleFlight
from ..security import tls


class FilerServer:
    def __init__(self, filer: Filer, master_url: str,
                 ip: str = "127.0.0.1", port: int = 8888,
                 chunk_size: int = 32 * 1024 * 1024,
                 collection: str = "", replication: str = "",
                 data_center: str = "",
                 redirect_on_read: bool = False,
                 disable_dir_listing: bool = False,
                 dir_list_limit: int = 100_000,
                 cache_mem_bytes: int = 0,
                 cache_dir: str = "",
                 shard_id: int = 0, shard_of: int = 1,
                 shard_peers: dict | None = None,
                 shard_split_mbps: float = 8.0):
        # -cache.mem/-cache.dir: tiered whole-chunk read cache riding
        # the WeedClient (util/chunk_cache); 0 disables
        self.cache_mem_bytes = cache_mem_bytes
        self.cache_dir = cache_dir
        self.filer = filer
        self.master_url = master_url
        self.ip = ip
        self.port = port
        self.chunk_size = chunk_size
        self.collection = collection
        self.replication = replication
        # command/filer.go:50-54 knobs
        self.data_center = data_center
        self.redirect_on_read = redirect_on_read
        self.disable_dir_listing = disable_dir_listing
        self.dir_list_limit = dir_list_limit
        self._runner: web.AppRunner | None = None
        self._tasks: list[asyncio.Task] = []
        self.client: WeedClient | None = None
        # -shard.id/-shard.of: this process owns a prefix range of the
        # namespace per the raft-committed shard map (filer/shard.py)
        self.shard = None
        if shard_of > 1:
            from ..filer.shard import ShardNode
            self.shard = ShardNode(self, shard_id, shard_of,
                                   peers=shard_peers,
                                   split_mbps=shard_split_mbps)
        # hot-listing collapse: identical concurrent list ops on one
        # directory share a single store query, fenced by a per-dir
        # generation the write listener bumps (util/singleflight.py)
        self._list_sf = SingleFlight()
        self._dir_gens: dict[str, int] = {}
        self._fence_epoch = 0
        self.filer.listeners.append(self._on_entry_change)
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        from ..stats import metrics
        from ..util import tracing

        @web.middleware
        async def timing(request, handler):
            from .. import qos
            t0 = time.perf_counter()
            kind = "read" if request.method in ("GET", "HEAD") \
                else "write"
            reserved = request.path.startswith("/__")
            # tenant admission (qos/): classified on the
            # AWS credential / JWT identity when present, the default
            # class otherwise; shed answers cost no chunk work
            ctrl = None if reserved else qos.admission()
            dec = None
            if ctrl is not None:
                # weedlint: ignore[lock-acquire] admission decision, not a mutex: a denied Decision holds nothing, and the admitted path releases in the finally below
                dec = await ctrl.acquire(
                    "filer", kind,
                    qos.tenant_from_headers(request.headers))
                if not dec.admitted:
                    return web.json_response(
                        {"error": "request shed", "reason": dec.reason},
                        status=dec.status,
                        headers={"Retry-After": str(
                            max(1, int(dec.retry_after_s + 0.999)))})
                qos.set_current_class(dec.cls)
            # filer-tier entry span; the reserved introspection paths
            # (/__metrics__, /__debug__/...) stay out of the ring
            sp = (tracing._NOOP if reserved
                  else tracing.start_root(
                      "filer", kind, headers=request.headers,
                      **({"tenant": dec.tenant} if dec is not None
                         else {})))
            try:
                with sp:
                    try:
                        resp = await handler(request)
                    except web.HTTPException as e:
                        sp.status = str(e.status)
                        raise
                    sp.status = ("ok" if resp.status < 400
                                 else str(resp.status))
                    return resp
            finally:
                dt = time.perf_counter() - t0
                if dec is not None:
                    ctrl.release(dec)
                    ctrl.observe("filer", kind, dec, dt)
                if metrics.HAVE_PROMETHEUS:
                    metrics.FILER_REQUEST_TIME.labels(kind).observe(dt)

        app = web.Application(client_max_size=4 * 1024 * 1024 * 1024,
                              middlewares=[timing])
        api = [
            ("POST", "/__api__/rename", self.h_api_rename),
            ("GET", "/__api__/lookup", self.h_api_lookup),
            ("GET", "/__api__/list", self.h_api_list),
            ("POST", "/__api__/entry", self.h_api_create_entry),
            ("POST", "/__api__/assign", self.h_api_assign),
            ("POST", "/__api__/delete", self.h_api_delete),
            ("POST", "/__api__/shard/ingest", self.h_shard_ingest),
        ]
        for method, path, handler in api:
            app.router.add_route(method, path, handler)
        from ..util import failpoints
        app.router.add_route("*", "/__debug__/failpoints",
                             failpoints.handle_debug)
        # reserved-prefix twins of the volume server's /debug/traces//
        # debug/requests (a stored file named /debug/traces must stay
        # reachable); one shared implementation across filer/S3/WebDAV
        h_traces, h_requests = tracing.debug_handlers()
        app.router.add_get("/__debug__/traces", h_traces)
        app.router.add_get("/__debug__/requests", h_requests)
        # flight-recorder twins (stats/timeline.py): timeline, event
        # journal, SLO health — same shared trio as master/S3/WebDAV
        from ..stats.timeline import recorder_handlers
        h_tl, h_ev, h_hl = recorder_handlers()
        app.router.add_get("/__debug__/timeline", h_tl)
        app.router.add_post("/__debug__/timeline", h_tl)
        app.router.add_get("/__debug__/events", h_ev)
        app.router.add_get("/__debug__/health", h_hl)
        from .. import qos
        app.router.add_get("/__debug__/qos", qos.debug_handler)
        app.router.add_get("/__debug__/shards", self.h_debug_shards)
        from ..stats import profiler
        from ..util import pprof
        app.router.add_get("/__debug__/profile", profiler.debug_handler())
        app.router.add_get("/__debug__/pprof", pprof.debug_handler())
        # reserved-prefix path (like /__api__, /__debug__) so a stored
        # file named /metrics is never shadowed; exposes the chunk-cache
        # hit/miss/byte counters among the rest of the registry
        app.router.add_get("/__metrics__", self.h_metrics)
        app.router.add_route("GET", "/{path:.*}", self.h_get)
        app.router.add_route("HEAD", "/{path:.*}", self.h_get)
        app.router.add_route("POST", "/{path:.*}", self.h_post)
        app.router.add_route("PUT", "/{path:.*}", self.h_post)
        app.router.add_route("DELETE", "/{path:.*}", self.h_delete)
        return app

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    async def h_metrics(self, req: web.Request) -> web.Response:
        from ..stats.metrics import metrics_text
        return web.Response(body=metrics_text(),
                            content_type="text/plain")


    async def start(self) -> None:
        cc = None
        if self.cache_mem_bytes > 0:
            from ..util import tracing
            from ..util.chunk_cache import TieredChunkCache
            # ctor makedirs the disk tier — off the loop: under
            # `weed-tpu server` this loop already serves other daemons
            cc = await tracing.run_in_executor(
                lambda: TieredChunkCache(self.cache_mem_bytes,
                                         disk_dir=self.cache_dir or None))
        self.client = WeedClient(self.master_url, chunk_cache=cc)
        await self.client.__aenter__()
        # watch-fed location map: hot-path reads never lookup the master
        # (reference filer embeds wdclient the same way)
        from ..util.masterclient import MasterClient
        self.master_client = MasterClient(self.master_url, name="filer")
        await self.master_client.start()
        self.client.attach_master_client(self.master_client)
        self.filer.chunk_deleter = self._queue_chunk_deletes
        self._pending: list[str] = []
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.ip, self.port)
        await site.start()
        if self.port == 0:
            self.port = site._server.sockets[0].getsockname()[1]
        self._tasks.append(asyncio.create_task(self._chunk_gc_loop()))
        if self.shard is not None:
            await self.shard.start()

    async def stop(self) -> None:
        if self.shard is not None:
            await self.shard.stop()
        for t in self._tasks:
            t.cancel()
        mc = getattr(self, "master_client", None)
        if mc is not None:
            await mc.stop()
        if self.client:
            await self.client.__aexit__()
        if self._runner:
            await self._runner.cleanup()
        self.filer.close()

    # ---- async chunk GC (filer_deletion.go) ----

    def _queue_chunk_deletes(self, fids: list[str]) -> None:
        self._pending.extend(fids)

    async def _chunk_gc_loop(self) -> None:
        from ..util import glog
        from ..util.client import OperationError
        while True:
            await asyncio.sleep(1.0)
            batch, self._pending = self._pending[:1024], self._pending[1024:]
            if batch:
                try:
                    await self.client.delete_fids(batch)
                except (OperationError, aiohttp.ClientError,
                        asyncio.TimeoutError, OSError) as e:
                    # transient tier outage: requeue, but visibly — a
                    # permanently failing GC loop leaks chunks forever
                    glog.warning("filer chunk gc: %d fids requeued: %s",
                                 len(batch), e)
                    self._pending.extend(batch)

    # ---- normalize ----

    @staticmethod
    def _path(req: web.Request) -> str:
        p = "/" + req.match_info["path"]
        while "//" in p:
            p = p.replace("//", "/")
        return p if p == "/" else p.rstrip("/")

    # ---- shard ownership (filer/shard.py) ----

    async def _shard_gate(self, req: web.Request,
                          path: str) -> web.Response | None:
        """Ownership enforcement: a request for a path this shard does
        not own bounces with ``307 + X-Shard-Owner/-Prefix/-Epoch`` so
        the client folds the owner into its route cache (the learned-
        leader discipline). ``local=1`` marks a peer-internal hop that
        must be answered from the local store, never re-routed."""
        if self.shard is None or req.query.get("local") == "1":
            return None
        from ..util import failpoints
        # chaos site: the per-request routing decision
        await failpoints.fail("filer.shard.route")
        if self.shard.is_local(path):
            self.shard.counters["local"] += 1
            from ..stats import metrics
            if metrics.HAVE_PROMETHEUS:
                metrics.FILER_SHARD_REQUESTS.labels("local").inc()
            return None
        hdrs = self.shard.redirect_headers(path)
        if hdrs is None:
            # owner unknown (map still syncing): 503 so the client
            # retries — a routed miss must never read as a 404
            return web.json_response(
                {"error": "shard owner unknown", "path": path},
                status=503, headers={"Retry-After": "1"})
        loc = tls.url(hdrs["X-Shard-Owner"], req.path_qs)
        return web.json_response(
            {"error": "wrong shard", "owner": hdrs["X-Shard-Owner"]},
            status=307, headers=dict(hdrs, Location=loc))

    def _on_entry_change(self, old_entry, new_entry) -> None:
        """Write listener: bump the listing generation of every parent
        directory a mutation touches (the singleflight fill-token
        fence — an in-flight collapsed fill keyed on the old
        generation can no longer satisfy new readers)."""
        for e in (old_entry, new_entry):
            if e is not None:
                self.bump_gen_fence(e.dir_path)

    def bump_gen_fence(self, dir_path: str, subtree: bool = False) -> None:
        d = dir_path or "/"
        self._dir_gens[d] = self._dir_gens.get(d, 0) + 1
        if subtree or len(self._dir_gens) > 8192:
            # wholesale invalidation: subtree tombstone/migration, or
            # the per-dir table growing without bound
            self._dir_gens.clear()
            self._fence_epoch += 1

    async def _list_entries(self, path: str, start_file: str,
                            inclusive: bool, limit: int) -> list[Entry]:
        """One directory page: singleflight-collapsed, store query off
        the event loop, merged across shards owning rules below the
        directory when sharded."""
        gen = self._dir_gens.get(path, 0)
        key = (f"{path}|{start_file}|{int(inclusive)}|{limit}"
               f"|{gen}|{self._fence_epoch}")

        async def fill() -> list[Entry]:
            if self.shard is not None:
                self.shard.counters["local"] += 1
                return await self.shard.merged_list(
                    path, start_file, inclusive, limit)
            from ..util import tracing
            return await tracing.run_in_executor(
                lambda: self.filer.list_directory_entries(
                    path, start_file, inclusive, limit))

        return await self._list_sf.do(key, fill)

    async def _shard_fallback_entry(self, path: str) -> Entry | None:
        """Local miss during a split's cleanup window: double-read the
        old owner (it holds entries not yet streamed over) so the
        migration window never surfaces a 404."""
        if self.shard is None:
            return None
        src = self.shard.double_read_source(path)
        if not src:
            return None
        d = await self.shard.forward_lookup(src, path)
        if d is None:
            return None
        from ..filer.shard import _entry_from_json
        return _entry_from_json(d)

    async def h_shard_ingest(self, req: web.Request) -> web.Response:
        """Migration sink for split/move batches (idempotent,
        mtime-gated; see ShardNode.ingest)."""
        if self.shard is None:
            return web.json_response(
                {"error": "not a sharded filer"}, status=400)
        body = await req.json()
        n = await self.shard.ingest(body.get("entries", []))
        if int(body.get("epoch") or 0) > self.shard.map.epoch:
            await self.shard.adopt_epoch(int(body["epoch"]))
        # a migrated batch changes listings wholesale under the moved
        # prefix: drop every collapsed fill
        self.bump_gen_fence("/", subtree=True)
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FILER_SHARD_REQUESTS.labels("ingest").inc()
        return web.json_response({"ingested": n})

    async def h_debug_shards(self, req: web.Request) -> web.Response:
        if self.shard is not None:
            st = self.shard.status()
        else:
            count = getattr(self.filer.store, "count_entries", None)
            st = {"shard": 0, "of": 1, "url": self.url, "epoch": 0,
                  "entries": count() if count is not None else -1,
                  "rules": [["/", 0]], "owners": {},
                  "moves": [], "counters": {}}
        st["singleflight"] = {"calls": self._list_sf.calls,
                              "collapsed": self._list_sf.collapsed}
        return web.json_response(st)

    # ---- read path ----

    async def h_get(self, req: web.Request) -> web.StreamResponse:
        path = self._path(req)
        bounce = await self._shard_gate(req, path)
        if bounce is not None:
            return bounce
        entry = self.filer.find_entry(path)
        if entry is None:
            entry = await self._shard_fallback_entry(path)
        if entry is None:
            return web.json_response({"error": "not found"}, status=404)
        if entry.is_directory:
            return await self._list_dir(req, path)
        size = entry.size
        status = 200
        offset, length = 0, size
        try:
            rng = parse_range(req.headers.get("Range", ""), size)
        except RangeError:
            return web.Response(
                status=416, headers={"Content-Range": f"bytes */{size}"})
        if rng is not None:
            offset, length = rng
            status = 206
        headers = {
            "Accept-Ranges": "bytes",
            "Content-Length": str(length),
            "Etag": f'"{chunks_etag(entry.chunks)}"',
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT",
                time.gmtime(entry.attr.mtime or 0)),
        }
        if status == 206:
            headers["Content-Range"] = f"bytes {offset}-{offset+length-1}/{size}"
        ct = entry.attr.mime or "application/octet-stream"
        if req.method == "HEAD":
            return web.Response(status=status, headers=headers,
                                content_type=ct)
        if self.redirect_on_read and rng is None \
                and len(entry.chunks) == 1 \
                and entry.chunks[0].offset == 0 \
                and entry.chunks[0].size == size:
            # -redirectOnRead (filer.go:50, handleSingleChunk): bounce
            # the client straight to the volume server instead of
            # proxying. Only when the single chunk IS the whole file —
            # a sparse entry's raw blob would be the wrong bytes.
            url = None
            try:
                url = await self.client.lookup_file_id(
                    entry.chunks[0].file_id)
            except (OperationError, IndexError, aiohttp.ClientError,
                    asyncio.TimeoutError):
                pass  # fall through to the proxy path
            if url:
                raise web.HTTPFound(location=url)
        resp = web.StreamResponse(status=status, headers=headers)
        resp.content_type = ct
        await resp.prepare(req)
        # stream chunk views (filer2/stream.go StreamContent) under a
        # stream span: its SELF time is the filer's chunk fan-out +
        # assembly cost, its client children are the volume-tier hops
        from ..util import tracing
        with tracing.start("filer", "stream",
                           chunks=len(entry.chunks)) as sp:
            try:
                sent = 0
                async for data in stream_chunk_views(
                        self.client, entry.chunks, offset, length):
                    await resp.write(data)
                    sent += len(data)
                sp.nbytes = sent
            except OperationError:
                # headers already sent: abort the connection so the
                # client sees a transport error, not a silently short
                # body
                sp.status = "error"
                if req.transport is not None:
                    req.transport.close()
                return resp
        await resp.write_eof()
        return resp

    async def _list_dir(self, req: web.Request, path: str) -> web.Response:
        if self.disable_dir_listing:
            # -disableDirListing (filer.go:51)
            return web.json_response(
                {"error": "directory listing is disabled"}, status=405)
        limit = int(req.query.get("limit", 1000))
        if limit <= 0:
            # SQLite treats LIMIT -1 as unlimited — a negative client
            # value must not bypass the cap
            limit = 1000
        limit = min(limit, self.dir_list_limit)
        last = req.query.get("lastFileName", "")
        entries = await self._list_entries(path, last, False, limit)
        return web.json_response({
            "Path": path,
            "Entries": [self._entry_json(e) for e in entries],
            "ShouldDisplayLoadMore": len(entries) == limit,
        })

    @staticmethod
    def _entry_json(e: Entry) -> dict:
        return {
            "FullPath": e.full_path,
            "Mtime": e.attr.mtime, "Crtime": e.attr.crtime,
            "Mode": e.attr.mode, "Uid": e.attr.uid, "Gid": e.attr.gid,
            "Mime": e.attr.mime, "Replication": e.attr.replication,
            "Collection": e.attr.collection, "TtlSec": e.attr.ttl_sec,
            "IsDirectory": e.is_directory, "FileSize": e.size,
            "chunks": [c.to_dict() for c in e.chunks],
            "extended": e.extended,
        }

    # ---- write path (auto-chunking, _write_autochunk.go:23-188) ----

    async def h_post(self, req: web.Request) -> web.Response:
        path = self._path(req)
        if "mv.from" in req.query:
            return await self._rename(req, req.query["mv.from"], path)
        bounce = await self._shard_gate(req, path)
        if bounce is not None:
            return bounce
        raw_path = req.match_info["path"]
        if (raw_path.endswith("/") and raw_path != "") \
                or req.query.get("mkdir") == "true":
            from ..filer.entry import new_directory_entry
            self.filer.create_entry(new_directory_entry(path))
            return web.json_response({"name": path}, status=201)

        mime = ""
        reader = None
        ctype = req.headers.get("Content-Type", "")
        filename = ""
        if ctype.startswith("multipart/form-data"):
            mp = await req.multipart()
            async for part in mp:
                if part.filename or part.name in ("file", None):
                    filename = part.filename or ""
                    pct = part.headers.get("Content-Type", "")
                    if pct and pct != "application/octet-stream":
                        mime = pct
                    reader = part
                    break
            if reader is None:
                return web.json_response({"error": "no file part"},
                                         status=400)
        else:
            reader = req.content
            if ctype and ctype != "application/octet-stream":
                mime = ctype.split(";")[0]

        collection = req.query.get("collection", self.collection)
        replication = req.query.get("replication", self.replication)
        ttl = req.query.get("ttl", "")
        try:
            # validate BEFORE uploading any chunk: a bad ttl must be an
            # early 400, not a post-upload 500 with chunk rollback (or a
            # silent drop on a zero-byte file)
            ttl_sec = t.TTL.parse(ttl).minutes * 60
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        chunks: list[FileChunk] = []
        offset = 0
        carry = bytearray()
        # filer-tier write span: the chunk fan-out + entry commit,
        # with the per-chunk volume uploads as client children
        from ..util import tracing
        with tracing.start("filer", "write") as fsp:
            try:
                while True:
                    data = await _read_up_to(reader, self.chunk_size,
                                             carry)
                    if not data:
                        break
                    a = await self.client.assign(
                        collection=collection, replication=replication,
                        ttl=ttl, data_center=self.data_center)
                    up = await self.client.upload(
                        a["fid"], a["url"], data, mime=mime, ttl=ttl,
                        auth=a.get("auth", ""))
                    chunks.append(FileChunk(
                        file_id=a["fid"], offset=offset,
                        size=len(data), mtime=time.time_ns(),
                        etag=up.get("eTag", "")))
                    offset += len(data)
                    if len(data) < self.chunk_size:
                        break
            except OperationError as e:
                # roll back uploaded chunks
                self.filer.delete_chunks([c.file_id for c in chunks])
                fsp.status = "error"
                return web.json_response({"error": str(e)}, status=500)

            now = time.time()
            entry = Entry(
                full_path=path,
                attr=Attr(mtime=now, crtime=now, mode=0o660, mime=mime,
                          replication=replication,
                          collection=collection, ttl_sec=ttl_sec),
                chunks=chunks)
            try:
                self.filer.create_entry(entry)
            except FilerError as e:
                self.filer.delete_chunks([c.file_id for c in chunks])
                fsp.status = "error"
                return web.json_response({"error": str(e)}, status=400)
            fsp.set("chunks", len(chunks))
            fsp.nbytes = offset
        return web.json_response(
            {"name": filename or entry.name, "size": offset}, status=201)

    async def _rename(self, req: web.Request, src: str,
                      dst: str) -> web.Response:
        """Rename, shard-aware: the SOURCE shard drives. Same-shard
        renames stay the plain atomic store move; a cross-shard rename
        runs as a raft-journaled two-phase move (intent committed,
        copy-then-tombstone, idempotent replay on crash)."""
        if self.shard is not None and req.query.get("local") != "1":
            from ..util import failpoints
            # chaos site: the rename routing decision
            await failpoints.fail("filer.shard.route")
            if not self.shard.is_local(src):
                hdrs = self.shard.redirect_headers(src)
                if hdrs is None:
                    return web.json_response(
                        {"error": "shard owner unknown", "path": src},
                        status=503, headers={"Retry-After": "1"})
                loc = tls.url(hdrs["X-Shard-Owner"], req.path_qs)
                return web.json_response(
                    {"error": "wrong shard",
                     "owner": hdrs["X-Shard-Owner"]},
                    status=307, headers=dict(hdrs, Location=loc))
            if not self.shard.is_local(dst):
                try:
                    await self.shard.cross_shard_rename(src, dst)
                except (OSError, ValueError) as e:
                    return web.json_response({"error": str(e)},
                                             status=409)
                return web.json_response({"ok": True, "moved": True})
        try:
            self.filer.rename_entry(src, dst)
        except FilerError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"ok": True})

    async def h_delete(self, req: web.Request) -> web.Response:
        path = self._path(req)
        bounce = await self._shard_gate(req, path)
        if bounce is not None:
            return bounce
        recursive = req.query.get("recursive") == "true"
        try:
            self.filer.delete_entry(path, recursive=recursive,
                                    ignore_recursive_error=req.query.get(
                                        "ignoreRecursiveError") == "true")
        except FilerError as e:
            code = 404 if "not found" in str(e) else 400
            return web.json_response({"error": str(e)}, status=code)
        return web.Response(status=204)

    # ---- metadata API (filer.proto analog) ----

    async def h_api_lookup(self, req: web.Request) -> web.Response:
        path = req.query["path"]
        bounce = await self._shard_gate(req, path)
        if bounce is not None:
            return bounce
        entry = self.filer.find_entry(path)
        if entry is None:
            entry = await self._shard_fallback_entry(path)
        if entry is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(self._entry_json(entry))

    async def h_api_list(self, req: web.Request) -> web.Response:
        path = req.query["path"]
        bounce = await self._shard_gate(req, path)
        if bounce is not None:
            return bounce
        limit = int(req.query.get("limit", 1024))
        if limit <= 0:
            # same clamp as _list_dir: SQLite reads LIMIT -1 as
            # unlimited, so a negative value must not bypass the cap
            limit = 1000
        limit = min(limit, self.dir_list_limit)
        if req.query.get("local") == "1":
            # peer-internal hop of a merged listing: local page only
            entries = self.filer.list_directory_entries(
                path, req.query.get("startFile", ""),
                req.query.get("inclusive") == "true", limit)
        else:
            entries = await self._list_entries(
                path, req.query.get("startFile", ""),
                req.query.get("inclusive") == "true", limit)
        return web.json_response(
            {"entries": [self._entry_json(e) for e in entries]})

    async def h_api_create_entry(self, req: web.Request) -> web.Response:
        body = await req.json()
        bounce = await self._shard_gate(req, body.get("FullPath", "/"))
        if bounce is not None:
            return bounce
        e = Entry(
            full_path=body["FullPath"],
            attr=Attr(mtime=body.get("Mtime", time.time()),
                      crtime=body.get("Crtime", time.time()),
                      mode=body.get("Mode", 0o660),
                      uid=body.get("Uid", 0), gid=body.get("Gid", 0),
                      mime=body.get("Mime", ""),
                      replication=body.get("Replication", ""),
                      collection=body.get("Collection", ""),
                      ttl_sec=body.get("TtlSec", 0)),
            chunks=[FileChunk.from_dict(c) for c in body.get("chunks", [])],
            extended=body.get("extended", {}))
        try:
            self.filer.create_entry(e)
        except FilerError as err:
            return web.json_response({"error": str(err)}, status=400)
        return web.json_response({"ok": True})

    async def h_api_rename(self, req: web.Request) -> web.Response:
        return await self._rename(req, req.query["from"],
                                  req.query["to"])

    async def h_api_assign(self, req: web.Request) -> web.Response:
        try:
            a = await self.client.assign(
                collection=req.query.get("collection", self.collection),
                replication=req.query.get("replication", self.replication),
                ttl=req.query.get("ttl", ""),
                data_center=self.data_center)
        except OperationError as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response(a)

    async def h_api_delete(self, req: web.Request) -> web.Response:
        fids = (await req.json()).get("fids", [])
        self.filer.delete_chunks(fids)
        return web.json_response({"ok": True})


async def _read_up_to(reader, n: int, carry: bytearray) -> bytes:
    """Read exactly n bytes unless EOF; handles both aiohttp StreamReader
    (short reads possible) and multipart BodyPartReader, whose read_chunk
    may return more than asked: the bytes past n wait in `carry`, which
    the next call reads first."""
    out = bytearray(carry[:n])
    del carry[:n]
    while len(out) < n:
        if hasattr(reader, "read_chunk"):
            chunk = await reader.read_chunk(min(64 * 1024, n - len(out)))
        else:
            chunk = await reader.read(n - len(out))
        if not chunk:
            break
        out.extend(chunk)
    carry[:0] = out[n:]
    del out[n:]
    return bytes(out)
