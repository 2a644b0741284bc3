"""WebDAV gateway over the filer metadata tier.

Reference: weed/server/webdav_server.go (`WebDavFileSystem` implementing
golang.org/x/net/webdav on filer gRPC: webdav_server.go:64-366, chunked
WebDavFile.Write/Read :368-500) + weed/command/webdav.go. Here the DAV
protocol surface (OPTIONS/PROPFIND/MKCOL/GET/PUT/DELETE/MOVE/COPY and
class-2 advisory LOCK) is implemented directly on aiohttp; file bodies
are chunked into volume-server blobs exactly like the filer's own
auto-chunking write path.

A copy of seaweedfs_tpu/server/webdav_server.py in the PyTorch port, with
one change: a PUT gathers each chunk to -chunkSizeMB before it uploads it.
The reference uploads whatever one StreamReader.read returns, so its
chunks are as large as the reads that arrived (tens of KiB at a time) and
a file's layout depends on read timing.
"""

from __future__ import annotations

import asyncio
import time
import uuid
import xml.etree.ElementTree as ET
from urllib.parse import quote, unquote, urlparse

from aiohttp import web

from ..filer.entry import Attr, Entry, new_directory_entry
from ..filer.filechunks import FileChunk, view_from_chunks
from ..filer.stream import stream_chunk_views
from ..filer.filer import Filer, FilerError
from ..util.client import OperationError, WeedClient
from ..util.httprange import RangeError, parse_range
from ..security import tls

DAV_NS = "DAV:"
ET.register_namespace("D", DAV_NS)


def _rfc1123(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts or 0))


def _rfc3339(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts or 0))


class WebDavServer:
    def __init__(self, filer: Filer, master_url: str,
                 ip: str = "127.0.0.1", port: int = 7333,
                 collection: str = "", replication: str = "",
                 chunk_size: int = 16 * 1024 * 1024,
                 jwt_key: str = "",
                 cache_mem_bytes: int = 0,
                 cache_dir: str = "",
                 shard_router=None):
        # sharded gateway fleet (filer/shard.py GatewayRouter): the
        # WebDAV namespace IS the filer namespace, so foreign paths
        # bounce straight to the owning sibling
        self.shard_router = shard_router
        self._shard_http = None
        self.filer = filer
        self.master_url = master_url
        self.ip = ip
        self.port = port
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        cc = None
        if cache_mem_bytes > 0:
            # -cache.mem/-cache.dir chunk read cache (see FilerServer)
            from ..util.chunk_cache import TieredChunkCache
            cc = TieredChunkCache(cache_mem_bytes,
                                  disk_dir=cache_dir or None)
        self.client = WeedClient(master_url, jwt_key=jwt_key,
                                 chunk_cache=cc)
        self._locks: dict[str, str] = {}  # path -> token (advisory)
        self._runner: web.AppRunner | None = None
        self._tasks: list[asyncio.Task] = []
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        app = web.Application(client_max_size=1024 * 1024 * 1024)
        # POST is not a WebDAV verb, but the flight-recorder twin
        # POST /__debug__/timeline?snap=1 needs it; dispatch confines
        # POST to that one path (anything else 405s, as before)
        for method in ("OPTIONS", "PROPFIND", "PROPPATCH", "MKCOL", "GET",
                       "HEAD", "PUT", "DELETE", "MOVE", "COPY", "LOCK",
                       "UNLOCK", "POST"):
            app.router.add_route(method, "/{path:.*}", self.dispatch)
        return app

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    async def start(self) -> None:
        await self.client.__aenter__()
        if self.shard_router is not None:
            import aiohttp
            self._shard_http = tls.make_session(
                timeout=aiohttp.ClientTimeout(total=10))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.ip, self.port)
        await site.start()
        if self.port == 0:
            self.port = site._server.sockets[0].getsockname()[1]
        self._tasks.append(asyncio.create_task(self._chunk_gc_loop()))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._shard_http is not None:
            await self._shard_http.close()
        await self.client.__aexit__(None, None, None)
        if self._runner:
            await self._runner.cleanup()

    async def _chunk_gc_loop(self) -> None:
        """Delete orphaned chunks of overwritten/deleted files
        (filer_deletion.go:11-52 analog)."""
        while True:
            await asyncio.sleep(1.0)
            fids = self.filer.drain_pending_chunk_deletes()
            if fids:
                try:
                    await self.client.delete_fids(fids)
                except Exception:
                    # requeue so a transient volume-server outage doesn't
                    # leak the chunks forever (filer_server.py loop)
                    self.filer.delete_chunks(fids)

    # ---- dispatch ----

    async def dispatch(self, req: web.Request) -> web.StreamResponse:
        from ..util import tracing
        path = "/" + unquote(req.match_info["path"])
        while "//" in path:
            path = path.replace("//", "/")
        if path != "/":
            path = path.rstrip("/")
        if req.method == "GET" and path in ("/__debug__/traces",
                                            "/__debug__/requests"):
            # same shared handlers the filer/S3 surfaces register
            h_traces, h_requests = tracing.debug_handlers()
            return await (h_traces if path.endswith("traces")
                          else h_requests)(req)
        if req.method == "GET" and path in ("/__debug__/profile",
                                            "/__debug__/pprof"):
            from ..stats import profiler
            from ..util import pprof
            return await (profiler.debug_handler()
                          if path.endswith("profile")
                          else pprof.debug_handler())(req)
        if (req.method == "GET" and path in (
                "/__debug__/timeline", "/__debug__/events",
                "/__debug__/health", "/__debug__/qos")) or (
                req.method == "POST" and path == "/__debug__/timeline"):
            # flight-recorder twins: shared trio, no drift vs filer/S3
            # (POST only on timeline — ?snap=1 — exactly like the
            # add_get/add_post registrations on every other daemon)
            from .. import qos
            from ..stats.timeline import recorder_handlers
            h_tl, h_ev, h_hl = recorder_handlers()
            return await {"/__debug__/timeline": h_tl,
                          "/__debug__/events": h_ev,
                          "/__debug__/health": h_hl,
                          "/__debug__/qos": qos.debug_handler}[path](req)
        if self.shard_router is not None \
                and not path.startswith("/__debug__"):
            owner = await self.shard_router.foreign_owner(
                self._shard_http, path)
            if owner:
                self.shard_router.redirects += 1
                return web.Response(
                    status=307,
                    headers={"Location": tls.url(owner, req.path_qs),
                             "X-Shard-Owner": owner,
                             "X-Shard-Prefix":
                                 self.shard_router.matched_prefix(path),
                             "X-Shard-Epoch": str(
                                 self.shard_router.routes.map.epoch)})
        handler = getattr(self, f"h_{req.method.lower()}", None)
        if handler is None:
            return web.Response(status=405)
        from .. import qos
        op = req.method.lower()
        # tenant admission (qos/): JWT / AWS-credential
        # identity when present, else the default class
        ctrl = qos.admission()
        dec = None
        if ctrl is not None:
            # weedlint: ignore[lock-acquire] admission decision, not a mutex: a denied Decision holds nothing, and the admitted path releases in the finally below
            dec = await ctrl.acquire(
                "webdav", op, qos.tenant_from_headers(req.headers))
            if not dec.admitted:
                return web.Response(
                    status=dec.status, text="request shed\n",
                    headers={"Retry-After": str(
                        max(1, int(dec.retry_after_s + 0.999)))})
            qos.set_current_class(dec.cls)
        t0 = time.perf_counter()
        try:
            # webdav-tier entry span: child client/volume/store spans
            # hang off it exactly as on the filer/S3 read paths
            with tracing.start_root(
                    "webdav", op, headers=req.headers,
                    **({"tenant": dec.tenant}
                       if dec is not None else {})) as sp:
                resp = await handler(req, path)
                sp.status = "ok" if resp.status < 400 \
                    else str(resp.status)
                return resp
        finally:
            if dec is not None:
                ctrl.release(dec)
                ctrl.observe("webdav", op, dec,
                             time.perf_counter() - t0)

    # ---- methods ----

    async def h_options(self, req: web.Request, path: str) -> web.Response:
        return web.Response(headers={
            "Allow": "OPTIONS, PROPFIND, PROPPATCH, MKCOL, GET, HEAD, PUT, "
                     "DELETE, MOVE, COPY, LOCK, UNLOCK",
            "DAV": "1, 2",
            "MS-Author-Via": "DAV",
        })

    def _prop_response(self, href: str, e: Entry) -> ET.Element:
        r = ET.Element(f"{{{DAV_NS}}}response")
        # percent-encode: names with '#', '%', spaces must form valid URIs
        ET.SubElement(r, f"{{{DAV_NS}}}href").text = quote(href)
        ps = ET.SubElement(r, f"{{{DAV_NS}}}propstat")
        prop = ET.SubElement(ps, f"{{{DAV_NS}}}prop")
        ET.SubElement(prop, f"{{{DAV_NS}}}displayname").text = \
            e.name if e.full_path != "/" else "/"
        ET.SubElement(prop, f"{{{DAV_NS}}}creationdate").text = \
            _rfc3339(e.attr.crtime)
        ET.SubElement(prop, f"{{{DAV_NS}}}getlastmodified").text = \
            _rfc1123(e.attr.mtime)
        rt = ET.SubElement(prop, f"{{{DAV_NS}}}resourcetype")
        if e.is_directory:
            ET.SubElement(rt, f"{{{DAV_NS}}}collection")
        else:
            ET.SubElement(prop, f"{{{DAV_NS}}}getcontentlength").text = \
                str(e.size)
            ET.SubElement(prop, f"{{{DAV_NS}}}getcontenttype").text = \
                e.attr.mime or "application/octet-stream"
        ET.SubElement(ps, f"{{{DAV_NS}}}status").text = "HTTP/1.1 200 OK"
        return r

    async def h_propfind(self, req: web.Request, path: str) -> web.Response:
        entry = self.filer.find_entry(path)
        if entry is None:
            return web.Response(status=404)
        depth = req.headers.get("Depth", "1")
        ms = ET.Element(f"{{{DAV_NS}}}multistatus")
        href = path + ("/" if entry.is_directory and path != "/" else "")
        ms.append(self._prop_response(href, entry))
        if entry.is_directory and depth != "0":
            for child in self.filer.list_directory_entries(
                    path, "", False, 10000):
                chref = child.full_path + \
                    ("/" if child.is_directory else "")
                ms.append(self._prop_response(chref, child))
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(ms)
        return web.Response(body=body, status=207,
                            content_type="application/xml")

    async def h_proppatch(self, req: web.Request, path: str) -> web.Response:
        if self.filer.find_entry(path) is None:
            return web.Response(status=404)
        # properties are not persisted (matches the reference's minimal
        # webdav.FileSystem which has no property store either)
        ms = ET.Element(f"{{{DAV_NS}}}multistatus")
        r = ET.SubElement(ms, f"{{{DAV_NS}}}response")
        ET.SubElement(r, f"{{{DAV_NS}}}href").text = path
        ps = ET.SubElement(r, f"{{{DAV_NS}}}propstat")
        ET.SubElement(ps, f"{{{DAV_NS}}}status").text = \
            "HTTP/1.1 403 Forbidden"
        return web.Response(
            body=b'<?xml version="1.0" encoding="utf-8"?>' +
            ET.tostring(ms),
            status=207, content_type="application/xml")

    async def h_mkcol(self, req: web.Request, path: str) -> web.Response:
        if self.filer.find_entry(path) is not None:
            return web.Response(status=405)  # already exists
        if self.filer.find_entry(self._parent(path)) is None:
            return web.Response(status=409)  # missing intermediate
        self.filer.create_entry(new_directory_entry(path))
        return web.Response(status=201)

    async def h_get(self, req: web.Request, path: str) -> web.StreamResponse:
        entry = self.filer.find_entry(path)
        if entry is None:
            return web.Response(status=404)
        if entry.is_directory:
            names = [e.name + ("/" if e.is_directory else "")
                     for e in self.filer.list_directory_entries(
                         path, "", False, 10000)]
            return web.Response(text="\n".join(names),
                                content_type="text/plain")
        size = entry.size
        status, offset, length = 200, 0, size
        try:
            rng = parse_range(req.headers.get("Range", ""), size)
        except RangeError:
            return web.Response(status=416)
        if rng is not None:
            offset, length = rng
            status = 206
        headers = {"Content-Length": str(length),
                   "Accept-Ranges": "bytes",
                   "Last-Modified": _rfc1123(entry.attr.mtime)}
        if status == 206:
            headers["Content-Range"] = \
                f"bytes {offset}-{offset+length-1}/{size}"
        ct = entry.attr.mime or "application/octet-stream"
        if req.method == "HEAD":
            return web.Response(status=status, headers=headers,
                                content_type=ct)
        resp = web.StreamResponse(status=status, headers=headers)
        resp.content_type = ct
        await resp.prepare(req)
        try:
            async for data in stream_chunk_views(self.client, entry.chunks,
                                                 offset, length):
                await resp.write(data)
        except OperationError:
            if req.transport is not None:
                req.transport.close()
            return resp
        await resp.write_eof()
        return resp

    h_head = h_get

    async def h_put(self, req: web.Request, path: str) -> web.Response:
        if self.filer.find_entry(self._parent(path)) is None:
            return web.Response(status=409)
        existing = self.filer.find_entry(path)
        if existing is not None and existing.is_directory:
            return web.Response(status=405)
        # chunk the body as it streams in (WebDavFile.Write :444-480)
        chunks: list[FileChunk] = []
        offset = 0
        reader = req.content
        while True:
            # a StreamReader's read(n) returns what has arrived, up to n:
            # gather a whole chunk, so every chunk but the last is
            # chunk_size whatever the read timing
            data = bytearray()
            while len(data) < self.chunk_size:
                part = await reader.read(self.chunk_size - len(data))
                if not part:
                    break
                data += part
            if not data:
                break
            data = bytes(data)
            fid = await self.client.upload_data(
                data, collection=self.collection,
                replication=self.replication)
            chunks.append(FileChunk(file_id=fid, offset=offset,
                                    size=len(data),
                                    mtime=time.time_ns()))
            offset += len(data)
        now = time.time()
        entry = Entry(full_path=path,
                      attr=Attr(mtime=now, crtime=now, mode=0o660,
                                mime=req.headers.get("Content-Type", ""),
                                collection=self.collection,
                                replication=self.replication),
                      chunks=chunks)
        if existing is not None:
            self.filer.update_entry(existing, entry)
            self.filer.delete_chunks(
                [c.file_id for c in existing.chunks])
        else:
            self.filer.create_entry(entry)
        return web.Response(status=201 if existing is None else 204)

    async def h_delete(self, req: web.Request, path: str) -> web.Response:
        entry = self.filer.find_entry(path)
        if entry is None:
            return web.Response(status=404)
        try:
            self.filer.delete_entry(path, recursive=True)
        except FilerError as e:
            return web.Response(status=409, text=str(e))
        self._locks.pop(path, None)
        return web.Response(status=204)

    def _dest_path(self, req: web.Request) -> str | None:
        dest = req.headers.get("Destination", "")
        if not dest:
            return None
        p = unquote(urlparse(dest).path)
        if p != "/":
            p = p.rstrip("/")
        return p or None

    async def h_move(self, req: web.Request, path: str) -> web.Response:
        dest = self._dest_path(req)
        if dest is None:
            return web.Response(status=400)
        if self.filer.find_entry(path) is None:
            return web.Response(status=404)
        overwrite = req.headers.get("Overwrite", "T").upper() != "F"
        existing = self.filer.find_entry(dest)
        if existing is not None:
            if not overwrite:
                return web.Response(status=412)
            self.filer.delete_entry(dest, recursive=True)
        try:
            self.filer.rename_entry(path, dest)
        except FilerError as e:
            return web.Response(status=409, text=str(e))
        return web.Response(status=204 if existing else 201)

    async def h_copy(self, req: web.Request, path: str) -> web.Response:
        dest = self._dest_path(req)
        if dest is None:
            return web.Response(status=400)
        src = self.filer.find_entry(path)
        if src is None:
            return web.Response(status=404)
        overwrite = req.headers.get("Overwrite", "T").upper() != "F"
        existing = self.filer.find_entry(dest)
        if existing is not None:
            if not overwrite:
                return web.Response(status=412)
            self.filer.delete_entry(dest, recursive=True)
        await self._copy_recursive(src, dest)
        return web.Response(status=204 if existing else 201)

    async def _copy_recursive(self, src: Entry, dest: str) -> None:
        if src.is_directory:
            self.filer.create_entry(new_directory_entry(dest))
            for child in self.filer.list_directory_entries(
                    src.full_path, "", False, 10000):
                await self._copy_recursive(
                    child, dest + "/" + child.name)
            return
        # re-upload data so source and copy have independent chunks;
        # place each copied view at its logical offset so sparse holes
        # survive the copy
        chunks: list[FileChunk] = []
        for view in view_from_chunks(src.chunks, 0, src.size):
            data = await self.client.read(view.file_id, view.offset,
                                          view.size)
            fid = await self.client.upload_data(
                data, collection=self.collection,
                replication=self.replication)
            chunks.append(FileChunk(file_id=fid, offset=view.logic_offset,
                                    size=len(data),
                                    mtime=time.time_ns()))
        now = time.time()
        self.filer.create_entry(Entry(
            full_path=dest,
            attr=Attr(mtime=now, crtime=now, mode=src.attr.mode,
                      mime=src.attr.mime, collection=self.collection,
                      replication=self.replication),
            chunks=chunks))

    async def h_lock(self, req: web.Request, path: str) -> web.Response:
        """Advisory class-2 locks (enough for macOS/Windows clients that
        refuse to write without LOCK support)."""
        token = self._locks.get(path) or f"opaquelocktoken:{uuid.uuid4()}"
        self._locks[path] = token
        prop = ET.Element(f"{{{DAV_NS}}}prop")
        ld = ET.SubElement(prop, f"{{{DAV_NS}}}lockdiscovery")
        al = ET.SubElement(ld, f"{{{DAV_NS}}}activelock")
        lt = ET.SubElement(al, f"{{{DAV_NS}}}locktoken")
        ET.SubElement(lt, f"{{{DAV_NS}}}href").text = token
        ET.SubElement(al, f"{{{DAV_NS}}}timeout").text = "Second-3600"
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(prop)
        return web.Response(body=body, status=200,
                            content_type="application/xml",
                            headers={"Lock-Token": f"<{token}>"})

    async def h_unlock(self, req: web.Request, path: str) -> web.Response:
        self._locks.pop(path, None)
        return web.Response(status=204)

    @staticmethod
    def _parent(path: str) -> str:
        p = path.rsplit("/", 1)[0]
        return p or "/"
