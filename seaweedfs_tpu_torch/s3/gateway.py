"""S3 REST gateway over the filer.

Reference: weed/s3api/ — router (s3api_server.go:31-107), bucket handlers
(bucket == collection, stored under /buckets/<name>), object passthrough,
multipart uploads assembled from part files (filer_multipart.go:25-121),
ListObjects w/ prefix/marker/delimiter, bulk delete. XML shapes follow
AmazonS3.xsd (s3api_xsd_generated.go).

The gateway holds the Filer in-proc (like `weed server -s3`) and streams
chunk data through the volume tier with WeedClient.

A copy of seaweedfs_tpu/s3/gateway.py in the PyTorch port, with one
change: a standalone gateway's chunk GC loop takes its batch out of the
pending list in place. The reference rebinds the list each second while
filer.chunk_deleter keeps the first list's extend, so every chunk freed
after the gateway's first second (an overwrite, a delete, a refused
upload) is never deleted. The bucket Owner ID it answers stays the
literal "seaweedfs_tpu", a wire value, so the XML bodies equal the
reference gateway's.
"""

from __future__ import annotations

import asyncio
import hashlib
import math
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

import aiohttp
from aiohttp import web

from ..filer.entry import Attr, Entry, new_directory_entry
from .auth import (AuthError, AwsChunkedDecoder, SigV4Verifier,
                   is_aws_chunked)
from ..filer.filechunks import FileChunk, etag as chunks_etag, view_from_chunks
from ..filer.stream import stream_chunk_views
from ..filer.filer import Filer, FilerError
from ..util.client import OperationError, WeedClient
from ..util.httprange import RangeError, parse_range
from ..security import tls

BUCKETS_DIR = "/buckets"
UPLOADS_DIR = "/buckets/.uploads"
_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _xml(root: ET.Element) -> web.Response:
    body = b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)
    return web.Response(body=body, content_type="application/xml")


def _err(code: str, message: str, status: int) -> web.Response:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = message
    return web.Response(
        body=b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root),
        content_type="application/xml", status=status)


def _shed_response(dec) -> web.Response:
    """AWS-shaped throttle answer: the `SlowDown` error XML aws-sdk
    clients back off on natively, with `Retry-After` derived from the
    tenant's own bucket refill (integer delta-seconds, rounded up so
    a sub-second refill never reads as 'retry immediately')."""
    resp = _err("SlowDown", "Please reduce your request rate.",
                dec.status)
    resp.headers["Retry-After"] = \
        str(max(1, math.ceil(dec.retry_after_s)))
    return resp


def _ts(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(t))


def _auth_status(e: AuthError) -> int:
    return (403 if e.code in ("AccessDenied", "SignatureDoesNotMatch",
                              "InvalidAccessKeyId")
            else 400)


class S3Gateway:
    def __init__(self, filer: Filer, master_url: str,
                 ip: str = "127.0.0.1", port: int = 8333,
                 chunk_size: int = 8 * 1024 * 1024,
                 identities: dict[str, str] | None = None,
                 domain_name: str = "",
                 cache_mem_bytes: int = 0,
                 cache_dir: str = "",
                 admission=None,
                 shard_router=None):
        # -cache.mem/-cache.dir chunk read cache (see FilerServer)
        self.cache_mem_bytes = cache_mem_bytes
        self.cache_dir = cache_dir
        # sharded gateway fleet (filer/shard.py GatewayRouter): one
        # gateway per filer shard; foreign-bucket requests bounce to
        # the sibling with 307 + X-Shard-Owner
        self.shard_router = shard_router
        self._shard_http: aiohttp.ClientSession | None = None
        # -domainName (s3api_server.go:35-37): virtual-host-style
        # addressing, Host: <bucket>.<domainName>
        self.domain_name = domain_name
        self.filer = filer
        self.master_url = master_url
        self.ip = ip
        self.port = port
        self.chunk_size = chunk_size
        # {access_key: secret_key}; empty == anonymous mode
        # (s3api_auth.go authTypeAnonymous when no identities configured)
        self.identities = dict(identities or {})
        self._verifier = SigV4Verifier(self.identities)
        # explicit AdmissionController for tests; daemons leave None
        # and the middleware consults the process singleton live
        self.admission = admission
        self.client: WeedClient | None = None
        self._runner: web.AppRunner | None = None
        self.app = self._build_app()

    def _admission(self):
        from .. import qos
        return self.admission if self.admission is not None \
            else qos.admission()

    def _build_app(self) -> web.Application:
        from ..util import tracing
        app = web.Application(client_max_size=5 * 1024 * 1024 * 1024,
                              middlewares=[self._auth_middleware])
        # reserved introspection paths FIRST (route order wins): the
        # trace ring of this gateway process, mirroring the volume
        # server's /debug/traces (documented caveat: shadows a bucket
        # literally named __debug__); shared handlers, no drift
        h_traces, h_requests = tracing.debug_handlers()
        app.router.add_get("/__debug__/traces", h_traces)
        app.router.add_get("/__debug__/requests", h_requests)
        # flight-recorder twins: same shared trio as master/filer/WebDAV
        from ..stats.timeline import recorder_handlers
        h_tl, h_ev, h_hl = recorder_handlers()
        app.router.add_get("/__debug__/timeline", h_tl)
        app.router.add_post("/__debug__/timeline", h_tl)
        app.router.add_get("/__debug__/events", h_ev)
        app.router.add_get("/__debug__/health", h_hl)
        from .. import qos
        app.router.add_get("/__debug__/qos", qos.debug_handler)
        from ..stats import profiler
        from ..util import pprof
        app.router.add_get("/__debug__/profile", profiler.debug_handler())
        app.router.add_get("/__debug__/pprof", pprof.debug_handler())
        # the qos soak arms/disarms `qos.admit` here at runtime, the
        # same shared admin surface the volume/master/filer expose
        from ..util import failpoints
        app.router.add_route("*", "/__debug__/failpoints",
                             failpoints.handle_debug)
        # "*": with -domainName, PUT/DELETE bucket.domain/ are bucket
        # operations that land on the root path
        app.router.add_route("*", "/", self.h_list_buckets)
        app.router.add_route("*", "/{bucket}", self.h_bucket)
        app.router.add_route("*", "/{bucket}/{key:.+}", self.h_object)
        return app

    @web.middleware
    async def _auth_middleware(self, req: web.Request, handler):
        from .. import qos
        from ..util import tracing
        # the reserved introspection paths are NOT S3 objects and are
        # served unsigned, exactly like every other tier's /debug
        # surface (the bucket-shadowing caveat above already applies)
        debug = req.path.startswith("/__debug__")
        if self.shard_router is not None and not debug \
                and req.path != "/":
            owner = await self.shard_router.foreign_owner(
                self._shard_http, BUCKETS_DIR + req.path)
            if owner:
                self.shard_router.redirects += 1
                return web.Response(
                    status=307,
                    headers={"Location": tls.url(owner, req.path_qs),
                             "X-Shard-Owner": owner,
                             "X-Shard-Prefix":
                                 self.shard_router.matched_prefix(
                                     BUCKETS_DIR + req.path),
                             "X-Shard-Epoch": str(
                                 self.shard_router.routes.map.epoch)})
        if self.identities and not debug:
            try:
                # raw_path: SigV4 signs the encoded form verbatim, and a
                # decode-requote round trip corrupts keys like a%2Fb;
                # items list: dict() would collapse duplicate query keys
                req["s3auth"] = self._verifier.verify(
                    req.method, req.rel_url.raw_path,
                    list(req.query.items()), req.headers, None)
            except AuthError as e:
                return _err(e.code, str(e), _auth_status(e))
        op = req.method.lower()
        # tenant admission AFTER auth (the identity is the verified
        # access key — an unsigned scan can't impersonate a class) and
        # BEFORE the handler: a shed request costs no filer/volume work
        ctrl = None if debug else self._admission()
        dec = None
        if ctrl is not None:
            ctx = req.get("s3auth")
            # weedlint: ignore[lock-acquire] admission decision, not a mutex: a denied Decision holds nothing, and the admitted path releases in the finally below
            dec = await ctrl.acquire(
                "s3", op, getattr(ctx, "access_key", "") if ctx else "")
            if not dec.admitted:
                return _shed_response(dec)
            qos.set_current_class(dec.cls)
        sp = (tracing._NOOP if debug
              else tracing.start_root(
                  "s3", op, headers=req.headers,
                  **({"tenant": dec.tenant} if dec is not None else {})))
        t0 = time.perf_counter()
        try:
            with sp:
                try:
                    resp = await handler(req)
                except AuthError as e:
                    # mid-stream chunk-signature / truncation failures
                    sp.status = "auth"
                    return _err(e.code, str(e), _auth_status(e))
                except web.HTTPException as e:
                    sp.status = str(e.status)
                    raise
                sp.status = "ok" if resp.status < 400 \
                    else str(resp.status)
                return resp
        finally:
            if dec is not None:
                ctrl.release(dec)
                ctrl.observe("s3", op, dec,
                             time.perf_counter() - t0)

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

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
        if self.shard_router is not None:
            self._shard_http = tls.make_session(
                timeout=aiohttp.ClientTimeout(total=10))
        # when standalone (no colocated FilerServer draining chunk GC),
        # run our own drain loop so deletes/overwrites reclaim blobs
        self._gc_task: asyncio.Task | None = None
        if self.filer.chunk_deleter is None:
            self._pending: list[str] = []
            self.filer.chunk_deleter = self._pending.extend
            self._gc_task = asyncio.create_task(self._chunk_gc_loop())
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.ip, self.port)
        await site.start()
        if self.port == 0:
            self.port = site._server.sockets[0].getsockname()[1]

    async def _chunk_gc_loop(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            # in place: filer.chunk_deleter is this list's extend
            batch = self._pending[:1024]
            del self._pending[:1024]
            if batch:
                try:
                    await self.client.delete_fids(batch)
                except Exception:
                    self._pending.extend(batch)

    async def stop(self) -> None:
        if self._gc_task:
            self._gc_task.cancel()
        if self._shard_http is not None:
            await self._shard_http.close()
        if self.client:
            await self.client.__aexit__()
        if self._runner:
            await self._runner.cleanup()

    # ------------------------------------------------------------------
    # buckets
    # ------------------------------------------------------------------

    def _host_bucket(self, req: web.Request) -> "str | None":
        """Bucket named by a virtual-host-style Host header
        (s3api_server.go:35-37), else None for path-style."""
        if not self.domain_name:
            return None
        host = req.headers.get("Host", "").split(":")[0]
        suffix = "." + self.domain_name
        if host.endswith(suffix):
            bucket = host[: -len(suffix)]
            # an empty label ('Host: .domain') would alias the whole
            # /buckets root — a single malformed header must never turn
            # DELETE / into delete-every-bucket
            if bucket and "/" not in bucket:
                return bucket
        return None

    async def h_list_buckets(self, req: web.Request) -> web.Response:
        hb = self._host_bucket(req)
        if hb is not None:
            # bucket.domain/ is a bucket operation, not ListBuckets
            return await self._bucket_ops(req, hb)
        if req.method != "GET":
            return _err("MethodNotAllowed", req.method, 405)
        return await self._list_buckets(req)

    async def _list_buckets(self, req: web.Request) -> web.Response:
        root = ET.Element("ListAllMyBucketsResult", xmlns=_NS)
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "seaweedfs_tpu"
        buckets = ET.SubElement(root, "Buckets")
        for e in self.filer.list_directory_entries(BUCKETS_DIR, limit=10000):
            if not e.is_directory or e.name.startswith("."):
                continue
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = e.name
            ET.SubElement(b, "CreationDate").text = _ts(e.attr.crtime)
        return _xml(root)

    async def h_bucket(self, req: web.Request) -> web.Response:
        hb = self._host_bucket(req)
        if hb is not None:
            # host-style: the single path segment is an object key
            return await self._object_ops(
                req, hb, urllib.parse.unquote(req.match_info["bucket"]))
        return await self._bucket_ops(req, req.match_info["bucket"])

    async def _bucket_ops(self, req: web.Request,
                          bucket: str) -> web.Response:
        path = f"{BUCKETS_DIR}/{bucket}"
        if req.method == "PUT":
            self.filer.create_entry(new_directory_entry(path))
            return web.Response(status=200)
        if req.method == "HEAD":
            e = self.filer.find_entry(path)
            if e is None:
                return web.Response(status=404)
            return web.Response(status=200)
        if req.method == "DELETE":
            try:
                self.filer.delete_entry(path, recursive=True,
                                        ignore_recursive_error=True)
            except FilerError:
                return _err("NoSuchBucket", bucket, 404)
            return web.Response(status=204)
        if req.method == "POST" and "delete" in req.query:
            return await self._bulk_delete(req, bucket)
        if req.method == "GET":
            if self.filer.find_entry(path) is None:
                return _err("NoSuchBucket", bucket, 404)
            if "uploads" in req.query:
                return self._list_multipart_uploads(bucket)
            return await self._list_objects(req, bucket)
        return _err("MethodNotAllowed", req.method, 405)

    def _list_multipart_uploads(self, bucket: str) -> web.Response:
        """ListMultipartUploads (s3api_server.go:59): every in-progress
        upload targeting this bucket, from the shared uploads dir."""
        root = ET.Element("ListMultipartUploadsResult", xmlns=_NS)
        ET.SubElement(root, "Bucket").text = bucket
        # page through the SHARED uploads dir completely — a capped
        # single listing would silently drop uploads for this bucket
        # once the global in-progress count passes the cap
        ups: list = []
        start = ""
        while True:
            try:
                page = self.filer.list_directory_entries(
                    UPLOADS_DIR, start, False, 1024)
            except FilerError:
                break
            ups.extend(page)
            if len(page) < 1024:
                break
            start = page[-1].name
        for e in ups:
            meta = e.extended or {}
            if meta.get("bucket") != bucket:
                continue
            el = ET.SubElement(root, "Upload")
            ET.SubElement(el, "Key").text = str(meta.get("key", ""))
            ET.SubElement(el, "UploadId").text = e.name
            ET.SubElement(el, "Initiated").text = _ts(e.attr.crtime)
        return _xml(root)

    async def _list_objects(self, req: web.Request,
                            bucket: str) -> web.Response:
        q = req.query
        v2 = q.get("list-type") == "2"
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", 1000))
        marker = q.get("continuation-token" if v2 else "marker", "")

        keys, prefixes, truncated, next_marker = self._walk_objects(
            bucket, prefix, delimiter, marker, max_keys)

        root = ET.Element("ListBucketResult", xmlns=_NS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = prefix
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        if v2:
            ET.SubElement(root, "KeyCount").text = str(len(keys))
            if truncated:
                ET.SubElement(root, "NextContinuationToken").text = \
                    next_marker
        elif truncated:
            ET.SubElement(root, "NextMarker").text = next_marker
        for key, e in keys:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = key
            ET.SubElement(c, "LastModified").text = _ts(e.attr.mtime)
            ET.SubElement(c, "ETag").text = f'"{chunks_etag(e.chunks)}"'
            ET.SubElement(c, "Size").text = str(e.size)
            ET.SubElement(c, "StorageClass").text = "STANDARD"
        for p in sorted(prefixes):
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = p
        return _xml(root)

    def _walk_objects(self, bucket: str, prefix: str, delimiter: str,
                      marker: str, max_keys: int):
        """Depth-first walk of the bucket subtree, emitting keys > marker
        matching prefix; delimiter folds into CommonPrefixes."""
        base = f"{BUCKETS_DIR}/{bucket}"
        keys: list[tuple[str, Entry]] = []
        prefixes: set[str] = set()
        truncated = False
        next_marker = ""

        def emit(key: str, e: Entry) -> bool:
            nonlocal truncated, next_marker
            if len(keys) >= max_keys:
                truncated = True
                return False
            keys.append((key, e))
            next_marker = key
            return True

        def walk(dir_path: str) -> bool:
            rel_dir = dir_path[len(base):].lstrip("/")
            start = ""
            while True:
                entries = self.filer.list_directory_entries(
                    dir_path, start, False, 1024)
                if not entries:
                    return True
                for e in entries:
                    key = (rel_dir + "/" if rel_dir else "") + e.name
                    if prefix and not key.startswith(prefix) \
                            and not prefix.startswith(key + "/"):
                        continue
                    if delimiter:
                        rest = key[len(prefix):]
                        if delimiter in rest:
                            cut = key[:len(prefix) + rest.index(delimiter)
                                      + len(delimiter)]
                            prefixes.add(cut)
                            continue
                    if e.is_directory:
                        if not walk(f"{dir_path}/{e.name}"):
                            return False
                        continue
                    if marker and key <= marker:
                        continue
                    if not emit(key, e):
                        return False
                start = entries[-1].name
                if len(entries) < 1024:
                    return True

        walk(base)
        return keys, prefixes, truncated, next_marker

    async def _bulk_delete(self, req: web.Request,
                           bucket: str) -> web.Response:
        body = await req.read()
        doc = ET.fromstring(body)
        deleted, errors = [], []
        for obj in doc.findall(".//{*}Object"):
            key_el = obj.find("{*}Key")
            key = key_el.text if key_el is not None else None
            if not key:
                continue
            try:
                self.filer.delete_entry(f"{BUCKETS_DIR}/{bucket}/{key}")
                deleted.append(key)
            except FilerError as e:
                errors.append((key, str(e)))
        root = ET.Element("DeleteResult", xmlns=_NS)
        for key in deleted:
            d = ET.SubElement(root, "Deleted")
            ET.SubElement(d, "Key").text = key
        for key, msg in errors:
            er = ET.SubElement(root, "Error")
            ET.SubElement(er, "Key").text = key
            ET.SubElement(er, "Message").text = msg
        return _xml(root)

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------

    async def h_object(self, req: web.Request) -> web.Response:
        bucket = req.match_info["bucket"]
        key = urllib.parse.unquote(req.match_info["key"])
        hb = self._host_bucket(req)
        if hb is not None:
            # host-style: the first path segment belongs to the key
            bucket, key = hb, f"{urllib.parse.unquote(bucket)}/{key}"
        return await self._object_ops(req, bucket, key)

    async def _object_ops(self, req: web.Request, bucket: str,
                          key: str) -> web.Response:
        path = f"{BUCKETS_DIR}/{bucket}/{key}"
        q = req.query
        if "uploadId" in q or "uploads" in q:
            return await self._multipart(req, bucket, key)
        if req.method == "PUT":
            src = req.headers.get("x-amz-copy-source")
            if src:
                return await self._copy_object(src, path)
            return await self._put_object(req, bucket, path)
        if req.method in ("GET", "HEAD"):
            return await self._get_object(req, path)
        if req.method == "DELETE":
            try:
                self.filer.delete_entry(path)
            except FilerError:
                pass  # S3 delete is idempotent
            return web.Response(status=204)
        return _err("MethodNotAllowed", req.method, 405)

    async def _put_object(self, req: web.Request, bucket: str,
                          path: str) -> web.Response:
        if self.filer.find_entry(f"{BUCKETS_DIR}/{bucket}") is None:
            return _err("NoSuchBucket", bucket, 404)
        mime = req.headers.get("Content-Type", "")
        # filer-tier write span: the chunk fan-out + entry commit of
        # this object write, with the volume uploads as client children
        from ..util import tracing
        with tracing.start("filer", "write") as sp:
            chunks, md5, sha_hex = await self._store_stream(
                self._body_reader(req), collection=bucket, mime=mime)
            if (bad := self._payload_hash_mismatch(req, chunks,
                                                   sha_hex)):
                sp.status = "error"
                return bad
            now = time.time()
            entry = Entry(path, Attr(mtime=now, crtime=now, mime=mime,
                                     collection=bucket), chunks)
            try:
                self.filer.create_entry(entry)
            except FilerError as e:
                self.filer.delete_chunks([c.file_id for c in chunks])
                sp.status = "error"
                return _err("InternalError", str(e), 500)
            sp.set("chunks", len(chunks))
            sp.nbytes = sum(c.size for c in chunks)
        return web.Response(status=200,
                            headers={"ETag": f'"{md5.hexdigest()}"'})

    def _payload_hash_mismatch(self, req: web.Request, chunks,
                               sha_hex: str) -> web.Response | None:
        """When the client signed a concrete payload hash, enforce it —
        otherwise a replayed signature could smuggle a different body.
        Cleans up the uploaded chunks on mismatch."""
        ctx = req.get("s3auth")
        if ctx is not None and len(ctx.content_sha256) == 64 \
                and ctx.content_sha256 != sha_hex:
            self.filer.delete_chunks([c.file_id for c in chunks])
            return _err("XAmzContentSHA256Mismatch",
                        "payload does not match signed hash", 400)
        return None

    def _body_reader(self, req: web.Request):
        """Raw body stream, stripping aws-chunked signature framing when
        the SDK streams with STREAMING-AWS4-HMAC-SHA256-PAYLOAD; chunk
        signatures are verified when the request was authenticated."""
        if is_aws_chunked(req.headers):
            return AwsChunkedDecoder(req.content, req.get("s3auth"))
        return req.content

    async def _store_stream(self, reader, collection: str,
                            mime: str = "") -> tuple[list[FileChunk], object]:
        chunks: list[FileChunk] = []
        offset = 0
        md5 = hashlib.md5()
        sha256 = hashlib.sha256()
        try:
            await self._store_stream_inner(reader, collection, mime,
                                           chunks, md5, sha256)
        except Exception:
            # mid-stream failure (bad chunk signature, truncated body,
            # volume error): the already-uploaded chunks must not leak
            self.filer.delete_chunks([c.file_id for c in chunks])
            raise
        return chunks, md5, sha256.hexdigest()

    async def _store_stream_inner(self, reader, collection, mime,
                                  chunks, md5, sha256) -> None:
        offset = 0
        while True:
            try:
                data = bytearray()
                while len(data) < self.chunk_size:
                    part = await reader.read(self.chunk_size - len(data))
                    if not part:
                        break
                    data.extend(part)
            except asyncio.IncompleteReadError:
                raise AuthError("IncompleteBody",
                                "request body ended mid-chunk") from None
            if not data:
                break
            md5.update(data)
            sha256.update(data)
            a = await self.client.assign(collection=collection)
            up = await self.client.upload(a["fid"], a["url"], bytes(data),
                                          mime=mime,
                                          auth=a.get("auth", ""))
            chunks.append(FileChunk(a["fid"], offset, len(data),
                                    time.time_ns(), up.get("eTag", "")))
            offset += len(data)
            if len(data) < self.chunk_size:
                break

    async def _copy_object(self, src: str, dst_path: str) -> web.Response:
        src = urllib.parse.unquote(src).lstrip("/")
        src_path = f"{BUCKETS_DIR}/{src}"
        entry = self.filer.find_entry(src_path)
        if entry is None:
            return _err("NoSuchKey", src, 404)
        # server-side copy re-uploads chunk data (fresh fids, so source
        # delete cannot orphan the copy)
        new_chunks: list[FileChunk] = []
        for view in view_from_chunks(entry.chunks, 0, entry.size):
            data = await self.client.read(view.file_id, view.offset,
                                          view.size)
            a = await self.client.assign(
                collection=dst_path.split("/")[2])
            up = await self.client.upload(a["fid"], a["url"], data,
                                          auth=a.get("auth", ""))
            new_chunks.append(FileChunk(
                a["fid"], view.logic_offset, view.size, time.time_ns(),
                up.get("eTag", "")))
        now = time.time()
        self.filer.create_entry(Entry(
            dst_path, Attr(mtime=now, crtime=now, mime=entry.attr.mime),
            new_chunks))
        root = ET.Element("CopyObjectResult", xmlns=_NS)
        ET.SubElement(root, "ETag").text = f'"{chunks_etag(new_chunks)}"'
        ET.SubElement(root, "LastModified").text = _ts(now)
        return _xml(root)

    async def _get_object(self, req: web.Request,
                          path: str) -> web.StreamResponse:
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            return _err("NoSuchKey", path, 404)
        size = entry.size
        offset, length, status = 0, size, 200
        try:
            rng = parse_range(req.headers.get("Range", ""), size)
        except RangeError as e:
            return _err("InvalidRange", str(e), 416)
        if rng is not None:
            offset, length = rng
            status = 206
        headers = {
            "ETag": f'"{chunks_etag(entry.chunks)}"',
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(entry.attr.mtime)),
            "Content-Length": str(length),
            "Accept-Ranges": "bytes",
        }
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
        # filer-tier stream span: the chunk fan-out/assembly cost of
        # this object read, with the volume hops as client children
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
                sp.status = "error"
                if req.transport is not None:
                    req.transport.close()
                return resp
        await resp.write_eof()
        return resp

    # ------------------------------------------------------------------
    # multipart (filer_multipart.go)
    # ------------------------------------------------------------------

    async def _multipart(self, req: web.Request, bucket: str,
                         key: str) -> web.Response:
        q = req.query
        if req.method == "POST" and "uploads" in q:
            upload_id = uuid.uuid4().hex
            d = new_directory_entry(f"{UPLOADS_DIR}/{upload_id}")
            d.extended = {"bucket": bucket, "key": key}
            self.filer.create_entry(d)
            root = ET.Element("InitiateMultipartUploadResult", xmlns=_NS)
            ET.SubElement(root, "Bucket").text = bucket
            ET.SubElement(root, "Key").text = key
            ET.SubElement(root, "UploadId").text = upload_id
            return _xml(root)

        upload_id = q.get("uploadId", "")
        updir = f"{UPLOADS_DIR}/{upload_id}"
        if self.filer.find_entry(updir) is None:
            return _err("NoSuchUpload", upload_id, 404)

        if req.method == "PUT" and "partNumber" in q:
            part = int(q["partNumber"])
            chunks, md5, sha_hex = await self._store_stream(
                self._body_reader(req), collection=bucket)
            if (bad := self._payload_hash_mismatch(req, chunks, sha_hex)):
                return bad
            now = time.time()
            self.filer.create_entry(Entry(
                f"{updir}/{part:04d}.part", Attr(mtime=now, crtime=now),
                chunks))
            return web.Response(status=200,
                                headers={"ETag": f'"{md5.hexdigest()}"'})

        if req.method == "POST":  # CompleteMultipartUpload
            parts = self.filer.list_directory_entries(updir, limit=10001)
            parts = sorted((p for p in parts
                            if p.name.endswith(".part")),
                           key=lambda p: int(p.name.split(".")[0]))
            all_chunks: list[FileChunk] = []
            offset = 0
            for p in parts:
                for c in sorted(p.chunks, key=lambda c: c.offset):
                    all_chunks.append(FileChunk(
                        c.file_id, offset + c.offset, c.size, c.mtime,
                        c.etag))
                offset += p.size
            now = time.time()
            path = f"{BUCKETS_DIR}/{bucket}/{key}"
            self.filer.create_entry(Entry(
                path, Attr(mtime=now, crtime=now, collection=bucket),
                all_chunks))
            # drop part entries WITHOUT freeing chunks (now referenced by
            # the object): bypass delete_entry's chunk GC
            for p in parts:
                self.filer.store.delete_entry(p.full_path)
            self.filer.store.delete_entry(updir)
            root = ET.Element("CompleteMultipartUploadResult", xmlns=_NS)
            ET.SubElement(root, "Location").text = \
                tls.url(self.url, f"/{bucket}/{key}")
            ET.SubElement(root, "Bucket").text = bucket
            ET.SubElement(root, "Key").text = key
            ET.SubElement(root, "ETag").text = \
                f'"{chunks_etag(all_chunks)}-{len(parts)}"'
            return _xml(root)

        if req.method == "DELETE":  # AbortMultipartUpload
            try:
                self.filer.delete_entry(updir, recursive=True,
                                        ignore_recursive_error=True)
            except FilerError:
                pass
            return web.Response(status=204)

        if req.method == "GET":  # ListParts
            parts = self.filer.list_directory_entries(updir, limit=10001)
            root = ET.Element("ListPartsResult", xmlns=_NS)
            ET.SubElement(root, "Bucket").text = bucket
            ET.SubElement(root, "Key").text = key
            ET.SubElement(root, "UploadId").text = upload_id
            for p in sorted(parts, key=lambda p: p.name):
                if not p.name.endswith(".part"):
                    continue
                el = ET.SubElement(root, "Part")
                ET.SubElement(el, "PartNumber").text = \
                    str(int(p.name.split(".")[0]))
                ET.SubElement(el, "Size").text = str(p.size)
                ET.SubElement(el, "LastModified").text = _ts(p.attr.mtime)
            return _xml(root)

        return _err("MethodNotAllowed", req.method, 405)
