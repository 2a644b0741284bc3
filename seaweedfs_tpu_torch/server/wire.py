"""Unified volume data-plane protocol layer: ONE wire.

Both volume listeners — the hand-rolled raw HTTP/1.1 fast protocol
(server/fasthttp.py) and the aiohttp application (server/volume_server)
— feed the SAME parse/handle/respond functions here for the public
needle API: GET, POST/PUT, DELETE and the pipelined multi-needle
``/batch`` endpoint. The hot-needle cache peek, the tracing
attribution, the ``volume.read.http`` failpoint, Range/conditional
semantics, replication fan-out and group-commit writes are therefore
wired exactly once; a listener is only a transport adapter that builds
a :class:`WireRequest` and renders a :class:`WireResponse`.

Zero-copy: a cold read of a large plain needle resolves to a
:class:`NeedleRef` (storage/volume.py) instead of bytes — the raw
listener then moves the body disk->socket with ``loop.sendfile`` and
the span carries ``source=sendfile``. Responses the shared layer cannot
express for a given transport degrade explicitly: ``upgrade=True``
tells the raw listener to replay the request into aiohttp (chunked
manifests, multipart), ``manifest`` tells the aiohttp adapter to
stream the assembled file.

A copy of seaweedfs_tpu/server/wire.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import gzip

import aiohttp
import json
import re
import time
from dataclasses import dataclass, field

from ..storage import types as t
from ..storage.backend import BackendError
from ..storage.needle import (FLAG_HAS_LAST_MODIFIED,
                              FLAG_IS_CHUNK_MANIFEST, CrcMismatch, Needle,
                              NeedleError)
from ..storage.store import BatchBudgetExceeded
from ..storage.volume import AlreadyDeleted, NotFound, VolumeError
from ..ec.ec_volume import EcVolumeError
from ..ec import scrub as ec_scrub
from ..util import batchframe, failpoints, glog, tracing
from ..util.httprange import RangeError, parse_range
from ..security import tls

# cold bodies at least this large go disk->socket via sendfile on the
# raw listener; smaller ones aren't worth the extra header/meta preads
SENDFILE_MIN = 64 * 1024

# most fids a single /batch request may carry (overridable per server
# with -batch.max)
BATCH_MAX_DEFAULT = 256

OCTET = "application/octet-stream"


@dataclass
class WireRequest:
    """Transport-agnostic request: both listeners build one of these."""

    method: str                       # GET / POST / PUT / DELETE / HEAD
    fid_s: str = ""                   # "" for /batch
    query: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)   # LOWER-CASED keys
    peer_ip: str | None = None
    body: bytes | None = None
    raw: bool = False                 # serving on the raw fast listener
    worker_hop: bool = False          # token-authenticated sibling hop


@dataclass
class WireResponse:
    status: int = 200
    headers: dict = field(default_factory=dict)
    body: bytes = b""
    content_type: str = OCTET
    head: bool = False                # HEAD: emit headers, no body
    # -- transport escape hatches --
    upgrade: bool = False             # raw listener: replay via aiohttp
    manifest: Needle | None = None    # aiohttp: stream assembled file
    drop: bool = False                # sever the connection, no answer
    truncate_to: int = -1             # failpoint: full CL, partial body
    sendfile: object | None = None    # storage.volume.NeedleRef

    @property
    def content_length(self) -> int:
        if self.sendfile is not None:
            return self.sendfile.length
        return len(self.body)


_REASONS = {200: "OK", 201: "Created", 206: "Partial Content",
            301: "Moved Permanently", 304: "Not Modified",
            400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
            406: "Not Acceptable", 409: "Conflict",
            413: "Payload Too Large", 416: "Range Not Satisfiable",
            500: "Internal Server Error", 503: "Service Unavailable"}


def reason(status: int) -> str:
    return _REASONS.get(status, "Status")


def json_err(status: int, msg: str) -> WireResponse:
    return WireResponse(
        status=status, body=json.dumps({"error": msg}).encode(),
        content_type="application/json; charset=utf-8")


def json_ok(obj: dict, status: int = 200) -> WireResponse:
    return WireResponse(
        status=status, body=json.dumps(obj).encode(),
        content_type="application/json; charset=utf-8")


def observe(vs, op: str, t0: float, nbytes: int = 0) -> None:
    dur = time.perf_counter() - t0
    # the scrub pacer's pause-on-foreground-latency signal is THIS
    # feed — the same durations the request-seconds histogram sees, so
    # the pacer and the dashboards agree on what "foreground latency"
    # means (one lock-free deque append; see ec/scrub.ForegroundLoad)
    ec_scrub.foreground.note(dur)
    # ... and the bandwidth arbiter's foreground-PRESSURE feed is the
    # served bytes (qos/arbiter.py: background repair yields to this)
    from .. import qos
    qos.note_foreground(nbytes)
    from ..stats import metrics
    if metrics.HAVE_PROMETHEUS:
        metrics.VOLUME_REQUEST_TIME.labels(op).observe(dur)


# tiny cache of formatted Last-Modified values: needles written in the
# same second share the string, and strftime is the priciest call left
# on the cache-hot read path (carried over from the pre-unification
# fast listener, which measured exactly that)
_LM_CACHE: dict = {}


def http_date(ts: int) -> str:
    v = _LM_CACHE.get(ts)
    if v is None:
        v = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))
        if len(_LM_CACHE) > 64:
            _LM_CACHE.clear()
        _LM_CACHE[ts] = v
    return v


def _guess_mime(fname: str, default: str) -> str:
    """Extension-derived mime, ONLY for plain extensions: guess_type
    splits 'a.tar.gz' into (application/x-tar, gzip) and serving the
    inner type for compressed bytes would mislabel the body."""
    import mimetypes
    guess, enc = mimetypes.guess_type(fname)
    return guess if guess and enc is None else default


def _disposition(query: dict, fname: str) -> str:
    """Content-Disposition with ?dl=true attachment support
    (volume_server_handlers_read.go:239-247); control characters
    stripped so a CR/LF in a stored name can't split the header."""
    fname = "".join(ch for ch in fname if ch >= " ")
    disp = ("attachment"
            if str(query.get("dl", "")).lower() in ("1", "true")
            else "inline")
    escaped = fname.replace("\\", "\\\\").replace('"', '\\"')
    return f'{disp}; filename="{escaped}"'


def check_jwt(vs, wr: WireRequest) -> WireResponse | None:
    """Write-token guard (volume_server_handlers_write.go:41-44),
    shared by POST/DELETE on both listeners. Replica writes must carry
    the forwarded per-fid token — a bare ?type=replicate does NOT
    bypass the guard."""
    if not vs.jwt_key:
        return None
    from ..security.jwt import (JwtError, check_write_jwt,
                                get_jwt_from_request)
    # the shared extractor expects canonical header casing; WireRequest
    # headers are lower-cased by contract
    token = get_jwt_from_request(
        {"Authorization": wr.headers.get("authorization", "")},
        wr.query)
    if not token:
        return json_err(401, "missing jwt")
    try:
        check_write_jwt(vs.jwt_key, token, wr.fid_s)
    except JwtError as e:
        return json_err(401, str(e))
    return None


# ---- GET ----

async def serve_read(vs, wr: WireRequest) -> WireResponse:
    """The one needle-GET implementation behind both listeners."""
    t0 = time.perf_counter()
    sp = tracing.current()
    try:
        fid = t.FileId.parse(wr.fid_s)
    except ValueError as e:
        return json_err(400, str(e))
    store = vs.store
    vid = fid.volume_id
    wc = vs.worker_ctx
    if wr.raw and wc is not None and not wc.owns(vid) \
            and not wr.worker_hop:
        # a sibling worker's partition: the aiohttp worker-routing
        # middleware owns the proxy hop — replay the request there
        return WireResponse(upgrade=True)
    if not store.has_volume(vid):
        if not vs.read_redirect:
            vs.count("read", "404")
            return json_err(404, "not found")
        # misrouted read: redirect via master lookup (handlers_read.go:46)
        try:
            async with vs._http.get(
                    tls.url(vs.master_url, "/dir/lookup"),
                    params={"volumeId": str(vid)},
                    timeout=aiohttp.ClientTimeout(total=5)) as resp:
                if resp.status != 200:
                    return json_err(404, "volume not found")
                locs = (await resp.json())["locations"]
        except (OSError, ValueError, KeyError,
                asyncio.TimeoutError, aiohttp.ClientError):
            # asyncio.TimeoutError is NOT an OSError on py3.10 — a
            # wedged master must produce the 404, not a 500
            return json_err(404, "volume not found")
        others = [l for l in locs if l["url"] != vs.url]
        if not others:
            return json_err(404, "volume not found")
        return WireResponse(
            status=301,
            headers={"Location": tls.url(others[0]["publicUrl"],
                                         f"/{wr.fid_s}")})
    # hot-needle cache peek: a hit answers on the event loop with zero
    # disk I/O and no executor round trip. count=False: accounting is
    # deferred until we know this layer actually serves the request
    # (a manifest replayed into aiohttp must not count twice).
    n = store.cached_needle(vid, fid.key, fid.cookie, count=False)
    from_cache = n is not None
    ref = None
    try:
        if n is None:
            # zero-copy eligibility is decided from REQUEST shape here
            # (body-shape checks below fall back): any listener — the
            # raw path and the frame adapter sendfile into the socket,
            # the aiohttp app drains the ref through a StreamResponse —
            # but nothing that forces the bytes through Python
            want_ref = (wr.method == "GET"
                        and wr.headers.get("etag-md5") != "True"
                        and "width" not in wr.query
                        and "height" not in wr.query
                        and not failpoints.pending("volume.read.http"))
            if want_ref:
                n, ref = await vs._in_executor(
                    store.read_needle_ex, vid, fid.key, fid.cookie,
                    vs.sendfile_min)
            else:
                n = await vs._in_executor(
                    store.read_needle, vid, fid.key, fid.cookie)
    except (NotFound, AlreadyDeleted):
        vs.count("read", "404")
        sp.status = "404"
        return WireResponse(status=404)
    except failpoints.FailpointDrop:
        sp.status = "drop"
        return WireResponse(drop=True)
    except failpoints.FailpointError as e:
        sp.status = str(e.status)
        return json_err(e.status, str(e))
    except CrcMismatch as e:
        sp.status = "500"
        return json_err(500, str(e))
    except (EcVolumeError, BackendError) as e:
        # retryable server-side degradation: an EC read that could not
        # gather enough shards or a tiered volume whose remote tier is
        # down — clean 503, never a traceback
        vs.count("read", "error")
        sp.status = "503"
        return json_err(503, str(e))
    try:
        return await _render_needle(vs, wr, fid, n, ref, from_cache,
                                    sp, t0)
    except BaseException:
        if ref is not None:
            ref.close()
        raise


async def _render_needle(vs, wr: WireRequest, fid, n: Needle, ref,
                         from_cache: bool, sp, t0: float
                         ) -> WireResponse:
    """Headers/conditionals/Range/response for one resolved needle.
    Owns ``ref``: every early return that doesn't hand it to the
    response closes it (the caller backstops on exceptions)."""
    store = vs.store
    is_manifest = n.is_chunked_manifest and wr.query.get("cm") != "false"
    if is_manifest and wr.raw:
        # manifest assembly streams through the aiohttp machinery; the
        # raw listener replays the request there (the full handler
        # does its own accounting, and its adapter cancels this span)
        if ref is not None:
            ref.close()
        return WireResponse(upgrade=True)
    headers: dict = {"Etag": f'"{n.etag()}"', "Accept-Ranges": "bytes"}
    if n.pairs:
        # stored pairs come back as response headers
        # (volume_server_handlers_read.go:123-132)
        try:
            pair_map = json.loads(n.pairs)
            if isinstance(pair_map, dict):
                headers.update({k: str(v) for k, v in pair_map.items()})
            else:
                glog.warning("pairs of %s: not a JSON object", wr.fid_s)
        except ValueError:
            glog.warning("unmarshal pairs of %s: bad json", wr.fid_s)
    # conditional checks BEFORE body work, as in the reference
    # (read.go:102-121 precede tryHandleChunkedFile)
    if n.last_modified:
        headers["Last-Modified"] = http_date(int(n.last_modified))
        ims = wr.headers.get("if-modified-since", "")
        if ims:
            import calendar
            try:
                # calendar.timegm, NOT mktime: the header is GMT and
                # mktime applies the host zone (DST included)
                at = calendar.timegm(time.strptime(
                    ims, "%a, %d %b %Y %H:%M:%S GMT"))
                if at >= int(n.last_modified):
                    if ref is not None:
                        ref.close()
                    _count_served(vs, store, n, from_cache, sp, t0)
                    return WireResponse(status=304, headers=headers,
                                        head=True)
            except ValueError:
                pass  # unparseable date: serve normally (ref parity)
    if wr.headers.get("if-none-match", "") == f'"{n.etag()}"':
        if ref is not None:
            ref.close()
        _count_served(vs, store, n, from_cache, sp, t0)
        return WireResponse(status=304, headers=headers, head=True)
    if wr.headers.get("etag-md5") == "True":
        # content-MD5 etag instead of the CRC one (read.go:117-121);
        # needs the bytes, so never on the ref path (see want_ref)
        import hashlib
        headers["Etag"] = f'"{hashlib.md5(n.data).hexdigest()}"'
    if is_manifest:
        # conditional checks ran ABOVE, as in the reference
        # (read.go:102-121 precede tryHandleChunkedFile — assembled
        # files are where a 304 saves the most); pairs + Last-Modified
        # ride into the streamed response's headers
        if ref is not None:
            # meta-only ref resolution can't feed the manifest parser
            ref.close()
            ref = None
            n = await vs._in_executor(store.read_needle, fid.volume_id,
                                      fid.key, fid.cookie)
        _count_served(vs, store, n, from_cache, sp, t0)
        return WireResponse(manifest=n, headers=headers)
    body = n.data
    if n.is_gzipped:
        if "gzip" in wr.headers.get("accept-encoding", ""):
            headers["Content-Encoding"] = "gzip"
        else:
            if ref is not None:
                # stored-gzipped body must be inflated in userspace:
                # fall back to the buffered read (rare: gzip + cold +
                # large)
                ref.close()
                ref = None
                n = await vs._in_executor(
                    store.read_needle, fid.volume_id, fid.key,
                    fid.cookie)
            body = gzip.decompress(n.data)
    ct = n.mime.decode() if n.mime else OCTET
    if n.name:
        fname = n.name.decode(errors="replace")
        ct = _guess_mime(fname, ct) if not n.mime else ct
        headers["Content-Disposition"] = _disposition(wr.query, fname)
    # on-read image resize (volume_server_handlers_read.go:211-227);
    # resize queries are excluded from the ref path by want_ref
    if ("width" in wr.query or "height" in wr.query) \
            and "Content-Encoding" not in headers \
            and wr.method != "HEAD":
        from ..images import resizing
        if resizing.resizable(ct):
            try:
                w = int(wr.query.get("width", 0) or 0)
                h = int(wr.query.get("height", 0) or 0)
            except ValueError:
                w = h = 0  # bad params: serve the original (ref parity)
            mode = wr.query.get("mode", "")
            if w > 0 or h > 0:
                data = body
                body = await vs._in_executor(
                    lambda: resizing.resized(ct, data, w, h, mode))
                headers.pop("Etag", None)
    status = 200
    if "Content-Encoding" not in headers:
        # serve byte ranges of the (plain) body — suffix, open-ended
        # and mid-body resume ranges included; 416 carries the total
        total = ref.length if ref is not None else len(body)
        try:
            rng = parse_range(wr.headers.get("range", ""), total)
        except RangeError:
            if ref is not None:
                ref.close()
            return WireResponse(
                status=416,
                headers={"Content-Range": f"bytes */{total}"})
        if rng is not None:
            off, ln = rng
            headers["Content-Range"] = f"bytes {off}-{off+ln-1}/{total}"
            status = 206
            if ref is not None:
                ref.slice(off, ln)
            else:
                body = body[off:off + ln]
    _count_served(vs, store, n, from_cache, sp, t0)
    if wr.method == "HEAD":
        if ref is not None:
            ref.close()
            ref = None
        sp.nbytes = 0
        return WireResponse(status=status, headers=headers,
                            content_type=ct, head=True)
    # chaos site volume.read.http: response-level error / latency /
    # drop / truncate (full Content-Length, partial body, dead socket —
    # the mid-read death degraded reads must survive). The ref path is
    # excluded while armed (want_ref), so body is always real here.
    if failpoints.armed():
        a = failpoints.take("volume.read.http")
        if a is not None:
            if a.action == "latency":
                await asyncio.sleep(float(a.arg or 0) / 1000.0)
            elif a.action == "error":
                if ref is not None:
                    ref.close()
                return json_err(int(a.arg or 500),
                                f"failpoint volume.read.http")
            elif a.action == "drop":
                if ref is not None:
                    ref.close()
                sp.status = "drop"
                return WireResponse(drop=True)
            else:  # truncate
                if ref is not None:
                    ref.close()
                keep = float(a.arg) if a.arg else 0.5
                return WireResponse(
                    status=status, headers=headers, content_type=ct,
                    body=body, truncate_to=int(len(body) * keep))
    if ref is not None:
        sp.set("source", "sendfile")
        sp.nbytes = ref.length
        return WireResponse(status=status, headers=headers,
                            content_type=ct, sendfile=ref)
    sp.nbytes = len(body)
    return WireResponse(status=status, headers=headers,
                        content_type=ct, body=body)


def _count_served(vs, store, n: Needle, from_cache: bool, sp,
                  t0: float) -> None:
    if from_cache:
        # deferred accounting for the served cache hit
        store.needle_cache.hit(n)
        sp.set("source", "cache")
    vs.count("read", "ok")
    observe(vs, "read", t0, nbytes=len(n.data or b""))


# ---- POST / PUT ----

def build_needle(fid, wr: WireRequest, data: bytes, name: bytes = b"",
                 mime: bytes = b"") -> Needle:
    """ParseUpload analog (needle.go:54) minus transport framing: the
    adapters extract (data, name, mime) — raw body or multipart part —
    and everything else (EXIF fix, pairs, ts/ttl validation, flags) is
    decided here once."""
    if not mime:
        ctype = wr.headers.get("content-type", "")
        if ctype and ctype != OCTET and not ctype.startswith("multipart/"):
            mime = ctype.split(";")[0].encode()
    if mime in (b"image/jpeg", b"image/jpg") or \
            (name.lower().endswith((b".jpg", b".jpeg")) and not mime):
        # bake EXIF rotation into stored bytes (needle.go ParseUpload)
        from ..images import fix_jpeg_orientation
        data = fix_jpeg_orientation(data)
    # Seaweed-* request headers ride along as needle pairs
    # (needle.go:19,55-60 PairNamePrefix), canonicalized like Go's
    # net/http does before the prefix check
    pair_map = {k.title(): v for k, v in wr.headers.items()
                if k.title().startswith("Seaweed-") and v}
    try:
        # client-supplied modified time (needle.go:80 "ts")
        last_modified = int(wr.query.get("ts", "") or time.time())
    except ValueError:
        last_modified = int(time.time())
    if not 0 <= last_modified < (1 << 40):
        # out of the 5-byte on-disk range: a negative/overflowed ts
        # must not crash serialization or corrupt TTL math
        last_modified = int(time.time())
    n = Needle(cookie=fid.cookie, id=fid.key, data=data, name=name,
               mime=mime, ttl=t.TTL.parse(wr.query.get("ttl", "")),
               pairs=(json.dumps(pair_map).encode() if pair_map else b""),
               last_modified=last_modified)
    n.set_flag(FLAG_HAS_LAST_MODIFIED)
    if wr.query.get("cm") in ("true", "1"):
        # chunk-manifest needle (needle_parse_multipart.go:86)
        n.set_flag(FLAG_IS_CHUNK_MANIFEST)
    return n


async def serve_write(vs, wr: WireRequest,
                      n: Needle | None = None) -> WireResponse:
    """The one needle-write implementation: jwt guard, needle build
    (unless the adapter pre-parsed a multipart upload into ``n``),
    group-commit store append, replication fan-out, 201."""
    t0 = time.perf_counter()
    sp = tracing.current()
    denied = check_jwt(vs, wr)
    if denied is not None:
        return denied
    try:
        fid = t.FileId.parse(wr.fid_s)
    except ValueError as e:
        return json_err(400, str(e))
    if n is None:
        if wr.headers.get("x-raw-needle") == "1":
            # replica write: body is the serialized needle record
            n = Needle.from_bytes(wr.body or b"", t.CURRENT_VERSION)
        else:
            try:
                n = build_needle(fid, wr, wr.body or b"")
            except (NeedleError, ValueError) as e:
                return json_err(400, str(e))
    try:
        _, size = await vs._in_executor(
            vs.store.write_needle, fid.volume_id, n)
    except NotFound:
        sp.status = "404"
        return json_err(404, "volume not found")
    except failpoints.FailpointDrop:
        sp.status = "drop"
        return WireResponse(drop=True)
    except failpoints.FailpointError as e:
        sp.status = str(e.status)
        return json_err(e.status, str(e))
    except NeedleError as e:
        # e.g. >64KB of Seaweed-* pair headers: a client error, not an
        # unhandled 500 (needle.py pairs-size limit)
        sp.status = "400"
        return json_err(400, str(e))
    except VolumeError as e:
        sp.status = "409"
        return json_err(409, str(e))
    sp.nbytes = len(n.data)
    vs.count("write", "ok")
    observe(vs, "write", t0, nbytes=len(n.data))
    # replicate unless this IS a replica write (store_replicate.go:21)
    if wr.query.get("type") != "replicate":
        v = vs.store.volumes.get(fid.volume_id)
        rp = v.super_block.replica_placement if v else None
        if rp and rp.copy_count > 1:
            ok = await vs._replicate(
                wr.fid_s, "POST", n.to_bytes(3),
                auth=wr.headers.get("authorization", ""))
            if not ok:
                return json_err(500, "replication failed")
    return json_ok({"name": n.name.decode(errors="replace"),
                    "size": size, "eTag": n.etag()}, status=201)


# ---- DELETE ----

async def serve_delete(vs, wr: WireRequest) -> WireResponse:
    """The one needle-delete implementation: jwt guard, chunk-manifest
    cascade, tombstone, replica/EC-shard fan-out."""
    sp = tracing.current()
    denied = check_jwt(vs, wr)
    if denied is not None:
        return denied
    try:
        fid = t.FileId.parse(wr.fid_s)
    except ValueError as e:
        return json_err(400, str(e))
    store = vs.store
    n = Needle(cookie=fid.cookie, id=fid.key)
    is_ec = fid.volume_id in store.ec_volumes
    # a chunk-manifest delete cascades to its chunks — also through the
    # EC read path, or a manifest in an EC-encoded volume would orphan
    # every chunk (volume_server_handlers_write.go DeleteHandler)
    if wr.query.get("type") != "replicate":
        try:
            existing = await vs._in_executor(
                lambda: store.read_needle(fid.volume_id, fid.key,
                                          fid.cookie))
            if existing.is_chunked_manifest:
                from ..util.chunked import ChunkManifest
                cm = ChunkManifest.load(existing.data,
                                        existing.is_gzipped)
                await cm.delete_chunks(vs._weed_client())
        except (NotFound, AlreadyDeleted):
            pass  # nothing stored: plain tombstone below
        except (ValueError, KeyError, BackendError) as e:
            # tier outage / corrupt manifest: still tombstone, but the
            # skipped cascade must be visible — its chunks may now be
            # orphaned
            glog.warning("delete %s: manifest cascade skipped: %s",
                         wr.fid_s, e)
    try:
        size = await vs._in_executor(
            lambda: store.delete_needle(fid.volume_id, n))
    except NotFound:
        sp.status = "404"
        return json_err(404, "volume not found")
    if wr.query.get("type") != "replicate":
        auth = wr.headers.get("authorization", "")
        if is_ec:
            # tombstone every shard holder's .ecx (DeleteEcShardNeedle
            # broadcast, store_ec_delete.go:15-101)
            await vs._ec_delete_broadcast(fid.volume_id, wr.fid_s, auth)
        else:
            v = store.volumes.get(fid.volume_id)
            rp = v.super_block.replica_placement if v else None
            if rp and rp.copy_count > 1:
                await vs._replicate(wr.fid_s, "DELETE", None, auth=auth)
    vs.count("delete", "ok")
    return json_ok({"size": size})


# ---- batch GET ----

_FID_TOKEN = re.compile(r"\d+,[0-9a-fA-F]+")


def _batch_fids(wr: WireRequest) -> list[str] | WireResponse:
    """fids from ?fids=... or a JSON body {"fileIds": [...]}. A fid
    itself contains a comma (vid,keycookie), so the query form is
    parsed structurally: every vid,hex token in order. Garbage between
    tokens is a client error, not a silent drop."""
    raw = wr.query.get("fids", "")
    if raw:
        fids = _FID_TOKEN.findall(raw)
        if not fids or ",".join(fids) != raw:
            return json_err(400, "bad fids list (want fid,fid,...)")
        return fids
    if wr.body:
        try:
            body = json.loads(wr.body)
            fids = body.get("fileIds", [])
            if isinstance(fids, list) and \
                    all(isinstance(f, str) for f in fids):
                return fids
        except ValueError:
            pass
        return json_err(400, "bad json body")
    return json_err(400, "no fids given")


def _row_for(vs, fid_s: str, n: Needle | Exception,
             from_cache: bool = False) -> tuple[dict, bytes]:
    """(meta, body) for one batch row; counts per-needle like a
    single GET so hit rates and read counters stay meaningful."""
    if isinstance(n, Exception):
        if isinstance(n, BatchBudgetExceeded):
            # over the response byte budget: the client re-fetches
            # this row as a streamed single GET
            return {"fid": fid_s, "status": 413, "error": str(n)}, b""
        if isinstance(n, (NotFound, AlreadyDeleted)):
            vs.count("read", "404")
            return {"fid": fid_s, "status": 404,
                    "error": str(n) or "not found"}, b""
        if isinstance(n, (EcVolumeError, BackendError)):
            vs.count("read", "error")
            return {"fid": fid_s, "status": 503, "error": str(n)}, b""
        if isinstance(n, failpoints.FailpointError):
            return {"fid": fid_s, "status": n.status, "error": str(n)}, b""
        vs.count("read", "error")
        return {"fid": fid_s, "status": 500, "error": str(n)}, b""
    if n.is_chunked_manifest:
        # assembly needs the full streaming machinery: the client
        # falls back to a single GET for this fid
        return {"fid": fid_s, "status": 406,
                "error": "chunked manifest: use single GET"}, b""
    if from_cache:
        vs.store.needle_cache.hit(n)
    meta = {"fid": fid_s, "status": 200, "etag": n.etag()}
    if n.mime:
        meta["mime"] = n.mime.decode(errors="replace")
    if n.is_gzipped:
        # stored-compressed bytes travel as-is; the flag tells the
        # client to inflate (batch is an SDK/bench surface, not a
        # browser one)
        meta["gzip"] = True
    vs.count("read", "ok")
    return meta, n.data


async def serve_batch(vs, wr: WireRequest) -> WireResponse:
    """Pipelined multi-needle GET: cache hits answer inline on the
    event loop, the cold remainder coalesces into ONE executor round
    trip, and under -workers the batch splits by vid ownership — each
    sibling gets one sub-batch request and the rows reassemble in
    request order."""
    t0 = time.perf_counter()
    sp = tracing.current()
    fids = _batch_fids(wr)
    if isinstance(fids, WireResponse):
        return fids
    if len(fids) > vs.batch_max:
        return json_err(413, f"batch of {len(fids)} exceeds "
                             f"-batch.max {vs.batch_max}")
    store = vs.store
    wc = vs.worker_ctx
    rows: list[tuple[dict, bytes] | None] = [None] * len(fids)
    local: list[tuple[int, object]] = []          # (row idx, FileId)
    sibling: dict[int, list[int]] = {}            # worker -> row idxs
    for i, fid_s in enumerate(fids):
        try:
            fid = t.FileId.parse(str(fid_s))
        except ValueError as e:
            rows[i] = ({"fid": str(fid_s), "status": 400,
                        "error": str(e)}, b"")
            continue
        if wc is not None and not wr.worker_hop \
                and not wc.owns(fid.volume_id):
            sibling.setdefault(wc.owner_index(fid.volume_id),
                               []).append(i)
            continue
        local.append((i, fid))
    # cache hits answer inline; misses coalesce into one executor
    # trip. A BYTE budget bounds the buffered response (reads are an
    # open endpoint — one request must not hold batch_max full bodies
    # in memory): over-budget rows answer 413 and the client re-reads
    # them as streamed single GETs.
    hits = 0
    used = 0
    misses: list[tuple[int, object]] = []
    for i, fid in local:
        n = store.cached_needle(fid.volume_id, fid.key, fid.cookie,
                                count=False)
        if n is None:
            misses.append((i, fid))
            continue
        if used + len(n.data) > vs.batch_bytes_max:
            rows[i] = ({"fid": fids[i], "status": 413,
                        "error": "batch byte budget exceeded"}, b"")
            continue
        used += len(n.data)
        rows[i] = _row_for(vs, fids[i], n, from_cache=True)
        hits += 1
    if misses:
        got = await vs._in_executor(
            store.read_needles,
            [(f.volume_id, f.key, f.cookie) for _, f in misses],
            max(0, vs.batch_bytes_max - used))
        for (i, _), n in zip(misses, got):
            rows[i] = _row_for(vs, fids[i], n)

    async def fan_out(idx: int, row_idxs: list[int]) -> None:
        addr = wc.sibling_addr(idx)
        sub = [fids[i] for i in row_idxs]
        parsed: list[tuple[dict, bytes]] | None = None
        # frame hop first: one multiplexed frame per sibling sub-batch
        # instead of a full HTTP request (the channel carries the
        # launch token; worker.frame faults and dead channels fall
        # back to the HTTP hop below)
        ch = vs.sibling_frame_channel(idx) \
            if hasattr(vs, "sibling_frame_channel") else None
        if ch is not None:
            headers: dict = {}
            tracing.inject(headers)
            try:
                status, _, payload = await ch.request(
                    "GET", "/batch", query={"fids": ",".join(sub)},
                    headers=headers)
                if status == 200:
                    parsed = batchframe.parse_all(payload)
            except (OSError, ValueError):
                parsed = None
            if parsed is not None:
                sp.event("sibling_batch", worker=idx,
                         transport="frame")
        if parsed is None and addr is not None:
            wk = _wk()
            headers = {wk.WORKER_HEADER: wc.token}
            tracing.inject(headers)
            try:
                await failpoints.fail("worker.forward")
                async with vs._http.get(
                        tls.url(addr, "/batch"),
                        params={"fids": ",".join(sub)},
                        headers=headers,
                        timeout=aiohttp.ClientTimeout(total=30)) as r:
                    if r.status == 200:
                        parsed = batchframe.parse_all(await r.read())
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                    ValueError):
                parsed = None
            if parsed is not None:
                sp.event("sibling_batch", worker=idx,
                         transport="http")
        if parsed is None or len(parsed) != len(row_idxs):
            for i in row_idxs:
                rows[i] = ({"fid": fids[i], "status": 503,
                            "error": f"worker {idx} unavailable"}, b"")
            return
        for i, rec in zip(row_idxs, parsed):
            rows[i] = rec

    if sibling:
        await asyncio.gather(*(fan_out(i, g) for i, g in
                               sibling.items()))
    out = bytearray()
    for i, row in enumerate(rows):
        if row is None:       # unreachable, but never emit a hole
            row = ({"fid": str(fids[i]), "status": 500,
                    "error": "no result"}, b"")
        out += batchframe.encode_record(row[0], row[1])
    sp.set("n", len(fids))
    sp.set("hits", hits)
    if sibling:
        sp.set("proxied", sum(len(g) for g in sibling.values()))
    sp.nbytes = len(out)
    vs.count("batch", "ok")
    observe(vs, "batch", t0, nbytes=len(out))
    return WireResponse(body=bytes(out),
                        content_type=batchframe.CONTENT_TYPE,
                        headers={"X-Batch-Count": str(len(fids))})


def _wk():
    """Lazy server.workers import (only -workers mode pays for it)."""
    from . import workers
    return workers
