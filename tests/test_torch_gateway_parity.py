"""The port's gateways held to the JAX package's on the same requests.

- SigV4: seeded header-signed, presigned and aws-chunked requests (right
  and wrong secrets, unknown keys, tampered paths and queries, skewed
  clocks, expired and over-long presigned URLs, truncated bodies, bad
  and oversized chunk headers, tampered chunk signatures) go to the
  reference's SigV4Verifier / AwsChunkedDecoder and to the port's: the
  verdicts (the access key, the seed signature and the decoded bytes, or
  the error code) are equal.
- S3, WebDAV and replication twins: one seeded request sequence goes to
  a reference gateway on the reference's Filer and cluster
  (tests/cluster_util.py) and to the port's on the port's
  (tests/test_torch_cluster_util.py); statuses, the headers a client
  reads, XML bodies and object bytes are equal. Masked: times
  (LastModified, CreationDate, Initiated, creationdate,
  getlastmodified), upload ids, lock tokens and the Location URL, which
  name the run's own clock, uuid and port.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import os
import random
import re
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

import cluster_util
from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu.notification.queues import (
    SqliteQueue as RefSqliteQueue, attach_to_filer as ref_attach)
from seaweedfs_tpu.replication.replicator import Replicator as RefReplicator
from seaweedfs_tpu.replication.runner import (
    replicate_from_queue as ref_replicate)
from seaweedfs_tpu.replication.sink import LocalDirSink as RefLocalDirSink
from seaweedfs_tpu.replication.source import FilerSource as RefFilerSource
from seaweedfs_tpu.s3 import auth as ref_auth
from seaweedfs_tpu.s3.gateway import S3Gateway as RefS3Gateway
from seaweedfs_tpu.server.webdav_server import WebDavServer as RefWebDav
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.notification.queues import (SqliteQueue,
                                                     attach_to_filer)
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.runner import replicate_from_queue
from seaweedfs_tpu_torch.replication.sink import LocalDirSink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.s3.gateway import S3Gateway
from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
from test_torch_cluster_util import Cluster, run

AK, SK = "PARITYKEY", "PARITYSECRET"
REGION = "us-east-1"


# --- SigV4 verdicts ---------------------------------------------------------

def _amz_date(offset_s: float = 0.0) -> str:
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time()
                                                      + offset_s))


def _cq(query: dict) -> str:
    return "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query.items()))


def sign_headers(method: str, host: str, path: str, query: dict,
                 payload_hash: str, secret: str, access_key: str,
                 amz_date: str) -> dict:
    date = amz_date[:8]
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    signed = sorted(headers)
    canon = "\n".join([
        method, path, _cq(query),
        "".join(f"{h}:{headers[h]}\n" for h in signed),
        ";".join(signed), payload_hash])
    scope = f"{date}/{REGION}/s3/aws4_request"
    sts = "\n".join([auth.ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    sig = hmac.new(auth.signing_key(secret, date, REGION), sts.encode(),
                   hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"{auth.ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def presign(method: str, host: str, path: str, secret: str,
            access_key: str, amz_date: str, expires: int) -> dict:
    date = amz_date[:8]
    scope = f"{date}/{REGION}/s3/aws4_request"
    q = {"X-Amz-Algorithm": auth.ALGORITHM,
         "X-Amz-Credential": f"{access_key}/{scope}",
         "X-Amz-Date": amz_date, "X-Amz-Expires": str(expires),
         "X-Amz-SignedHeaders": "host"}
    canon = "\n".join([method, path, _cq(q), f"host:{host}\n", "host",
                       auth.UNSIGNED])
    sts = "\n".join([auth.ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    q["X-Amz-Signature"] = hmac.new(
        auth.signing_key(secret, date, REGION), sts.encode(),
        hashlib.sha256).hexdigest()
    return q


def chunked_body(headers: dict, chunks: list[bytes], secret: str) -> bytes:
    seed = headers["Authorization"].split("Signature=")[1]
    amz_date = headers["x-amz-date"]
    scope = f"{amz_date[:8]}/{REGION}/s3/aws4_request"
    ctx = auth.AuthContext(AK, auth.signing_key(secret, amz_date[:8],
                                                REGION),
                           scope, amz_date, seed, "")
    out, prev = bytearray(), seed
    for data in list(chunks) + [b""]:
        prev = ctx.chunk_signature(prev, data)
        out += f"{len(data):x};chunk-signature={prev}\r\n".encode()
        out += data + b"\r\n"
    return bytes(out)


def _verdict(mod, method, path, query, headers, payload):
    try:
        ctx = mod.SigV4Verifier({AK: SK, "OTHER": "OTHERSECRET"}).verify(
            method, path, query, headers, payload)
    except mod.AuthError as e:
        return ("err", e.code)
    return ("ok", ctx.access_key, ctx.seed_signature, ctx.content_sha256)


def _decode_verdict(mod, body, headers, with_ctx: bool):
    ctx = None
    if with_ctx:
        try:
            ctx = mod.SigV4Verifier({AK: SK}).verify(
                "PUT", "/b/k", {}, headers, None)
        except mod.AuthError as e:
            return ("err", e.code)
    try:
        return ("ok", mod.decode_aws_chunked(body, ctx))
    except mod.AuthError as e:
        return ("err", e.code)
    except asyncio.IncompleteReadError:
        # a body cut inside a chunk's data: the gateway answers it as
        # IncompleteBody (gateway.py _store_stream_inner)
        return ("err", "IncompleteReadError")


def _signed_cases(rng: random.Random):
    keys = ["k", "a/b/c.bin", "sp ace", "a%2Fb", "ü-ñ", "x" * 40]
    for i in range(60):
        method = rng.choice(["GET", "PUT", "DELETE", "HEAD", "POST"])
        path = "/" + urllib.parse.quote(f"b{rng.randrange(3)}/"
                                        + rng.choice(keys), safe="/%")
        query = rng.choice([{}, {"uploads": ""},
                            {"partNumber": "2", "uploadId": "u1"},
                            {"prefix": "a/", "delimiter": "/"}])
        payload = rng.choice([auth.UNSIGNED, hashlib.sha256(
            rng.randbytes(20)).hexdigest(), auth.STREAMING])
        secret = SK if rng.random() < 0.6 else "WRONG"
        access_key = rng.choice([AK, AK, "OTHER", "NOPE"])
        if access_key == "OTHER" and secret == SK:
            secret = "OTHERSECRET"
        skew = rng.choice([0, 0, 0, 300, -300, 3600, -3600])
        h = sign_headers(method, "gw:8333", path, query, payload, secret,
                         access_key, _amz_date(skew))
        tamper = rng.randrange(6)
        vpath, vquery = path, dict(query)
        if tamper == 0:
            vpath = path + "x"
        elif tamper == 1:
            vquery["extra"] = "1"
        elif tamper == 2:
            h["Authorization"] = h["Authorization"].replace(
                "SignedHeaders=", "SignedHdrs=")
        elif tamper == 3:
            h["x-amz-date"] = "not-a-date"
        yield method, vpath, vquery, h, None
    for i in range(30):
        path = f"/b/k{i}"
        secret = SK if rng.random() < 0.7 else "WRONG"
        expires = rng.choice([1, 60, 3600, 604800, 604801, 0])
        skew = rng.choice([0, 0, -120, -7200, 1800])
        q = presign("GET", "gw:8333", path, secret, AK, _amz_date(skew),
                    expires)
        if rng.random() < 0.2:
            q["X-Amz-Signature"] = q["X-Amz-Signature"][::-1]
        yield "GET", path, q, {"host": "gw:8333"}, None
    yield "GET", "/b/k", {}, {}, None
    yield "GET", "/b/k", {}, {"Authorization": "Basic Zm9vOmJhcg=="}, None


def test_sigv4_verdicts_equal_the_reference():
    rng = random.Random(12)
    verdicts = []
    for method, path, query, headers, payload in _signed_cases(rng):
        ours = _verdict(auth, method, path, query, headers, payload)
        theirs = _verdict(ref_auth, method, path, query, headers, payload)
        assert ours == theirs, (method, path, query, headers)
        verdicts.append(ours[0] if ours[0] == "ok" else ours[1])
    # the seeded set reaches every verdict, not only refusals
    assert {"ok", "SignatureDoesNotMatch", "InvalidAccessKeyId",
            "RequestTimeTooSkewed", "AuthorizationHeaderMalformed",
            "AuthorizationQueryParametersError",
            "AccessDenied"} <= set(verdicts)


def test_aws_chunked_verdicts_equal_the_reference():
    rng = random.Random(13)
    seen = set()
    for i in range(40):
        h = sign_headers("PUT", "gw:8333", "/b/k", {}, auth.STREAMING, SK,
                         AK, _amz_date())
        chunks = [rng.randbytes(rng.randrange(1, 3000))
                  for _ in range(rng.randrange(1, 5))]
        body = chunked_body(h, chunks, SK)
        kind = i % 8
        if kind == 1:  # truncated: no final 0-size chunk
            body = body[:body.rindex(b"0;chunk-signature=")]
        elif kind == 2:  # a tampered data byte
            j = body.index(b"\r\n") + 2
            body = body[:j] + bytes([body[j] ^ 1]) + body[j + 1:]
        elif kind == 3:  # a bad chunk signature
            body = body.replace(b"chunk-signature=", b"chunk-signature=0",
                                1)
        elif kind == 4:  # a chunk signed with the wrong secret
            body = chunked_body(h, chunks, "WRONG")
        elif kind == 5:  # a size over the 16 MiB cap
            body = b"2000000;chunk-signature=00\r\n" + body
        elif kind == 6:  # a header that is not hex
            body = b"zz;chunk-signature=00\r\n" + body
        elif kind == 7:  # cut inside a chunk's data
            body = body[:body.index(b"\r\n") + 3]
        for with_ctx in (True, False):
            ours = _decode_verdict(auth, body, h, with_ctx)
            theirs = _decode_verdict(ref_auth, body, h, with_ctx)
            assert ours == theirs, (i, with_ctx)
            seen.add(ours[0] if ours[0] == "ok" else ours[1])
            if kind == 0:
                assert ours == ("ok", b"".join(chunks))
    assert {"ok", "IncompleteBody", "SignatureDoesNotMatch",
            "InvalidRequest", "IncompleteReadError"} <= seen
    assert auth.is_aws_chunked({"x-amz-content-sha256": auth.STREAMING})
    assert not auth.is_aws_chunked({})


# --- twins ------------------------------------------------------------------

_MASKED_TAGS = ("LastModified", "CreationDate", "Initiated", "UploadId",
                "Location", "creationdate", "getlastmodified", "href")


def _mask_xml(body: bytes, masked=_MASKED_TAGS) -> bytes:
    if not body.startswith(b"<?xml"):
        return body
    root = ET.fromstring(body)
    for el in root.iter():
        tag = el.tag.rsplit("}", 1)[-1]
        if tag in masked and el.text and (
                tag != "href" or el.text.startswith("opaquelocktoken:")):
            el.text = "masked"
    return ET.tostring(root)


async def _call(out: list, http, method: str, url: str, *, label: str,
                **kw) -> tuple[int, bytes]:
    async with http.request(method, url, **kw) as r:
        body = await r.read()
        hdrs = {k: r.headers[k] for k in ("ETag", "Content-Range",
                                          "Content-Length", "Content-Type",
                                          "Allow", "DAV", "Retry-After")
                if k in r.headers}
        params = dict(kw.get("params") or {})
        if "uploadId" in params:
            # a NoSuchUpload message names the id
            body = body.replace(params["uploadId"].encode(), b"masked")
            params["uploadId"] = "masked"
        sent = {k: re.sub(r"^http://[^/]+", "http://masked", v)
                for k, v in (kw.get("headers") or {}).items()}
        out.append([method, label, params, sent, r.status, hdrs,
                    _mask_xml(body)])
        return r.status, body


def _upload_id(body: bytes) -> str:
    return next(el.text for el in ET.fromstring(body).iter()
                if el.tag.endswith("UploadId"))


async def _s3_transcript(http, base: str) -> list:
    rng = random.Random(31)
    out: list = []

    async def call(method, path, **kw):
        return await _call(out, http, method, base + path, label=path,
                           **kw)

    objs = {f"{d}/f{i}.bin": rng.randbytes(rng.choice(
        [0, 1, 100, 1024, 1025, 3000, 5000]))
        for i, d in enumerate(["a", "a/b", "a/b", "c", "c", "a", "d/e/f"])}
    await call("PUT", "/bk1")
    await call("PUT", "/bk2")
    await call("GET", "/")
    await call("HEAD", "/bk1")
    await call("HEAD", "/nobucket")
    await call("PUT", "/nobucket/x", data=b"x")
    for key, data in sorted(objs.items()):
        await call("PUT", f"/bk1/{key}", data=data,
                   headers={"Content-Type": "application/octet-stream"})
    await call("PUT", "/bk1/typed.txt", data=b"hello",
               headers={"Content-Type": "text/plain"})
    for key, data in sorted(objs.items()):
        await call("GET", f"/bk1/{key}")
        await call("HEAD", f"/bk1/{key}")
        n = len(data)
        if n:
            for start, end in ((0, 0), (n // 3, n - 1), (1000, 2100),
                               (n - 1, n + 50)):
                await call("GET", f"/bk1/{key}",
                           headers={"Range": f"bytes={start}-{end}"})
            await call("GET", f"/bk1/{key}", headers={"Range": "bytes=-70"})
        await call("GET", f"/bk1/{key}",
                   headers={"Range": f"bytes={n + 10}-{n + 20}"})
    for params in ({}, {"prefix": "a/"}, {"prefix": "a/", "delimiter": "/"},
                   {"delimiter": "/"}, {"max-keys": "2"},
                   {"marker": "a/b/f2.bin"},
                   {"list-type": "2", "max-keys": "3"},
                   {"list-type": "2", "continuation-token": "c/f3.bin"},
                   {"prefix": "zz"}):
        await call("GET", "/bk1", params=params)
    await call("GET", "/bk1/nokey")
    await call("PUT", "/bk2/copied.bin",
               headers={"x-amz-copy-source": "/bk1/a/b/f1.bin"})
    await call("GET", "/bk2/copied.bin")
    await call("PUT", "/bk2/none.bin",
               headers={"x-amz-copy-source": "/bk1/missing"})
    # multipart: initiate, parts out of order, list, complete; and an abort
    _, body = await call("POST", "/bk2/mp/big.bin", params={"uploads": ""})
    uid = _upload_id(body)
    parts = [rng.randbytes(rng.choice([1024, 2500, 4096]))
             for _ in range(3)]
    for i in (2, 1, 3):
        await call("PUT", "/bk2/mp/big.bin",
                   params={"partNumber": str(i), "uploadId": uid},
                   data=parts[i - 1])
    await call("GET", "/bk2/mp/big.bin", params={"uploadId": uid})
    await call("GET", "/bk2", params={"uploads": ""})
    await call("POST", "/bk2/mp/big.bin", params={"uploadId": uid},
               data=b"<CompleteMultipartUpload/>")
    await call("GET", "/bk2/mp/big.bin")
    await call("GET", "/bk2/mp/big.bin", headers={"Range": "bytes=1000-5000"})
    _, body = await call("POST", "/bk2/mp/gone.bin", params={"uploads": ""})
    uid2 = _upload_id(body)
    await call("PUT", "/bk2/mp/gone.bin",
               params={"partNumber": "1", "uploadId": uid2}, data=b"zz")
    await call("DELETE", "/bk2/mp/gone.bin", params={"uploadId": uid2})
    await call("PUT", "/bk2/mp/gone.bin",
               params={"partNumber": "2", "uploadId": uid2}, data=b"zz")
    # bulk delete, then what is left
    keys = sorted(objs)[:4] + ["never/there"]
    doc = "<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>"
                               for k in keys) + "</Delete>"
    await call("POST", "/bk1", params={"delete": ""}, data=doc.encode())
    await call("GET", "/bk1")
    await call("DELETE", "/bk1/c/f4.bin")
    await call("DELETE", "/bk1/c/f4.bin")
    await call("GET", "/bk1", params={"prefix": "c/"})
    await call("DELETE", "/bk2")
    await call("GET", "/")
    await call("PATCH", "/bk1")
    return out


def test_s3_gateway_twin_of_the_reference(tmp_path):
    """The same requests to a reference S3Gateway and to the port's, 1 KiB
    chunks so that objects and parts span up to 5 chunks."""
    async def body():
        out = {}
        for name, cls, gw, filer in (
                ("ref", cluster_util.Cluster, RefS3Gateway, RefFiler),
                ("port", Cluster, S3Gateway, Filer)):
            async with cls(str(tmp_path / name), n_servers=2) as c:
                s3 = gw(filer("memory"), c.master.url, port=0,
                        chunk_size=1024)
                await s3.start()
                try:
                    out[name] = await _s3_transcript(c.http,
                                                     f"http://{s3.url}")
                finally:
                    await s3.stop()
        assert len(out["port"]) == len(out["ref"])
        for got, want in zip(out["port"], out["ref"]):
            assert got == want
    run(body())


async def _dav_transcript(http, base: str) -> list:
    rng = random.Random(41)
    out: list = []

    async def call(method, path, **kw):
        return await _call(out, http, method, base + path, label=path,
                           **kw)

    await call("OPTIONS", "/")
    for d in ("/t", "/t/a", "/t/b", "/t/a/c"):
        await call("MKCOL", d)
    await call("MKCOL", "/t")
    await call("MKCOL", "/no/parent")
    files = {f"/t/{d}/f{i}.bin": rng.randbytes(rng.choice(
        [0, 10, 500, 1024, 3000]))
        for i, d in enumerate(["a", "a", "b", "a/c", "b"])}
    for path, data in sorted(files.items()):
        await call("PUT", path, data=data)
    await call("PUT", "/t/a/f0.bin", data=b"overwritten")
    await call("PUT", "/missing/dir/f.bin", data=b"x")
    await call("PUT", "/t/a", data=b"x")
    for d in ("/", "/t", "/t/a", "/t/a/c"):
        await call("PROPFIND", d, headers={"Depth": "1"})
        await call("PROPFIND", d, headers={"Depth": "0"})
    await call("PROPFIND", "/t/b/f2.bin")
    await call("PROPFIND", "/nothing")
    await call("PROPPATCH", "/t/b/f2.bin", data=b"<x/>")
    for path in sorted(files):
        await call("GET", path)
        await call("GET", path, headers={"Range": "bytes=5-1500"})
    await call("GET", "/t/a")
    await call("MOVE", "/t/a/c", headers={"Destination": base + "/t/b/c"})
    await call("MOVE", "/t/b/c", headers={"Destination": base + "/t/a",
                                          "Overwrite": "F"})
    await call("COPY", "/t/b/f2.bin",
               headers={"Destination": base + "/t/f2copy.bin"})
    await call("COPY", "/t/b/f2.bin",
               headers={"Destination": base + "/t/f2copy.bin",
                        "Overwrite": "F"})
    await call("GET", "/t/f2copy.bin")
    await call("LOCK", "/t/b/f2.bin")
    await call("UNLOCK", "/t/b/f2.bin")
    await call("DELETE", "/t/b/c")
    await call("DELETE", "/t/b/c")
    await call("PROPFIND", "/t", headers={"Depth": "1"})
    return out


def test_webdav_twin_of_the_reference(tmp_path):
    """The same DAV requests to a reference WebDavServer and to the
    port's, 1 KiB chunks: equal statuses, headers, PROPFIND bodies and
    file bytes."""
    async def body():
        out = {}
        for name, cls, dav, filer in (
                ("ref", cluster_util.Cluster, RefWebDav, RefFiler),
                ("port", Cluster, WebDavServer, Filer)):
            async with cls(str(tmp_path / name), n_servers=1) as c:
                wd = dav(filer("memory"), c.master.url, port=0,
                         chunk_size=1024)
                await wd.start()
                try:
                    out[name] = await _dav_transcript(c.http,
                                                      f"http://{wd.url}")
                finally:
                    await wd.stop()
        assert len(out["port"]) == len(out["ref"])
        for got, want in zip(out["port"], out["ref"]):
            assert got == want
    run(body())


def _tree(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_replicate_twin_of_the_reference(tmp_path):
    """The same filer writes, overwrites and deletes, queued on a sqlite
    queue and replayed by replicate_from_queue into a LocalDirSink, in two
    passes (the progress file resumes): the mirrors are equal, file for
    file, and equal to what the filer holds."""
    rng = random.Random(51)
    writes = [(f"/docs/{rng.choice(['', 'a/', 'a/b/'])}f{i}.bin",
               rng.randbytes(rng.choice([5, 700, 2048, 5000])))
              for i in range(10)]

    async def body():
        mirrors, counts = {}, {}
        for name, cls, mods in (
                ("ref", cluster_util.Cluster,
                 (RefSqliteQueue, ref_attach, RefFilerSource,
                  RefLocalDirSink, RefReplicator, ref_replicate)),
                ("port", Cluster,
                 (SqliteQueue, attach_to_filer, FilerSource, LocalDirSink,
                  Replicator, replicate_from_queue))):
            queue_cls, attach, source, sink_cls, repl, replay = mods
            c = cls(str(tmp_path / name / "c"))
            c.with_filer = True
            c.filer_chunk_size = 1024
            async with c:
                queue = queue_cls(str(tmp_path / name / "q.db"))
                attach(c.filer.filer, queue)

                async def post(path, data):
                    async with c.http.post(f"http://{c.filer.url}{path}",
                                           data=data) as r:
                        assert r.status == 201, await r.text()

                for path, data in writes:
                    await post(path, data)
                await post("/outside/x.bin", b"not replicated")
                dest = str(tmp_path / name / "mirror")
                progress = str(tmp_path / name / "progress.json")
                counts[name] = []
                for step in range(2):
                    async with source(c.master.url, "/docs") as src:
                        sink = sink_cls(dest)
                        await sink.start()
                        counts[name].append(await replay(
                            queue, repl(src, sink), progress, once=True))
                        await sink.close()
                    if step == 0:
                        await post(writes[0][0], b"overwritten")
                        async with c.http.delete(
                                f"http://{c.filer.url}{writes[1][0]}") as r:
                            assert r.status == 204
                mirrors[name] = _tree(dest)
                queue.close()
        assert counts["port"] == counts["ref"]
        assert mirrors["port"] == mirrors["ref"]
        want = {p[len("/docs/"):]: d for p, d in writes[2:]}
        want[writes[0][0][len("/docs/"):]] = b"overwritten"
        assert mirrors["port"] == want
    run(body())


@pytest.mark.parametrize("mod", [auth, ref_auth], ids=["port", "ref"])
def test_chunk_signature_chain_is_the_sdk_chain(mod):
    """AuthContext.chunk_signature, from either package, gives the chain
    an SDK sends (the string to sign of chunked_reader_v4.go)."""
    key = mod.signing_key(SK, "20260101", REGION)
    ctx = mod.AuthContext(AK, key, f"20260101/{REGION}/s3/aws4_request",
                          "20260101T000000Z", "seed", "")
    sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", "20260101T000000Z",
                     f"20260101/{REGION}/s3/aws4_request", "seed",
                     hashlib.sha256(b"").hexdigest(),
                     hashlib.sha256(b"data").hexdigest()])
    assert ctx.chunk_signature("seed", b"data") == hmac.new(
        key, sts.encode(), hashlib.sha256).hexdigest()
