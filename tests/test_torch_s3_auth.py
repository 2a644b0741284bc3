"""S3 SigV4 auth (s3api_auth.go analog) + aws-chunked decoding tests.

The cases of tests/test_s3_auth.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse

import aiohttp
from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.s3.auth import (ALGORITHM, UNSIGNED, AuthError,
                                   SigV4Verifier, decode_aws_chunked,
                                   signing_key)

AK, SK = "TESTKEY", "TESTSECRET"
REGION = "us-east-1"


def _sign_headers(method: str, host: str, path: str,
                  query: dict | None = None,
                  payload_hash: str = UNSIGNED,
                  secret: str = SK, access_key: str = AK) -> dict:
    """Client-side V4 signing, the way an SDK does it."""
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    signed = sorted(headers)
    cq = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted((query or {}).items()))
    canon = "\n".join([
        method, path, cq,  # path = raw wire form, signed verbatim
        "".join(f"{h}:{headers[h]}\n" for h in signed),
        ";".join(signed), payload_hash])
    scope = f"{date}/{REGION}/s3/aws4_request"
    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, date, REGION), sts.encode(),
                   hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def _chunked_body(signed_headers: dict, chunks: list[bytes]) -> bytes:
    """Frame chunks as STREAMING-AWS4-HMAC-SHA256-PAYLOAD with a correct
    signature chain, the way an SDK streams."""
    from seaweedfs_tpu_torch.s3.auth import AuthContext

    auth = signed_headers["Authorization"]
    seed = auth.split("Signature=")[1]
    amz_date = signed_headers["x-amz-date"]
    date = amz_date[:8]
    scope = f"{date}/{REGION}/s3/aws4_request"
    ctx = AuthContext(AK, signing_key(SK, date, REGION), scope,
                      amz_date, seed, "")
    out = bytearray()
    prev = seed
    for data in list(chunks) + [b""]:
        sig = ctx.chunk_signature(prev, data)
        prev = sig
        out += f"{len(data):x};chunk-signature={sig}\r\n".encode()
        out += data
        out += b"\r\n"
    return bytes(out)


def test_verifier_accepts_valid_and_rejects_tampered():
    v = SigV4Verifier({AK: SK})
    h = _sign_headers("GET", "h:1", "/bucket/key")
    assert v.verify("GET", "/bucket/key", {}, h, None).access_key == AK

    # tampered path
    try:
        v.verify("GET", "/bucket/other", {}, h, None)
        raise AssertionError("accepted tampered path")
    except AuthError as e:
        assert e.code == "SignatureDoesNotMatch"

    # wrong secret
    h2 = _sign_headers("GET", "h:1", "/bucket/key", secret="WRONG")
    try:
        v.verify("GET", "/bucket/key", {}, h2, None)
        raise AssertionError("accepted wrong secret")
    except AuthError as e:
        assert e.code == "SignatureDoesNotMatch"

    # unknown access key
    h3 = _sign_headers("GET", "h:1", "/bucket/key", access_key="NOPE")
    try:
        v.verify("GET", "/bucket/key", {}, h3, None)
        raise AssertionError("accepted unknown key")
    except AuthError as e:
        assert e.code == "InvalidAccessKeyId"

    # anonymous
    try:
        v.verify("GET", "/bucket/key", {}, {}, None)
        raise AssertionError("accepted anonymous")
    except AuthError as e:
        assert e.code == "AccessDenied"


def test_decode_aws_chunked():
    payload = (b"5;chunk-signature=aaaa\r\nhello\r\n"
               b"6;chunk-signature=bbbb\r\n world\r\n"
               b"0;chunk-signature=cccc\r\n\r\n")
    assert decode_aws_chunked(payload) == b"hello world"


class _AuthS3Cluster(Cluster):
    async def __aenter__(self):
        await super().__aenter__()
        from seaweedfs_tpu_torch.filer.filer import Filer
        from seaweedfs_tpu_torch.s3.gateway import S3Gateway
        self.s3 = S3Gateway(Filer("memory"), self.master.url, port=0,
                            chunk_size=128 * 1024,
                            identities={AK: SK})
        await self.s3.start()
        return self

    async def __aexit__(self, *exc):
        await self.s3.stop()
        await super().__aexit__(*exc)


def test_s3_gateway_enforces_auth(tmp_path):
    async def body():
        async with _AuthS3Cluster(str(tmp_path)) as c:
            host = c.s3.url
            async with aiohttp.ClientSession() as http:
                # unsigned request is refused
                async with http.put(f"http://{host}/authb") as resp:
                    assert resp.status == 403
                    assert b"AccessDenied" in await resp.read()

                # signed bucket create + object put + get round trip
                h = _sign_headers("PUT", host, "/authb")
                async with http.put(f"http://{host}/authb",
                                    headers=h) as resp:
                    assert resp.status == 200, await resp.text()

                h = _sign_headers("PUT", host, "/authb/hello.txt")
                async with http.put(f"http://{host}/authb/hello.txt",
                                    headers=h, data=b"signed!") as resp:
                    assert resp.status == 200, await resp.text()

                h = _sign_headers("GET", host, "/authb/hello.txt")
                async with http.get(f"http://{host}/authb/hello.txt",
                                    headers=h) as resp:
                    assert resp.status == 200
                    assert await resp.read() == b"signed!"

                # bad signature refused
                h = _sign_headers("GET", host, "/authb/hello.txt",
                                  secret="WRONG")
                async with http.get(f"http://{host}/authb/hello.txt",
                                    headers=h) as resp:
                    assert resp.status == 403

                # aws-chunked upload (SDK streaming style) with a REAL
                # chunk-signature chain seeded by the request signature
                h = _sign_headers(
                    "PUT", host, "/authb/stream.bin",
                    payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
                h["Content-Encoding"] = "aws-chunked"
                chunked = _chunked_body(h, [b"chunked"])
                async with http.put(f"http://{host}/authb/stream.bin",
                                    headers=h, data=chunked) as resp:
                    assert resp.status == 200, await resp.text()
                h = _sign_headers("GET", host, "/authb/stream.bin")
                async with http.get(f"http://{host}/authb/stream.bin",
                                    headers=h) as resp:
                    assert await resp.read() == b"chunked"

                # tampered chunk data must be rejected mid-stream
                h = _sign_headers(
                    "PUT", host, "/authb/evil.bin",
                    payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
                h["Content-Encoding"] = "aws-chunked"
                bad = _chunked_body(h, [b"chunked"]).replace(
                    b"chunked\r\n", b"tampred\r\n", 1)
                async with http.put(f"http://{host}/authb/evil.bin",
                                    headers=h, data=bad) as resp:
                    assert resp.status == 403, await resp.text()

    run(body())


def test_presigned_expires_bounds():
    """X-Amz-Expires outside 1..604800 and far-future X-Amz-Date are
    rejected (AWS bounds presigned lifetime to 7 days)."""
    v = SigV4Verifier({AK: SK})
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]

    def q(**over):
        qd = {"X-Amz-Algorithm": ALGORITHM,
              "X-Amz-Credential": f"{AK}/{date}/{REGION}/s3/aws4_request",
              "X-Amz-Date": amz_date, "X-Amz-Expires": "300",
              "X-Amz-SignedHeaders": "host", "X-Amz-Signature": "00"}
        qd.update(over)
        return qd

    for bad in ("0", "-5", "604801", "99999999"):
        try:
            v.verify("GET", "/b/k", q(**{"X-Amz-Expires": bad}),
                     {"host": "h:1"}, None)
            raise AssertionError(f"accepted X-Amz-Expires={bad}")
        except AuthError as e:
            assert e.code == "AuthorizationQueryParametersError", bad

    future = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() + 3600))
    try:
        v.verify("GET", "/b/k", q(**{"X-Amz-Date": future}),
                 {"host": "h:1"}, None)
        raise AssertionError("accepted far-future X-Amz-Date")
    except AuthError as e:
        assert e.code == "RequestTimeTooSkewed"


def test_chunked_size_cap():
    """A client-declared multi-GB chunk must be refused before buffering
    (bounds gateway memory; streaming bypasses client_max_size)."""
    huge = (b"40000000;chunk-signature=aaaa\r\n")
    try:
        decode_aws_chunked(huge)
        raise AssertionError("accepted oversized chunk claim")
    except AuthError as e:
        assert e.code == "InvalidRequest"
    # boundary: a legitimate large-ish chunk still decodes
    ok = (b"5;chunk-signature=aaaa\r\nhello\r\n"
          b"0;chunk-signature=cccc\r\n\r\n")
    assert decode_aws_chunked(ok) == b"hello"


def test_multivalue_header_canonicalization():
    """Repeated headers must comma-join in the canonical form (SigV4 spec)
    instead of collapsing to the last value."""
    from multidict import CIMultiDict

    from seaweedfs_tpu_torch.s3.auth import _lower_headers

    md = CIMultiDict()
    md.add("X-Amz-Meta-Tag", "  a  b ")
    md.add("x-amz-meta-tag", "c")
    md.add("Host", "h:1")
    low = _lower_headers(md)
    assert low["x-amz-meta-tag"] == "a b,c"
    assert low["host"] == "h:1"

    # end-to-end: sign WITH the comma-joined value, verify with the
    # multidict carrying the duplicated header
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    headers = {"host": "h:1", "x-amz-date": amz_date,
               "x-amz-content-sha256": UNSIGNED,
               "x-amz-meta-tag": "a b,c"}
    signed = sorted(headers)
    canon = "\n".join([
        "GET", "/b/k", "",
        "".join(f"{h}:{headers[h]}\n" for h in signed),
        ";".join(signed), UNSIGNED])
    scope = f"{date}/{REGION}/s3/aws4_request"
    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    sig = hmac.new(signing_key(SK, date, REGION), sts.encode(),
                   hashlib.sha256).hexdigest()
    wire = CIMultiDict()
    wire.add("host", "h:1")
    wire.add("x-amz-date", amz_date)
    wire.add("x-amz-content-sha256", UNSIGNED)
    wire.add("X-Amz-Meta-Tag", "  a  b ")
    wire.add("X-Amz-Meta-Tag", "c")
    wire.add("Authorization",
             f"{ALGORITHM} Credential={AK}/{scope}, "
             f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    v = SigV4Verifier({AK: SK})
    assert v.verify("GET", "/b/k", {}, wire, None).access_key == AK
