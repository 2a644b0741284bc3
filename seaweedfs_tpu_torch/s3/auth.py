"""AWS Signature V4 verification + aws-chunked payload decoding.

Reference: weed/s3api/s3api_auth.go:15-85 (auth-type detection: header
signature v4, presigned query v4, anonymous) and chunked_reader_v4.go
(streaming chunk-signature verification for
STREAMING-AWS4-HMAC-SHA256-PAYLOAD uploads).

A copy of seaweedfs_tpu/s3/auth.py in the PyTorch port.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from datetime import datetime, timedelta, timezone

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED = "UNSIGNED-PAYLOAD"
STREAMING = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"

# Largest accepted aws-chunked chunk: SDKs send 8KB-1MB chunks; 16MB
# bounds the per-chunk buffering a client-declared size can force.
MAX_CHUNK_SIZE = 16 * 1024 * 1024


class AuthError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _canonical_query(query: "dict[str, str] | list[tuple[str, str]]",
                     drop_signature: bool = False) -> str:
    items = (query.items() if isinstance(query, dict) else query)
    pairs = sorted(
        (urllib.parse.quote(k, safe="-_.~"),
         urllib.parse.quote(v, safe="-_.~"))
        for k, v in items
        if not (drop_signature and k == "X-Amz-Signature"))
    return "&".join(f"{k}={v}" for k, v in pairs)


def _canonical_request(method: str, path: str, cq: str,
                       signed_headers: list[str],
                       headers, payload_hash: str) -> str:
    """`path` must be the RAW (still percent-encoded) request path: S3
    SigV4 signs it verbatim, and requoting a decoded path corrupts keys
    whose encoding is not a decode-requote fixed point (a%2Fb)."""
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([method, path, cq,
                      canon_headers, ";".join(signed_headers),
                      payload_hash])


def _string_to_sign(amz_date: str, scope: str, canonical: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope,
                      hashlib.sha256(canonical.encode()).hexdigest()])


class AuthContext:
    """Result of a successful verification: everything the streaming
    chunk-signature check needs (chunked_reader_v4.go keeps the same
    state: seed signature, signing key, date/scope)."""

    def __init__(self, access_key: str, key: bytes, scope: str,
                 amz_date: str, seed_signature: str,
                 content_sha256: str):
        self.access_key = access_key
        self.key = key
        self.scope = scope
        self.amz_date = amz_date
        self.seed_signature = seed_signature
        self.content_sha256 = content_sha256

    _EMPTY_SHA = hashlib.sha256(b"").hexdigest()

    def chunk_signature(self, prev_sig: str, data: bytes) -> str:
        sts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", self.amz_date, self.scope,
            prev_sig, self._EMPTY_SHA,
            hashlib.sha256(data).hexdigest()])
        return hmac.new(self.key, sts.encode(), hashlib.sha256).hexdigest()


class SigV4Verifier:
    """Verifies header-based and presigned V4 requests against a static
    identity table {access_key: secret_key} (weed s3 identities model)."""

    def __init__(self, identities: dict[str, str]):
        self.identities = identities

    # -- helpers ----------------------------------------------------------

    def auth_type(self, headers, query) -> str:
        auth = headers.get("Authorization", "")
        if auth.startswith(ALGORITHM):
            return "header"
        if query.get("X-Amz-Algorithm") == ALGORITHM:
            return "presigned"
        if auth:
            return "unsupported"
        return "anonymous"

    def verify(self, method: str, path: str, query, headers,
               payload_hash: str | None) -> "AuthContext":
        """Returns the authenticated AuthContext. Raises AuthError.

        `query` may be a dict or a list of (key, value) pairs — pass the
        pair list when duplicate query keys are possible (dict would
        collapse them and break the canonical query string)."""
        qd = query if isinstance(query, dict) else dict(query)
        kind = self.auth_type(headers, qd)
        if kind == "anonymous":
            raise AuthError("AccessDenied", "anonymous access denied")
        if kind == "unsupported":
            raise AuthError("AccessDenied",
                            "unsupported authorization scheme")
        if kind == "presigned":
            return self._verify_presigned(method, path, query, qd,
                                          headers)
        return self._verify_header(method, path, query, headers,
                                   payload_hash)

    def _secret_for(self, access_key: str) -> str:
        try:
            return self.identities[access_key]
        except KeyError:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key!r}") from None

    def _verify_header(self, method, path, query, headers,
                       payload_hash) -> str:
        auth = headers.get("Authorization", "")
        parts = dict(
            p.strip().split("=", 1)
            for p in auth[len(ALGORITHM):].strip().split(",") if "=" in p)
        try:
            cred = parts["Credential"]
            signed = parts["SignedHeaders"].lower().split(";")
            got_sig = parts["Signature"]
        except KeyError as e:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"missing {e} in Authorization") from None
        try:
            access_key, date, region, service, _ = cred.split("/", 4)
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"bad Credential {cred!r}") from None
        secret = self._secret_for(access_key)
        amz_date = headers.get("x-amz-date", headers.get("X-Amz-Date", ""))
        # clock-skew window: an unexpiring signature would make any
        # captured request replayable forever (AWS allows 15 minutes)
        try:
            t0 = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=timezone.utc)
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"bad x-amz-date {amz_date!r}") from None
        if abs((datetime.now(timezone.utc) - t0).total_seconds()) > 900:
            raise AuthError("RequestTimeTooSkewed",
                            "request time too far from server time")
        payload = headers.get("x-amz-content-sha256", payload_hash
                              or UNSIGNED)
        scope = f"{date}/{region}/{service}/aws4_request"
        canonical = _canonical_request(
            method, path, _canonical_query(query), signed,
            _lower_headers(headers), payload)
        sts = _string_to_sign(amz_date, scope, canonical)
        key = signing_key(secret, date, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch",
                            "request signature mismatch")
        return AuthContext(access_key, key, scope, amz_date, want, payload)

    def _verify_presigned(self, method, path, query, qd,
                          headers) -> "AuthContext":
        cred = qd.get("X-Amz-Credential", "")
        try:
            access_key, date, region, service, _ = \
                urllib.parse.unquote(cred).split("/", 4)
        except ValueError:
            raise AuthError("AuthorizationQueryParametersError",
                            f"bad X-Amz-Credential {cred!r}") from None
        secret = self._secret_for(access_key)
        amz_date = qd.get("X-Amz-Date", "")
        # expiry check
        try:
            t0 = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=timezone.utc)
            expires = int(qd.get("X-Amz-Expires", "0"))
        except ValueError:
            raise AuthError("AuthorizationQueryParametersError",
                            "bad X-Amz-Date/X-Amz-Expires") from None
        # AWS bounds presigned lifetime to 7 days; without this a
        # credential holder could mint effectively non-expiring URLs
        if not 1 <= expires <= 604800:
            raise AuthError("AuthorizationQueryParametersError",
                            "X-Amz-Expires must be in 1..604800")
        now = datetime.now(timezone.utc)
        # a far-future X-Amz-Date would extend the lifetime past the
        # X-Amz-Expires cap; apply the header-auth 15-minute skew window
        if (t0 - now).total_seconds() > 900:
            raise AuthError("RequestTimeTooSkewed",
                            "X-Amz-Date too far in the future")
        if now > t0 + timedelta(seconds=expires):
            raise AuthError("AccessDenied", "request has expired")
        signed = qd.get("X-Amz-SignedHeaders", "host").split(";")
        scope = f"{date}/{region}/{service}/aws4_request"
        canonical = _canonical_request(
            method, path, _canonical_query(query, drop_signature=True),
            signed, _lower_headers(headers), UNSIGNED)
        sts = _string_to_sign(amz_date, scope, canonical)
        key = signing_key(secret, date, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, qd.get("X-Amz-Signature", "")):
            raise AuthError("SignatureDoesNotMatch",
                            "presigned signature mismatch")
        return AuthContext(access_key, key, scope, amz_date, want, UNSIGNED)


def _lower_headers(headers) -> dict:
    """Lower-cased header dict for canonicalization. SigV4 requires
    repeated headers to be comma-joined (after whitespace folding), so a
    multidict source (aiohttp CIMultiDict) must not collapse to the last
    value — a client legitimately signing a duplicated header (repeated
    x-amz-meta-*) would get a spurious SignatureDoesNotMatch."""
    if hasattr(headers, "getall"):
        out: dict = {}
        for k in headers.keys():
            lk = k.lower()
            if lk not in out:
                out[lk] = ",".join(
                    " ".join(v.split()) for v in headers.getall(k))
        return out
    return {k.lower(): v for k, v in headers.items()}


def decode_aws_chunked(body: bytes,
                       ctx: "AuthContext | None" = None) -> bytes:
    """Whole-buffer convenience wrapper over AwsChunkedDecoder (single
    framing implementation; same validation rules)."""
    import asyncio
    import io

    class _Reader:
        def __init__(self, data: bytes):
            self._f = io.BytesIO(data)

        async def readline(self) -> bytes:
            return self._f.readline()

        async def read(self, n: int) -> bytes:
            return self._f.read(n)

        async def readexactly(self, n: int) -> bytes:
            data = self._f.read(n)
            if len(data) != n:
                raise asyncio.IncompleteReadError(data, n)
            return data

    async def run() -> bytes:
        return await AwsChunkedDecoder(_Reader(body), ctx).read()

    return asyncio.run(run())


class AwsChunkedDecoder:
    """Streaming decoder over an aiohttp StreamReader for
    STREAMING-AWS4-HMAC-SHA256-PAYLOAD bodies (chunked_reader_v4.go):
    strips the `<hex-size>;chunk-signature=<sig>\\r\\n ... \\r\\n` framing
    and exposes the same `await read(n)` surface the store path uses.

    With an AuthContext, every chunk signature is verified against the
    AWS4-HMAC-SHA256-PAYLOAD chain seeded by the request signature — a
    tampered or reordered chunk raises AuthError mid-stream. Without one
    (anonymous gateway), only the framing is parsed."""

    def __init__(self, raw, ctx: "AuthContext | None" = None):
        self.raw = raw
        self.ctx = ctx
        self.prev_sig = ctx.seed_signature if ctx else ""
        self.buf = b""
        self.done = False

    async def _next_chunk(self) -> None:
        line = await self.raw.readline()
        while line in (b"\r\n", b"\n"):
            line = await self.raw.readline()
        if not line:
            # EOF before the terminal 0-size chunk: the stream's sealing
            # signature was never presented — a truncated body must not
            # be stored as a complete object
            raise AuthError("IncompleteBody",
                            "stream ended before the final chunk")
        header = line.strip().decode("ascii", "replace")
        size_hex, _, rest = header.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise AuthError("IncompleteBody",
                            f"bad chunk header {header[:40]!r}") from None
        if size < 0 or size > MAX_CHUNK_SIZE:
            # the declared size is buffered via readexactly before its
            # signature can be checked; an attacker-controlled multi-GB
            # claim must not force unbounded gateway memory (streaming
            # bodies bypass aiohttp's client_max_size)
            raise AuthError("InvalidRequest",
                            f"chunk size {size} exceeds {MAX_CHUNK_SIZE}")
        sig = ""
        for kv in rest.split(";"):
            if kv.startswith("chunk-signature="):
                sig = kv[len("chunk-signature="):]
        data = await self.raw.readexactly(size) if size else b""
        if size:
            await self.raw.readexactly(2)  # chunk-trailing \r\n
        if self.ctx is not None:
            want = self.ctx.chunk_signature(self.prev_sig, data)
            if not hmac.compare_digest(want, sig):
                raise AuthError("SignatureDoesNotMatch",
                                "chunk signature mismatch")
            self.prev_sig = want
        if size == 0:
            while True:  # swallow trailers until the blank terminator
                t = await self.raw.readline()
                if t in (b"", b"\r\n", b"\n"):
                    break
            self.done = True
        else:
            self.buf = data

    async def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while not self.done and (n < 0 or len(out) < n):
            if not self.buf:
                await self._next_chunk()
                if self.done or not self.buf:
                    break
            take = len(self.buf) if n < 0 else min(len(self.buf),
                                                   n - len(out))
            out += self.buf[:take]
            self.buf = self.buf[take:]
        return bytes(out)


def is_aws_chunked(headers) -> bool:
    return (headers.get("x-amz-content-sha256") == STREAMING
            or "aws-chunked" in headers.get("Content-Encoding", ""))
