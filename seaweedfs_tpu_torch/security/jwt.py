"""JWT (HS256) write tokens, minted by the master per fileId and checked by
volume servers.

Reference: weed/security/jwt.go:140-180 (SeaweedFileIdClaims), guard.go
(white-list + jwt guard), wired at master_server.go:71-78 and
volume_server_handlers_write.go:41-44. Implemented on stdlib hmac —
the token format is standard JWT HS256.

A copy of seaweedfs_tpu/security/jwt.py in the PyTorch port.
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import time


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def gen_jwt(signing_key: str, fid: str, expires_seconds: int = 10) -> str:
    """Mint a write token bound to one fileId (GenJwt, jwt.go:158-171)."""
    header = {"alg": "HS256", "typ": "JWT"}
    claims = {"exp": int(time.time()) + expires_seconds, "fid": fid}
    seg = _b64(json.dumps(header, separators=(",", ":")).encode()) + "." + \
        _b64(json.dumps(claims, separators=(",", ":")).encode())
    sig = hmac.new(signing_key.encode(), seg.encode(), hashlib.sha256)
    return seg + "." + _b64(sig.digest())


class JwtError(Exception):
    pass


def decode_jwt(signing_key: str, token: str) -> dict:
    """Validate signature + expiry; returns the claims."""
    try:
        head, payload, sig = token.split(".")
    except ValueError:
        raise JwtError("malformed token")
    seg = f"{head}.{payload}"
    want = hmac.new(signing_key.encode(), seg.encode(), hashlib.sha256)
    if not hmac.compare_digest(_b64(want.digest()), sig):
        raise JwtError("bad signature")
    claims = json.loads(_unb64(payload))
    if claims.get("exp", 0) < time.time():
        raise JwtError("expired")
    return claims


def check_write_jwt(signing_key: str, token: str, fid: str) -> None:
    """Raise JwtError unless token authorizes writing fid."""
    claims = decode_jwt(signing_key, token)
    if claims.get("fid") != fid:
        raise JwtError(f"token not valid for fid {fid}")


def get_jwt_from_request(headers, query) -> str:
    """Authorization: Bearer <t> or ?jwt= (GetJwt, jwt.go:173-180)."""
    auth = headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        return auth[7:]
    return query.get("jwt", "")
