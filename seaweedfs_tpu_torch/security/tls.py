"""Mutual-TLS transport config for all inter-server traffic.

Reference: weed/security/tls.go (LoadServerTLS/LoadClientTLS building
credentials from [grpc.<role>] cert/key + [grpc] ca in security.toml,
wired into every gRPC server/client) — here applied to the aiohttp
HTTP/1.1+SSE mesh instead of gRPC.

Process-global by design, like the reference's viper-loaded config: one
`configure()` (or `configure_from_toml()`) call at process start flips
every server listener to TLS-with-client-auth and every client session to
presenting its certificate; `url()` is the single place the scheme is
chosen, so call sites never hardcode http vs https.

A copy of seaweedfs_tpu/security/tls.py in the PyTorch port.
"""

from __future__ import annotations

import ssl

import aiohttp

_server_ctx: ssl.SSLContext | None = None
_client_ctx: ssl.SSLContext | None = None


def configure(ca: str, cert: str, key: str,
              require_client_cert: bool = True) -> None:
    """Enable mTLS: every peer presents `cert` signed by `ca`."""
    global _server_ctx, _client_ctx
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    sctx.load_verify_locations(ca)
    if require_client_cert:
        sctx.verify_mode = ssl.CERT_REQUIRED
    cctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cctx.load_cert_chain(cert, key)
    cctx.load_verify_locations(ca)
    # inter-server certs are issued to service roles, not hostnames
    # (the reference dials by ip:port with a role cert the same way)
    cctx.check_hostname = False
    _server_ctx = sctx
    _client_ctx = cctx


def configure_from_toml(path: str, cfg: dict | None = None) -> bool:
    """Apply the [tls] section of a security.toml (pass cfg when the
    file is already parsed); returns True if TLS was enabled.
    Absent/empty section leaves plaintext HTTP."""
    if cfg is None:
        from ..util.toml import tomllib
        if tomllib is None:
            raise SystemExit(
                "security.toml given but no TOML parser available "
                "(tomllib needs Python 3.11+, or install tomli)")
        with open(path, "rb") as f:
            cfg = tomllib.load(f)
    tls = cfg.get("tls", {})
    if not (tls.get("cert") or tls.get("ca") or tls.get("key")):
        return False
    missing = [k for k in ("ca", "cert", "key") if not tls.get(k)]
    if missing:
        raise SystemExit(
            f"security.toml [tls]: missing {', '.join(missing)} "
            f"(all of ca/cert/key are required to enable mTLS)")
    configure(tls["ca"], tls["cert"], tls["key"],
              require_client_cert=bool(tls.get("require_client_cert",
                                               True)))
    return True


def reset() -> None:
    global _server_ctx, _client_ctx
    _server_ctx = None
    _client_ctx = None


def enabled() -> bool:
    return _server_ctx is not None


def scheme() -> str:
    return "https" if enabled() else "http"


def url(hostport: str, path: str = "") -> str:
    return f"{scheme()}://{hostport}{path}"


def server_ctx() -> ssl.SSLContext | None:
    return _server_ctx


def client_ctx() -> ssl.SSLContext | None:
    """For non-aiohttp clients (urllib in executor threads)."""
    return _client_ctx


def client_connector() -> aiohttp.TCPConnector | None:
    """Connector presenting this process's client certificate; None in
    plaintext mode (aiohttp default connector)."""
    if _client_ctx is None:
        return None
    return aiohttp.TCPConnector(ssl=_client_ctx)


def make_session(**kwargs) -> aiohttp.ClientSession:
    """The one constructor for inter-server sessions: attaches the mTLS
    connector when enabled."""
    conn = client_connector()
    if conn is not None:
        kwargs.setdefault("connector", conn)
    return aiohttp.ClientSession(**kwargs)
