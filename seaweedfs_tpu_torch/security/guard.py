"""IP white-list guard.

Reference: weed/security/guard.go:43-137 — handlers wrapped with
`Guard.WhiteList` admit everyone when the list is empty, otherwise only
peers whose IP matches an entry (exact IP or CIDR network); mismatches
get 401. Wired via -whiteList on master/volume
(weed/command/volume.go:87,125, master.go).

A copy of seaweedfs_tpu/security/guard.py in the PyTorch port.
"""

from __future__ import annotations

import ipaddress


class Guard:
    def __init__(self, white_list: "list[str] | tuple[str, ...]" = ()):
        self.nets: list = []
        self.ips: set = set()
        for entry in white_list or ():
            entry = entry.strip()
            if not entry:
                continue
            # validate every entry at parse time — a typo'd IP that can
            # never match would silently lock out the intended peer
            if "/" in entry:
                self.nets.append(
                    ipaddress.ip_network(entry, strict=False))
            else:
                self.ips.add(ipaddress.ip_address(entry))

    @property
    def empty(self) -> bool:
        return not self.ips and not self.nets

    def allows(self, ip: "str | None") -> bool:
        if self.empty:
            return True
        if not ip:
            return False
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return False
        return addr in self.ips or any(addr in net for net in self.nets)


def middleware(guard_getter, is_guarded, remote_of=None):
    """Shared aiohttp middleware: 401 when the live guard rejects the
    peer of a guarded request. guard_getter is late-bound so a server's
    guard can be swapped at runtime (tests do). remote_of lets -workers
    servers substitute the token-authenticated X-Forwarded-For peer for
    intra-host proxy hops (server/workers.py)."""
    from aiohttp import web

    @web.middleware
    async def white_list_mw(req, handler):
        g = guard_getter()
        remote = remote_of(req) if remote_of is not None else req.remote
        if not g.empty and is_guarded(req) and not g.allows(remote):
            return web.json_response({"error": "ip not in whitelist"},
                                     status=401)
        return await handler(req)

    return white_list_mw


def path_guarded(path: str, prefixes) -> bool:
    """True when `path` is one of the guarded endpoints.

    Matches exact path or a sub-path (prefix + '/'); a bare
    startswith() would also guard unrelated siblings like
    /submitfoo. Entries already ending in '/' guard the subtree."""
    for p in prefixes:
        if p.endswith("/"):
            if path.startswith(p):
                return True
        elif path == p or path.startswith(p + "/"):
            return True
    return False


def parse_white_list(spec: str) -> list[str]:
    """Comma-separated -whiteList flag value -> entries.

    Validates eagerly so a typo'd entry fails the command cleanly
    instead of dying later with an ipaddress traceback."""
    entries = [e.strip() for e in (spec or "").split(",") if e.strip()]
    for entry in entries:
        try:
            if "/" in entry:
                ipaddress.ip_network(entry, strict=False)
            else:
                ipaddress.ip_address(entry)
        except ValueError as e:
            raise SystemExit(
                f"invalid -whiteList entry {entry!r}: {e}") from None
    return entries
