"""Named fault-injection points ("failpoints") for the whole cluster.

Reference: the reference tree has no fault-injection layer at all — a
stalled or lying peer can only be reproduced with external tooling.
This module is the missing harness: code plants *named sites* on the
needle write/read path, the heartbeat, the worker sibling proxy, the
replicated-write fan-out and the replication sinks; tests and the chaos
harness (tools/chaos.py) *arm* those sites with an action.

Actions (spec grammar ``action[=arg][:count][@probability]``):

    error          raise/return an injected error (arg = HTTP status)
    latency=MS     add MS milliseconds of delay, then proceed normally
    truncate       cut the payload (arg = keep-fraction, default 0.5);
                   on the volume read path this serves a partial body
                   with a full Content-Length, then drops the socket
    drop           sever the connection / raise a connection error
    flip           silently corrupt the payload: XOR 0xFF into the
                   first N bytes (arg = N, default 1) — bit-rot the
                   EC scrubber must detect (payload sites only; a
                   non-payload site treats it as a no-op)

``count`` bounds how many times the site fires before auto-disarming
(default 1; ``*`` = unlimited); ``@probability`` makes each pass fire
with that chance (e.g. ``@0.05`` = 5%).

Arming:

    WEED_FAILPOINTS=store.read=error@0.05,volume.heartbeat=drop:3
    POST  /debug/failpoints?site=store.write&spec=latency=200:10
    GET   /debug/failpoints                  (list armed sites + hits)
    DELETE /debug/failpoints[?site=...]      (disarm one / all)

Disarmed cost: every planted site is a single module-level dict
emptiness check (``if not _sites``) — no allocation, no lock, no
string formatting — so production hot paths pay nothing.

A copy of seaweedfs_tpu/util/failpoints.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time

__all__ = [
    "FailpointError", "FailpointDrop", "arm", "disarm", "reset",
    "armed", "list_armed", "take", "sync_fail", "fail", "corrupt",
    "pending", "load_env", "handle_debug",
]


class FailpointError(OSError):
    """Injected failure. Subclasses OSError on purpose: every network
    error path in the tree already handles OSError, so an injected
    fault flows through exactly the handling a real one would."""

    def __init__(self, site: str, status: int = 500):
        super().__init__(f"failpoint {site}")
        self.site = site
        self.status = status


class FailpointDrop(ConnectionResetError):
    """Injected connection drop (ConnectionResetError => OSError)."""

    def __init__(self, site: str):
        super().__init__(f"failpoint drop {site}")
        self.site = site


class _Armed:
    __slots__ = ("site", "action", "arg", "count", "prob", "hits")

    def __init__(self, site: str, action: str, arg: str,
                 count: int, prob: float):
        self.site = site
        self.action = action
        self.arg = arg
        self.count = count          # remaining fires; -1 = unlimited
        self.prob = prob
        self.hits = 0

    def to_dict(self) -> dict:
        return {"site": self.site, "action": self.action, "arg": self.arg,
                "count": self.count, "probability": self.prob,
                "hits": self.hits}


_sites: dict[str, _Armed] = {}
_lock = threading.Lock()
_rng = random.Random()

_ACTIONS = ("error", "latency", "truncate", "drop", "flip")


def parse_spec(site: str, spec: str) -> _Armed:
    """``action[=arg][:count][@probability]`` -> _Armed."""
    prob = 1.0
    if "@" in spec:
        spec, _, p = spec.rpartition("@")
        prob = float(p)
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"failpoint {site}: probability {p} "
                             f"not in (0, 1]")
    count = 1
    explicit_count = False
    head, _, tail = spec.rpartition(":")
    if head and (tail == "*" or tail.isdigit()):
        spec = head
        count = -1 if tail == "*" else int(tail)
        explicit_count = True
    if prob < 1.0 and not explicit_count:
        count = -1                  # probabilistic default: unlimited
    action, _, arg = spec.partition("=")
    if action not in _ACTIONS:
        raise ValueError(f"failpoint {site}: unknown action {action!r} "
                         f"(want one of {_ACTIONS})")
    if action == "latency":
        float(arg or 0)             # validate now, not at fire time
    if action == "error" and arg:
        int(arg)
    if action == "truncate" and arg:
        f = float(arg)
        if not 0.0 <= f < 1.0:
            raise ValueError(f"failpoint {site}: truncate fraction {arg} "
                             f"not in [0, 1)")
    if action == "flip" and arg:
        if int(arg) < 1:
            raise ValueError(f"failpoint {site}: flip byte count {arg} "
                             f"must be >= 1")
    return _Armed(site, action, arg, count, prob)


def arm(site: str, spec: str) -> None:
    """Arm `site` with `spec` (see module docstring for the grammar)."""
    a = parse_spec(site, spec)
    with _lock:
        _sites[site] = a


def disarm(site: str) -> bool:
    with _lock:
        return _sites.pop(site, None) is not None


def reset() -> None:
    with _lock:
        _sites.clear()


def armed() -> bool:
    return bool(_sites)


def pending(site: str) -> bool:
    """True when `site` is armed (without consuming a fire)."""
    return site in _sites


def list_armed() -> list[dict]:
    with _lock:
        return [a.to_dict() for a in _sites.values()]


def take(site: str) -> _Armed | None:
    """Consume one fire of `site` if armed (respecting probability and
    remaining count). The fast path is the unlocked emptiness check."""
    if not _sites:
        return None
    with _lock:
        a = _sites.get(site)
        if a is None:
            return None
        if a.prob < 1.0 and _rng.random() >= a.prob:
            return None
        if a.count == 0:
            del _sites[site]
            return None
        if a.count > 0:
            a.count -= 1
            if a.count == 0:
                del _sites[site]
        a.hits += 1
        return a


def _raise_for(a: _Armed) -> None:
    if a.action == "error":
        raise FailpointError(a.site, int(a.arg or 500))
    if a.action == "drop":
        raise FailpointDrop(a.site)
    # flip is payload-only: at a non-payload site it is a no-op (the
    # fire is still consumed, so counts stay honest)


def sync_fail(site: str) -> None:
    """Synchronous site (storage layer, executor threads): error/drop
    raise; latency blocks the calling thread; truncate is a no-op here
    (use corrupt() for payload sites)."""
    if not _sites:
        return
    a = take(site)
    if a is None:
        return
    if a.action == "latency":
        time.sleep(float(a.arg or 0) / 1000.0)
        return
    _raise_for(a)


async def fail(site: str) -> None:
    """Async site (event-loop paths): like sync_fail but latency does
    not block the loop."""
    if not _sites:
        return
    a = take(site)
    if a is None:
        return
    if a.action == "latency":
        await asyncio.sleep(float(a.arg or 0) / 1000.0)
        return
    _raise_for(a)


def corrupt(site: str, data: bytes) -> bytes:
    """Payload site: `truncate` cuts data to the armed keep-fraction
    (default half); `flip` XORs 0xFF into the first N bytes (silent
    bit-rot — same length, wrong content); other actions behave as in
    sync_fail."""
    if not _sites:
        return data
    a = take(site)
    if a is None:
        return data
    if a.action == "truncate":
        keep = float(a.arg) if a.arg else 0.5
        return data[:int(len(data) * keep)]
    if a.action == "flip":
        n = min(int(a.arg or 1), len(data))
        return bytes(b ^ 0xFF for b in data[:n]) + data[n:]
    if a.action == "latency":
        time.sleep(float(a.arg or 0) / 1000.0)
        return data
    _raise_for(a)
    return data


async def http_respond(req, site: str, *, body: bytes, headers: dict,
                       content_type: str, status: int):
    """Volume read-path site with response-level actions. Returns an
    aiohttp Response to send instead of the normal one, or None to
    proceed normally (latency sleeps first).

    `truncate` is the interesting one: it declares the full
    Content-Length, streams a prefix, then severs the socket — exactly
    the shape of a volume server dying mid-read, which is what the
    degraded-read failover path must survive."""
    if not _sites:
        return None
    a = take(site)
    if a is None:
        return None
    from aiohttp import web
    if a.action == "latency":
        await asyncio.sleep(float(a.arg or 0) / 1000.0)
        return None
    if a.action == "error":
        return web.json_response({"error": f"failpoint {site}"},
                                 status=int(a.arg or 500))
    if a.action == "drop":
        if req.transport is not None:
            req.transport.close()
        return web.Response(status=500)
    # truncate: full headers, partial body, dead socket
    keep = float(a.arg) if a.arg else 0.5
    resp = web.StreamResponse(status=status, headers={
        **headers, "Content-Length": str(len(body))})
    resp.content_type = content_type
    await resp.prepare(req)
    await resp.write(body[:int(len(body) * keep)])
    if req.transport is not None:
        req.transport.close()
    return resp


def load_env(value: str | None = None) -> int:
    """Arm sites from WEED_FAILPOINTS (site=spec,site=spec). Returns the
    number armed. Malformed entries raise — a chaos run silently
    arming nothing would 'pass' while testing nothing."""
    raw = os.environ.get("WEED_FAILPOINTS", "") if value is None else value
    n = 0
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        site, sep, spec = item.partition("=")
        if not sep or not site:
            raise ValueError(f"WEED_FAILPOINTS entry {item!r}: "
                             f"want site=spec")
        arm(site, spec)
        n += 1
    return n


async def handle_debug(req):
    """Shared /debug/failpoints admin endpoint for master, volume and
    filer servers:

        GET                       -> {"failpoints": [...]}
        POST ?site=S&spec=SPEC    -> arm one site
        POST {"S": "SPEC", ...}   -> arm many (JSON body)
        DELETE [?site=S]          -> disarm one / all
    """
    from aiohttp import web
    if req.method == "GET":
        return web.json_response({"failpoints": list_armed()})
    if req.method == "DELETE":
        site = req.query.get("site", "")
        if site:
            return web.json_response({"disarmed": disarm(site)})
        n = len(list_armed())
        reset()
        return web.json_response({"disarmed": n})
    if req.method in ("POST", "PUT"):
        specs: dict[str, str] = {}
        if req.query.get("site"):
            specs[req.query["site"]] = req.query.get("spec", "error")
        elif req.can_read_body:
            try:
                body = await req.json()
            except ValueError:
                return web.json_response({"error": "bad json"}, status=400)
            if not isinstance(body, dict):
                return web.json_response(
                    {"error": "want {site: spec, ...}"}, status=400)
            specs = {str(k): str(v) for k, v in body.items()}
        if not specs:
            return web.json_response({"error": "no site given"},
                                     status=400)
        try:
            for site, spec in specs.items():
                arm(site, spec)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"armed": list_armed()})
    return web.json_response({"error": "method not allowed"}, status=405)


# Arm from the environment at import: server subprocesses (chaos soak,
# -workers fleets) inherit WEED_FAILPOINTS without any plumbing.
if os.environ.get("WEED_FAILPOINTS"):
    load_env()
