"""Sharded filer metadata plane: prefix -> shard routing.

The filer was the last single-process tier: every S3/WebDAV/FUSE
metadata op funnelled through one event loop and one store file. This
module shards the namespace by directory prefix:

* ``ShardMap`` — the raft-committed routing table the master quorum
  owns (epoch + longest-prefix rules + shard ownership + in-flight
  move intents). Committed through the same log-ordered apply as the
  ``seq_reserve`` windows (master/election.py), so splits, moves and
  ownership changes are totally ordered and a deposed leader can never
  commit a conflicting map.
* ``apply_map_op`` — the pure map transition function the master's
  ``POST /cluster/shards`` handler runs before raft-committing the
  result under an epoch CAS.
* ``RouteCache`` — client-side cached map + owners learned from
  ``307 + X-Shard-Owner`` answers, folded in exactly like the learned-
  leader rotation in ``WeedClient._master_get``.
* ``ShardNode`` — the per-filer-process runtime: ownership
  enforcement, the paced online split executor, and the journaled
  two-phase cross-shard move (rename) with idempotent crash replay.

Reference seam: the per-shard store stays a pluggable ``FilerStore``
(filer2/filerstore.go) — each shard process owns its own instance.

A copy of seaweedfs_tpu/filer/shard.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import json
import time

import aiohttp

from ..security import tls
from ..util import events, failpoints, glog
from .entry import Entry
from .filer import Filer, FilerError

# split migration batch size (entries per paced hop)
BATCH = 256
# how long a cached client-side map stays fresh
MAP_TTL_S = 2.0
MiB = 1 << 20


def norm_path(p: str) -> str:
    p = "/" + (p or "").strip("/")
    while "//" in p:
        p = p.replace("//", "/")
    return p


def covers(prefix: str, path: str) -> bool:
    """True when `path` sits at or under directory `prefix`."""
    if prefix == "/":
        return True
    return path == prefix or path.startswith(prefix + "/")


class ShardMap:
    """Epoch-versioned prefix->shard routing table (JSON round-trip).

    ``rules`` are ``[prefix, shard_id]`` pairs; routing picks the
    longest matching prefix (the root rule ``["/", 0]`` always
    exists). ``owners`` maps shard id -> filer address. ``moves``
    holds in-flight split/rename intents — the raft-committed journal
    the executors replay idempotently after a crash.
    """

    def __init__(self, epoch: int = 0,
                 rules: list | None = None,
                 owners: dict | None = None,
                 moves: list | None = None):
        self.epoch = epoch
        self.rules = [[norm_path(p), int(s)] for p, s in
                      (rules or [["/", 0]])]
        self.owners = {int(k): v for k, v in (owners or {}).items()}
        self.moves = list(moves or [])

    # -- routing -------------------------------------------------------

    def route(self, path: str) -> int:
        """Longest-prefix match; the root rule guarantees a hit."""
        path = norm_path(path)
        best, best_len = 0, -1
        for prefix, sid in self.rules:
            if covers(prefix, path) and len(prefix) > best_len:
                best, best_len = sid, len(prefix)
        return best

    def owner_url(self, sid: int) -> str:
        return self.owners.get(sid, "")

    def matched_prefix(self, path: str) -> str:
        path = norm_path(path)
        best = "/"
        for prefix, sid in self.rules:
            if covers(prefix, path) and len(prefix) > len(best):
                best = prefix
        return best

    def shards_under(self, dir_path: str) -> set[int]:
        """Shards owning rule prefixes strictly below `dir_path` —
        their local listings contribute entries (at least the stub
        directory chain) to a merged listing of `dir_path`."""
        d = norm_path(dir_path)
        out: set[int] = set()
        for prefix, sid in self.rules:
            if prefix != d and covers(d, prefix):
                out.add(sid)
        return out

    def move_covering(self, path: str) -> dict | None:
        """The in-flight intent whose subtree covers `path`, if any."""
        path = norm_path(path)
        for mv in self.moves:
            root = mv.get("prefix") or mv.get("src") or ""
            if root and covers(root, path):
                return mv
        return None

    def move_by_id(self, mid: str) -> dict | None:
        for mv in self.moves:
            if mv.get("id") == mid:
                return mv
        return None

    # -- serialization -------------------------------------------------

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "rules": self.rules,
                "owners": {str(k): v for k, v in self.owners.items()},
                "moves": self.moves}

    @classmethod
    def from_dict(cls, d: dict | None) -> "ShardMap":
        d = d or {}
        return cls(epoch=int(d.get("epoch", 0)),
                   rules=d.get("rules") or [["/", 0]],
                   owners=d.get("owners") or {},
                   moves=d.get("moves") or [])

    def copy(self) -> "ShardMap":
        return ShardMap.from_dict(json.loads(json.dumps(self.to_dict())))


def apply_map_op(m: ShardMap, op: dict) -> ShardMap:
    """Pure transition: current map + operator/executor op -> new map.

    The master runs this on its APPLIED map, then raft-commits the
    result under a ``base_epoch`` CAS (election.py), so two leaders —
    or one deposed leader — can never interleave conflicting maps.
    Raises ValueError on an invalid transition (rendered as a 400).
    """
    n = m.copy()
    kind = op.get("op", "")
    if kind == "register":
        sid = int(op["shard"])
        n.owners[sid] = str(op["url"])
    elif kind == "set":
        # bootstrap / test hook: replace rules+owners wholesale
        if op.get("rules"):
            n.rules = [[norm_path(p), int(s)] for p, s in op["rules"]]
        if op.get("owners"):
            n.owners = {int(k): v for k, v in op["owners"].items()}
        if not any(p == "/" for p, _ in n.rules):
            raise ValueError("shard map must keep a root rule")
    elif kind == "split_intent":
        prefix = norm_path(op["prefix"])
        to = int(op["to"])
        frm = n.route(prefix)
        if frm == to:
            raise ValueError(f"{prefix} already routes to shard {to}")
        mid = f"split:{prefix}"
        if n.move_by_id(mid) is not None:
            return n                      # idempotent re-submit
        if n.move_covering(prefix) is not None:
            raise ValueError(f"a move already covers {prefix}")
        n.moves.append({"id": mid, "kind": "split", "prefix": prefix,
                        "from": frm, "to": to, "state": "copy",
                        "by": str(op.get("by", ""))})
    elif kind == "rename_intent":
        src, dst = norm_path(op["src"]), norm_path(op["dst"])
        mid = f"rename:{src}:{dst}"
        if n.move_by_id(mid) is not None:
            return n                      # idempotent re-submit
        if n.move_covering(src) or n.move_covering(dst):
            raise ValueError(f"a move already covers {src} or {dst}")
        n.moves.append({"id": mid, "kind": "rename", "src": src,
                        "dst": dst, "from": n.route(src),
                        "to": n.route(dst), "state": "copy",
                        "by": str(op.get("by", ""))})
    elif kind == "commit_move":
        mv = n.move_by_id(op["id"])
        if mv is None:
            raise ValueError(f"no such move {op['id']!r}")
        if mv["state"] == "copy":
            mv["state"] = "cleanup"
            if mv["kind"] == "split":
                # the one-raft-apply flip: routing cuts over atomically
                prefix = mv["prefix"]
                n.rules = [r for r in n.rules if r[0] != prefix]
                n.rules.append([prefix, mv["to"]])
    elif kind == "move_done":
        mv = n.move_by_id(op["id"])
        if mv is None:
            return n                      # idempotent completion
        n.moves.remove(mv)
    elif kind == "abort_move":
        mv = n.move_by_id(op["id"])
        if mv is not None:
            if mv["state"] != "copy":
                raise ValueError("cannot abort past the routing flip")
            n.moves.remove(mv)
    else:
        raise ValueError(f"unknown shard map op {kind!r}")
    return n


class RouteCache:
    """Client-side shard map: fetched from the masters with a short
    TTL, with owners learned from ``307 + X-Shard-Owner`` hints folded
    in (the learned-leader rotation discipline — a hint from the
    server that actually knows beats a stale cached map)."""

    def __init__(self, master_url: str = ""):
        self.master_seeds = [s.strip() for s in master_url.split(",")
                             if s.strip()]
        self.map = ShardMap()
        self._fetched = 0.0
        # prefix -> owner address learned from redirect hints; beats
        # the cached map until a fresher epoch arrives
        self.learned: dict[str, str] = {}
        self.learned_hits = 0

    def learn(self, prefix: str, owner: str, epoch: int = 0) -> None:
        if not owner:
            return
        self.learned[norm_path(prefix or "/")] = owner
        if epoch > self.map.epoch:
            self._fetched = 0.0           # our map is stale: refetch

    def owner_for(self, path: str) -> str:
        """Best-known owner address for `path` (may be "")."""
        path = norm_path(path)
        best, best_len = "", -1
        for prefix, owner in self.learned.items():
            if covers(prefix, path) and len(prefix) > best_len:
                best, best_len = owner, len(prefix)
        if best:
            self.learned_hits += 1
            return best
        return self.map.owner_url(self.map.route(path))

    async def refresh(self, http: aiohttp.ClientSession,
                      force: bool = False) -> ShardMap:
        if not self.master_seeds or (
                not force
                and time.monotonic() - self._fetched < MAP_TTL_S):
            return self.map
        last: Exception | None = None
        for seed in list(self.master_seeds):
            try:
                # chaos site: the shard-map fetch is a routed hop like
                # any other — an armed fault must degrade to the
                # cached/learned owners, never wedge the caller
                await failpoints.fail("filer.shard.route")
                async with http.get(tls.url(seed, "/cluster/shards"),
                                    timeout=aiohttp.ClientTimeout(
                                        total=5)) as resp:
                    body = await resp.json()
                if "epoch" in body:
                    fresh = ShardMap.from_dict(body)
                    if fresh.epoch >= self.map.epoch:
                        self.map = fresh
                        # a fresher committed map supersedes hearsay
                        self.learned.clear()
                    self._fetched = time.monotonic()
                    return self.map
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError, ValueError) as e:
                last = e
        if last is not None:
            glog.V(1).infof("shard map refresh failed: %s", last)
        return self.map


class GatewayRouter:
    """Bucket/path-granular shard routing for the S3/WebDAV gateways.

    A sharded gateway fleet runs one gateway per filer shard, each
    embedding that shard's ``Filer``. The router answers, per
    namespace path, the SIBLING gateway that owns it (or "" when the
    request is ours) so the gateway middleware can bounce foreign
    requests with ``307 + X-Shard-Owner``."""

    def __init__(self, shard_id: int, master_url: str,
                 peers: dict[int, str]):
        self.shard_id = shard_id
        self.routes = RouteCache(master_url)
        self.peers = dict(peers)          # shard id -> gateway address
        self.redirects = 0

    async def foreign_owner(self, http: aiohttp.ClientSession,
                            filer_path: str) -> str:
        m = await self.routes.refresh(http)
        sid = m.route(filer_path)
        if sid == self.shard_id:
            return ""
        return self.peers.get(sid, "")

    def matched_prefix(self, filer_path: str) -> str:
        return self.routes.map.matched_prefix(filer_path)


def merge_entry_lists(pages: list[list[Entry]], start_file: str,
                      inclusive: bool, limit: int,
                      sources: list[int] | None = None,
                      prefer: "ShardMap | None" = None) -> list[Entry]:
    """K-way merge of per-shard listing pages: global name order,
    every entry exactly once. ``sources[i]`` is the shard id page ``i``
    came from; a duplicate full_path (the dual-write window of an
    in-flight move) keeps the copy from the page whose SOURCE shard
    the map routes the path to, so a half-migrated entry never shows
    twice — and never shows its stale pre-move copy."""
    by_name: dict[str, tuple[bool, Entry]] = {}
    for i, page in enumerate(pages):
        src = sources[i] if sources and i < len(sources) else -1
        for e in page:
            name = e.name
            if start_file:
                if inclusive and name < start_file:
                    continue
                if not inclusive and name <= start_file:
                    continue
            routed = (prefer is not None and src >= 0
                      and prefer.route(e.full_path) == src)
            cur = by_name.get(name)
            if cur is None or (routed and not cur[0]):
                by_name[name] = (routed, e)
    ordered = [by_name[k][1] for k in sorted(by_name)]
    return ordered[:limit]


class ShardNode:
    """Per-filer-process shard runtime.

    Holds this process's view of the committed map (refresh loop +
    post-commit adoption), makes the ownership-enforcement decisions
    for the HTTP handlers, and drives the two background state
    machines: the paced online split executor and the journaled
    two-phase cross-shard move. Both replay idempotently from the
    raft-committed intent after a SIGKILL at any step."""

    def __init__(self, server, shard_id: int, shard_of: int,
                 peers: dict[int, str] | None = None,
                 split_mbps: float = 8.0):
        self.server = server              # FilerServer
        self.shard_id = shard_id
        self.shard_of = shard_of
        self.static_peers = dict(peers or {})
        self.routes = RouteCache(server.master_url)
        self.counters = {"local": 0, "redirect": 0, "forward": 0,
                         "merge": 0, "ingest": 0, "moved": 0,
                         "replayed": 0}
        from ..ec.scrub import TokenBucket
        self.bucket = TokenBucket(split_mbps * MiB)
        from .. import qos
        arb = qos.arbiter()
        if arb is not None:
            # PR-15 bandwidth arbiter: split migration is background
            # traffic — it yields to foreground pressure like repair
            self.bucket = arb.adopt("shard_move", self.bucket)
        self._http: aiohttp.ClientSession | None = None
        self._tasks: list[asyncio.Task] = []
        self._executor_wake = asyncio.Event()
        self._move_lock = asyncio.Lock()

    # -- lifecycle -----------------------------------------------------

    @property
    def map(self) -> ShardMap:
        return self.routes.map

    async def start(self) -> None:
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=30))
        await self._register()
        await self.routes.refresh(self._http, force=True)
        self._tasks.append(asyncio.create_task(self._refresh_loop()))
        self._tasks.append(asyncio.create_task(self._executor_loop()))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 — a dying executor
                # must not mask server stop, but stays visible
                glog.V(1).infof("shard %d task exit: %s",
                                self.shard_id, e)
        if self._http is not None:
            await self._http.close()

    async def _register(self) -> None:
        """Announce this shard's address into the committed map."""
        for attempt in range(20):
            try:
                if await self._map_op({"op": "register",
                                       "shard": self.shard_id,
                                       "url": self.server.url}):
                    return
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError, ValueError):
                pass
            await asyncio.sleep(min(0.25 * (attempt + 1), 2.0))
        glog.warning("shard %d: could not register with master %s",
                     self.shard_id, self.server.master_url)

    async def _map_op(self, op: dict) -> bool:
        """POST one map transition to the master (leader-chased) and
        adopt the committed map from the reply."""
        op = dict(op, by=self.server.url)
        seeds = list(self.routes.master_seeds) or [""]
        for seed in seeds:
            if not seed:
                continue
            try:
                # chaos site: the executor's commit hop — an armed
                # fault (or SIGKILL between hops) leaves the intent in
                # the committed map for idempotent replay
                await failpoints.fail("filer.shard.move")
                async with self._http.post(
                        tls.url(seed, "/cluster/shards"), json=op,
                        timeout=aiohttp.ClientTimeout(total=10),
                        allow_redirects=True) as resp:
                    body = await resp.json()
                if resp.status == 200 and "map" in body:
                    fresh = ShardMap.from_dict(body["map"])
                    if fresh.epoch >= self.map.epoch:
                        self.routes.map = fresh
                        self.routes.learned.clear()
                        self._note_epoch()
                    return True
                if resp.status == 400:
                    raise ValueError(body.get("error", "bad map op"))
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                glog.V(1).infof("shard map op via %s failed: %s", seed, e)
        return False

    def _note_epoch(self) -> None:
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FILER_SHARD_EPOCH.set(self.map.epoch)

    async def adopt_epoch(self, epoch: int) -> None:
        """A peer advertised a committed epoch ahead of ours (the
        post-flip poke): adopt it now instead of waiting out the
        refresh interval — a curl-level client must not ping-pong
        307s between two half-adopted shards."""
        if epoch <= self.map.epoch:
            return
        await self.routes.refresh(self._http, force=True)
        self._note_epoch()
        self._executor_wake.set()

    async def _poke_target(self, mv: dict) -> None:
        """Best-effort epoch push to the move's target: the flip is
        committed on the master, but the target only polls — failures
        here are covered by its refresh loop within MAP_TTL_S/2."""
        to = int(mv["to"])
        owner = self.static_peers.get(to) or self.map.owner_url(to)
        if not owner:
            return
        try:
            await self._peer_json(owner, "POST",
                                  "/__api__/shard/ingest",
                                  payload={"entries": [],
                                           "move": mv["id"],
                                           "epoch": self.map.epoch})
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            glog.V(1).infof("shard %d: epoch poke to %s failed: %s",
                            self.shard_id, owner, e)

    async def _refresh_loop(self) -> None:
        while True:
            await asyncio.sleep(MAP_TTL_S / 2)
            try:
                before = self.map.epoch
                await self.routes.refresh(self._http)
                self._note_epoch()
                if self.map.epoch != before or self._pending_moves():
                    self._executor_wake.set()
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                glog.V(1).infof("shard %d map refresh: %s", self.shard_id, e)

    # -- enforcement decisions (handlers consult these) ----------------

    def is_local(self, path: str) -> bool:
        return self.map.route(path) == self.shard_id

    def redirect_headers(self, path: str) -> dict | None:
        """Build the 307 hint headers for a foreign path, or None when
        the owner is unknown (caller answers 503, never a wrong 404)."""
        sid = self.map.route(path)
        owner = (self.static_peers.get(sid)
                 or self.map.owner_url(sid))
        if not owner:
            return None
        self.counters["redirect"] += 1
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FILER_SHARD_REQUESTS.labels("redirect").inc()
        return {"X-Shard-Owner": owner,
                "X-Shard-Prefix": self.map.matched_prefix(path),
                "X-Shard-Epoch": str(self.map.epoch)}

    def double_read_source(self, path: str) -> str:
        """During the cleanup window of a move TO this shard, a local
        miss double-routes to the old owner (never 404): the routing
        flip committed before the source finished its final copy
        pass + tombstone."""
        mv = self.map.move_covering(path)
        if (mv is not None and mv["kind"] == "split"
                and mv["state"] == "cleanup"
                and int(mv["to"]) == self.shard_id):
            sid = int(mv["from"])
            return self.static_peers.get(sid) or self.map.owner_url(sid)
        return ""

    # -- remote metadata ops (frames where channels exist, HTTP else) --

    async def _peer_json(self, owner: str, method: str, path: str,
                         params: dict | None = None,
                         payload: dict | None = None) -> dict:
        """One routed metadata hop to a peer shard. Rides the frame
        fabric when a channel to the peer exists (WeedClient.frame_hub
        probes once and remembers a downgrade), falling back to the
        resilient HTTP session."""
        # chaos site: EVERY peer-shard metadata hop, framed or HTTP
        # (callers — merge fan-out, double-read, ingest push — all
        # funnel through here)
        await failpoints.fail("filer.shard.route")
        body = b"" if payload is None else json.dumps(payload).encode()
        client = self.server.client
        if client is not None:
            framed = await client._frame_json(
                owner, method, path, params=params,
                headers={"content-type": "application/json"},
                body=body, timeout=15.0)
            if framed is not None and framed[0] == 200:
                return framed[2]
        async with self._http.request(
                method, tls.url(owner, path), params=params,
                data=body or None,
                headers={"Content-Type": "application/json"},
                timeout=aiohttp.ClientTimeout(total=15)) as resp:
            got = await resp.json()
            if resp.status != 200:
                raise OSError(
                    f"shard peer {owner} {path}: "
                    f"{got.get('error', resp.status)}")
            return got

    async def forward_lookup(self, owner: str, path: str) -> dict | None:
        """Routed lookup on a peer shard (double-read / merge hops)."""
        self.counters["forward"] += 1
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FILER_SHARD_REQUESTS.labels("forward").inc()
        # chaos site: every routed read hop
        await failpoints.fail("filer.shard.route")
        try:
            return await self._peer_json(
                owner, "GET", "/__api__/lookup",
                params={"path": path, "local": "1"})
        except OSError:
            return None

    async def peer_list(self, owner: str, dir_path: str,
                        start_file: str, inclusive: bool,
                        limit: int) -> list[Entry]:
        """One peer shard's local page of a merged listing."""
        self.counters["forward"] += 1
        # chaos site: the merged-listing fan-out hop
        await failpoints.fail("filer.shard.route")
        body = await self._peer_json(
            owner, "GET", "/__api__/list",
            params={"path": dir_path, "startFile": start_file,
                    "inclusive": "true" if inclusive else "false",
                    "limit": str(limit), "local": "1"})
        return [_entry_from_json(d) for d in body.get("entries", [])]

    async def merged_list(self, dir_path: str, start_file: str,
                          inclusive: bool, limit: int) -> list[Entry]:
        """Listing of an owned directory merged across every shard
        holding a rule below it (exactly-once, global name order)."""
        fan = self.map.shards_under(dir_path)
        mv = self.map.move_covering(dir_path)
        if mv is not None and mv.get("kind") == "split":
            fan |= {int(mv["from"]), int(mv["to"])}
        fan.discard(self.shard_id)
        local = self.server.filer.list_directory_entries(
            dir_path, start_file, inclusive, limit)
        if not fan:
            return local
        self.counters["merge"] += 1
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.FILER_SHARD_REQUESTS.labels("merge").inc()
        pages = [local]
        srcs = [self.shard_id]
        for sid in sorted(fan):
            owner = self.static_peers.get(sid) or self.map.owner_url(sid)
            if not owner:
                continue
            try:
                pages.append(await self.peer_list(
                    owner, dir_path, start_file, inclusive, limit))
                srcs.append(sid)
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                # a dead peer degrades the merge, visibly — callers
                # still get the local+reachable slice, never a 500
                glog.warning("merged list %s: shard %d (%s) "
                             "unreachable: %s", dir_path, sid, owner, e)
        return merge_entry_lists(pages, start_file, inclusive, limit,
                                 sources=srcs, prefer=self.map)

    async def ingest(self, entries: list[dict]) -> int:
        """Idempotent migration sink: insert entries into the LOCAL
        store, mtime-gated so a stale source copy never clobbers a
        write that already landed here post-flip."""
        n = 0
        filer = self.server.filer
        for d in entries:
            try:
                e = _entry_from_json(d)
                have = filer.find_entry(e.full_path)
                if have is not None and have.attr.mtime > e.attr.mtime:
                    continue
                filer.create_entry(e)
                n += 1
            except (FilerError, KeyError, ValueError) as err:
                glog.warning("shard ingest %r: %s",
                             d.get("FullPath", d.get("full_path")), err)
        self.counters["ingest"] += n
        return n

    async def cross_shard_rename(self, src: str, dst: str) -> None:
        """Journaled two-phase move, driven synchronously by the
        source shard's rename handler: raft-commit the intent, copy
        the subtree to the destination shard (paths rebased),
        raft-commit the flip, final catch-up + tombstone, done. A
        SIGKILL between ANY two steps leaves the committed intent for
        the executor loop to replay idempotently on restart."""
        src, dst = norm_path(src), norm_path(dst)
        if self.server.filer.find_entry(src) is None:
            raise ValueError(f"rename source {src} not found")
        if not await self._map_op({"op": "rename_intent",
                                   "src": src, "dst": dst}):
            raise OSError("could not raft-commit rename intent")
        mv = self.map.move_by_id(f"rename:{src}:{dst}")
        if mv is None:
            raise OSError("rename intent missing from committed map")
        async with self._move_lock:
            await self._drive(dict(mv))

    # -- the split / move executors ------------------------------------

    def _pending_moves(self) -> list[dict]:
        """Intents this shard executes: the SOURCE drives both kinds
        (it owns the entries being copied out)."""
        return [mv for mv in self.map.moves
                if int(mv.get("from", -1)) == self.shard_id]

    async def _executor_loop(self) -> None:
        while True:
            try:
                await asyncio.wait_for(self._executor_wake.wait(),
                                       timeout=MAP_TTL_S * 2)
            except asyncio.TimeoutError:
                pass
            self._executor_wake.clear()
            for mv in self._pending_moves():
                try:
                    async with self._move_lock:
                        await self._drive(dict(mv))
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError, ValueError) as e:
                    # the intent stays committed: the next wake (or a
                    # restarted process) replays it from its state
                    glog.warning("shard %d: move %s stalled: %s",
                                 self.shard_id, mv.get("id"), e)

    async def _drive(self, mv: dict) -> None:
        """Drive one intent to completion from whatever state the
        committed map says it is in (idempotent crash replay: every
        phase re-runs safely; tombstoning only ever starts after the
        copy-complete commit)."""
        mid, kind = mv["id"], mv["kind"]
        root = mv.get("prefix") or mv["src"]
        started = time.monotonic()
        if mv.get("state") == "copy":
            self.counters["replayed"] += 1
            copied = await self._copy_subtree(
                root, mv, dst_root=mv.get("dst"))
            if not await self._map_op({"op": "commit_move", "id": mid}):
                return                    # retry on next wake
            flip = dict(id=mid, phase="flip", shard=self.shard_id,
                        entries=copied,
                        seconds=round(time.monotonic() - started, 3))
            if kind == "split":
                events.record("shard_split", **flip)
            else:
                events.record("shard_move", **flip)
            await self._poke_target(mv)
            mv["state"] = "cleanup"
        if mv.get("state") == "cleanup":
            # final catch-up pass: anything written locally between the
            # last pass and the flip streams over before the tombstone
            await self._copy_subtree(root, mv, dst_root=mv.get("dst"))
            self._tombstone_subtree(root)
            if not await self._map_op({"op": "move_done", "id": mid}):
                return
            done = dict(id=mid, phase="done", shard=self.shard_id,
                        seconds=round(time.monotonic() - started, 3))
            if kind == "split":
                events.record("shard_split", **done)
            else:
                events.record("shard_move", **done)
            await self._poke_target(mv)

    def _walk_local(self, root: str) -> list[Entry]:
        """Depth-first local subtree snapshot (root entry included)."""
        filer = self.server.filer
        out: list[Entry] = []
        root_entry = filer.find_entry(root)
        if root_entry is not None and root != "/":
            out.append(root_entry)
        stack = [root]
        while stack:
            d = stack.pop()
            last = ""
            while True:
                page = filer.list_directory_entries(d, last, False, BATCH)
                if not page:
                    break
                for e in page:
                    out.append(e)
                    if e.is_directory:
                        stack.append(e.full_path)
                last = page[-1].name
                if len(page) < BATCH:
                    break
        return out

    async def _copy_subtree(self, root: str, mv: dict,
                            dst_root: str | None = None) -> int:
        """Stream the subtree at `root` to the intent's target shard
        in paced batches (token bucket — arbitrated background
        traffic, the 1309.0186 discipline). Rename intents rewrite the
        path prefix to `dst_root` on the way out."""
        to = int(mv["to"])
        owner = self.static_peers.get(to) or self.map.owner_url(to)
        if not owner:
            raise OSError(f"move {mv['id']}: shard {to} has no owner")
        entries = self._walk_local(root)
        sent = 0
        for i in range(0, len(entries), BATCH):
            batch = entries[i:i + BATCH]
            out = []
            for e in batch:
                d = _entry_to_json(e)
                if dst_root is not None:
                    d["FullPath"] = _rebase(e.full_path, root, dst_root)
                out.append(d)
            payload = {"entries": out, "move": mv["id"]}
            nbytes = sum(len(json.dumps(d)) for d in out)
            await self.bucket.consume(nbytes)
            # chaos site: every migration hop — a SIGKILL here leaves
            # the raft-committed intent to replay idempotently
            if mv["kind"] == "split":
                await failpoints.fail("filer.shard.split")
            else:
                await failpoints.fail("filer.shard.move")
            await self._peer_json(owner, "POST", "/__api__/shard/ingest",
                                  payload=payload)
            sent += len(out)
            self.counters["moved"] += len(out)
            from ..stats import metrics
            if metrics.HAVE_PROMETHEUS:
                metrics.FILER_SHARD_MOVED.inc(len(out))
        return sent

    def _tombstone_subtree(self, root: str) -> None:
        """Drop the migrated subtree from the LOCAL store only —
        straight store deletes, so the moved entries' chunks are never
        queued for GC (they now belong to the target shard)."""
        store = self.server.filer.store
        store.delete_folder_children(root)
        if root != "/":
            store.delete_entry(root)
        # store-level deletes bypass the filer listeners: fence the
        # collapsed listings wholesale
        self.server.bump_gen_fence(root, subtree=True)

    # -- status --------------------------------------------------------

    def status(self) -> dict:
        entry_count = -1
        count = getattr(self.server.filer.store, "count_entries", None)
        if count is not None:
            entry_count = count()
        return {"shard": self.shard_id, "of": self.shard_of,
                "url": self.server.url, "epoch": self.map.epoch,
                "entries": entry_count, "rules": self.map.rules,
                "owners": {str(k): v
                           for k, v in self.map.owners.items()},
                "moves": self.map.moves, "counters": dict(self.counters)}


# -- entry JSON plumbing (the /__api__ wire shape) ---------------------

def _entry_to_json(e: Entry) -> dict:
    return {"FullPath": e.full_path, "Mtime": e.attr.mtime,
            "Crtime": e.attr.crtime, "Mode": e.attr.mode,
            "Uid": e.attr.uid, "Gid": e.attr.gid, "Mime": e.attr.mime,
            "Replication": e.attr.replication,
            "Collection": e.attr.collection, "TtlSec": e.attr.ttl_sec,
            "chunks": [c.to_dict() for c in e.chunks],
            "extended": e.extended}


def _entry_from_json(d: dict) -> Entry:
    from .entry import Attr
    from .filechunks import FileChunk
    return Entry(
        full_path=d["FullPath"],
        attr=Attr(mtime=d.get("Mtime", 0.0), crtime=d.get("Crtime", 0.0),
                  mode=d.get("Mode", 0o660), uid=d.get("Uid", 0),
                  gid=d.get("Gid", 0), mime=d.get("Mime", ""),
                  replication=d.get("Replication", ""),
                  collection=d.get("Collection", ""),
                  ttl_sec=d.get("TtlSec", 0)),
        chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
        extended=d.get("extended", {}))


def _rebase(path: str, old_root: str, new_root: str) -> str:
    if path == old_root:
        return new_root
    return new_root + path[len(old_root):]
