"""Master server: cluster control plane.

Reference: weed/server/master_server.go (HTTP /dir/assign, /dir/lookup,
status), master_grpc_server.go (heartbeat stream -> topology sync + pubsub
of location deltas), master_server_handlers.go:96-137 (assign + on-demand
volume growth). gRPC streams become HTTP POST heartbeats + an SSE watch
stream over the asyncio mesh.

A copy of seaweedfs_tpu/master/server.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

from aiohttp import web
import aiohttp

from .. import qos
from ..pb import messages as pb
from ..storage import types as t
from ..storage.super_block import ReplicaPlacement
from ..topology.layout import (LayoutKey, PlacementError, VolumeLayout,
                               find_empty_slots)
from ..topology.tree import DataNode, Topology
from ..security import tls
from ..util import failpoints, glog, tracing
from .election import Election
from .sequence import (MemorySequencer, RaftSequencer, SequenceBehind,
                       SequenceUnavailable)


class MasterServer:
    def __init__(self, ip: str = "127.0.0.1", port: int = 9333,
                 volume_size_limit_mb: int = 30_000,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 garbage_threshold: float = 0.3,
                 jwt_key: str = "",
                 peers: list[str] | None = None,
                 election_timeout: tuple[float, float] = (1.0, 2.0),
                 election_pulse: float = 0.3,
                 sequencer: str = "memory",
                 meta_dir: str = "",
                 maintenance_interval_s: float = 900.0,
                 admin_scripts: list[str] | None = None,
                 admin_scripts_interval_s: float = 17 * 60.0,
                 white_list: list[str] | None = None,
                 volume_preallocate: bool = False,
                 autopilot_interval_s: float = 0.0,
                 autopilot_mbps: float = 16.0,
                 autopilot_dryrun: bool = False,
                 autopilot_concurrency: int = 2,
                 autopilot_tier_backend: str = "",
                 worker_ctx=None):
        # -workers N (server/workers.py): this master is the PRIMARY
        # (worker 0) of a fleet whose other members are assign
        # accelerators sharing the public port via SO_REUSEPORT
        self.worker_ctx = worker_ctx
        from ..security.guard import Guard
        # -whiteList: IP guard on the API surface (guard.go:43-137,
        # wrapped handlers at master_server.go:110-120)
        self.guard = Guard(white_list or ())
        # -volumePreallocate (master.go:51): grown volumes fallocate
        # their full size limit up front
        self.volume_preallocate = volume_preallocate
        self.ip = ip
        self.port = port
        self._peers = list(peers or [])
        self._election_timeout = election_timeout
        self._election_pulse = election_pulse
        # -mdir: raft-state directory (reference -mdir, raft_server.go:60)
        self.meta_dir = meta_dir
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        self.election: Election | None = None
        self.jwt_key = jwt_key
        self.volume_size_limit = volume_size_limit_mb * 1024 * 1024
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        # automatic maintenance (master_server.go:186-250 startAdminScripts
        # + topology_event_handling.go:22-28 auto-vacuum): leader-only
        # background upkeep so an unattended cluster reclaims space and
        # runs its configured admin scripts. 0 disables either loop.
        self.maintenance_interval_s = maintenance_interval_s
        self.admin_scripts = [s.strip() for s in (admin_scripts or [])
                              if s.strip()]
        self.admin_scripts_interval_s = admin_scripts_interval_s
        self.topo = Topology(pulse_seconds=pulse_seconds)
        # -sequencer memory | file:<path> | etcd:<host:port>
        # (master.toml [master.sequencer], scaffold.go:362-371)
        if sequencer.startswith("file:"):
            from .sequence import FileSequencer
            self.seq = FileSequencer(sequencer[5:])
        elif sequencer.startswith("etcd:"):
            from .sequence import EtcdSequencer
            self.seq = EtcdSequencer(sequencer[5:])
        else:
            # under -peers the raft log itself is the durable shared
            # allocator: _make_election wraps this in a RaftSequencer,
            # so even the in-memory sequencer is failover-safe (every
            # issued id sits inside a quorum-committed window)
            self.seq = MemorySequencer()
        self.layouts: dict[LayoutKey, VolumeLayout] = {}
        self._watchers: list[asyncio.Queue] = []
        self._peer_ips: set[str] = set()
        self._runner: web.AppRunner | None = None
        self._site: web.TCPSite | None = None
        self._tasks: list[asyncio.Task] = []
        self._http: aiohttp.ClientSession | None = None
        # lazily-built frame hub for cluster-scope introspection
        # fan-out (stats/introspect.py) — frame-first, HTTP fallback
        self._introspect_hub = None
        self._grow_lock = asyncio.Lock()
        # applied filer shard map mirror (filer/shard.py): fed by the
        # election's adopt hook at APPLY time; served on /cluster/shards
        self.shard_epoch = 0
        self.shard_map: dict | None = None
        # autopilot maintenance plane (autopilot/): the object always
        # exists so POST /debug/autopilot?run=1 can force a cycle even
        # with the loop disabled; the loop itself is leader-only and
        # starts in start() when -autopilot.interval > 0
        from ..autopilot import Autopilot
        self.autopilot = Autopilot(
            self, interval_s=autopilot_interval_s,
            mbps=autopilot_mbps, dryrun=autopilot_dryrun,
            concurrency=autopilot_concurrency,
            tier_backend=autopilot_tier_backend,
            garbage_threshold=garbage_threshold)
        # bandwidth arbiter adoption (-qos.mbps): autopilot repair
        # pacing yields to cluster foreground pressure (volume nodes
        # report theirs through heartbeats) down to the floor
        arb = qos.arbiter()
        if arb is not None:
            self.autopilot.executor.bucket = arb.adopt(
                "autopilot", self.autopilot.executor.bucket)
        self.app = self._build_app()

    # ------------------------------------------------------------------
    # the client-API paths the reference wraps with guard.WhiteList
    # (master_server.go:110-120). Deliberately NOT guarded: the UI, the
    # fid redirect, the raft/heartbeat/watch mesh (mTLS-scoped instead).
    # /dir/lookup IS guarded like the reference's master_server.go:111 —
    # volume servers calling it during replica fan-out are auto-admitted
    # by _is_peer (their IP is learned from heartbeats), so an operator
    # whitelist only needs to cover clients. Follower control routes
    # 307-redirect (the client IP is judged here, on the leader); only
    # /submit still proxies, so peer master IPs need whitelisting for
    # that route alone.
    _GUARDED = ("/dir/assign", "/dir/lookup", "/dir/status",
                "/col/delete", "/vol/grow", "/vol/status", "/vol/vacuum",
                "/vol/volumes", "/vol/ec_lookup", "/submit", "/stats/")

    def _is_peer(self, ip: str | None) -> bool:
        """Heartbeating volume servers are cluster members, not clients;
        admit them on guarded paths regardless of -whiteList."""
        return ip is not None and ip in self._peer_ips

    def _remote(self, req: web.Request) -> str | None:
        """The peer IP a policy decision should see: for an intra-host
        worker hop (launch-token authenticated) the accelerator's
        X-Forwarded-For carries the real client address."""
        wc = self.worker_ctx
        if wc is not None:
            from ..server import workers as wk
            if wc.token_ok(req.headers.get(wk.WORKER_HEADER)):
                return req.headers.get(wk.FORWARDED_HEADER) or req.remote
        return req.remote

    def _worker_auth(self, req: web.Request) -> bool:
        """Gate on the internal mesh endpoints (/cluster/seq_lease,
        /cluster/assign_state): when a worker token is configured only
        fleet members holding it get in; a standalone master leaves
        them open like the rest of the /cluster mesh (mTLS-scoped)."""
        wc = self.worker_ctx
        if wc is None or not wc.token:
            return True
        from ..server import workers as wk
        return wc.token_ok(req.headers.get(wk.WORKER_HEADER))

    def _build_app(self) -> web.Application:
        from ..security.guard import middleware as guard_mw
        from ..security.guard import path_guarded
        app = web.Application(
            client_max_size=64 * 1024 * 1024,
            middlewares=[guard_mw(
                lambda: self.guard,
                lambda req: (path_guarded(req.path, self._GUARDED)
                             and not (req.path == "/dir/lookup"
                                      and self._is_peer(
                                          self._remote(req)))),
                remote_of=self._remote)])
        app.router.add_route("*", "/dir/assign", self.h_assign)
        app.router.add_route("*", "/dir/lookup", self.h_lookup)
        app.router.add_get("/dir/status", self.h_dir_status)
        app.router.add_get("/cluster/status", self.h_cluster_status)
        app.router.add_post("/cluster/heartbeat", self.h_heartbeat)
        app.router.add_get("/cluster/watch", self.h_watch)
        app.router.add_get("/cluster/seq_lease", self.h_seq_lease)
        app.router.add_get("/cluster/assign_state", self.h_assign_state)
        app.router.add_route("*", "/cluster/shards", self.h_cluster_shards)
        app.router.add_get("/debug/shards", self.h_debug_shards)
        app.router.add_get("/stats/health", self.h_health)
        app.router.add_get("/metrics", self.h_metrics)
        app.router.add_route("*", "/debug/failpoints",
                             failpoints.handle_debug)
        # flight recorder: shared handler trio (stats/timeline.py), so
        # the master serves the same /debug/timeline//events//health
        # contract as every data-plane daemon
        from ..stats.timeline import recorder_handlers
        h_tl, h_ev, h_hl = recorder_handlers()
        app.router.add_get("/debug/timeline", h_tl)
        app.router.add_post("/debug/timeline", h_tl)
        app.router.add_get("/debug/events", h_ev)
        app.router.add_get("/debug/health", h_hl)
        # span ring + in-flight table: instance ATTRIBUTES (not
        # closures in the router) because the frame adapter whitelist
        # resolves handlers by getattr — peer masters pull trace spans
        # over the fabric
        self.h_traces, self.h_trace_requests = tracing.debug_handlers()
        app.router.add_get("/debug/traces", self.h_traces)
        app.router.add_get("/debug/requests", self.h_trace_requests)
        from ..stats import profiler
        from ..util import pprof
        app.router.add_get("/debug/profile", profiler.debug_handler())
        app.router.add_get("/debug/pprof", pprof.debug_handler())
        # cluster scope: leader-side fan-out over every known member
        # (multi-segment paths can't collide with the /{fid} catch-all)
        app.router.add_get("/debug/cluster", self.h_cluster_index)
        app.router.add_get("/debug/cluster/trace/{tid}",
                           self.h_cluster_trace)
        app.router.add_get("/debug/cluster/timeline",
                           self.h_cluster_timeline)
        app.router.add_get("/debug/cluster/events",
                           self.h_cluster_events)
        app.router.add_get("/debug/cluster/health",
                           self.h_cluster_health)
        app.router.add_route("*", "/debug/autopilot", self.h_autopilot)
        app.router.add_get("/debug/qos", qos.debug_handler)
        app.router.add_route("*", "/vol/grow", self.h_grow)
        app.router.add_route("*", "/vol/vacuum", self.h_vacuum)
        app.router.add_route("*", "/col/delete", self.h_collection_delete)
        app.router.add_get("/vol/volumes", self.h_volumes)
        app.router.add_get("/vol/status", self.h_volumes)
        app.router.add_get("/vol/ec_lookup", self.h_ec_lookup)
        app.router.add_route("*", "/submit", self.h_submit)
        app.router.add_post("/raft/vote", self.h_raft_vote)
        app.router.add_post("/raft/heartbeat", self.h_raft_heartbeat)
        app.router.add_post("/raft/snapshot", self.h_raft_snapshot)
        app.router.add_get("/ui", self.h_ui)
        app.router.add_get("/", self.h_ui)
        # catch-all LAST: GET /<fid> redirects to a holder of the volume
        # (master_server.go:121 redirectHandler)
        app.router.add_get("/{fid}", self.h_fid_redirect)
        return app

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def frame_protocol(self):
        """Factory for the master-side frame terminator — the hook
        FastAssignProtocol's MAGIC sniff upgrades onto (the assign
        accelerator has no such surface, so frames there degrade to
        HTTP)."""
        from .frameadapter import MasterFrameProtocol
        return MasterFrameProtocol(self)

    async def start(self) -> None:
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=30))
        # multi-master: the raft state MUST be replayed (executor —
        # this loop may already serve sibling daemons) BEFORE any
        # listener goes live. A respawned worker that answered
        # /dir/assign with `self.election is None` would claim
        # leadership with no raft state next to the real leader.
        # Single mode defers until the port is bound (identity may be
        # an ephemeral :0 here, and single mode is leader by fiat).
        if self._peers:
            await self._make_election()
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        # public listener: /dir/assign answered straight off the socket,
        # everything else upgrades in place onto the aiohttp app
        from ..server.fasthttp import FastAssignProtocol
        loop = asyncio.get_running_loop()
        wc = self.worker_ctx
        self._server = await loop.create_server(
            lambda: FastAssignProtocol(self), self.ip, self.port,
            ssl=tls.server_ctx(), reuse_address=True,
            reuse_port=wc is not None)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        if wc is not None:
            # a private listener is the direct door to THIS process for
            # the assign accelerators (lease/assign-state/proxy target).
            # Plain aiohttp, NOT the raw fast path: a proxied
            # /dir/assign must be guarded against the forwarded client
            # IP (token + X-Forwarded-For via _remote()), which the
            # header-blind raw protocol cannot see — it would judge the
            # accelerator's loopback address instead
            self._priv_server = await loop.create_server(
                self._runner.server, self.ip, 0,
                ssl=tls.server_ctx(), reuse_address=True)
            priv_port = self._priv_server.sockets[0].getsockname()[1]
            wc.write_state(ip=self.ip, port=priv_port, role="master")
        if self.election is None:
            await self._make_election()
        await self.election.start()
        self._tasks.append(asyncio.create_task(self._liveness_loop()))
        if self.autopilot.interval_s > 0:
            # long-lived leader-only maintenance loop; handle retained
            # and cancelled in stop() (orphan-task discipline)
            self._tasks.append(asyncio.create_task(self.autopilot.run()))
        if self.maintenance_interval_s > 0:
            self._tasks.append(
                asyncio.create_task(self._auto_vacuum_loop()))
        if self.admin_scripts and self.admin_scripts_interval_s > 0:
            self._tasks.append(
                asyncio.create_task(self._admin_scripts_loop()))

    async def stop(self) -> None:
        if self.election:
            await self.election.stop()
        for task in self._tasks:
            task.cancel()
        if self._http:
            await self._http.close()
        if self._introspect_hub is not None:
            await self._introspect_hub.close()
        if getattr(self, "_server", None) is not None:
            self._server.close()
            # NOT wait_closed() (3.12 waits on live keep-alives)
            for tr in list(getattr(self, "_fast_conns", ())):
                tr.close()
        if getattr(self, "_priv_server", None) is not None:
            self._priv_server.close()
        if self._runner:
            await self._runner.cleanup()

    _assign_ctr = None

    def count_assign(self) -> None:
        """Cached assign counter for the fast path."""
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        if self._assign_ctr is None:
            self._assign_ctr = \
                metrics.MASTER_ASSIGN_REQUESTS.labels("ok")
        self._assign_ctr.inc()

    # ---- layouts ----

    def _layout(self, collection: str, replication: str,
                ttl: str) -> VolumeLayout:
        replication = str(ReplicaPlacement.parse(
            replication or self.default_replication))
        key = LayoutKey(collection, replication, str(t.TTL.parse(ttl)))
        lay = self.layouts.get(key)
        if lay is None:
            lay = VolumeLayout(key, self.volume_size_limit)
            self.layouts[key] = lay
        return lay

    def _refresh_writable(self, node: DataNode) -> None:
        for m in node.volumes.values():
            rp = ReplicaPlacement.from_byte(m.replica_placement)
            ttl = str(t.TTL.from_uint32(m.ttl))
            lay = self._layout(m.collection, str(rp), ttl)
            writable = (not m.read_only
                        and m.size < self.volume_size_limit)
            lay.set_writable(m.id, writable)

    # ---- leadership ----

    @property
    def is_leader(self) -> bool:
        return self.election is None or self.election.is_leader

    @property
    def leader_url(self) -> str | None:
        return self.url if self.election is None else self.election.leader

    def _adopt_max_volume_id(self, v: int) -> None:
        """Follower side of the one replicated raft value
        (cluster_commands.go:23 MaxVolumeIdCommand)."""
        self.topo.max_volume_id = max(self.topo.max_volume_id, v)

    async def _make_election(self) -> None:
        """Build the Election (its ctor replays persisted raft state
        from disk, so it runs on the executor — under `weed-tpu
        server` and worker respawn this loop already serves traffic)
        and wire the MaxVolumeId exchange hooks."""
        self.election = await tracing.run_in_executor(lambda: Election(
            self.url, self._peers,
            election_timeout=self._election_timeout,
            pulse=self._election_pulse,
            state_path=(os.path.join(self.meta_dir, "raft_state.json")
                        if self.meta_dir else None),
            jwt_key=self.jwt_key))
        self.election.get_max_volume_id = lambda: self.topo.max_volume_id
        self.election.adopt_max_volume_id = self._adopt_max_volume_id
        self.election.adopt_shard_map = self._adopt_shard_map
        # replayed raft state may already hold a committed map
        self.shard_epoch = self.election.applied_shard_epoch
        self.shard_map = self.election.applied_shard
        if self._peers and not isinstance(self.seq, RaftSequencer):
            # multi-master: every fid block must come out of a
            # quorum-committed reservation window — the raft log is
            # the shared durable allocator (wrapping the configured
            # file:/etcd: sequencer keeps its local durability as an
            # extra floor under the committed ceiling)
            self.seq = RaftSequencer(self.seq, self.election)

    def _raft_unready(self) -> web.Response | None:
        """503 while the Election is still being built (single mode
        binds the port before constructing it; a raft RPC landing in
        that window means a peer is misconfigured, not that we should
        500 with an AttributeError)."""
        if self.election is None:
            return web.json_response(
                {"error": "raft state not loaded yet"}, status=503)
        return None

    async def h_raft_vote(self, req: web.Request) -> web.Response:
        if (err := self._raft_unready()) is not None:
            return err
        body = await req.json()
        lli = body.get("last_log_index")
        r = self.election.on_vote_request(
            int(body["term"]), body["candidate"],
            int(body.get("max_volume_id", 0)),
            last_log_index=None if lli is None else int(lli),
            last_log_term=int(body.get("last_log_term", 0) or 0))
        # raft durability rule: the granted vote / term bump must be
        # on disk before the reply leaves this node (the fsync runs on
        # the executor; a failed write 500s instead of lying)
        await self.election.flush()
        return web.json_response(r)

    async def h_raft_heartbeat(self, req: web.Request) -> web.Response:
        if (err := self._raft_unready()) is not None:
            return err
        body = await req.json()
        if "prev_index" in body:
            r = self.election.on_append(
                int(body["term"]), body["leader"],
                int(body["prev_index"]), int(body["prev_term"]),
                list(body.get("entries", [])), int(body.get("commit", 0)))
        else:
            # legacy pulse (value inline, no log coordinates)
            r = self.election.on_leader_pulse(
                int(body["term"]), body["leader"],
                int(body.get("max_volume_id", 0)))
        await self.election.flush()   # appended entries durable pre-ack
        return web.json_response(r)

    async def h_raft_snapshot(self, req: web.Request) -> web.Response:
        if (err := self._raft_unready()) is not None:
            return err
        body = await req.json()
        r = self.election.on_install_snapshot(
            int(body["term"]), body["leader"], int(body["last_index"]),
            int(body["last_term"]), int(body.get("value", 0)),
            seq=int(body.get("seq", 0)),
            shard_epoch=int(body.get("shard_epoch", 0)),
            shard_map=body.get("shard_map"))
        await self.election.flush()   # term bump / snapshot durable
        return web.json_response(r)

    # ---- filer shard map (filer/shard.py) ----

    def _adopt_shard_map(self, epoch: int, shard_map: dict) -> None:
        """APPLY-time hook: mirror the committed map for serving."""
        if epoch > self.shard_epoch:
            self.shard_epoch = epoch
            self.shard_map = shard_map

    def _shard_map_dict(self) -> dict:
        from ..filer.shard import ShardMap
        if self.shard_map is not None:
            return dict(self.shard_map, epoch=self.shard_epoch)
        return ShardMap(epoch=self.shard_epoch).to_dict()

    async def h_cluster_shards(self, req: web.Request) -> web.Response:
        """GET: the applied shard map (any node serves its own applied
        copy — a stale follower answer only costs the client one
        redirect chase). POST: a map transition, leader-only, raft-
        committed under an epoch CAS so a deposed leader's proposal
        applies as a no-op."""
        if req.method in ("GET", "HEAD"):
            return web.json_response(dict(
                self._shard_map_dict(), leader=self.leader_url or ""))
        if (err := self._raft_unready()) is not None:
            return err
        if not self.is_leader:
            return self._redirect_to_leader(req)
        from ..filer.shard import ShardMap, apply_map_op
        op = await req.json()
        for _ in range(5):
            base = self.shard_epoch
            cur = ShardMap.from_dict(self._shard_map_dict())
            try:
                want = apply_map_op(cur, op)
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            committed = await self.election.append_command(
                {"shard_map": {"base": base, "map": want.to_dict()},
                 "by": self.url})
            if not committed:
                return web.json_response(
                    {"error": "not leader / no quorum"}, status=503)
            # CAS verdict: the op is in iff re-applying it to the NOW
            # applied map is a no-op (every transition is idempotent)
            applied = ShardMap.from_dict(self._shard_map_dict())
            try:
                again = apply_map_op(applied, op)
            except ValueError:
                # e.g. commit_move whose move already completed: the
                # op's effect is behind us either way
                again = applied
            if again.to_dict() == applied.to_dict():
                return web.json_response({"ok": True,
                                          "map": applied.to_dict()})
        return web.json_response(
            {"error": "shard map CAS kept losing"}, status=503)

    async def h_debug_shards(self, req: web.Request) -> web.Response:
        """Merged fleet view: the committed map plus each owner
        filer's local /__debug__/shards (entry counts, move state,
        routing counters). A dead filer degrades its row, not the
        endpoint."""
        m = self._shard_map_dict()
        shards = []
        for sid_s, owner in sorted((m.get("owners") or {}).items(),
                                   key=lambda kv: int(kv[0])):
            row = {"shard": int(sid_s), "url": owner}
            try:
                # chaos site: the fan-out hop is routed traffic too
                await failpoints.fail("filer.shard.route")
                async with self._http.get(
                        tls.url(owner, "/__debug__/shards"),
                        timeout=aiohttp.ClientTimeout(total=5)) as resp:
                    row.update(await resp.json())
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError, AttributeError) as e:
                row["error"] = str(e) or type(e).__name__
            shards.append(row)
        return web.json_response(
            {"epoch": self.shard_epoch, "leader": self.leader_url or "",
             "map": m, "shards": shards})

    # ---- cluster-scope introspection (stats/introspect.py) ----

    def _frame_hub(self):
        if self._introspect_hub is None:
            from ..util.frame import FrameHub
            from ..stats import introspect
            self._introspect_hub = FrameHub(
                ssl=tls.client_ctx(), jwt_key=self.jwt_key,
                request_timeout=introspect.deadline_s())
        return self._introspect_hub

    async def _cluster_fanout(self, req: web.Request, path: str,
                              params: "dict | None", local):
        """One bounded debug pull per known member; any node serves it
        (no leader gate — introspection must work mid-election)."""
        from ..stats import introspect
        nodes = introspect.cluster_nodes(
            self, extra=req.query.get("extra", ""))
        return await introspect.fanout(
            nodes, path, self._http, frame_hub=self._frame_hub(),
            params=params, local=local)

    async def h_cluster_index(self, req: web.Request) -> web.Response:
        """/debug/cluster: the views this master can assemble and the
        member enumeration each one fans out over — the operator's
        entry point (no network pulls: answering must never block)."""
        from ..stats import introspect
        nodes = introspect.cluster_nodes(
            self, extra=req.query.get("extra", ""))
        return web.json_response({
            "views": ["/debug/cluster/trace/<id>",
                      "/debug/cluster/timeline",
                      "/debug/cluster/events",
                      "/debug/cluster/health"],
            "deadline_s": introspect.deadline_s(),
            "nodes": [{"node": nd["node"], "kind": nd["kind"]}
                      for nd in nodes],
        })

    async def h_cluster_trace(self, req: web.Request) -> web.Response:
        """/debug/cluster/trace/<id>: every node's spans for ONE trace
        assembled into a single tree with host/tier attribution and
        explicit missing_nodes rows for members that didn't answer
        inside -introspect.deadline."""
        from ..stats import introspect
        tid = req.match_info["tid"].strip()[:64]
        if not tid:
            return web.json_response({"error": "empty trace id"},
                                     status=400)
        results, missing = await self._cluster_fanout(
            req, "/traces", {"trace": tid},
            local=lambda: tracing.trace_spans_dict(tid))
        return web.json_response(introspect.assemble_trace(
            tid, [(nd["node"], p) for nd, p in results], missing))

    async def h_cluster_timeline(self, req: web.Request) -> web.Response:
        """/debug/cluster/timeline: every member's windows merged with
        the whole-host discipline lifted to cluster scope (sum rates
        and buckets, MAX the non-additive gauges, recompute quantiles
        from merged buckets — never average)."""
        from ..stats import timeline
        try:
            n = tracing.clamp_count(req.query.get("n", 60), cap=10_000)
        except ValueError:
            return web.json_response({"error": "bad n"}, status=400)
        results, missing = await self._cluster_fanout(
            req, "/timeline", {"n": str(n)},
            local=lambda: timeline.timeline_dict(n=n, render=False))
        merged = timeline.merge_payloads([p for _, p in results], n=n)
        merged["nodes"] = len(results)
        merged["missing_nodes"] = missing
        return web.json_response(merged)

    async def h_cluster_events(self, req: web.Request) -> web.Response:
        """/debug/cluster/events: the structured journals of every
        member zipped newest-first, rows tagged with their node."""
        from ..util import events
        try:
            n = tracing.clamp_count(req.query.get("n", 100), cap=10_000)
        except ValueError:
            return web.json_response({"error": "bad n"}, status=400)
        results, missing = await self._cluster_fanout(
            req, "/events", {"n": str(n)},
            local=lambda: events.events_dict(n=n))
        payloads = []
        for nd, p in results:
            p["events"] = [{**r, "node": nd["node"]}
                           for r in p.get("events", ())]
            payloads.append(p)
        merged = events.merge_payloads(payloads, n=n)
        merged["nodes"] = len(results)
        merged["missing_nodes"] = missing
        return web.json_response(merged)

    async def h_cluster_health(self, req: web.Request) -> web.Response:
        """/debug/cluster/health: the SLO verdict evaluated over the
        CLUSTER-merged timeline + journal — burn rates burn on
        cluster-wide buckets, not one host's."""
        from ..stats import slo, timeline
        from ..util import events
        wins = slo.windows_needed()
        (tl_results, tl_missing), (ev_results, _) = await asyncio.gather(
            self._cluster_fanout(
                req, "/timeline", {"n": str(wins)},
                local=lambda: timeline.timeline_dict(n=wins,
                                                     render=False)),
            self._cluster_fanout(
                req, "/events", {"n": "500"},
                local=lambda: events.events_dict(n=500)))
        merged = timeline.merge_payloads([p for _, p in tl_results],
                                         n=wins, render=False)
        evs: list = []
        for _, p in ev_results:
            evs.extend(p.get("events", ()))
        out = slo.health_dict(merged["windows"], events=evs)
        out["nodes"] = len(tl_results)
        out["missing_nodes"] = tl_missing
        return web.json_response(out)

    def _leader_or_503(self) -> tuple[str | None, web.Response | None]:
        """Resolve the current leader, or the 503 every non-leader
        entry point returns while no leader is elected."""
        leader = self.leader_url
        if not leader or leader == self.url:
            return None, web.json_response(
                {"error": "no leader elected yet"}, status=503)
        return leader, None

    def _redirect_to_leader(self, req: web.Request) -> web.Response:
        """Follower answer for every control route: 307 to the leader
        with the ``X-Raft-Leader`` hint (307 preserves method + body,
        so aiohttp/urllib clients land on the leader transparently;
        explicit fleet clients read the hint and re-home). Replaces
        the old whole-body proxy — a follower must not buffer blobs,
        and the whitelist decision belongs on the leader, judged by
        the real client IP."""
        leader, err = self._leader_or_503()
        if err is not None:
            return err
        return web.json_response(
            {"error": "not leader", "leader": leader}, status=307,
            headers={"Location": tls.url(leader, req.path_qs),
                     "X-Raft-Leader": leader})

    async def _proxy_to_leader(self, req: web.Request) -> web.Response:
        """Non-leader HTTP forwards to the leader
        (proxyToLeader, master_server.go:153-185). Only /submit still
        rides this (its multipart body is not reliably replayable
        across a 307 by arbitrary clients); every other control route
        redirects via _redirect_to_leader."""
        leader, err = self._leader_or_503()
        if err is not None:
            return err
        data = await req.read()
        # forward Content-Type: /submit interprets its body by it
        # (multipart vs raw), and dropping it would corrupt the upload
        headers = {"X-Raft-Leader": leader}
        if "Content-Type" in req.headers:
            headers["Content-Type"] = req.headers["Content-Type"]
        try:
            # chaos site: the follower->leader hop is a network hop
            # like any other — error/latency/drop here must surface as
            # a bounded 502 the client's seed rotation absorbs
            await failpoints.fail("master.proxy")
            async with self._http.request(
                    req.method, tls.url(leader, f"{req.path_qs}"),
                    data=data or None, headers=headers) as resp:
                return web.Response(body=await resp.read(),
                                    status=resp.status,
                                    content_type=resp.content_type)
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            return web.json_response(
                {"error": f"proxy to leader {leader}: {e}"}, status=502)

    async def _next_fid(self, count: int) -> int:
        """Allocate a fid block under the quorum discipline: ids come
        only from a raft-committed reservation window; when the open
        window cannot cover the block, the leader commits a fresh one
        through the log FIRST (so a successor can never re-issue these
        ids). Raises SequenceUnavailable when no window can be
        committed — the caller errors/redirects, exactly the deposed
        mid-assign contract."""
        for _ in range(3):
            try:
                return self.seq.next_file_id(count)
            except SequenceBehind:
                if not isinstance(self.seq, RaftSequencer) \
                        or not await self.seq.reserve(count):
                    raise SequenceUnavailable(
                        "no committed fid window (not leader?)") \
                        from None
        raise SequenceUnavailable("fid window kept burning under "
                                  "racing heartbeat watermarks")

    # ---- handlers ----

    async def h_health(self, req: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    async def h_metrics(self, req: web.Request) -> web.Response:
        from ..stats.metrics import metrics_text
        return web.Response(body=metrics_text(),
                            content_type="text/plain")

    async def h_heartbeat(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            # volume servers must register with the leader. 307 lands
            # this very pulse on the leader (aiohttp re-sends the JSON
            # body), so a re-homing fleet loses ZERO pulses; the body
            # keeps the legacy rejected+hint shape for clients that
            # don't follow redirects (master_grpc_server.go:165-175)
            leader = self.leader_url
            if leader and leader != self.url:
                return web.json_response(
                    {"rejected": True, "leader": leader}, status=307,
                    headers={"Location": tls.url(leader, req.path_qs),
                             "X-Raft-Leader": leader})
            return web.json_response({"rejected": True, "leader": ""})
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.MASTER_RECEIVED_HEARTBEATS.inc()
        try:
            raw = await req.json()
            hb = pb.Heartbeat.from_dict(raw)
        except (ValueError, TypeError, KeyError, AttributeError):
            return web.json_response({"error": "bad heartbeat body"},
                                     status=400)
        if not hb.ip or not hb.port:
            return web.json_response(
                {"error": "heartbeat without ip:port"}, status=400)
        # auto-admit the sender as a cluster peer ONLY now that the body
        # parsed as a real volume-server registration on the leader path
        # — an empty POST must not whitelist-bypass /dir/lookup. Residual
        # exposure: a client that forges a full valid heartbeat is still
        # admitted (and registered); the mesh trust boundary without
        # security.toml mTLS is the heartbeat body, as in the reference.
        remote = self._remote(req)
        if remote:
            self._peer_ips.add(remote)
        node = self.topo.register_heartbeat(hb)
        self.seq.set_max(hb.max_file_key)
        self._refresh_writable(node)
        # publish location deltas to watchers (KeepConnected analog)
        if hb.new_volumes or hb.deleted_volumes or hb.new_ec_shards \
                or hb.deleted_ec_shards:
            self._publish({
                "url": node.url, "public_url": node.public_url,
                "new_vids": sorted({m.id for m in hb.new_volumes}
                                   | {m.id for m in hb.new_ec_shards}),
                "deleted_vids": sorted({m.id for m in hb.deleted_volumes}
                                       | {m.id for m in hb.deleted_ec_shards}),
            })
        out = {
            "volume_size_limit": self.volume_size_limit,
            "leader": self.url,
        }
        # cluster-wide bandwidth arbitration rides the pulse: the node
        # reports its foreground byte rate, the leader publishes the
        # -qos.mbps budget every arbiter in the fleet paces against
        arb = qos.arbiter()
        if arb is not None:
            fg = raw.get("qos_fg_bps")
            if isinstance(fg, (int, float)):
                arb.note_node_foreground(node.url, float(fg))
            if arb.budget_bps > 0:
                out["qos_mbps"] = round(arb.budget_bps / (1 << 20), 3)
        return web.json_response(out)

    async def h_seq_lease(self, req: web.Request) -> web.Response:
        """Lease a block of file ids to an assign accelerator
        (server/workers.py): the accelerator hands them out without a
        round trip per assign. Ids in an abandoned lease are simply
        never used — file keys are sparse by design."""
        if not self._worker_auth(req):
            return web.json_response({"error": "forbidden"}, status=403)
        if not self.is_leader:
            return web.json_response(
                {"error": "not leader", "leader": self.leader_url or ""},
                status=503)
        try:
            count = max(1, min(int(req.query.get("count", 1024)),
                               1 << 20))
        except ValueError:
            return web.json_response({"error": "bad count"}, status=400)
        try:
            start = await self._next_fid(count)
        except SequenceUnavailable:
            return web.json_response(
                {"error": "not leader", "leader": self.leader_url or ""},
                status=503)
        return web.json_response({"start": start, "count": count})

    async def h_assign_state(self, req: web.Request) -> web.Response:
        """Writable-volume snapshot for one layout key — everything an
        accelerator needs to answer /dir/assign locally: vids with
        enough live replicas plus their primary location."""
        if not self._worker_auth(req):
            return web.json_response({"error": "forbidden"}, status=403)
        if not self.is_leader:
            return web.json_response({"entries": [],
                                      "leader": self.leader_url or ""})
        q = req.query
        collection = q.get("collection", "")
        replication = q.get("replication", "") or self.default_replication
        ttl = q.get("ttl", "")
        try:
            rp = ReplicaPlacement.parse(replication)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        lay = self._layout(collection, replication, ttl)
        entries = []
        for vid in sorted(lay.writable):
            nodes = self.topo.lookup(vid)
            if len(nodes) >= rp.copy_count:
                entries.append({"vid": vid, "url": nodes[0].url,
                                "publicUrl": nodes[0].public_url})
        return web.json_response({"entries": entries})

    async def h_assign(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            return self._redirect_to_leader(req)
        try:
            # chaos site: injected assign faults (error => client retry
            # with backoff; latency => client deadline discipline)
            await failpoints.fail("master.assign")
        except OSError as e:
            return web.json_response({"error": str(e)}, status=503)
        q = req.query
        count = int(q.get("count", 1) or 1)
        collection = q.get("collection", "")
        replication = q.get("replication", "") or self.default_replication
        ttl = q.get("ttl", "")
        data_center = q.get("dataCenter", "")
        try:
            rp = ReplicaPlacement.parse(replication)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)

        lay = self._layout(collection, replication, ttl)
        vid = lay.pick_for_write(self.topo, rp.copy_count)
        if vid is None:
            # serialize growth: concurrent assigns must not each grow a
            # volume and overshoot node capacity (vgChan in the reference)
            async with self._grow_lock:
                vid = lay.pick_for_write(self.topo, rp.copy_count)
                if vid is None:
                    try:
                        await self._grow(lay, rp, collection, replication,
                                         ttl, data_center)
                    except PlacementError as e:
                        return web.json_response({"error": str(e)},
                                                 status=500)
                    vid = lay.pick_for_write(self.topo, rp.copy_count)
            if vid is None:
                return web.json_response(
                    {"error": "no writable volumes after growth"}, status=500)
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.MASTER_ASSIGN_REQUESTS.labels("ok").inc()
        try:
            key = await self._next_fid(count)
        except SequenceUnavailable:
            # deposed mid-assign: the in-flight request errors or
            # redirects — it NEVER gets a fid outside a committed
            # reservation window (tools/chaos.py ha's core invariant)
            if not self.is_leader:
                return self._redirect_to_leader(req)
            return web.json_response(
                {"error": "fid reservation lost quorum",
                 "leader": self.leader_url or ""}, status=503)
        fid = str(t.FileId(vid, key, t.random_cookie()))
        nodes = self.topo.lookup(vid)
        node = nodes[0]
        out = {
            "fid": fid, "url": node.url, "publicUrl": node.public_url,
            "count": count,
        }
        if self.jwt_key:
            from ..security.jwt import gen_jwt
            out["auth"] = gen_jwt(self.jwt_key, fid)
        return web.json_response(out)

    async def _grow(self, lay: VolumeLayout, rp: ReplicaPlacement,
                    collection: str, replication: str, ttl: str,
                    data_center: str) -> None:
        """AutomaticGrowByType: place + AllocateVolume on each target
        (volume_growth.go:204-230, allocate_volume.go)."""
        nodes = find_empty_slots(self.topo, rp, data_center or None)
        vid = self.topo.next_volume_id()
        if self.election and not await self.election.commit_max_volume_id():
            # the new id must reach a majority before any volume exists
            # under it, or a successor leader could reissue it
            raise PlacementError(
                f"vid {vid}: MaxVolumeId not replicated to a quorum")
        prealloc = str(self.volume_size_limit
                       if self.volume_preallocate else 0)
        # chaos site: the allocate fan-out to volume servers — an
        # injected fault is a failed growth (PlacementError), never a
        # half-registered volume the layout would hand out
        try:
            await failpoints.fail("master.grow")
        except OSError as e:
            raise PlacementError(f"injected grow fault: {e}") from e
        for n in nodes:
            async with self._http.post(
                    tls.url(n.url, "/admin/volume/allocate"),
                    params={"volume": str(vid), "collection": collection,
                            "replication": replication, "ttl": ttl,
                            "preallocate": prealloc}) as resp:
                if resp.status != 200:
                    raise PlacementError(
                        f"allocate vid {vid} on {n.url}: "
                        f"{await resp.text()}")
            m = pb.VolumeInformationMessage(
                id=vid, collection=collection,
                replica_placement=rp.to_byte(),
                ttl=t.TTL.parse(ttl).to_uint32())
            n.volumes[m.id] = m
            self.topo.register_volume(m, n)
        lay.set_writable(vid, True)

    async def h_lookup(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            return self._redirect_to_leader(req)
        q = req.query
        vid_s = q.get("volumeId", "") or q.get("fileId", "")
        if "," in vid_s:
            vid_s = vid_s.split(",")[0]
        try:
            vid = int(vid_s)
        except ValueError:
            return web.json_response(
                {"error": f"unknown volumeId {vid_s!r}"}, status=400)
        nodes = self.topo.lookup(vid)
        if not nodes:
            return web.json_response(
                {"volumeId": vid_s, "error": "volume id not found"},
                status=404)
        return web.json_response({
            "volumeId": vid_s,
            "locations": [{"url": n.url, "publicUrl": n.public_url}
                          for n in nodes],
        })

    async def h_vacuum(self, req: web.Request) -> web.Response:
        """HTTP vacuum trigger (master_server.go:116 volumeVacuumHandler):
        the manual form of the auto-vacuum loop, same underlying
        check -> compact -> commit workflow."""
        if not self.is_leader:
            return self._redirect_to_leader(req)
        from ..shell import volume_commands as vc
        from ..shell.env import CommandEnv
        try:
            threshold = float(req.query.get("garbageThreshold",
                                            self.garbage_threshold))
        except ValueError:
            return web.json_response(
                {"error": "bad garbageThreshold"}, status=400)
        async with CommandEnv(self.url, session=self._http) as env:
            res = await vc.volume_vacuum(env, threshold)
        return web.json_response({"vacuumed": res})

    async def h_submit(self, req: web.Request) -> web.Response:
        """One-shot upload through the master: assign + store
        (master_server_handlers.go:117 submitFromMasterServerHandler,
        operation.SubmitFiles)."""
        if not self.is_leader:
            return await self._proxy_to_leader(req)
        from ..util.client import OperationError, WeedClient
        name = ""
        mime = ""
        ctype = req.headers.get("Content-Type", "")
        data = b""
        if ctype.startswith("multipart/form-data"):
            mp = await req.multipart()
            async for part in mp:
                if part.filename or part.name in ("file", None):
                    name = part.filename or ""
                    pct = part.headers.get("Content-Type", "")
                    if pct and pct != "application/octet-stream":
                        mime = pct
                    data = await part.read()
                    break
        else:
            data = await req.read()
            if ctype and ctype != "application/octet-stream":
                mime = ctype.split(";")[0]
        if not data:
            return web.json_response({"error": "no file content"},
                                     status=400)
        q = req.query
        try:
            async with WeedClient(self.url, session=self._http,
                                  jwt_key=self.jwt_key) as c:
                a = await c.assign(collection=q.get("collection", ""),
                                   replication=q.get("replication", ""),
                                   ttl=q.get("ttl", ""))
                if "fid" not in a:
                    return web.json_response(a, status=500)
                await c.upload(a["fid"], a["url"], data, mime=mime,
                               ttl=q.get("ttl", ""), auth=a.get("auth", ""))
        except (OperationError, aiohttp.ClientError,
                asyncio.TimeoutError, OSError) as e:
            # keep the JSON error contract even for connection-level
            # failures between assign and upload
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({
            "fid": a["fid"],
            "fileUrl": f"{a.get('publicUrl') or a['url']}/{a['fid']}",
            "fileName": name, "size": len(data)})

    async def h_fid_redirect(self, req: web.Request) -> web.Response:
        """GET /<fid>: redirect to a volume server holding the volume
        (master_server.go:121 redirectHandler)."""
        if not self.is_leader:
            # topology is heartbeat-fed on the leader only; bounce the
            # CLIENT there (proxying would buffer whole blobs in this
            # process and swallow the leader's redirect)
            leader, err = self._leader_or_503()
            if err is not None:
                return err
            raise web.HTTPFound(
                location=tls.url(leader, f"/{req.match_info['fid']}"),
                headers={"X-Raft-Leader": leader})
        fid = req.match_info["fid"]
        vid_s = fid.split(",")[0]
        try:
            vid = int(vid_s)
        except ValueError:
            return web.json_response({"error": f"bad fileId {fid!r}"},
                                     status=404)
        nodes = self.topo.lookup(vid)
        if not nodes:
            return web.json_response(
                {"error": f"volume {vid} not found"}, status=404)
        loc = nodes[hash(fid) % len(nodes)]
        raise web.HTTPMovedPermanently(
            location=tls.url(loc.public_url or loc.url, f"/{fid}"))

    async def h_dir_status(self, req: web.Request) -> web.Response:
        dcs = []
        for dc in self.topo.data_centers.values():
            racks = []
            for r in dc.racks.values():
                racks.append({
                    "id": r.id,
                    "nodes": [{
                        "id": n.id, "url": n.url, "publicUrl": n.public_url,
                        "volumes": len(n.volumes),
                        "ecShards": n.ec_shard_count(),
                        "max": n.max_volume_count,
                    } for n in r.nodes.values()],
                })
            dcs.append({"id": dc.id, "racks": racks})
        return web.json_response({
            "topology": {"datacenters": dcs,
                         "max_volume_id": self.topo.max_volume_id},
            "version": "seaweedfs_tpu 0.1",
        })

    async def h_volumes(self, req: web.Request) -> web.Response:
        """VolumeList analog: every volume + EC shard set with locations."""
        if not self.is_leader:
            return self._redirect_to_leader(req)
        out = []
        for node in self.topo.all_nodes():
            out.append({
                "url": node.url, "publicUrl": node.public_url,
                "dataCenter": node.rack.data_center.id if node.rack else "",
                "rack": node.rack.id if node.rack else "",
                "maxVolumes": node.max_volume_count,
                "freeSlots": node.free_space(),
                "volumes": [m.to_dict() for m in node.volumes.values()],
                "ecShards": [m.to_dict() for m in node.ec_shards.values()],
            })
        return web.json_response({
            "nodes": out,
            "volumeSizeLimitMB": self.volume_size_limit >> 20})

    async def h_ec_lookup(self, req: web.Request) -> web.Response:
        """vid -> {shard_id: [urls]} (LookupEcVolume, topology_ec.go:97-133)."""
        if not self.is_leader:
            return self._redirect_to_leader(req)
        vid = int(req.query["volumeId"])
        by_shard = self.topo.ec_shard_locations.get(vid)
        if not by_shard:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({
            "volumeId": vid,
            "shards": {str(sid): [n.url for n in nodes]
                       for sid, nodes in by_shard.items()},
        })

    async def h_cluster_status(self, req: web.Request) -> web.Response:
        return web.json_response({
            "isLeader": self.is_leader,
            "leader": self.leader_url or "",
            "term": self.election.term if self.election else 0,
            "peers": self._peers})

    async def h_grow(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            return self._redirect_to_leader(req)
        q = req.query
        collection = q.get("collection", "")
        replication = q.get("replication", "") or self.default_replication
        ttl = q.get("ttl", "")
        count = int(q.get("count", 1) or 1)
        rp = ReplicaPlacement.parse(replication)
        lay = self._layout(collection, replication, ttl)
        grown = 0
        for _ in range(count):
            try:
                await self._grow(lay, rp, collection, replication, ttl,
                                 q.get("dataCenter", ""))
                grown += 1
            except PlacementError as e:
                return web.json_response(
                    {"error": str(e), "count": grown}, status=500)
        return web.json_response({"count": grown})

    async def h_collection_delete(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            return self._redirect_to_leader(req)
        collection = req.query.get("collection", "")
        deleted = []
        for node in self.topo.all_nodes():
            vids = [m.id for m in node.volumes.values()
                    if m.collection == collection]
            for vid in vids:
                # chaos site: per-holder delete dispatch — a failed hop
                # surfaces as a bounded 503 with the partial result
                try:
                    await failpoints.fail("master.col_delete")
                    async with self._http.post(
                            tls.url(node.url, "/admin/volume/delete"),
                            params={"volume": str(vid)}) as resp:
                        await resp.read()
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError) as e:
                    return web.json_response(
                        {"error": f"delete vid {vid} on {node.url}: {e}",
                         "deleted": sorted(set(deleted))}, status=503)
                deleted.append(vid)
        return web.json_response({"deleted": sorted(set(deleted))})

    async def h_ui(self, req: web.Request) -> web.Response:
        """Live cluster status page (server/master_ui/templates.go)."""
        from html import escape
        rows = []
        for node in self.topo.all_nodes():
            # heartbeat-supplied strings are untrusted: escape everything
            dc = escape(node.rack.data_center.id if node.rack else "")
            rack = escape(node.rack.id if node.rack else "")
            url = escape(node.url)
            # under mesh mTLS a browser can't present the role client
            # cert, so don't render a link it cannot follow
            cell = (url if tls.enabled() else
                    f"<a href='{escape(tls.url(node.url, '/ui'), quote=True)}'>"
                    f"{url}</a>")
            rows.append(
                f"<tr><td>{dc}</td><td>{rack}</td>"
                f"<td>{cell}</td><td>{len(node.volumes)}</td>"
                f"<td>{node.ec_shard_count()}</td>"
                f"<td>{node.max_volume_count}</td></tr>")
        html = f"""<!DOCTYPE html><html><head><title>seaweedfs_tpu master
</title></head><body><h1>seaweedfs_tpu master {self.url}</h1>
<p>leader: {self.leader_url or '(none)'} | term:
{self.election.term if self.election else 0} | max volume id:
{self.topo.max_volume_id} | sequencer at: {self.seq.peek()}</p>
<h2>Topology</h2>
<table border=1 cellpadding=4><tr><th>DC</th><th>Rack</th><th>Node</th>
<th>Volumes</th><th>EC shards</th><th>Max</th></tr>{''.join(rows)}</table>
</body></html>"""
        return web.Response(text=html, content_type="text/html")

    # ---- watch stream (KeepConnected pubsub, master_grpc_server.go:181) ----

    def _publish(self, update: dict) -> None:
        for q in self._watchers:
            q.put_nowait(update)

    async def h_watch(self, req: web.Request) -> web.StreamResponse:
        if not self.is_leader:
            # a follower has no topology; hand the subscriber the leader
            # hint (wdclient reconnects there, masterclient.py:158-162)
            resp = web.StreamResponse(
                headers={"Content-Type": "application/x-ndjson"})
            await resp.prepare(req)
            await resp.write(json.dumps(
                {"leader": self.leader_url or ""}).encode() + b"\n")
            await resp.write_eof()
            return resp
        resp = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(req)
        # register BEFORE writing the snapshot: each write awaits, and a
        # delta published mid-snapshot would otherwise be lost to this
        # subscriber forever (apply is idempotent, so the duplicate a
        # racing delta can cause is harmless)
        q: asyncio.Queue = asyncio.Queue()
        self._watchers.append(q)
        try:
            # initial full state (snapshot: heartbeats mutate these dicts)
            for vid, locs in list(self.topo.volume_locations.items()):
                for n in list(locs.values()):
                    await resp.write(json.dumps({
                        "url": n.url, "public_url": n.public_url,
                        "new_vids": [vid],
                        "deleted_vids": []}).encode() + b"\n")
            # explicit end-of-snapshot marker so subscribers know when
            # their map is complete (KeepConnected's initial sync boundary)
            await resp.write(b'{"synced": true}\n')
            while True:
                if not self.is_leader:
                    # deposed mid-stream: this master no longer receives
                    # heartbeats, so the subscriber's map would silently
                    # go stale; redirect it to the new leader
                    await resp.write(json.dumps(
                        {"leader": self.leader_url or ""}).encode() + b"\n")
                    break
                try:
                    update = await asyncio.wait_for(q.get(), timeout=1.0)
                except asyncio.TimeoutError:
                    # keepalive doubles as disconnect detection, so dead
                    # subscribers don't pin the handler (and shutdown
                    # isn't held hostage by the blocking q.get())
                    await resp.write(b"\n")
                    continue
                await resp.write(json.dumps(update).encode() + b"\n")
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            self._watchers.remove(q)
        return resp

    # ---- automatic maintenance (leader-only) ----

    async def h_autopilot(self, req: web.Request) -> web.Response:
        """/debug/autopilot: maintenance-plane status (plan queue,
        in-flight actions, per-cycle ledgers incl. dry-run). POST
        ?run=1 forces one observe -> plan -> execute cycle NOW and
        returns its report — how tests and the heal soak drive
        deterministic convergence. Leader-only for POST: a follower
        has no topology to observe."""
        if req.method == "POST":
            if req.query.get("run", "") not in ("1", "true"):
                return web.json_response(
                    {"error": "POST wants ?run=1"}, status=400)
            if not self.is_leader:
                return web.json_response(
                    {"error": "not leader",
                     "leader": self.leader_url or ""}, status=503)
            report = await self.autopilot.run_cycle()
            return web.json_response({
                "cycle": report, "status": self.autopilot.status()})
        if req.method != "GET":
            return web.json_response({"error": "method not allowed"},
                                     status=405)
        return web.json_response({"autopilot": self.autopilot.status()})

    async def _auto_vacuum_loop(self) -> None:
        """Vacuum volumes whose garbage ratio exceeds the threshold, with
        no shell interaction (topology_event_handling.go:22-28; the
        reference's topo.Vacuum timer)."""
        from ..shell import volume_commands as vc
        from ..shell.env import CommandEnv
        while True:
            await asyncio.sleep(self.maintenance_interval_s)
            if not self.is_leader:
                continue
            try:
                async with CommandEnv(self.url,
                                      session=self._http) as env:
                    res = await vc.volume_vacuum(env,
                                                 self.garbage_threshold)
                if res:
                    glog.info("auto-vacuum: %s", res)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — upkeep must not die
                glog.warning("auto-vacuum failed: %s", e)

    async def _admin_scripts_loop(self) -> None:
        """Run the configured admin script lines (master.toml
        [master.maintenance] scripts) every sleep interval
        (master_server.go:186-250 startAdminScripts)."""
        from ..shell.env import CommandEnv
        from ..shell.runner import dispatch
        while True:
            await asyncio.sleep(self.admin_scripts_interval_s)
            if not self.is_leader:
                continue
            for line in self.admin_scripts:
                try:
                    async with CommandEnv(self.url,
                                          session=self._http) as env:
                        res = await dispatch(env, line)
                    glog.V(1).infof("admin script %r: %s", line, res)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    glog.warning("admin script %r failed: %s", line, e)

    # ---- liveness sweep (topology_event_handling.go:13-21) ----

    async def _liveness_loop(self) -> None:
        while True:
            await asyncio.sleep(self.topo.pulse_seconds)
            for node in self.topo.dead_nodes():
                vids = self.topo.unregister_node(node)
                for lay in self.layouts.values():
                    for vid in vids:
                        # volumes that lost replicas below quorum stop
                        # being writable until re-registered
                        if vid in lay.writable and not self.topo.lookup(vid):
                            lay.set_writable(vid, False)
                self._publish({"url": node.url,
                               "public_url": node.public_url,
                               "new_vids": [],
                               "deleted_vids": sorted(set(vids))})
