"""Master consensus: a compact raft with a replicated log + snapshots.

Reference: weed/server/raft_server.go:28-97 runs chrislusf/raft with
log + snapshotting; the only command the reference ever replicates is
MaxVolumeIdCommand (topology/cluster_commands.go:9-29), with leader
identity surfaced to volume servers in heartbeat responses
(master_grpc_server.go:165-175) and non-leader HTTP proxied to the
leader (master_server.go:153-185).

This module implements the same machinery natively: term-based election
with log-freshness vote checks, an AppendEntries log with conflict
truncation and per-peer next/match tracking, quorum commit, a leader
lease (a partitioned leader steps down before the majority elects a
successor — the split-brain window the round-4 verdict flagged), and
log-compaction snapshots with InstallSnapshot for lagging peers. The
state machine is the reference's: the MaxVolumeId watermark.

Wire surface (HTTP, mTLS-scoped like the reference's raft transport):
  POST /raft/vote       {term, candidate, last_log_index, last_log_term}
  POST /raft/heartbeat  {term, leader, prev_index, prev_term,
                         entries: [{term, cmd}], commit}
  POST /raft/snapshot   {term, leader, last_index, last_term, value}

A copy of seaweedfs_tpu/master/election.py in the PyTorch port.
"""

from __future__ import annotations

from ..security import tls

import asyncio
import json
import os
import random
import time

import aiohttp

from ..util import events, failpoints, glog, tracing
from ..util.frame import FrameChannelError, FrameHub

# compact the log once it outgrows this many entries (each entry is one
# volume-id bump; the reference's raft snapshots on a size threshold too)
SNAPSHOT_THRESHOLD = 64


class Election:
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"

    @staticmethod
    def _norm(url: str) -> str:
        host, _, port = url.strip().partition(":")
        if host in ("localhost", ""):
            host = "127.0.0.1"
        return f"{host}:{port}"

    def __init__(self, me: str, peers: list[str],
                 election_timeout: tuple[float, float] = (1.0, 2.0),
                 pulse: float = 0.3,
                 state_path: str | None = None,
                 jwt_key: str = ""):
        self.me = self._norm(me)
        # peers excludes self (normalized, so localhost == 127.0.0.1);
        # empty peers == single-master mode
        self.peers = [p for p in map(self._norm, peers) if p != self.me]
        self.single = not self.peers
        self.majority = (len(self.peers) + 1) // 2 + 1
        self.timeout_range = election_timeout
        self.pulse = pulse
        # per-attempt RPC deadline, strictly shorter than the minimum
        # election timeout: one hung peer socket must never stretch a
        # vote fan-out (or a replication round) past the next timeout
        # fire — the campaign would then collide with its own retry
        # forever instead of re-randomizing
        self.attempt_timeout = max(0.05, min(election_timeout[0] * 0.5,
                                             pulse * 2))
        self.term = 0
        self.voted_for: str | None = None
        # replicated log: absolute index = snap.last_index + 1 + pos.
        # `value` is the applied MaxVolumeId watermark; `seq` the applied
        # file-id reservation ceiling (ids below it are spoken for by
        # some committed reservation window — sequence.RaftSequencer)
        self.snap = {"last_index": 0, "last_term": 0, "value": 0,
                     "seq": 0, "shard_epoch": 0, "shard_map": None}
        self.entries: list[dict] = []
        self.commit = 0
        self.applied = 0
        self.applied_value = 0
        self.applied_seq = 0
        # applied filer shard map (filer/shard.py): epoch + the last
        # committed map dict; transitions CAS on the epoch at APPLY
        # time so a deposed leader's stale map proposal is a no-op
        self.applied_shard_epoch = 0
        self.applied_shard: dict | None = None
        # durable (term, votedFor, snapshot, log), written BEFORE any
        # vote/append takes effect: without it a restarted master forgets
        # it voted and can grant a second vote in the same term — a
        # split-brain window the reference's raft layer persists away
        # (raft_server.go:60-76)
        self.state_path = state_path
        if state_path and os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    st = json.load(f)
                self.term = int(st.get("term", 0))
                self.voted_for = st.get("voted_for") or None
                self.snap = st.get("snapshot", self.snap)
                self.entries = st.get("entries", [])
            except (OSError, ValueError) as e:
                raise SystemExit(
                    f"election state {state_path} unreadable/corrupt: {e};"
                    f" repair or remove it explicitly") from e
            self.snap.setdefault("seq", 0)   # pre-HA state files
            self.snap.setdefault("shard_epoch", 0)   # pre-shard files
            self.snap.setdefault("shard_map", None)
            self.commit = self.applied = self.snap["last_index"]
            self.applied_value = self.snap["value"]
            self.applied_seq = self.snap["seq"]
            self.applied_shard_epoch = self.snap["shard_epoch"]
            self.applied_shard = self.snap["shard_map"]
        self.role = self.LEADER if self.single else self.FOLLOWER
        self.leader: str | None = self.me if self.single else None
        self.last_pulse = time.monotonic()
        # last time a leader round reached a quorum (leader lease)
        self._last_quorum = time.monotonic()
        # leader-side replication cursors (valid while role == LEADER)
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        # replicated value (MaxVolumeId) exchange hooks, set by MasterServer
        self.get_max_volume_id = lambda: 0
        self.adopt_max_volume_id = lambda v: None
        # replicated fid-reservation hook (sequence.RaftSequencer):
        # called at APPLY time for every committed seq_reserve window,
        # in log order, with the entry's author and term so only the
        # reserving leader claims the window it committed
        self.adopt_seq_window = lambda start, end, by, term: None
        # replicated filer shard map hook (MasterServer mirrors the
        # applied map for /cluster/shards), called at APPLY time
        self.adopt_shard_map = lambda epoch, shard_map: None
        self._http: aiohttp.ClientSession | None = None
        # frame fabric: one persistent multiplexed channel per raft
        # peer (HELLO identity signed with the cluster jwt key when
        # set), with per-attempt channel deadlines; any frame failure
        # falls back to the aiohttp POST below
        self.jwt_key = jwt_key
        self.frame_hub: FrameHub | None = None
        self._task: asyncio.Task | None = None
        # deferred-durability machinery: sync mutators mark, async
        # call sites flush before the state is acted on
        self._dirty = False
        self._flush_lock = asyncio.Lock()
        # one replicated command in flight at a time: two interleaved
        # append_command drivers would race next_index bookkeeping
        self._append_lock = asyncio.Lock()
        # last leader identity this node journaled (change detection)
        self._noted_leader: str | None = None
        if self.single:
            # leader by fiat: journal + gauges so a single-mode master
            # is observable through the same surfaces as a quorum one
            self._note_leader(self.me)
        self._update_gauges()

    # ---- observability (journal + gauges) ----

    def _note_leader(self, leader: str | None) -> None:
        """Journal a leadership change exactly once per transition —
        every node records the change it OBSERVED (wall_ms deltas
        across the fleet bound the failover window)."""
        if leader == self._noted_leader or not leader:
            return
        self._noted_leader = leader
        events.record("raft_leader_change", leader=leader,
                      term=self.term, me=self.me,
                      role=self.role, single=self.single)

    def _update_gauges(self) -> None:
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        metrics.RAFT_TERM.set(self.term)
        metrics.RAFT_COMMIT_INDEX.set(self.commit)
        metrics.RAFT_IS_LEADER.set(1 if self.is_leader else 0)

    @property
    def is_leader(self) -> bool:
        return self.role == self.LEADER

    # ---- log primitives ----

    def last_index(self) -> int:
        return self.snap["last_index"] + len(self.entries)

    def last_log_term(self) -> int:
        return (self.entries[-1]["term"] if self.entries
                else self.snap["last_term"])

    def _term_at(self, idx: int) -> int | None:
        if idx == self.snap["last_index"]:
            return self.snap["last_term"]
        pos = idx - self.snap["last_index"] - 1
        if 0 <= pos < len(self.entries):
            return self.entries[pos]["term"]
        return None

    def _mark_dirty(self) -> None:
        """Record that (term, votedFor, snapshot, log) changed. The
        change becomes durable at the next ``flush()`` — and every RPC
        reply / vote solicitation / replication round flushes BEFORE
        acting on the state (raft durability rule), so the guarantee
        is unchanged from the old write-inline ``_persist``; only the
        fsync moved off the event loop."""
        self._dirty = True

    def _state_payload(self) -> str:
        return json.dumps({"term": self.term,
                           "voted_for": self.voted_for,
                           "snapshot": self.snap,
                           "entries": self.entries})

    def _write_state(self, payload: str) -> None:
        """Atomic checkpoint write (tmp + fsync + rename); runs on the
        executor so a slow disk never stalls the loop serving every
        master request."""
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    async def flush(self) -> None:
        """Make every marked state change durable. Serialization
        happens on the loop under the flush lock (so the snapshot is
        internally consistent), the write+fsync on the executor. A
        failed write re-marks dirty and re-raises — the caller's RPC
        reply must not leave the node claiming durability it lacks."""
        if not self.state_path or not self._dirty:
            return
        async with self._flush_lock:
            if not self._dirty:
                return          # a racing flush already covered us
            self._dirty = False
            payload = self._state_payload()
            try:
                await tracing.run_in_executor(self._write_state, payload)
            except OSError:
                self._dirty = True
                raise

    def _apply_committed(self) -> None:
        while self.applied < self.commit:
            self.applied += 1
            pos = self.applied - self.snap["last_index"] - 1
            entry = self.entries[pos]
            cmd = entry["cmd"]
            v = int(cmd.get("max_volume_id", 0))
            if v > self.applied_value:
                self.applied_value = v
                self.adopt_max_volume_id(v)
            # fid reservation window: RELATIVE by construction — the
            # window is [applied_seq, applied_seq + n) at APPLY time,
            # so windows partition the id space in log order no matter
            # how stale the reserving leader's view was when it
            # appended (a new leader's first reservation always lands
            # ABOVE every window a deposed predecessor committed)
            n = int(cmd.get("seq_reserve", 0))
            if n > 0:
                start = self.applied_seq
                self.applied_seq = start + n
                self.adopt_seq_window(start, self.applied_seq,
                                      cmd.get("by", ""),
                                      int(entry.get("term", -1)))
            sm = cmd.get("shard_map")
            if sm is not None:
                self._apply_shard_map(sm)
        self._maybe_snapshot()
        self._update_gauges()

    def _apply_shard_map(self, sm: dict) -> None:
        """Shard-map transition at APPLY time: a compare-and-swap on
        the applied epoch. Like seq_reserve windows, the outcome is
        decided by LOG ORDER, not by the proposer's view — a deposed
        leader's proposal built on a stale epoch applies as a no-op,
        so two leaders can never interleave conflicting maps."""
        if int(sm.get("base", -1)) != self.applied_shard_epoch:
            return
        self.applied_shard_epoch += 1
        m = dict(sm.get("map") or {})
        m["epoch"] = self.applied_shard_epoch
        self.applied_shard = m
        self.adopt_shard_map(self.applied_shard_epoch, m)

    def _maybe_snapshot(self) -> None:
        """Log compaction (the reference's raft snapshot): fold applied
        entries into the snapshot once the log outgrows the threshold."""
        if len(self.entries) <= SNAPSHOT_THRESHOLD \
                or self.applied <= self.snap["last_index"]:
            return
        cut = self.applied - self.snap["last_index"]
        self.snap = {"last_index": self.applied,
                     "last_term": self._term_at(self.applied) or 0,
                     "value": self.applied_value,
                     "seq": self.applied_seq,
                     "shard_epoch": self.applied_shard_epoch,
                     "shard_map": self.applied_shard}
        self.entries = self.entries[cut:]
        self._mark_dirty()
        glog.info("%s: snapshot at index %d (value %d, %d entries kept)",
                  self.me, self.applied, self.applied_value,
                  len(self.entries))

    # ------------------------------------------------------------------
    async def start(self) -> None:
        if self.single:
            return
        self._http = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=max(self.pulse * 2, 0.5)))
        self.frame_hub = FrameHub(ssl=tls.client_ctx(),
                                  jwt_key=self.jwt_key,
                                  request_timeout=self.attempt_timeout)
        self.last_pulse = time.monotonic()
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        # drain any dirt a cancelled replication round left behind.
        # Correctness never depends on this (every acted-on change was
        # flushed before the action), but a clean shutdown should not
        # discard a term bump it already observed.
        try:
            await self.flush()
        except OSError as e:
            glog.warning("%s: final raft-state flush failed: %s",
                         self.me, e)
        if self.frame_hub:
            await self.frame_hub.close()
        if self._http:
            await self._http.close()

    # ---- incoming RPCs (wired as HTTP handlers by MasterServer) ----

    def on_vote_request(self, term: int, candidate: str,
                        max_volume_id: int = 0,
                        last_log_index: int | None = None,
                        last_log_term: int | None = None) -> dict:
        if self.single:
            # a single-mode master is not part of any quorum; never let a
            # misconfigured peer demote it (it has no loop to recover)
            return {"term": self.term, "granted": False}
        if candidate == self.me:
            # our own vote request routed back to us through a peer-list
            # entry that is really our address: only the local self-vote
            # in _campaign counts
            return {"term": self.term, "granted": False}
        bumped = term > self.term
        if bumped:
            self.term = term
            self.voted_for = None
            self._step_down()
        # raft log-freshness rule: never elect a candidate whose log is
        # behind ours (it would reissue already-used volume ids). When
        # the candidate sends log coordinates use them; fall back to the
        # MaxVolumeId watermark for bare requests.
        if last_log_index is not None:
            fresh = ((last_log_term or 0, last_log_index)
                     >= (self.last_log_term(), self.last_index()))
        else:
            fresh = max_volume_id >= max(self.get_max_volume_id(),
                                         self.applied_value)
        granted = (term == self.term
                   and self.voted_for in (None, candidate)
                   and fresh)
        if granted:
            self.voted_for = candidate
            self.last_pulse = time.monotonic()
        if granted or bumped:
            self._mark_dirty()  # the handler flushes before replying
        self._update_gauges()
        return {"term": self.term, "granted": granted}

    def on_append(self, term: int, leader: str, prev_index: int,
                  prev_term: int, entries: list[dict],
                  leader_commit: int) -> dict:
        """AppendEntries: leader pulse + log replication + commit."""
        if self.single:
            return {"term": self.term, "ok": False}
        if term < self.term:
            return {"term": self.term, "ok": False,
                    "last": self.last_index()}
        if term > self.term:
            self.voted_for = None
            self.term = term
            self._mark_dirty()
        self.leader = leader
        if leader != self.me:
            self._step_down()
        self._note_leader(leader)
        self.last_pulse = time.monotonic()
        # consistency check at prev (entries already folded into the
        # snapshot are by definition committed => consistent)
        if prev_index < self.snap["last_index"]:
            drop = self.snap["last_index"] - prev_index
            entries = entries[drop:]
            prev_index = self.snap["last_index"]
            prev_term = self.snap["last_term"]
        pt = self._term_at(prev_index)
        if pt is None or pt != prev_term:
            return {"term": self.term, "ok": False,
                    "last": self.last_index()}
        changed = False
        for i, e in enumerate(entries):
            idx = prev_index + 1 + i
            have = self._term_at(idx)
            if have is None:
                self.entries.append(e)
                changed = True
            elif have != e["term"]:
                # conflict: truncate ours from idx on, take the leader's
                pos = idx - self.snap["last_index"] - 1
                del self.entries[pos:]
                self.entries.append(e)
                changed = True
        if changed:
            self._mark_dirty()
        match = prev_index + len(entries)
        if leader_commit > self.commit:
            self.commit = min(leader_commit, self.last_index())
            self._apply_committed()
        self._update_gauges()
        return {"term": self.term, "ok": True, "match": match}

    def on_install_snapshot(self, term: int, leader: str, last_index: int,
                            last_term: int, value: int,
                            seq: int = 0, shard_epoch: int = 0,
                            shard_map: dict | None = None) -> dict:
        """InstallSnapshot for followers whose log is behind the leader's
        compaction point."""
        if self.single or term < self.term:
            return {"term": self.term, "ok": False}
        if term > self.term:
            self.voted_for = None
            self.term = term
            # persist NOW, even when the snapshot turns out stale below:
            # currentTerm durability must not depend on installation, or
            # a restart forgets the bump and this node can double-vote
            self._mark_dirty()
        self.leader = leader
        self._step_down()
        self._note_leader(leader)
        self.last_pulse = time.monotonic()
        if last_index > self.last_index():
            self.snap = {"last_index": last_index, "last_term": last_term,
                         "value": value, "seq": seq,
                         "shard_epoch": shard_epoch,
                         "shard_map": shard_map}
            self.entries = []
            self.commit = self.applied = last_index
            if value > self.applied_value:
                self.applied_value = value
                self.adopt_max_volume_id(value)
            if seq > self.applied_seq:
                # folded reservation windows: adopt as foreign (by=""),
                # so the installing node fences its counter past them
                self.applied_seq = seq
                self.adopt_seq_window(0, seq, "", -1)
            if shard_epoch > self.applied_shard_epoch:
                # folded shard-map transitions: adopt the compacted map
                self.applied_shard_epoch = shard_epoch
                self.applied_shard = shard_map
                self.adopt_shard_map(shard_epoch, shard_map or {})
            self._mark_dirty()
        self._update_gauges()
        return {"term": self.term, "ok": True}

    # back-compat alias: the round-4 pulse RPC carried the value inline
    def on_leader_pulse(self, term: int, leader: str,
                        max_volume_id: int) -> dict:
        r = self.on_append(term, leader, self.last_index(),
                           self.last_log_term(), [], self.commit)
        if r.get("ok") and max_volume_id > self.applied_value:
            self.adopt_max_volume_id(max_volume_id)
        return r

    def _step_down(self) -> None:
        if self.role != self.FOLLOWER:
            glog.info("%s: stepping down from %s at term %d",
                      self.me, self.role, self.term)
            if self.role == self.LEADER:
                # journal only real depositions (candidate -> follower
                # happens every lost election and would flood the ring)
                events.record("raft_step_down", me=self.me,
                              term=self.term)
            self.role = self.FOLLOWER
            self._update_gauges()

    # ---- outgoing RPC transport (frames first, HTTP fallback) ----

    async def _raft_rpc(self, peer: str, path: str,
                        payload: dict) -> dict:
        """POST one raft RPC to `peer`, riding the persistent frame
        channel when the peer speaks it and dropping to the aiohttp
        session otherwise. The caller supplies the per-attempt
        wait_for; the channel deadline here bounds the frame leg so a
        refused/sick channel still leaves time for the HTTP leg."""
        if self.frame_hub is not None:
            try:
                # chaos site: force the frame leg down so chaos/ha
                # proves raft stays correct on the HTTP fallback
                await failpoints.fail("master.raft.frame")
                chan = self.frame_hub.get(target=peer)
                status, _, body = await chan.request(
                    "POST", path,
                    headers={"content-type": "application/json"},
                    body=json.dumps(payload).encode(),
                    timeout=self.attempt_timeout)
                if status == 200:
                    return json.loads(body)
            except (FrameChannelError, OSError, ValueError):
                pass    # breaker-open / severed / refused -> HTTP
        async with self._http.post(tls.url(peer, path),
                                   json=payload) as resp:
            return await resp.json()

    # ---- the election / heartbeat loop ----

    async def _loop(self) -> None:
        while True:
            if self.role == self.LEADER:
                await self._replicate_round()
                # leader lease: a leader partitioned from every peer must
                # stop serving writes before the others elect a successor,
                # or two masters assign volume ids concurrently
                if time.monotonic() - self._last_quorum \
                        > self.timeout_range[0] * 0.8:
                    self._step_down()
                    self.leader = None
                    self.last_pulse = time.monotonic()
                await asyncio.sleep(self.pulse)
            else:
                timeout = random.uniform(*self.timeout_range)
                await asyncio.sleep(self.pulse / 2)
                if time.monotonic() - self.last_pulse > timeout:
                    await self._campaign()

    async def _campaign(self) -> None:
        self.role = self.CANDIDATE
        self.term += 1
        term = self.term
        self.voted_for = self.me
        self._mark_dirty()
        await self.flush()   # self-vote durable before soliciting
        self.leader = None
        votes = 1  # self-vote

        async def ask(peer: str) -> bool:
            try:
                # chaos site: error/latency/drop model a dead, slow or
                # partitioned peer on the vote fan-out. The wait_for is
                # the per-ATTEMPT deadline: one hung peer socket (or an
                # armed latency) must not stretch this campaign past
                # the next election-timeout fire
                async def one() -> dict:
                    await failpoints.fail("master.vote")
                    return await self._raft_rpc(
                        peer, "/raft/vote",
                        {"term": term, "candidate": self.me,
                         "last_log_index": self.last_index(),
                         "last_log_term": self.last_log_term(),
                         "max_volume_id": self.get_max_volume_id()})
                body = await asyncio.wait_for(one(), self.attempt_timeout)
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                return False
            if body.get("term", 0) > self.term:
                self.term = body["term"]
                self.voted_for = None
                self._mark_dirty()
                self._step_down()
            return bool(body.get("granted"))

        results = await asyncio.gather(*(ask(p) for p in self.peers))
        votes += sum(results)
        if self.role == self.CANDIDATE and self.term == term \
                and votes >= self.majority:
            glog.info("%s: elected leader at term %d (%d/%d votes)",
                      self.me, term, votes, len(self.peers) + 1)
            self.role = self.LEADER
            self.leader = self.me
            self._note_leader(self.me)
            self._last_quorum = time.monotonic()
            # raft leader init: replicate from the end, learn backwards
            self.next_index = {p: self.last_index() + 1
                               for p in self.peers}
            self.match_index = {p: 0 for p in self.peers}
            self._update_gauges()
            await self._replicate_round()
        else:
            self._step_down()
            # reset the election timer: retrying immediately would keep
            # split candidates colliding in lockstep (the randomized
            # timeout only de-syncs them if both wait a fresh one)
            self.last_pulse = time.monotonic()
            self._update_gauges()

    async def _replicate_round(self) -> int:
        """One AppendEntries round to every peer: heartbeat, log catch-up
        (with InstallSnapshot below the compaction point), match/commit
        advancement, lease refresh. Returns acks incl. self."""

        async def send(peer: str) -> bool:
            ni = self.next_index.get(peer, self.last_index() + 1)
            try:
                if ni <= self.snap["last_index"]:
                    # peer is behind our compaction point. Chaos site:
                    # a dropped/failed InstallSnapshot models a
                    # partition mid-catch-up
                    async def snap_rpc() -> dict:
                        await failpoints.fail("master.snapshot")
                        return await self._raft_rpc(
                            peer, "/raft/snapshot",
                            {"term": self.term, "leader": self.me,
                             "last_index": self.snap["last_index"],
                             "last_term": self.snap["last_term"],
                             "value": self.snap["value"],
                             "seq": self.snap["seq"],
                             "shard_epoch": self.snap.get(
                                 "shard_epoch", 0),
                             "shard_map": self.snap.get("shard_map")})
                    reply = await asyncio.wait_for(snap_rpc(),
                                                   self.attempt_timeout)
                    if reply.get("term", 0) > self.term:
                        self._adopt_higher_term(reply["term"])
                        return False
                    if reply.get("ok"):
                        self.next_index[peer] = self.snap["last_index"] + 1
                        self.match_index[peer] = self.snap["last_index"]
                        return True
                    return False
                prev = ni - 1
                pos = prev - self.snap["last_index"]
                batch = self.entries[pos:]

                # chaos site: error/latency/drop on the AppendEntries
                # pulse — `drop` on a leader partitions it outbound, so
                # its lease expires while a successor gets elected (the
                # exact window tools/chaos.py ha arms). Per-attempt
                # deadline so one hung follower cannot stall the round
                # past the lease/pulse cadence.
                async def append_rpc() -> dict:
                    await failpoints.fail("master.append")
                    return await self._raft_rpc(
                        peer, "/raft/heartbeat",
                        {"term": self.term, "leader": self.me,
                         "prev_index": prev,
                         "prev_term": self._term_at(prev) or 0,
                         "entries": batch,
                         "commit": self.commit,
                         # legacy field so a mid-upgrade peer still
                         # adopts the watermark
                         "max_volume_id": self.get_max_volume_id()})
                reply = await asyncio.wait_for(append_rpc(),
                                               self.attempt_timeout)
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                return False
            if reply.get("term", 0) > self.term:
                self._adopt_higher_term(reply["term"])
                return False
            if reply.get("ok"):
                m = int(reply.get("match", prev + len(batch)))
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0), m)
                self.next_index[peer] = self.match_index[peer] + 1
                return True
            # log mismatch: jump back using the follower's hint
            hint = int(reply.get("last", prev - 1))
            self.next_index[peer] = max(1, min(prev, hint + 1))
            return True  # the peer IS alive (acked the term)

        results = await asyncio.gather(*(send(p) for p in self.peers))
        acks = 1 + sum(results)
        if acks >= self.majority:
            self._last_quorum = time.monotonic()
        # quorum commit: largest N replicated on a majority with
        # log[N].term == currentTerm (the raft commit rule)
        if self.is_leader:
            matches = sorted(
                [self.last_index()]
                + [self.match_index.get(p, 0) for p in self.peers],
                reverse=True)
            n = matches[self.majority - 1]
            if n > self.commit and self._term_at(n) == self.term:
                self.commit = n
                self._apply_committed()
        # snapshot compaction / adopted-higher-term dirt from this
        # round becomes durable before the next round acts on it
        await self.flush()
        self._update_gauges()
        return acks

    def _adopt_higher_term(self, term: int) -> None:
        self.term = term
        self.voted_for = None
        self._mark_dirty()
        self._step_down()
        self._update_gauges()

    # ---- client surface ----

    async def append_command(self, cmd: dict,
                             rounds: int = 8) -> bool:
        """Leader-only: append `cmd` to the replicated log and drive
        replication until it commits (or this leader loses its standing).
        The reference raft-commits MaxVolumeIdCommand the same way before
        using a grown volume id (cluster_commands.go:23)."""
        if self.single:
            v = int(cmd.get("max_volume_id", 0))
            if v > self.applied_value:
                self.applied_value = v
            n = int(cmd.get("seq_reserve", 0))
            if n > 0:
                start = self.applied_seq
                self.applied_seq = start + n
                self.adopt_seq_window(start, self.applied_seq,
                                      cmd.get("by", ""), self.term)
            sm = cmd.get("shard_map")
            if sm is not None:
                self._apply_shard_map(sm)
            return True
        # serialize command commits: two interleaved append_command
        # drivers would race the per-peer next/match bookkeeping (and
        # their replication rounds would double-send suffixes)
        async with self._append_lock:
            if not self.is_leader:
                return False
            self.entries.append({"term": self.term, "cmd": cmd})
            self._mark_dirty()
            # the leader counts itself in the quorum, so its own log
            # entry must be durable before any peer acks are tallied
            await self.flush()
            idx = self.last_index()
            for _ in range(rounds):
                await self._replicate_round()
                if self.commit >= idx:
                    return True
                if not self.is_leader:
                    return False
                await asyncio.sleep(self.pulse / 4)
            return self.commit >= idx

    async def commit_max_volume_id(self) -> bool:
        """Synchronously replicate the current MaxVolumeId watermark to a
        quorum via the log; a value not acked by a majority may be lost
        on leader crash and reissued."""
        return await self.append_command(
            {"max_volume_id": self.get_max_volume_id()})
