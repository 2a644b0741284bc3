"""Tagged async scenarios: the REAL protocol cores, in-process, under
the controlled loop, each declaring the invariant its subsystem
documents.

Every scenario here is expected GREEN — a violation under any
schedule or injection is a real concurrency bug in the tree (the two
historical bug shapes that motivated the explorer live in
``fixtures.py``, re-introduced in mini-classes, and MUST be caught).

Scenario contract: ``build()`` returns a :class:`Run` whose ``tasks``
are ``(name, coroutine)`` pairs started as named root tasks and whose
``check()`` runs after the loop settles, returning violation strings
(empty = invariants held). ``victims`` names the root tasks whose
await points get CancelledError injected one at a time — the tasks a
disconnecting client or timeout would cancel in production. Scenario
code never reads the wall clock; sleeps ride the loop's virtual time.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Callable

# allocation attempts per client in the raft scenario — bounds the
# reserve/retry loop so a livelock shows up as a deadlock finding,
# not a step-budget crash
_ALLOC_TRIES = 60


@dataclass
class Run:
    tasks: list = field(default_factory=list)
    check: Callable[[], list] = lambda: []


class Scenario:
    def __init__(self, name: str, build, victims: tuple = (),
                 kind: str = "core", expect_violation: bool = False,
                 description: str = ""):
        self.name = name
        self.build = build
        self.victims = victims
        self.kind = kind
        self.expect_violation = expect_violation
        self.description = description


SCENARIOS: dict[str, Scenario] = {}


def scenario(name: str, victims: tuple = (), description: str = ""):
    def deco(build):
        SCENARIOS[name] = Scenario(name, build, victims=victims,
                                   description=description)
        return build
    return deco


# ---- raft sequencer: reserve/apply vs deposition ---------------------

PEERS = ["a:1", "b:2", "c:3"]


@scenario("raft-sequencer", victims=("alloc-a", "alloc-b"),
          description="two masters allocate fids across a mid-run "
                      "deposition; no fid may ever be issued twice")
def _raft_sequencer() -> Run:
    from seaweedfs_tpu_torch.master.election import Election
    from seaweedfs_tpu_torch.master.sequence import (MemorySequencer,
                                               RaftSequencer,
                                               SequenceBehind)

    a = Election("a:1", PEERS)
    a.role = Election.LEADER
    a.leader = a.me
    a.term = 1

    async def round_a() -> int:
        # a quorum round is a suspension point; acks only count while
        # this node still leads (the real round checks the same)
        await asyncio.sleep(0)
        if a.is_leader:
            a.commit = a.last_index()
            a._apply_committed()
        return 3

    a._replicate_round = round_a
    seq_a = RaftSequencer(MemorySequencer(), a, step=8)

    b = Election("b:2", PEERS)
    seq_b = RaftSequencer(MemorySequencer(), b, step=8)

    issued: dict[str, list] = {"a": [], "b": []}
    deposed = {"done": False}

    async def alloc(seq, out, n: int) -> None:
        for _ in range(_ALLOC_TRIES):
            if len(out) >= n:
                return
            try:
                out.append(seq.next_file_id())
            except SequenceBehind:
                if not await seq.reserve(1):
                    return          # deposed: the caller redirects
            await asyncio.sleep(0)

    async def depose() -> None:
        for _ in range(3):
            await asyncio.sleep(0)
        # the quorum contract, in one atomic step (no awaits): B holds
        # everything A's commits certified, then A observes the higher
        # term and B promotes
        r = b.on_append(1, "a:1", 0, 0, list(a.entries), a.commit)
        if not r.get("ok"):
            raise RuntimeError(f"log transfer refused: {r}")
        a._adopt_higher_term(2)
        b.role = Election.LEADER
        b.leader = b.me
        b.term = 2

        async def round_b() -> int:
            await asyncio.sleep(0)
            if b.is_leader:
                b.commit = b.last_index()
                b._apply_committed()
            return 3

        b._replicate_round = round_b
        deposed["done"] = True

    async def alloc_b() -> None:
        while not deposed["done"]:
            await asyncio.sleep(0)
        await alloc(seq_b, issued["b"], 6)

    def check() -> list:
        v = []
        for who, ids in sorted(issued.items()):
            if len(set(ids)) != len(ids):
                v.append(f"duplicate fids within {who}: {sorted(ids)}")
        cross = set(issued["a"]) & set(issued["b"])
        if cross:
            v.append(f"fid issued by BOTH masters: {sorted(cross)}")
        return v

    return Run(tasks=[("alloc-a", alloc(seq_a, issued["a"], 6)),
                      ("depose", depose()),
                      ("alloc-b", alloc_b())],
               check=check)


# ---- shard map: journaled ops, replicated replay ---------------------

@scenario("shard-replay", victims=("apply-1", "apply-2"),
          description="two replicas replay the committed op journal "
                      "(with a duplicate delivery) at their own pace; "
                      "they must converge to one map")
def _shard_replay() -> Run:
    from seaweedfs_tpu_torch.filer.shard import ShardMap, apply_map_op

    ops = [
        {"op": "set", "rules": [["/", 0], ["/a", 1]],
         "owners": {0: "f0:1", 1: "f1:1"}},
        {"op": "register", "shard": 2, "url": "f2:1"},
        {"op": "split_intent", "prefix": "/a/hot", "to": 2, "by": "op"},
        # duplicate delivery of the same intent: executors re-submit
        # after a crash and the transition must be idempotent
        {"op": "split_intent", "prefix": "/a/hot", "to": 2, "by": "op"},
        {"op": "commit_move", "id": "split:/a/hot"},
        {"op": "rename_intent", "src": "/a/x", "dst": "/b/y"},
        {"op": "commit_move", "id": "rename:/a/x:/b/y"},
    ]
    log: list = []
    replicas = [{"m": ShardMap(), "applied": 0},
                {"m": ShardMap(), "applied": 0}]

    async def propose() -> None:
        for op in ops:
            await asyncio.sleep(0)
            log.append(op)

    async def applier(r: dict) -> None:
        while r["applied"] < len(ops):
            if r["applied"] < len(log):
                # apply_map_op is pure (copy-on-write), so a replica
                # can never observe a half-applied transition
                r["m"] = apply_map_op(r["m"], log[r["applied"]])
                r["applied"] += 1
            await asyncio.sleep(0)

    def check() -> list:
        finals = []
        for r in replicas:
            m = r["m"]
            # crash-replay: a cancelled applier resumes from its
            # journal position — exactly what the executor does
            for op in log[r["applied"]:]:
                m = apply_map_op(m, op)
            finals.append(m.to_dict())
        v = []
        if finals[0] != finals[1]:
            v.append(f"replicas diverged: {finals[0]} != {finals[1]}")
        probe = finals[0] and ShardMap.from_dict(finals[0])
        for path in ("/a/hot/x", "/a/x", "/b/y", "/other"):
            s1 = ShardMap.from_dict(finals[0]).route(path)
            s2 = ShardMap.from_dict(finals[1]).route(path)
            if s1 != s2:
                v.append(f"{path} routes to {s1} vs {s2}")
        del probe
        return v

    return Run(tasks=[("propose", propose()),
                      ("apply-1", applier(replicas[0])),
                      ("apply-2", applier(replicas[1]))],
               check=check)


# ---- chunk cache: fenced fill vs invalidate --------------------------

@scenario("chunk-cache", victims=("fill-1", "fill-2"),
          description="concurrent fetch+fill against overwrite "
                      "invalidations; the cache must never serve "
                      "bytes older than the newest overwrite")
def _chunk_cache() -> Run:
    from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache

    cache = TieredChunkCache(mem_bytes=1 << 20, name="weedsched")
    src = {"v": 1}

    def body(v: int) -> bytes:
        return b"gen-%d" % v

    async def filler() -> None:
        for _ in range(3):
            token = cache.fill_token("fid")
            v = src["v"]
            await asyncio.sleep(0)      # the network fetch window
            await asyncio.sleep(0)
            cache.set_if("fid", body(v), token)
            await asyncio.sleep(0)

    async def overwrite() -> None:
        for _ in range(2):
            await asyncio.sleep(0)
            # bump + invalidate with no await between: one overwrite
            src["v"] += 1
            cache.delete("fid")
            await asyncio.sleep(0)

    def check() -> list:
        got = cache.get("fid")
        if got is not None and got != body(src["v"]):
            return [f"stale cache bytes {got!r}; newest overwrite is "
                    f"{body(src['v'])!r}"]
        return []

    return Run(tasks=[("fill-1", filler()), ("fill-2", filler()),
                      ("overwrite", overwrite())],
               check=check)


# ---- frame channel: multiplexed requests vs a severed wire -----------

class _FakeWriter:
    """In-memory peer-side of the wire: collects written frames for
    the responder task; close() severs it."""

    def __init__(self):
        self.buf = bytearray()
        self.closed = False

    def write(self, b: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("wire severed")
        self.buf += b

    async def drain(self) -> None:
        await asyncio.sleep(0)
        if self.closed:
            raise ConnectionResetError("wire severed")

    def close(self) -> None:
        self.closed = True


@scenario("frame-channel", victims=("req-1", "req-2"),
          description="multiplexed requests over one channel while "
                      "the wire is severed mid-flight; no pending "
                      "entry, window slot or waiter may leak")
def _frame_channel() -> Run:
    from seaweedfs_tpu_torch.util.frame import (RESP, FrameChannel,
                                          FrameChannelError,
                                          FrameDecoder, FrameFallback,
                                          encode_frame)

    chan = FrameChannel(target="peer:1", request_timeout=5.0)
    w = _FakeWriter()
    chan._writer = w
    chan._cwnd = 1.0        # window of 1: every extra request queues
    #                         in _acquire_slot, the leak-prone path
    chan._retry_at = 1e9    # no real reconnects: a severed writer
    #                         fails fast instead of opening sockets
    dec = FrameDecoder()
    results: dict[int, int] = {}

    async def peer() -> None:
        while not w.closed:
            if w.buf:
                frames = dec.feed(bytes(w.buf))
                del w.buf[:]
                for fr in frames:
                    rdec = FrameDecoder()
                    wire = encode_frame(RESP, fr.req_id, {"s": 200},
                                        b"ok")
                    for resp in rdec.feed(wire):
                        chan._dispatch(resp)
            await asyncio.sleep(0)

    async def req(i: int) -> None:
        try:
            status, _, _ = await chan.request("GET", f"/p{i}")
            results[i] = status
        except (FrameChannelError, FrameFallback):
            results[i] = -1     # downgrade path: legal under a sever

    async def sever() -> None:
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        chan._teardown(w, FrameChannelError("peer severed"))

    def check() -> list:
        v = []
        if chan._pending:
            v.append(f"leaked pending entries: "
                     f"{sorted(chan._pending)}")
        if chan._inflight != 0:
            v.append(f"congestion slots leaked: "
                     f"inflight={chan._inflight} after settle")
        if chan._win_waiters:
            v.append(f"leaked window waiters: "
                     f"{len(chan._win_waiters)}")
        return v

    return Run(tasks=[("req-1", req(1)), ("req-2", req(2)),
                      ("req-3", req(3)), ("peer", peer()),
                      ("sever", sever())],
               check=check)


# ---- singleflight: leader cancellation must not abort followers ------

@scenario("singleflight", victims=("caller-0", "caller-1"),
          description="collapsed concurrent calls; cancelling any "
                      "caller (the round leader included) must not "
                      "abort the shared work under the others")
def _singleflight() -> Run:
    from seaweedfs_tpu_torch.util.singleflight import SingleFlight

    sf = SingleFlight()
    results: dict[int, object] = {}

    async def work():
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        return 42

    async def caller(i: int) -> None:
        results[i] = await sf.do("k", work)

    def check() -> list:
        v = []
        if sf._inflight:
            v.append(f"settled round never forgotten: "
                     f"{sorted(sf._inflight)}")
        for i, r in sorted(results.items()):
            if r != 42:
                v.append(f"caller-{i} saw {r!r} instead of the "
                         f"shared result")
        return v

    return Run(tasks=[("caller-0", caller(0)),
                      ("caller-1", caller(1)),
                      ("caller-2", caller(2))],
               check=check)


# ---- autopilot executor: plan dispatch vs deposition -----------------

@scenario("autopilot", victims=("cycle",),
          description="a repair plan executing while leadership is "
                      "lost mid-queue; halted actions never dispatch, "
                      "nothing dispatches twice, in_flight drains")
def _autopilot() -> Run:
    from seaweedfs_tpu_torch.autopilot.execute import Executor
    from seaweedfs_tpu_torch.autopilot.plan import KIND_REPLICATE, Action

    state = {"leader": True}
    posts: dict[str, int] = {}
    res: dict = {"rows": None}

    async def node_post(url, path, params, timeout_s=0.0):
        vid = str(params.get("volume", "?"))
        posts[vid] = posts.get(vid, 0) + 1
        await asyncio.sleep(0)
        return {}

    ex = Executor(node_post, mbps=1.0, concurrency=2,
                  is_leader=lambda: state["leader"])
    actions = [Action(kind=KIND_REPLICATE, vid=i, target="t:1",
                      targets=("t:1",), holders=("src:1",),
                      bytes_est=0, reason="weedsched")
               for i in range(1, 5)]

    async def cycle() -> None:
        res["rows"] = await ex.execute(actions)

    async def depose() -> None:
        for _ in range(3):
            await asyncio.sleep(0)
        state["leader"] = False

    def check() -> list:
        v = []
        if ex.in_flight:
            v.append(f"executor in_flight leaked: "
                     f"{sorted(ex.in_flight)}")
        for vid, n in sorted(posts.items()):
            if n > 1:
                v.append(f"action vid={vid} dispatched {n}x")
        rows = res["rows"]
        if rows is None:
            return v            # cycle was cancelled before settling
        if any(r is None for r in rows):
            v.append("execute() returned an unfilled result row")
            return v
        statuses = [r["status"] for r in rows]
        bad = [s for s in statuses if s not in ("ok", "halted")]
        if bad:
            v.append(f"unexpected action statuses: {bad}")
        halted = False
        for r in rows:
            if r["status"] == "halted":
                halted = True
                if posts.get(str(r["action"]["vid"])):
                    v.append(f"halted action vid="
                             f"{r['action']['vid']} was dispatched "
                             f"anyway")
            elif halted and r["status"] == "ok":
                v.append("action admitted after a halted predecessor")
        return v

    return Run(tasks=[("cycle", cycle()), ("depose", depose())],
               check=check)
