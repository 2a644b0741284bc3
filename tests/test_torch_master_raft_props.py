"""Election property suite: randomized interleavings over the raft
surface (term monotonicity, log matching under torn/duplicated append
replays, snapshot-install then catch-up, restart durability) plus the
campaign per-attempt-timeout regression.

These are the invariants the chaos ha scenario relies on statistically,
driven here deterministically over seeded random schedules.

The cases of tests/test_raft_props.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio
import random
import time

import aiohttp

from seaweedfs_tpu_torch.master.election import Election
from seaweedfs_tpu_torch.util import events, failpoints

PEERS = ["a:1", "b:2", "c:3"]


def _mk(me: str = "b:2", path=None) -> Election:
    return Election(me, PEERS, state_path=path)


def _leader_log(rng: random.Random, n: int) -> list[dict]:
    """A synthetic committed leader log with term bumps and a mix of
    volume-id and fid-reservation commands."""
    log, term = [], 1
    for i in range(n):
        if rng.random() < 0.15:
            term += rng.randint(1, 2)
        cmd = ({"max_volume_id": i + 1} if rng.random() < 0.5
               else {"seq_reserve": rng.randint(1, 64), "by": "a:1"})
        log.append({"term": term, "cmd": cmd})
    return log


def _append_slice(f: Election, log: list[dict], start: int, end: int,
                  commit: int) -> dict:
    """Deliver log[start:end] with the correct prev coordinates, the
    way a (possibly stale) leader retransmission would."""
    prev_term = log[start - 1]["term"] if start else 0
    return f.on_append(log[-1]["term"], "a:1", start, prev_term,
                       [dict(e) for e in log[start:end]], commit)


def test_term_never_regresses_under_random_rpc_storm():
    rng = random.Random(1234)
    f = _mk()
    log = _leader_log(rng, 40)
    seen = 0
    for _ in range(500):
        seen = max(seen, f.term)
        op = rng.random()
        if op < 0.35:
            f.on_vote_request(term=rng.randint(0, 30),
                              candidate=rng.choice(["a:1", "c:3"]),
                              last_log_index=rng.randint(0, 60),
                              last_log_term=rng.randint(0, 30))
        elif op < 0.75:
            s = rng.randint(0, len(log))
            _append_slice(f, log, s, rng.randint(s, len(log)),
                          rng.randint(0, len(log)))
        else:
            f.on_install_snapshot(term=rng.randint(0, 30),
                                  leader="c:3",
                                  last_index=rng.randint(0, 80),
                                  last_term=rng.randint(0, 30),
                                  value=rng.randint(0, 80),
                                  seq=rng.randint(0, 500))
        assert f.term >= seen, "term regressed"


def test_log_matching_after_torn_replays():
    """Two followers fed the SAME leader log as randomly torn,
    duplicated, out-of-order slices converge to identical logs and
    identical applied state — the raft Log Matching property."""
    rng = random.Random(77)
    log = _leader_log(rng, 60)
    for trial in range(8):
        followers = [_mk("b:2"), _mk("c:3")]
        applied = [[], []]
        seqs = [[], []]
        for i, f in enumerate(followers):
            f.adopt_max_volume_id = applied[i].append
            f.adopt_seq_window = \
                lambda s, e, by, t, acc=seqs[i]: acc.append((s, e))
        for f in followers:
            # a storm of torn, duplicated, reordered retransmissions
            for _ in range(30):
                s = rng.randint(0, len(log) - 1)
                e = rng.randint(s, len(log))
                _append_slice(f, log, s, e, rng.randint(0, e))
            # the final full retransmission every live leader converges
            # on via the next_index walk-back
            _append_slice(f, log, 0, len(log), len(log))
        a, b = followers
        assert a.last_index() == b.last_index() == len(log)
        assert [a._term_at(i) for i in range(1, len(log) + 1)] == \
               [b._term_at(i) for i in range(1, len(log) + 1)]
        assert a.applied_value == b.applied_value
        assert a.applied_seq == b.applied_seq
        # reservation windows applied in identical order on both
        assert seqs[0] == seqs[1]
        # committed prefix applied exactly once per index
        assert applied[0] == applied[1]


def test_snapshot_install_then_catch_up():
    rng = random.Random(5)
    log = _leader_log(rng, 50)
    # precompute the leader's applied state at index 30
    value30 = max((e["cmd"].get("max_volume_id", 0)
                   for e in log[:30]), default=0)
    seq30 = sum(e["cmd"].get("seq_reserve", 0) for e in log[:30])
    f = _mk()
    r = f.on_install_snapshot(term=log[-1]["term"], leader="a:1",
                              last_index=30, last_term=log[29]["term"],
                              value=value30, seq=seq30)
    assert r["ok"]
    assert f.applied_seq == seq30 and f.applied_value == value30
    # catch up from the snapshot point with the remaining tail
    r = _append_slice(f, log, 30, len(log), len(log))
    assert r["ok"]
    assert f.last_index() == len(log)
    assert f.applied_seq == sum(e["cmd"].get("seq_reserve", 0)
                                for e in log)
    # a stale snapshot arriving late must not roll anything back
    r = f.on_install_snapshot(term=log[-1]["term"], leader="a:1",
                              last_index=10, last_term=log[9]["term"],
                              value=1, seq=1)
    assert r["ok"] and f.last_index() == len(log)
    assert f.applied_seq == sum(e["cmd"].get("seq_reserve", 0)
                                for e in log)


def test_restart_durability_random_schedules(tmp_path):
    """votedFor/term/log/applied-seq survive flush()+reload at every
    random cut point — the double-vote and id-reissue windows a crash
    must never open."""
    rng = random.Random(99)
    for trial in range(6):
        path = str(tmp_path / f"raft_{trial}.json")
        f = _mk(path=path)
        log = _leader_log(rng, 30)
        for _ in range(rng.randint(3, 12)):
            if rng.random() < 0.4:
                f.on_vote_request(term=rng.randint(1, 20),
                                  candidate=rng.choice(["a:1", "c:3"]),
                                  last_log_index=99, last_log_term=99)
            else:
                s = rng.randint(0, len(log) - 1)
                _append_slice(f, log, s, rng.randint(s, len(log)),
                              rng.randint(0, len(log)))
        asyncio.run(f.flush())   # what every RPC handler awaits pre-reply
        g = _mk(path=path)
        assert g.term == f.term
        assert g.voted_for == f.voted_for
        assert g.snap == f.snap
        assert g.entries == f.entries
        # applied state beyond the snapshot re-derives from the log as
        # commit re-advances; the snapshot floor itself must hold
        assert g.applied_seq == g.snap["seq"]
        r = g.on_vote_request(term=g.term, candidate="c:3",
                              last_log_index=999, last_log_term=999)
        if f.voted_for not in (None, "c:3"):
            assert not r["granted"], "double vote after restart"


def test_campaign_bounded_by_per_attempt_timeout():
    """Satellite regression: a hung/slow peer socket (latency-armed
    master.vote) must not stretch a campaign past the election
    timeout — the per-attempt wait_for bounds every vote RPC."""
    async def body():
        e = Election("127.0.0.1:1", ["127.0.0.1:1", "127.0.0.1:2",
                                     "127.0.0.1:3"],
                     election_timeout=(0.4, 0.8), pulse=0.1)
        assert e.attempt_timeout <= 0.2
        e._http = aiohttp.ClientSession()
        failpoints.arm("master.vote", "latency=5000:*")
        try:
            t0 = time.monotonic()
            await e._campaign()
            elapsed = time.monotonic() - t0
        finally:
            failpoints.reset()
            await e._http.close()
        # both vote RPCs run concurrently; the whole fan-out must fit
        # inside one election timeout with margin to spare
        assert elapsed < 0.4, f"campaign took {elapsed:.2f}s"
        assert e.role == Election.FOLLOWER   # no quorum, stepped down
    asyncio.run(body())


def test_leader_change_and_step_down_are_journaled():
    f = _mk()
    f.on_append(7, "a:1", 0, 0, [], 0)
    f.role = Election.LEADER         # pretend it won a later election
    f._step_down()
    rows = events.events_dict(n=1000)["events"]
    assert any(r["type"] == "raft_leader_change"
               and r.get("leader") == "a:1" and r.get("term") == 7
               for r in rows)
    assert any(r["type"] == "raft_step_down"
               and r.get("me") == "b:2" and r.get("term") == 7
               for r in rows)
    # both are documented vocabulary, not typo'd strays
    assert {"raft_leader_change", "raft_step_down"} <= events.TYPES
