"""Replicated-log raft unit tests (chrislusf/raft parity surface:
log replication, conflict truncation, quorum commit, snapshots,
InstallSnapshot, log-freshness votes). Reference behavior contract:
/root/reference/weed/server/raft_server.go:28-97 +
/root/reference/weed/topology/cluster_commands.go:9-29.

The cases of tests/test_raft_log.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio

from seaweedfs_tpu_torch.master.election import SNAPSHOT_THRESHOLD, Election

PEERS = ["a:1", "b:2", "c:3"]


def _follower(me: str, path=None) -> Election:
    e = Election(me, PEERS, state_path=path)
    return e


def test_append_entries_replicates_and_commits():
    f = _follower("b:2")
    adopted = []
    f.adopt_max_volume_id = adopted.append
    r = f.on_append(term=1, leader="a:1", prev_index=0, prev_term=0,
                    entries=[{"term": 1, "cmd": {"max_volume_id": 7}}],
                    leader_commit=0)
    assert r["ok"] and r["match"] == 1
    assert f.last_index() == 1 and f.commit == 0 and adopted == []
    # commit rides the next pulse (empty heartbeat)
    r = f.on_append(term=1, leader="a:1", prev_index=1, prev_term=1,
                    entries=[], leader_commit=1)
    assert r["ok"] and f.commit == 1 and adopted == [7]


def test_append_gap_is_rejected_with_hint():
    f = _follower("b:2")
    r = f.on_append(term=1, leader="a:1", prev_index=5, prev_term=1,
                    entries=[], leader_commit=0)
    assert not r["ok"] and r["last"] == 0   # leader jumps back to 1


def test_conflicting_suffix_is_truncated():
    f = _follower("b:2")
    # entries from a deposed term-1 leader, never committed
    f.on_append(1, "a:1", 0, 0,
                [{"term": 1, "cmd": {"max_volume_id": 1}},
                 {"term": 1, "cmd": {"max_volume_id": 2}}], 0)
    # new term-2 leader overwrites index 2 with its own entry
    r = f.on_append(2, "c:3", 1, 1,
                    [{"term": 2, "cmd": {"max_volume_id": 9}}], 2)
    assert r["ok"]
    assert f.last_index() == 2
    assert f._term_at(2) == 2
    assert f.applied_value == 9


def test_snapshot_compaction_and_state_restart(tmp_path):
    path = str(tmp_path / "raft_state.json")
    f = _follower("b:2", path)
    n = SNAPSHOT_THRESHOLD + 10
    entries = [{"term": 1, "cmd": {"max_volume_id": i + 1}}
               for i in range(n)]
    f.on_append(1, "a:1", 0, 0, entries, n)
    assert f.applied_value == n
    assert f.snap["last_index"] == n          # compacted
    assert len(f.entries) <= SNAPSHOT_THRESHOLD
    # the handler flushes before acking; only then is the state durable
    asyncio.run(f.flush())
    # restart: snapshot + tail reload, applied value restored
    f2 = _follower("b:2", path)
    assert f2.applied_value == n
    assert f2.last_index() == n
    # an append continuing from the snapshot point still works
    r = f2.on_append(1, "a:1", n, 1,
                     [{"term": 1, "cmd": {"max_volume_id": n + 1}}], n + 1)
    assert r["ok"] and f2.applied_value == n + 1


def test_install_snapshot_fast_forwards_lagging_follower():
    f = _follower("b:2")
    adopted = []
    f.adopt_max_volume_id = adopted.append
    r = f.on_install_snapshot(term=3, leader="a:1", last_index=120,
                              last_term=2, value=120)
    assert r["ok"]
    assert f.last_index() == 120 and f.applied_value == 120
    assert adopted == [120]
    # stale snapshot (lower index) is a no-op
    r = f.on_install_snapshot(term=3, leader="a:1", last_index=50,
                              last_term=2, value=50)
    assert r["ok"] and f.last_index() == 120


def test_vote_log_freshness_rule():
    f = _follower("b:2")
    f.on_append(2, "a:1", 0, 0,
                [{"term": 2, "cmd": {"max_volume_id": 5}}], 1)
    # candidate with a SHORTER log is refused despite the higher term
    r = f.on_vote_request(term=3, candidate="c:3",
                          last_log_index=0, last_log_term=0)
    assert not r["granted"] and f.term == 3
    # candidate at least as fresh is granted
    r = f.on_vote_request(term=4, candidate="c:3",
                          last_log_index=1, last_log_term=2)
    assert r["granted"]


def test_leader_commit_requires_current_term_entry():
    """The raft commit rule: a leader only commits entries from ITS term
    (prior-term entries commit transitively)."""
    lead = _follower("a:1")
    lead.role = Election.LEADER
    lead.term = 2
    lead.entries = [{"term": 1, "cmd": {"max_volume_id": 3}}]
    lead.match_index = {"b:2": 1, "c:3": 0}
    # majority has index 1, but it is a term-1 entry: must NOT commit
    matches = sorted([lead.last_index()]
                     + [lead.match_index[p] for p in lead.peers],
                     reverse=True)
    n = matches[lead.majority - 1]
    assert n == 1 and lead._term_at(n) != lead.term
