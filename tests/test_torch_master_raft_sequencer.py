"""RaftSequencer: quorum-committed fid reservation windows.

The invariant under test is the chaos ha acceptance contract: an id is
only ever handed out from a raft-COMMITTED reservation window, windows
partition the id space in log order, and a deposed leader's in-flight
/dir/assign either fails/redirects or returns an id the successor's
committed log also owns — never an id the successor could re-issue.

The cases of tests/test_raft_sequencer.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio

import pytest

from seaweedfs_tpu_torch.master.election import Election
from seaweedfs_tpu_torch.master.sequence import (MemorySequencer, RaftSequencer,
                                           SequenceBehind)

PEERS = ["a:1", "b:2", "c:3"]


def _leader(me: str = "a:1", term: int = 1) -> Election:
    e = Election(me, PEERS)
    e.role = Election.LEADER
    e.leader = e.me
    e.term = term
    return e


async def _commit_all(e: Election) -> bool:
    """Test stand-in for a replication round that reaches a full
    quorum instantly: everything in the log commits and applies."""
    e.commit = e.last_index()
    e._apply_committed()
    return True


def _wire_quorum(e: Election) -> None:
    async def fake_round() -> int:
        await _commit_all(e)
        return len(e.peers) + 1
    e._replicate_round = fake_round


def test_ids_only_from_committed_windows():
    e = _leader()
    _wire_quorum(e)
    seq = RaftSequencer(MemorySequencer(), e, step=16)
    # nothing committed yet: allocation must refuse, not invent ids
    with pytest.raises(SequenceBehind):
        seq.next_file_id()
    assert asyncio.run(seq.reserve(1))
    first = seq.next_file_id()
    assert 1 <= first < seq.ceiling
    # the whole window drains without another commit round
    got = [first] + [seq.next_file_id() for _ in range(seq.ceiling
                                                      - first - 1)]
    assert len(set(got)) == len(got)
    with pytest.raises(SequenceBehind):
        seq.next_file_id()


def test_successor_windows_never_overlap_deposed_leaders():
    """The acceptance race, deterministically: leader A commits a
    window and keeps draining it AFTER being deposed; successor B's
    first window starts above A's ceiling, so even ids A hands out
    post-deposition are ids B's committed log owns and B will never
    re-issue."""
    a = _leader("a:1", term=1)
    _wire_quorum(a)
    seq_a = RaftSequencer(MemorySequencer(), a, step=16)
    assert asyncio.run(seq_a.reserve(1))
    issued_a = [seq_a.next_file_id() for _ in range(5)]

    # replicate A's log to follower B (the quorum path A's commit
    # certifies), then depose A and promote B
    b = Election("b:2", PEERS)
    seq_b = RaftSequencer(MemorySequencer(), b, step=16)
    r = b.on_append(1, "a:1", 0, 0, list(a.entries), a.commit)
    assert r["ok"]
    a._adopt_higher_term(2)          # A deposed (higher term observed)
    b.role = Election.LEADER
    b.leader = b.me
    b.term = 2
    _wire_quorum(b)

    # A keeps draining its committed window mid-deposition (the
    # in-flight /dir/assign case) — allowed, because...
    issued_a += [seq_a.next_file_id() for _ in range(3)]
    assert all(i < seq_a.ceiling for i in issued_a)

    # ...B's first window starts at/above A's committed ceiling
    assert asyncio.run(seq_b.reserve(1))
    issued_b = [seq_b.next_file_id() for _ in range(8)]
    assert min(issued_b) >= seq_a.ceiling
    assert not set(issued_a) & set(issued_b)

    # and once A's window is spent, A cannot reserve another
    while True:
        try:
            issued_a.append(seq_a.next_file_id())
        except SequenceBehind:
            break
    assert not asyncio.run(seq_a.reserve(1))
    assert not set(issued_a) & set(issued_b)


def test_reserve_fails_cleanly_when_deposed_mid_commit():
    """append_command loses leadership mid-round: reserve() is False
    and no window opens — the caller redirects instead of inventing
    ids."""
    e = _leader()

    async def deposed_round() -> int:
        e._adopt_higher_term(5)
        return 1
    e._replicate_round = deposed_round
    seq = RaftSequencer(MemorySequencer(), e, step=16)
    assert not asyncio.run(seq.reserve(1))
    with pytest.raises(SequenceBehind):
        seq.next_file_id()


def test_foreign_window_fences_instead_of_claiming():
    """A window authored by this node in an OLDER term (committed by a
    successor) must fence the counter past its end, never open for
    local allocation — the old leadership may have promised nothing,
    but the new one owns the space."""
    e = _leader("a:1", term=3)
    seq = RaftSequencer(MemorySequencer(), e, step=16)
    # entry authored by us at term 2, applied while we run term 3
    seq.adopt_window(0, 100, "a:1", 2)
    assert seq.ceiling == 100
    with pytest.raises(SequenceBehind):
        seq.next_file_id()
    assert seq.peek() >= 100


def test_heartbeat_watermark_burns_through_windows():
    """A volume server reporting a huge max file key (migration from a
    pre-HA cluster) pushes the counter past the open window; the next
    reserve must size its window past the watermark, and the burned
    block is never handed out."""
    e = _leader()
    _wire_quorum(e)
    seq = RaftSequencer(MemorySequencer(), e, step=16)
    assert asyncio.run(seq.reserve(1))
    seq.set_max(10_000)
    with pytest.raises(SequenceBehind):
        seq.next_file_id()
    assert asyncio.run(seq.reserve(1))
    nxt = seq.next_file_id()
    assert nxt > 10_000
    assert nxt + 1 <= seq.ceiling


def test_reserve_covers_counts_larger_than_step():
    """Review regression: the window must cover `count` ids from its
    OWN start (the claim fences the counter there) — a block bigger
    than the step used to under-reserve and fail the healthy leader's
    assign forever."""
    e = _leader()
    _wire_quorum(e)
    seq = RaftSequencer(MemorySequencer(), e, step=16)
    assert asyncio.run(seq.reserve(1))
    seq.next_file_id()                       # counter mid-window
    big = 5 * seq.step
    assert asyncio.run(seq.reserve(big))
    first = seq.next_file_id(big)
    assert first + big <= seq.ceiling


def test_install_snapshot_seq_rides_the_http_wire():
    """Review regression: h_raft_snapshot must hand the RPC's `seq` to
    on_install_snapshot — dropping it left a catching-up follower's
    applied_seq at 0, un-fenced against every folded reservation
    window (duplicate fids if it later led)."""
    import inspect

    from seaweedfs_tpu_torch.master.server import MasterServer
    src = inspect.getsource(MasterServer.h_raft_snapshot)
    assert "seq=" in src
    f = Election("b:2", PEERS)
    sq = RaftSequencer(MemorySequencer(), f, step=16)
    r = f.on_install_snapshot(term=3, leader="a:1", last_index=40,
                              last_term=2, value=7, seq=9000)
    assert r["ok"]
    assert f.applied_seq == 9000
    assert sq.ceiling == 9000 and sq.peek() >= 9000


def test_concurrent_reserves_collapse_to_one_commit():
    e = _leader()
    rounds = 0

    async def counting_round() -> int:
        nonlocal rounds
        rounds += 1
        await _commit_all(e)
        return 3
    e._replicate_round = counting_round
    seq = RaftSequencer(MemorySequencer(), e, step=64)

    async def burst():
        return await asyncio.gather(*(seq.reserve(1) for _ in range(8)))

    assert all(asyncio.run(burst()))
    # one committed window serves all 8 waiters (one entry, one round)
    assert len(e.entries) == 1
    assert seq.reserves == 1


def test_window_survives_restart_and_refuses_reissue(tmp_path):
    """Restart durability: a leader that crashed after committing a
    window comes back (as a follower) with its counter fenced past
    every window in its durable log — even the tail it had not yet
    folded into a snapshot."""
    path = str(tmp_path / "raft_state.json")
    e = _leader()
    e.state_path = path
    _wire_quorum(e)
    seq = RaftSequencer(MemorySequencer(), e, step=16)
    assert asyncio.run(seq.reserve(1))
    issued = [seq.next_file_id() for _ in range(4)]
    e._mark_dirty()
    asyncio.run(e.flush())

    e2 = Election("a:1", PEERS, state_path=path)
    seq2 = RaftSequencer(MemorySequencer(), e2, step=16)
    # tail entries beyond the snapshot re-apply when commit re-advances
    # (here: promoted and committing its own no-window entry)
    e2.role = Election.LEADER
    e2.leader = e2.me
    e2.term = e.term + 1

    async def commit_all2() -> int:
        e2.commit = e2.last_index()
        e2._apply_committed()
        return 3
    e2._replicate_round = commit_all2
    assert asyncio.run(seq2.reserve(1))
    fresh = [seq2.next_file_id() for _ in range(4)]
    assert not set(issued) & set(fresh)
    assert min(fresh) >= seq.ceiling
