"""Multi-master leader election (raft_server.go analog) integration tests.

The cases of tests/test_election.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio
import os
import socket

import aiohttp

from test_torch_cluster_util import run

from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.store import Store


def _reserve_ports(n: int) -> list[socket.socket]:
    """n ports the kernel picks (port 0), each held by a bound socket
    that does not listen (SO_REUSEADDR) until the master that takes it
    listens: the peers must know every address before any master
    starts, and no other process can bind a held port in between."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    return socks


async def _make_cluster(n: int = 3) -> list[MasterServer]:
    held = _reserve_ports(n)
    ports = [s.getsockname()[1] for s in held]
    urls = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    try:
        for p in ports:
            # generous margins: under full-suite load the event loop can
            # stall past a tight lease window and flake the test with
            # leader churn
            m = MasterServer(port=p, pulse_seconds=0.1,
                             peers=urls,
                             election_timeout=(0.4, 0.8),
                             election_pulse=0.1)
            await m.start()
            masters.append(m)
    finally:
        for s in held:
            s.close()
    return masters


async def _wait_single_leader(masters, timeout: float = 10.0) -> MasterServer:
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        leaders = [m for m in masters if m.is_leader]
        agreed = {m.leader_url for m in masters}
        if len(leaders) == 1 and agreed == {leaders[0].url}:
            return leaders[0]
        await asyncio.sleep(0.05)
    raise AssertionError(
        f"no stable leader: roles={[m.election.role for m in masters]}")


def test_single_leader_elected_and_agreed():
    run(_body_single_leader())


async def _body_single_leader():
    masters = await _make_cluster(3)
    try:
        leader = await _wait_single_leader(masters)
        for m in masters:
            assert m.leader_url == leader.url
        terms = {m.election.term for m in masters}
        assert len(terms) == 1
    finally:
        for m in masters:
            await m.stop()


def test_follower_redirects_assign_and_status(tmp_path):
    run(_body_redirect(tmp_path))


async def _body_redirect(tmp_path):
    masters = await _make_cluster(3)
    vs = None
    try:
        leader = await _wait_single_leader(masters)
        follower = next(m for m in masters if not m.is_leader)

        store = Store([os.path.join(str(tmp_path), "v0")],
                      max_volume_counts=[8])
        # point the volume server at a follower: the 307 lands THIS
        # pulse on the leader (re-homing costs zero pulses) and the
        # hint re-points master_url for the next one
        vs = VolumeServer(store, follower.url, port=0, pulse_seconds=0.1)
        await vs.start()
        assert await vs.heartbeat_once()   # redirected => registered
        assert vs.master_url == leader.url
        assert any(n.url == vs.url for n in leader.topo.all_nodes())

        async with aiohttp.ClientSession() as http:
            async with http.get(
                    f"http://{follower.url}/cluster/status") as resp:
                st = await resp.json()
            assert st["isLeader"] is False
            assert st["leader"] == leader.url
            # assign via follower: 307-redirect-to-leader with the
            # X-Raft-Leader hint on the wire...
            async with http.post(f"http://{follower.url}/dir/assign",
                                 allow_redirects=False) as resp:
                assert resp.status == 307
                assert resp.headers["X-Raft-Leader"] == leader.url
                assert leader.url in resp.headers["Location"]
                hint = await resp.json()
            assert hint["leader"] == leader.url
            # ...which a default client follows transparently
            async with http.post(
                    f"http://{follower.url}/dir/assign") as resp:
                body = await resp.json()
            assert resp.status == 200, body
            assert "fid" in body, body

            # /submit through a follower: the proxy must preserve the
            # multipart Content-Type or the envelope gets stored raw
            form = aiohttp.FormData()
            form.add_field("file", b"via-follower", filename="f.bin")
            async with http.post(f"http://{follower.url}/submit",
                                 data=form) as resp:
                sub = await resp.json()
                assert resp.status == 200, sub
            assert sub["size"] == 12 and sub["fileName"] == "f.bin"

            # follower GET /<fid> bounces the client to the leader
            # (302) rather than proxy-buffering the blob...
            async with http.get(f"http://{follower.url}/{sub['fid']}",
                                allow_redirects=False) as resp:
                assert resp.status == 302
                assert leader.url in resp.headers["Location"]
            # ...and following the chain serves the exact bytes
            async with http.get(
                    f"http://{follower.url}/{sub['fid']}") as resp:
                assert resp.status == 200
                assert await resp.read() == b"via-follower"
    finally:
        if vs:
            await vs.stop()
        for m in masters:
            await m.stop()


def test_leader_steps_down_without_quorum():
    run(_body_quorum_loss())


async def _body_quorum_loss():
    masters = await _make_cluster(3)
    try:
        leader = await _wait_single_leader(masters)
        followers = [m for m in masters if m is not leader]
        for f in followers:
            await f.stop()
        # partitioned from every peer, the leader must drop its lease
        # instead of keeping a second writable master alive
        deadline = asyncio.get_event_loop().time() + 3.0
        while asyncio.get_event_loop().time() < deadline:
            if not leader.is_leader:
                break
            await asyncio.sleep(0.05)
        assert not leader.is_leader
        # and writes through it are refused, not misapplied
        async with aiohttp.ClientSession() as http:
            async with http.post(
                    f"http://{leader.url}/dir/assign") as resp:
                assert resp.status == 503
    finally:
        for m in masters:
            await m.stop()


def test_leader_failover_and_max_volume_id_survives(tmp_path):
    run(_body_failover(tmp_path))


async def _body_failover(tmp_path):
    masters = await _make_cluster(3)
    vs = None
    try:
        leader = await _wait_single_leader(masters)
        survivors = [m for m in masters if m is not leader]

        seeds = ",".join(m.url for m in masters)
        store = Store([os.path.join(str(tmp_path), "v0")],
                      max_volume_counts=[8])
        vs = VolumeServer(store, seeds, port=0, pulse_seconds=0.1)
        await vs.start()
        for _ in range(4):
            await vs.heartbeat_once()
        assert vs.master_url == leader.url

        # grow a volume so MaxVolumeId advances on the leader, then verify
        # the replicated value reached followers via leader pulses
        issued = []
        async with aiohttp.ClientSession() as http:
            for _ in range(4):
                async with http.post(
                        f"http://{leader.url}/dir/assign") as resp:
                    fid = (await resp.json()).get("fid")
                    assert fid
                    issued.append(fid)
        await asyncio.sleep(0.3)
        grown_vid = leader.topo.max_volume_id
        assert grown_vid >= 1
        for m in survivors:
            assert m.topo.max_volume_id >= grown_vid

        await leader.stop()
        new_leader = await _wait_single_leader(survivors)
        assert new_leader.url != leader.url
        assert new_leader.election.term > leader.election.term
        # the new leader must not reissue already-used volume ids
        assert new_leader.topo.max_volume_id >= grown_vid

        # volume server finds the new leader via seed rotation + hint
        for _ in range(60):
            try:
                await vs.heartbeat_once()
            except Exception:
                vs._seed_idx = (vs._seed_idx + 1) % len(vs.master_seeds)
                vs.master_url = vs.master_seeds[vs._seed_idx]
            if vs.master_url == new_leader.url \
                    and new_leader.topo.all_nodes():
                break
            await asyncio.sleep(0.05)
        assert vs.master_url == new_leader.url
        assert any(n.url == vs.url for n in new_leader.topo.all_nodes())

        # zero duplicate fids across the failover: every (vid, key) the
        # old leader issued came from a quorum-committed reservation
        # window, so the successor's assigns land strictly above them
        from seaweedfs_tpu_torch.storage.types import FileId
        async with aiohttp.ClientSession() as http:
            for _ in range(6):
                async with http.post(
                        f"http://{new_leader.url}/dir/assign") as resp:
                    body = await resp.json()
                    assert "fid" in body, body
                    issued.append(body["fid"])
        keys = [(f.volume_id, f.key)
                for f in map(FileId.parse, issued)]
        assert len(set(keys)) == len(keys), f"duplicate fid: {issued}"
    finally:
        if vs:
            await vs.stop()
        for m in masters:
            await m.stop()


def test_vote_state_survives_restart(tmp_path):
    """A restarted master must not grant a second vote in a term it
    already voted in (durable term/votedFor, raft_server.go:60-76)."""
    from seaweedfs_tpu_torch.master.election import Election

    path = str(tmp_path / "raft_state.json")
    peers = ["a:1", "b:2", "c:3"]
    e1 = Election("a:1", peers, state_path=path)
    r = e1.on_vote_request(term=5, candidate="b:2", max_volume_id=10)
    assert r["granted"] and e1.term == 5
    # durability rides flush() — the RPC handler awaits it before the
    # reply leaves the node (the fsync itself runs on the executor)
    asyncio.run(e1.flush())

    # crash + restart: state reloads from disk
    e2 = Election("a:1", peers, state_path=path)
    assert e2.term == 5
    assert e2.voted_for == "b:2"
    # a competing candidate in the SAME term must be refused
    r = e2.on_vote_request(term=5, candidate="c:3", max_volume_id=10)
    assert not r["granted"]
    # re-voting for the same candidate stays idempotent
    r = e2.on_vote_request(term=5, candidate="b:2", max_volume_id=10)
    assert r["granted"]
    # a HIGHER term resets votedFor and persists the new term
    r = e2.on_vote_request(term=6, candidate="c:3", max_volume_id=10)
    assert r["granted"]
    asyncio.run(e2.flush())
    e3 = Election("a:1", peers, state_path=path)
    assert e3.term == 6 and e3.voted_for == "c:3"


def test_stale_snapshot_still_persists_term_bump(tmp_path):
    """ADVICE round 5: on_install_snapshot adopted a higher term but
    only persisted when the snapshot was actually installed — a STALE
    snapshot (last_index <= local) lost the bump on restart, so the
    node could vote twice in that term after a crash."""
    from seaweedfs_tpu_torch.master.election import Election

    path = str(tmp_path / "raft_state.json")
    peers = ["a:1", "b:2", "c:3"]
    e1 = Election("a:1", peers, state_path=path)
    # local log already ahead of the snapshot's last_index
    e1.on_append(term=3, leader="b:2", prev_index=0, prev_term=0,
                 entries=[{"term": 3, "cmd": {"max_volume_id": 7}}],
                 leader_commit=1)
    assert e1.last_index() == 1
    r = e1.on_install_snapshot(term=9, leader="c:3", last_index=0,
                               last_term=0, value=0)
    assert r["ok"] and e1.term == 9
    asyncio.run(e1.flush())   # what h_raft_snapshot awaits pre-reply
    # crash + restart: the term bump must have been durable
    e2 = Election("a:1", peers, state_path=path)
    assert e2.term == 9
    r = e2.on_vote_request(term=9, candidate="b:2", max_volume_id=0,
                           last_log_index=5, last_log_term=3)
    # whatever the vote outcome, the term must not have regressed
    assert e2.term == 9


def test_corrupt_election_state_is_fatal(tmp_path):
    from seaweedfs_tpu_torch.master.election import Election

    path = str(tmp_path / "raft_state.json")
    with open(path, "w") as f:
        f.write("{not json")
    try:
        Election("a:1", ["a:1", "b:2"], state_path=path)
        raise AssertionError("corrupt state silently ignored")
    except SystemExit:
        pass
