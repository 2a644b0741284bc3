"""The inter-host frame fabric: replication fan-out, raft RPCs, EC
shard gather, heartbeat/lookup and client data hops all ride the
multiplexed binary wire by default, fall back to HTTP byte-identically
when the frame leg is severed, refuse unauthenticated HELLOs on a
jwt-secured cluster before any payload, and fail pending requests
immediately when a channel dies mid-pipeline.

The cases of tests/test_frame_fabric.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import asyncio
import json
import random
import socket
import time

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.util import events
from seaweedfs_tpu_torch.util import failpoints as fp
from seaweedfs_tpu_torch.util.client import WeedClient
from seaweedfs_tpu_torch.util.connpool import FrameProbeGate
from seaweedfs_tpu_torch.util.frame import (FrameChannel, FrameChannelError,
                                      FrameDecoder, HELLO, HELLO_OK,
                                      MAGIC, REQ, encode_frame)


@pytest.fixture(autouse=True)
def _clean():
    fp.reset()
    events.reset()
    yield
    fp.reset()
    events.reset()


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _fid_parts(fid: str) -> tuple[int, int]:
    vid, rest = fid.split(",")
    return int(vid), int(rest[:-8], 16)


async def _put_replicated(c: Cluster, data: bytes) -> str:
    a = await c.assign(replication="001")
    assert "fid" in a, a
    st, _ = await c.put(a["fid"], a["url"], data)
    assert st == 201
    return a["fid"]


def _holders(c: Cluster, vid: int):
    return [vs for vs in c.servers if vid in vs.store.volumes]


# ---------------------------------------------------------------------------
# replication fan-out
# ---------------------------------------------------------------------------

def test_replication_fanout_rides_frames_byte_identical(tmp_path):
    """A replicated write fans out over a frame channel; both holders
    end with byte-identical needles. With the frame leg severed
    (replication.frame armed) the HTTP fallback produces the SAME
    bytes — the two transports are provably interchangeable."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=3) as c:
            data_a = b"frame-fabric-fanout" * 911
            fid_a = await _put_replicated(c, data_a)
            vid, key = _fid_parts(fid_a)
            holders = _holders(c, vid)
            assert len(holders) == 2, [vs.url for vs in c.servers]
            got = [vs.store.read_needle(vid, key).data for vs in holders]
            assert got[0] == got[1] == data_a
            # the fan-out hop really rode a frame channel: the primary
            # holder's hub has an inter-host channel to its replica
            fanout_reqs = sum(
                s["requests"]
                for vs in holders
                for tgt, s in vs.frame_hub.stats_dict().items()
                if any(tgt == peer.url for peer in c.servers))
            assert fanout_reqs >= 1, \
                [vs.frame_hub.stats_dict() for vs in holders]

            # sever the frame leg: every fan-out attempt errors and
            # the write must ride HTTP, still byte-identical
            fp.arm("replication.frame", "error:*")
            data_b = b"http-fallback-fanout" * 907
            fid_b = await _put_replicated(c, data_b)
            vid_b, key_b = _fid_parts(fid_b)
            holders_b = _holders(c, vid_b)
            assert len(holders_b) == 2
            got_b = [vs.store.read_needle(vid_b, key_b).data
                     for vs in holders_b]
            assert got_b[0] == got_b[1] == data_b

            # delete propagates to both holders (frames again)
            fp.reset()
            assert await c.delete(fid_a, holders[0].url) == 200
            await asyncio.sleep(0.05)
            for vs in holders:
                st, _ = await c.get(fid_a, vs.url)
                assert st == 404, vs.url
    run(go())


# ---------------------------------------------------------------------------
# heartbeat / lookup / client hops
# ---------------------------------------------------------------------------

def test_control_plane_and_client_hops_ride_frames(tmp_path):
    """Volume->master heartbeats and client->master lookups plus
    client->volume reads all travel frame channels by default."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            data = b"hop-check" * 512
            fid = await _put_replicated(c, data)
            await c.heartbeat_all()
            # every volume server holds a frame channel to the master
            # with at least one completed request (the heartbeat)
            for vs in c.servers:
                stats = vs.frame_hub.stats_dict()
                master_stats = [s for tgt, s in stats.items()
                                if tgt == c.master.url]
                assert master_stats and master_stats[0]["requests"] >= 1, \
                    stats
            async with WeedClient(c.master.url) as wc:
                assert await wc.read(fid) == data
                stats = wc.frame_hub.stats_dict()
                # lookup rode a frame to the master AND the data GET
                # rode a frame to a volume server
                assert any(tgt == c.master.url and s["requests"] >= 1
                           for tgt, s in stats.items()), stats
                assert any(tgt != c.master.url and s["requests"] >= 1
                           for tgt, s in stats.items()), stats

                # upload + delete over frames round-trip too
                blob = b"client-frame-write" * 64
                fid2 = await wc.upload_data(blob)
                assert await wc.read(fid2) == blob
                await wc.delete_fids([fid2])
                with pytest.raises(Exception):
                    await wc.read(fid2)
    run(go())


# ---------------------------------------------------------------------------
# raft over frames
# ---------------------------------------------------------------------------

async def _make_masters(n: int = 3) -> list[MasterServer]:
    ports = _free_ports(n)
    urls = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    for p in ports:
        m = MasterServer(port=p, pulse_seconds=0.1, peers=urls,
                         election_timeout=(0.4, 0.8),
                         election_pulse=0.1)
        await m.start()
        masters.append(m)
    return masters


async def _wait_single_leader(masters, timeout: float = 10.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        live = [m for m in masters if m.election is not None]
        leaders = [m for m in live if m.is_leader]
        agreed = {m.leader_url for m in live}
        if len(leaders) == 1 and agreed == {leaders[0].url}:
            return leaders[0]
        await asyncio.sleep(0.05)
    raise AssertionError(
        f"no stable leader: roles={[m.election.role for m in masters]}")


def test_raft_rpcs_ride_frames_and_survive_frame_loss(tmp_path):
    """Vote/append RPCs default to frame channels (hub traffic is
    observable on the leader); with master.raft.frame armed the
    quorum still re-elects after leader death via the HTTP fallback."""
    async def go():
        masters = await _make_masters(3)
        stopped: set = set()
        try:
            leader = await _wait_single_leader(masters)
            # let a few heartbeat rounds run, then check the fabric
            await asyncio.sleep(0.4)
            hub = leader.election.frame_hub
            assert hub is not None
            reqs = sum(s["requests"] for s in hub.stats_dict().values())
            assert reqs >= 2, hub.stats_dict()   # appends to 2 peers

            # sever EVERY raft frame leg and kill the leader: the
            # remaining pair must still elect over HTTP
            fp.arm("master.raft.frame", "error:*")
            survivors = [m for m in masters if m is not leader]
            await leader.stop()
            stopped.add(leader)
            new_leader = await _wait_single_leader(survivors)
            assert new_leader is not leader
        finally:
            for m in masters:
                if m not in stopped:
                    await m.stop()
    run(go())


# ---------------------------------------------------------------------------
# EC inter-host gather
# ---------------------------------------------------------------------------

def test_ec_gather_falls_back_to_http_when_frames_sever(tmp_path):
    """Cross-host EC shard gather rides the sync frame pool; with
    ec.fetch.frame armed every gather rides HTTP instead and reads
    stay byte-exact."""
    async def go():
        from seaweedfs_tpu_torch.shell.env import CommandEnv
        from seaweedfs_tpu_torch.shell import ec_commands as ec
        async with Cluster(str(tmp_path), n_servers=3) as c:
            rng = random.Random(7)
            files = []
            for _ in range(12):
                a = await c.assign(collection="ecfab")
                data = bytes(rng.getrandbits(8)
                             for _ in range(rng.randint(800, 6000)))
                st, _ = await c.put(a["fid"], a["url"], data)
                assert st == 201
                files.append((a["fid"], data))
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                vids = sorted({int(f.split(",")[0]) for f, _ in files})
                res = await ec.ec_encode(env, collection="ecfab",
                                         vids=vids)
                assert res, "ec.encode produced no results"

            # reads from any server now require cross-host gather;
            # default path (frames) first...
            for fid, data in files[:4]:
                for vs in c.servers:
                    st, got = await c.get(fid, vs.url)
                    assert st == 200 and got == data, (fid, vs.url)
            # ...then with the frame leg severed: HTTP fallback only
            fp.arm("ec.fetch.frame", "error:*")
            for fid, data in files[4:8]:
                for vs in c.servers:
                    st, got = await c.get(fid, vs.url)
                    assert st == 200 and got == data, \
                        ("http-fallback", fid, vs.url)
    run(go())


# ---------------------------------------------------------------------------
# HELLO authentication
# ---------------------------------------------------------------------------

def test_master_refuses_unauthenticated_hello_on_jwt_cluster(tmp_path):
    """On a jwt-secured cluster the master's frame listener refuses an
    identity-less or wrong-key HELLO at the handshake — before any
    request payload crosses the wire — while the correct key works."""
    async def go():
        port = _free_ports(1)[0]
        m = MasterServer(port=port, pulse_seconds=0.1,
                         jwt_key="fabric-secret")
        await m.start()
        try:
            # no identity at all
            chan = FrameChannel(target=m.url)
            with pytest.raises(FrameChannelError,
                               match="handshake refused"):
                await chan.request("GET", "/dir/assign", timeout=5.0)
            await chan.close()
            # wrong key: signature check fails, same refusal
            chan = FrameChannel(target=m.url, jwt_key="wrong-secret")
            with pytest.raises(FrameChannelError,
                               match="handshake refused"):
                await chan.request("GET", "/dir/assign", timeout=5.0)
            await chan.close()
            # right key: handshake accepted, request served (404 —
            # the bare master holds no volumes — but it ANSWERED,
            # which an unauthenticated channel never got to)
            chan = FrameChannel(target=m.url, jwt_key="fabric-secret")
            status, _, body = await chan.request(
                "GET", "/dir/lookup", query={"volumeId": "1"},
                timeout=5.0)
            assert status in (200, 404), (status, body)
            assert isinstance(json.loads(body), dict)
            await chan.close()
        finally:
            await m.stop()
    run(go())


# ---------------------------------------------------------------------------
# probe gate (sticky-downgrade fix)
# ---------------------------------------------------------------------------

class _FixedRng:
    def __init__(self, v: float):
        self.v = v

    def random(self) -> float:
        return self.v


def test_probe_gate_backoff_doubles_caps_and_journals():
    now = [0.0]
    gate = FrameProbeGate(base_s=1.0, cap_s=8.0, rng=_FixedRng(0.5),
                          clock=lambda: now[0])
    t = "10.0.0.9:8080"
    assert gate.allow(t)                      # never refused: probe
    # rng 0.5 -> jitter multiplier exactly 1.0: delays are the pure
    # doubling sequence 1, 2, 4, 8, then capped at 8
    assert gate.refused(t, "no frame listener") == pytest.approx(1.0)
    assert not gate.allow(t)                  # inside the backoff
    now[0] = 1.01
    assert gate.allow(t)                      # window elapsed: reprobe
    assert gate.refused(t) == pytest.approx(2.0)
    assert gate.refused(t) == pytest.approx(4.0)
    assert gate.refused(t) == pytest.approx(8.0)
    assert gate.refused(t) == pytest.approx(8.0)   # capped, not sticky
    # success clears the strikes entirely
    gate.ok(t)
    assert gate.allow(t)
    assert gate.refused(t) == pytest.approx(1.0)
    # every refusal journaled a frame_downgrade with the evidence
    rows = events.events_dict(types={"frame_downgrade"})["events"]
    assert len(rows) == 6
    assert rows[-1]["target"] == t
    assert rows[-1]["strikes"] == 1
    assert rows[-1]["reason"] == "no frame listener"
    assert rows[-1]["retry_in_s"] == pytest.approx(1.0)


def test_probe_gate_jitter_spans_half_to_one_and_a_half():
    lo = FrameProbeGate(base_s=2.0, rng=_FixedRng(0.0),
                        clock=lambda: 0.0)
    hi = FrameProbeGate(base_s=2.0, rng=_FixedRng(0.999),
                        clock=lambda: 0.0)
    assert lo.refused("a") == pytest.approx(1.0)       # 2.0 * 0.5
    assert hi.refused("a") == pytest.approx(2.998)     # 2.0 * 1.499


# ---------------------------------------------------------------------------
# congestion window (AIMD)
# ---------------------------------------------------------------------------

def test_congestion_window_aimd_shrink_grow_clamps():
    ch = FrameChannel(target="127.0.0.1:1")
    assert ch.window == FrameChannel.CWND_INIT
    ch._rtt_best = float("inf")
    ch._observe_rtt(0.010)                 # sets the floor; grows
    assert ch.stats.window_grows == 1
    cwnd_before = ch._cwnd
    ch._observe_rtt(0.050)                 # > 2x floor: shrink x0.7
    assert ch.stats.window_shrinks == 1
    assert ch._cwnd == pytest.approx(cwnd_before * 0.7)
    # sustained queueing shrinks to CWND_MIN and clamps there
    for _ in range(50):
        ch._observe_rtt(1.0)
    assert ch.window == FrameChannel.CWND_MIN
    shrinks = ch.stats.window_shrinks
    ch._observe_rtt(1.0)                   # at the floor: no shrink
    assert ch.stats.window_shrinks == shrinks
    # clean RTTs grow additively back up to CWND_MAX and clamp
    for _ in range(5000):
        ch._observe_rtt(0.010)
    assert ch.window == FrameChannel.CWND_MAX
    assert ch.stats.window_grows > 1


# ---------------------------------------------------------------------------
# severed channel fast-fail
# ---------------------------------------------------------------------------

def test_severed_channel_fails_pending_requests_immediately():
    """Requests pipelined on a channel whose peer dies mid-flight must
    fail with FrameChannelError as soon as the socket closes — not
    after the 30s request timeout."""
    async def go():
        conns = []

        async def handle(reader, writer):
            conns.append(writer)
            dec = FrameDecoder()
            reqs = 0
            first = True
            while reqs < 4:                # swallow the pipeline...
                data = await reader.read(64 * 1024)
                if not data:
                    return
                if first and data.startswith(MAGIC):
                    data = data[len(MAGIC):]
                first = False
                for f in dec.feed(data):
                    if f.type == HELLO:
                        writer.write(encode_frame(HELLO_OK, f.req_id,
                                                  {"v": 1}))
                        await writer.drain()
                    elif f.type == REQ:
                        reqs += 1
            writer.close()                 # ...then sever, answering 0

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        chan = FrameChannel(target=f"127.0.0.1:{port}",
                            request_timeout=30.0)
        try:
            t0 = time.monotonic()
            results = await asyncio.gather(
                *(chan.request("GET", f"/p{i}") for i in range(4)),
                return_exceptions=True)
            elapsed = time.monotonic() - t0
            assert all(isinstance(r, (FrameChannelError, OSError))
                       for r in results), results
            # far below both the 30s request timeout and the 60s idle
            # reap — the sever itself failed the pending requests
            assert elapsed < 5.0, elapsed
        finally:
            await chan.close()
            server.close()
            await server.wait_closed()
    run(go())
