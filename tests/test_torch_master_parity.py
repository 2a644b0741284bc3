"""The port's master (seaweedfs_tpu_torch/master/server.py) against the
JAX package's, over HTTP on one event loop.

The same heartbeats go to a reference master and a port master; their
/dir/status, /vol/status, /vol/ec_lookup and /cluster/status bodies must
be equal once each master's own address is replaced by one placeholder.
Under one seeded random stream (the reference's placement modules see a
private stream in place of their module-global `random`; the port's
Topology holds its own), /dir/assign must hand out the same volume
and the same needle keys; only the cookie, drawn from `secrets`, differs.
A MemorySequencer gives the same keys on both sides. Every comparison is
exact.
"""

from __future__ import annotations

import json
import random

import aiohttp
import pytest

from seaweedfs_tpu.master.sequence import MemorySequencer as RefSequencer
from seaweedfs_tpu.master.server import MasterServer as RefMaster
from seaweedfs_tpu_torch.master.sequence import MemorySequencer
from seaweedfs_tpu_torch.master.server import MasterServer

from test_torch_cluster_util import run
from test_torch_topology import _heartbeats


def _norm(body, master_url: str):
    """The body with the master's own address replaced."""
    return json.loads(json.dumps(body).replace(master_url, "MASTER"))


async def _pair_get(http, masters, path: str, **params):
    out = []
    for m in masters:
        async with http.get(f"http://{m.url}{path}", params=params) as r:
            out.append((r.status, _norm(await r.json(), m.url)))
    return out


async def _with_masters(seed: int, body):
    ref = RefMaster(port=0, pulse_seconds=60.0, volume_size_limit_mb=64)
    port = MasterServer(port=0, pulse_seconds=60.0, volume_size_limit_mb=64)
    await ref.start()
    await port.start()
    try:
        async with aiohttp.ClientSession() as http:
            for hb in _heartbeats(seed):
                for m in (ref, port):
                    async with http.post(f"http://{m.url}/cluster/heartbeat",
                                         json=hb) as r:
                        assert r.status == 200, await r.text()
            await body(http, ref, port)
    finally:
        await port.stop()
        await ref.stop()


@pytest.mark.parametrize("seed", range(3))
def test_same_heartbeats_give_equal_status_bodies(seed):
    async def body(http, ref, port):
        for path in ("/dir/status", "/vol/status", "/cluster/status"):
            (rs, rb), (ps, pb) = await _pair_get(http, (ref, port), path)
            assert (ps, pb) == (rs, rb), path
        vids = sorted(ref.topo.ec_shard_locations) + [999999]
        for vid in vids:
            (rs, rb), (ps, pb) = await _pair_get(
                http, (ref, port), "/vol/ec_lookup", volumeId=str(vid))
            assert (ps, pb) == (rs, rb), vid
        for vid in sorted(ref.topo.volume_locations)[:4] + [999999]:
            (rs, rb), (ps, pb) = await _pair_get(
                http, (ref, port), "/dir/lookup", volumeId=str(vid))
            assert (ps, pb) == (rs, rb), vid
    run(_with_masters(seed, body))


@pytest.mark.parametrize("seed", range(3))
def test_assign_picks_equal_volumes_and_keys(seed, monkeypatch):
    # the reference's placement modules get a private stream in place of
    # the module-global `random`, seeded like the port master's
    from seaweedfs_tpu.topology import layout as ref_layout
    from seaweedfs_tpu.topology import tree as ref_tree
    ref_rng = random.Random(seed)
    monkeypatch.setattr(ref_layout, "random", ref_rng)
    monkeypatch.setattr(ref_tree, "random", ref_rng)

    async def body(http, ref, port):
        port.topo.rng = random.Random(seed)
        got = {}
        for name, m in (("ref", ref), ("port", port)):
            fids = []
            for count in (1, 1, 3, 1, 2) * 4:
                async with http.get(f"http://{m.url}/dir/assign",
                                    params={"count": str(count)}) as r:
                    a = await r.json()
                assert r.status == 200, a
                vid, rest = a["fid"].split(",")
                # the key, without its 8 hex digits of cookie
                fids.append((vid, rest[:-8], a["url"], a["count"]))
            got[name] = fids
        assert got["port"] == got["ref"]
    run(_with_masters(seed, body))


def test_memory_sequencer_gives_equal_keys():
    rng = random.Random(5)
    ref, port = RefSequencer(), MemorySequencer()
    for _ in range(200):
        if rng.random() < 0.2:
            seen = rng.randint(0, 5000)
            ref.set_max(seen)
            port.set_max(seen)
        n = rng.randint(1, 9)
        assert port.next_file_id(n) == ref.next_file_id(n)
        assert port.peek() == ref.peek()


def test_shard_map_routes_are_not_ported_yet():
    """The shard-map routes now that filer/shard.py is ported (the name
    is kept from when the port answered them with 500): GET
    /cluster/shards and /debug/shards, and POSTed map ops (a register, a
    rejected split, a split intent and its idempotent re-submit), give
    both masters the same status and the same body, each master's own
    address masked."""
    ops = [({"op": "register", "shard": 1, "url": "h:1"}, 200),
           ({"op": "set", "rules": [["/a", 1]]}, 400),
           ({"op": "split_intent", "prefix": "/a", "to": 0}, 400),
           ({"op": "split_intent", "prefix": "/a", "to": 1}, 200),
           ({"op": "split_intent", "prefix": "/a", "to": 1}, 200)]

    async def body(http, ref, port):
        for path in ("/cluster/shards", "/debug/shards"):
            (rs, rb), (ps, pb) = await _pair_get(http, (ref, port), path)
            assert rs == 200 and (ps, pb) == (rs, rb), path
        for op, want in ops:
            got = []
            for m in (ref, port):
                async with http.post(f"http://{m.url}/cluster/shards",
                                     json=op) as r:
                    got.append((r.status, _norm(await r.json(), m.url)))
            assert got[0][0] == want and got[1] == got[0], (op, got)
        for path in ("/cluster/shards", "/debug/shards"):
            (rs, rb), (ps, pb) = await _pair_get(http, (ref, port), path)
            assert rs == 200 and (ps, pb) == (rs, rb), path
        assert rb["map"]["moves"]
    run(_with_masters(0, body))
