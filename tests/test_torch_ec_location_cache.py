"""EC shard-location cache staleness tiers (server/ec_locations.py).

Reference: weed/storage/store_ec.go:218-259 — 11s lookup suppression,
7m TTL, 37m stale-while-error window.

The cases of tests/test_ec_location_cache.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

import asyncio

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.server.ec_locations import EcLocationCache


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _cache(results):
    """results: list mutated by tests; pop(0) per lookup; None = fail."""
    calls = []

    def lookup(vid):
        calls.append(vid)
        r = results.pop(0) if results else None
        if isinstance(r, Exception):
            raise r
        return r

    clock = Clock()
    return EcLocationCache(lookup, now=clock), calls, clock


def test_ttl_serves_without_lookup():
    locs = {"0": ["a:1"]}
    c, calls, clock = _cache([locs])
    assert c.get(5) == locs
    for _ in range(100):
        assert c.get(5) == locs
    assert len(calls) == 1          # one lookup for the whole burst
    clock.t += EcLocationCache.TTL_S + 1
    c2 = {"0": ["b:2"]}
    c._lookup = lambda vid: c2
    assert c.get(5) == c2           # TTL expiry re-resolves


def test_fresh_window_suppresses_lookup_after_failure():
    c, calls, clock = _cache([None])      # first lookup fails
    assert c.get(7) is None
    assert c.get(7) is None               # inside 11s: no second dial
    assert len(calls) == 1
    clock.t += EcLocationCache.FRESH_S + 1
    c._lookup = lambda vid: {"1": ["x:1"]}
    assert c.get(7) == {"1": ["x:1"]}     # after the window, retried


def test_stale_while_error_then_expire():
    locs = {"2": ["a:1"]}
    c, calls, clock = _cache([locs])
    assert c.get(9) == locs
    # TTL passes, every lookup now fails -> keep serving stale
    clock.t += EcLocationCache.TTL_S + 1
    c._lookup = lambda vid: (_ for _ in ()).throw(OSError("master down"))
    assert c.get(9) == locs
    # ... until the 37m expiry, then None
    clock.t += EcLocationCache.EXPIRE_S
    assert c.get(9) is None


def test_invalidate_forces_immediate_relookup_once_per_window():
    l1, l2 = {"0": ["dead:1"]}, {"0": ["alive:2"]}
    seq = [l1, l2]
    c, calls, clock = _cache(seq)
    assert c.get(3) == l1
    c.invalidate(3)
    # a shard move must not leave readers stuck on dead holders
    assert c.get(3) == l2
    assert len(calls) == 2
    # an every-holder-down storm: further invalidations inside the
    # FRESH window do NOT force more lookups (stale l2 keeps serving)
    for _ in range(50):
        c.invalidate(3)
        assert c.get(3) == l2
    assert len(calls) == 2
    # after the window, one more forced re-lookup is allowed
    clock.t += EcLocationCache.FRESH_S + 1
    c._lookup = lambda vid: (calls.append(vid), {"0": ["c:3"]})[1]
    c.invalidate(3)
    assert c.get(3) == {"0": ["c:3"]}
    assert len(calls) == 3


def test_degraded_read_burst_one_master_lookup(tmp_path):
    """Cluster-level: a burst of EC reads needing remote shard fetches
    costs each server ONE master ec_lookup per volume, not one per
    interval (the pre-cache behavior at volume_server.py round 3)."""
    import random

    from seaweedfs_tpu.shell import ec_commands as ec
    from seaweedfs_tpu.shell.env import CommandEnv

    async def body():
        async with Cluster(str(tmp_path), n_servers=3) as c:
            rng = random.Random(2)
            files = []
            for _ in range(12):
                a = await c.assign(collection="ecc")
                data = bytes(rng.getrandbits(8)
                             for _ in range(rng.randint(500, 6000)))
                st, _ = await c.put(a["fid"], a["url"], data)
                assert st == 201
                files.append((a["fid"], data))
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                vids = sorted({int(f.split(",")[0]) for f, _ in files})
                res = await ec.ec_encode(env, collection="ecc", vids=vids)
                assert res
            await c.heartbeat_all()

            # count master lookups issued by each server's cache
            counts = {vs.url: [] for vs in c.servers}
            for vs in c.servers:
                inner = vs._ec_locations._lookup

                def counting(vid, _inner=inner, _log=counts[vs.url]):
                    _log.append(vid)
                    return _inner(vid)
                vs._ec_locations._lookup = counting

            # read every file from every server, twice: plenty of remote
            # interval fetches
            for _ in range(2):
                for fid, data in files:
                    for vs in c.servers:
                        st, got = await c.get(fid, vs.url)
                        assert st == 200 and got == data
            for url, log in counts.items():
                # at most one lookup per (server, volume)
                assert len(log) == len(set(log)), (url, log)
    run(body())
