"""IP white-list guard (security/guard.go:43-137 semantics).

The cases of tests/test_guard.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.security.guard import Guard, parse_white_list


def test_guard_matching():
    assert Guard(()).allows("10.0.0.1")  # empty list admits everyone
    g = Guard(["127.0.0.1", "10.1.0.0/16"])
    assert g.allows("127.0.0.1")
    assert g.allows("10.1.255.3")
    assert not g.allows("10.2.0.1")
    assert not g.allows("192.168.0.9")
    assert not g.allows(None)
    assert not g.allows("not-an-ip")
    assert parse_white_list(" 1.2.3.4 , 10.0.0.0/8 ,") == \
        ["1.2.3.4", "10.0.0.0/8"]
    # a typo'd entry fails fast instead of silently never matching
    import pytest
    with pytest.raises(ValueError):
        Guard(["10.0.0.256"])
    # the CLI flag parser turns that into a clean exit, not a traceback
    with pytest.raises(SystemExit, match="10.0.0.256"):
        parse_white_list("127.0.0.1,10.0.0.256")


def test_path_guarded_prefix_semantics():
    from seaweedfs_tpu_torch.security.guard import path_guarded
    prefixes = ("/submit", "/vol/status", "/stats/")
    assert path_guarded("/submit", prefixes)
    assert path_guarded("/submit/extra", prefixes)
    # unrelated siblings must NOT be guarded (plain startswith would)
    assert not path_guarded("/submitfoo", prefixes)
    assert not path_guarded("/vol/statusx", prefixes)
    # entries ending in '/' guard the whole subtree
    assert path_guarded("/stats/health", prefixes)
    assert not path_guarded("/stats", prefixes)


def test_white_list_enforced_over_http(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            # flip on a whitelist that excludes the loopback client
            c.master.guard = Guard(["10.9.9.9"])
            c.servers[0].guard = Guard(["10.9.9.9"])
            async with c.http.get(
                    f"http://{c.master.url}/dir/assign") as resp:
                assert resp.status == 401
            # the mesh stays open: cluster status, raft/heartbeat.
            # /dir/lookup is guarded (master_server.go:111) but
            # heartbeating volume-server IPs are auto-admitted — the
            # loopback client shares the VS's IP here, so it passes
            async with c.http.get(
                    f"http://{c.master.url}/cluster/status") as resp:
                assert resp.status == 200
            async with c.http.get(
                    f"http://{c.master.url}/dir/lookup",
                    params={"volumeId": "1"}) as resp:
                assert resp.status != 401
            # ...but a non-peer, non-whitelisted IP is rejected: clear
            # the learned peer set to simulate a foreign client
            saved_peers = set(c.master._peer_ips)
            c.master._peer_ips.clear()
            async with c.http.get(
                    f"http://{c.master.url}/dir/lookup",
                    params={"volumeId": "1"}) as resp:
                assert resp.status == 401
            c.master._peer_ips.update(saved_peers)
            # volume: client writes guarded; without mTLS the /admin
            # mutation surface is guarded too (else a 401'd client could
            # still tombstone needles via /admin/batch_delete); reads
            # and replica forwards (JWT-covered when enforced) stay open
            vs = c.servers[0].url
            async with c.http.post(f"http://{vs}/1,01deadbeef",
                                   data=b"x") as resp:
                assert resp.status == 401
            async with c.http.post(
                    f"http://{vs}/admin/vacuum/check",
                    params={"volume": "1"}) as resp:
                assert resp.status == 401
            async with c.http.get(
                    f"http://{vs}/admin/volume/status",
                    params={"volume": "1"}) as resp:
                assert resp.status != 401  # GETs aren't mutations
            # without write JWTs a ?type=replicate spoof must NOT bypass
            # the IP guard (peers have to be whitelisted instead)
            async with c.http.post(f"http://{vs}/9,01deadbeef",
                                   data=b"x",
                                   params={"type": "replicate"}) as resp:
                assert (await resp.json())["error"] == \
                    "ip not in whitelist"
            # with JWTs enforced, replica forwards skip the IP guard and
            # are authenticated by their forwarded token instead
            c.servers[0].jwt_key = "k"
            async with c.http.post(f"http://{vs}/9,01deadbeef",
                                   data=b"x",
                                   params={"type": "replicate"}) as resp:
                assert (await resp.json())["error"] == "missing jwt"
            c.servers[0].jwt_key = ""
            async with c.http.get(f"http://{vs}/status") as resp:
                assert resp.status == 200
            # widen the list to include loopback: everything works again
            c.master.guard = Guard(["127.0.0.0/8"])
            c.servers[0].guard = Guard(["127.0.0.0/8"])
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"guarded-ok")
            assert st == 201
    run(body())
