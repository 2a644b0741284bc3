"""Cluster-wide EC workflows: ec.encode -> distributed reads ->
shard loss -> degraded read over the network -> ec.rebuild -> ec.balance.

This is the reference's north-star flow (SURVEY.md §3.3/3.4) running on the
in-proc cluster.

The cases of tests/test_ec_cluster.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
The port's shell drives port volume servers under the port's master, no
module of the JAX package in the loop (tests/test_torch_ec_cluster.py
runs the same cases with the JAX package's shell and master). One mixed
case holds the JAX package's volume servers under the port's master to
the same cluster under the JAX package's master.
"""

import asyncio
import json
import os
import random

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell import ec_commands as ec


async def _fill_volume(c: Cluster, n_files: int = 40) -> list[tuple[str, str, bytes]]:
    rng = random.Random(5)
    out = []
    for i in range(n_files):
        a = await c.assign(collection="ectest")
        data = bytes(rng.getrandbits(8)
                     for _ in range(rng.randint(500, 8000)))
        st, _ = await c.put(a["fid"], a["url"], data)
        assert st == 201
        out.append((a["fid"], a["publicUrl"], data))
    return out


def test_ec_encode_spread_read_rebuild_balance(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=4) as c:
            files = await _fill_volume(c)
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                vids = sorted({int(f.split(",")[0]) for f, _, _ in files})
                res = await ec.ec_encode(env, collection="ectest", vids=vids)
                assert res, "ec.encode produced no results"
                # shards spread over all 4 servers
                assignments = res[0]["assignments"]
                assert len(assignments) == 4
                assert sum(len(s) for s in assignments.values()) == 14

            # NO heartbeat_all here: ec mount/unmount/delete push
            # immediate delta heartbeats, so reads that land ANYWHERE in
            # the cluster right after ec.encode must already succeed —
            # waiting a pulse used to hide a window where remote-shard
            # lookups found nothing and reconstruction failed with too
            # few sources (the round-4 soak's 783-bad-read bug)
            for vs in c.servers:
                assert not any(int(v.split(",")[0]) in vs.store.volumes
                               for v, _, _ in files)
            for fid, url, data in files[:10]:
                st, got = await c.get(fid, url)
                assert st == 200 and got == data, fid

            # destroy one server's shard files -> degraded read still works
            async with CommandEnv(c.master.url, c.http) as env:
                smap = await ec.ec_shard_map(env)
            vid = vids[0]
            victim_url = smap[vid]["shards"][0][0]
            import seaweedfs_tpu_torch.ec.pipeline as pl
            victim = next(v for v in c.servers if v.url == victim_url)
            lost = sorted(victim.store.ec_volumes[vid].shards)
            base = victim._base_name(vid, "ectest")
            victim.store.unmount_ec_shards(vid)
            for sid in lost:
                os.remove(base + pl.to_ext(sid))
            await c.heartbeat_all()

            for fid, url, data in files[:5]:
                server = next(s for s in c.servers if s.url != victim_url)
                st, got = await c.get(fid, server.url)
                assert st == 200 and got == data, ("degraded", fid)

            # ec.rebuild regenerates the lost shards somewhere
            async with CommandEnv(c.master.url, c.http) as env:
                results = await ec.ec_rebuild(env, collection="ectest")
            assert any(r.get("rebuilt") for r in results), results
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                smap = await ec.ec_shard_map(env)
            assert len(smap[vid]["shards"]) == gf.TOTAL_SHARDS

            # ec.balance produces no moves or only valid ones, and reads
            # still succeed afterwards
            async with CommandEnv(c.master.url, c.http) as env:
                moves = await ec.ec_balance(env, collection="ectest")
            await c.heartbeat_all()
            for fid, url, data in files[:5]:
                st, got = await c.get(fid, url)
                assert st == 200 and got == data, ("post-balance", fid)

            # EC delete broadcasts the tombstone to every shard holder
            del_fid, del_url, _ = files[0]
            assert await c.delete(del_fid, del_url) == 200
            for vs in c.servers:
                st, _ = await c.get(del_fid, vs.url)
                assert st == 404, ("ec-delete", vs.url)
    run(body())


def test_ec_rebuild_unrepairable_reported(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            files = await _fill_volume(c, n_files=10)
            await c.heartbeat_all()
            vids = sorted({int(f.split(",")[0]) for f, _, _ in files})
            async with CommandEnv(c.master.url, c.http) as env:
                await ec.ec_encode(env, collection="ectest", vids=vids)
            await c.heartbeat_all()
            vid = vids[0]
            # destroy shards until < 10 remain
            import seaweedfs_tpu_torch.ec.pipeline as pl
            removed = 0
            for vs in c.servers:
                ev = vs.store.ec_volumes.get(vid)
                if ev is None:
                    continue
                sids = sorted(ev.shards)
                for sid in sids:
                    if removed >= 5:
                        break
                    vs.store.unmount_ec_shards(vid, [sid])
                    p = vs._base_name(vid, "ectest") + pl.to_ext(sid)
                    if os.path.exists(p):
                        os.remove(p)
                    removed += 1
            assert removed == 5
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                results = await ec.ec_rebuild(env, collection="ectest")
            assert any("unrepairable" in str(r.get("error", ""))
                       for r in results), results
    run(body())


def test_ec_decode_back_to_normal_volume(tmp_path):
    """The un-EC path (command_ec_decode.go + VolumeEcShardsToVolume):
    encode -> delete original -> lose a data shard -> ec.decode -> every
    needle reads back from the reassembled NORMAL volume."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=4) as c:
            files = await _fill_volume(c, n_files=25)
            await c.heartbeat_all()
            vids = sorted({int(f.split(",")[0]) for f, _, _ in files})
            async with CommandEnv(c.master.url, c.http) as env:
                await ec.ec_encode(env, collection="ectest", vids=vids)
            await c.heartbeat_all()
            vid = vids[0]
            # original volume is gone everywhere (sealed into shards)
            for vs in c.servers:
                assert vid not in vs.store.volumes

            # delete one needle through the EC path so the decode must
            # carry the tombstone into the rebuilt .idx
            del_fid, del_url, _ = files[-1]
            assert await c.delete(del_fid, del_url) == 200

            # lose one server's shards entirely: decode must gather +
            # reconstruct before reassembly
            import seaweedfs_tpu_torch.ec.pipeline as pl
            async with CommandEnv(c.master.url, c.http) as env:
                smap = await ec.ec_shard_map(env)
            victim_url = smap[vid]["shards"][0][0]
            victim = next(v for v in c.servers if v.url == victim_url)
            lost = sorted(victim.store.ec_volumes[vid].shards)
            base = victim._base_name(vid, "ectest")
            victim.store.unmount_ec_shards(vid)
            for sid in lost:
                os.remove(base + pl.to_ext(sid))
            await c.heartbeat_all()

            async with CommandEnv(c.master.url, c.http) as env:
                results = await ec.ec_decode(env, collection="ectest",
                                             vids=[vid])
            assert results and "error" not in results[0], results
            target_url = results[0]["node"]
            await c.heartbeat_all()

            # the volume is back as a NORMAL volume on the target and the
            # EC shards are gone cluster-wide
            target = next(v for v in c.servers if v.url == target_url)
            assert vid in target.store.volumes
            for vs in c.servers:
                assert vid not in vs.store.ec_volumes
                b = vs._base_name(vid, "ectest")
                if b:
                    assert not any(
                        os.path.exists(b + pl.to_ext(s))
                        for s in range(14)), vs.url

            # every live needle reads back through the normal read path
            for fid, url, data in files[:-1]:
                if int(fid.split(",")[0]) != vid:
                    continue
                st, got = await c.get(fid, target.url)
                assert st == 200 and got == data, fid
            # the EC-deleted needle stays deleted in the rebuilt volume
            st, _ = await c.get(del_fid, target.url)
            assert st == 404
    run(body())


def test_ec_verify_scrub_detects_bit_rot(tmp_path):
    """ec.verify: clean volumes scrub clean; a single flipped byte in
    one shard file is reported as a corrupt window."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=4) as c:
            files = await _fill_volume(c, n_files=20)
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                vids = sorted({int(f.split(",")[0]) for f, _, _ in files})
                await ec.ec_encode(env, collection="ectest", vids=vids)
                await c.heartbeat_all()
                reports = await ec.ec_verify(env, collection="ectest")
                assert reports, "no EC volumes scrubbed"
                for r in reports:
                    assert r.get("bad_windows") == [], r
                    assert r["windows"] >= 1

                # flip one byte in one mounted shard file, then re-scrub
                vid = reports[0]["volume"]
                victim = None
                for vs in c.servers:
                    ev = vs.store.ec_volumes.get(vid)
                    if ev and ev.shards:
                        sid = next(iter(ev.shards))
                        victim = ev.base_name + f".ec{sid:02d}"
                        break
                assert victim and os.path.getsize(victim) > 0
                with open(victim, "r+b") as f:
                    f.seek(os.path.getsize(victim) // 2)
                    b = f.read(1)
                    f.seek(-1, 1)
                    f.write(bytes([b[0] ^ 0xFF]))
                reports = await ec.ec_verify(env, volume_id=vid)
                assert len(reports) == 1
                # the scrubbing node may or may not be the corrupted
                # holder; verify through the node that holds the flipped
                # shard to pin detection
                bad = reports[0].get("bad_windows")
                if not bad:
                    for vs in c.servers:
                        ev = vs.store.ec_volumes.get(vid)
                        if ev and ev.shards:
                            rep = ev.verify_parity()
                            if rep["bad_windows"]:
                                bad = rep["bad_windows"]
                                break
                assert bad, "flipped byte not detected by any holder"
    run(body())


def test_reference_volume_servers_under_the_port_master(tmp_path,
                                                        monkeypatch):
    """The JAX package's volume servers heartbeating to a port master
    give what they give under the JAX package's master: the same fids on
    the same servers (one seeded stream per assign on each side), the
    same ec.encode placement through the reference shell, the same
    /vol/status body, and every needle back through GETs before and
    after one server loses its shards. All exact, with each address
    replaced by its server's index.

    The reference master's placement draws from the module-global
    `random` of topology/layout.py and tree.py, which the reference
    volume servers' heartbeat loops draw from too; here those two
    modules see a private stream instead, seeded like the port's."""
    from seaweedfs_tpu.master.server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
    from seaweedfs_tpu.shell import ec_commands as ref_ec
    from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
    from seaweedfs_tpu.storage.store import Store as RefStore
    import seaweedfs_tpu.ec.pipeline as ref_pl
    from seaweedfs_tpu.topology import layout as ref_layout
    from seaweedfs_tpu.topology import tree as ref_tree

    ref_rng = random.Random()
    monkeypatch.setattr(ref_layout, "random", ref_rng)
    monkeypatch.setattr(ref_tree, "random", ref_rng)

    async def one(sub: str, master_cls) -> dict:
        async with Cluster(str(tmp_path / sub), n_servers=4, pulse=60.0,
                           master_cls=master_cls, volume_cls=RefServer,
                           store_cls=RefStore) as c:
            stream = ref_rng
            if master_cls is not RefMaster:
                stream = c.master.topo.rng = random.Random()
            idx = {vs.url: f"S{i}" for i, vs in enumerate(c.servers)}

            def norm(body):
                text = json.dumps(body, sort_keys=True)
                for url, name in idx.items():
                    text = text.replace(url, name)
                return json.loads(text.replace(c.master.url, "MASTER"))

            rng = random.Random(5)
            files = []
            for i in range(24):
                stream.seed(1000 + i)
                a = await c.assign(collection="ectest")
                data = rng.randbytes(rng.randint(500, 8000))
                st, _ = await c.put(a["fid"], a["url"], data)
                assert st == 201
                files.append((a["fid"], a["url"], data))
            await c.heartbeat_all()
            out = {"fids": [(f.split(",")[0], f.split(",")[1][:-8],
                             idx[u]) for f, u, _ in files]}
            vids = sorted({int(f.split(",")[0]) for f, _, _ in files})
            async with RefEnv(c.master.url, c.http) as env:
                res = await ref_ec.ec_encode(env, collection="ectest",
                                             vids=vids)
                smap = await ref_ec.ec_shard_map(env)
            out["encode"] = norm(res)
            out["shards"] = norm({str(k): v for k, v in smap.items()})
            async with c.http.get(
                    f"http://{c.master.url}/vol/status") as r:
                out["status"] = norm(await r.json())
            for fid, url, data in files:
                st, got = await c.get(fid, url)
                assert (st, got) == (200, data), fid
            # one server loses every shard: degraded reads gather the
            # rest over the network
            vid = vids[0]
            victim = next(vs for vs in c.servers
                          if vid in vs.store.ec_volumes)
            base = victim._base_name(vid, "ectest")
            lost = sorted(victim.store.ec_volumes[vid].shards)
            victim.store.unmount_ec_shards(vid)
            for sid in lost:
                os.remove(base + ref_pl.to_ext(sid))
            await c.heartbeat_all()
            other = next(vs for vs in c.servers if vs is not victim)
            for fid, _, data in files:
                if int(fid.split(",")[0]) == vid:
                    st, got = await c.get(fid, other.url)
                    assert (st, got) == (200, data), (fid, got[:200])
            out["lost"] = [idx[victim.url], lost]
            return out

    want = run(one("ref", RefMaster))
    got = run(one("port", MasterServer))
    assert got == want
