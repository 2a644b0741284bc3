"""Vacuum/compaction (incl. racing-write replay) + volume repair/balance.

The compact, cluster-vacuum, fix-replication and balance cases of
tests/test_vacuum_and_balance.py pointed at the port's storage/vacuum.py
and its volume servers (tests/test_torch_cluster_util.py); the JAX
package's shell drives them under its master. Its planner cases test the
shell alone, which the port has not got yet. The port's compaction of a
volume the JAX package wrote is byte-equal to the JAX package's."""

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu.shell.env import CommandEnv
from seaweedfs_tpu.shell import volume_commands as vc
from seaweedfs_tpu_torch.storage import vacuum
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import AlreadyDeleted, NotFound, Volume


def test_compact_reclaims_space(tmp_path):
    v = Volume(str(tmp_path), "", 31)
    for i in range(1, 21):
        v.write_needle(Needle(cookie=i, id=i, data=bytes([i]) * 1000))
    for i in range(1, 11):
        v.delete_needle(Needle(cookie=i, id=i))
    big = v.data_size()
    assert v.garbage_level() > 0.3
    vacuum.compact(v)
    vacuum.commit_compact(v)
    assert v.data_size() < big
    assert v.garbage_level() == 0.0
    # survivors readable, deleted still gone, revision bumped
    for i in range(11, 21):
        assert v.read_needle(i).data == bytes([i]) * 1000
    for i in range(1, 11):
        with pytest.raises(Exception):
            v.read_needle(i)
    assert v.super_block.compaction_revision == 1
    v.close()


def test_compact_with_racing_writes(tmp_path):
    """The makeupDiff path: writes and deletes that land between compact()
    and commit_compact() survive the swap (volume_vacuum_test.go pattern)."""
    v = Volume(str(tmp_path), "", 32)
    for i in range(1, 6):
        v.write_needle(Needle(cookie=i, id=i, data=b"orig-%d" % i))
    v.delete_needle(Needle(cookie=2, id=2))
    vacuum.compact(v)
    # racing traffic after the snapshot:
    v.write_needle(Needle(cookie=9, id=9, data=b"new-needle"))     # create
    v.write_needle(Needle(cookie=3, id=3, data=b"overwritten!"))   # update
    v.delete_needle(Needle(cookie=4, id=4))                        # delete
    vacuum.commit_compact(v)
    assert v.read_needle(9).data == b"new-needle"
    assert v.read_needle(3).data == b"overwritten!"
    with pytest.raises(AlreadyDeleted):
        v.read_needle(4)
    assert v.read_needle(1).data == b"orig-1"
    v.close()


def test_cluster_vacuum_command(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign(replication="001")
            fids = []
            for i in range(20):
                aa = await c.assign(replication="001")
                await c.put(aa["fid"], aa["url"], b"x" * 2000)
                fids.append(aa["fid"])
            for fid in fids[:15]:
                await c.delete(fid, a["url"])
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                res = await vc.volume_vacuum(env, garbage_threshold=0.3)
            assert any(r.get("vacuumed") for r in res), res
            # surviving files still readable on both replicas
            for fid in fids[15:]:
                st, data = await c.get(fid, a["url"])
                assert st == 200 and data == b"x" * 2000
    run(body())


def test_fix_replication(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=3) as c:
            a = await c.assign(replication="001")
            await c.put(a["fid"], a["url"], b"fragile")
            await c.heartbeat_all()
            vid = int(a["fid"].split(",")[0])
            # kill one replica
            holders = [vs for vs in c.servers if vid in vs.store.volumes]
            assert len(holders) == 2
            victim = holders[0]
            victim.store.delete_volume(vid)
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                actions = await vc.volume_fix_replication(env)
            assert any(x.get("copy_to") for x in actions), actions
            await c.heartbeat_all()
            holders = [vs for vs in c.servers if vid in vs.store.volumes]
            assert len(holders) == 2
            # data intact on the new replica
            key = int(a["fid"].split(",")[1][:-8], 16)
            for vs in holders:
                assert vs.store.read_needle(vid, key).data == b"fragile"
    run(body())


def test_volume_balance(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            # load all volumes onto server 0 by only heartbeating it first
            for i in range(4):
                c.servers[0].store.add_volume(100 + i)
            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                moves = await vc.volume_balance(env)
            assert len(moves) >= 1
            await c.heartbeat_all()
            counts = sorted(len(vs.store.volumes) for vs in c.servers)
            assert counts == [2, 2]
    run(body())


def test_compaction_equals_the_reference(tmp_path):
    """One volume written by the JAX package, with deletes and an
    overwrite, copied twice: each package compacts its copy, and the .dat
    and .idx files come out byte-equal. (Racing writes carry the clock
    in their records, so test_compact_with_racing_writes covers them.)"""
    import shutil
    from seaweedfs_tpu.storage import vacuum as ref_vacuum
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle
    from seaweedfs_tpu.storage.volume import Volume as RefVolume
    src = tmp_path / "src"
    ref = RefVolume(str(src), "", 33)
    for i in range(1, 31):
        ref.write_needle(RefNeedle(cookie=i, id=i, data=bytes([i]) * 700))
    for i in range(1, 31, 3):
        ref.delete_needle(RefNeedle(cookie=i, id=i))
    ref.write_needle(RefNeedle(cookie=5, id=5, data=b"overwritten"))
    ref.close()
    for d in ("ref", "port"):
        shutil.copytree(src, tmp_path / d)
    r = RefVolume(str(tmp_path / "ref"), "", 33, create_if_missing=False)
    p = Volume(str(tmp_path / "port"), "", 33, create_if_missing=False)
    ref_vacuum.compact(r)
    vacuum.compact(p)
    ref_vacuum.commit_compact(r)
    vacuum.commit_compact(p)
    assert p.read_needle(5).data == b"overwritten"
    with pytest.raises(NotFound):
        p.read_needle(4)
    base_r, base_p = r.file_name(), p.file_name()
    r.close()
    p.close()
    for ext in (".dat", ".idx"):
        with open(base_r + ext, "rb") as a, open(base_p + ext, "rb") as b:
            assert a.read() == b.read(), ext
