"""Master automatic maintenance: leader-only auto-vacuum + admin scripts.

Reference: weed/server/master_server.go:186-250 (startAdminScripts),
weed/topology/topology_event_handling.go:22-28 (auto-vacuum timer),
weed/command/scaffold.go:337-361 (master.toml [master.maintenance]).

The cases of tests/test_maintenance.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

import asyncio
import os

from test_torch_cluster_util import Cluster, run


async def _fill_and_delete(c: Cluster) -> tuple[str, int, int]:
    """Write 10 needles to one volume, delete 8 — returns (vid, surviving
    fid, dirty size)."""
    a = await c.assign()
    vid = a["fid"].split(",")[0]
    fids = [a["fid"]]
    st, _ = await c.put(a["fid"], a["url"], b"k" * 10_000)
    assert st == 201
    for i in range(2, 11):
        fid = f"{vid},{i:02x}cafebabe"
        st, _ = await c.put(fid, a["url"], b"g" * 10_000)
        assert st == 201
        fids.append(fid)
    for fid in fids[2:]:
        assert await c.delete(fid, a["url"]) == 200
    v = c.servers[0].store.volumes[int(vid)]
    return a, fids, v


def test_master_auto_vacuum(tmp_path):
    """A cluster left alone reclaims space once garbage crosses the
    threshold — no shell interaction."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1, master_kwargs={
                "maintenance_interval_s": 0.3,
                "garbage_threshold": 0.2}) as c:
            a, fids, v = await _fill_and_delete(c)
            dirty = v.data_size()
            assert v.garbage_level() > 0.2
            for _ in range(60):  # up to ~6s for the loop to fire
                await asyncio.sleep(0.1)
                if v.data_size() < dirty and v.garbage_level() == 0.0:
                    break
            assert v.data_size() < dirty, "auto-vacuum never ran"
            assert v.garbage_level() == 0.0
            # survivors still readable after compaction
            for fid in fids[:2]:
                st, data = await c.get(fid, a["publicUrl"])
                assert st == 200 and len(data) == 10_000
    run(body())


def test_master_admin_scripts(tmp_path):
    """Configured admin script lines run on their own cadence through the
    shell dispatcher (reference-style -k=v flags included)."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1, master_kwargs={
                "maintenance_interval_s": 0,      # isolate the scripts path
                "admin_scripts": [
                    "volume.vacuum -garbageThreshold=0.2"],
                "admin_scripts_interval_s": 0.3}) as c:
            a, fids, v = await _fill_and_delete(c)
            dirty = v.data_size()
            for _ in range(60):
                await asyncio.sleep(0.1)
                if v.data_size() < dirty:
                    break
            assert v.data_size() < dirty, "admin script never ran"
    run(body())


def test_master_toml_parsing(tmp_path, monkeypatch):
    """master.toml discovery feeds [master.maintenance] into the server
    config (scaffold.go:337-361)."""
    from seaweedfs_tpu_torch.cli import _load_master_toml

    (tmp_path / "master.toml").write_text(
        '[master.maintenance]\n'
        'scripts = """\n'
        '  volume.fix.replication\n'
        '  ec.rebuild -force\n'
        '"""\n'
        'sleep_minutes = 3\n'
        '[master.sequencer]\n'
        'type = "memory"\n')
    monkeypatch.chdir(tmp_path)
    cfg = _load_master_toml()
    assert cfg["admin_scripts"] == ["volume.fix.replication",
                                    "ec.rebuild -force"]
    assert cfg["admin_scripts_interval_s"] == 180.0
    assert "sequencer" not in cfg  # memory = default, not forwarded


def test_only_leader_runs_maintenance(tmp_path):
    """In a multi-master cluster the maintenance loops are leader-gated:
    followers wake up, see they are not leader, and do nothing — so a
    vacuum never runs twice concurrently (topology_event_handling.go's
    loop runs only on the elected master)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import asyncio

    from test_torch_master_election import _make_cluster, _wait_single_leader
    from seaweedfs_tpu_torch.shell import volume_commands as vc

    async def body():
        masters = await _make_cluster(2)
        try:
            leader = await _wait_single_leader(masters)
            follower = next(m for m in masters if m is not leader)
            # both loops configured hot; count volume_vacuum invocations
            calls = []
            orig = vc.volume_vacuum

            async def counting(env, *a, **kw):
                calls.append(env.master_url)
                return []
            vc.volume_vacuum = counting
            try:
                for m in masters:
                    m.maintenance_interval_s = 0.2
                    m._tasks.append(asyncio.create_task(
                        m._auto_vacuum_loop()))
                await asyncio.sleep(1.2)
            finally:
                vc.volume_vacuum = orig
            assert calls, "leader never ran maintenance"
            assert set(calls) == {leader.url}, (calls, leader.url,
                                                follower.url)
        finally:
            for m in masters:
                await m.stop()
    run(body())
