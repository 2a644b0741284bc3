"""Autopilot maintenance plane: planner purity/determinism, executor
pacing + pause-on-page + leadership discipline, the rebuild-to-target
admin route, and live observe->plan->execute convergence on the
in-proc cluster (lost shard AND scrub-localized rot).

The cases of tests/test_autopilot.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

import asyncio
import copy
import importlib
import os
import random

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.autopilot import (Action, ClusterSnapshot,
                                     CorruptionReport, EcVolumeState,
                                     NodeState, PlannerConfig,
                                     VolumeState, plan)
from seaweedfs_tpu_torch.autopilot.execute import ActionError, Executor
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.shell import ec_commands as ec
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.topology.layout import rank_repair_targets


# ---------------------------------------------------------------------------
# planner: pure + deterministic
# ---------------------------------------------------------------------------


def _random_snapshot(rng: random.Random) -> ClusterSnapshot:
    n_nodes = rng.randint(1, 8)
    nodes = tuple(NodeState(
        url=f"10.0.0.{i}:80{i}", data_center=f"dc{rng.randint(0, 2)}",
        rack=f"r{rng.randint(0, 3)}", free_slots=rng.randint(0, 10))
        for i in range(n_nodes))
    urls = [n.url for n in nodes]
    volumes = []
    for vid in range(1, rng.randint(1, 6)):
        holders = tuple(sorted(rng.sample(
            urls, rng.randint(1, len(urls)))))
        size = rng.randint(0, 1 << 20)
        volumes.append(VolumeState(
            vid=vid, collection=rng.choice(("", "c")), size=size,
            deleted_bytes=rng.randint(0, size) if size else 0,
            read_only=rng.random() < 0.3, remote=rng.random() < 0.2,
            replica_count=rng.randint(1, 3), holders=holders))
    ec_volumes = []
    corruptions = []
    for vid in range(100, 100 + rng.randint(0, 4)):
        shards = []
        for sid in range(gf.TOTAL_SHARDS):
            if rng.random() < 0.85:
                shards.append((sid, (rng.choice(urls),)))
        if shards:
            ec_volumes.append(EcVolumeState(
                vid=vid, collection="", shards=tuple(shards)))
        if rng.random() < 0.4:
            corruptions.append(CorruptionReport(
                vid=vid, offset=rng.randrange(0, 4) << 20, size=1 << 20,
                shards=(rng.randrange(gf.TOTAL_SHARDS),)
                if rng.random() < 0.7 else ()))
    return ClusterSnapshot(
        nodes=nodes, volumes=tuple(volumes),
        ec_volumes=tuple(ec_volumes), corruptions=tuple(corruptions),
        volume_size_limit=8 << 20, paging=rng.random() < 0.1)


def test_planner_deterministic_property():
    """Identical snapshots -> identical ordered plans, and planning
    mutates nothing — over 60 randomized cluster states."""
    cfg = PlannerConfig(tier_backend="mmap.hot")
    for seed in range(60):
        snap = _random_snapshot(random.Random(seed))
        before = copy.deepcopy(snap)
        a1, d1 = plan(snap, cfg)
        a2, d2 = plan(snap, cfg)
        assert a1 == a2 and d1 == d2, f"seed {seed} not deterministic"
        assert snap == before, f"seed {seed} mutated its snapshot"
        # plans are in execution order: priorities never decrease
        prios = [a.priority for a in a1]
        assert prios == sorted(prios), f"seed {seed} order broken"


def test_planner_input_order_independent():
    """The same cluster state presented with shuffled tuple orderings
    must plan identically (canonicalization lives in the planner)."""
    rng = random.Random(7)
    snap = _random_snapshot(rng)
    shuffled = ClusterSnapshot(
        nodes=tuple(reversed(snap.nodes)),
        volumes=tuple(reversed(snap.volumes)),
        ec_volumes=tuple(reversed(snap.ec_volumes)),
        corruptions=tuple(reversed(snap.corruptions)),
        volume_size_limit=snap.volume_size_limit,
        paging=snap.paging)
    cfg = PlannerConfig()
    assert plan(snap, cfg) == plan(shuffled, cfg)


def _nodes(n=4, racks=2):
    return tuple(NodeState(url=f"h{i}:80", data_center="dc",
                           rack=f"r{i % racks}", free_slots=5)
                 for i in range(n))


def test_single_missing_shard_outranks_everything():
    ecv = EcVolumeState(vid=5, shards=tuple(
        (sid, (f"h{sid % 3}:80",)) for sid in range(13)))
    vol = VolumeState(vid=1, size=100, deleted_bytes=90,
                      replica_count=2, holders=("h0:80",))
    snap = ClusterSnapshot(nodes=_nodes(), volumes=(vol,),
                           ec_volumes=(ecv,), volume_size_limit=8 << 20)
    actions, _ = plan(snap, PlannerConfig())
    assert actions[0].kind == "rebuild_shard"
    assert actions[0].shards == (13,)
    assert actions[0].priority == 0
    # target is the node holding NO shard of this volume (h3)
    assert actions[0].target == "h3:80"
    # gather map carries exactly the clean survivors
    assert len(actions[0].sources) == 13


def test_rotten_shard_rebuilds_in_place():
    ecv = EcVolumeState(vid=5, shards=tuple(
        (sid, (f"h{sid % 4}:80",)) for sid in range(14)))
    snap = ClusterSnapshot(
        nodes=_nodes(), ec_volumes=(ecv,),
        corruptions=(CorruptionReport(vid=5, offset=0, size=1 << 20,
                                      shards=(12,)),),
        volume_size_limit=8 << 20)
    actions, defer = plan(snap, PlannerConfig())
    assert len(actions) == 1 and not defer
    a = actions[0]
    assert a.kind == "rebuild_shard" and a.shards == (12,)
    assert a.target == "h0:80"      # shard 12's current holder
    # the rotten shard is NOT in the gather sources
    assert all(sid != 12 for sid, _ in a.sources)


def test_unlocalized_corruption_defers():
    ecv = EcVolumeState(vid=5, shards=tuple(
        (sid, ("h0:80",)) for sid in range(14)))
    snap = ClusterSnapshot(
        nodes=_nodes(), ec_volumes=(ecv,),
        corruptions=(CorruptionReport(vid=5, shards=()),),
        volume_size_limit=8 << 20)
    actions, defer = plan(snap, PlannerConfig())
    assert not actions
    assert any(d.reason == "corruption-unlocalized" for d in defer)


def test_unlocalized_window_poisons_all_rebuilds_for_the_vid():
    """Review regression: a vid with one LOCALIZED rotten shard AND one
    ambiguous window must defer everything — a rebuild of the
    localized shard would regenerate from survivors the ambiguous
    window says may be rotten, overwriting good bytes with garbage."""
    ecv = EcVolumeState(vid=5, shards=tuple(
        (sid, (f"h{sid % 4}:80",)) for sid in range(13)))  # 13 missing
    snap = ClusterSnapshot(
        nodes=_nodes(), ec_volumes=(ecv,),
        corruptions=(
            CorruptionReport(vid=5, offset=0, size=1 << 20,
                             shards=(12,)),
            CorruptionReport(vid=5, offset=1 << 20, size=1 << 20,
                             shards=()),
        ),
        volume_size_limit=8 << 20)
    actions, defer = plan(snap, PlannerConfig())
    assert not actions
    assert any(d.reason == "corruption-unlocalized" and d.vid == 5
               for d in defer)


def test_multi_holder_rotten_shard_defers():
    """Review regression: rot localized to a shard held by TWO nodes
    must defer — the report cannot say which copy is rotten, and
    regenerating the clean one would leave the rot serving forever."""
    shards = [(sid, (f"h{sid % 4}:80",)) for sid in range(14)]
    shards[12] = (12, ("h0:80", "h1:80"))
    snap = ClusterSnapshot(
        nodes=_nodes(), ec_volumes=(EcVolumeState(
            vid=5, shards=tuple(shards)),),
        corruptions=(CorruptionReport(vid=5, offset=0, size=1 << 20,
                                      shards=(12,)),),
        volume_size_limit=8 << 20)
    actions, defer = plan(snap, PlannerConfig())
    assert not actions
    assert [d.reason for d in defer] == ["rot-multi-holder"]


def test_unrepairable_defers():
    ecv = EcVolumeState(vid=5, shards=tuple(
        (sid, ("h0:80",)) for sid in range(9)))   # < k survivors
    snap = ClusterSnapshot(nodes=_nodes(), ec_volumes=(ecv,),
                           volume_size_limit=8 << 20)
    actions, defer = plan(snap, PlannerConfig())
    assert not actions
    assert [d.reason for d in defer] == ["unrepairable"]


def test_multi_missing_spreads_targets():
    """Four lost shards must not all land on one rebuild target."""
    ecv = EcVolumeState(vid=5, shards=tuple(
        (sid, (f"h{sid % 2}:80",)) for sid in range(10)))
    snap = ClusterSnapshot(nodes=_nodes(n=6, racks=3),
                           ec_volumes=(ecv,),
                           volume_size_limit=8 << 20)
    actions, _ = plan(snap, PlannerConfig())
    rebuilds = [a for a in actions if a.kind == "rebuild_shard"]
    covered = sorted(s for a in rebuilds for s in a.shards)
    assert covered == [10, 11, 12, 13]
    assert len({a.target for a in rebuilds}) > 1
    assert all(a.priority == 1 for a in rebuilds)


def test_replicate_vacuum_tier_and_remote_skip():
    nodes = _nodes()
    vols = (
        VolumeState(vid=1, size=100, replica_count=2,
                    holders=("h0:80",)),                 # under-replicated
        VolumeState(vid=2, size=100, deleted_bytes=40,
                    holders=("h1:80",)),                 # dirty
        VolumeState(vid=3, size=100, read_only=True,
                    holders=("h2:80",)),                 # sealed -> tier
        VolumeState(vid=4, size=100, read_only=True, remote=True,
                    holders=("h3:80",)),                 # already tiered
    )
    snap = ClusterSnapshot(nodes=nodes, volumes=vols,
                           volume_size_limit=8 << 20)
    actions, _ = plan(snap, PlannerConfig(garbage_threshold=0.3,
                                          tier_backend="mmap.hot"))
    kinds = [(a.kind, a.vid) for a in actions]
    assert kinds == [("replicate_volume", 1), ("vacuum_volume", 2),
                     ("tier_seal", 3)]
    rep = actions[0]
    assert rep.target != "h0:80" and rep.holders == ("h0:80",)
    # no tier backend configured -> no tier action at all
    a2, _ = plan(snap, PlannerConfig())
    assert all(a.kind != "tier_seal" for a in a2)


def test_rank_repair_targets_rack_aware():
    nodes = [NodeState(url=f"h{i}:80", data_center="dc",
                       rack="r0" if i < 2 else "r1", free_slots=5 - i)
             for i in range(4)]
    # holders both in r0 -> r1 nodes must rank first
    ranked = rank_repair_targets(nodes, {"h0:80", "h1:80"})
    assert ranked[0].startswith("h2") or ranked[0].startswith("h3")
    assert set(ranked) == {"h2:80", "h3:80"}
    # full nodes are excluded
    nodes2 = [NodeState(url="a:1", rack="r0", free_slots=0),
              NodeState(url="b:1", rack="r1", free_slots=1)]
    assert rank_repair_targets(nodes2, set()) == ["b:1"]


# ---------------------------------------------------------------------------
# executor: dry-run ledger, pacing, pause, leadership, fallback targets
# ---------------------------------------------------------------------------


def _sample_actions():
    return [
        Action(kind="rebuild_shard", vid=7, priority=0, shards=(3,),
               target="t1:80", targets=("t1:80", "t2:80"),
               sources=((0, "s0:80"),), bytes_est=1000),
        Action(kind="vacuum_volume", vid=2, priority=3,
               holders=("h0:80", "h1:80"), bytes_est=500),
        Action(kind="tier_seal", vid=3, priority=4, target="mmap.hot",
               holders=("h0:80",), bytes_est=200),
    ]


def test_dryrun_ledger_matches_live_execution():
    """-autopilot.dryrun emits the EXACT action list live mode
    executes: same actions, same order — only nothing is sent."""
    async def body():
        calls = []

        async def recorder(url, path, params, timeout_s=60.0):
            calls.append((url, path, params.get("volume")))
            return {"ok": True}

        actions = _sample_actions()
        live = Executor(recorder, mbps=0, concurrency=1)
        live_results = await live.execute(actions)
        dry = Executor(recorder, mbps=0, concurrency=1, dryrun=True)
        n_calls = len(calls)
        dry_results = await dry.execute(actions)
        assert len(calls) == n_calls          # dry-run sent NOTHING
        assert [r["action"] for r in dry_results] == \
               [r["action"] for r in live_results]
        assert all(r["status"] == "dryrun" for r in dry_results)
        assert all(r["status"] == "ok" for r in live_results)
        # live dispatches hit the right routes
        assert ("t1:80", "/admin/ec/rebuild_shard", "7") in calls
        assert ("h0:80", "/admin/tier/upload", "3") in calls
        assert ("h1:80", "/admin/vacuum/commit", "2") in calls
    run(body())


def test_executor_falls_back_to_next_target():
    async def body():
        calls = []

        async def flaky(url, path, params, timeout_s=60.0):
            calls.append(url)
            if url == "t1:80":
                raise ActionError("partition mismatch")
            return {"ok": True}

        ex = Executor(flaky, mbps=0, concurrency=1)
        [res] = await ex.execute([_sample_actions()[0]])
        assert res["status"] == "ok"
        assert res["target"] == "t2:80"
        assert calls == ["t1:80", "t2:80"]
    run(body())


def test_executor_pays_token_bucket():
    """Every action's bytes are paid BEFORE dispatch: at 1 MB/s, 3 MB
    of estimated repair must accumulate ~2 s of pacing sleep (burst
    covers the first MB)."""
    async def body():
        slept = []

        async def fake_sleep(s):
            slept.append(s)

        async def ok(url, path, params, timeout_s=60.0):
            return {"ok": True}

        ex = Executor(ok, mbps=1.0, concurrency=1, sleep=fake_sleep)
        actions = [Action(kind="tier_seal", vid=i, priority=4,
                          target="b", holders=("h:1",),
                          bytes_est=1 << 20) for i in range(3)]
        await ex.execute(actions)
        assert ex.bytes_paid == 3 << 20
        # injected sleep never advances the clock, so the deficit
        # accumulates: >= (bytes - burst) / rate of pacing sleep
        assert 1.5 <= ex.paced_sleep_s <= 3.5, ex.paced_sleep_s
        assert slept, "bucket never slept"
    run(body())


def test_executor_pauses_on_page_and_defers_when_stuck():
    async def body():
        state = {"paging": True, "polls": 0}

        async def paging():
            state["polls"] += 1
            if state["polls"] > 3:
                state["paging"] = False
            return state["paging"]

        async def ok(url, path, params, timeout_s=60.0):
            return {"ok": True}

        async def fake_sleep(s):
            pass

        ex = Executor(ok, mbps=0, concurrency=1, paging=paging,
                      sleep=fake_sleep)
        [res] = await ex.execute([_sample_actions()[2]])
        assert res["status"] == "ok"          # ran after the page cleared
        assert ex.paused_s > 0

        # paging forever -> the cycle defers instead of wedging
        async def always(): return True
        ex2 = Executor(ok, mbps=0, concurrency=1, paging=always,
                       sleep=fake_sleep, pause_max_s=0.0)
        [r2] = await ex2.execute([_sample_actions()[2]])
        assert r2["status"] == "deferred"
    run(body())


def test_executor_halts_on_leadership_loss():
    async def body():
        state = {"n": 0}

        def leader():
            state["n"] += 1
            # the executor consults leadership around the pause gate
            # (twice per action): depose after the first action's pair
            return state["n"] <= 2

        async def ok(url, path, params, timeout_s=60.0):
            return {"ok": True}

        ex = Executor(ok, mbps=0, concurrency=1, is_leader=leader)
        results = await ex.execute(_sample_actions())
        statuses = [r["status"] for r in results]
        assert statuses[0] == "ok"
        assert set(statuses[1:]) == {"halted"}
    run(body())


def test_cycle_halts_when_deposed_between_plan_and_execute():
    """HA quorum discipline: a leader deposed mid-cycle (after its
    observation, before execution) must execute NOTHING — the planned
    actions were derived from a leadership that no longer exists, and
    the successor's autopilot owns the cluster from ITS observation."""
    async def body():
        from seaweedfs_tpu_torch.autopilot.controller import Autopilot

        state = {"leader": True}

        class FakeMaster:
            @property
            def is_leader(self):
                return state["leader"]

        ap = Autopilot(FakeMaster())
        dispatched = []

        async def fake_snapshot():
            return ClusterSnapshot(), []
        ap.observer.snapshot = fake_snapshot

        def fake_plan(snap, cfg):
            # deposition lands exactly between plan and execute
            state["leader"] = False
            return [Action(kind="vacuum_volume", vid=1,
                           holders=("10.0.0.1:801",))], []
        import seaweedfs_tpu_torch.autopilot.controller as ctl
        orig_plan = ctl.plan
        ctl.plan = fake_plan

        async def spy_post(url, path, params, timeout_s=60.0):
            dispatched.append((url, path))
            return {"ok": True}
        ap.executor.node_post = spy_post
        try:
            report = await ap.run_cycle()
        finally:
            ctl.plan = orig_plan
        assert report["halted"] == "lost leadership"
        assert report["executed"] == []
        assert len(report["planned"]) == 1   # the plan WAS made...
        assert dispatched == []              # ...and nothing ran
        assert ap.state == "follower"
        assert ap.actions_ok == 0 and ap.actions_failed == 0
    run(body())


# ---------------------------------------------------------------------------
# live cluster: the rebuild-to-target route + full heal cycles
# ---------------------------------------------------------------------------


async def _encode_one_volume(c: Cluster, n_files: int = 30):
    rng = random.Random(11)
    files = []
    for _ in range(n_files):
        a = await c.assign(collection="ap")
        data = bytes(rng.getrandbits(8)
                     for _ in range(rng.randint(500, 6000)))
        st, _ = await c.put(a["fid"], a["url"], data)
        assert st == 201
        files.append((a["fid"], a["publicUrl"], data))
    await c.heartbeat_all()
    async with CommandEnv(c.master.url, c.http) as env:
        vids = sorted({int(f.split(",")[0]) for f, _, _ in files})
        await ec.ec_encode(env, collection="ap", vids=vids)
    return files, vids


def test_rebuild_shard_route_and_heal_cycle(tmp_path):
    """Kill one holder's shards on disk; one forced autopilot cycle
    must re-host them on live nodes via /admin/ec/rebuild_shard, after
    which reads verify and the registry is whole again."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=4) as c:
            files, vids = await _encode_one_volume(c)
            vid = vids[0]
            async with CommandEnv(c.master.url, c.http) as env:
                smap = await ec.ec_shard_map(env)
            victim_url = smap[vid]["shards"][0][0]
            victim = next(v for v in c.servers if v.url == victim_url)
            lost = sorted(victim.store.ec_volumes[vid].shards)
            # the holder DIES (shards with it) — the autopilot must
            # re-host its shards on the surviving nodes
            c.servers.remove(victim)
            await victim.stop()
            # outlive the liveness window so the observer sees 3 nodes
            await asyncio.sleep(3 * c.pulse + 0.3)
            await c.heartbeat_all()

            report = await c.master.autopilot.run_cycle()
            planned = report["planned"]
            assert planned, report
            assert all(a["kind"] == "rebuild_shard" for a in planned)
            covered = sorted(s for a in planned for s in a["shards"])
            assert covered == lost
            # executed ledger rides the same cycle report, in order
            assert [r["action"] for r in report["executed"]] == planned
            assert all(r["status"] == "ok"
                       for r in report["executed"]), report["executed"]

            await c.heartbeat_all()
            async with CommandEnv(c.master.url, c.http) as env:
                smap = await ec.ec_shard_map(env)
            assert len(smap[vid]["shards"]) == gf.TOTAL_SHARDS
            # rebuilt shards live on surviving nodes, never the victim
            for sid in lost:
                assert victim_url not in smap[vid]["shards"][sid]
            for fid, url, data in files[:8]:
                server = next(s for s in c.servers
                              if s.url != victim_url)
                st, got = await c.get(fid, server.url)
                assert st == 200 and got == data, fid

            # convergence: the NEXT cycle observes a whole cluster and
            # plans nothing (modulo cooldown, which also plans nothing)
            report2 = await c.master.autopilot.run_cycle()
            assert report2["planned"] == [], report2["planned"]
    run(body())


def test_heal_rotten_shard_localized_by_scrub(tmp_path):
    """Plant real on-disk rot in one parity shard; a scrub cycle must
    LOCALIZE it (reported_windows carries the shard id), and the next
    autopilot cycle must rebuild that shard in place — after which a
    fresh scrub reports the volume clean."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=3) as c:
            files, vids = await _encode_one_volume(c, n_files=20)
            vid = vids[0]
            # find the holder of parity shard 12 and flip a byte
            import seaweedfs_tpu_torch.ec.pipeline as pl
            holder = next(v for v in c.servers
                          if 12 in v.store.ec_volumes.get(
                              vid, type("e", (), {"shards": {}})()).shards)
            path = holder._base_name(vid, "ap") + pl.to_ext(12)

            def flip():
                with open(path, "r+b") as f:
                    f.seek(100)
                    b = f.read(1)
                    f.seek(100)
                    f.write(bytes([b[0] ^ 0xFF]))
            await asyncio.get_running_loop().run_in_executor(None, flip)

            # scrub runs on the shard-0 holder (ownership rule)
            owner = next(v for v in c.servers
                         if 0 in v.store.ec_volumes[vid].shards)
            rep = await owner.scrubber.run_cycle()
            assert rep["corrupt"] >= 1, rep
            rows = [w for w in rep["corrupt_windows"]
                    if w["volume"] == vid]
            assert rows and rows[0]["shards"] == [12], rows
            st = owner.scrubber.status()
            assert st["reported_windows"], "structured ring empty"
            for key in ("volume", "window", "offset", "size",
                        "shards", "wall"):
                assert key in st["reported_windows"][0], key

            report = await c.master.autopilot.run_cycle()
            acts = [a for a in report["planned"]
                    if a["kind"] == "rebuild_shard" and a["vid"] == vid]
            assert acts and acts[0]["shards"] == [12], report["planned"]
            assert acts[0]["target"] == holder.url  # in-place repair
            assert all(r["status"] == "ok"
                       for r in report["executed"]), report["executed"]

            rep2 = await owner.scrubber.run_cycle()
            mine = [w for w in rep2["corrupt_windows"]
                    if w["volume"] == vid]
            assert not mine, rep2
            for fid, url, data in files[:5]:
                st_, got = await c.get(fid, url)
                assert st_ == 200 and got == data, fid
    run(body())


def test_debug_autopilot_surface(tmp_path):
    """GET /debug/autopilot schema + POST ?run=1 forced dry-run cycle."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            c.master.autopilot.dryrun = True
            c.master.autopilot.executor.dryrun = True
            async with c.http.get(
                    f"http://{c.master.url}/debug/autopilot") as r:
                body_ = await r.json()
                assert r.status == 200
            ap = body_["autopilot"]
            for key in ("enabled", "leader", "dryrun", "state",
                        "cycles", "budget_mbps", "actions_ok",
                        "in_flight", "history", "last_cycle"):
                assert key in ap, key
            assert ap["enabled"] is False     # loop off by default
            async with c.http.post(
                    f"http://{c.master.url}/debug/autopilot",
                    params={"run": "1"}) as r:
                forced = await r.json()
                assert r.status == 200, forced
            for key in ("planned", "deferred", "executed", "observed",
                        "dryrun"):
                assert key in forced["cycle"], key
            assert forced["status"]["cycles"] == 1
    run(body())


def test_rebuild_shard_failed_gather_keeps_rotten_copy(tmp_path):
    """Review regression: /admin/ec/rebuild_shard must confirm k clean
    inputs on local disk BEFORE destroying a local (rotten) copy of a
    requested shard — a failed gather answers 409 with the
    mostly-good shard still mounted and its file intact, never
    converting one corrupt window into a lost shard."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=3) as c:
            _files, vids = await _encode_one_volume(c, n_files=15)
            vid = vids[0]
            holder = c.servers[0]
            local = sorted(holder.store.ec_volumes[vid].shards)
            assert len(local) < gf.DATA_SHARDS  # spread over 3 nodes
            sid = local[0]
            import seaweedfs_tpu_torch.ec.pipeline as pl
            path = holder._base_name(vid, "ap") + pl.to_ext(sid)
            # every remote source is unreachable: the gather cannot
            # reach k inputs (local survivors alone are < 10)
            sources = ",".join(
                f"{s}:127.0.0.1:1" for s in range(gf.TOTAL_SHARDS)
                if s != sid)
            async with c.http.post(
                    f"http://{holder.url}/admin/ec/rebuild_shard",
                    params={"volume": str(vid), "collection": "ap",
                            "shards": str(sid),
                            "sources": sources}) as resp:
                body_ = await resp.json()
                assert resp.status == 409, body_
            assert sid in holder.store.ec_volumes[vid].shards
            assert os.path.exists(path)
    run(body())


def test_no_holder_map_triggers_rate_bounded_reresolve(tmp_path):
    """Heal-soak regression: a shard-location map cached while a shard
    had NO holders (the outage window) used to be served for the full
    7-minute TTL with no invalidation — hiding the shard the autopilot
    had long since re-hosted. A fetch that finds no listed holder must
    now schedule the (rate-bounded) re-resolve, single and batched."""
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            calls = []

            class StubLocations:
                def get(self, vid):
                    return {"1": ["somewhere:1"]}   # nothing for sid 0

                def invalidate(self, vid):
                    calls.append(vid)

            vs._ec_locations = StubLocations()
            loop = asyncio.get_running_loop()
            out = await loop.run_in_executor(
                None, vs._sync_fetch_remote_shard, 9, 0, 0, 1)
            assert out is None
            assert calls == [9]
            out = await loop.run_in_executor(
                None, vs._sync_fetch_remote_shard_batch, 9, [(0, 0, 1)])
            assert out is None
            assert calls == [9, 9]
    run(body())


def test_unknown_action_kind_errors():
    async def body():
        async def ok(url, path, params, timeout_s=60.0):
            return {"ok": True}
        ex = Executor(ok, mbps=0)
        [res] = await ex.execute([Action(kind="nope", vid=1)])
        assert res["status"] == "error"
    run(body())


# ---------------------------------------------------------------------------
# parity: the port's planner against the JAX package's
# ---------------------------------------------------------------------------


def _as_ref(snap: ClusterSnapshot):
    """The same snapshot built from the JAX package's dataclasses."""
    from dataclasses import asdict
    ref = importlib.import_module("seaweedfs_tpu.autopilot.plan")
    return ref.ClusterSnapshot(
        nodes=tuple(ref.NodeState(**asdict(n)) for n in snap.nodes),
        volumes=tuple(ref.VolumeState(**asdict(v)) for v in snap.volumes),
        ec_volumes=tuple(ref.EcVolumeState(**asdict(e))
                         for e in snap.ec_volumes),
        corruptions=tuple(ref.CorruptionReport(**asdict(c))
                          for c in snap.corruptions),
        volume_size_limit=snap.volume_size_limit, paging=snap.paging)


@pytest.mark.parametrize("tier", ["", "mmap.hot"])
def test_plan_equals_the_reference_planner(tier):
    """plan() on the same ClusterSnapshots gives the same actions and
    deferrals, in the same order, as the JAX package's planner (exact,
    over 60 randomized cluster states and two configurations). One
    field differs by design: a port rebuild's bytes_est counts the k
    inputs and the up to gf.REBUILD_CHECK_ROWS more that the target
    gathers to check them, where the reference counts k."""
    ref = importlib.import_module("seaweedfs_tpu.autopilot.plan")
    cfg = PlannerConfig(tier_backend=tier, max_actions=16)
    ref_cfg = ref.PlannerConfig(tier_backend=tier, max_actions=16)
    n_actions = 0
    for seed in range(60):
        snap = _random_snapshot(random.Random(seed))
        actions, deferrals = plan(snap, cfg)
        want_a, want_d = ref.plan(_as_ref(snap), ref_cfg)
        want_rows = [a.to_dict() for a in want_a]
        for row in want_rows:
            if row["kind"] == "rebuild_shard":
                gathered = min(len(row["sources"]),
                               gf.DATA_SHARDS + gf.REBUILD_CHECK_ROWS)
                row["bytes_est"] = \
                    row["bytes_est"] // gf.DATA_SHARDS * gathered
        assert [a.to_dict() for a in actions] == want_rows, seed
        assert [d.to_dict() for d in deferrals] == \
            [d.to_dict() for d in want_d], seed
        n_actions += len(actions)
    assert n_actions > 0
