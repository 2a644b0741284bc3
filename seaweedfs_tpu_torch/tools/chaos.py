"""Failpoint-driven chaos soak: prove the resilience layer end to end.

Two scenarios:

``soak`` (default) boots a real CLI cluster (master + volume fleet on
private ports), arms failpoints over the live /debug/failpoints admin
endpoint (5% injected read/write errors, latency spikes, mid-body
truncations, replication fan-out faults), runs a mixed
write/read/delete workload, SIGKILLs one volume server mid-run, and
then asserts the two invariants that define user-visible durability
and availability:

  1. ZERO acknowledged-write loss — every fid whose upload was ACKed
     (and not deliberately deleted) reads back byte-identical at the
     end, through location failover past the killed server.
  2. BOUNDED client-observed error rate — retries + breakers must
     absorb the injected 5% fault rate; the workload's post-retry
     error rate must stay under --error-bound.

``ha`` is the multi-master quorum proof: 3 masters (raft ``-peers``,
fast election timings) + 2 volume servers under sustained
assign+write load; the LEADER is SIGKILLed mid-assign (twice in the
full run, with a respawn between), and a 5-way partition window is
armed through the raft failpoints (``master.vote`` / ``master.append``
/ ``master.snapshot`` = drop on the leader, flaky drops on the other
masters and the volume heartbeats) — processes alive, network lying.
Asserted across the ENTIRE run:

  1. ZERO lost acked writes (final byte-identical read-back);
  2. ZERO duplicate fids — every assign ever answered, including those
     whose upload then failed, is parsed to (vid, key) and checked
     globally unique (a deposed leader may drain its committed
     reservation window; a successor can never re-issue from it);
  3. failover completes within 2 election timeouts of each kill,
     cross-checked against the ``raft_leader_change`` journal rows on
     the survivors (`/debug/events`) and `/debug/health` reachability;
  4. the autopilot stays PARKED on every follower (no action ever
     executed from a non-leader).

Run as `python -m seaweedfs_tpu_torch.tools.chaos [ha] [--quick]`:

    chaos               # full soak (~60s of load)
    chaos --quick       # CI smoke (~10s of load)
    chaos ha            # full quorum chaos (~50s)
    chaos ha --quick    # CI smoke: one leader kill

Exit code 0 only when every invariant holds.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import signal
import sys
import tempfile
import time
import urllib.request

from . import procutil

Procs = procutil.Procs
wait_assign = procutil.wait_assign

BASE_PORT = 23400

# what gets armed on every volume server (spec grammar:
# action[=arg][:count][@probability] — util/failpoints.py)
VOLUME_FAILPOINTS = {
    "store.read": "error@0.04",
    "store.write": "error@0.04",
    "volume.read.http": "truncate=0.5@0.25",
    "volume.replicate": "error@0.03",
}
VOLUME_LATENCY = {"store.read": "latency=80@0.05"}  # alternate arming
MASTER_FAILPOINTS = {"master.assign": "latency=50@0.05"}


def http_json(url: str, method: str = "GET",
              timeout: float = 5.0) -> dict:
    req = urllib.request.Request(url, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def arm(addr: str, specs: dict[str, str], path="/debug/failpoints") -> None:
    for site, spec in specs.items():
        out = http_json(f"http://{addr}{path}?site={site}&spec={spec}",
                        method="POST")
        assert any(a["site"] == site for a in out.get("armed", [])), out


class Stats:
    def __init__(self):
        self.writes_ok = 0
        self.writes_err = 0
        self.reads_ok = 0
        self.reads_err = 0
        self.deletes = 0

    @property
    def ops(self) -> int:
        return self.writes_ok + self.writes_err + \
            self.reads_ok + self.reads_err

    @property
    def errors(self) -> int:
        return self.writes_err + self.reads_err

    def to_dict(self) -> dict:
        rate = self.errors / self.ops if self.ops else 0.0
        return {"writes_ok": self.writes_ok, "writes_err": self.writes_err,
                "reads_ok": self.reads_ok, "reads_err": self.reads_err,
                "deletes": self.deletes,
                "client_error_rate": round(rate, 4)}


async def workload(master: str, duration: float, concurrency: int,
                   stats: Stats, acked: dict, deleted: set,
                   rng: random.Random, kill_at: float,
                   kill_fn) -> None:
    from seaweedfs_tpu_torch.util.client import OperationError, WeedClient
    stop_at = time.monotonic() + duration
    killed = False
    lock = asyncio.Lock()

    async with WeedClient(master) as c:
        async def worker(wid: int) -> None:
            nonlocal killed
            while time.monotonic() < stop_at:
                roll = rng.random()
                try:
                    if roll < 0.45 or not acked:
                        data = rng.randbytes(rng.randint(400, 24000))
                        fid = await c.upload_data(data,
                                                  replication="001")
                        async with lock:
                            acked[fid] = data
                            stats.writes_ok += 1
                    elif roll < 0.9:
                        fid = rng.choice(list(acked))
                        want = acked.get(fid)
                        try:
                            got = await c.read(fid)
                        except OperationError:
                            if fid in deleted:
                                continue   # raced a deleter: benign
                            raise
                        # re-check: a deleter may have tombstoned it
                        # between our pick and the read completing
                        if fid in deleted:
                            continue
                        if want is not None and got != want:
                            raise OperationError(
                                f"payload mismatch {fid}: "
                                f"{len(got)} vs {len(want)}")
                        stats.reads_ok += 1
                    else:
                        fid = rng.choice(list(acked))
                        async with lock:
                            if fid not in acked:
                                continue
                            del acked[fid]
                            deleted.add(fid)
                        await c.delete_fids([fid])
                        stats.deletes += 1
                except Exception as e:  # noqa: BLE001 — every failure counts
                    if roll < 0.45:
                        stats.writes_err += 1
                    else:
                        stats.reads_err += 1
                    if stats.errors <= 5:
                        print(f"  [w{wid}] op error: "
                              f"{type(e).__name__} {str(e)[:120]}")
                await asyncio.sleep(0)

        async def killer() -> None:
            nonlocal killed
            await asyncio.sleep(kill_at)
            kill_fn()
            killed = True

        await asyncio.gather(killer(),
                             *(worker(i) for i in range(concurrency)))


async def final_verify(master: str, acked: dict) -> list[str]:
    """Every acknowledged, undeleted write must read back byte-identical
    — through failover, with a patient fresh client."""
    from seaweedfs_tpu_torch.util.client import WeedClient
    from seaweedfs_tpu_torch.util.resilience import RetryPolicy
    lost: list[str] = []
    sem = asyncio.Semaphore(16)
    async with WeedClient(master, retry=RetryPolicy(
            max_attempts=6, base_delay=0.2, total_timeout=60)) as c:

        async def check(fid: str, want: bytes) -> None:
            async with sem:
                for attempt in range(4):
                    try:
                        got = await c.read(fid)
                        if got == want:
                            return
                        lost.append(f"{fid}: MISMATCH {len(got)} vs "
                                    f"{len(want)}")
                        return
                    except Exception as e:  # noqa: BLE001
                        if attempt == 3:
                            lost.append(f"{fid}: {type(e).__name__} "
                                        f"{str(e)[:100]}")
                            return
                        await asyncio.sleep(0.5 * (attempt + 1))

        await asyncio.gather(*(check(f, w) for f, w in acked.items()))
    return lost


async def run(args) -> int:
    tmp = tempfile.mkdtemp(prefix="chaos_")
    procs = Procs(tmp)
    n_servers = 3
    rng = random.Random(args.seed)
    report: dict = {"mode": "quick" if args.quick else "soak"}
    try:
        master = f"127.0.0.1:{BASE_PORT}"
        await procs.spawn("master", "-port", str(BASE_PORT),
                    "-mdir", os.path.join(tmp, "m"),
                    "-volumeSizeLimitMB", "8", "-pulseSeconds", "1",
                    "-defaultReplication", "001")
        await asyncio.sleep(2)
        for i in range(n_servers):
            # --slo arms a real objective on every server: without one
            # the engine is empty and /debug/health answers a
            # structurally-ok stub no matter how much damage the
            # failpoints do, which would make the recorder report a lie
            slo_flags = (("-slo", "volume.read:p99<250ms@99")
                         if args.slo else ())
            await procs.spawn("volume", "-port", str(BASE_PORT + 1 + i),
                        "-dir", os.path.join(tmp, f"v{i}"),
                        "-max", "20", "-master", master,
                        "-pulseSeconds", "1", *slo_flags)
        await wait_assign(master, "replication=001", tries=45)

        # runtime arming over the live admin endpoint (this also IS the
        # endpoint's integration test)
        arm(master, MASTER_FAILPOINTS)
        for i in range(n_servers):
            addr = f"127.0.0.1:{BASE_PORT + 1 + i}"
            arm(addr, VOLUME_FAILPOINTS)
        # one server additionally gets latency spikes
        arm(f"127.0.0.1:{BASE_PORT + 1}", VOLUME_LATENCY)
        print(f"armed failpoints on master + {n_servers} volume servers")

        stats = Stats()
        acked: dict = {}
        deleted: set = set()
        duration = 10.0 if args.quick else 60.0
        kill_at = duration * 0.5
        victim = procs.procs[1 + n_servers - 1]   # last volume server

        def kill_victim() -> None:
            print(f"  SIGKILL volume server pid {victim.pid} "
                  f"(port {BASE_PORT + n_servers})")
            victim.send_signal(signal.SIGKILL)

        t0 = time.monotonic()
        await workload(master, duration, args.concurrency, stats,
                       acked, deleted, rng, kill_at, kill_victim)
        elapsed = time.monotonic() - t0

        report["stats"] = stats.to_dict()
        report["acked"] = len(acked)
        report["deleted"] = len(deleted)
        report["elapsed_s"] = round(elapsed, 1)
        print(f"workload done in {elapsed:.1f}s: {report['stats']}")
        if stats.writes_ok < (10 if args.quick else 100):
            print("FAIL: workload acked too few writes to prove anything")
            report["verdict"] = "FAIL(too few writes)"
            return 1

        # collect fired-failpoint + breaker evidence from survivors
        fired = {}
        for i in range(n_servers - 1):
            addr = f"127.0.0.1:{BASE_PORT + 1 + i}"
            try:
                for a in http_json(
                        f"http://{addr}/debug/failpoints")["failpoints"]:
                    fired[a["site"]] = fired.get(a["site"], 0) + a["hits"]
            except OSError:
                pass
        report["failpoint_hits"] = fired
        print(f"failpoint hits (surviving servers): {fired}")

        if args.trace:
            # per-tier latency breakdown from the survivors' span
            # rings: under injected faults this is where the retry /
            # failover time shows up as client-tier self time. ONE
            # fetch round — table and JSON report must describe the
            # same ring snapshot
            from . import trace_table
            addrs = [f"127.0.0.1:{BASE_PORT + 1 + i}"
                     for i in range(n_servers - 1)]
            rows = trace_table.rows_from_payloads(
                [p for p in (trace_table.fetch(a) for a in addrs) if p])
            print("--- per-tier trace breakdown (survivors) ---")
            print(trace_table.render(rows))
            report["trace_breakdown"] = rows
        if args.slo:
            # flight-recorder pull from the survivors: one forced
            # timeline window covering the run, the merged journal, and
            # the health verdict — the chaos report carries what the
            # cluster SAW, not just what this tool measured
            recorder = {}
            for i in range(n_servers - 1):
                addr = f"127.0.0.1:{BASE_PORT + 1 + i}"
                try:
                    http_json(f"http://{addr}/debug/timeline?snap=1",
                              method="POST")
                    h = http_json(f"http://{addr}/debug/health")
                    ev = http_json(f"http://{addr}/debug/events?n=50")
                    recorder[addr] = {
                        "health": h["status"],
                        "objectives": h.get("objectives", []),
                        "event_types": sorted(
                            {e["type"] for e in ev["events"]})}
                except (OSError, ValueError, KeyError):
                    continue
            report["recorder"] = recorder
            for addr, rec in recorder.items():
                print(f"recorder {addr}: health={rec['health']} "
                      f"events={rec['event_types']}")
        if not args.quick and not any(fired.values()):
            print("FAIL: no failpoint ever fired — the chaos run "
                  "tested nothing")
            report["verdict"] = "FAIL(no faults injected)"
            return 1

        # invariant 1: zero acknowledged-write loss
        lost = await final_verify(master, acked)
        report["lost"] = len(lost)
        for line in lost[:10]:
            print("  LOST:", line)

        # invariant 2: bounded client-observed error rate
        rate = report["stats"]["client_error_rate"]
        ok = not lost and rate <= args.error_bound
        report["verdict"] = "PASS" if ok else "FAIL"
        print(f"acked={len(acked)} lost={len(lost)} "
              f"err_rate={rate:.3f} (bound {args.error_bound}) "
              f"-> {report['verdict']}")
        return 0 if ok else 1
    finally:
        procs.kill_all()

        def teardown() -> None:
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(report, f, indent=2)
            if not args.keep:
                import shutil
                shutil.rmtree(tmp, ignore_errors=True)

        # teardown I/O off the loop: pending client tasks may still be
        # draining their cancellations on it
        from seaweedfs_tpu_torch.util import tracing
        await tracing.run_in_executor(teardown)
        if args.keep:
            print("logs under", tmp)


# ---------------------------------------------------------------------------
# ha: multi-master quorum chaos (leader SIGKILLs + partition window)
# ---------------------------------------------------------------------------

HA_PORT = 23500
HA_TIMEOUT = (0.5, 1.0)          # -raft.timeout armed on every master
HA_PULSE = 0.1                   # -raft.pulse


def cluster_status(addr: str) -> dict:
    return http_json(f"http://{addr}/cluster/status", timeout=3)


async def _wait_ha_leader(masters: list[str], exclude: str = "",
                          timeout: float = 30.0) -> tuple[str, float]:
    """Poll the fleet until one live master claims leadership (not
    `exclude`); returns (leader, seconds waited)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        for m in masters:
            try:
                st = await asyncio.to_thread(cluster_status, m)
            except OSError:
                continue
            if st.get("isLeader") and st["leader"] != exclude:
                return st["leader"], time.monotonic() - t0
        await asyncio.sleep(0.05)
    raise RuntimeError(f"no leader elected within {timeout}s")


async def run_ha(args) -> int:
    from seaweedfs_tpu_torch.storage.types import FileId
    from seaweedfs_tpu_torch.util.client import WeedClient
    from seaweedfs_tpu_torch.util.resilience import RetryPolicy

    tmp = tempfile.mkdtemp(prefix="chaos_ha_")
    procs = Procs(tmp)
    rng = random.Random(args.seed)
    masters = [f"127.0.0.1:{HA_PORT + i}" for i in range(3)]
    vols = [f"127.0.0.1:{HA_PORT + 10 + i}" for i in range(2)]
    report: dict = {"mode": "ha-quick" if args.quick else "ha",
                    "failovers": [], "kills": 0}
    margin = 0.5                  # poll granularity + heartbeat slack
    bound = 2 * HA_TIMEOUT[1] + margin

    def master_args(i: int) -> tuple:
        return ("master", "-port", str(HA_PORT + i),
                "-mdir", os.path.join(tmp, f"m{i}"),
                "-peers", ",".join(masters),
                "-raft.timeout", f"{HA_TIMEOUT[0]},{HA_TIMEOUT[1]}",
                "-raft.pulse", str(HA_PULSE),
                "-volumeSizeLimitMB", "8", "-pulseSeconds", "0.5",
                "-defaultReplication", "001",
                # dry-run autopilot on every master: the run asserts it
                # only ever cycles on the leader
                "-autopilot.interval", "1", "-autopilot.dryrun")

    try:
        mprocs = {}
        for i in range(3):
            mprocs[i] = await procs.spawn(*master_args(i))
        await asyncio.sleep(2.5)       # first election
        for i, v in enumerate(vols):
            await procs.spawn("volume", "-port", str(HA_PORT + 10 + i),
                              "-dir", os.path.join(tmp, f"v{i}"),
                              "-max", "20",
                              "-master", ",".join(masters),
                              "-pulseSeconds", "0.5")
        await wait_assign(masters[0], "replication=001", tries=45)

        stats = Stats()
        issued: list[str] = []         # EVERY fid any assign answered
        acked: dict = {}
        stop = asyncio.Event()
        lock = asyncio.Lock()

        async with WeedClient(",".join(masters)) as c:
            async def writer(wid: int) -> None:
                while not stop.is_set():
                    data = rng.randbytes(rng.randint(400, 16000))
                    try:
                        a = await c.assign(replication="001")
                        async with lock:
                            issued.append(a["fid"])
                        await c.upload(a["fid"], a["url"], data,
                                       auth=a.get("auth", ""))
                        async with lock:
                            acked[a["fid"]] = data
                            stats.writes_ok += 1
                    except Exception as e:  # noqa: BLE001 — counted
                        stats.writes_err += 1
                        if stats.writes_err <= 5:
                            print(f"  [w{wid}] write error: "
                                  f"{type(e).__name__} {str(e)[:100]}")
                        await asyncio.sleep(0.1)
                    await asyncio.sleep(0)

            writers = [asyncio.create_task(writer(i))
                       for i in range(args.concurrency)]

            async def kill_leader(round_no: int) -> str:
                leader, _ = await _wait_ha_leader(
                    [m for i, m in enumerate(masters)
                     if mprocs[i].poll() is None])
                li = masters.index(leader)
                print(f"  SIGKILL leader #{round_no} master{li} "
                      f"({leader}) mid-assign")
                mprocs[li].send_signal(signal.SIGKILL)
                report["kills"] += 1
                new_leader, waited = await _wait_ha_leader(
                    [m for m in masters if m != leader],
                    exclude=leader)
                print(f"  new leader {new_leader} after {waited:.2f}s "
                      f"(bound {bound:.1f}s)")
                report["failovers"].append(
                    {"killed": leader, "leader": new_leader,
                     "seconds": round(waited, 2)})
                return new_leader

            await asyncio.sleep(3)                 # load before chaos
            new_leader = await kill_leader(1)

            if not args.quick:
                # respawn the victim (same -mdir: durable raft state)
                # so the quorum is back to 3/3 before the second kill
                dead = masters.index(report["failovers"][0]["killed"])
                mprocs[dead] = await procs.spawn(*master_args(dead))
                await asyncio.sleep(3)

                # ---- 5-way partition window: every process keeps
                # running, the network starts lying. The leader drops
                # ALL outbound raft RPCs (lease expiry forces a step
                # down + re-election); the other masters and both
                # volume heartbeats get flaky drops.
                leader = new_leader
                part = {"master.vote": "drop:*", "master.append":
                        "drop:*", "master.snapshot": "drop:*"}
                arm(leader, part)
                for m in masters:
                    if m != leader and \
                            mprocs[masters.index(m)].poll() is None:
                        arm(m, {"master.append": "drop@0.3"})
                for v in vols:
                    arm(v, {"volume.heartbeat": "drop@0.5"})
                print(f"  5-way partition window armed "
                      f"(leader {leader} fully cut outbound)")
                t_cut = time.time()
                successor, waited = await _wait_ha_leader(
                    [m for m in masters if m != leader],
                    exclude=leader, timeout=20)
                print(f"  partition: successor {successor} after "
                      f"{waited:.2f}s")
                await asyncio.sleep(2)
                for node in masters + vols:
                    try:
                        http_json(f"http://{node}/debug/failpoints",
                                  method="DELETE")
                    except OSError:
                        pass
                report["partition"] = {
                    "cut_leader": leader, "successor": successor,
                    "window_s": round(time.time() - t_cut, 1),
                    "elected_in_s": round(waited, 2)}
                await asyncio.sleep(2)             # heal + re-home

                await kill_leader(2)

            await asyncio.sleep(3)                 # post-chaos load
            stop.set()
            await asyncio.gather(*writers, return_exceptions=True)

        alive = [m for i, m in enumerate(masters)
                 if mprocs[i].poll() is None]
        final_leader, _ = await _wait_ha_leader(alive)

        # ---- invariant 3: failover bound + journal/health evidence
        ok = True
        for f in report["failovers"]:
            if f["seconds"] > bound:
                print(f"  FAIL: failover after killing {f['killed']} "
                      f"took {f['seconds']}s > {bound:.1f}s")
                ok = False
        changes, step_downs = [], []
        for m in alive:
            try:
                ev = http_json(f"http://{m}/debug/events?n=500"
                               f"&type=raft_leader_change,raft_step_down")
                for row in ev["events"]:
                    (changes if row["type"] == "raft_leader_change"
                     else step_downs).append(row)
            except OSError:
                pass
        leaders_seen = {r.get("leader") for r in changes}
        report["journal"] = {
            "leader_changes": len(changes),
            "step_downs": len(step_downs),
            "leaders_seen": sorted(x for x in leaders_seen if x)}
        print(f"  journal: {len(changes)} raft_leader_change rows "
              f"({len(leaders_seen)} leaders), "
              f"{len(step_downs)} raft_step_down")
        for f in report["failovers"]:
            if f["leader"] not in leaders_seen:
                print(f"  FAIL: no raft_leader_change journal row for "
                      f"elected leader {f['leader']}")
                ok = False
        if not args.quick and not step_downs:
            print("  FAIL: partition window never journaled a "
                  "raft_step_down on the cut leader")
            ok = False
        health = http_json(f"http://{final_leader}/debug/health")
        report["final_leader"] = {"url": final_leader,
                                  "health": health.get("status", "?")}

        # ---- invariant 4: autopilot parked on every follower
        for m in alive:
            try:
                ap = http_json(
                    f"http://{m}/debug/autopilot")["autopilot"]
            except OSError:
                continue
            if m != final_leader:
                executed = ap["actions_ok"] + ap["actions_failed"]
                if ap["leader"] or ap["in_flight"] or executed:
                    print(f"  FAIL: follower {m} autopilot not parked: "
                          f"leader={ap['leader']} "
                          f"in_flight={ap['in_flight']} "
                          f"executed={executed}")
                    ok = False
        print(f"  autopilot parked on "
              f"{len(alive) - 1} followers (leader {final_leader})")

        # ---- invariant 2: ZERO duplicate fids across the whole run
        keys: dict = {}
        dups = []
        for fid in issued:
            k = None
            try:
                f = FileId.parse(fid)
                k = (f.volume_id, f.key)
            except ValueError:
                dups.append(f"unparseable fid {fid!r}")
                continue
            if k in keys:
                dups.append(f"duplicate (vid,key) {k}: "
                            f"{keys[k]!r} vs {fid!r}")
            keys[k] = fid
        report["issued"] = len(issued)
        report["duplicates"] = len(dups)
        for line in dups[:10]:
            print("  DUP:", line)

        # ---- invariant 1: ZERO lost acked writes
        async def patient_verify() -> list[str]:
            lost: list[str] = []
            sem = asyncio.Semaphore(16)
            async with WeedClient(",".join(alive),
                                  retry=RetryPolicy(
                                      max_attempts=6, base_delay=0.2,
                                      total_timeout=60)) as vc:
                async def check(fid: str, want: bytes) -> None:
                    async with sem:
                        for attempt in range(4):
                            try:
                                got = await vc.read(fid)
                                if got != want:
                                    lost.append(
                                        f"{fid}: MISMATCH {len(got)} "
                                        f"vs {len(want)}")
                                return
                            except Exception as e:  # noqa: BLE001
                                if attempt == 3:
                                    lost.append(
                                        f"{fid}: {type(e).__name__} "
                                        f"{str(e)[:80]}")
                                    return
                                await asyncio.sleep(0.5 * (attempt + 1))
                await asyncio.gather(*(check(f, w)
                                       for f, w in acked.items()))
            return lost
        lost = await patient_verify()
        report["stats"] = stats.to_dict()
        report["acked"] = len(acked)
        report["lost"] = len(lost)
        for line in lost[:10]:
            print("  LOST:", line)

        min_writes = 20 if args.quick else 100
        if stats.writes_ok < min_writes:
            print(f"FAIL: only {stats.writes_ok} acked writes — too "
                  f"few to prove anything")
            ok = False
        ok = ok and not lost and not dups
        report["verdict"] = "PASS" if ok else "FAIL"
        print(f"ha: issued={len(issued)} acked={len(acked)} "
              f"lost={len(lost)} dups={len(dups)} kills="
              f"{report['kills']} failovers="
              f"{[f['seconds'] for f in report['failovers']]}s "
              f"-> {report['verdict']}")
        return 0 if ok else 1
    finally:
        procs.kill_all()

        def teardown() -> None:
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(report, f, indent=2)
            if not args.keep:
                import shutil
                shutil.rmtree(tmp, ignore_errors=True)
        from seaweedfs_tpu_torch.util import tracing
        await tracing.run_in_executor(teardown)
        if args.keep:
            print("logs under", tmp)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scenario", nargs="?", default="soak",
                    choices=("soak", "ha"),
                    help="soak = data-plane chaos (default); "
                         "ha = multi-master quorum chaos")
    ap.add_argument("--quick", action="store_true",
                    help="~10s CI smoke instead of the full soak")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--error-bound", type=float, default=0.20,
                    help="max post-retry client error rate")
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--trace", action="store_true",
                    help="pull /debug/traces from the surviving volume "
                         "servers and print the per-tier latency "
                         "breakdown table")
    ap.add_argument("--slo", action="store_true",
                    help="pull the flight recorder (/debug/timeline + "
                         "/debug/events + /debug/health) from the "
                         "surviving volume servers into the report")
    ap.add_argument("--json", help="write the report to this path")
    ap.add_argument("--keep", action="store_true",
                    help="keep tmpdir + server logs")
    args = ap.parse_args()
    if args.scenario == "ha":
        return asyncio.run(run_ha(args))
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
