"""Cross-feature chaos soaks against a real CLI cluster.

These are the scenarios that found the JAX package's post-ec.encode
stale-registry bug (ROUND4.md "Session-2 soak results") — kept runnable
so regressions in the distributed plane surface again. Each scenario
starts its own master/volume processes on private ports, drives load
over real sockets, and byte-verifies every surviving file at the end.

Run one scenario (or `all`) as `python -m seaweedfs_tpu_torch.tools.soak
<scenario> [--quick]`; the daemons are the port's CLI, and
SWTPU_TORCH_EC_BACKEND=cpu in the caller's environment puts their EC
engine on the CPU (else the GPU):

    soak ec          # write/delete/vacuum/ec.encode/verify
    soak vacuum-race # writers+deletes racing vacuum rounds
    soak rebuild     # encode, SIGKILL a shard holder, rebuild
    soak failover    # SIGKILL the leader master under load
    soak partition   # cut the leader's raft links (alive)
    soak workers     # -workers 2 fleet: writes under worker
                     # SIGKILLs, byte-verify via shared port
    soak cache-churn # read-your-writes under cache churn:
                     # zipf reads racing overwrites/deletes
                     # with failpoints armed, every read
                     # byte-verified (zero stale tolerated)
    soak scrub       # paced parity scrubber vs planted
                     # bit-rot (real on-disk + scrub.read
                     # flip failpoint): every corruption
                     # reported, zero foreground read
                     # errors, byte budget held
    soak heal        # autopilot acceptance: rot
                     # planted in two EC volumes + one
                     # shard holder SIGKILLed mid-soak
                     # must converge back to full
                     # declared redundancy (scrub
                     # clean, shards re-hosted) with
                     # ZERO operator intervention,
                     # zero foreground read errors,
                     # and the -autopilot.mbps repair
                     # budget held (--quick: smaller
                     # fill, the short smoke)
    soak slo         # flight-recorder acceptance: a
                     # latency failpoint drives
                     # /debug/health ok -> page with the
                     # violating timeline slice + a
                     # correlated journal event in the
                     # evidence; disarmed phase stays ok
    soak qos         # multi-tenant QoS acceptance: an
                     # abusive S3 tenant at full
                     # throttle vs a paying tenant with
                     # an armed per-tenant -slo — the
                     # paying objective must hold, all
                     # throttle/shed decisions must land
                     # on the abuser's class, and every
                     # acked write must read back
                     # byte-identical (--quick: the
                     # short smoke)
    soak meta        # sharded filer metadata plane:
                     # >=3x op-accounted QPS at 4
                     # shards, an online split under
                     # armed filer.shard.* failpoints
                     # + a SIGKILL of the source filer
                     # (the journaled move must
                     # replay), a cross-shard rename
                     # storm with kills — the final
                     # paged enumeration must hold
                     # every entry exactly once
                     # (--quick: the short smoke)
    soak all


Exit code 0 only when every read verifies.
"""

from __future__ import annotations

import asyncio
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from . import procutil

REPO = procutil.REPO

BASE_PORT = 21500


class Procs(procutil.Procs):
    def shell(self, master: str, cmd: str) -> str:
        # timeout: a shell command wedged on a dead server must fail
        # the scenario, not hang the soak forever
        out = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "shell",
             "-master", master, "-c", cmd],
            capture_output=True, text=True, env=self.env, cwd=REPO,
            timeout=180)
        return out.stdout + out.stderr


wait_assign = procutil.wait_assign


async def fill(client, payloads: dict, n: int, rng,
               replication: str = "001") -> None:
    sem = asyncio.Semaphore(24)

    async def put(i):
        data = rng.randbytes(rng.randint(500, 30000))
        async with sem:
            fid = await client.upload_data(data, replication=replication)
        payloads[fid] = data

    await asyncio.gather(*(put(i) for i in range(n)))


async def verify(client, payloads: dict, tag: str) -> int:
    sem = asyncio.Semaphore(24)
    bad = []

    async def check(fid, want):
        async with sem:
            try:
                got = await client.read(fid)
            except Exception as e:  # noqa: BLE001 — every failure counts
                bad.append((fid, f"ERR {type(e).__name__} "
                                 f"{str(e)[:80]}"))
                return
        if got != want:
            bad.append((fid, f"MISMATCH {len(got)} vs {len(want)}"))

    await asyncio.gather(*(check(f, w) for f, w in payloads.items()))
    print(f"  {tag}: bad={len(bad)}/{len(payloads)}")
    for fid, why in bad[:5]:
        print("   ", fid, why)
    return len(bad)


async def cluster(procs: Procs, port0: int, n_servers: int,
            master_args: tuple[str, ...] = ()) -> str:
    master = f"127.0.0.1:{port0}"
    await procs.spawn("master", "-port", str(port0),
                "-mdir", os.path.join(procs.tmp, "m"),
                "-volumeSizeLimitMB", "8", "-pulseSeconds", "1",
                *master_args)
    await asyncio.sleep(2)
    for i in range(n_servers):
        await procs.spawn("volume", "-port", str(port0 + 1 + i),
                    "-dir", os.path.join(procs.tmp, f"v{i}"),
                    "-max", "20", "-master", master,
                    "-pulseSeconds", "1")
    return master


async def scenario_ec(tmp: str) -> int:
    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    try:
        master = await cluster(procs, BASE_PORT, 3)
        await wait_assign(master, "replication=001")
        rng = random.Random(42)
        payloads: dict = {}
        async with WeedClient(master) as c:
            await fill(c, payloads, 1500, rng)
            dead = rng.sample(sorted(payloads), 450)
            await c.delete_fids(dead)
            for f in dead:
                del payloads[f]
            await asyncio.to_thread(
                procs.shell, master,
                "volume.vacuum -garbageThreshold 0.05")
            await asyncio.to_thread(
                procs.shell, master, "ec.encode -fullPercent 1")
            # NO settling sleep: reads must verify IMMEDIATELY
            return await verify(c, payloads, "after ec.encode")
    finally:
        procs.kill_all()


async def scenario_vacuum_race(tmp: str) -> int:
    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    try:
        master = await cluster(procs, BASE_PORT + 10, 2)
        await wait_assign(master)
        rng = random.Random(9)
        payloads: dict = {}
        stop = asyncio.Event()
        async with WeedClient(master) as c:
            async def writer():
                i = 0
                while not stop.is_set():
                    i += 1
                    data = rng.randbytes(rng.randint(500, 20000))
                    try:
                        fid = await c.upload_data(data,
                                                  replication="001")
                    except Exception:  # noqa: BLE001
                        await asyncio.sleep(0.05)
                        continue
                    payloads[fid] = data
                    if i % 4 == 0 and payloads:
                        victim = rng.choice(list(payloads))
                        try:
                            await c.delete_fids([victim])
                            del payloads[victim]
                        # weedlint: ignore[silent-except] churn driver: armed failpoints make deletes fail by design; the byte-verify pass catches real loss
                        except Exception:  # noqa: BLE001
                            pass

            writers = [asyncio.create_task(writer()) for _ in range(8)]
            for round_ in range(4):
                await asyncio.sleep(4)
                # to_thread: a blocking subprocess.run would suspend the
                # writers and erase the very race being tested
                await asyncio.to_thread(
                    procs.shell, master,
                    "volume.vacuum -garbageThreshold 0.01")
                print(f"  vacuum round {round_ + 1} "
                      f"({len(payloads)} live)")
            stop.set()
            await asyncio.gather(*writers, return_exceptions=True)
            return await verify(c, payloads, "after vacuum races")
    finally:
        procs.kill_all()


async def scenario_rebuild(tmp: str) -> int:
    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    try:
        master = await cluster(procs, BASE_PORT + 20, 4)
        await wait_assign(master)
        rng = random.Random(12)
        payloads: dict = {}
        async with WeedClient(master) as c:
            await fill(c, payloads, 900, rng, replication="000")
            await asyncio.sleep(2)
            # fullPercent 1: EVERY volume (incl. small tails) must be
            # EC-protected, or the killed server takes replication-000
            # files with it and the scenario fails on placement luck
            await asyncio.to_thread(
                procs.shell, master, "ec.encode -fullPercent 1")
            bad = await verify(c, payloads, "after encode")
            # SIGKILL one shard-holding volume server (procs[2])
            procs.procs[2].send_signal(signal.SIGKILL)
            await asyncio.sleep(4)
            bad += await verify(c, payloads, "degraded (server killed)")
            await asyncio.to_thread(
                procs.shell, master, "ec.rebuild -force")
            await asyncio.sleep(2)
            bad += await verify(c, payloads, "after ec.rebuild")
            return bad
    finally:
        procs.kill_all()


async def scenario_failover(tmp: str) -> int:
    import json

    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    try:
        port0 = BASE_PORT + 30
        peers = ",".join(f"127.0.0.1:{port0 + i}" for i in range(3))
        for i in range(3):
            await procs.spawn("master", "-port", str(port0 + i),
                        "-mdir", os.path.join(procs.tmp, f"m{i}"),
                        "-peers", peers, "-pulseSeconds", "1",
                        "-sequencer",
                        f"file:{os.path.join(procs.tmp, f'seq{i}')}")
        await asyncio.sleep(4)
        for i in range(2):
            await procs.spawn("volume", "-port", str(port0 + 10 + i),
                        "-dir", os.path.join(procs.tmp, f"v{i}"),
                        "-max", "16", "-master", peers,
                        "-pulseSeconds", "1")
        first = f"127.0.0.1:{port0}"
        await wait_assign(first, "replication=001")
        with urllib.request.urlopen(
                f"http://{first}/cluster/status", timeout=5) as r:
            leader = json.load(r)["leader"]
        leader_proc = procs.procs[int(leader.split(":")[1]) - port0]

        rng = random.Random(3)
        payloads: dict = {}
        errors = []
        stop = asyncio.Event()
        # the client gets the FULL seed list: whichever master dies —
        # including the one a single-seed client would be pointed at —
        # the seed rotation must carry it through the failover
        async with WeedClient(peers) as c:
            async def writer():
                while not stop.is_set():
                    data = rng.randbytes(rng.randint(500, 8000))
                    try:
                        fid = await c.upload_data(data,
                                                  replication="001")
                        payloads[fid] = data
                    except Exception as e:  # noqa: BLE001
                        errors.append(str(e)[:60])
                        await asyncio.sleep(0.2)

            writers = [asyncio.create_task(writer()) for _ in range(6)]
            await asyncio.sleep(5)
            pre = len(payloads)
            leader_proc.send_signal(signal.SIGKILL)
            t_kill = time.time()
            while len(payloads) <= pre and time.time() - t_kill < 60:
                await asyncio.sleep(0.5)
            recovery = time.time() - t_kill
            print(f"  first post-kill write after {recovery:.1f}s "
                  f"({len(errors)} transient errors)")
            await asyncio.sleep(8)
            stop.set()
            await asyncio.gather(*writers, return_exceptions=True)
            bad = await verify(c, payloads, "after leader failover")
            if recovery >= 60:
                print("  FAIL: no write succeeded within 60s of the kill")
                bad += 1
            return bad
    finally:
        procs.kill_all()


class PairProxy:
    """Userspace TCP link for ONE direction of a master pair; the soak
    cuts it to simulate a network partition (both processes stay alive —
    the failure class SIGKILL soaks can't produce)."""

    def __init__(self, name: str, listen_port: int, target_port: int,
                 cut: set):
        self.name = name
        self.listen_port = listen_port
        self.target_port = target_port
        self.cut = cut              # shared: {name} membership = severed
        self.conns: set = set()
        self.server = None

    async def start(self) -> None:
        self.server = await asyncio.start_server(
            self._handle, "127.0.0.1", self.listen_port)

    def sever(self) -> None:
        for w in list(self.conns):
            w.close()

    async def _handle(self, r, w) -> None:
        if self.name in self.cut:
            w.close()
            return
        try:
            tr, tw = await asyncio.open_connection(
                "127.0.0.1", self.target_port)
        except OSError:
            w.close()
            return
        self.conns.update((w, tw))

        async def pipe(a, b):
            try:
                while True:
                    d = await a.read(65536)
                    if not d or self.name in self.cut:
                        break
                    b.write(d)
                    await b.drain()
            # weedlint: ignore[silent-except] chaos TCP proxy: severed/reset pipes are this tool's purpose, any stream error just ends the pipe
            except Exception:  # noqa: BLE001
                pass
            finally:
                try:
                    b.close()
                except OSError:
                    pass  # peer already gone

        await asyncio.gather(pipe(r, tw), pipe(tr, w),
                             return_exceptions=True)
        self.conns.difference_update((w, tw))


async def scenario_partition(tmp: str) -> int:
    """Cut the LEADER's raft links (both directions, processes alive):
    the minority master must stop assigning within its lease, the
    majority must elect a successor, writes must keep flowing, and the
    heal must leave ONE leader and ZERO duplicate fids. Reference
    behavior contract: raft_server.go:28-97 (chrislusf/raft leader
    lease + election under partition)."""
    import json

    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    port0 = BASE_PORT + 40
    real = [f"127.0.0.1:{port0 + i}" for i in range(3)]
    # directed-pair proxies: master i dials master j via Q[i][j]; raft
    # traffic (and only raft traffic) rides these links
    qport = {(i, j): port0 + 50 + i * 3 + j
             for i in range(3) for j in range(3) if i != j}
    cut: set = set()
    proxies = {}
    for (i, j), qp in qport.items():
        proxies[(i, j)] = PairProxy(f"{i}->{j}", qp, port0 + j, cut)
    for p in proxies.values():
        await p.start()
    try:
        for i in range(3):
            peer_list = ",".join(
                [real[i]] + [f"127.0.0.1:{qport[(i, j)]}"
                             for j in range(3) if j != i])
            await procs.spawn("master", "-port", str(port0 + i),
                        "-mdir", os.path.join(procs.tmp, f"m{i}"),
                        "-peers", peer_list, "-pulseSeconds", "1",
                        "-sequencer",
                        f"file:{os.path.join(procs.tmp, f'seq{i}')}")
        # asyncio.sleep / to_thread, NOT time.sleep: the pair proxies run
        # on THIS loop — blocking it severs every raft link at once
        await asyncio.sleep(4)
        for i in range(2):
            await procs.spawn("volume", "-port", str(port0 + 10 + i),
                        "-dir", os.path.join(procs.tmp, f"v{i}"),
                        "-max", "16", "-master", ",".join(real),
                        "-pulseSeconds", "1")
        await wait_assign(real[0], "replication=001")

        def status(url):
            with urllib.request.urlopen(
                    f"http://{url}/cluster/status", timeout=3) as r:
                return json.load(r)

        leader = (await asyncio.to_thread(status, real[0]))["leader"]
        li = real.index(leader)
        others = [i for i in range(3) if i != li]
        print(f"  leader is master{li} ({leader})")

        rng = random.Random(17)
        payloads: dict = {}
        errors: list = []
        stop = asyncio.Event()
        async with WeedClient(",".join(real)) as c:
            async def writer():
                while not stop.is_set():
                    data = rng.randbytes(rng.randint(500, 8000))
                    try:
                        fid = await c.upload_data(data,
                                                  replication="001")
                        payloads[fid] = data
                    except Exception as e:  # noqa: BLE001
                        errors.append(str(e)[:60])
                        await asyncio.sleep(0.2)

            writers = [asyncio.create_task(writer()) for _ in range(6)]
            await asyncio.sleep(4)
            pre = len(payloads)

            # ---- CUT: isolate the leader from both peers ----
            for j in others:
                cut.add(f"{li}->{j}")
                cut.add(f"{j}->{li}")
            for p in proxies.values():
                if p.name in cut:
                    p.sever()
            t_cut = time.time()
            print(f"  partition: master{li} isolated "
                  f"({len(payloads)} files so far)")

            # majority elects a successor; old leader must step down
            new_leader = None
            while time.time() - t_cut < 30:
                await asyncio.sleep(0.5)
                try:
                    st = await asyncio.to_thread(status, real[others[0]])
                    if st["leader"] and st["leader"] != leader:
                        new_leader = st["leader"]
                        break
                except OSError:
                    pass
            bad = 0
            if not new_leader:
                print("  FAIL: majority elected no successor in 30s")
                bad += 1
            else:
                print(f"  new leader {new_leader} after "
                      f"{time.time() - t_cut:.1f}s")
            # the isolated minority master must NOT be assigning: its
            # lease expired and it has no quorum
            await asyncio.sleep(1.5)
            try:
                st = await asyncio.to_thread(status, real[li])
                if st.get("isLeader"):
                    print("  FAIL: isolated master still claims "
                          "leadership past its lease")
                    bad += 1
                with urllib.request.urlopen(
                        f"http://{real[li]}/dir/assign?replication=001",
                        timeout=3) as r:
                    body = json.load(r)
                    if "fid" in body:
                        print(f"  FAIL: isolated master still assigns: "
                              f"{body}")
                        bad += 1
            except (OSError, ValueError):
                pass  # refusing/erroring is the correct behavior

            # writes must keep flowing through the majority
            t0 = time.time()
            while len(payloads) <= pre and time.time() - t0 < 30:
                await asyncio.sleep(0.5)
            if len(payloads) <= pre:
                print("  FAIL: no write succeeded during the partition")
                bad += 1
            await asyncio.sleep(4)

            # ---- HEAL ----
            cut.clear()
            print(f"  healed ({len(payloads)} files, "
                  f"{len(errors)} transient errors)")
            t_heal = time.time()
            converged = False
            while time.time() - t_heal < 30:
                await asyncio.sleep(0.5)
                try:
                    sts = [await asyncio.to_thread(status, u)
                           for u in real]
                except OSError:
                    continue
                leaders = {st["leader"] for st in sts}
                claiming = [st for st in sts if st.get("isLeader")]
                if len(leaders) == 1 and "" not in leaders \
                        and len(claiming) == 1:
                    converged = True
                    break
            if not converged:
                print("  FAIL: masters did not converge on one leader "
                      "after heal")
                bad += 1
            await asyncio.sleep(3)
            stop.set()
            await asyncio.gather(*writers, return_exceptions=True)

            # ZERO duplicate fids across the whole run: upload_data
            # would have overwritten payloads[fid] silently, so count
            # via a second write-log? payloads keys ARE the issued fids;
            # a duplicate issue to two writers would byte-mismatch one
            # of them in verify below. Also verify every byte.
            bad += await verify(c, payloads, "after partition heal")
            return bad
    finally:
        for p in proxies.values():
            if p.server:
                p.server.close()
        procs.kill_all()


async def scenario_workers(tmp: str) -> int:
    """-workers 2 volume fleet (SO_REUSEPORT, vid % 2 partitioning):
    continuous writes while each worker is SIGKILLed in turn (the
    supervisor respawns them), then every surviving byte is verified
    through the SHARED port, exercising the sibling proxy path for the
    ~half of reads the kernel routes to the non-owner."""
    import json
    import urllib.request as urq

    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    try:
        port0 = BASE_PORT + 60
        master = f"127.0.0.1:{port0}"
        await procs.spawn("master", "-port", str(port0),
                    "-mdir", os.path.join(procs.tmp, "m"),
                    "-volumeSizeLimitMB", "8", "-pulseSeconds", "1")
        await asyncio.sleep(2)
        vport = port0 + 1
        await procs.spawn("volume", "-port", str(vport),
                    "-dir", os.path.join(procs.tmp, "v0"),
                    "-max", "20", "-master", master,
                    "-pulseSeconds", "1", "-workers", "2")
        await wait_assign(master)

        def worker_rows():
            with urq.urlopen(f"http://127.0.0.1:{vport}/stats/workers",
                             timeout=3) as r:
                return json.load(r)["workers"]

        rng = random.Random(77)
        payloads: dict = {}
        errors: list = []
        stop = asyncio.Event()
        async with WeedClient(master) as c:
            async def writer():
                while not stop.is_set():
                    data = rng.randbytes(rng.randint(500, 20000))
                    try:
                        fid = await c.upload_data(data)
                        payloads[fid] = data
                    except Exception as e:  # noqa: BLE001
                        errors.append(str(e)[:60])
                        await asyncio.sleep(0.1)

            writers = [asyncio.create_task(writer()) for _ in range(6)]
            await asyncio.sleep(4)
            bad = 0
            for victim_idx in (1, 0):
                rows = await asyncio.to_thread(worker_rows)
                victim = [w for w in rows
                          if w["index"] == victim_idx][0]
                os.kill(victim["pid"], signal.SIGKILL)
                print(f"  killed worker {victim_idx} "
                      f"(pid {victim['pid']}, {len(payloads)} files)")
                t0 = time.time()
                while time.time() - t0 < 30:
                    await asyncio.sleep(0.5)
                    rows = await asyncio.to_thread(worker_rows)
                    me = [w for w in rows if w["index"] == victim_idx]
                    if me and me[0]["alive"] \
                            and me[0]["pid"] != victim["pid"]:
                        break
                else:
                    print(f"  FAIL: worker {victim_idx} not respawned "
                          f"within 30s")
                    bad += 1
                await asyncio.sleep(3)
            stop.set()
            await asyncio.gather(*writers, return_exceptions=True)
            print(f"  {len(payloads)} files written "
                  f"({len(errors)} transient errors)")

            # byte-verify through the SHARED port only: whichever
            # worker accepts each connection must serve or proxy
            async def shared_read(fid: str) -> bytes:
                path = f"http://127.0.0.1:{vport}/{fid}"
                return await asyncio.to_thread(
                    lambda: urq.urlopen(path, timeout=10).read())

            sem = asyncio.Semaphore(16)
            failures = []

            async def check(fid, want):
                async with sem:
                    try:
                        got = await shared_read(fid)
                    except Exception as e:  # noqa: BLE001
                        failures.append((fid, str(e)[:60]))
                        return
                if got != want:
                    failures.append((fid, "MISMATCH"))

            await asyncio.gather(*(check(f, w)
                                   for f, w in payloads.items()))
            print(f"  shared-port verify: bad={len(failures)}"
                  f"/{len(payloads)}")
            for fid, why in failures[:5]:
                print("   ", fid, why)
            return bad + len(failures)
    finally:
        procs.kill_all()


def _failpoints(vport: int, method: str, query: str = "") -> None:
    req = urllib.request.Request(
        f"http://127.0.0.1:{vport}/debug/failpoints{query}",
        method=method)
    with urllib.request.urlopen(req, timeout=10) as r:
        r.read()


async def scenario_cache_churn(tmp: str) -> int:
    """Read-your-writes through the new cache tiers: a -workers 2
    volume fleet with the hot-needle cache on, a client with the chunk
    cache on, Zipfian hot reads racing same-fid overwrites and deletes
    while failpoints inject read errors/latency. EVERY read is
    byte-verified against the current truth under a per-fid lock: a
    single stale byte (old bytes after overwrite, success after
    delete) fails the scenario. Injected-fault read errors are counted
    as transient, not stale."""
    from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache
    from seaweedfs_tpu_torch.util.client import OperationError, WeedClient
    procs = Procs(tmp)
    duration = float(os.environ.get("SWTPU_TORCH_CHURN_SECONDS", "20"))
    n_files = int(os.environ.get("SWTPU_TORCH_CHURN_FILES", "250"))
    try:
        port0 = BASE_PORT + 70
        master = f"127.0.0.1:{port0}"
        await procs.spawn("master", "-port", str(port0),
                    "-mdir", os.path.join(procs.tmp, "m"),
                    "-volumeSizeLimitMB", "8", "-pulseSeconds", "1")
        await asyncio.sleep(2)
        vport = port0 + 1
        await procs.spawn("volume", "-port", str(vport),
                    "-dir", os.path.join(procs.tmp, "v"),
                    "-max", "20", "-master", master,
                    "-pulseSeconds", "1", "-workers", "2",
                    "-cache.mem", "16")
        await wait_assign(master)

        rng = random.Random(5)
        payloads: dict = {}
        locks: dict = {}
        deleted: set = set()
        stats = {"reads": 0, "stale": 0, "transient": 0,
                 "overwrites": 0, "deletes": 0, "batched": 0,
                 "pipelined": 0}
        async with WeedClient(
                master, chunk_cache=await asyncio.to_thread(TieredChunkCache, 8 << 20)) as c:
            await fill(c, payloads, n_files, rng, replication="000")
            fid_list = sorted(payloads)
            for f in fid_list:
                locks[f] = asyncio.Lock()

            def pick() -> str:
                # zipf-ish hot head: most traffic lands on a few fids,
                # so the caches actually heat up before churn hits them
                i = min(len(fid_list) - 1,
                        int(rng.paretovariate(1.2)) - 1)
                return fid_list[i]

            # armed for the WHOLE churn window: cache-hot reads must
            # stay byte-exact while the miss path throws errors and
            # stalls (the volume fans the arming out to both workers)
            await asyncio.to_thread(
                _failpoints, vport, "POST",
                "?site=store.read&spec=error@0.02")
            await asyncio.to_thread(
                _failpoints, vport, "POST",
                "?site=volume.read.http&spec=latency=10@0.05")
            # sever a slice of the binary frame hop too: pipelined
            # reads and the sibling frame proxy must fall back to
            # HTTP without a single stale/lost byte. Armed BOTH on the
            # servers (the worker-to-worker frame forward) and in this
            # process (the client's own channels).
            await asyncio.to_thread(
                _failpoints, vport, "POST",
                "?site=worker.frame&spec=error@0.05")
            from seaweedfs_tpu_torch.util import failpoints as _fp
            _fp.arm("worker.frame", "error@0.05")
            stop_at = time.time() + duration

            async def reader() -> None:
                while time.time() < stop_at:
                    fid = pick()
                    async with locks[fid]:
                        want = payloads.get(fid)
                        try:
                            got = await c.read(fid)
                        except OperationError:
                            # correct for a deleted fid; otherwise an
                            # injected-fault miss that exhausted its
                            # holders — transient, not stale
                            if fid not in deleted:
                                stats["transient"] += 1
                            continue
                        stats["reads"] += 1
                        if want is None:
                            print(f"  STALE: read of deleted {fid} "
                                  f"returned {len(got)} bytes")
                            stats["stale"] += 1
                        elif got != want:
                            print(f"  STALE: {fid} returned "
                                  f"{len(got)}B != expected "
                                  f"{len(want)}B after overwrite")
                            stats["stale"] += 1

            async def batch_reader() -> None:
                # the /batch multi-needle wire path must hold the same
                # read-your-writes bar as single GETs, under the same
                # armed failpoints; locks taken in sorted order so the
                # group acquisition can't deadlock against reader()
                import contextlib
                while time.time() < stop_at:
                    group = sorted({pick() for _ in range(4)})
                    async with contextlib.AsyncExitStack() as held:
                        for f in group:
                            await held.enter_async_context(locks[f])
                        want = {f: payloads.get(f) for f in group}
                        got = await c.batch_read(group)
                        for f in group:
                            g = got.get(f)
                            if g is None:
                                # deleted fid: correct; live fid: an
                                # injected-fault miss — transient
                                if f not in deleted:
                                    stats["transient"] += 1
                                continue
                            stats["reads"] += 1
                            stats["batched"] += 1
                            if want[f] is None:
                                print(f"  STALE: batch read of "
                                      f"deleted {f} returned "
                                      f"{len(g)} bytes")
                                stats["stale"] += 1
                            elif g != want[f]:
                                print(f"  STALE: batch {f} returned "
                                      f"{len(g)}B != expected "
                                      f"{len(want[f])}B")
                                stats["stale"] += 1

            async def pipeline_reader() -> None:
                # a fraction of traffic rides the binary frame wire
                # (multiplexed pipelined reads) with worker.frame
                # faults armed: every severed request must downgrade
                # to HTTP and still return current bytes
                import contextlib
                while time.time() < stop_at:
                    group = sorted({pick() for _ in range(4)})
                    async with contextlib.AsyncExitStack() as held:
                        for f in group:
                            await held.enter_async_context(locks[f])
                        want = {f: payloads.get(f) for f in group}
                        got = await c.pipelined_read(group, depth=4)
                        for f in group:
                            g = got.get(f)
                            if g is None:
                                if f not in deleted:
                                    stats["transient"] += 1
                                continue
                            stats["reads"] += 1
                            stats["pipelined"] += 1
                            if want[f] is None:
                                print(f"  STALE: pipelined read of "
                                      f"deleted {f} returned "
                                      f"{len(g)} bytes")
                                stats["stale"] += 1
                            elif g != want[f]:
                                print(f"  STALE: pipelined {f} "
                                      f"returned {len(g)}B != "
                                      f"expected {len(want[f])}B")
                                stats["stale"] += 1

            async def overwriter() -> None:
                while time.time() < stop_at:
                    fid = pick()
                    if fid in deleted:
                        continue
                    new = rng.randbytes(rng.randint(200, 8000))
                    async with locks[fid]:
                        if fid in deleted:
                            continue
                        try:
                            locs = await c.lookup(fid.split(",")[0])
                            await c.upload(fid, locs[0]["url"], new)
                        except OperationError:
                            stats["transient"] += 1
                            continue
                        payloads[fid] = new
                        stats["overwrites"] += 1
                    await asyncio.sleep(0.005)

            async def deleter() -> None:
                while time.time() < stop_at:
                    await asyncio.sleep(max(0.2, duration / 25))
                    fid = rng.choice(fid_list)
                    if fid in deleted:
                        continue
                    async with locks[fid]:
                        try:
                            await c.delete_fids([fid])
                        except OperationError:
                            continue
                        deleted.add(fid)
                        payloads.pop(fid, None)
                        stats["deletes"] += 1

            await asyncio.gather(*[reader() for _ in range(4)],
                                 *[batch_reader() for _ in range(2)],
                                 *[pipeline_reader() for _ in range(2)],
                                 *[overwriter() for _ in range(2)],
                                 deleter())
            await asyncio.to_thread(_failpoints, vport, "DELETE")
            print(f"  churn: {stats['reads']} verified reads "
                  f"({stats['batched']} via /batch, "
                  f"{stats['pipelined']} pipelined over frames), "
                  f"{stats['overwrites']} overwrites, "
                  f"{stats['deletes']} deletes, "
                  f"{stats['transient']} transient errors, "
                  f"{stats['stale']} stale")
            _fp.reset()
            # quiescent final sweep: every live file byte-exact, every
            # deleted fid a clean 404 (lost/stale both count as bad)
            bad = await verify(c, payloads, "after cache churn")
            for fid in deleted:
                try:
                    await c.read(fid)
                except OperationError:
                    continue
                print(f"  STALE: deleted {fid} still readable")
                bad += 1
            return bad + stats["stale"]
    finally:
        procs.kill_all()


def pregrow(master: str) -> None:
    """Grow one more writable volume (replication 000) on `master`, so a
    fill is spread over two volumes whatever the heartbeats report."""
    req = urllib.request.Request(
        f"http://{master}/vol/grow?count=1&replication=000",
        method="POST")
    with urllib.request.urlopen(req, timeout=15) as r:
        r.read()


def _http_json(port: int, path: str, method: str = "GET") -> dict:
    import json as _json
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method)
    with urllib.request.urlopen(req, timeout=300) as r:
        return _json.loads(r.read())


async def scenario_scrub(tmp: str) -> int:
    """Silent-corruption hunt under pacing: one volume server holds
    every EC shard, real bit-rot is planted on disk in parity shards
    (bytes no foreground needle read ever visits) AND the scrub.read
    failpoint is armed with `flip`, while foreground reads hammer the
    same volumes. The paced scrubber must report EVERY planted
    corruption, cause ZERO foreground read errors, and hold its token-
    bucket byte budget (the pacing floor is asserted from the cycle
    report)."""
    import glob as _glob

    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    failures = 0
    mbps = 8.0
    try:
        port0 = BASE_PORT + 80
        master = f"127.0.0.1:{port0}"
        await procs.spawn("master", "-port", str(port0),
                    "-mdir", os.path.join(procs.tmp, "m"),
                    "-volumeSizeLimitMB", "8", "-pulseSeconds", "1")
        await asyncio.sleep(2)
        vport = port0 + 1
        vdir = os.path.join(procs.tmp, "v")
        await procs.spawn("volume", "-port", str(vport), "-dir", vdir,
                    "-max", "20", "-master", master,
                    "-pulseSeconds", "1",
                    "-scrub.mbps", str(mbps),
                    "-scrub.interval", "3600",   # loop alive, cycles
                    "-scrub.pausems", "500")     # driven via ?run=1
        await wait_assign(master)
        # pre-grow a second volume, as heal does: the fill below can
        # end before a heartbeat reports volume 1 full, and then the
        # layout never rolls and ec.encode makes one EC volume where
        # the scenario plants rot in two
        await asyncio.to_thread(pregrow, master)
        rng = random.Random(77)
        payloads: dict = {}
        async with WeedClient(master) as c:
            await fill(c, payloads, 900, rng, replication="000")
            await asyncio.to_thread(
                procs.shell, master, "ec.encode -fullPercent 1")
            bad = await verify(c, payloads, "after ec.encode")

            vids = sorted(int(os.path.basename(p)[:-4])
                          for p in _glob.glob(os.path.join(vdir,
                                                           "*.ecx")))
            if len(vids) < 2:
                print(f"  want >=2 EC volumes, got {vids}")
                return bad + 1
            # real on-disk bit rot in a PARITY shard of every volume
            # but the first (shard files < 4MB => scrub window 0)
            def flip_byte(path: str, off: int) -> None:
                with open(path, "r+b") as f:
                    f.seek(off)
                    b = f.read(1)
                    f.seek(off)
                    f.write(bytes([b[0] ^ 0xFF]))

            planted = []
            for vid in vids[1:]:
                await asyncio.to_thread(
                    flip_byte, os.path.join(vdir, f"{vid}.ec12"), 4321)
                planted.append(vid)
            # failpoint-injected corruption lands in the FIRST
            # scrubbed volume's first window (2 row reads flipped)
            await asyncio.to_thread(
                _failpoints, vport, "POST",
                "?site=scrub.read&spec=flip:2")
            expected = {(vids[0], 0)} | {(v, 0) for v in planted}

            # foreground reads run THROUGH the scrub cycle: zero
            # errors tolerated (the scrubber must never disturb them)
            stop = asyncio.Event()
            fg = {"reads": 0, "errors": 0}
            sample = dict(rng.sample(sorted(payloads.items()), 200))

            async def forever_reads() -> None:
                while not stop.is_set():
                    for fid, want in sample.items():
                        if stop.is_set():
                            break
                        try:
                            got = await c.read(fid)
                        except Exception as e:  # noqa: BLE001
                            print(f"  FG ERROR {fid}: "
                                  f"{type(e).__name__} {e}")
                            fg["errors"] += 1
                            continue
                        fg["reads"] += 1
                        if got != want:
                            print(f"  FG STALE {fid}")
                            fg["errors"] += 1

            readers = [asyncio.create_task(forever_reads())
                       for _ in range(2)]
            body = await asyncio.to_thread(
                _http_json, vport, "/debug/scrub?run=1", "POST")
            stop.set()
            await asyncio.gather(*readers)
            cycle, status = body["cycle"], body["status"]
            reported = {(r["volume"], r["offset"])
                        for r in status["corruptions"]}
            print(f"  cycle 1: {cycle['volumes']} volumes, "
                  f"{cycle['windows']} windows, "
                  f"{cycle['bytes'] / (1 << 20):.1f}MB in "
                  f"{cycle['seconds']}s, corrupt={cycle['corrupt']}, "
                  f"paced_sleep={status['paced_sleep_s']}s; "
                  f"foreground: {fg['reads']} reads "
                  f"{fg['errors']} errors")
            if reported != expected:
                print(f"  MISSED/extra corruption: reported="
                      f"{sorted(reported)} expected={sorted(expected)}")
                failures += 1
            if cycle["skipped"]:
                print(f"  unexpected skips: {cycle['skipped']}")
                failures += 1
            # pacing floor: every byte past the burst was paid for at
            # -scrub.mbps; a cycle faster than that broke the budget
            rate = mbps * (1 << 20)
            floor = max(0.0, (cycle["bytes"] - rate) / rate)
            if cycle["seconds"] < floor * 0.95:
                print(f"  BUDGET BROKEN: {cycle['bytes']}B in "
                      f"{cycle['seconds']}s < floor {floor:.2f}s")
                failures += 1
            if floor > 0 and status["paced_sleep_s"] <= 0:
                print("  pacing never engaged (paced_sleep_s == 0)")
                failures += 1
            failures += fg["errors"]

            # cycle 2: the failpoint is spent, the REAL bit rot
            # persists and must be re-detected every pass
            body = await asyncio.to_thread(
                _http_json, vport, "/debug/scrub?run=1", "POST")
            c2 = body["cycle"]
            print(f"  cycle 2: corrupt={c2['corrupt']} "
                  f"(want {len(planted)}: real rot persists, "
                  f"failpoint spent)")
            if c2["corrupt"] != len(planted):
                failures += 1
            bad += await verify(c, payloads, "after scrub cycles")
            return bad + failures
    finally:
        procs.kill_all()


async def scenario_slo(tmp: str) -> int:
    """SLO flight-recorder acceptance: a `-workers 2` fleet armed with
    `-slo volume.read:p99<40ms@99` serves a healthy read phase —
    /debug/health must stay ok end-to-end — then a latency failpoint
    (store.read latency > threshold) plus sibling-proxy faults (to trip
    a server-side breaker) drive the SAME objective from ok to PAGE.
    The page's evidence must carry the violating timeline slice and at
    least one correlated journal event (breaker/retry/scrub family),
    proving the three recorder surfaces actually cross-link."""
    from seaweedfs_tpu_torch.util.client import WeedClient
    procs = Procs(tmp)
    failures = 0
    try:
        port0 = BASE_PORT + 120
        master = f"127.0.0.1:{port0}"
        await procs.spawn("master", "-port", str(port0),
                    "-mdir", os.path.join(procs.tmp, "m"),
                    "-volumeSizeLimitMB", "8", "-pulseSeconds", "1")
        await asyncio.sleep(2)
        vport = port0 + 1
        await procs.spawn("volume", "-port", str(vport),
                    "-dir", os.path.join(procs.tmp, "v"),
                    "-max", "20", "-master", master,
                    "-pulseSeconds", "1", "-workers", "2",
                    "-timeline.interval", "1",
                    # threshold sized for this container class (~20x
                    # slower than a production host, PERF.md): healthy
                    # server-side reads sit well under it, the armed
                    # latency failpoint far over it
                    "-slo", "volume.read:p99<150ms@99")
        await wait_assign(master)
        rng = random.Random(99)
        payloads: dict = {}

        async with WeedClient(master) as c:
            await fill(c, payloads, 60, rng, replication="000")
            sample = sorted(payloads)

            stats = {"reads": 0, "errors": 0, "first_error": None}
            stop = asyncio.Event()

            async def reader() -> None:
                while not stop.is_set():
                    fid = rng.choice(sample)
                    try:
                        await c.read(fid)
                        stats["reads"] += 1
                    except Exception as e:  # noqa: BLE001 — injected
                        # faults are expected once armed; counted not
                        # raised
                        stats["errors"] += 1
                        if stats["first_error"] is None:
                            stats["first_error"] = repr(e)[:120]

            def health() -> dict:
                # force a merged snapshot so the newest window covers
                # the traffic just driven, then read the verdict
                _http_json(vport, "/debug/timeline?snap=1", "POST")
                return _http_json(vport, "/debug/health")

            readers = [asyncio.create_task(reader()) for _ in range(8)]
            try:
                # -- phase 1: disarmed must stay ok end-to-end --------
                ok_polls = 0
                for _ in range(4):
                    await asyncio.sleep(3)
                    h = await asyncio.to_thread(health)
                    print(f"  healthy phase: status={h['status']} "
                          f"reads={stats['reads']} "
                          f"errors={stats['errors']}"
                          + (f" first_error={stats['first_error']}"
                             if stats["errors"] else ""))
                    if h["status"] == "ok":
                        ok_polls += 1
                if ok_polls < 4:
                    print("  FAIL: healthy fleet left ok")
                    failures += 1

                # -- phase 2: arm latency + sibling faults ------------
                # store.read latency puts every read far over the
                # threshold; a BOUNDED worker.proxy error burst trips
                # the entry worker's sibling breaker => breaker_open
                # lands in the server-side journal as correlated
                # evidence, then the spent failpoint lets the breaker
                # recover so fast 503 rows stop diluting the latency
                # histogram the objective is computed from.  250ms
                # (1.7x the threshold) rather than something larger:
                # the slow 600s window is diluted by every fast
                # healthy-phase row, so paging needs slow-row VOLUME —
                # 8 readers at 250ms feed ~32 violating rows/s vs ~20
                # at 400ms, which on a slow container is the margin
                # between paging inside the budget and timing out
                await asyncio.to_thread(
                    _failpoints, vport, "POST",
                    "?site=store.read&spec=latency=250:*")
                await asyncio.to_thread(
                    _failpoints, vport, "POST",
                    "?site=worker.proxy&spec=error:12")
                paged = None
                t0 = time.monotonic()
                while time.monotonic() - t0 < 300:
                    await asyncio.sleep(5)
                    h = await asyncio.to_thread(health)
                    obj = h["objectives"][0]
                    print(f"  armed phase: status={h['status']} "
                          f"fast_burn={obj['fast']['burn']} "
                          f"slow_burn={obj['slow']['burn']} "
                          f"reads={stats['reads']} "
                          f"errors={stats['errors']}")
                    if h["status"] == "page":
                        paged = h
                        break
                if paged is None:
                    print("  FAIL: never paged under armed latency")
                    return failures + 1
                ev = paged["objectives"][0].get("evidence", {})
                if not ev.get("violating_windows"):
                    print("  FAIL: page without violating timeline "
                          "slice")
                    failures += 1
                etypes = {e["type"] for e in ev.get("events", ())}
                want = {"breaker_open", "breaker_close",
                        "retry_budget_exhausted", "scrub_corruption"}
                if not etypes & want:
                    print(f"  FAIL: no correlated journal event "
                          f"(saw {sorted(etypes)})")
                    failures += 1
                else:
                    print(f"  page evidence: "
                          f"{len(ev['violating_windows'])} violating "
                          f"windows, events={sorted(etypes)}, "
                          f"worst_trace="
                          f"{ev.get('worst_trace', {}).get('trace', '-')}")

                # -- phase 3: disarm, recorder must recover -----------
                # warn/page need the FAST (60s) window burning too, so
                # once the armed latency stops feeding it the verdict
                # must drain back to ok within ~2 fast horizons even
                # though the slow (600s) window still remembers the
                # damage (regression guard: an engine that latches
                # page forever would otherwise pass this scenario)
                await asyncio.to_thread(_failpoints, vport, "DELETE")
                recovered = None
                for _ in range(30):
                    await asyncio.sleep(5)
                    h = await asyncio.to_thread(health)
                    if h["status"] == "ok":
                        recovered = h
                        break
                if recovered is None:
                    print(f"  FAIL: health never drained back to ok "
                          f"after disarm (last={h['status']})")
                    failures += 1
                else:
                    print(f"  disarmed phase: status=ok "
                          f"(fast window drained)")
            finally:
                stop.set()
                await asyncio.gather(*readers, return_exceptions=True)
            return failures
    finally:
        procs.kill_all()


def _sign_s3(method: str, host: str, path: str,
             access_key: str, secret: str) -> dict:
    """Client-side SigV4 (UNSIGNED-PAYLOAD), the way an SDK signs —
    the soak's S3 traffic must carry REAL verified identities so the
    gateway's tenant classification keys on the access key."""
    import hashlib
    import hmac
    from seaweedfs_tpu_torch.s3.auth import ALGORITHM, UNSIGNED, signing_key
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": UNSIGNED}
    signed = sorted(headers)
    canon = "\n".join([
        method, path, "",
        "".join(f"{h}:{headers[h]}\n" for h in signed),
        ";".join(signed), UNSIGNED])
    scope = f"{date}/us-east-1/s3/aws4_request"
    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, date, "us-east-1"), sts.encode(),
                   hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


async def scenario_qos(tmp: str) -> int:
    """Multi-tenant QoS acceptance: an S3 gateway with two REAL SigV4
    identities — `PAYKEY` (weight 8, effectively unlimited rps, an
    armed per-tenant -slo objective) and `ABUSEKEY` (weight 1, tight
    rps) — serves a paying workload while the abuser floods zipf GETs
    at full throttle. The gate: /__debug__/health keeps the paying
    objective ok THROUGH the flood, every throttle/shed decision lands
    on the abuser's class only (paying sheds stay exactly 0), the
    `qos.admit` failpoint proves the chaos path end to end, the abuser
    is readmitted within a couple of bucket horizons once it stops,
    and every byte the gateway ever acked reads back identical."""
    import aiohttp
    procs = Procs(tmp)
    quick = "--quick" in sys.argv
    failures = 0
    try:
        port0 = BASE_PORT + 140
        master = f"127.0.0.1:{port0}"
        await procs.spawn("master", "-port", str(port0),
                    "-mdir", os.path.join(procs.tmp, "m"),
                    "-volumeSizeLimitMB", "8", "-pulseSeconds", "1",
                    "-qos.mbps", "64")
        await asyncio.sleep(2)
        await procs.spawn("volume", "-port", str(port0 + 1),
                    "-dir", os.path.join(procs.tmp, "v"),
                    "-max", "20", "-master", master,
                    "-pulseSeconds", "1", "-qos.mbps", "64")
        s3port = port0 + 2
        s3host = f"127.0.0.1:{s3port}"
        await procs.spawn(
            "s3", "-port", str(s3port), "-master", master,
            "-store", "memory",
            "-accessKey", "PAYKEY", "-secretKey", "PAYSECRET",
            "-accessKey", "ABUSEKEY", "-secretKey", "ABUSESECRET",
            "-qos.tenant", "PAYKEY:8:1000:2000",
            "-qos.tenant", "ABUSEKEY:1:25:25",
            # armed thresholds sized far above this light load: the
            # ladder plumbing runs live, but the scenario's shed
            # evidence stays the deterministic rate-limit path
            "-qos.shed.lagms", "2000", "-qos.shed.waitms", "2000",
            "-timeline.interval", "1",
            "-slo", "s3.get/PAYKEY:p99<1500ms@99")
        await wait_assign(master)
        for _ in range(60):     # gateway readiness
            try:
                _http_json(s3port, "/__debug__/health")
                break
            except OSError:
                await asyncio.sleep(0.5)

        rng = random.Random(17)
        n_objects = 30 if quick else 120
        abuse_s = 8 if quick else 40
        payloads: dict[str, bytes] = {}
        stats = {"pay_reads": 0, "pay_errors": 0, "abuse_200": 0,
                 "abuse_429": 0, "abuse_503": 0, "abuse_other": 0,
                 "pay_stale": 0}

        def qos_snapshot() -> dict:
            return _http_json(s3port, "/__debug__/qos")["qos"]

        def health() -> dict:
            _http_json(s3port, "/__debug__/timeline?snap=1", "POST")
            return _http_json(s3port, "/__debug__/health")

        async with aiohttp.ClientSession() as http:
            async def s3req(method: str, path: str, key: str,
                            secret: str, data: bytes | None = None):
                h = _sign_s3(method, s3host, path, key, secret)
                return await http.request(
                    method, f"http://{s3host}{path}", headers=h,
                    data=data)

            # -- phase 1: the paying tenant fills (every ack recorded)
            async with await s3req("PUT", "/qosbkt", "PAYKEY",
                                   "PAYSECRET") as r:
                assert r.status == 200, await r.text()
            sem = asyncio.Semaphore(16)

            async def put(i: int) -> None:
                body = rng.randbytes(rng.randint(2000, 20000))
                path = f"/qosbkt/obj-{i}"
                async with sem:
                    async with await s3req("PUT", path, "PAYKEY",
                                           "PAYSECRET", body) as r:
                        if r.status == 200:
                            payloads[path] = body
                        else:
                            stats["pay_errors"] += 1

            await asyncio.gather(*(put(i) for i in range(n_objects)))
            print(f"  fill: {len(payloads)}/{n_objects} acked writes")
            if len(payloads) != n_objects:
                print("  FAIL: paying writes rejected during fill")
                failures += 1
            paths = sorted(payloads)

            # -- phase 2: abuser floods, paying keeps reading ---------
            stop = asyncio.Event()

            async def abuser() -> None:
                while not stop.is_set():
                    path = rng.choice(paths)
                    try:
                        async with await s3req("GET", path, "ABUSEKEY",
                                               "ABUSESECRET") as r:
                            await r.read()
                            if r.status == 200:
                                stats["abuse_200"] += 1
                            elif r.status == 429:
                                stats["abuse_429"] += 1
                            elif r.status == 503:
                                stats["abuse_503"] += 1
                            else:
                                stats["abuse_other"] += 1
                    except aiohttp.ClientError:
                        stats["abuse_other"] += 1

            async def paying() -> None:
                while not stop.is_set():
                    path = rng.choice(paths)
                    try:
                        async with await s3req("GET", path, "PAYKEY",
                                               "PAYSECRET") as r:
                            body = await r.read()
                            if r.status != 200:
                                stats["pay_errors"] += 1
                            elif body != payloads[path]:
                                stats["pay_stale"] += 1
                            else:
                                stats["pay_reads"] += 1
                    except aiohttp.ClientError:
                        stats["pay_errors"] += 1
                    await asyncio.sleep(0.02)

            tasks = [asyncio.create_task(abuser()) for _ in range(6)]
            tasks += [asyncio.create_task(paying()) for _ in range(2)]
            t0 = time.monotonic()
            ok_polls = polls = 0
            while time.monotonic() - t0 < abuse_s:
                await asyncio.sleep(3)
                h = await asyncio.to_thread(health)
                polls += 1
                if h["status"] == "ok":
                    ok_polls += 1
                print(f"  flood: health={h['status']} "
                      f"pay={stats['pay_reads']} "
                      f"abuse 200/429/503="
                      f"{stats['abuse_200']}/{stats['abuse_429']}"
                      f"/{stats['abuse_503']}")
            stop.set()
            await asyncio.gather(*tasks, return_exceptions=True)

            if ok_polls < polls:
                print(f"  FAIL: paying objective left ok during the "
                      f"flood ({ok_polls}/{polls} ok)")
                failures += 1
            if stats["pay_errors"] or stats["pay_stale"]:
                print(f"  FAIL: paying tenant saw "
                      f"{stats['pay_errors']} errors / "
                      f"{stats['pay_stale']} stale reads in the flood")
                failures += 1
            if not (stats["abuse_429"] + stats["abuse_503"]):
                print("  FAIL: abuser at full throttle was never "
                      "throttled")
                failures += 1
            q = await asyncio.to_thread(qos_snapshot)
            pay = q["tenants"]["PAYKEY"]
            abu = q["tenants"]["ABUSEKEY"]
            if pay["throttled"] or pay["shed"]:
                print(f"  FAIL: sheds landed on the paying class "
                      f"(throttled={pay['throttled']} "
                      f"shed={pay['shed']})")
                failures += 1
            if not (abu["throttled"] + abu["shed"]):
                print("  FAIL: no decision attributed to the abuser's "
                      "class")
                failures += 1
            print(f"  qos: abuser throttled={abu['throttled']} "
                  f"shed={abu['shed']}; paying admitted="
                  f"{pay['admitted']} throttled=0 shed=0")

            # -- phase 3: the qos.admit chaos path --------------------
            await asyncio.to_thread(
                _http_json, s3port,
                "/__debug__/failpoints?site=qos.admit&spec=error:2",
                "POST")
            async with await s3req("GET", paths[0], "PAYKEY",
                                   "PAYSECRET") as r:
                if r.status != 503 or "Retry-After" not in r.headers:
                    print(f"  FAIL: armed qos.admit answered "
                          f"{r.status} without Retry-After")
                    failures += 1
            await asyncio.to_thread(
                _http_json, s3port, "/__debug__/failpoints", "DELETE")

            # -- phase 4: abuser recovery after the flood stops -------
            readmitted = False
            for _ in range(20):
                await asyncio.sleep(0.5)
                async with await s3req("GET", paths[0], "ABUSEKEY",
                                       "ABUSESECRET") as r:
                    await r.read()
                    if r.status == 200:
                        readmitted = True
                        break
            if not readmitted:
                print("  FAIL: abuser never readmitted after backing "
                      "off")
                failures += 1
            h = await asyncio.to_thread(health)
            if h["status"] != "ok":
                print(f"  FAIL: health {h['status']} after the flood "
                      f"ended")
                failures += 1

            # -- phase 5: zero lost acked writes ----------------------
            bad = 0
            for path in paths:
                async with await s3req("GET", path, "PAYKEY",
                                       "PAYSECRET") as r:
                    body = await r.read()
                    if r.status != 200 or body != payloads[path]:
                        bad += 1
            print(f"  verify: bad={bad}/{len(paths)} acked objects, "
                  f"readmitted={readmitted}, health={h['status']}")
            return failures + bad
    finally:
        procs.kill_all()


async def scenario_heal(tmp: str) -> int:
    """Autopilot acceptance: a fleet with the scrubber and
    the autopilot BOTH running autonomously. Real bit-rot is planted
    on disk in a parity shard of two EC volumes, then one shard-
    holding server is SIGKILLed mid-soak. With zero operator
    intervention the fleet must converge back to full declared
    redundancy — every EC volume's 14 shards hosted on live holders,
    a fresh scrub cycle reporting zero corruptions — while foreground
    reads stay error-free and the repair token bucket provably never
    exceeds -autopilot.mbps (pacing floor asserted from the ledger)."""
    import glob as _glob
    import json as _json

    from seaweedfs_tpu_torch.ec import gf as _gf
    from seaweedfs_tpu_torch.util.client import WeedClient
    quick = "--quick" in sys.argv
    procs = Procs(tmp)
    failures = 0
    mbps = 4.0
    try:
        port0 = BASE_PORT + 160
        master = f"127.0.0.1:{port0}"
        await procs.spawn("master", "-port", str(port0),
                    "-mdir", os.path.join(procs.tmp, "m"),
                    "-volumeSizeLimitMB", "4", "-pulseSeconds", "1",
                    "-autopilot.interval", "2",
                    "-autopilot.mbps", str(mbps))
        await asyncio.sleep(2)
        n_servers = 4
        vdirs = []
        for i in range(n_servers):
            d = os.path.join(procs.tmp, f"v{i}")
            vdirs.append(d)
            await procs.spawn("volume", "-port", str(port0 + 1 + i),
                        "-dir", d, "-max", "20", "-master", master,
                        "-pulseSeconds", "1",
                        "-rack", f"r{i % 2}",
                        "-scrub.interval", "4",
                        "-scrub.mbps", "50",
                        "-scrub.pausems", "500")
        await wait_assign(master)

        # pre-grow a second volume: on a fast container the fill below
        # outruns the heartbeat-fed size accounting (every write lands
        # before vid 1 ever reports size >= limit, so the layout never
        # rolls), and the scenario NEEDS >= 2 EC volumes to plant rot
        # in — offer two up front and let pick_for_write spread data
        await asyncio.to_thread(pregrow, master)

        rng = random.Random(2026)
        payloads: dict = {}
        async with WeedClient(master) as c:
            # enough bytes to roll past -volumeSizeLimitMB at least once
            await fill(c, payloads, 500 if quick else 900, rng,
                       replication="000")
            await asyncio.to_thread(
                procs.shell, master, "ec.encode -fullPercent 1")
            bad = await verify(c, payloads, "after ec.encode")

            # locate the EC volumes and plant REAL on-disk rot in a
            # parity shard of two of them (window 0 — shard files
            # are < 1 MB here), wherever those shards landed
            vids = sorted({int(os.path.basename(p).split(".")[0])
                           for d in vdirs
                           for p in _glob.glob(
                               os.path.join(d, "*.ecx"))})
            if len(vids) < 2:
                print(f"  want >=2 EC volumes, got {vids}")
                return bad + 1

            def flip_byte(path: str, off: int) -> None:
                with open(path, "r+b") as f:
                    f.seek(off)
                    b = f.read(1)
                    f.seek(off)
                    f.write(bytes([b[0] ^ 0xFF]))

            rotten = []
            for vid in vids[:2]:
                for d in vdirs:
                    p = os.path.join(d, f"{vid}.ec12")
                    if os.path.exists(p):
                        await asyncio.to_thread(flip_byte, p, 4321)
                        rotten.append(vid)
                        break
            print(f"  planted parity rot in volumes {rotten} "
                  f"(shard 12); autopilot + scrub are autonomous")
            if len(rotten) < 2:
                return bad + 1

            # foreground readers run through the WHOLE soak: repair
            # traffic and holder death must never surface to them
            stop = asyncio.Event()
            fg = {"reads": 0, "errors": 0}
            sample = dict(rng.sample(sorted(payloads.items()),
                                     min(150, len(payloads))))

            async def forever_reads() -> None:
                while not stop.is_set():
                    for fid, want in sample.items():
                        if stop.is_set():
                            break
                        try:
                            got = await c.read(fid)
                        except Exception as e:  # noqa: BLE001
                            print(f"  FG ERROR {fid}: "
                                  f"{type(e).__name__} {e}")
                            fg["errors"] += 1
                            continue
                        fg["reads"] += 1
                        if got != want:
                            print(f"  FG STALE {fid}")
                            fg["errors"] += 1

            readers = [asyncio.create_task(forever_reads())
                       for _ in range(2)]

            # let scrub find the rot and the autopilot start repairing,
            # then SIGKILL one shard-holding volume server mid-soak
            def shard_map() -> dict:
                body = _http_json(port0, "/vol/volumes")
                out: dict = {}
                for node in body["nodes"]:
                    for m in node["ecShards"]:
                        e = out.setdefault(m["id"], {})
                        for sid in range(32):
                            if m["ec_index_bits"] & (1 << sid):
                                e.setdefault(sid, []).append(
                                    node["url"])
                return out

            await asyncio.sleep(10)
            victim = procs.procs[2]        # volume server index 1
            victim_port = port0 + 2
            before = await asyncio.to_thread(shard_map)
            victim.send_signal(signal.SIGKILL)
            # what the kill leaves: a rotten survivor among exactly k
            # has nothing to be checked against
            left = {vid: sorted(sid for sid, us in before.get(vid, {}).items()
                                if any(f":{victim_port}" not in u
                                       for u in us))
                    for vid in vids}
            print(f"  SIGKILLed volume server :{victim_port} mid-soak; "
                  f"survivors per volume "
                  f"{ {v: len(s) for v, s in left.items()} }, shard 12 "
                  f"rotten in {rotten}")

            # convergence: every EC volume back to 14 hosted shards on
            # LIVE nodes, with zero operator intervention
            t0 = time.monotonic()
            deadline = t0 + (240 if quick else 420)
            converged = False
            while time.monotonic() < deadline:
                await asyncio.sleep(5)
                smap = await asyncio.to_thread(shard_map)
                whole = all(
                    len(smap.get(vid, {})) == _gf.TOTAL_SHARDS
                    and all(f":{victim_port}" not in u
                            for us in smap.get(vid, {}).values()
                            for u in us)
                    for vid in vids)
                ap = (await asyncio.to_thread(
                    _http_json, port0, "/debug/autopilot"))["autopilot"]
                print(f"  t+{int(time.monotonic() - t0)}s"
                      f" cycles={ap['cycles']} ok={ap['actions_ok']}"
                      f" failed={ap['actions_failed']}"
                      f" paid={ap['bytes_paid'] >> 20}MB"
                      f" paced={ap['paced_sleep_s']}s whole={whole}")
                if whole and ap["actions_ok"] > 0:
                    converged = True
                    break
            if not converged:
                print("  FAIL: never converged to full redundancy")
                failures += 1
            # snapshot the ledger NOW: the 16-cycle /debug/autopilot
            # history keeps rolling during the verification scrubs
            # below and would evict the executed cycles this report's
            # pacing-floor math needs
            ap_conv = (await asyncio.to_thread(
                _http_json, port0, "/debug/autopilot"))["autopilot"]

            # a FRESH scrub cycle on every live server must be clean
            # for the healed volumes (this is verification, not
            # repair: the autopilot did all the healing). Retried for
            # a bit: each server's EC location cache keeps an ~11s
            # freshness tier, so a scrub fired the instant after
            # convergence can still chase the dead holder for a
            # remote row and report the volume as degraded.
            if converged:
                clean = False
                for attempt in range(10):
                    clean = True
                    rows_seen = []
                    for i in range(n_servers):
                        if port0 + 1 + i == victim_port:
                            continue
                        body = await asyncio.to_thread(
                            _http_json, port0 + 1 + i,
                            "/debug/scrub?run=1", "POST")
                        cyc = body["cycle"]
                        for row in cyc.get("corrupt_windows", ()):
                            rows_seen.append(("CORRUPT", row))
                            clean = False
                        for sk in cyc.get("skipped", ()):
                            if sk.get("missing_shards"):
                                rows_seen.append(("DEGRADED", sk))
                                clean = False
                    if clean:
                        print(f"  verification scrub clean "
                              f"(attempt {attempt + 1})")
                        break
                    await asyncio.sleep(6)
                if not clean:
                    for tag, row in rows_seen:
                        print(f"  STILL {tag}: {row}")
                    failures += 1

            stop.set()
            await asyncio.gather(*readers)
            failures += fg["errors"]
            print(f"  foreground: {fg['reads']} reads, "
                  f"{fg['errors']} errors")

            # repair budget provably held: every byte past the burst
            # was paid for at -autopilot.mbps — reconstruct the repair
            # wall-clock span from the executed ledger (snapshotted at
            # convergence) and compare against the pacing floor
            ap = ap_conv
            stamps = []
            for cyc in ap["history"]:
                if cyc["executed"]:
                    stamps.append(cyc["wall_ms"])
                    stamps.extend(r["wall_ms"]
                                  for r in cyc["executed"])
                # dry-run-equivalence witness: executed rides the
                # planned ledger verbatim, in order
                if [r["action"] for r in cyc["executed"]] \
                        != cyc["planned"]:
                    print("  LEDGER MISMATCH in cycle")
                    failures += 1
            rate = mbps * (1 << 20)
            floor = max(0.0, (ap["bytes_paid"] - rate) / rate)
            span = (max(stamps) - min(stamps)) / 1000.0 if stamps \
                else 0.0
            print(f"  budget: paid={ap['bytes_paid']}B floor="
                  f"{floor:.1f}s span={span:.1f}s "
                  f"paced_sleep={ap['paced_sleep_s']}s")
            if span < floor * 0.9:
                print("  BUDGET BROKEN: repairs finished faster than "
                      "the token bucket allows")
                failures += 1
            if floor > 1.0 and ap["paced_sleep_s"] <= 0:
                print("  pacing never engaged")
                failures += 1

            bad += await verify(c, payloads, "after convergence")
            return bad + failures
    finally:
        procs.kill_all()


def _filer_failpoints(fport: int, method: str, query: str = "") -> None:
    # the filer's path-shadowed admin surface lives under /__debug__/
    req = urllib.request.Request(
        f"http://127.0.0.1:{fport}/__debug__/failpoints{query}",
        method=method)
    with urllib.request.urlopen(req, timeout=10) as r:
        r.read()


def _shards_body(port: int, path: str, body: dict) -> dict:
    import json as _json
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=_json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=15) as r:
        return _json.loads(r.read())


async def scenario_meta(tmp: str) -> int:
    """Sharded filer metadata plane acceptance. Three
    phases:

    1. QPS A/B — bench_meta.run_bench at 1 shard then 4; the
       op-accounted aggregate (sum of per-shard SOLO rates, locality
       proven by the routed counters) must scale >= 3x.
    2. Online split under chaos — populate /soak/hot on shard 0, arm
       filer.shard.* failpoints, commit a split_intent to shard 1,
       SIGKILL the SOURCE filer while the journaled move is pending,
       restart it and let the raft-committed intent replay to
       completion. Foreground creates/stats/lists run the whole time
       (retrying transient faults) and must end with ZERO given-up
       ops; the final paged enumeration must match the expected
       namespace exactly — no lost entry, no duplicate, mtimes
       byte-identical — and the source shard's local copy of the
       moved prefix must be fully tombstoned.
    3. Cross-shard rename storm — journaled two-phase moves from
       shard 0 into the split prefix on shard 1, with the source
       filer SIGKILLed mid-storm; every dst must exist exactly once
       with the src's mtime, every src must be gone.
    """
    import json as _json

    import aiohttp

    from . import bench_meta
    from seaweedfs_tpu_torch.util import failpoints as _fp
    from seaweedfs_tpu_torch.util.client import FilerHttpClient, OperationError
    quick = "--quick" in sys.argv
    failures = 0
    port0 = BASE_PORT + 180

    # -- phase 1: the >=3x op-accounted scaling gate -------------------
    ab_ops = 100 if quick else 600
    r1 = r4 = None
    for n, off in ((1, 0), (4, 20)):
        d = os.path.join(tmp, f"ab{n}")
        await asyncio.to_thread(os.makedirs, d, exist_ok=True)
        r = await bench_meta.run_bench(n, ab_ops, d,
                                       base_port=port0 + off)
        if n == 1:
            r1 = r
        else:
            r4 = r
    x = r4["aggregate_qps"] / max(r1["aggregate_qps"], 1e-9)
    print(f"  A/B: 1-shard {r1['aggregate_qps']:.0f} QPS, 4-shard "
          f"{r4['aggregate_qps']:.0f} QPS -> {x:.2f}x "
          f"(storm_errors={r1['storm_errors']}+{r4['storm_errors']})")
    if x < 3.0:
        print("  FAIL: aggregate metadata QPS did not scale >= 3x")
        failures += 1
    if r1["storm_errors"] or r4["storm_errors"]:
        print("  FAIL: errors under the concurrent storm")
        failures += 1
    for c in r4["counters"]:
        # locality is the accounting's foundation: a shard serving
        # redirects instead of local ops would inflate nothing
        if c["local"] <= 0 or c["redirect"] * 20 > c["local"]:
            print(f"  FAIL: shard {c['url']} not serving locally: {c}")
            failures += 1

    # -- phase 2: online split under failpoints + SIGKILL --------------
    procs = Procs(tmp)
    try:
        port = port0 + 40
        master = f"127.0.0.1:{port}"
        fports = [port + 1, port + 2]
        filers = [f"127.0.0.1:{p}" for p in fports]

        async def spawn_filer(sid: int):
            return await procs.spawn(
                "filer", "-port", str(fports[sid]), "-ip", "127.0.0.1",
                "-master", master, "-store", "sqlite",
                "-dbPath", os.path.join(tmp, f"filer{sid}.db"),
                "-shard.id", str(sid), "-shard.of", "2",
                "-shard.peers", ",".join(filers),
                "-shard.splitMbps", "0.05" if quick else "0.02")

        await procs.spawn("master", "-port", str(port),
                          "-ip", "127.0.0.1",
                          "-mdir", os.path.join(tmp, "m"))
        for sid in range(2):
            await spawn_filer(sid)
        for _ in range(120):
            try:
                m = _http_json(port, "/cluster/shards")
                if {"0", "1"} <= set(m.get("owners", {})):
                    break
            except OSError:
                pass
            await asyncio.sleep(0.5)
        else:
            raise RuntimeError("filer shards never registered")

        n_seed = 300 if quick else 800
        expect: dict[str, float] = {}
        async with FilerHttpClient(filers, master_url=master) as cli:
            sem = asyncio.Semaphore(16)

            async def seed(i: int) -> None:
                p = f"/soak/hot/d{i % 10}/f{i:04d}"
                mt = 1_700_000_000.0 + i
                async with sem:
                    await cli.request(
                        "POST", "/__api__/entry", route_path=p,
                        data=_json.dumps({"FullPath": p,
                                          "Mtime": mt}).encode())
                expect[p] = mt

            await asyncio.gather(*(seed(i) for i in range(n_seed)))
            print(f"  seeded {len(expect)} entries under /soak/hot "
                  f"(shard 0)")

            # chaos: migration batches on the source always fail (the
            # move is guaranteed pending when the SIGKILL lands), the
            # routed gate throws/stalls a slice of foreground hops,
            # and the client's own hop site stalls in-process
            _filer_failpoints(fports[0], "POST",
                              "?site=filer.shard.split&spec=error")
            for fp in fports:
                _filer_failpoints(
                    fp, "POST",
                    "?site=filer.shard.route&spec=error@0.03")
            _fp.arm("filer.shard.route", "latency=5@0.05")

            # foreground load for the WHOLE split window: transient
            # faults (injected 5xx, the dead-filer gap) are retried,
            # an op that never lands within its deadline is a failure
            stop = asyncio.Event()
            fg = {"ok": 0, "retries": 0, "gaveup": 0, "seq": 0}

            async def fg_op(kind: str, path: str, mt: float) -> bool:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    try:
                        if kind == "create":
                            await cli.request(
                                "POST", "/__api__/entry",
                                route_path=path,
                                data=_json.dumps(
                                    {"FullPath": path,
                                     "Mtime": mt}).encode())
                        elif kind == "stat":
                            await cli.stat(path)
                        else:
                            await cli.list_dir(path, limit=64)
                        fg["ok"] += 1
                        return True
                    except (OperationError, aiohttp.ClientError,
                            asyncio.TimeoutError, OSError):
                        fg["retries"] += 1
                        await asyncio.sleep(0.3)
                fg["gaveup"] += 1
                return False

            async def fg_loop() -> None:
                rng = random.Random(77)
                while not stop.is_set():
                    r = rng.random()
                    if r < 0.5:
                        fg["seq"] += 1
                        p = f"/soak/hot/live/f{fg['seq']:05d}"
                        mt = 1_750_000_000.0 + fg["seq"]
                        if await fg_op("create", p, mt):
                            expect[p] = mt
                    elif r < 0.8 and expect:
                        await fg_op("stat", rng.choice(
                            sorted(expect)[:50]), 0)
                    else:
                        await fg_op("list",
                                    f"/soak/hot/d{rng.randrange(10)}",
                                    0)
                    await asyncio.sleep(0.02)

            fg_tasks = [asyncio.create_task(fg_loop())
                        for _ in range(3)]

            _shards_body(port, "/cluster/shards",
                         {"op": "split_intent", "prefix": "/soak/hot",
                          "to": 1})
            await asyncio.sleep(2.0 if quick else 3.0)
            m = _http_json(port, "/cluster/shards")
            mv = [v for v in m.get("moves", ())
                  if v["id"] == "split:/soak/hot"]
            if not mv:
                print("  FAIL: split intent not pending in the map")
                failures += 1
            print(f"  split committed, state="
                  f"{mv[0]['state'] if mv else '?'}; SIGKILLing the "
                  f"source filer with the move journaled")
            procs.procs[1].send_signal(signal.SIGKILL)
            await asyncio.sleep(1.0)
            await spawn_filer(0)
            # the restarted source replays the raft-committed intent;
            # re-arm a moderate batch-failure rate so the replay
            # itself retries through injected faults
            for _ in range(60):
                try:
                    _filer_failpoints(
                        fports[0], "POST",
                        "?site=filer.shard.split&spec=error@0.2")
                    break
                except OSError:
                    await asyncio.sleep(0.5)

            deadline = time.monotonic() + (180 if quick else 300)
            done = False
            while time.monotonic() < deadline:
                await asyncio.sleep(2)
                try:
                    m = _http_json(port, "/cluster/shards")
                except OSError:
                    continue
                rules = {tuple(r) for r in m.get("rules", ())}
                if not m.get("moves") and ("/soak/hot", 1) in rules:
                    done = True
                    break
            if not done:
                print("  FAIL: split never drained after the replay")
                failures += 1
            else:
                print("  split replayed to completion: /soak/hot -> "
                      "shard 1, moves empty")

            stop.set()
            await asyncio.gather(*fg_tasks)
            print(f"  foreground: ok={fg['ok']} retries={fg['retries']}"
                  f" gaveup={fg['gaveup']}")
            failures += fg["gaveup"]

            # -- phase 3: cross-shard rename storm with a kill ---------
            n_ren = 12 if quick else 30
            for i in range(n_ren):
                p = f"/soak/ren/r{i:03d}"
                await cli.request(
                    "POST", "/__api__/entry", route_path=p,
                    data=_json.dumps({"FullPath": p,
                                      "Mtime": 1_800_000_000.0 + i
                                      }).encode())

            async def ren(i: int) -> bool:
                src = f"/soak/ren/r{i:03d}"
                dst = f"/soak/hot/m{i:03d}"
                deadline = time.monotonic() + 90
                while time.monotonic() < deadline:
                    try:
                        await cli.rename(src, dst)
                        return True
                    except (OperationError, aiohttp.ClientError,
                            asyncio.TimeoutError, OSError):
                        try:
                            await cli.stat(dst)
                            try:
                                await cli.stat(src)
                            except OperationError:
                                return True      # move replayed through
                        except (OperationError, aiohttp.ClientError,
                                asyncio.TimeoutError, OSError):
                            pass  # dst not there yet: retry until the
                            # deadline; a stuck move fails below
                        await asyncio.sleep(0.5)
                return False

            async def ren_batch(lo: int, hi: int) -> int:
                res = await asyncio.gather(*(ren(i)
                                             for i in range(lo, hi)))
                return sum(0 if ok else 1 for ok in res)

            bad_ren = await ren_batch(0, n_ren // 3)
            procs.procs[-1].send_signal(signal.SIGKILL)
            print("  SIGKILLed the rename source filer mid-storm")
            await asyncio.sleep(1.0)
            await spawn_filer(0)
            bad_ren += await ren_batch(n_ren // 3, n_ren)
            if bad_ren:
                print(f"  FAIL: {bad_ren} renames never completed")
                failures += bad_ren
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                try:
                    if not _http_json(port,
                                      "/cluster/shards").get("moves"):
                        break
                except OSError:
                    pass
                await asyncio.sleep(1)
            else:
                print("  FAIL: rename moves never drained")
                failures += 1
            for i in range(n_ren):
                expect[f"/soak/hot/m{i:03d}"] = 1_800_000_000.0 + i

            # -- byte-verify: exactly-once, in-order enumeration -------
            for fp in fports:
                _filer_failpoints(fp, "DELETE")
            _fp.reset()

            async def list_all(d: str, limit: int = 7) -> dict:
                out: dict[str, dict] = {}
                start, inc = "", False
                while True:
                    page = await cli.list_dir(d, start_file=start,
                                              limit=limit,
                                              inclusive=inc)
                    names = [e["FullPath"].rsplit("/", 1)[1]
                             for e in page]
                    if names != sorted(names):
                        print(f"  FAIL: {d} page out of order")
                        nonlocal_fail[0] += 1
                    for e, nm in zip(page, names):
                        if e["FullPath"] in out:
                            print(f"  FAIL: duplicate "
                                  f"{e['FullPath']} across pages")
                            nonlocal_fail[0] += 1
                        out[e["FullPath"]] = e
                    if len(page) < limit:
                        return out
                    start = names[-1]

            nonlocal_fail = [0]
            got: dict[str, dict] = {}
            dirs = ([f"/soak/hot/d{i}" for i in range(10)]
                    + ["/soak/hot/live", "/soak/hot", "/soak/ren"])
            for d in dirs:
                for p, e in (await list_all(d)).items():
                    if not e.get("IsDirectory"):
                        got[p] = e
            failures += nonlocal_fail[0]
            missing = sorted(set(expect) - set(got))
            extra = sorted(set(got) - set(expect))
            stale = [p for p in expect
                     if p in got and got[p]["Mtime"] != expect[p]]
            if missing or extra or stale:
                print(f"  FAIL: lost={len(missing)} dup/extra="
                      f"{len(extra)} stale-mtime={len(stale)}")
                for p in (missing[:3] + extra[:3] + stale[:3]):
                    print(f"    {p}")
                failures += len(missing) + len(extra) + len(stale)
            else:
                print(f"  byte-verify: {len(got)} entries exactly "
                      f"once, every mtime intact")

            # tombstone completeness: the SOURCE shard must hold no
            # local copy of the moved prefix (peer-internal local=1
            # listing bypasses routing)
            left = _http_json(
                fports[0],
                "/__api__/list?path=/soak/hot&local=1").get(
                "entries", [])
            if left:
                print(f"  FAIL: {len(left)} entries still on the "
                      f"source shard after tombstone")
                failures += 1
            st = [_http_json(p, "/__debug__/shards") for p in fports]
            print(f"  shard entries: {[s['entries'] for s in st]}, "
                  f"replayed={st[0]['counters']['replayed']}, "
                  f"ingested={st[1]['counters']['ingest']}")
        return failures
    finally:
        _fp.reset()
        procs.kill_all()


SCENARIOS = {
    "ec": scenario_ec,
    "vacuum-race": scenario_vacuum_race,
    "rebuild": scenario_rebuild,
    "failover": scenario_failover,
    "partition": scenario_partition,
    "workers": scenario_workers,
    "cache-churn": scenario_cache_churn,
    "scrub": scenario_scrub,
    "heal": scenario_heal,
    "slo": scenario_slo,
    "qos": scenario_qos,
    "meta": scenario_meta,
}


# the line main() prints, before the directory's path, when it keeps a
# failed scenario's directory (its data and the daemons' proc*.log)
KEPT = "soak: kept the failed scenario's directory "


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which != "all" and which not in SCENARIOS:
        raise SystemExit(f"unknown scenario {which!r}; "
                         f"choose from: all, {', '.join(SCENARIOS)}")
    names = list(SCENARIOS) if which == "all" else [which]
    total_bad = 0
    for name in names:
        print(f"== soak: {name}")
        tmp = tempfile.mkdtemp(prefix=f"swtpu_soak_{name}_")
        bad = None
        try:
            bad = asyncio.run(SCENARIOS[name](tmp))
            total_bad += bad
        finally:
            if bad == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                # a failed (or raising) scenario keeps its daemons'
                # logs for whoever has to explain it
                print(KEPT + tmp, flush=True)
    print("PASS" if total_bad == 0 else f"FAIL ({total_bad} bad reads)")
    sys.exit(0 if total_bad == 0 else 1)


if __name__ == "__main__":
    main()
