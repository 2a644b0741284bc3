"""Filer metadata microbenchmark: create/stat/list/rename QPS.

Measures the sharded metadata plane (filer/shard.py) with
DETERMINISTIC OP ACCOUNTING:

* each shard's capacity is measured SOLO — one shard driven at a time,
  so on a small host the numbers are per-process capacity, not a
  picture of core contention — and aggregate QPS is the sum of
  per-shard solo rates (the fleet's capacity when shards run on their
  own hosts, which is the deployment the shard map exists for);
* per-shard routing counters from /__debug__/shards prove every op was
  served LOCALLY (redirects ~ 0 after the route cache warms) — the
  scaling claim rests on counted local ops, not wall-clock alone;
* a concurrent all-shard storm then runs for CORRECTNESS (zero
  errors under simultaneous multi-shard load), not for the QPS number.

Workload: zipf-skewed ops over deep trees (hot directories are the
filer's real traffic shape), fixed op counts, seeded RNG — two runs do
the same ops in the same order.

Usage:
  python -m seaweedfs_tpu_torch.tools.bench_meta [--shards N] [--ops N]
      [--quick] [--ab]

--ab runs 1-shard then 4-shard and prints the A/B table.
Importable: run_bench() is the soak's scenario_meta building block.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import shutil
import tempfile
import time
import urllib.request

from . import procutil

BASE_PORT = 23100
DEPTH_DIRS = 8          # d0..d7 per level, two levels deep
ZIPF_A = 1.3            # skew: a few directories take most ops


def _get_json(addr: str, path: str) -> dict:
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
        return json.loads(r.read())


def _post_json(addr: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def zipf_pick(rng: random.Random, n: int) -> int:
    """Zipf-ish index in [0, n): directory popularity is heavy-headed."""
    return min(int(rng.paretovariate(ZIPF_A)) - 1, n - 1) % n


def _deep_path(rng: random.Random, prefix: str, i: int) -> str:
    a = zipf_pick(rng, DEPTH_DIRS)
    b = zipf_pick(rng, DEPTH_DIRS)
    return f"{prefix}/d{a}/d{b}/f{i}"


async def start_cluster(procs, base_port: int, shards: int,
                        tmp: str) -> tuple[str, list[str]]:
    """One single-mode master + `shards` sqlite-backed filer shards."""
    master = f"127.0.0.1:{base_port}"
    await procs.spawn("master", "-port", str(base_port),
                      "-ip", "127.0.0.1", "-mdir", f"{tmp}/m")
    filers = []
    for sid in range(shards):
        port = base_port + 1 + sid
        filers.append(f"127.0.0.1:{port}")
    for sid in range(shards):
        port = base_port + 1 + sid
        args = ["filer", "-port", str(port), "-ip", "127.0.0.1",
                "-master", master, "-store", "sqlite",
                "-dbPath", f"{tmp}/filer{sid}.db"]
        if shards > 1:
            args += ["-shard.id", str(sid), "-shard.of", str(shards),
                     "-shard.peers", ",".join(filers)]
        await procs.spawn(*args)
    for _ in range(60):
        try:
            _get_json(master, "/cluster/status")
            break
        except OSError:
            await asyncio.sleep(0.5)
    else:
        raise RuntimeError(f"master {master} never came up")
    # wait for the filer HTTP surfaces (no volumes needed: /__api__/
    # entry creates are pure metadata)
    for f in filers:
        for _ in range(60):
            try:
                _get_json(f, "/__debug__/shards")
                break
            except OSError:
                await asyncio.sleep(0.5)
        else:
            raise RuntimeError(f"filer {f} never came up")
    return master, filers


def install_rules(master: str, shards: int) -> None:
    """Route /bench/t<i> to shard i (empty prefixes: a pure map `set`,
    no migration needed — the split path is exercised by the soak)."""
    rules = [["/", 0]] + [[f"/bench/t{i}", i] for i in range(shards)]
    _post_json(master, "/cluster/shards", {"op": "set", "rules": rules})


async def wait_rules(filers: list[str], shards: int) -> None:
    """Every shard must have adopted the bench rules AND know every
    owner before the measurement starts — a stale map would route ops
    to the wrong shard and poison the locality accounting."""
    want_rules = {f"/bench/t{i}" for i in range(shards)}
    want_owners = {str(i) for i in range(shards)}
    for f in filers:
        for _ in range(60):
            st = _get_json(f, "/__debug__/shards")
            have_rules = {r[0] for r in st["rules"]}
            if want_rules <= have_rules \
                    and want_owners <= set(st["owners"]):
                break
            await asyncio.sleep(0.25)
        else:
            raise RuntimeError(f"filer {f} never adopted bench rules")


async def drive_ops(client, prefix: str, n_ops: int,
                    seed: int) -> dict:
    """The deterministic op script against one prefix: 50% meta
    creates, 25% stats, 15% lists, 10% renames. Returns op counts and
    elapsed wall seconds for THIS prefix only."""
    rng = random.Random(seed)
    counts = {"create": 0, "stat": 0, "list": 0, "rename": 0}
    created: list[str] = []
    t0 = time.perf_counter()
    for i in range(n_ops):
        r = rng.random()
        if r < 0.5 or not created:
            p = _deep_path(rng, prefix, i)
            await client.request(
                "POST", "/__api__/entry", route_path=p,
                data=json.dumps({"FullPath": p,
                                 "Mtime": time.time()}).encode())
            created.append(p)
            counts["create"] += 1
        elif r < 0.75:
            await client.stat(created[zipf_pick(rng, len(created))])
            counts["stat"] += 1
        elif r < 0.9:
            p = created[zipf_pick(rng, len(created))]
            d = p.rsplit("/", 1)[0]
            await client.list_dir(d, limit=256)
            counts["list"] += 1
        else:
            j = zipf_pick(rng, len(created))
            src = created[j]
            dst = src + "r"
            await client.rename(src, dst)
            created[j] = dst
            counts["rename"] += 1
    counts["seconds"] = time.perf_counter() - t0
    counts["qps"] = n_ops / counts["seconds"]
    return counts


async def run_bench(shards: int, ops_per_shard: int, tmp: str,
                    base_port: int = BASE_PORT) -> dict:
    """Boot, measure each shard solo, then storm all shards at once.
    Returns the accounting dict the A/B table and soak read."""
    from seaweedfs_tpu_torch.util.client import FilerHttpClient

    procs = procutil.Procs(tmp)
    try:
        master, filers = await start_cluster(procs, base_port,
                                             shards, tmp)
        if shards > 1:
            install_rules(master, shards)
            await wait_rules(filers, shards)
        per_shard = []
        # solo capacity: one shard at a time, deterministic script
        async with FilerHttpClient(filers, master_url=master) as cli:
            for sid in range(shards):
                prefix = f"/bench/t{sid}" if shards > 1 else "/bench/t0"
                per_shard.append(await drive_ops(
                    cli, prefix, ops_per_shard, seed=1000 + sid))
        aggregate = sum(s["qps"] for s in per_shard)
        # locality proof: the routed counters on each shard
        counters = []
        for f in filers:
            st = _get_json(f, "/__debug__/shards")
            counters.append({"url": f, "entries": st["entries"],
                             **st.get("counters", {})})
        # concurrent storm (correctness only): all prefixes at once,
        # fresh paths so the op script stays deterministic
        errors = 0
        t0 = time.perf_counter()

        async def storm(sid: int) -> dict:
            async with FilerHttpClient(filers,
                                       master_url=master) as c2:
                prefix = (f"/bench/t{sid}/storm" if shards > 1
                          else f"/bench/t0/storm{sid}")
                return await drive_ops(c2, prefix,
                                       max(ops_per_shard // 4, 50),
                                       seed=2000 + sid)

        storm_res = await asyncio.gather(
            *(storm(s) for s in range(shards)), return_exceptions=True)
        for r in storm_res:
            if isinstance(r, BaseException):
                errors += 1
        storm_s = time.perf_counter() - t0
        return {"shards": shards, "ops_per_shard": ops_per_shard,
                "per_shard": per_shard, "aggregate_qps": aggregate,
                "counters": counters, "storm_errors": errors,
                "storm_seconds": storm_s}
    finally:
        procs.kill_all()


def fmt_row(r: dict) -> str:
    ops = r["shards"] * r["ops_per_shard"]
    solo = ", ".join(f"{s['qps']:.0f}" for s in r["per_shard"])
    return (f"| {r['shards']} | {ops} | {solo} | "
            f"{r['aggregate_qps']:.0f} | {r['storm_errors']} |")


async def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--ops", type=int, default=2000,
                    help="deterministic ops per shard")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ab", action="store_true",
                    help="run 1-shard vs N-shard and print the table")
    args = ap.parse_args()
    if args.quick:
        args.ops = min(args.ops, 300)
    results = []
    runs = ([1, args.shards] if args.ab else [args.shards])
    for i, n in enumerate(runs):
        tmp = tempfile.mkdtemp(prefix=f"benchmeta{n}_")
        try:
            r = await run_bench(n, args.ops, tmp,
                                base_port=BASE_PORT + 20 * i)
            results.append(r)
            solo = [round(s["qps"]) for s in r["per_shard"]]
            print(f"[bench_meta] {n} shard(s): aggregate "
                  f"{r['aggregate_qps']:.0f} QPS (solo {solo}, "
                  f"storm_errors={r['storm_errors']})")
            for c in r["counters"]:
                print(f"[bench_meta]   {c}")
        finally:
            await asyncio.to_thread(shutil.rmtree, tmp,
                                    ignore_errors=True)
    if args.ab and len(results) == 2:
        base, wide = results
        print("\n| shards | ops | per-shard solo QPS | aggregate QPS "
              "(op-accounted) | storm errors |")
        print("|---|---|---|---|---|")
        print(fmt_row(base))
        print(fmt_row(wide))
        x = wide["aggregate_qps"] / max(base["aggregate_qps"], 1e-9)
        print(f"\nscaling: {x:.2f}x aggregate at {wide['shards']} "
              f"shards vs 1")
        return 0 if x >= 3.0 and all(
            r["storm_errors"] == 0 for r in results) else 1
    return 0 if all(r["storm_errors"] == 0 for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(asyncio.run(main()))
