"""The cluster cell (`cluster.http-get-4lost`, op `http_get`) on the host
at a small size: the deployment as set-up leaves it, sound runs correct,
the control and the faults not correct where their seam is on the HTTP
path, no module of JAX loaded, and the four readers of the peer fetches
on hand-made spans and counters."""

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import pytest

from benchmark import build, faults, harness, spanclock
from benchmark.devtrace import DeviceTrace, Op
from benchmark.ops import http_get

from .small import ROOT
from .test_benchmark_spans import copy_call, run_of, span

CELL = "cluster.http-get-4lost"
NEW = ("fetch_ms_per_get.http_get", "fetched_MiB_per_get.http_get",
       "frame_fetch_share.http_get", "idle_fetch.http_get")
# the faults whose seam the HTTP path does not reach: `served` alters
# what Store.read_needle returns, and the volume server's GET reads
# through Store.read_needle_ex
OFF_THE_PATH = ("served",)


@pytest.fixture
def cluster_root(small_root):
    """The small root with the cluster's published blocks: its volume
    servers lay EC volumes out in 1 GiB and 1 MiB blocks."""
    path = os.path.join(small_root, "benchmark", "configs",
                        "cluster4-ec.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "cluster4-ec.json")) as f:
        full = json.load(f)
    for key in ("large_block_bytes", "small_block_bytes"):
        cfg[key] = full[key]
    with open(path, "w") as f:
        json.dump(cfg, f)
    return small_root


def run(root, seed, trace=False, fault="none", seconds=0.5):
    return harness.run_cell(root, CELL, seed, seconds, trace, fault,
                            time.perf_counter(), "cpu")


def test_the_deployment_set_up_leaves(cluster_root, cpu_port, tmp_path):
    spec = harness.load_spec(cluster_root)
    _, cfg, traffic = harness.resolve(cluster_root, spec, CELL)
    cell = harness.Cell(CELL, cfg, traffic, 2 ** 33 + 3, 0.5, False, "cpu")
    cell.built = build.build(cfg, traffic, cell.seed, str(tmp_path), "cpu")
    http_get.warm(cell)
    dep = cell.deployment
    try:
        assert cell.built.store is dep.source.vs.store
        assert [s.live for s in dep.servers] == [True, False, True, True]
        assert dep.lost is dep.servers[1] and cfg["lost_server"] == "v1"
        source, lost = dep.source.vs.url, dep.lost.vs.url
        for vid, spread in dep.shard_map.items():
            # ec.encode's 4,4,3,3 on every volume, as the config states
            assert dep.named_map(vid) == cfg["shard_map"][str(vid)]
            sizes = sorted((len(s) for s in spread.values()), reverse=True)
            assert sizes == [4, 4, 3, 3], (vid, spread)
            assert len(spread[lost]) == 4 and len(spread[source]) == 3
            assert sum(sid < 10 for sid in spread[lost]) == 3
            survivors = dep.survivors(vid)
            assert sorted(survivors) == sorted(
                sid for u, ss in spread.items() if u != lost for sid in ss)
            assert len(survivors) == 10
        # the source keeps 3 shards of each volume and fetches the rest
        assert {len(ev.shards) for ev in
                dep.source.vs.store.ec_volumes.values()} == {3}
    finally:
        dep.stop()


@pytest.mark.parametrize("stated", ["map", "lost"])
def test_set_up_refuses_a_deployment_other_than_the_stated(
        cluster_root, cpu_port, tmp_path, stated):
    """A spread that is not the configuration's shard_map, or a lost
    server that does not hold 4 shards of every volume, fails the run's
    set-up."""
    spec = harness.load_spec(cluster_root)
    _, cfg, traffic = harness.resolve(cluster_root, spec, CELL)
    if stated == "map":
        cfg["shard_map"]["2"] = cfg["shard_map"]["4"]
    else:
        cfg["lost_server"] = "v2"
    cell = harness.Cell(CELL, cfg, traffic, 2 ** 33 + 3, 0.5, False, "cpu")
    cell.built = build.build(cfg, traffic, cell.seed, str(tmp_path), "cpu")
    with pytest.raises(RuntimeError, match="configuration states"
                       if stated == "map" else "4 shards of every volume"):
        http_get.warm(cell)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(cluster_root, cpu_port, trace):
    r = run(cluster_root, 2 ** 33 + 11, trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {
        "failed_gets", "wrong_sizes", "mismatched_parts",
        "no_parts_compared", "reference_mismatches", "no_remote_fetches"}
    split = r["device"]["setup_split_s"]
    assert {"cluster_start_s", "spread_s", "server_lost_s",
            "warm_gets_s"} <= set(split)
    if not trace:
        # the host has no device trace: card_recover_GBps is left out
        assert set(r["metrics"]) == {"setup_s"}
        return
    # nor what is read on the device trace or on its clock; K1 does not
    # run on the host
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(NEW) - {"idle_fetch.http_get"} | {
        "gets_per_s.get", "recover_ms_per_get.get"}
    assert m["fetch_ms_per_get.http_get"] > 0
    assert m["fetched_MiB_per_get.http_get"] > 0
    # every live peer speaks the frame protocol
    assert m["frame_fetch_share.http_get"] == 100.0


@pytest.mark.parametrize("fault", [f for f in faults.NAMES
                                   if f != "none" and f not in OFF_THE_PATH])
def test_control_and_faults_are_not_correct(cluster_root, cpu_port, fault):
    for seed in (3, 2 ** 32 + 5, 2 ** 31 + 7):
        r = run(cluster_root, seed, fault=fault)
        assert not r["correct"], (seed, r["checks"])


@pytest.mark.parametrize("fault", OFF_THE_PATH)
def test_faults_off_the_http_path_stay_correct(cluster_root, cpu_port,
                                               fault):
    """A gap of benchmark/faults.py on this cell: its seam is not on the
    HTTP path, so the run stays correct. When a fault reaches the path,
    move it to the test above."""
    r = run(cluster_root, 2 ** 31 + 9, fault=fault)
    assert r["correct"], r["checks"]


def test_a_run_loads_neither_jax_nor_the_jax_package(cluster_root):
    code = (
        "import json, sys, time\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from benchmark import harness\n"
        f"r = harness.run_cell({cluster_root!r}, {CELL!r}, 2**33 + 1, 0.3,\n"
        "                      True, 'none', time.perf_counter(), 'cpu')\n"
        "print(json.dumps({'correct': r['correct'],\n"
        "                  'forbidden': harness.forbidden_modules()}))\n")
    env = dict(os.environ, SWTPU_TORCH_EC_BACKEND="cpu")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": []}


# -- the readers, on hand-made spans and counters


def read(run):
    return {n: harness.reader(ROOT, n)(run) for n in NEW}


def timeline():
    """One GET on one clock (offset 0), the card busy 7.2-8.5 ms: an
    intact interval fetched from a peer, then a card recover whose
    gather fetches survivors; each fetch holds the peer's shard_read
    span, joined to the GET's trace."""
    spans = [
        span("A", "a", "", "bench", "get", 0.0, 10.0),
        span("A", "a1", "a", "store", "read", 0.0, 10.0),
        span("A", "f1", "a1", "ec", "fetch", 1.0, 3.0, holder="v2",
             transport="frame", intervals=1),
        span("A", "p1", "f1", "volume", "ec.shard_read", 1.5, 2.0),
        span("A", "p2", "p1", "ec", "pread", 2.0, 0.5),
        span("A", "r", "a1", "ec", "recover", 5.0, 4.0, path="card",
             rows=2),
        span("A", "g", "r", "ec", "gather", 5.0, 2.0),
        span("A", "f2", "g", "ec", "fetch", 5.2, 1.6, holder="v3",
             transport="frame", intervals=4),
        span("A", "p3", "f2", "volume", "ec.shard_read", 5.5, 1.0),
        span("A", "h", "r", "ec", "h2d", 7.0, 0.5),
        span("A", "w", "r", "ec", "wait", 7.5, 1.5)]
    dev = [Op("Memcpy HtoD", "gpu_memcpy", 7200.0, 800.0),
           Op("gf256_transform_kernel", "kernel", 8000.0, 500.0)]
    trace = DeviceTrace(device_ops=dev, host_ops=[copy_call(7000.0)],
                        window_s=0.02)
    return spans, trace


@dataclass
class Outcome:
    requests: list = field(default_factory=list)
    fetches: dict = field(default_factory=dict)
    fetch_bytes: dict = field(default_factory=dict)


def test_span_readers_on_a_timeline_laid_by_hand():
    spans, trace = timeline()
    r = run_of(spans, trace, (0.0, 0.02))
    r.outcome = Outcome()
    got = read(r)
    assert got["fetch_ms_per_get.http_get"] == pytest.approx(3.0 + 1.6)
    # idle ms by the GET thread's innermost span, the peers' spans left
    # out: store.read 3.0, ec.fetch 3.0 + 1.6, ec.gather 0.4, ec.h2d
    # 0.5 - 0.3, ec.wait 1.5 - 1.0
    assert got["idle_fetch.http_get"] == pytest.approx(100 * 4.6 / 8.7)
    assert got["fetched_MiB_per_get.http_get"] is None
    assert got["frame_fetch_share.http_get"] is None
    # the same spans on the peers' side are not the GET thread's: with
    # them, the fetches would be left 1.6 ms of the card's idle time
    a = spanclock.of(r)
    assert a.idle_split(trace)["ec.fetch"] == pytest.approx(1600.0)


def test_span_readers_report_nothing_without_fetch_spans():
    """A program that opens no `ec.fetch` span (before they existed)."""
    spans, trace = timeline()
    spans = [s for s in spans if s["op"] != "fetch"]
    r = run_of(spans, trace, (0.0, 0.02))
    r.outcome = Outcome()
    assert read(r) == dict.fromkeys(NEW)
    r = run_of(None, None, (0.0, 0.0))
    r.outcome = Outcome()
    assert read(r) == dict.fromkeys(NEW)


def test_counter_readers():
    r = run_of(None, None, (0.0, 1.0))
    r.outcome = Outcome(requests=[(0, 1, True, 0)] * 4,
                        fetches={"frame": 30.0, "http": 10.0},
                        fetch_bytes={"frame": 7.0 * (1 << 20),
                                     "http": 1.0 * (1 << 20)})
    got = read(r)
    assert got["fetched_MiB_per_get.http_get"] == pytest.approx(2.0)
    assert got["frame_fetch_share.http_get"] == pytest.approx(75.0)
    # the program has no such counter: nothing is read
    r.outcome = Outcome(requests=[(0, 1, True, 0)],
                        fetches={"frame": None, "http": None},
                        fetch_bytes={"frame": None, "http": None})
    got = read(r)
    assert got["fetched_MiB_per_get.http_get"] is None
    assert got["frame_fetch_share.http_get"] is None
    # the counter exists and nothing was fetched
    r.outcome = Outcome(requests=[(0, 1, True, 0)],
                        fetches={"frame": 0.0, "http": 0.0},
                        fetch_bytes={"frame": 0.0, "http": 0.0})
    got = read(r)
    assert got["fetched_MiB_per_get.http_get"] == 0.0
    assert got["frame_fetch_share.http_get"] is None


def test_remote_fetch_check_reads_the_counter_else_the_peers():
    out = http_get.Outcome(samples=[], fetch_bytes={"frame": 0.0,
                                                    "http": 0.0},
                           peer_bytes=5)

    @dataclass
    class Cell:
        built: object = None
        seed: int = 1

    @dataclass
    class Built:
        plans: list = field(default_factory=list)

    cell = Cell(Built())
    assert http_get.check(cell, out)["no_remote_fetches"] == (1, 0)
    out.fetch_bytes = {"frame": 10.0, "http": 0.0}
    assert http_get.check(cell, out)["no_remote_fetches"] == (0, 0)
    # a program without the counters: the peers' stores say
    out.fetch_bytes = {"frame": None, "http": None}
    assert http_get.check(cell, out)["no_remote_fetches"] == (0, 0)
    out.peer_bytes = 0
    assert http_get.check(cell, out)["no_remote_fetches"] == (1, 0)


def test_k1_bytes_counts_every_row_of_a_card_recover():
    r = run_of([span("A", "r", "", "ec", "recover", 1.0, 1.0, path="card",
                     rows=3),
                span("A", "s", "", "ec", "recover", 2.0, 1.0, path="host",
                     rows=1)],
               None, (0.0, 0.02))
    r.spans[0]["bytes"] = 3 * (1 << 20)
    r.spans[1]["bytes"] = 1 << 19

    @dataclass
    class Cell:
        cfg: dict

    r.cell = Cell({"data_shards": 10})
    assert http_get.k1_bytes(r) == (10 + 3) * (1 << 20)
