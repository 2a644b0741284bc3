"""Every cell end to end on the host at a small size: correct on sound
runs, not correct with the control or any fault put in, and open to a
new cell, mix and metric added as files alone."""

import json
import os
import time

import pytest

from benchmark import faults, harness

CELLS = ("s3parts.get-4lost",)


def run(root, wl, seed, trace=False, fault="none", seconds=0.4):
    return harness.run_cell(root, wl, seed, seconds, trace, fault,
                            time.perf_counter(), "cpu")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("wl", CELLS)
def test_sound_runs_are_correct(small_root, cpu_port, wl, trace):
    r = run(small_root, wl, 2 ** 33 + 11, trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    spec = harness.load_spec(small_root)
    names = {m["name"] for m in harness.metrics_of(spec, wl, trace)}
    if not trace:
        # the host has no device trace: the card's metrics are left out
        assert set(r["metrics"]) == {
            m["name"] for m in harness.metrics_of(spec, wl, trace)
            if m["source"] != "device_trace"}
    elif wl.startswith("s3parts"):
        # the host has no device trace and counts no launches
        assert set(r["metrics"]) == {"gets_per_s.get",
                                     "recover_ms_per_get.get",
                                     "get_p95_ms." + wl}
    keys = list(r["checks"])
    assert keys and all(set(c) == {"value", "limit"}
                        for c in r["checks"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [f for f in faults.NAMES if f != "none"])
@pytest.mark.parametrize("wl", CELLS)
def test_control_and_faults_are_not_correct(small_root, cpu_port, wl,
                                            fault):
    for seed in (3, 2 ** 32 + 5, 2 ** 31 + 7):
        r = run(small_root, wl, seed, fault=fault)
        assert not r["correct"], (seed, r["checks"])


def test_a_cell_mix_and_metric_added_as_files(small_root, cpu_port):
    root = small_root
    with open(os.path.join(root, "benchmark", "traffic",
                           "get-4lost.json")) as f:
        mix = json.load(f)
    mix.update(clients=2, lost_shards=[1, 2])
    with open(os.path.join(root, "benchmark", "traffic",
                           "throwaway-2lost.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "throwaway_gets.py"), "w") as f:
        f.write("def read(run):\n"
                "    return float(len(run.outcome.requests))\n")
    spec = harness.load_spec(root)
    spec["workloads"].append({
        "name": "s3parts.throwaway", "config": "s3parts-ec",
        "traffic": "throwaway-2lost", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({
        "name": "throwaway_gets", "unit": "GETs", "better": "higher",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["s3parts.throwaway"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    r = run(root, "s3parts.throwaway", 77, seconds=0.5)
    assert r["correct"], r["checks"]
    assert r["metrics"]["throwaway_gets"]["value"] == r["attempted"] > 0
    # the metrics with no list of cells, and the one that names it
    assert set(r["metrics"]) == {"setup_s", "throwaway_gets"}
