"""The harness on the card at a small size: sound runs correct, with
the device trace read, and the control and every fault not correct.
Run on the card with `python3 -m pytest -m gpu benchmark/tests`."""

import time

import pytest

from benchmark import faults, harness

CELLS = ("s3parts.get-4lost",)


def run(root, wl, seed, trace=False, fault="none"):
    return harness.run_cell(root, wl, seed, 0.5, trace, fault,
                            time.perf_counter(), "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("wl", CELLS)
def test_sound_traced_runs_on_the_card(small_root, cuda, wl):
    r = run(small_root, wl, 2 ** 33 + 21, trace=True)
    assert r["correct"], r["checks"]
    spec = harness.load_spec(small_root)
    want = {m["name"] for m in harness.metrics_of(spec, wl, True)}
    assert set(r["metrics"]) == want
    dev = r["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    for name, m in r["metrics"].items():
        if name.startswith("k1_roofline"):
            assert 0 < m["value"] <= 100, m
    assert r["breakdown"]["device_ops"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [f for f in faults.NAMES if f != "none"])
@pytest.mark.parametrize("wl", CELLS)
def test_control_and_faults_on_the_card(small_root, cuda, wl, fault):
    for seed in (13, 2 ** 32 + 15, 2 ** 31 + 17):
        r = run(small_root, wl, seed, fault=fault)
        assert not r["correct"], (seed, r["checks"])
