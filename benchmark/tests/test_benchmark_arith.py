"""Rates and tails are taken over every request of the whole window."""

import threading

import pytest

from benchmark import arith
from benchmark import harness
from benchmark.ops import get


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert arith.percentile(vals, 95) == 95
    assert arith.percentile(vals, 100) == 100
    assert arith.percentile([7.0], 95) == 7.0
    assert arith.percentile(list(range(1, 21)), 95) == 19
    assert arith.percentile([], 95) is None


def test_rate():
    assert arith.rate(400, 20.0) == 20.0
    assert arith.rate(0, 20.0) is None


def view(outcome, open_, close):
    clock = harness.Clock(close - open_)
    clock.open, clock.close = open_, close
    return harness.RunView(None, get, outcome, clock, 12.5, None, None)


def test_get_rate_and_tail_cover_every_request_of_the_window():
    out = get.Outcome()
    # 100 GETs of 10 ms, 5 of 200 ms, one failed, one after the close
    out.requests = [(1.0 + i * 0.01, 1.0 + i * 0.01 + 0.01, True, 0)
                    for i in range(100)]
    out.requests += [(2.0, 2.2, True, 0)] * 5
    out.requests += [(2.3, 2.4, False, 0), (9.9, 11.5, True, 0)]
    v = view(out, 1.0, 11.0)
    rate = harness.reader(harness_root(), "gets_per_s.get")(v)
    assert rate == pytest.approx(105 / 10.0)
    p95 = harness.reader(harness_root(), "get_p95_ms.s3parts.get-4lost")(v)
    lat = sorted([10.0] * 100 + [200.0] * 5 + [100.0])
    assert p95 == pytest.approx(lat[100])   # rank ceil(0.95 * 106) = 101
    assert harness.reader(harness_root(), "setup_s")(v) == 12.5


def test_clock_window():
    c = harness.Clock(0.05)
    assert not c.go.is_set()
    c.start()
    assert c.go.is_set() and c.close == pytest.approx(c.open + 0.05)
    c.wait_close()
    c.closed()
    assert threading.active_count() >= 1


def harness_root():
    from .small import ROOT
    return ROOT


def test_host_readings_around_a_window():
    from benchmark import hostprobe
    a = hostprobe.snapshot()
    sum(i * i for i in range(200000))
    got = hostprobe.between(a, hostprobe.snapshot())
    assert set(got) == {"wall_s", "process_cpu_s", "minor_faults",
                        "major_faults", "voluntary_switches",
                        "involuntary_switches", "cores"}
    assert got["wall_s"] > 0 and got["process_cpu_s"] >= 0
    assert got["cores"] >= 1 and got["minor_faults"] >= 0
    assert hostprobe.copy_GBps() > 0
    assert hostprobe.loop_Msteps() > 0


def test_done_by_slice_counts_each_good_request_once():
    from benchmark import hostprobe
    reqs = [(0.0, 1.0, True), (0.0, 4.9, True), (0.0, 5.0, True),
            (0.0, 9.0, False), (0.0, 12.0, True), (0.0, 13.0, True)]
    assert hostprobe.done_by_slice(reqs, 0.0, 12.0) == [2, 1, 1]
