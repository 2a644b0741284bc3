"""Metrics timelines (stats/timeline.py): snapshot ring, histogram-
delta quantiles, whole-host merging, saturation probes, query-param
clamping (the /debug surfaces share one parser), and the
merge_metrics_texts histogram semantics the timeline merger relies on.

The cases of tests/test_timeline.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import time

import pytest

from seaweedfs_tpu_torch.stats import metrics, saturation, timeline
from seaweedfs_tpu_torch.util import tracing


@pytest.fixture(autouse=True)
def _fresh_ring():
    timeline.init(interval_s=1.0, ring=64)
    timeline.reset()
    yield
    timeline.reset()


# ---------------------------------------------------------------------------
# quantile math


def test_quantiles_linear_interpolation():
    # 100 requests: 90 under 10ms, 10 between 10ms and 100ms
    buckets = {"0.01": 90.0, "0.1": 100.0, "+Inf": 100.0}
    q = timeline.quantiles_from_buckets(buckets)
    assert q["p50"] == pytest.approx(0.01 * 50 / 90, abs=1e-6)
    # p95 = halfway through the (0.01, 0.1] bucket
    assert q["p95"] == pytest.approx(0.055, abs=1e-6)
    assert q["p99"] == pytest.approx(0.091, abs=1e-6)


def test_quantiles_inf_bucket_reports_floor():
    # everything slower than the largest finite bound: the quantile is
    # the largest finite edge — an honest "at least this slow" floor
    q = timeline.quantiles_from_buckets({"0.01": 0.0, "+Inf": 10.0})
    assert q["p99"] == 0.01


def test_quantiles_empty_and_malformed():
    assert timeline.quantiles_from_buckets({}) == {}
    assert timeline.quantiles_from_buckets({"+Inf": 0.0}) == {}
    assert timeline.quantiles_from_buckets({"junk": 1.0}) == {}


# ---------------------------------------------------------------------------
# snapshot ring


@pytest.mark.skipif(not metrics.HAVE_PROMETHEUS,
                    reason="prometheus_client unavailable")
def test_snap_counter_rates_and_hist_deltas():
    assert timeline.snap() is None          # baseline only
    metrics.CACHE_HITS.labels("timeline_test").inc(10)
    metrics.REQUEST_DURATION.labels("volume", "read", "ok").observe(0.02)
    metrics.REQUEST_DURATION.labels("volume", "read", "ok").observe(0.2)
    time.sleep(0.02)
    win = timeline.snap()
    assert win is not None
    key = 'SeaweedFS_cache_hits_total{cache="timeline_test"}'
    assert win["rates"][key] > 0
    base = ('SeaweedFS_request_duration_seconds'
            '{op="read",status="ok",tier="volume"}')
    assert win["hist"][base]["count"] == 2.0
    assert win["hist"][base]["buckets"]["+Inf"] == 2.0
    # the NEXT window must contain only new increments
    metrics.CACHE_HITS.labels("timeline_test").inc(1)
    time.sleep(0.01)
    win2 = timeline.snap()
    d = timeline.timeline_dict(n=10)
    assert len(d["windows"]) == 2
    assert base not in win2["hist"]         # no new observations
    # derived quantiles only on windows with histogram mass
    assert base in d["windows"][0]["quantiles"]
    assert d["windows"][0]["quantiles"][base]["count"] == 2.0
    assert "avg" in d["windows"][0]["quantiles"][base]


@pytest.mark.skipif(not metrics.HAVE_PROMETHEUS,
                    reason="prometheus_client unavailable")
def test_gauges_snapshot_last_value():
    timeline.snap()
    metrics.EVENTLOOP_LAG.set(0.25)
    win = timeline.snap()
    assert win["gauges"]["SeaweedFS_eventloop_lag_seconds"] == 0.25
    # build info + process start ride every window (restart detection)
    assert any(k.startswith("SeaweedFS_build_info") for k in win["gauges"])
    assert win["gauges"]["SeaweedFS_process_start_time_seconds"] > 0


def test_ring_bound():
    timeline.init(interval_s=1.0, ring=4)
    timeline.snap()
    for _ in range(10):
        timeline.snap()
    assert len(timeline.timeline_dict(n=100)["windows"]) == 4


# ---------------------------------------------------------------------------
# whole-host merge


def _mkwin(wall_s: float, rate: float, bucket_counts: dict) -> dict:
    total = max(bucket_counts.values(), default=0.0)
    return {"wall_ms": wall_s * 1000.0, "dt_s": 1.0,
            "rates": {"SeaweedFS_x_total": rate},
            "gauges": {"SeaweedFS_g": rate},
            "hist": {'SeaweedFS_request_duration_seconds'
                     '{op="read",status="ok",tier="volume"}':
                     {"buckets": dict(bucket_counts), "sum": 0.0,
                      "count": total}}}


def test_merge_aligns_and_sums():
    p1 = {"interval_s": 1.0, "ring": 64,
          "windows": [_mkwin(100.0, 5.0, {"0.01": 8, "+Inf": 10})]}
    p2 = {"interval_s": 1.0, "ring": 64,
          "windows": [_mkwin(100.3, 7.0, {"0.01": 2, "+Inf": 10})]}
    m = timeline.merge_payloads([p1, p2], n=10)
    assert len(m["windows"]) == 1           # same wall bucket
    w = m["windows"][0]
    assert w["rates"]["SeaweedFS_x_total"] == 12.0
    assert w["gauges"]["SeaweedFS_g"] == 12.0
    base = ('SeaweedFS_request_duration_seconds'
            '{op="read",status="ok",tier="volume"}')
    assert w["hist"][base]["buckets"]["+Inf"] == 20.0
    # host-level p50: 10/20 under 10ms -> exactly the 0.01 edge
    assert w["quantiles"][base]["p50"] == pytest.approx(0.01)
    # distinct wall buckets stay distinct windows
    p3 = {"interval_s": 1.0, "ring": 64,
          "windows": [_mkwin(105.0, 1.0, {"+Inf": 1})]}
    m2 = timeline.merge_payloads([p1, p3], n=10)
    assert len(m2["windows"]) == 2


def test_merge_folds_same_process_windows_before_summing():
    # a forced ?snap=1 lands a few hundred ms after the periodic snap:
    # the SAME worker contributes two windows to one wall bucket whose
    # dt_s are disjoint sub-intervals (regression: the merge summed
    # their per-second rates to ~2x the true rate and added the same
    # process's gauges twice)
    base = ('SeaweedFS_request_duration_seconds'
            '{op="read",status="ok",tier="volume"}')

    def w(wall_ms, dt, rate, fds, inf):
        return {"wall_ms": wall_ms, "dt_s": dt,
                "rates": {"SeaweedFS_x_total": rate},
                "gauges": {"SeaweedFS_open_fds": fds},
                "hist": {base: {"buckets": {"+Inf": inf}, "sum": 0.0,
                                "count": inf}}}
    # 100/s over 0.7s then 100/s over 0.3s = 100 events in the 1s
    # bucket: the honest rate is 100/s, the gauge is the newest sample
    p1 = {"interval_s": 1.0, "ring": 64, "windows": [
        w(100_100.0, 0.7, 100.0, 40, 70.0),
        w(100_400.0, 0.3, 100.0, 42, 30.0)]}
    m = timeline.merge_payloads([p1], n=10)
    assert len(m["windows"]) == 1
    win = m["windows"][0]
    assert win["rates"]["SeaweedFS_x_total"] == pytest.approx(100.0)
    assert win["gauges"]["SeaweedFS_open_fds"] == 42
    assert win["hist"][base]["buckets"]["+Inf"] == 100.0
    assert win["hist"][base]["count"] == 100.0
    # a second WORKER in the same bucket still sums across processes
    p2 = {"interval_s": 1.0, "ring": 64,
          "windows": [w(100_200.0, 1.0, 50.0, 10, 50.0)]}
    win2 = timeline.merge_payloads([p1, p2], n=10)["windows"][0]
    assert win2["rates"]["SeaweedFS_x_total"] == pytest.approx(150.0)
    assert win2["gauges"]["SeaweedFS_open_fds"] == 52
    assert win2["hist"][base]["buckets"]["+Inf"] == 150.0


def test_merge_non_additive_gauges_take_max():
    # every worker samples the SAME filesystem and its OWN event loop:
    # summing would report a half-full disk as empty-on-paper and two
    # 50ms loop lags as one 100ms lag (regression: merge used to sum
    # every gauge unconditionally)
    def win(free, lag, fds, start):
        return {"wall_ms": 100_000.0, "dt_s": 1.0, "rates": {},
                "gauges": {
                    'SeaweedFS_disk_free_bytes{path="/data"}': free,
                    "SeaweedFS_eventloop_lag_seconds": lag,
                    "SeaweedFS_executor_wait_seconds": lag / 2,
                    'SeaweedFS_build_info{pyver="3.10",version="0.1.0"}': 1,
                    "SeaweedFS_process_start_time_seconds": start,
                    "SeaweedFS_open_fds": fds},
                "hist": {}}
    p1 = {"interval_s": 1.0, "ring": 64,
          "windows": [win(1e9, 0.05, 40, 1.75e9)]}
    p2 = {"interval_s": 1.0, "ring": 64,
          "windows": [win(1e9, 0.02, 60, 1.75e9 + 30)]}
    w = timeline.merge_payloads([p1, p2], n=10)["windows"][0]
    g = w["gauges"]
    assert g['SeaweedFS_disk_free_bytes{path="/data"}'] == 1e9
    assert g["SeaweedFS_eventloop_lag_seconds"] == 0.05
    assert g["SeaweedFS_executor_wait_seconds"] == 0.025
    # build identity stays the constant 1; start time is the youngest
    # worker's birth (ANY respawn moves it), never a summed timestamp
    assert g['SeaweedFS_build_info{pyver="3.10",version="0.1.0"}'] == 1
    assert g["SeaweedFS_process_start_time_seconds"] == 1.75e9 + 30
    # per-process resources still sum like /metrics
    assert g["SeaweedFS_open_fds"] == 100


# ---------------------------------------------------------------------------
# query-param clamping (regression: ?n=/?slowest= were unguarded)


def test_traces_query_clamps_negative_and_huge():
    tracing.init(sample=1.0)
    tracing.reset()
    with tracing.start_root("volume", "read"):
        pass
    out = tracing.traces_query({"n": "-5", "slowest": "-1"})
    assert out["traces"] == [] and out["slowest"] == []
    out = tracing.traces_query({"n": "999999999", "slowest": "10**9"
                                if False else "999999999"})
    assert len(out["traces"]) <= tracing.MAX_QUERY_COUNT
    with pytest.raises(ValueError):
        tracing.traces_query({"n": "bogus"})
    assert tracing.clamp_count(-7) == 0
    assert tracing.clamp_count(10 ** 9) == tracing.MAX_QUERY_COUNT


def test_timeline_query_clamps():
    timeline.snap()
    timeline.snap()
    assert timeline.timeline_dict(n=-3)["windows"] == []
    assert len(timeline.timeline_dict(n=10 ** 9)["windows"]) == 1
    with pytest.raises(ValueError):
        timeline.timeline_query({"n": "x"})


# ---------------------------------------------------------------------------
# saturation probes


@pytest.mark.skipif(not metrics.HAVE_PROMETHEUS,
                    reason="prometheus_client unavailable")
def test_saturation_probes_set_gauges(tmp_path):
    saturation.note_loop_lag(0.5)
    saturation.note_loop_lag(0.1)       # max wins
    saturation.sample_loop_lag()
    timeline.snap()
    win = timeline.snap()
    assert win["gauges"]["SeaweedFS_eventloop_lag_seconds"] == 0.5
    # flushing resets the max
    saturation.sample_loop_lag()
    win = timeline.snap()
    assert win["gauges"]["SeaweedFS_eventloop_lag_seconds"] == 0.0
    saturation.sample_process()
    probe = saturation.disk_probe([str(tmp_path)])
    probe()
    win = timeline.snap()
    assert win["gauges"].get("SeaweedFS_open_fds", 0) > 0
    key = f'SeaweedFS_disk_free_bytes{{path="{tmp_path}"}}'
    assert win["gauges"][key] > 0


@pytest.mark.skipif(not metrics.HAVE_PROMETHEUS,
                    reason="prometheus_client unavailable")
def test_cache_budget_gauge():
    from seaweedfs_tpu_torch.util.chunk_cache import LruByteCache
    LruByteCache(12345, name="budget_test")
    timeline.snap()
    win = timeline.snap()
    assert win["gauges"][
        'SeaweedFS_cache_budget_bytes{cache="budget_test"}'] == 12345


# ---------------------------------------------------------------------------
# merge_metrics_texts histogram semantics (the timeline merger's
# sibling: both must sum buckets per key and keep sum/count consistent)


@pytest.mark.skipif(not metrics.HAVE_PROMETHEUS,
                    reason="prometheus_client unavailable")
def test_merge_metrics_texts_histograms():
    t1 = (b"# HELP SeaweedFS_h_seconds h\n"
          b"# TYPE SeaweedFS_h_seconds histogram\n"
          b'SeaweedFS_h_seconds_bucket{le="0.01"} 3\n'
          b'SeaweedFS_h_seconds_bucket{le="0.1"} 5\n'
          b'SeaweedFS_h_seconds_bucket{le="+Inf"} 6\n'
          b"SeaweedFS_h_seconds_sum 0.5\n"
          b"SeaweedFS_h_seconds_count 6\n")
    t2 = (b"# HELP SeaweedFS_h_seconds h\n"
          b"# TYPE SeaweedFS_h_seconds histogram\n"
          b'SeaweedFS_h_seconds_bucket{le="0.01"} 1\n'
          b'SeaweedFS_h_seconds_bucket{le="0.1"} 1\n'
          b'SeaweedFS_h_seconds_bucket{le="+Inf"} 4\n'
          b"SeaweedFS_h_seconds_sum 2.25\n"
          b"SeaweedFS_h_seconds_count 4\n")
    from seaweedfs_tpu_torch.stats.metrics import merge_metrics_texts
    merged = merge_metrics_texts([t1, t2]).decode()
    lines = dict(ln.rsplit(" ", 1) for ln in merged.splitlines()
                 if not ln.startswith("#"))
    # buckets summed per le, INCLUDING +Inf
    assert lines['SeaweedFS_h_seconds_bucket{le="0.01"}'] == "4"
    assert lines['SeaweedFS_h_seconds_bucket{le="0.1"}'] == "6"
    assert lines['SeaweedFS_h_seconds_bucket{le="+Inf"}'] == "10"
    # sum/count consistency: count == +Inf bucket, sum is the float sum
    assert lines["SeaweedFS_h_seconds_count"] == "10"
    assert float(lines["SeaweedFS_h_seconds_sum"]) == pytest.approx(2.75)
    # cumulative monotonicity survives the merge
    assert (float(lines['SeaweedFS_h_seconds_bucket{le="0.01"}'])
            <= float(lines['SeaweedFS_h_seconds_bucket{le="0.1"}'])
            <= float(lines['SeaweedFS_h_seconds_bucket{le="+Inf"}']))
    # parses back through the reference text parser
    from prometheus_client.parser import text_string_to_metric_families
    fams = {f.name: f for f in
            text_string_to_metric_families(merged + "\n")}
    h = fams["SeaweedFS_h_seconds"]
    by_le = {s.labels.get("le"): s.value for s in h.samples
             if s.name.endswith("_bucket")}
    assert by_le == {"0.01": 4.0, "0.1": 6.0, "+Inf": 10.0}


@pytest.mark.skipif(not metrics.HAVE_PROMETHEUS,
                    reason="prometheus_client unavailable")
def test_merge_metrics_texts_histogram_bucket_misalignment():
    # a worker exporting an extra bucket edge (version skew) must not
    # corrupt the shared edges: each le key sums independently
    t1 = (b'SeaweedFS_h2_seconds_bucket{le="0.01"} 2\n'
          b'SeaweedFS_h2_seconds_bucket{le="+Inf"} 2\n'
          b"SeaweedFS_h2_seconds_count 2\n")
    t2 = (b'SeaweedFS_h2_seconds_bucket{le="0.01"} 1\n'
          b'SeaweedFS_h2_seconds_bucket{le="0.05"} 3\n'
          b'SeaweedFS_h2_seconds_bucket{le="+Inf"} 3\n'
          b"SeaweedFS_h2_seconds_count 3\n")
    from seaweedfs_tpu_torch.stats.metrics import merge_metrics_texts
    merged = merge_metrics_texts([t1, t2]).decode()
    lines = dict(ln.rsplit(" ", 1) for ln in merged.splitlines())
    assert lines['SeaweedFS_h2_seconds_bucket{le="0.01"}'] == "3"
    assert lines['SeaweedFS_h2_seconds_bucket{le="0.05"}'] == "3"
    assert lines['SeaweedFS_h2_seconds_bucket{le="+Inf"}'] == "5"
    assert lines["SeaweedFS_h2_seconds_count"] == "5"


def test_merge_metrics_texts_non_additive_gauges():
    # the scrape merge shares the timeline's non-additive policy: a
    # merged build_info must stay 1 and a merged start time must be an
    # actual birth instant (regression: both were summed, reporting
    # build_info=2 and a ~3.5e9 "start time" for a 2-worker host)
    t1 = (b'SeaweedFS_build_info{pyver="3.10",version="0.1.0"} 1\n'
          b"SeaweedFS_process_start_time_seconds 1750000000.25\n"
          b'SeaweedFS_disk_free_bytes{path="/data"} 1000000000\n'
          b"SeaweedFS_eventloop_lag_seconds 0.05\n"
          b"SeaweedFS_open_fds 40\n")
    t2 = (b'SeaweedFS_build_info{pyver="3.10",version="0.1.0"} 1\n'
          b"SeaweedFS_process_start_time_seconds 1750000030.5\n"
          b'SeaweedFS_disk_free_bytes{path="/data"} 1000000000\n'
          b"SeaweedFS_eventloop_lag_seconds 0.02\n"
          b"SeaweedFS_open_fds 60\n")
    from seaweedfs_tpu_torch.stats.metrics import merge_metrics_texts
    merged = merge_metrics_texts([t1, t2]).decode()
    lines = dict(ln.rsplit(" ", 1) for ln in merged.splitlines())
    assert lines['SeaweedFS_build_info{pyver="3.10",version="0.1.0"}'] == "1"
    assert lines["SeaweedFS_process_start_time_seconds"] == "1750000030.5"
    assert lines['SeaweedFS_disk_free_bytes{path="/data"}'] == "1000000000"
    assert lines["SeaweedFS_eventloop_lag_seconds"] == "0.05"
    # per-process resources still sum
    assert lines["SeaweedFS_open_fds"] == "100"


# ---------------------------------------------------------------------------
# exemplars: each window links its worst trace per (tier, op)


def test_snap_attaches_worst_trace_exemplars():
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    timeline.snap()                         # baseline drains + drops
    with tracing.start_root("volume", "read") as fast:
        time.sleep(0.002)
    with tracing.start_root("volume", "read") as slow:
        time.sleep(0.03)
    win = timeline.snap()
    ex = win.get("exemplars", {})
    assert "volume.read" in ex, win.keys()
    # the WORST trace of the window wins the exemplar slot
    assert ex["volume.read"]["trace"] == slow.trace != fast.trace
    assert ex["volume.read"]["dur_ms"] >= 25.0
    # drained: the next window starts fresh
    win2 = timeline.snap()
    assert "exemplars" not in win2
    tracing.reset()


def _exwin(wall_s: float, trace: str, dur: float) -> dict:
    return {"wall_ms": wall_s * 1000.0, "dt_s": 1.0, "rates": {},
            "gauges": {}, "hist": {},
            "exemplars": {"s3.get": {"trace": trace, "dur_ms": dur}}}


def test_merge_keeps_max_duration_exemplar_per_key():
    # cross-process merge: the slower host's trace wins the key
    p1 = {"interval_s": 1.0, "ring": 64,
          "windows": [_exwin(100.0, "aa" * 16, 10.0)]}
    p2 = {"interval_s": 1.0, "ring": 64,
          "windows": [_exwin(100.2, "bb" * 16, 90.0)]}
    m = timeline.merge_payloads([p1, p2], n=10)
    assert len(m["windows"]) == 1
    assert m["windows"][0]["exemplars"]["s3.get"] == {
        "trace": "bb" * 16, "dur_ms": 90.0}
    # same-process fold (forced ?snap=1 sub-windows) keeps the max too
    p3 = {"interval_s": 1.0, "ring": 64,
          "windows": [_exwin(100.0, "cc" * 16, 50.0),
                      _exwin(100.4, "dd" * 16, 20.0)]}
    m2 = timeline.merge_payloads([p3], n=10)
    assert m2["windows"][0]["exemplars"]["s3.get"]["trace"] == "cc" * 16
