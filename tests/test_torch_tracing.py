"""util/tracing.py span recorder + the observability satellites:
traceparent parse/format, context parenthood, ring + in-flight
introspection payloads, cross-worker merge, the no-op fast path,
slow-request logging, the prometheus bridge, metrics push-loop error
accounting, merged-metrics integer formatting, and per-worker pprof
dump paths.

The cases of tests/test_tracing.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu_torch.util import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_tracing():
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()
    yield
    tracing.init(sample=1.0, slow_ms=0.0)
    tracing.reset()


# ---------------------------------------------------------------------------
# traceparent


def test_traceparent_roundtrip():
    with tracing.start_root("volume", "read") as sp:
        tp = sp.traceparent()
    parsed = tracing.parse_traceparent(tp)
    assert parsed is not None
    trace, parent, flags = parsed
    assert trace == sp.trace and parent == sp.span_id and flags & 1


@pytest.mark.parametrize("bad", [
    "", "00", "00-short-span-01", "zz-" + "0" * 32 + "-" + "1" * 16,
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "ff-" + "0" * 32 + "-" + "1" * 16 + "-01",
])
def test_traceparent_malformed(bad):
    assert tracing.parse_traceparent(bad) is None


def test_unsampled_traceparent_is_noop():
    tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-00"
    assert not tracing.start_root("volume", "read", traceparent=tp)


def test_incoming_sampled_trace_joins_even_at_sample_zero():
    tracing.init(sample=0.0)
    assert not tracing.start_root("volume", "read")   # local roll: off
    tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    sp = tracing.start_root("volume", "read", traceparent=tp)
    assert sp and sp.trace == "a" * 32 and sp.parent == "b" * 16
    sp.cancel()


# ---------------------------------------------------------------------------
# parenthood + ring payloads


def test_child_spans_nest_and_self_time_sums_to_wall():
    with tracing.start_root("s3", "get") as root:
        with tracing.start("filer", "stream") as mid:
            with tracing.start("client", "read") as leaf:
                leaf.nbytes = 42
            assert leaf.trace == root.trace
            assert leaf.parent == mid.span_id
        assert mid.parent == root.span_id
    d = tracing.traces_dict()
    assert d["spans"] == 3 and len(d["traces"]) == 1
    g = d["traces"][0]
    assert g["trace_id"] == root.trace
    # non-overlapping attribution: per-span self time sums to ~the
    # trace's wall time
    assert abs(sum(s["self_ms"] for s in g["spans"]) - g["dur_ms"]) < 1.0
    assert set(g["tiers"]) == {"s3", "filer", "client"}


def test_no_active_parent_means_noop_child():
    assert not tracing.start("store", "read")


def test_events_and_attrs_recorded_and_bounded():
    with tracing.start_root("client", "read", fid="3,01ab") as sp:
        for i in range(200):
            sp.event("retry", attempt=i)
        sp.set("source", "cache")
    g = tracing.traces_dict()["traces"][0]
    s = g["spans"][0]
    assert s["attrs"]["fid"] == "3,01ab"
    assert s["attrs"]["source"] == "cache"
    assert len(s["events"]) == 64          # bounded
    assert s["events"][0]["name"] == "retry"
    assert "t_ms" in s["events"][0]


def test_cancel_discards_span():
    sp = tracing.start_root("volume", "read")
    sp.cancel()
    sp.finish()
    assert tracing.traces_dict()["spans"] == 0
    assert tracing.requests_dict()["inflight"] == 0


def test_requests_dict_shows_inflight_with_age():
    sp = tracing.start_root("volume", "read")
    try:
        time.sleep(0.01)
        r = tracing.requests_dict()
        assert r["inflight"] == 1
        assert r["requests"][0]["tier"] == "volume"
        assert r["requests"][0]["age_ms"] >= 10
    finally:
        sp.finish()
    assert tracing.requests_dict()["inflight"] == 0


def test_explicit_status_survives_exception_exit():
    with pytest.raises(ValueError):
        with tracing.start_root("volume", "read") as sp:
            sp.status = "404"
            raise ValueError("gone")
    s = tracing.traces_dict()["traces"][0]["spans"][0]
    assert s["status"] == "404"
    with pytest.raises(ValueError):
        with tracing.start_root("volume", "read"):
            raise ValueError("boom")
    statuses = {s["status"]
                for g in tracing.traces_dict()["traces"]
                for s in g["spans"]}
    assert "error" in statuses


def test_ring_is_bounded():
    tracing.init(sample=1.0, ring=32)
    for _ in range(100):
        tracing.start_root("volume", "read").finish()
    assert tracing.traces_dict(recent=1000)["spans"] == 32
    tracing.init(sample=1.0, ring=2048)


def test_traces_query_clamps_zero_and_negative_counts():
    for _ in range(3):
        tracing.start_root("volume", "read").finish()
    full = tracing.traces_dict()
    assert len(full["traces"]) == 3
    # ?n=0 must be EMPTY (a -0 slice would return the whole ring)
    z = tracing.traces_query({"n": "0", "slowest": "0"})
    assert z["traces"] == [] and z["slowest"] == []
    neg = tracing.traces_query({"n": "-5", "slowest": "-1"})
    assert neg["traces"] == [] and neg["slowest"] == []
    with pytest.raises(ValueError):
        tracing.traces_query({"n": "bogus"})


def test_merge_payloads_dedupes_and_merges():
    with tracing.start_root("volume", "read") as a:
        pass
    p1 = tracing.traces_dict()
    tracing.reset()
    # a second "worker" carries a different span of the SAME trace
    with tracing.start_root("volume", "read",
                            traceparent=a.traceparent()):
        with tracing.start("store", "read"):
            pass
    p2 = tracing.traces_dict()
    merged = tracing.merge_payloads([p1, p2, p2])   # p2 twice: dedupe
    assert merged["spans"] == 3
    assert len(merged["traces"]) == 1
    assert merged["traces"][0]["trace_id"] == a.trace


def test_executor_context_propagation_pattern():
    """The volume server carries the request context into executor
    threads via contextvars.copy_context — store spans must parent
    under the request span."""
    import contextvars

    async def body():
        with tracing.start_root("volume", "read") as root:
            ctx = contextvars.copy_context()

            def work():
                with tracing.start("store", "read") as sp:
                    sp.set("source", "pread")

            await asyncio.get_running_loop().run_in_executor(
                None, lambda: ctx.run(work))
        return root

    root = asyncio.run(body())
    g = tracing.traces_dict()["traces"][0]
    store = [s for s in g["spans"] if s["tier"] == "store"][0]
    assert store["parent"] == root.span_id


def test_slow_request_glog_line(capsys):
    tracing.init(sample=1.0, slow_ms=1.0)
    with tracing.start_root("volume", "read"):
        time.sleep(0.01)
    err = capsys.readouterr().err
    assert "slow request" in err and "trace=" in err
    # child spans of a fast parent never log
    tracing.init(sample=1.0, slow_ms=10_000.0)
    with tracing.start_root("volume", "read"):
        pass
    assert "slow request" not in capsys.readouterr().err


def test_prometheus_histogram_agrees_with_ring():
    metrics = pytest.importorskip("seaweedfs_tpu_torch.stats.metrics")
    if not metrics.HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")
    before = metrics.REQUEST_DURATION.labels(
        "testtier", "testop", "ok")._sum.get()
    with tracing.start_root("testtier", "testop"):
        pass
    after = metrics.REQUEST_DURATION.labels(
        "testtier", "testop", "ok")._sum.get()
    assert after > before


# ---------------------------------------------------------------------------
# satellites: metrics push loop, merge formatting, pprof


def test_push_loop_counts_and_logs_failures(capsys, monkeypatch):
    metrics = pytest.importorskip("seaweedfs_tpu_torch.stats.metrics")
    if not metrics.HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")

    async def body():
        # unresolvable gateway: every push fails fast-ish; two loop
        # turns prove the counter moves and the first failure logs
        task = asyncio.get_event_loop().create_task(
            metrics.push_loop("127.0.0.1:1", "testjob",
                              interval_seconds=0.05))
        for _ in range(100):
            await asyncio.sleep(0.05)
            if metrics.METRICS_PUSH_ERRORS._value.get() >= 1:
                break
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    before = metrics.METRICS_PUSH_ERRORS._value.get()
    asyncio.run(body())
    assert metrics.METRICS_PUSH_ERRORS._value.get() > before
    assert "metrics push to 127.0.0.1:1 failed" in capsys.readouterr().err


def test_merge_metrics_integer_roundtrip_with_histograms():
    prometheus_client = pytest.importorskip("prometheus_client")
    from prometheus_client import CollectorRegistry, Histogram
    from prometheus_client.parser import text_string_to_metric_families
    from seaweedfs_tpu_torch.stats.metrics import merge_metrics_texts

    texts = []
    for observations in ([0.1, 0.2, 3.0], [0.4]):
        reg = CollectorRegistry()
        h = Histogram("SeaweedFS_test_merge_seconds", "merge test",
                      registry=reg)
        for v in observations:
            h.observe(v)
        texts.append(prometheus_client.generate_latest(reg))
    merged = merge_metrics_texts(texts).decode()
    # bucket/count values are integral: no trailing .0, no exponent
    for line in merged.splitlines():
        if line.startswith("SeaweedFS_test_merge_seconds_count"):
            assert line.endswith(" 4"), line
        if line.startswith("SeaweedFS_test_merge_seconds_bucket"):
            val = line.rsplit(" ", 1)[1]
            assert "." not in val and "e" not in val, line
    # and the merged exposition still parses as prometheus text
    fams = {f.name: f for f in
            text_string_to_metric_families(merged)}
    fam = fams["SeaweedFS_test_merge_seconds"]
    samples = {(s.name, s.labels.get("le")): s.value
               for s in fam.samples}
    assert samples[("SeaweedFS_test_merge_seconds_count", None)] == 4
    assert samples[("SeaweedFS_test_merge_seconds_sum", None)] == \
        pytest.approx(3.7)
    # a large counter sum renders as plain digits, never 9.0072e+15
    big = merge_metrics_texts(
        [b"c_total 9007199254740992.0\n", b"c_total 1024.0\n"]).decode()
    assert big.startswith("c_total 9007199254742016\n"), big


def test_pprof_worker_suffix(tmp_path):
    from seaweedfs_tpu_torch.util.pprof import profile_path
    assert profile_path("/x/prof.out", -1) == "/x/prof.out"
    assert profile_path("/x/prof.out", 2) == "/x/prof.out.w2"

    # smoke: the dump file actually appears at the suffixed path when
    # a profiled process exits (atexit-driven, so a real subprocess)
    cpu = tmp_path / "cpu.prof"
    code = (
        "from seaweedfs_tpu_torch.util.pprof import setup_profiling\n"
        f"setup_profiling({str(cpu)!r}, worker_index=1)\n"
        "sum(range(1000))\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=60)
    assert (tmp_path / "cpu.prof.w1").exists()
    assert not cpu.exists()
    import pstats
    pstats.Stats(str(tmp_path / "cpu.prof.w1"))  # parseable dump
