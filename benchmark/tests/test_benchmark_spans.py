"""The program's spans on the device trace's clock (benchmark/spanclock.py)
and the nine readers built on it, on hand-made traces and spans: the
offset is found within a microsecond through runtime calls out of order
and one call late behind the GIL, the idle shares come out exactly on a
timeline laid by hand, and every reader reports nothing without the
trace's runtime calls and 0 where the alignment stands but the spans it
reads are absent."""

import random
from dataclasses import dataclass

import pytest

from benchmark import harness, spanclock
from benchmark.devtrace import DeviceTrace, Op

from .small import ROOT

NEW = ("lock_wait_ms_per_get.get", "shard_read_ms_per_get.get",
       "stage_ms_per_recover.get", "enqueue_ms_per_recover.get",
       "card_wait_ms_per_recover.get", "host_recover_ms_per_get.get",
       "idle_lock_wait.get", "idle_shard_reads.get", "idle_staging.get")


def span(trace, sid, parent, tier, op, start_ms, dur_ms, **attrs):
    d = {"trace": trace, "span": sid, "parent": parent, "tier": tier,
         "op": op, "status": "ok", "start_ms": round(start_ms, 3),
         "dur_ms": round(dur_ms, 3), "bytes": 0}
    if attrs:
        d["attrs"] = attrs
    return d


def copy_call(ts_us, dur_us=4.0):
    return Op("cudaMemcpyAsync", "cuda_runtime", ts_us, dur_us)


@dataclass(eq=False)
class Clock:
    trace_wall: tuple


@dataclass(eq=False)
class Run:
    """What the readers read of a run (harness.RunView)."""
    spans: list | None
    trace: DeviceTrace | None
    clock: Clock


def run_of(spans, trace, wall):
    return Run(spans, trace, Clock(wall))


def read(run):
    return {n: harness.reader(ROOT, n)(run) for n in NEW}


# the host's wall clock at the window, and a profiler clock that starts
# near 0: the offset between them is whole microseconds, as a dropped
# base of whole nanoseconds leaves it
W0 = 1_760_000_000.0
DELTA = 4321.0 - W0 * 1e6


def test_offset_found_through_disorder_and_a_late_call():
    r = random.Random(7)
    spans, ops = [], []
    n = 300
    t = W0 * 1e3 + 5.0                         # ms, host wall clock
    for k in range(n):
        t += r.uniform(3.0, 12.0)
        lag = 0.0 if k % 5 == 0 else r.uniform(1.0, 9.0)    # us
        dur = 0.020
        if k == 101:                           # lost the GIL: 3 ms late
            lag, dur = 3000.0, 3.030
        h2d = span(f"t{k}", f"h{k}", f"r{k}", "ec", "h2d", t, dur)
        spans.append(h2d)
        ops.append(copy_call(h2d["start_ms"] * 1e3 + DELTA + lag))
        d2h = span(f"t{k}", f"d{k}", f"r{k}", "ec", "d2h",
                   t + r.uniform(0.5, 2.5), 0.015)
        spans.append(d2h)
        if k != 200:                           # one copy out not traced
            ops.append(copy_call(d2h["start_ms"] * 1e3 + DELTA + 2.0))
        # other runtime calls, and copies of other threads between spans
        ops.append(Op("cudaLaunchKernel", "cuda_runtime",
                      h2d["start_ms"] * 1e3 + DELTA + 40.0, 5.0))
        ops.append(copy_call((t + 2.8) * 1e3 + DELTA))
    # the trace's events come out of order
    for _ in range(40):
        i, j = r.randrange(len(ops)), r.randrange(len(ops))
        ops[i], ops[j] = ops[j], ops[i]
    trace = DeviceTrace(host_ops=ops, window_s=4.0)
    a = spanclock.align(spans, trace, (W0, W0 + 4.0))
    assert a is not None
    assert abs(a.delta_us - DELTA) <= 1.0
    assert a.matched == 1.0 and a.anchors == n
    p25, p50, p75, p99 = a.residual_us
    assert -1.0 <= p25 <= p50 <= p75 <= 9.5 and p99 <= 3000.5


def test_too_few_matches_align_nothing():
    spans = [span("t", f"h{k}", "r", "ec", "h2d", W0 * 1e3 + k, 0.02)
             for k in range(100)]
    # two of the hundred copies in are not in the trace: 98% matched
    ops = [copy_call(s["start_ms"] * 1e3 + DELTA) for s in spans[2:]]
    trace = DeviceTrace(host_ops=ops, window_s=1.0)
    assert spanclock.align(spans, trace, (W0, W0 + 1.0)) is None
    ops += [copy_call(spans[1]["start_ms"] * 1e3 + DELTA)]
    a = spanclock.align(spans, DeviceTrace(host_ops=ops, window_s=1.0),
                        (W0, W0 + 1.0))
    assert a is not None and a.matched == 0.99


def timeline():
    """Two GETs on one clock (offset 0), the card busy 2.0-2.5 ms and
    6.8-8.0 ms. GET A: its lock wait, an intact pread, a card recover
    (gather, staging, the copy in, the wait); GET B: its lock wait and a
    host recover."""
    a = [span("A", "a", "", "bench", "get", 0.0, 10.0),
         span("A", "a1", "a", "store", "read", 0.5, 9.0),
         span("A", "a2", "a1", "ec", "lock_wait", 1.0, 3.0),
         span("A", "a3", "a1", "ec", "pread", 4.0, 1.0),
         span("A", "a4", "a1", "ec", "recover", 5.0, 4.0, path="card"),
         span("A", "a5", "a4", "ec", "gather", 5.0, 1.0),
         span("A", "a6", "a4", "ec", "stage", 6.0, 0.5),
         span("A", "a7", "a4", "ec", "h2d", 6.5, 0.5),
         span("A", "a8", "a4", "ec", "wait", 7.0, 1.5)]
    b = [span("B", "b", "", "bench", "get", 0.0, 3.0),
         span("B", "b1", "b", "ec", "lock_wait", 0.0, 2.0),
         span("B", "b2", "b", "ec", "recover", 2.0, 1.0, path="host"),
         span("B", "b3", "b2", "ec", "gather", 2.0, 0.4)]
    dev = [Op("Memcpy HtoD", "gpu_memcpy", 6800.0, 700.0),
           Op("gf256_transform_kernel", "kernel", 7400.0, 600.0),
           Op("Memcpy DtoH", "gpu_memcpy", 2000.0, 500.0)]
    host = [copy_call(6500.0)]
    return a + b, DeviceTrace(device_ops=dev, host_ops=host, window_s=0.02)


def test_idle_shares_on_a_timeline_laid_by_hand():
    spans, trace = timeline()
    run = run_of(spans, trace, (0.0, 0.02))
    a = spanclock.of(run)
    assert a.delta_us == 0.0 and a.matched == 1.0
    # microseconds while the card was idle, by innermost span
    assert a.idle_split(trace) == pytest.approx({
        "bench.get": 1000.0, "store.read": 1000.0,
        "ec.lock_wait": 2500.0 + 2000.0, "ec.pread": 1000.0,
        "ec.gather": 1000.0 + 0.0, "ec.stage": 500.0, "ec.h2d": 300.0,
        "ec.wait": 500.0, "ec.recover.card": 500.0,
        "ec.recover.host": 500.0}, abs=1e-6)
    total = 10800.0
    got = read(run)
    assert got == pytest.approx({
        "lock_wait_ms_per_get.get": (3.0 + 2.0) / 2,
        "shard_read_ms_per_get.get": (1.0 + 1.0 + 0.4) / 2,
        "stage_ms_per_recover.get": 0.5,
        "enqueue_ms_per_recover.get": 0.5,
        "card_wait_ms_per_recover.get": 1.5,
        "host_recover_ms_per_get.get": (1.0 - 0.4) / 2,
        "idle_lock_wait.get": 100 * 4500.0 / total,
        "idle_shard_reads.get": 100 * 2000.0 / total,
        "idle_staging.get": 100 * 800.0 / total}, abs=1e-9)


def test_readers_report_nothing_without_runtime_calls():
    spans, trace = timeline()
    for tr in (None, DeviceTrace(device_ops=trace.device_ops,
                                 window_s=0.02)):
        assert read(run_of(spans, tr, (0.0, 0.02))) == dict.fromkeys(NEW)
    # a host run: no spans at all
    assert read(run_of(None, None, (0.0, 0.0))) == dict.fromkeys(NEW)


def test_readers_report_zero_where_the_spans_are_absent():
    """The alignment stands on one copy in, but no GET root lies in the
    window: every reader gives 0, as on a card's run that served none."""
    spans = [span("X", "x", "", "ec", "h2d", 6.5, 0.5)]
    trace = DeviceTrace(host_ops=[copy_call(6500.0)], window_s=0.02)
    run = run_of(spans, trace, (0.0, 0.02))
    assert spanclock.of(run) is not None
    assert read(run) == dict.fromkeys(NEW, 0.0)
