"""The yardstick's bytes, and the device trace's busy and idle time."""

from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness, roofline
from benchmark.ops import get

MIB = 1 << 20


def test_transform_bytes_read_once_written_once():
    # a recover: 10 survivor rows of 1 MiB in, one row out
    assert roofline.transform_bytes(10, 1, MIB) == 11 * MIB
    # an encode step: 10 data rows of 4 MiB in, 4 parity rows out
    assert roofline.transform_bytes(10, 4, 4 * MIB) == 56 * MIB
    # the ratios bench-ec credits per data byte
    assert roofline.BYTES_PER_DATA_BYTE["encode_GBps"] == 14 / 10
    assert roofline.ceiling_gbps("encode_GBps") == pytest.approx(
        3350 / 1.4)


def test_roofline_share():
    nbytes = 11 * MIB
    bound = nbytes / 3.35e12
    assert roofline.roofline_share(nbytes, 2 * bound) == pytest.approx(50)
    assert roofline.roofline_share(nbytes, 0) is None
    with pytest.raises(roofline.ImplausibleResult):
        roofline.check_plausible("encode_GBps", 3000.0)


def test_k1_bytes_of_the_card_recovers():
    cell = SimpleNamespace(cfg={"data_shards": 10,
                                "small_recover_bytes": MIB})
    clock = SimpleNamespace(trace_wall=(100.0, 110.0))

    def span(op, nbytes, start=101.0, dur_ms=2.0):
        return {"tier": "ec", "op": op, "bytes": nbytes,
                "start_ms": start * 1e3, "dur_ms": dur_ms}
    spans = [span("recover", MIB), span("recover", MIB),
             span("recover", 300 << 10),           # a host recover
             span("reread", MIB),
             span("recover", MIB, start=99.0),     # before the trace
             span("recover", MIB, start=109.999, dur_ms=5.0)]
    run = SimpleNamespace(cell=cell, clock=clock, spans=spans)
    assert get.k1_bytes(run) == 2 * 11 * MIB
    assert get.k1_bytes(SimpleNamespace(spans=None)) is None


def trace():
    tr = devtrace.DeviceTrace(window_s=0.001)
    k = "void (anonymous namespace)::gf256_transform_kernel<1>(unsigned " \
        "char const*, int)"
    tr.device_ops = [devtrace.Op(k, "kernel", 100, 10),
                     devtrace.Op(k, "kernel", 105, 10),
                     devtrace.Op("Memcpy HtoD (Pinned -> Device)",
                                 "gpu_memcpy", 300, 100, 3_400_000),
                     devtrace.Op("Memcpy DtoH (Device -> Pinned)",
                                 "gpu_memcpy", 600, 50, 1_000_000)]
    tr.host_ops = [devtrace.Op("aten::pin_memory", "cpu_op", 120, 150),
                   devtrace.Op("cudaEventSynchronize", "cuda_runtime",
                               450, 140),
                   devtrace.Op("aten::copy_", "cpu_op", 0, 1000)]
    return tr


def test_busy_time_is_the_union_of_device_intervals():
    tr = trace()
    assert tr.busy_intervals() == [(100, 115), (300, 400), (600, 650)]
    assert tr.busy_s() == pytest.approx(165e-6)
    top = tr.top_device_ops()
    assert top[0] == ["Memcpy HtoD", pytest.approx(100e-6)] or \
        top[0][1] == pytest.approx(100e-6)
    assert any(name.endswith("gf256_transform_kernel<1>") and
               s == pytest.approx(20e-6) for name, s in top)


def test_idle_gaps_say_what_the_host_did():
    gaps = trace().idle_gaps()
    # gaps: 0-100, 115-300, 400-600, 650-1000
    assert [g[1] for g in gaps] == pytest.approx(
        [350e-6, 200e-6, 185e-6, 100e-6])
    by = dict((round(s * 1e6), name) for name, s in gaps)
    # the innermost op that covers half a gap names it
    assert by[185] == "host aten::pin_memory"
    assert by[200] == "host cudaEventSynchronize"
    assert by[350] == "host aten::copy_"
    tr = trace()
    tr.host_ops = []
    assert {name for name, _ in tr.idle_gaps()} == {
        "host python (no traced op)"}


def test_device_readers():
    tr = trace()
    run = harness.RunView(None, None, None, None, 0.0, None, tr)
    root = __import__("benchmark.tests.small", fromlist=["ROOT"]).ROOT
    idle = harness.reader(root, "device_idle.get")(run)
    assert idle == pytest.approx(100 * (1 - 165e-6 / 0.001))
    h2d = harness.reader(root, "h2d_GBps.get")(run)
    assert h2d == pytest.approx(3_400_000 / 100e-6 / 1e9)
    out = sum(o.nbytes for o in tr.ops("DtoH"))
    assert out > 0
    card = harness.reader(root, "card_recover_GBps")(run)
    assert card == pytest.approx(out / 165e-6 / 1e9)
    empty = harness.RunView(None, None, None, None, 0.0, None, None)
    assert harness.reader(root, "k1_roofline.get")(empty) is None
    assert harness.reader(root, "device_idle.get")(empty) is None
    assert harness.reader(root, "card_recover_GBps")(empty) is None
