"""The reader of rows_per_card_recover.get on hand-made spans: the mean
`rows` of the card's `ec.recover` spans under the window's GETs, host
recovers and spans outside the window left out, and nothing where no
card recover names its rows, as a program without row-grouped recovers
leaves them."""

from dataclasses import dataclass

import pytest

from benchmark import harness

from .small import ROOT

NAME = "rows_per_card_recover.get"


@dataclass(eq=False)
class Clock:
    trace_wall: tuple


@dataclass(eq=False)
class Run:
    spans: list | None
    clock: Clock


def span(trace, sid, parent, tier, op, start_ms, dur_ms, **attrs):
    d = {"trace": trace, "span": sid, "parent": parent, "tier": tier,
         "op": op, "status": "ok", "start_ms": start_ms, "dur_ms": dur_ms,
         "bytes": 0}
    if attrs:
        d["attrs"] = attrs
    return d


def get(trace, start_ms, recovers):
    """A GET root and its recovers, each (path, rows or None)."""
    out = [span(trace, trace, "", "bench", "get", start_ms, 50.0)]
    for i, (path, rows) in enumerate(recovers):
        attrs = {"vid": 1, "shards": list(range(10)), "path": path}
        if rows is not None:
            attrs.update(rows=rows, want=list(range(rows)))
        out.append(span(trace, f"{trace}{i}", trace, "ec", "recover",
                        start_ms + i, 1.0, **attrs))
    return out


def read(spans, wall=(1.0, 2.0)):
    return harness.reader(ROOT, NAME)(Run(spans, Clock(wall)))


def test_mean_rows_of_the_windows_card_recovers():
    spans = (get("a", 1000.0, [("card", 2), ("card", 1), ("host", 1)])
             + get("b", 1200.0, [("card", 3), ("card", 2)])
             # outside the window: before it, and running past its end
             + get("c", 900.0, [("card", 4)])
             + get("d", 1990.0, [("card", 4)]))
    assert read(spans) == pytest.approx((2 + 1 + 3 + 2) / 4)


def test_nothing_without_rows_or_without_card_recovers():
    # the parent's spans: card recovers that do not name their rows
    assert read(get("a", 1000.0, [("card", None), ("card", None)])) is None
    # host recovers alone, a window with no GET, a run with no spans
    assert read(get("a", 1000.0, [("host", 2)])) is None
    assert read(get("a", 1000.0, [("card", 2)]), wall=(3.0, 4.0)) is None
    assert read(None) is None


def test_the_metric_is_declared_for_the_cell():
    spec = harness.load_spec(ROOT)
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "rows", "better": "higher",
                 "source": "program_span",
                 "layer": "ec/ec_volume.py recover",
                 "moves": "card_recover_GBps",
                 "workloads": ["s3parts.get-4lost"]}
    assert spec["per_layer"][-1] is m
