"""The reader of pieces_per_card_recover.get on hand-made spans: the mean
`pieces` of the card's `ec.recover` spans under the window's GETs, host
recovers and spans outside the window left out, and nothing where no
card recover names its pieces, as a program that enqueues a recover in
one piece leaves them."""

from dataclasses import dataclass

import pytest

from benchmark import harness

from .small import ROOT

NAME = "pieces_per_card_recover.get"


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
    """A GET root and its recovers, each (path, pieces or None)."""
    out = [span(trace, trace, "", "bench", "get", start_ms, 50.0)]
    for i, (path, pieces) in enumerate(recovers):
        attrs = {"vid": 1, "shards": list(range(10)), "path": path,
                 "rows": 2, "want": [0, 3]}
        if pieces is not None:
            attrs["pieces"] = pieces
        out.append(span(trace, f"{trace}{i}", trace, "ec", "recover",
                        start_ms + i, 1.0, **attrs))
    return out


def read(spans, wall=(1.0, 2.0)):
    return harness.reader(ROOT, NAME)(Run(spans, Clock(wall)))


def test_mean_pieces_of_the_windows_card_recovers():
    spans = (get("a", 1000.0, [("card", 4), ("card", 4), ("host", 1)])
             + get("b", 1200.0, [("card", 8), ("card", 2)])
             # outside the window: before it, and running past its end
             + get("c", 900.0, [("card", 1)])
             + get("d", 1990.0, [("card", 1)]))
    assert read(spans) == pytest.approx((4 + 4 + 8 + 2) / 4)


def test_nothing_without_pieces_or_without_card_recovers():
    # the parent's spans: card recovers that do not name their pieces
    assert read(get("a", 1000.0, [("card", None), ("card", None)])) is None
    # host recovers alone, a window with no GET, a run with no spans
    assert read(get("a", 1000.0, [("host", 1)])) is None
    assert read(get("a", 1000.0, [("card", 4)]), wall=(3.0, 4.0)) is None
    assert read(None) is None


def test_the_metric_is_declared_for_both_cells():
    spec = harness.load_spec(ROOT)
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "pieces", "better": "higher",
                 "source": "program_span",
                 "layer": "ec/encoder_torch.py copy enqueues",
                 "moves": "card_recover_GBps",
                 "workloads": ["s3parts.get-4lost",
                               "cluster.http-get-4lost"]}
