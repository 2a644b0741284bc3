"""BENCHMARK.json is whole: every name it gives is found, and every cell
reports what the contract asks of it."""

import json
import os
import re

from benchmark import harness

from .small import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    return harness.load_spec(ROOT)


def test_files_and_names():
    s = spec()
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10
    names = [c["name"] for c in s["configs"]] \
        + [w["name"] for w in s["workloads"]] \
        + [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg["published"] and cfg[key] != \
                cfg["published"][key]
    for w in s["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        harness.resolve(ROOT, s, w["name"])
        op = json.load(open(os.path.join(
            ROOT, "benchmark", "traffic", w["traffic"] + ".json")))["op"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "ops",
                                           op + ".py"))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(s, w["name"], False)}
        layer = harness.metrics_of(s, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e
    for m in s["end_to_end"] + s["per_layer"]:
        harness.reader(ROOT, m["name"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
