"""Structured event journal (util/events.py) and its emit sites:
breaker transitions, retry-budget exhaustion, EC holder refresh —
the state transitions /debug/health correlates into violation
evidence.

The cases of tests/test_events.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

from __future__ import annotations

import asyncio

import pytest

from seaweedfs_tpu_torch.util import events, tracing
from seaweedfs_tpu_torch.util.resilience import (BreakerRegistry, CircuitBreaker,
                                           RetryBudget, RetryPolicy)


@pytest.fixture(autouse=True)
def _fresh_ring():
    events.init(ring=1024)
    events.reset()
    yield
    events.reset()


def test_record_and_query():
    events.record("volume_mount", vid=3, kind="mount")
    events.record("volume_unmount", vid=3, kind="unmount")
    out = events.events_dict()
    assert out["recorded"] == 2
    assert [e["type"] for e in out["events"]] == \
        ["volume_unmount", "volume_mount"]   # newest first
    e = out["events"][1]
    assert e["vid"] == 3 and e["wall_ms"] > 0 and "mono" in e
    # type filter + since_ms floor
    only = events.events_dict(types={"volume_mount"})
    assert [e["type"] for e in only["events"]] == ["volume_mount"]
    assert events.events_dict(
        since_ms=e["wall_ms"] + 10 ** 9)["events"] == []


def test_ring_is_bounded():
    events.init(ring=16)
    for i in range(100):
        events.record("volume_mount", vid=i)
    out = events.events_dict(n=1000)
    assert len(out["events"]) == 16
    assert out["recorded"] == 100
    assert out["events"][0]["vid"] == 99    # newest survives


def test_query_rows_are_copies_not_the_live_ring():
    # aggregators stamp worker tags on what events_dict hands out
    # (volume_server._merged_events); a caller mutation must never
    # rewrite the journal every later surface reads (regression: the
    # first merged /debug/events query permanently tagged every ring
    # row with that worker's index)
    events.record("volume_mount", vid=7)
    out = events.events_dict()
    out["events"][0]["worker"] = 3
    again = events.events_dict()
    assert "worker" not in again["events"][0]


def test_unknown_type_recorded_with_warning():
    events.record("definitely_not_a_type", x=1)
    assert events.events_dict()["events"][0]["type"] == \
        "definitely_not_a_type"


def test_trace_id_stamped_inside_span():
    tracing.init(sample=1.0)
    with tracing.start_root("volume", "read") as sp:
        events.record("holder_refresh", vid=1)
    events.record("holder_refresh", vid=2)
    rows = events.events_dict()["events"]
    assert rows[1]["trace"] == sp.trace     # inside the span
    assert rows[0]["trace"] == ""           # outside


def test_window_correlation():
    events.record("breaker_open", upstream="a")
    rows = events.events_dict()["events"]
    wall = rows[0]["wall_ms"]
    assert events.window(wall - 1, wall + 1) == rows
    assert events.window(wall - 1, wall + 1,
                         types={"scrub_corruption"}) == []


def test_merge_payloads_orders_on_wall():
    events.record("volume_mount", vid=1)
    p1 = events.events_dict()
    for r in p1["events"]:
        r["worker"] = 0
    events.record("volume_mount", vid=2)
    p2 = events.events_dict(types={"volume_mount"})
    merged = events.merge_payloads([p1, p2], n=10)
    vids = [e["vid"] for e in merged["events"]]
    assert vids[0] == 2                     # newest first across rings
    assert merged["recorded"] == p1["recorded"] + p2["recorded"]


def test_events_query_parses_and_raises():
    events.record("volume_mount", vid=1)
    out = events.events_query({"n": "5", "type": "volume_mount"})
    assert len(out["events"]) == 1
    with pytest.raises(ValueError):
        events.events_query({"n": "zz"})


# ---------------------------------------------------------------------------
# emit sites


def test_breaker_transitions_journaled():
    clock = [0.0]
    br = CircuitBreaker(threshold=2, reset_timeout=1.0,
                        clock=lambda: clock[0], name="vol:8080")
    br.record_failure()
    assert events.events_dict()["events"] == []     # not yet open
    br.record_failure()
    rows = events.events_dict()["events"]
    assert rows[0]["type"] == "breaker_open"
    assert rows[0]["upstream"] == "vol:8080"
    assert rows[0]["failures"] == 2
    clock[0] = 2.0
    assert br.allow()                               # half-open probe
    br.record_success()
    rows = events.events_dict()["events"]
    assert rows[0]["type"] == "breaker_close"
    assert rows[0]["upstream"] == "vol:8080"
    # a healthy success journals nothing
    br.record_success()
    assert events.events_dict()["events"][0]["type"] == "breaker_close"


def test_breaker_registry_names_breakers():
    reg = BreakerRegistry(threshold=1)
    b = reg.get("10.0.0.1:8080")
    assert b.name == "10.0.0.1:8080"
    b.record_failure()
    assert events.events_dict()["events"][0]["upstream"] == \
        "10.0.0.1:8080"


def test_retry_budget_exhaustion_journaled():
    budget = RetryBudget(ratio=0.0, burst=0.0)      # always empty
    policy = RetryPolicy(max_attempts=3, base_delay=0.0,
                         budget=budget, name="client.read",
                         sleep=lambda _t: asyncio.sleep(0))

    async def drive():
        attempts = 0
        async for _ in policy.attempts():
            attempts += 1
        return attempts

    assert asyncio.run(drive()) == 1                # no retry allowed
    rows = events.events_dict()["events"]
    assert rows[0]["type"] == "retry_budget_exhausted"
    assert rows[0]["name"] == "client.read"


def test_holder_refresh_journaled_and_rate_bounded():
    from seaweedfs_tpu_torch.server.ec_locations import EcLocationCache
    clock = [100.0]
    cache = EcLocationCache(lambda vid: {"0": ["a:1"]},
                            now=lambda: clock[0])
    cache.get(7)
    assert cache.invalidate(7) is True              # forced -> journaled
    assert cache.invalidate(7) is False             # suppressed window
    rows = events.events_dict(types={"holder_refresh"})["events"]
    assert len(rows) == 1 and rows[0]["vid"] == 7
    clock[0] += EcLocationCache.FRESH_S + 1
    assert cache.invalidate(7) is True
    assert len(events.events_dict(
        types={"holder_refresh"})["events"]) == 2


def test_record_never_raises(monkeypatch):
    # an emit site inside a breaker transition must survive a broken
    # metrics layer
    monkeypatch.setattr(events, "_count",
                        lambda t: (_ for _ in ()).throw(RuntimeError()))
    events.record("breaker_open", upstream="x")     # must not raise
    assert events.events_dict()["events"][0]["type"] == "breaker_open"
