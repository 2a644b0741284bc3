"""SLO burn-rate engine (stats/slo.py): spec grammar, exact
over-threshold fractions from histogram deltas, multi-window page/warn
verdicts, the min-count guard, and evidence correlation (violating
slice + journal events + worst trace).

The cases of tests/test_slo.py pointed at the port's stats/slo.py, its
timeline, metrics, events and tracing registries and its CLI. Each case
also runs the JAX package's stats/slo.py on the same specs, windows,
events and clock and holds the port's answer equal to it; seeded random
windows and specs do the same beyond the cases' own constants."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from seaweedfs_tpu.stats import slo as ref_slo
from seaweedfs_tpu.util import events as ref_events
from seaweedfs_tpu.util import tracing as ref_tracing
from seaweedfs_tpu_torch.stats import slo
from seaweedfs_tpu_torch.util import events, tracing


@pytest.fixture(autouse=True)
def _fresh():
    for ev, tr in ((events, tracing), (ref_events, ref_tracing)):
        ev.reset()
        tr.init(sample=1.0)
        tr.reset()
    yield
    for ev, tr, mod in ((events, tracing, slo),
                        (ref_events, ref_tracing, ref_slo)):
        ev.reset()
        tr.reset()
        mod.init([])


def _normal(out: dict) -> dict:
    """An evaluate() payload without what each package's own span ring
    decides: the worst trace's id and duration (its status stays)."""
    out = copy.deepcopy(out)
    for obj in out.get("objectives", ()):
        worst = obj.get("evidence", {}).get("worst_trace")
        if worst:
            worst.pop("trace")
            worst.pop("dur_ms")
    return out


class _Twin:
    """A port engine and a reference engine over the same specs: every
    evaluate() runs both on the same inputs, holds the port's answer and
    transition state equal to the reference's, and returns the port's."""

    def __init__(self, specs: "list[str]", **kw):
        self.port = slo.SloEngine([slo.SloSpec(s) for s in specs], **kw)
        self.ref = ref_slo.SloEngine([ref_slo.SloSpec(s) for s in specs],
                                     **kw)

    def evaluate(self, windows, **kw) -> dict:
        want = self.ref.evaluate(copy.deepcopy(windows), **copy.deepcopy(kw))
        got = self.port.evaluate(windows, **kw)
        assert _normal(got) == _normal(want)
        assert self.port._last_status == self.ref._last_status
        return got


def _raises_alike(fn_port, fn_ref) -> ValueError:
    """Both raise ValueError with the same message; returns the port's."""
    with pytest.raises(ValueError) as want:
        fn_ref()
    with pytest.raises(ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return got.value


# ---------------------------------------------------------------------------
# spec grammar


def test_spec_parses():
    s = slo.SloSpec("volume.read:p99<50ms@99.9")
    assert (s.tier, s.op) == ("volume", "read")
    assert s.quantile == pytest.approx(0.99)
    assert s.threshold_s == pytest.approx(0.05)
    assert s.objective == pytest.approx(0.999)
    assert s.budget == pytest.approx(0.001)
    s2 = slo.SloSpec("filer.stream:p95<2s@99")
    assert s2.threshold_s == 2.0 and s2.objective == pytest.approx(0.99)
    for raw in ("volume.read:p99<50ms@99.9", "filer.stream:p95<2s@99",
                " s3.put/acme-1:p50<0.5s@99.95 ", "volume.ec.read:p9<7ms@1"):
        got, want = slo.SloSpec(raw), ref_slo.SloSpec(raw)
        assert got.to_dict() == want.to_dict(), raw
        assert got.budget == want.budget and got.tenant == want.tenant


@pytest.mark.parametrize("bad", [
    "volume.read",                  # no objective
    "volume.read:p99<50ms",         # no @
    "volume:p99<50ms@99",           # no op
    "volume.read:q99<50ms@99",      # not pNN
    "volume.read:p99<50m@99",       # bad unit
    "volume.read:p99<50ms@0",       # objective out of range
    "volume.read:p99<50ms@100",
    "",
])
def test_spec_rejects(bad):
    _raises_alike(lambda: slo.SloSpec(bad), lambda: ref_slo.SloSpec(bad))


def test_init_raises_on_bad_spec():
    raws = ["volume.read:p99<50ms@99", "garbage"]
    _raises_alike(lambda: slo.init(raws), lambda: ref_slo.init(raws))


def test_cli_refuses_slo_with_recorder_disabled(tmp_path):
    # -slo with -timeline.interval 0 would guard nothing: no window is
    # ever snapped, tick() never runs, /debug/health stays ok forever
    # — the same silent-pass hazard as a typo'd spec, refused the same
    # way (regression: the daemon used to start cleanly)
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.stats import timeline
    with pytest.raises(SystemExit, match="flight recorder"):
        cli.main(["volume", "-port", "0", "-dir", str(tmp_path),
                  "-slo", "volume.read:p99<50ms@99",
                  "-timeline.interval", "0"])
    timeline.init()                      # restore process defaults


# ---------------------------------------------------------------------------
# histogram math


def _frac_over(buckets, threshold_s, total) -> float:
    got = slo._frac_over(buckets, threshold_s, total)
    assert got == ref_slo._frac_over(dict(buckets), threshold_s, total)
    return got


def test_frac_over_interpolates():
    buckets = {"0.01": 90.0, "0.1": 100.0, "+Inf": 100.0}
    # threshold on a bucket edge: exact
    assert _frac_over(buckets, 0.01, 100.0) == pytest.approx(0.10)
    # inside the (0.01, 0.1] bucket: linear
    assert _frac_over(buckets, 0.055, 100.0) == pytest.approx(0.05)
    # +Inf mass always counts as over
    assert _frac_over({"0.01": 0.0, "+Inf": 10.0}, 0.05, 10.0) \
        == pytest.approx(1.0)
    assert _frac_over({}, 0.05, 0.0) == 0.0


EDGES = ["0.001", "0.005", "0.01", "0.025", "0.05", "0.1", "0.25", "1",
         "2.5", "10"]


def _random_buckets(rng: np.random.Generator) -> "tuple[dict, float]":
    """Cumulative buckets over a random subset of the edges (with a junk
    label now and then), in random order, and their total."""
    edges = [e for e in EDGES if rng.random() < 0.6]
    counts = np.cumsum(rng.integers(0, 50, len(edges) + 1)).astype(float)
    buckets = {e: float(c) for e, c in zip(edges, counts)}
    buckets["+Inf"] = float(counts[-1])
    if rng.random() < 0.2:
        buckets["bogus"] = 3.0
    keys = list(buckets)
    rng.shuffle(keys)
    return {k: buckets[k] for k in keys}, float(counts[-1])


@pytest.mark.parametrize("seed", range(4))
def test_frac_over_matches_reference_on_seeded_buckets(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        buckets, total = _random_buckets(rng)
        for thresh in (0.0005, 0.01, 0.03, 0.25, 3.0, 50.0):
            _frac_over(buckets, thresh, total)


# ---------------------------------------------------------------------------
# verdicts


BASE = ('SeaweedFS_request_duration_seconds'
        '{op="read",status="ok",tier="volume"}')


def _win(wall_ms: float, under: float, over: float) -> dict:
    total = under + over
    return {"wall_ms": wall_ms, "dt_s": 1.0, "rates": {}, "gauges": {},
            "hist": {BASE: {"buckets": {"0.025": under, "+Inf": total},
                            "sum": 0.0, "count": total}}}


def _engine():
    return _Twin(["volume.read:p99<50ms@99"])


def test_ok_when_healthy():
    now = 1_000_000.0
    wins = [_win(now - i * 1000, 100, 0) for i in range(30)]
    out = _engine().evaluate(wins, now_ms=now)
    assert out["status"] == "ok"
    obj = out["objectives"][0]
    assert obj["status"] == "ok" and obj["fast"]["burn"] == 0.0
    assert "evidence" not in obj


def test_page_with_evidence():
    now = 1_000_000.0
    events.record("breaker_open", upstream="w1")
    ev_rows = events.events_dict()["events"]
    for r in ev_rows:
        r["wall_ms"] = now - 5_000          # inside the fast window
    # every request over threshold: burn = 1.0/0.01 = 100 >> 14.4 in
    # both windows
    wins = [_win(now - i * 1000, 0, 10) for i in range(30)]
    out = _engine().evaluate(wins, events=ev_rows, now_ms=now)
    assert out["status"] == "page"
    obj = out["objectives"][0]
    assert obj["fast"]["burn"] >= slo.PAGE_BURN
    assert obj["slow"]["burn"] >= slo.PAGE_BURN
    ev = obj["evidence"]
    assert ev["violating_windows"], "violating slice must be present"
    assert all(w["frac_over"] > 0 for w in ev["violating_windows"])
    assert any(e["type"] == "breaker_open" for e in ev["events"])
    assert ev["window"]["from_ms"] < ev["window"]["to_ms"]


def test_evidence_spans_the_whole_burn_episode():
    # a slow-burn page can land minutes after the breaker trip that
    # explains it (regression: evidence was clipped to the fast 60s
    # window, so a soak that paged late correlated ZERO events)
    now = 1_000_000.0
    events.record("breaker_open", upstream="w1")
    ev_rows = events.events_dict()["events"]
    for r in ev_rows:
        r["wall_ms"] = now - 200_000        # 200s ago: damage onset
    # violation running for 240s: the earliest violating windows sit
    # far outside the fast horizon but inside the slow one
    wins = [_win(now - i * 1000, 0, 10) for i in range(240)]
    out = _engine().evaluate(wins, events=ev_rows, now_ms=now)
    assert out["status"] == "page"
    ev = out["objectives"][0]["evidence"]
    assert ev["violating_total"] == 240
    assert len(ev["violating_windows"]) == 200      # capped, newest
    assert any(e["type"] == "breaker_open" for e in ev["events"])
    # the correlation window opens at the start of the damage, not 60s
    # before the page
    assert ev["window"]["from_ms"] <= now - 200_000


def test_warn_between_burn_thresholds():
    now = 1_000_000.0
    # 8% violating, p99 allows 1% free, 1% budget -> burn 7: warn
    # (>=6) but not page
    wins = [_win(now - i * 1000, 92, 8) for i in range(30)]
    out = _engine().evaluate(wins, now_ms=now)
    assert out["objectives"][0]["status"] == "warn"
    assert out["status"] == "warn"


def test_quantile_is_honored():
    # regression: the pQQ in a spec used to be parsed and echoed but
    # never evaluated, so p50 and p99 behaved identically.  p99<25ms
    # permits 1% of requests over the threshold; p50<25ms permits 50%.
    now = 1_000_000.0
    wins = [_win(now - i * 1000, 70, 30) for i in range(30)]
    strict = _Twin(["volume.read:p99<50ms@99"])
    lax = _Twin(["volume.read:p50<50ms@99"])
    s = strict.evaluate(wins, now_ms=now)["objectives"][0]
    l = lax.evaluate(wins, now_ms=now)["objectives"][0]
    # 30% over: p99 burns (0.30-0.01)/0.01=29 -> page; p50 has 20%
    # headroom left -> burn 0, ok
    assert s["status"] == "page" and s["fast"]["burn"] >= slo.PAGE_BURN
    assert l["status"] == "ok" and l["fast"]["burn"] == 0.0


def test_merged_evaluate_does_not_flap_transition_state():
    # regression: /debug/health evaluates whole-host MERGED windows
    # against the same engine the local tick() uses; it must not touch
    # _last_status or every poll would log phantom ok->page->ok flaps
    # whenever local and merged verdicts disagree
    now = 1_000_000.0
    eng = _engine()
    bad = [_win(now - i * 1000, 0, 10) for i in range(30)]
    good = [_win(now - i * 1000, 100, 0) for i in range(30)]
    eng.evaluate(good, now_ms=now, update_metrics=True)
    assert eng.port._last_status.get("volume.read:p99<50ms@99",
                                     "ok") == "ok"
    # a merged-view page (the handler path: update_metrics=False)
    out = eng.evaluate(bad, now_ms=now)
    assert out["status"] == "page"
    assert eng.port._last_status.get("volume.read:p99<50ms@99",
                                     "ok") == "ok"
    # the canonical tick path still records it
    eng.evaluate(bad, now_ms=now, update_metrics=True)
    assert eng.port._last_status["volume.read:p99<50ms@99"] == "page"


def test_min_count_guard():
    now = 1_000_000.0
    # one catastrophically slow request on an idle daemon: no page
    wins = [_win(now - 1000, 0, 1)]
    out = _engine().evaluate(wins, now_ms=now)
    assert out["status"] == "ok"


def test_slow_window_guards_against_blips():
    now = 1_000_000.0
    # a fully-violating fast window inside an otherwise-healthy 10
    # minutes: fast burns hot but the slow window stays under the page
    # threshold -> no page (one blip is not an incident)
    wins = [_win(now - i * 1000, 0, 20) for i in range(60)]
    wins += [_win(now - (i + 60) * 1000, 2000, 0) for i in range(540)]
    eng = _engine()
    out = eng.evaluate(wins, now_ms=now)
    assert out["objectives"][0]["fast"]["burn"] >= slo.PAGE_BURN
    assert out["objectives"][0]["status"] != "page"


def test_worst_trace_in_evidence():
    # each package's engine reads its own span ring: a span in each,
    # and each evidence names its own (the rest of the payloads equal)
    with tracing.start_root("volume", "read") as sp:
        pass
    with ref_tracing.start_root("volume", "read") as ref_sp:
        pass
    import time
    now_ms = time.time() * 1000.0
    wins = [_win(now_ms - 1000, 0, 100)]
    eng = _engine()
    out = eng.evaluate(wins, now_ms=now_ms)
    worst = out["objectives"][0]["evidence"].get("worst_trace")
    assert worst is not None and worst["trace"] == sp.trace
    ref_worst = eng.ref.evaluate(wins, now_ms=now_ms)[
        "objectives"][0]["evidence"]["worst_trace"]
    assert ref_worst["trace"] == ref_sp.trace


def test_health_dict_without_engine_is_stable_schema():
    slo.init([])
    ref_slo.init([])
    out = slo.health_dict([])
    assert out["status"] == "ok" and out["objectives"] == []
    assert "now_ms" in out
    want = ref_slo.health_dict([])
    assert set(out) == set(want)
    assert {k: v for k, v in out.items() if k != "now_ms"} == \
        {k: v for k, v in want.items() if k != "now_ms"}


def test_engine_matches_only_its_tier_op():
    other = ('SeaweedFS_request_duration_seconds'
             '{op="write",status="ok",tier="volume"}')
    now = 1_000_000.0
    win = {"wall_ms": now - 1000, "dt_s": 1.0, "rates": {}, "gauges": {},
           "hist": {other: {"buckets": {"+Inf": 100.0}, "sum": 0.0,
                            "count": 100.0}}}
    out = _engine().evaluate([win], now_ms=now)
    assert out["objectives"][0]["fast"]["count"] == 0
    assert out["status"] == "ok"


def _slo_lines(text: str) -> "list[str]":
    return sorted(line for line in text.splitlines()
                  if line.startswith("SeaweedFS_slo_"))


def test_tick_exports_metrics():
    from seaweedfs_tpu.stats import metrics as ref_metrics
    from seaweedfs_tpu.stats import timeline as ref_timeline
    from seaweedfs_tpu_torch.stats import metrics, timeline
    if not metrics.HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")
    for tl, mod, met in ((timeline, slo, metrics),
                         (ref_timeline, ref_slo, ref_metrics)):
        tl.init(interval_s=1.0, ring=16)
        tl.reset()
        mod.init(["volume.read:p99<50ms@99"])
        tl.snap()
        met.REQUEST_DURATION.labels("volume", "read", "ok").observe(5.0)
        tl.snap()
        mod.tick()
    text = metrics.metrics_text().decode()
    assert 'SeaweedFS_slo_burn_rate{' in text
    assert 'SeaweedFS_slo_status{' in text
    # the same gauges, labels and values as the reference's after the
    # same snapshots
    assert _slo_lines(text) == _slo_lines(
        ref_metrics.metrics_text().decode())
    for tl in (timeline, ref_timeline):
        tl.init()


# ---------------------------------------------------------------------------
# the port against the reference beyond the cases' constants


SPEC_POOL = ["volume.read:p99<50ms@99", "volume.read:p50<10ms@99.9",
             "volume.write:p95<250ms@99.5", "filer.stream:p90<1s@95",
             "volume.read/acme:p99<25ms@99", "s3.get:p99.9<2.5s@99.99"]
KEYS = [
    'SeaweedFS_request_duration_seconds{op="read",status="ok",'
    'tier="volume"}',
    'SeaweedFS_request_duration_seconds{op="read",status="error",'
    'tier="volume"}',
    'SeaweedFS_request_duration_seconds{op="write",status="ok",'
    'tier="volume"}',
    'SeaweedFS_request_duration_seconds{op="stream",status="ok",'
    'tier="filer"}',
    'SeaweedFS_request_duration_seconds{op="get",status="ok",tier="s3"}',
    'SeaweedFS_qos_tenant_request_seconds{op="read",tenant="acme",'
    'tier="volume"}',
    'SeaweedFS_qos_tenant_request_seconds{op="read",tenant="other",'
    'tier="volume"}',
]
EVENT_TYPES = ["breaker_open", "breaker_close", "scrub_corruption",
               "worker_respawn", "tenant_shed", "volume_mounted"]


def _random_case(rng: np.random.Generator, now: float):
    specs = [s for s in SPEC_POOL if rng.random() < 0.5] or SPEC_POOL[:1]
    wins = []
    for i in range(int(rng.integers(1, 700))):
        hist = {}
        for key in KEYS:
            if rng.random() < 0.5:
                buckets, total = _random_buckets(rng)
                hist[key] = {"buckets": buckets, "sum": 0.0,
                             "count": total}
        wins.append({"wall_ms": now - i * 1000.0 - float(rng.random()),
                     "dt_s": 1.0, "rates": {}, "gauges": {},
                     "hist": hist})
    evs = [{"type": EVENT_TYPES[int(rng.integers(len(EVENT_TYPES)))],
            "wall_ms": now - float(rng.integers(0, 900_000)),
            "n": int(j)} for j in range(int(rng.integers(0, 40)))]
    return specs, wins, evs


@pytest.mark.parametrize("seed", range(8))
def test_evaluate_matches_reference_on_seeded_windows(seed):
    """Random specs (tenant ones too), up to 700 windows of random
    histograms over several tiers and ops, and random journal events:
    the port's payload equals the reference's, through a tick and a
    merged evaluation alike."""
    rng = np.random.default_rng(seed)
    now = 2_000_000.0
    for _ in range(3):
        specs, wins, evs = _random_case(rng, now)
        eng = _Twin(specs)
        eng.evaluate(wins, events=evs, now_ms=now)
        eng.evaluate(wins, events=evs, now_ms=now, update_metrics=True)
        eng.evaluate(wins[: len(wins) // 2], events=evs[::-1],
                     now_ms=now - 1234.5, update_metrics=True)


@pytest.mark.parametrize("interval", [0.0, 0.5, 1.0, 3.0, 10.0])
def test_windows_needed_matches_reference(interval):
    from seaweedfs_tpu.stats import timeline as ref_timeline
    from seaweedfs_tpu_torch.stats import timeline
    try:
        for tl, mod in ((timeline, slo), (ref_timeline, ref_slo)):
            tl.init(interval_s=interval, ring=16)
            mod.init(["volume.read:p99<50ms@99"])
        for minimum in (1, 200, 5000):
            assert slo.windows_needed(minimum) == \
                ref_slo.windows_needed(minimum)
    finally:
        for tl in (timeline, ref_timeline):
            tl.init()
