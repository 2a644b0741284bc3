"""Continuous sampling profiler (stats/profiler.py):

- deterministic accounting: the absolute-deadline tick loop delivers
  samples = hz x window within jitter (the overhead gate's contract);
- trace-tier attribution: a thread burning inside an s3-tier span
  folds under "s3;..." stacks;
- bounded memory: past MAX_FOLDED distinct stacks new ones fold into
  "(other)";
- whole-host merge sums folded counts; folded_text renders stable
  flamegraph lines; the shared query parser rejects junk.

The cases of tests/test_profiler.py pointed at the port's
stats/profiler.py and its tracing registry. Each case also runs the JAX
package's stats/profiler.py: its windows over the same time as the
port's, its sampler on the same parked thread, its merge and parser on
the same payloads and queries, and the port's answer is held to it."""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.stats import profiler as ref_profiler
from seaweedfs_tpu.util import tracing as ref_tracing
from seaweedfs_tpu_torch.stats import profiler
from seaweedfs_tpu_torch.util import tracing

from test_torch_cluster_util import run


def _reset_both():
    for mod in (profiler, ref_profiler):
        mod.stop()
        mod.init(0.0)
        mod.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset_both()
    yield
    _reset_both()


class _Burner:
    """A busy thread with a recognizable frame for the sampler; with a
    tier, inside a span of that tier in both packages' tracing."""

    def __init__(self, tier: str = ""):
        self.tier = tier
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._spin, daemon=True)

    def _spin(self):
        if self.tier:
            with tracing.start_root(self.tier, "burn"), \
                    ref_tracing.start_root(self.tier, "burn"):
                self._burn_loop()
        else:
            self._burn_loop()

    def _burn_loop(self):
        x = 0
        while not self._stop.is_set():
            x = (x + 1) % 1000003

    def __enter__(self):
        self.t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self.t.join(timeout=2.0)


def _burner_stacks(p: dict) -> "set[str]":
    """The burner's folded stacks, cut at its own frame (a sample may
    land inside Event.is_set below it)."""
    return {k[:k.index("_burn_loop")] for k in p["folded"]
            if "_burn_loop" in k}


async def _windows(seconds: float, hz: "float | None" = None):
    """The port's and the reference's profile_window over the same
    time; returns (port, reference)."""
    return await asyncio.gather(profiler.profile_window(seconds, hz=hz),
                                ref_profiler.profile_window(seconds, hz=hz))


def test_window_sample_accounting_tracks_hz_times_elapsed():
    async def go():
        with _Burner():
            p, ref = await _windows(0.8, hz=250)
        expect = 250 * 0.8
        for q in (p, ref):
            assert abs(q["samples"] - expect) <= expect * 0.10 + 2, \
                q["samples"]
            assert q["window_s"] == 0.8 and q["hz"] == 250
            assert q["folded"] and not q["running"]
            assert sum(q["folded"].values()) > 0
        assert _burner_stacks(p) and \
            _burner_stacks(p) == _burner_stacks(ref)
        assert set(p) == set(ref)
    run(go())


def test_window_attributes_active_trace_tier():
    tracing.init(sample=1.0)
    ref_tracing.init(sample=1.0)

    async def go():
        # arm before the span is entered (profiler.start() does this
        # at boot in production; the thread records its tier on entry)
        tracing.track_thread_tiers(True)
        ref_tracing.track_thread_tiers(True)
        with _Burner(tier="s3"):
            p, ref = await _windows(0.4, hz=200)
        tracing.track_thread_tiers(False)
        ref_tracing.track_thread_tiers(False)
        s3_keys = [k for k in p["folded"] if k.startswith("s3;")]
        assert s3_keys, list(p["folded"])[:5]
        # the burner's own frame shows up under the attributed tier
        assert any("_burn_loop" in k for k in s3_keys), s3_keys
        assert {s for s in _burner_stacks(p) if s.startswith("s3;")} == \
            {s for s in _burner_stacks(ref) if s.startswith("s3;")}
    run(go())


def test_always_on_sampler_and_window_piggyback():
    async def go():
        for mod in (profiler, ref_profiler):
            mod.init(200.0)
            assert mod.enabled()
            mod.start()
            assert mod.running()
        with _Burner():
            p, ref = await _windows(0.3)
        # the piggybacked sink rode the always-on cadence
        expect = 200 * 0.3
        for q in (p, ref):
            assert q["hz"] == 200.0 and q["running"]
            assert abs(q["samples"] - expect) <= expect * 0.25 + 2
        assert _burner_stacks(p) == _burner_stacks(ref)
        for mod, q in ((profiler, p), (ref_profiler, ref)):
            agg = mod.profile_dict()
            assert agg["samples"] >= q["samples"]
            assert agg["running"] and agg["hz"] == 200.0
            mod.stop()
            assert not mod.running()
    run(go())


def test_init_zero_disables_start():
    for mod in (profiler, ref_profiler):
        mod.init(0.0)
        assert mod.start() is None
        assert not mod.running()
    assert profiler.profile_dict() == ref_profiler.profile_dict()


def test_overflow_folds_into_other_bucket():
    stubs = {f"stub;{i}": 1 for i in range(profiler.MAX_FOLDED)}
    assert profiler.MAX_FOLDED == ref_profiler.MAX_FOLDED
    sinks = [{"folded": dict(stubs), "samples": 0} for _ in range(2)]
    with _Burner():
        time.sleep(0.02)
        profiler._sample_once([sinks[0]])
        ref_profiler._sample_once([sinks[1]])
    for sink in sinks:
        assert sink["samples"] == 1
        assert len(sink["folded"]) == profiler.MAX_FOLDED + 1
        assert sink["folded"]["(other)"] >= 1
    # every thread but the sampler's own lands in the one bucket
    assert sinks[0]["folded"] == sinks[1]["folded"]


def test_parked_thread_folds_alike():
    """A thread parked in a known frame, inside a volume-tier span in
    both packages' tracing: one sample of each module folds it into the
    same stack, tier first."""
    parked, release = threading.Event(), threading.Event()

    def _parked_frame():
        parked.set()
        release.wait(10)

    def body():
        with tracing.start_root("volume", "park"), \
                ref_tracing.start_root("volume", "park"):
            _parked_frame()

    tracing.init(sample=1.0)
    ref_tracing.init(sample=1.0)
    for tr in (tracing, ref_tracing):
        tr.track_thread_tiers(True)
    t = threading.Thread(target=body, daemon=True)
    t.start()
    try:
        assert parked.wait(5)
        sinks = [{"folded": {}, "samples": 0} for _ in range(2)]
        profiler._sample_once([sinks[0]])
        ref_profiler._sample_once([sinks[1]])
    finally:
        release.set()
        t.join(timeout=5)
        for tr in (tracing, ref_tracing):
            tr.track_thread_tiers(False)
    keys = [{k for k in s["folded"] if "_parked_frame" in k}
            for s in sinks]
    assert len(keys[0]) == 1 and keys[0] == keys[1], keys
    assert next(iter(keys[0])).startswith("volume;")


def test_merge_sums_and_folded_text_is_stable():
    p1 = {"hz": 99.0, "running": True, "window_s": 2.0, "samples": 10,
          "folded": {"-;a.py:f": 6, "-;b.py:g": 1}}
    p2 = {"hz": 50.0, "running": False, "window_s": 1.0, "samples": 4,
          "folded": {"-;a.py:f": 2, "-;c.py:h": 2}}
    m = profiler.merge_payloads([p1, p2])
    assert m == ref_profiler.merge_payloads([p1, p2])
    assert m["samples"] == 14 and m["hz"] == 99.0 and m["running"]
    assert m["folded"] == {"-;a.py:f": 8, "-;b.py:g": 1, "-;c.py:h": 2}
    txt = profiler.folded_text(m)
    assert txt == ref_profiler.folded_text(m)
    assert txt == "-;a.py:f 8\n-;c.py:h 2\n-;b.py:g 1\n"
    assert profiler.folded_text({"folded": {}}) == ""


def _random_payload(rng: np.random.Generator) -> dict:
    p: dict = {"folded": {f"-;m{int(rng.integers(0, 30))}.py:f": int(
        rng.integers(1, 20)) for _ in range(int(rng.integers(0, 25)))}}
    if rng.random() < 0.8:
        p["samples"] = int(rng.integers(0, 1000))
    if rng.random() < 0.8:
        p["hz"] = float(rng.choice([0.0, 19.0, 99.0, 250.5]))
    if rng.random() < 0.8:
        p["window_s"] = float(rng.choice([0.0, 0.5, 2.0, 60.0]))
    if rng.random() < 0.5:
        p["running"] = bool(rng.random() < 0.5)
    return p


@pytest.mark.parametrize("seed", range(4))
def test_merge_and_folded_text_match_reference_on_seeded_payloads(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        payloads = [_random_payload(rng)
                    for _ in range(int(rng.integers(0, 6)))]
        m = profiler.merge_payloads(payloads)
        assert m == ref_profiler.merge_payloads(payloads)
        assert profiler.folded_text(m) == ref_profiler.folded_text(m)
        for p in payloads:
            assert profiler.folded_text(p) == ref_profiler.folded_text(p)


def test_profile_query_parses_and_rejects():
    async def go():
        out = await profiler.profile_query({})
        assert out["window_s"] == 0.0       # the always-on aggregate
        assert out == await ref_profiler.profile_query({})
        for junk in ({"seconds": "junk"}, {"seconds": "1", "hz": "x"}):
            with pytest.raises(ValueError):
                await profiler.profile_query(junk)
            with pytest.raises(ValueError):
                await ref_profiler.profile_query(junk)
        # seconds clamp: a huge window is cut to MAX_WINDOW_S
        p = await profiler.profile_query({"seconds": "0.1", "hz": "50"})
        assert p["window_s"] == 0.1 and p["hz"] == 50.0
        ref = await ref_profiler.profile_query({"seconds": "0.1",
                                                "hz": "50"})
        assert {k: v for k, v in p.items() if k not in ("samples",
                                                         "folded")} == \
            {k: v for k, v in ref.items() if k not in ("samples",
                                                       "folded")}
    run(go())
