"""Multi-tenant QoS tests: WFQ fairness properties, rate-bucket burst
clamp, the priority shed ladder, the bandwidth arbiter's floor and
deterministic ledger, bounded tenant metric labels, keyed retry
budgets.

The cases of tests/test_qos.py pointed at the port's qos/ registries
and its stats/slo.py, the S3 SlowDown case at the port's s3/ gateway."""

from __future__ import annotations

import asyncio
import random

import pytest

from seaweedfs_tpu_torch import qos
from seaweedfs_tpu_torch.ec.scrub import TokenBucket
from seaweedfs_tpu_torch.qos.admission import (AdmissionController, RateBucket,
                                         TenantClass, WFQ,
                                         parse_tenant_flag,
                                         parse_tenant_flags)
from seaweedfs_tpu_torch.qos.arbiter import BandwidthArbiter, MiB
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.util.resilience import RetryBudget


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def run(coro):
    return asyncio.run(coro)


# ---- tenant flag parsing ----

def test_parse_tenant_flag_roundtrip():
    t = parse_tenant_flag("paying:8:100:200")
    assert (t.name, t.weight, t.rps, t.burst) == ("paying", 8.0, 100.0,
                                                  200.0)
    # burst defaults to max(rps, 1)
    assert parse_tenant_flag("x:1:50").burst == 50.0
    assert parse_tenant_flag("x:1:0").burst == 1.0


@pytest.mark.parametrize("bad", [
    "", "justakey", "k:1", "k:1:2:3:4", "k:zero:1", ":1:1",
    "k:0:1", "k:-1:1", "k:1:-5", "k:1:1:0",
])
def test_parse_tenant_flag_refuses_malformed(bad):
    with pytest.raises(ValueError):
        parse_tenant_flag(bad)


def test_parse_tenant_flags_ensures_default_and_refuses_dupes():
    out = parse_tenant_flags(["a:2:10"])
    assert "default" in out and out["default"].rps == 0.0
    with pytest.raises(ValueError):
        parse_tenant_flags(["a:2:10", "a:3:20"])


# ---- RateBucket ----

def test_rate_bucket_burst_clamp_and_honest_retry_after():
    clock = FakeClock()
    b = RateBucket(10.0, burst=5.0, now=clock)
    # a long idle period must never bank more than burst
    clock.t += 100.0
    assert b.tokens == 5.0
    for _ in range(5):
        assert b.try_take() == 0.0
    ra = b.try_take()
    assert ra == pytest.approx(0.1)        # 1 token at 10/s
    # advancing the advertised Retry-After (plus float dust) admits
    clock.t += ra + 1e-6
    assert b.try_take() == 0.0
    # rate <= 0 disables the limit entirely
    free = RateBucket(0.0, now=clock)
    assert all(free.try_take() == 0.0 for _ in range(1000))


# ---- WFQ properties ----

def test_wfq_work_conservation():
    q = WFQ({"a": 3.0, "b": 1.0})
    rng = random.Random(7)
    n = 500
    for i in range(n):
        q.push(rng.choice("ab"), i)
    seen = []
    while len(q):
        seen.append(q.pop())
    assert len(seen) == n                  # nothing lost, nothing extra
    assert q.pop() is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wfq_weight_proportional_service(seed):
    # both tenants continuously backlogged: service over any prefix
    # must track the 4:1 weight ratio
    q = WFQ({"fat": 4.0, "thin": 1.0})
    rng = random.Random(seed)
    items = ["fat"] * 400 + ["thin"] * 400
    rng.shuffle(items)
    for i, t in enumerate(items):
        q.push(t, i)
    first = [q.pop()[0] for _ in range(100)]
    fat = first.count("fat")
    assert 70 <= fat <= 90, f"fat got {fat}/100, want ~80"


def test_wfq_identical_seeds_are_deterministic():
    def drain(seed):
        q = WFQ({"a": 2.0, "b": 1.0, "c": 5.0})
        rng = random.Random(seed)
        for i in range(300):
            q.push(rng.choice("abc"), i)
        return [q.pop() for _ in range(300)]

    assert drain(42) == drain(42)
    assert drain(42) != drain(43)


def test_wfq_idle_tenant_banks_no_credit():
    q = WFQ({"a": 1.0, "b": 1.0})
    for i in range(100):
        q.push("a", i)
    for _ in range(100):
        q.pop()
    # b arrives after a long a-only backlog: it enters at the current
    # virtual clock, not at 0 — equal weights alternate from here on
    for i in range(10):
        q.push("a", f"a{i}")
        q.push("b", f"b{i}")
    order = [q.pop()[0] for _ in range(20)]
    assert order.count("a") == order.count("b") == 10


# ---- AdmissionController: throttle + shed ladder ----

def _ctrl(clock, probe, **kw):
    tenants = parse_tenant_flags(
        ["paying:8:1000:2000", "abuser:1:2:2"])
    kw.setdefault("lag_shed_ms", 100.0)
    return AdmissionController(tenants, now=clock, probe=probe, **kw)


def test_throttle_429_with_bucket_refill_retry_after():
    clock = FakeClock()
    ctrl = _ctrl(clock, probe=lambda: (0.0, 0.0))

    async def go():
        # burst 2 admits two, the third throttles
        for _ in range(2):
            dec = await ctrl.acquire("s3", "get", "abuser")
            assert dec.admitted
            ctrl.release(dec)
        dec = await ctrl.acquire("s3", "get", "abuser")
        assert not dec.admitted and dec.status == 429
        assert dec.reason == "throttle"
        assert dec.retry_after_s == pytest.approx(0.5)  # 1 token @ 2/s
        # the paying tenant is untouched by the abuser's drained bucket
        dec2 = await ctrl.acquire("s3", "get", "paying")
        assert dec2.admitted
        ctrl.release(dec2)

    run(go())


def test_shed_ladder_lowest_class_first_highest_never():
    clock = FakeClock()
    lag = {"ms": 0.0}
    ctrl = _ctrl(clock, probe=lambda: (lag["ms"], 0.0))

    async def go():
        # saturate: one rung per LEVEL_STEP_S, never faster
        lag["ms"] = 500.0
        clock.t += 1.0
        dec = await ctrl.acquire("s3", "get", "abuser")
        assert not dec.admitted and dec.status == 503
        assert dec.reason == "overload"
        # same instant: the paying (highest-weight) class still admits
        dec = await ctrl.acquire("s3", "get", "paying")
        assert dec.admitted
        ctrl.release(dec)
        # the ladder excludes the top class: however long the overload
        # lasts, paying is never overload-shed
        for _ in range(10):
            clock.t += 1.0
            dec = await ctrl.acquire("s3", "get", "paying")
            assert dec.admitted
            ctrl.release(dec)
        # recovery: lag drops below the hysteresis fraction
        lag["ms"] = 0.0
        clock.t += 1.0
        dec = await ctrl.acquire("s3", "get", "abuser")
        assert dec.admitted, "abuser not readmitted after recovery"
        ctrl.release(dec)

    run(go())


def test_shed_hysteresis_holds_level_between_steps():
    clock = FakeClock()
    lag = {"ms": 500.0}
    ctrl = _ctrl(clock, probe=lambda: (lag["ms"], 0.0))

    async def go():
        clock.t += 1.0
        await ctrl.acquire("s3", "get", "abuser")   # raises level to 1
        # lag recovers but NOT below RECOVER_FRAC * threshold
        lag["ms"] = 90.0                            # 0.9 of 100ms
        clock.t += 1.0
        dec = await ctrl.acquire("s3", "get", "abuser")
        assert not dec.admitted, "level dropped inside hysteresis band"

    run(go())


def test_queue_deadline_sheds_instead_of_silent_wait():
    clock = FakeClock()
    ctrl = _ctrl(clock, probe=lambda: (0.0, 0.0), inflight_limit=1,
                 queue_deadline_s=0.05)

    async def go():
        d1 = await ctrl.acquire("s3", "get", "paying")
        assert d1.admitted
        # the slot is taken: the next acquire parks in the WFQ and the
        # deadline sheds it with an honest 503 (never a silent queue)
        d2 = await ctrl.acquire("s3", "get", "paying")
        assert not d2.admitted and d2.status == 503
        assert d2.reason == "queue_deadline"
        assert d2.retry_after_s > 0
        ctrl.release(d1)

    run(go())


def test_release_wakes_queued_waiter():
    clock = FakeClock()
    ctrl = _ctrl(clock, probe=lambda: (0.0, 0.0), inflight_limit=1,
                 queue_deadline_s=5.0)

    async def go():
        d1 = await ctrl.acquire("s3", "get", "paying")
        waiter = asyncio.create_task(
            ctrl.acquire("s3", "get", "paying"))
        await asyncio.sleep(0.01)
        assert not waiter.done()
        ctrl.release(d1)
        d2 = await asyncio.wait_for(waiter, 1.0)
        assert d2.admitted and d2.queued_s >= 0.0
        ctrl.release(d2)

    run(go())


def test_to_dict_surfaces_counters_and_ladder():
    clock = FakeClock()
    ctrl = _ctrl(clock, probe=lambda: (12.0, 0.0))

    async def go():
        dec = await ctrl.acquire("s3", "get", "paying")
        ctrl.release(dec)

    run(go())
    d = ctrl.to_dict()
    assert d["tenants"]["paying"]["admitted"] == 1
    assert d["tenants"]["abuser"]["admitted"] == 0
    assert d["shed_level"] == 0
    assert d["ladder"] == [1.0]            # abuser+default; paying (8) excluded
    assert d["probes"]["lag_ms"] == pytest.approx(12.0)


# ---- bandwidth arbiter ----

def _paced(clock, sleeps):
    async def fake_sleep(d):
        sleeps.append(d)
        clock.t += d
    return fake_sleep


def test_arbiter_idle_cluster_grants_full_base_rate():
    clock, sleeps = FakeClock(), []
    arb = BandwidthArbiter(budget_mbps=10.0, now=clock)
    inner = TokenBucket(4 * MiB, now=clock, sleep=_paced(clock, sleeps))
    gb = arb.adopt("scrub", inner)

    async def go():
        for _ in range(4):
            await gb.consume(1 * MiB)

    run(go())
    assert arb.rate_for("scrub") == pytest.approx(4 * MiB)
    assert arb.to_dict()["consumers"]["scrub"]["yields"] == 0


def test_arbiter_floor_never_starved_and_grants_bounded():
    clock, sleeps = FakeClock(), []
    arb = BandwidthArbiter(budget_mbps=10.0, floor=0.25, now=clock)
    inner = TokenBucket(4 * MiB, now=clock, sleep=_paced(clock, sleeps))
    gb = arb.adopt("autopilot", inner)

    async def go():
        # sustained foreground pressure way past the budget
        for _ in range(50):
            arb.note_foreground(2 * MiB)
            clock.t += 0.01
        assert arb.foreground_bps() > 10 * MiB
        for _ in range(8):
            arb.note_foreground(2 * MiB)     # keep the window pressurised
            await gb.consume(1 * MiB)

    run(go())
    rows = list(arb.grants)
    assert len(rows) == 8
    base = 4 * MiB
    for r in rows:
        # the starvation-proof floor: never below floor * base even at
        # full squeeze, and never above the base entitlement
        assert r["rate_bps"] >= int(0.25 * base) - 1
        assert r["rate_bps"] <= base
        assert r["yielded"]
    c = arb.to_dict()["consumers"]["autopilot"]
    assert c["granted_bytes"] == 8 * MiB     # ledger accounts every byte
    assert c["yields"] == 8
    # pacing really happened: squeezed rate => the bucket slept
    assert sum(sleeps) > 0


def test_arbiter_ledger_is_deterministic_over_identical_runs():
    def one_run():
        clock, sleeps = FakeClock(), []
        arb = BandwidthArbiter(budget_mbps=8.0, floor=0.25, now=clock)
        gb = arb.adopt("scrub", TokenBucket(
            2 * MiB, now=clock, sleep=_paced(clock, sleeps)))

        async def go():
            for i in range(12):
                arb.note_foreground((i % 5) * MiB)
                clock.t += 0.05
                await gb.consume(MiB // 2)

        run(go())
        # wall_ms is a display stamp (time.time); everything the
        # pacing-floor asserts rely on must be clock-deterministic
        return [{k: v for k, v in r.items() if k != "wall_ms"}
                for r in arb.grants], sleeps

    rows_a, sleeps_a = one_run()
    rows_b, sleeps_b = one_run()
    assert rows_a == rows_b
    assert sleeps_a == sleeps_b


def test_arbiter_node_reports_age_out():
    clock = FakeClock()
    arb = BandwidthArbiter(budget_mbps=10.0, now=clock)
    arb.note_node_foreground("127.0.0.1:8080", 5 * MiB)
    assert arb.foreground_bps() == pytest.approx(5 * MiB)
    clock.t += 20.0                          # past NODE_REPORT_TTL_S
    assert arb.foreground_bps() == 0.0


def test_arbiter_disabled_budget_passes_base_through():
    clock, sleeps = FakeClock(), []
    arb = BandwidthArbiter(budget_mbps=0.0, now=clock)
    gb = arb.adopt("scrub", TokenBucket(
        MiB, now=clock, sleep=_paced(clock, sleeps)))

    async def go():
        arb.note_foreground(100 * MiB)
        await gb.consume(1024)

    run(go())
    assert arb.rate_for("scrub") == pytest.approx(MiB)
    assert arb.to_dict()["consumers"]["scrub"]["yields"] == 0


# ---- bounded tenant labels ----

def test_bounded_label_set_caps_cardinality_at_10k_keys():
    s = metrics.BoundedLabelSet(seed=["paying", "abuser"], cap=32)
    out = {s.get(f"key{i}") for i in range(10_000)}
    out |= {s.get("paying"), s.get("abuser")}
    assert len(out) <= 32 + 1               # cap plus the "other" bucket
    assert "other" in out
    assert s.get("paying") == "paying"      # seeds always pass through
    # a key admitted before the cap stays stable afterwards
    assert s.get("key0") == "key0"
    assert s.get("key9999") == "other"


# ---- keyed retry budget ----

def test_retry_budget_pools_are_isolated_by_key():
    b = RetryBudget(ratio=0.1, burst=2.0)
    assert b.allow_retry("master|abuser")
    assert b.allow_retry("master|abuser")
    assert not b.allow_retry("master|abuser")   # abuser pool exhausted
    # the paying tenant's pool is untouched by the abuser's storm
    assert b.allow_retry("master|paying")
    # and the process-global pool ("") keeps its legacy behavior
    assert b.allow_retry()
    assert b.allow_retry()
    assert not b.allow_retry()


def test_retry_budget_overflow_folds_past_max_pools():
    b = RetryBudget(ratio=0.1, burst=1.0)
    for i in range(RetryBudget.MAX_POOLS + 10):
        b.record_attempt(f"up{i}")
    # pools stopped growing at the cap; the overflow key still works
    assert len(b._pools) <= RetryBudget.MAX_POOLS + 1
    assert b.allow_retry(f"up{RetryBudget.MAX_POOLS + 5}") in (True,
                                                               False)


# ---- S3 shed response shape ----

def test_s3_shed_is_aws_shaped_slowdown_with_retry_after():
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.s3.gateway import S3Gateway

    clock = FakeClock()
    tenants = {"default": TenantClass("default", 1.0, 1.0, 1.0)}
    ctrl = AdmissionController(tenants, now=clock,
                               probe=lambda: (0.0, 0.0))

    async def go():
        import aiohttp
        gw = S3Gateway(Filer("memory"), "127.0.0.1:1", port=0,
                       admission=ctrl)
        await gw.start()
        try:
            async with aiohttp.ClientSession() as http:
                base = f"http://{gw.url}"
                async with http.put(f"{base}/b1") as r:
                    assert r.status == 200, await r.text()
                # burst 1 drained: the next request is throttled with
                # the AWS SlowDown shape + an honest Retry-After
                async with http.get(f"{base}/b1") as r:
                    assert r.status == 429
                    assert r.headers["Retry-After"] == "1"
                    body = await r.read()
                    assert b"<Code>SlowDown</Code>" in body
                    assert b"reduce your request rate" in body
                # the bucket refills exactly as advertised
                clock.t += 1.0
                async with http.get(f"{base}/b1") as r:
                    assert r.status == 200
        finally:
            await gw.stop()

    run(go())


# ---- debug surface merge ----

# ---- per-tenant SLO specs ----

def test_slo_spec_parses_tenant_qualifier():
    from seaweedfs_tpu_torch.stats.slo import SloSpec
    s = SloSpec("s3.get/paying:p99<200ms@99")
    assert (s.tier, s.op, s.tenant) == ("s3", "get", "paying")
    assert s.to_dict()["tenant"] == "paying"
    # tenant-less specs keep their exact legacy shape
    s2 = SloSpec("volume.read:p99<50ms@99.9")
    assert s2.tenant == ""
    assert "tenant" not in s2.to_dict()


def test_slo_tenant_spec_matches_tenant_histogram_rows():
    from seaweedfs_tpu_torch.stats.slo import SloSpec, _TENANT_HIST, _matches
    s = SloSpec("s3.get/paying:p99<200ms@99")
    paying = (_TENANT_HIST
              + '{tier="s3",op="get",tenant="paying"}')
    abuser = (_TENANT_HIST
              + '{tier="s3",op="get",tenant="abuser"}')
    assert _matches(s, paying)
    assert not _matches(s, abuser)
    # a tenant spec never matches the tenant-less tier histogram
    assert not _matches(
        s, 'SeaweedFS_request_seconds{tier="s3",op="get"}')
    # and a tenant-less spec never matches the tenant histogram
    s2 = SloSpec("s3.get:p99<200ms@99")
    assert not _matches(s2, paying)


def test_qos_merge_payloads_sums_counters_and_takes_worst_level():
    p1 = {"qos": {"tenants": {"a": {"admitted": 3, "throttled": 1,
                                    "shed": 0, "queued": 0,
                                    "queue_depth": 1, "tokens": 2.0,
                                    "cls": "a", "weight": 2.0,
                                    "rps": 10.0, "burst": 10.0}},
                  "inflight": 2, "inflight_limit": 256, "queued": 1,
                  "shed_level": 0, "ladder": [1.0],
                  "probes": {"lag_ms": 5.0, "wait_ms": 0.0},
                  "arbiter": {"budget_mbps": 10.0, "floor": 0.25,
                              "foreground_bps": 100.0,
                              "consumers": {"scrub": {
                                  "base_bps": 100, "rate_bps": 50,
                                  "granted_bytes": 10, "yields": 1,
                                  "slept_s": 0.5}},
                              "grants": [{"wall_ms": 1}]}}}
    p2 = {"qos": {"tenants": {"a": {"admitted": 2, "throttled": 0,
                                    "shed": 4, "queued": 0,
                                    "queue_depth": 0, "tokens": 1.0,
                                    "cls": "a", "weight": 2.0,
                                    "rps": 10.0, "burst": 10.0}},
                  "inflight": 1, "inflight_limit": 256, "queued": 0,
                  "shed_level": 2, "ladder": [1.0],
                  "probes": {"lag_ms": 80.0, "wait_ms": 3.0},
                  "arbiter": {"budget_mbps": 10.0, "floor": 0.25,
                              "foreground_bps": 50.0,
                              "consumers": {"scrub": {
                                  "base_bps": 100, "rate_bps": 25,
                                  "granted_bytes": 5, "yields": 2,
                                  "slept_s": 0.25}},
                              "grants": [{"wall_ms": 2}]}}}
    m = qos.merge_payloads([p1, p2])
    assert m["workers"] == 2
    t = m["qos"]["tenants"]["a"]
    assert t["admitted"] == 5 and t["shed"] == 4 and t["throttled"] == 1
    assert m["qos"]["inflight"] == 3
    assert m["qos"]["inflight_limit"] == 512
    assert m["qos"]["shed_level"] == 2       # worst worker wins
    assert m["qos"]["probes"]["lag_ms"] == 80.0
    a = m["qos"]["arbiter"]
    assert a["foreground_bps"] == 150.0
    assert a["consumers"]["scrub"]["granted_bytes"] == 15
    assert a["consumers"]["scrub"]["yields"] == 3
    assert [g["wall_ms"] for g in a["grants"]] == [1, 2]


def test_tenant_from_headers_extracts_sigv4_and_jwt_sub():
    import base64
    import json as j
    h = {"Authorization": "AWS4-HMAC-SHA256 Credential=AKEY/20260807/"
                          "us-east-1/s3/aws4_request, SignedHeaders=x,"
                          " Signature=y"}
    assert qos.tenant_from_headers(h) == "AKEY"
    payload = base64.urlsafe_b64encode(
        j.dumps({"sub": "team-a"}).encode()).rstrip(b"=").decode()
    h = {"Authorization": f"Bearer x.{payload}.y"}
    assert qos.tenant_from_headers(h) == "team-a"
    assert qos.tenant_from_headers({}) == ""
    assert qos.tenant_from_headers({"Authorization": "Bearer junk"}) == ""
