"""Unit tests for util/resilience.py: RetryPolicy backoff/deadline/
budget and the CircuitBreaker closed/open/half-open state machine
(including the half-open recovery the chaos acceptance demands).

The cases of tests/test_resilience.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

import asyncio

import pytest

from seaweedfs_tpu_torch.util.resilience import (
    Backoff, BreakerRegistry, CircuitBreaker, RetryBudget, RetryPolicy)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class MaxRng:
    """uniform(a, b) -> b: deterministic worst-case jitter."""

    def uniform(self, a, b):
        return b


def run(coro):
    return asyncio.run(coro)


def make_policy(clock, sleeps, **kw):
    async def fake_sleep(d):
        sleeps.append(d)
        clock.t += d
    kw.setdefault("rng", MaxRng())
    return RetryPolicy(clock=clock, sleep=fake_sleep, **kw)


# ---- RetryPolicy ----

def test_retry_backoff_is_exponential_and_capped():
    clock, sleeps = FakeClock(), []
    policy = make_policy(clock, sleeps, max_attempts=5, base_delay=1.0,
                         max_delay=4.0, total_timeout=1000.0)

    async def go():
        return [a async for a in policy.attempts()]

    assert run(go()) == [0, 1, 2, 3, 4]
    # full-jitter upper bounds: min(cap, base * 2^(n-1))
    assert sleeps == [1.0, 2.0, 4.0, 4.0]


def test_retry_total_deadline_stops_attempts():
    clock, sleeps = FakeClock(), []
    # every backoff is 2s (MaxRng); deadline 3s in: one retry fits,
    # the second would land past the deadline
    policy = make_policy(clock, sleeps, max_attempts=10, base_delay=2.0,
                         max_delay=2.0, total_timeout=3.0)

    async def go():
        return [a async for a in policy.attempts()]

    assert run(go()) == [0, 1]


def test_retry_budget_denies_when_exhausted():
    clock, sleeps = FakeClock(), []
    budget = RetryBudget(ratio=0.1, burst=1.0)
    policy = make_policy(clock, sleeps, max_attempts=10, base_delay=0.01,
                         total_timeout=100.0, budget=budget)

    async def go():
        return [a async for a in policy.attempts()]

    # burst allows exactly one retry; the deposit from the first
    # attempt (0.1) is below the withdrawal unit
    assert run(go()) == [0, 1]
    # successes refill the budget ratio-by-ratio
    for _ in range(10):
        budget.record_attempt()
    assert run(go()) == [0, 1]


def test_retry_budget_is_shared_across_policies():
    budget = RetryBudget(ratio=0.2, burst=2.0)
    assert budget.allow_retry()
    assert budget.allow_retry()
    assert not budget.allow_retry()


# ---- CircuitBreaker ----

def test_breaker_opens_after_threshold_and_half_open_recovers():
    clock = FakeClock()
    br = CircuitBreaker(threshold=3, reset_timeout=10.0, clock=clock)
    assert br.state == br.CLOSED
    for _ in range(3):
        assert br.allow()
        br.record_failure()
    # OPEN: requests are shed instantly
    assert br.state == br.OPEN
    assert not br.allow()
    assert br.open_count == 1
    # reset_timeout later: HALF-OPEN lets a bounded probe through
    clock.t += 10.0
    assert br.allow()
    assert br.state == br.HALF_OPEN
    assert not br.allow()          # only half_open_max probes
    # the probe succeeds: breaker closes, failures reset
    br.record_success()
    assert br.state == br.CLOSED
    assert br.failures == 0
    assert br.allow()


def test_breaker_half_open_failure_reopens():
    clock = FakeClock()
    br = CircuitBreaker(threshold=2, reset_timeout=5.0, clock=clock)
    br.record_failure()
    br.record_failure()
    assert br.state == br.OPEN
    clock.t += 5.0
    assert br.allow()              # probe
    br.record_failure()            # probe failed
    assert br.state == br.OPEN
    assert not br.allow()          # reset clock restarted
    assert br.open_count == 2
    clock.t += 5.0
    assert br.allow()


def test_breaker_success_resets_failure_streak():
    br = CircuitBreaker(threshold=3)
    br.record_failure()
    br.record_failure()
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == br.CLOSED   # never 3 consecutive


def test_breaker_blocking_peek_is_side_effect_free():
    """read_stream orders locations with blocking(); it must never
    transition state nor consume half-open probes (the wedged-half-open
    regression: a probe consumed by a sort key was never resolved)."""
    clock = FakeClock()
    br = CircuitBreaker(threshold=1, reset_timeout=5.0, clock=clock)
    br.record_failure()
    assert br.state == br.OPEN
    assert br.blocking()
    clock.t += 5.0
    for _ in range(5):
        assert not br.blocking()   # repeated peeks consume nothing
    assert br.state == br.OPEN     # no transition from peeking
    assert br.allow()              # the real probe is still available
    assert br.state == br.HALF_OPEN
    br.record_success()
    assert br.state == br.CLOSED


def test_breaker_registry_is_per_upstream():
    clock = FakeClock()
    reg = BreakerRegistry(threshold=1, clock=clock)
    reg.get("a:1").record_failure()
    assert reg.get("a:1").state == CircuitBreaker.OPEN
    assert reg.get("b:2").state == CircuitBreaker.CLOSED
    assert "a:1" in reg.to_dict()


# ---- Backoff ----

def test_backoff_grows_and_resets():
    b = Backoff(base=1.0, cap=8.0, rng=MaxRng())
    assert [b.next() for _ in range(5)] == [1.0, 2.0, 4.0, 8.0, 8.0]
    b.reset()
    assert b.next() == 1.0


@pytest.mark.parametrize("n", [1, 3])
def test_policy_attempts_is_reusable(n):
    clock, sleeps = FakeClock(), []
    policy = make_policy(clock, sleeps, max_attempts=n, base_delay=0.01,
                         total_timeout=100.0)

    async def go():
        out = []
        for _ in range(2):          # the same policy, two operations
            out.append([a async for a in policy.attempts()])
        return out

    assert run(go()) == [list(range(n))] * 2
