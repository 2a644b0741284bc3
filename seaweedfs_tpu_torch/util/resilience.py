"""Retry policies and circuit breakers for every inter-server hop.

Reference: the reference client retries assign/upload in a fixed loop
(operation/upload_content.go) and survives dead masters via wdclient
leader-chasing (wdclient/masterclient.go:45-119); it has no backoff
discipline and no breaker, so a dead volume server is re-dialed at full
rate by every caller until its TCP timeouts drain the fleet.

This module gives the tree the two standard primitives:

* ``RetryPolicy`` — exponential backoff with FULL jitter (the AWS
  architecture-blog shape: sleep = uniform(0, min(cap, base·2^n))),
  a per-attempt deadline, a total deadline, and an optional shared
  ``RetryBudget`` so a brown-out cannot amplify into a retry storm.

* ``CircuitBreaker`` — per-upstream closed → open → half-open state
  machine: `threshold` consecutive failures open it, `reset_timeout`
  later a limited number of half-open probes are let through, one
  success closes it again. While open, callers fail (or skip the
  upstream) in microseconds instead of burning a connect timeout.

Both take injectable ``clock``/``rng`` so the state machines unit-test
without wall-clock sleeps.

A copy of seaweedfs_tpu/util/resilience.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import random
import time

__all__ = ["RetryBudget", "RetryPolicy", "CircuitBreaker",
           "BreakerRegistry", "Backoff"]


class RetryBudget:
    """Token bucket bounding the fleet-wide retry amplification factor.

    Every first attempt deposits `ratio` tokens; every retry withdraws
    one. When the bucket is empty, retries are denied and the caller
    fails fast — under a full outage the extra load from retries is
    bounded at `ratio` of the offered load (the SRE-book discipline).

    The budget is KEYED (upstream + tenant class, util/client.py):
    each key gets its own token pool, so an abusive tenant burning
    retries against one flapping volume exhausts only its own pool —
    a paying tenant retrying against a healthy upstream is untouched.
    The un-keyed calls ("" key) keep the original process-global
    behavior. Pools are capped; past the cap everything shares an
    overflow pool rather than growing without bound."""

    MAX_POOLS = 256
    OVERFLOW = "~overflow"

    def __init__(self, ratio: float = 0.2, burst: float = 10.0):
        self.ratio = ratio
        self.burst = burst
        self._pools: dict[str, float] = {"": burst}

    def _key(self, key: str) -> str:
        if key in self._pools or len(self._pools) < self.MAX_POOLS:
            return key
        return self.OVERFLOW

    def record_attempt(self, key: str = "") -> None:
        k = self._key(key)
        self._pools[k] = min(self.burst,
                             self._pools.get(k, self.burst) + self.ratio)

    def allow_retry(self, key: str = "") -> bool:
        k = self._key(key)
        tokens = self._pools.get(k, self.burst)
        if tokens >= 1.0:
            self._pools[k] = tokens - 1.0
            return True
        self._pools[k] = tokens
        return False

    @property
    def tokens(self) -> float:
        """The process-global pool (back-compat introspection)."""
        return self._pools.get("", self.burst)

    @tokens.setter
    def tokens(self, value: float) -> None:
        self._pools[""] = value

    def to_dict(self) -> dict:
        return {k or "(global)": round(v, 3)
                for k, v in sorted(self._pools.items())}


class RetryPolicy:
    """Exponential backoff with full jitter + deadlines.

    Usage (attempt loop — break on success, `continue` retries):

        async for attempt in policy.attempts():
            try:
                return await do_thing()
            except TransientError as e:
                last = e
        raise OperationError(last)

    The generator sleeps the backoff BETWEEN yields, stops yielding
    when attempts or the total deadline run out, and consults the
    shared budget (when configured) before every retry.
    """

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, total_timeout: float = 30.0,
                 per_attempt_timeout: float | None = None,
                 budget: RetryBudget | None = None,
                 rng: random.Random | None = None,
                 clock=time.monotonic, sleep=None, name: str = ""):
        self.name = name            # journal attribution (events.py)
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.total_timeout = total_timeout
        self.per_attempt_timeout = per_attempt_timeout
        self.budget = budget
        self._rng = rng or random
        self._clock = clock
        self._sleep = sleep or asyncio.sleep

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before retry number `attempt` (1-based)."""
        cap = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        return self._rng.uniform(0, cap)

    async def attempts(self, budget_key: str = ""):
        """Async generator of attempt indices 0..max_attempts-1.

        `budget_key` selects the retry-budget pool (upstream + tenant
        class, see RetryBudget) — callers that know their upstream
        pass it so one flapping target can't drain everyone's
        retries; the default keeps the process-global pool."""
        deadline = self._clock() + self.total_timeout
        for attempt in range(self.max_attempts):
            if attempt:
                if self.budget is not None and \
                        not self.budget.allow_retry(budget_key):
                    # budget exhausted: fail fast — and journal it,
                    # because a brown-out's retry storm hitting the
                    # ceiling is exactly the transition an operator
                    # reading /debug/health evidence needs to see
                    from . import events
                    events.record("retry_budget_exhausted",
                                  name=self.name, key=budget_key,
                                  attempt=attempt)
                    return
                delay = self.backoff(attempt)
                if self._clock() + delay >= deadline:
                    return
                await self._sleep(delay)
            elif self.budget is not None:
                self.budget.record_attempt(budget_key)
            if self._clock() >= deadline:
                return
            yield attempt


class CircuitBreaker:
    """Closed / open / half-open breaker for one upstream."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 5, reset_timeout: float = 10.0,
                 half_open_max: int = 1, clock=time.monotonic,
                 name: str = ""):
        self.threshold = threshold
        self.reset_timeout = reset_timeout
        self.half_open_max = half_open_max
        self._clock = clock
        self.name = name            # upstream key, journal attribution
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probes = 0             # in-flight half-open probes
        self.open_count = 0         # times the breaker tripped (stats)

    def blocking(self) -> bool:
        """Side-effect-free peek: is this upstream currently shed?
        (Unlike allow(), never transitions state nor consumes a
        half-open probe — safe for ordering/demotion decisions.)"""
        return self.state == self.OPEN and \
            self._clock() - self.opened_at < self.reset_timeout

    def allow(self) -> bool:
        """May a request be sent to this upstream right now?"""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if self._clock() - self.opened_at >= self.reset_timeout:
                self.state = self.HALF_OPEN
                self.probes = 0
            else:
                return False
        # half-open: a bounded number of probes
        if self.probes < self.half_open_max:
            self.probes += 1
            return True
        return False

    def record_success(self) -> None:
        # closes from ANY state: the read path tries demoted (open)
        # upstreams last instead of skipping them, and a success there
        # is direct evidence of health
        if self.state != self.CLOSED:
            from . import events
            events.record("breaker_close", upstream=self.name,
                          was=self.state)
        self.state = self.CLOSED
        self.failures = 0
        self.probes = 0

    def record_failure(self) -> None:
        if self.state == self.HALF_OPEN:
            # the probe failed: re-open and restart the reset clock
            self.state = self.OPEN
            self.opened_at = self._clock()
            self.open_count += 1
            return
        self.failures += 1
        if self.state == self.CLOSED and self.failures >= self.threshold:
            self.state = self.OPEN
            self.opened_at = self._clock()
            self.open_count += 1
            from . import events
            events.record("breaker_open", upstream=self.name,
                          failures=self.failures)

    def to_dict(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "open_count": self.open_count}


class BreakerRegistry:
    """One CircuitBreaker per upstream key (host:port)."""

    def __init__(self, threshold: int = 5, reset_timeout: float = 10.0,
                 half_open_max: int = 1, clock=time.monotonic):
        self.threshold = threshold
        self.reset_timeout = reset_timeout
        self.half_open_max = half_open_max
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, upstream: str) -> CircuitBreaker:
        b = self._breakers.get(upstream)
        if b is None:
            if len(self._breakers) > 4096:
                # upstream keys derive from lookups; bound the registry
                self._breakers.clear()
            b = self._breakers[upstream] = CircuitBreaker(
                self.threshold, self.reset_timeout, self.half_open_max,
                clock=self._clock, name=upstream)
        return b

    def to_dict(self) -> dict:
        return {k: b.to_dict() for k, b in self._breakers.items()}


class Backoff:
    """Stateful exponential backoff with full jitter, for reconnect
    loops (MasterClient stream, heartbeat seed rotation): `next()`
    returns the sleep before the next try, `reset()` after success."""

    def __init__(self, base: float = 0.5, cap: float = 15.0,
                 rng: random.Random | None = None):
        self.base = base
        self.cap = cap
        self._rng = rng or random
        self._n = 0

    def next(self) -> float:
        delay = self._rng.uniform(0, min(self.cap,
                                         self.base * (2 ** self._n)))
        if self.base * (2 ** self._n) < self.cap:
            self._n += 1
        return delay

    def reset(self) -> None:
        self._n = 0
