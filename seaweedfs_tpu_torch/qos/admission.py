"""Per-tenant admission: token-bucket rate limits, a weighted-fair
queue in front of the event loop, and priority-aware load shedding.

Tenancy model: every request entering an S3 / filer / WebDAV tier is
classified by its access key (SigV4 credential) or JWT identity into a
*tenant class* configured via repeatable `-qos.tenant
"key:weight:rps[:burst]"` flags; unknown identities fall into the
`default` class. The controller then applies, in order:

1. **overload shedding** — when the saturation probes
   (stats/saturation.py: event-loop lag, executor queue wait) cross
   the armed `-qos.shed.lagms` / `-qos.shed.waitms` thresholds, the
   lowest-weight classes are shed FIRST (503 + Retry-After), one
   ladder rung per `LEVEL_STEP_S`, with hysteresis on recovery. The
   highest-weight class is never overload-shed — its protection is
   the point of the ladder (it still rate-limits).
2. **per-tenant rate limit** — a non-sleeping token bucket per class;
   a drained bucket answers 429 with `Retry-After` computed from the
   bucket's own refill, never a guess.
3. **weighted-fair queueing** — when the process is at its in-flight
   limit, waiters park in a virtual-time WFQ (start-time fair
   queueing: backlogged classes are served in proportion to weight).
   A waiter that would exceed `queue_deadline_s` is shed with 503 —
   requests are never silently queued past a deadline.

Every throttle/shed decision lands in the metrics
(`SeaweedFS_qos_decisions_total`) and — rate-bounded per tenant — the
event journal (`tenant_shed`), so SLO evidence can correlate a paying
tenant's burn with the abuser being shed. The `qos.admit` failpoint
lets chaos force any decision path.

References: start-time fair queueing (Goyal et al.) for the virtual
clock; the priority discipline of arXiv:2306.10528 (foreground-
impacting work first) for the shed ladder.

A copy of seaweedfs_tpu/qos/admission.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import heapq
import time

DEFAULT = "default"


class TenantClass:
    """One configured tenant: identity key == class name."""

    __slots__ = ("name", "weight", "rps", "burst")

    def __init__(self, name: str, weight: float, rps: float,
                 burst: float | None = None):
        self.name = name
        self.weight = weight
        self.rps = rps
        self.burst = burst if burst is not None else max(rps, 1.0)

    def to_dict(self) -> dict:
        return {"weight": self.weight, "rps": self.rps,
                "burst": self.burst}


def parse_tenant_flag(spec: str) -> TenantClass:
    """Parse one `-qos.tenant "key:weight:rps[:burst]"` value.

    Raises ValueError on malformed specs — cli init refuses them at
    boot (the slo.init discipline: a typo'd policy must not silently
    admit everything)."""
    parts = [p.strip() for p in spec.split(":")]
    if len(parts) not in (3, 4):
        raise ValueError(
            f"qos.tenant {spec!r}: want key:weight:rps[:burst]")
    key = parts[0]
    try:
        weight = float(parts[1])
        rps = float(parts[2])
        burst = float(parts[3]) if len(parts) == 4 else None
    except ValueError:
        raise ValueError(f"qos.tenant {spec!r}: non-numeric field")
    if not key:
        raise ValueError(f"qos.tenant {spec!r}: empty key")
    if weight <= 0:
        raise ValueError(f"qos.tenant {spec!r}: weight must be > 0")
    if rps < 0:
        raise ValueError(f"qos.tenant {spec!r}: rps must be >= 0")
    if burst is not None and burst <= 0:
        raise ValueError(f"qos.tenant {spec!r}: burst must be > 0")
    return TenantClass(key, weight, rps, burst)


def parse_tenant_flags(specs) -> "dict[str, TenantClass]":
    """All -qos.tenant flags -> {key: TenantClass}, with a `default`
    class (weight 1, unlimited rps) ensured for unknown identities."""
    out: dict[str, TenantClass] = {}
    for spec in specs or ():
        t = parse_tenant_flag(spec)
        if t.name in out:
            raise ValueError(f"qos.tenant {spec!r}: duplicate key")
        out[t.name] = t
    if DEFAULT not in out:
        out[DEFAULT] = TenantClass(DEFAULT, 1.0, 0.0, 1.0)
    return out


class RateBucket:
    """Non-sleeping token bucket for request admission.

    Unlike ec/scrub.TokenBucket (which paces by sleeping), admission
    must answer NOW: try_take() either debits and returns 0.0, or
    leaves the bucket untouched and returns the seconds until the
    deficit refills — exactly the honest `Retry-After` value.
    rate <= 0 disables the limit. Injectable clock for determinism."""

    __slots__ = ("rate", "burst", "_tokens", "_last", "_now")

    def __init__(self, rate: float, burst: float | None = None,
                 now=time.monotonic):
        self.rate = rate
        self.burst = burst if burst is not None else max(rate, 1.0)
        self._now = now
        self._tokens = self.burst
        self._last = now()

    def _refill(self) -> None:
        now = self._now()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> float:
        """0.0 = admitted (n debited); > 0 = denied, retry after."""
        if self.rate <= 0:
            return 0.0
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return 0.0
        return (n - self._tokens) / self.rate

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until n tokens are available (0.0 if now/unlimited)."""
        if self.rate <= 0:
            return 0.0
        self._refill()
        if self._tokens >= n:
            return 0.0
        return (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


class WFQ:
    """Virtual-time weighted fair queue (start-time fair queueing).

    push() tags an item with a virtual finish time
    `vf = max(V, last_vf[tenant]) + cost / weight`; pop() serves the
    smallest vf and advances V to it. Backlogged tenants therefore
    receive service in proportion to their weights; an idle tenant
    re-enters at the current virtual clock (no banked credit). Ties
    break on arrival order — the whole structure is deterministic for
    identical push/pop sequences, which the property tests rely on."""

    def __init__(self, weights: "dict[str, float]"):
        self._w = dict(weights)
        self._v = 0.0
        self._last: dict[str, float] = {}
        self._heap: list = []
        self._seq = 0
        self._depth: dict[str, int] = {}

    def push(self, tenant: str, item, cost: float = 1.0) -> None:
        w = max(self._w.get(tenant, 1.0), 1e-9)
        vf = max(self._v, self._last.get(tenant, 0.0)) + cost / w
        self._last[tenant] = vf
        heapq.heappush(self._heap, (vf, self._seq, tenant, item))
        self._seq += 1
        self._depth[tenant] = self._depth.get(tenant, 0) + 1

    def pop(self):
        """(tenant, item) with the smallest virtual finish, or None."""
        if not self._heap:
            return None
        vf, _, tenant, item = heapq.heappop(self._heap)
        self._v = max(self._v, vf)
        d = self._depth.get(tenant, 1) - 1
        if d:
            self._depth[tenant] = d
        else:
            self._depth.pop(tenant, None)
        return tenant, item

    def __len__(self) -> int:
        return len(self._heap)

    def depth(self, tenant: str) -> int:
        return self._depth.get(tenant, 0)

    def depths(self) -> dict:
        return dict(self._depth)


class Decision:
    """Outcome of one admission attempt. `tenant` is the BOUNDED
    metric label for the raw identity (stats/metrics.BoundedLabelSet);
    `cls` is the tenant class that policy applied."""

    __slots__ = ("admitted", "status", "retry_after_s", "tenant", "cls",
                 "reason", "queued_s")

    def __init__(self, admitted: bool, status: int = 200,
                 retry_after_s: float = 0.0, tenant: str = "",
                 cls: str = DEFAULT, reason: str = "",
                 queued_s: float = 0.0):
        self.admitted = admitted
        self.status = status
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        self.cls = cls
        self.reason = reason
        self.queued_s = queued_s


def _default_probe() -> "tuple[float, float]":
    """(event-loop lag ms, executor queue wait ms) — live values from
    the saturation probes."""
    from ..stats import saturation
    return (saturation.current_lag_s() * 1000.0,
            saturation.current_exec_wait_s() * 1000.0)


class AdmissionController:
    """The per-process admission plane one entry tier consults."""

    LEVEL_STEP_S = 0.5      # at most one shed-ladder rung per step
    RECOVER_FRAC = 0.7      # hysteresis: recover below 70% of threshold
    EVENT_INTERVAL_S = 1.0  # tenant_shed journal rows, per tenant

    def __init__(self, tenants: "dict[str, TenantClass]", *,
                 lag_shed_ms: float = 0.0, wait_shed_ms: float = 0.0,
                 inflight_limit: int = 256,
                 queue_deadline_s: float = 2.0,
                 now=time.monotonic, probe=None, label_cap: int = 32):
        from ..stats import metrics
        self.tenants = dict(tenants)
        if DEFAULT not in self.tenants:
            self.tenants[DEFAULT] = TenantClass(DEFAULT, 1.0, 0.0, 1.0)
        self.lag_shed_ms = lag_shed_ms
        self.wait_shed_ms = wait_shed_ms
        self.inflight_limit = inflight_limit
        self.queue_deadline_s = queue_deadline_s
        self._now = now
        self._probe = probe or _default_probe
        self._buckets = {n: RateBucket(t.rps, t.burst, now=now)
                         for n, t in self.tenants.items()}
        self._wfq = WFQ({n: t.weight for n, t in self.tenants.items()})
        self._inflight = 0
        # the shed ladder: distinct class weights ascending, top class
        # excluded — overload sheds the lowest classes first and never
        # the highest (that protection is the whole point)
        distinct = sorted({t.weight for t in self.tenants.values()})
        self._ladder = distinct[:-1]
        self._level = 0
        self._level_ts = -1e9
        self._labels = metrics.BoundedLabelSet(seed=self.tenants,
                                               cap=label_cap)
        self._counts: dict[str, dict] = {}
        self._ev_ts: dict[str, float] = {}

    # -- classification ------------------------------------------------

    def classify(self, key: str) -> TenantClass:
        return self.tenants.get(key) or self.tenants[DEFAULT]

    def label_of(self, key: str) -> str:
        return self._labels.get(key or "anonymous")

    # -- shed ladder ---------------------------------------------------

    def _severity(self) -> float:
        """>= 1.0 means a saturation probe crossed its armed
        threshold. 0.0 when no threshold is armed."""
        lag_ms, wait_ms = self._probe()
        s = 0.0
        if self.lag_shed_ms > 0:
            s = max(s, lag_ms / self.lag_shed_ms)
        if self.wait_shed_ms > 0:
            s = max(s, wait_ms / self.wait_shed_ms)
        return s

    def _update_level(self) -> None:
        if not self._ladder or (self.lag_shed_ms <= 0
                                and self.wait_shed_ms <= 0):
            return
        now = self._now()
        if now - self._level_ts < self.LEVEL_STEP_S:
            return
        s = self._severity()
        if s >= 1.0 and self._level < len(self._ladder):
            self._level += 1
            self._level_ts = now
        elif s < self.RECOVER_FRAC and self._level > 0:
            self._level -= 1
            self._level_ts = now

    def _overloaded(self, cls: TenantClass) -> bool:
        return (self._level > 0
                and cls.weight <= self._ladder[self._level - 1])

    # -- bookkeeping ---------------------------------------------------

    def _count(self, label: str) -> dict:
        c = self._counts.get(label)
        if c is None:
            c = self._counts[label] = {"admitted": 0, "throttled": 0,
                                       "shed": 0, "queued": 0}
        return c

    def _reject(self, label: str, cls: TenantClass, status: int,
                reason: str, tier: str, op: str,
                retry_after: float = 0.0) -> Decision:
        from ..stats import metrics
        from ..util import events
        if retry_after <= 0.0:
            # no per-tenant refill to anchor on: the honest floor is
            # one ladder evaluation period
            retry_after = self._buckets[cls.name].retry_after() \
                or 2 * self.LEVEL_STEP_S
        kind = "throttled" if status == 429 else "shed"
        self._count(label)[kind] += 1
        if metrics.HAVE_PROMETHEUS:
            metrics.QOS_DECISIONS.labels(
                label, "throttle" if status == 429 else "shed").inc()
        now = self._now()
        # journal rows are rate-bounded per tenant: an abuser at full
        # throttle must not flood the ring that holds its own evidence
        if now - self._ev_ts.get(label, -1e9) >= self.EVENT_INTERVAL_S:
            self._ev_ts[label] = now
            events.record("tenant_shed", tenant=label, cls=cls.name,
                          reason=reason, status=status, tier=tier,
                          op=op, retry_after_s=round(retry_after, 3))
        return Decision(False, status=status, retry_after_s=retry_after,
                        tenant=label, cls=cls.name, reason=reason)

    # -- the admission path --------------------------------------------

    async def acquire(self, tier: str, op: str, key: str) -> Decision:
        """Admit, throttle (429), queue, or shed (503) one request."""
        from ..stats import metrics
        from ..util import failpoints
        cls = self.classify(key or "")
        label = self.label_of(key)
        try:
            await failpoints.fail("qos.admit")
        except OSError as e:
            # whatever status the injected fault carries, the contract
            # to the client is an honest shed: 429/503 + Retry-After
            status = getattr(e, "status", 503) or 503
            if status not in (429, 503):
                status = 503
            return self._reject(label, cls, status, "failpoint",
                                tier, op)
        self._update_level()
        if self._overloaded(cls):
            return self._reject(label, cls, 503, "overload", tier, op)
        ra = self._buckets[cls.name].try_take()
        if ra > 0.0:
            return self._reject(label, cls, 429, "throttle", tier, op,
                                retry_after=ra)
        queued_s = 0.0
        if self._inflight >= self.inflight_limit:
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            self._wfq.push(cls.name, fut)
            self._count(label)["queued"] += 1
            if metrics.HAVE_PROMETHEUS:
                metrics.QOS_QUEUE_DEPTH.labels(cls.name).set(
                    self._wfq.depth(cls.name))
            t0 = self._now()
            try:
                # never silently queue past the deadline: a waiter
                # that can't be served in time is shed with an honest
                # Retry-After instead of adding invisible latency
                await asyncio.wait_for(fut, self.queue_deadline_s)
            except asyncio.TimeoutError:
                return self._reject(label, cls, 503, "queue_deadline",
                                    tier, op)
            finally:
                queued_s = self._now() - t0
                if metrics.HAVE_PROMETHEUS:
                    metrics.QOS_QUEUE_DEPTH.labels(cls.name).set(
                        self._wfq.depth(cls.name))
        self._inflight += 1
        self._count(label)["admitted"] += 1
        if metrics.HAVE_PROMETHEUS:
            metrics.QOS_DECISIONS.labels(label, "admit").inc()
        return Decision(True, tenant=label, cls=cls.name,
                        queued_s=queued_s)

    def release(self, dec: Decision) -> None:
        """Request finished: free the slot and wake the next waiter in
        weighted-fair order (skipping waiters that already timed out)."""
        from ..stats import metrics
        if not dec.admitted:
            return
        self._inflight = max(0, self._inflight - 1)
        while self._inflight < self.inflight_limit:
            nxt = self._wfq.pop()
            if nxt is None:
                return
            tenant, fut = nxt
            if metrics.HAVE_PROMETHEUS:
                metrics.QOS_QUEUE_DEPTH.labels(tenant).set(
                    self._wfq.depth(tenant))
            if fut.done():        # deadline-shed while queued
                continue
            fut.set_result(None)  # the waiter claims the freed slot
            return

    def observe(self, tier: str, op: str, dec: Decision,
                seconds: float) -> None:
        """Per-tenant latency attribution — the histogram per-tenant
        -slo objectives evaluate against."""
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.QOS_TENANT_REQUEST_TIME.labels(
                tier, op, dec.tenant).observe(seconds)

    # -- introspection (/debug/qos) ------------------------------------

    def to_dict(self) -> dict:
        lag_ms, wait_ms = self._probe()
        depths = self._wfq.depths()
        tenants = {}
        for label, counts in sorted(self._counts.items()):
            cls = self.classify(label)
            row = dict(counts)
            row.update(cls=cls.name, weight=cls.weight, rps=cls.rps,
                       burst=cls.burst,
                       tokens=round(self._buckets[cls.name].tokens, 3),
                       queue_depth=depths.get(cls.name, 0))
            tenants[label] = row
        for name, cls in self.tenants.items():
            if name not in tenants:
                tenants[name] = {
                    "admitted": 0, "throttled": 0, "shed": 0,
                    "queued": 0, "cls": name, "weight": cls.weight,
                    "rps": cls.rps, "burst": cls.burst,
                    "tokens": round(self._buckets[name].tokens, 3),
                    "queue_depth": depths.get(name, 0)}
        return {
            "tenants": tenants,
            "inflight": self._inflight,
            "inflight_limit": self.inflight_limit,
            "queued": len(self._wfq),
            "queue_deadline_s": self.queue_deadline_s,
            "shed_level": self._level,
            "ladder": self._ladder,
            "thresholds": {"lag_ms": self.lag_shed_ms,
                           "wait_ms": self.wait_shed_ms},
            "probes": {"lag_ms": round(lag_ms, 3),
                       "wait_ms": round(wait_ms, 3)},
        }
