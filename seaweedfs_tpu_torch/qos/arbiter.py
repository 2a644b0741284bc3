"""Cluster-wide bandwidth arbiter: one budget for background repair.

The scrub (-scrub.mbps), autopilot (-autopilot.mbps) and rebalance
paths each pace themselves with a private token bucket — honest
ledgers, but nothing arbitrates them against FOREGROUND traffic on
the same wire (the Facebook warehouse study, arXiv:1309.0186, found
unbudgeted repair routinely eating a large fraction of cluster
network). The arbiter closes that loop with the priority discipline
of arXiv:2306.10528: foreground-impacting work first, background
yields — but never below a starvation-proof floor, so repair always
converges.

Mechanics: the leader master publishes a byte budget (`-qos.mbps`)
through heartbeat responses; every node runs an arbiter that ADOPTS
its local background buckets (`adopt()` wraps a TokenBucket in a
drop-in facade routing `consume()` through `grant()`). Each grant
re-derives the consumer's allowed rate from live foreground pressure:

    pressure  p = min(1, foreground_bps / budget_bps)
    allowed_k   = base_k * max(floor, 1 - p)

so an idle cluster gives background its full configured rate, a
saturated one squeezes it to `floor * base` — never zero. Foreground
pressure is observed locally (server/wire.py notes every served byte)
and, on the master, aggregated from node heartbeat reports, making
the budget decision cluster-wide while each grant stays local.

Every reduction below base is a journalled `arbiter_yield`
(rate-bounded per consumer); every grant lands in a bounded ledger
(`/debug/qos`) and the `SeaweedFS_qos_arbiter_*` metrics — the
deterministic accounting the pacing-floor asserts check. The
`arbiter.grant` failpoint forces a grant to the starvation floor
(chaos: prove repair converges even when permanently squeezed).

A copy of seaweedfs_tpu/qos/arbiter.py in the PyTorch port.
"""

from __future__ import annotations

import time
from collections import deque

MiB = 1 << 20
FG_WINDOW_S = 2.0       # foreground rate observation window
NODE_REPORT_TTL_S = 15.0  # heartbeat-reported foreground freshness
LEDGER_ROWS = 64
EVENT_INTERVAL_S = 1.0


class GrantBucket:
    """Drop-in ec/scrub.TokenBucket facade: consume() routes through
    the arbiter so the owner (scrubber, autopilot executor) needs no
    code change — its bucket just became arbitrated."""

    def __init__(self, arbiter: "BandwidthArbiter", kind: str, inner):
        self._arbiter = arbiter
        self.kind = kind
        self.inner = inner

    @property
    def rate(self) -> float:
        return self.inner.rate

    @property
    def burst(self) -> float:
        return self.inner.burst

    async def consume(self, n: int) -> float:
        return await self._arbiter.grant(self.kind, n)


class BandwidthArbiter:
    """Per-process arbiter over adopted background token buckets."""

    def __init__(self, budget_mbps: float = 0.0, floor: float = 0.25,
                 now=time.monotonic):
        self.budget_bps = max(budget_mbps, 0.0) * MiB
        self.floor = min(max(floor, 0.0), 1.0)
        self._now = now
        # kind -> {"bucket": inner TokenBucket, "base": bytes/s,
        #          "granted": bytes, "yields": n, "slept_s": s}
        self._consumers: dict[str, dict] = {}
        self._fg: deque = deque()       # (t, nbytes) inside FG_WINDOW_S
        self._fg_bytes = 0.0
        self._nodes: dict[str, tuple] = {}  # node -> (t, bps)
        self.grants: deque = deque(maxlen=LEDGER_ROWS)
        self._ev_ts: dict[str, float] = {}

    # -- configuration -------------------------------------------------

    def adopt(self, kind: str, bucket) -> GrantBucket:
        """Register a background TokenBucket; its configured rate
        becomes the consumer's base entitlement."""
        self._consumers[kind] = {"bucket": bucket, "base": bucket.rate,
                                 "granted": 0, "yields": 0,
                                 "slept_s": 0.0}
        return GrantBucket(self, kind, bucket)

    def set_budget_mbps(self, mbps: float) -> None:
        """Leader-published budget pickup (heartbeat response)."""
        self.budget_bps = max(float(mbps), 0.0) * MiB

    # -- foreground pressure -------------------------------------------

    def note_foreground(self, nbytes: int) -> None:
        """One served foreground request's bytes (hot path: O(1)
        amortized — stale window entries retire on observation)."""
        now = self._now()
        self._fg.append((now, nbytes))
        self._fg_bytes += nbytes
        self._trim(now)

    def _trim(self, now: float) -> None:
        fg = self._fg
        cut = now - FG_WINDOW_S
        while fg and fg[0][0] < cut:
            self._fg_bytes -= fg.popleft()[1]

    def note_node_foreground(self, node: str, bps: float) -> None:
        """A heartbeat-reported foreground rate from one cluster node
        (master-side: makes the autopilot grant cluster-aware)."""
        self._nodes[node] = (self._now(), float(bps))

    def foreground_bps(self) -> float:
        """Local windowed foreground rate + fresh node reports."""
        now = self._now()
        self._trim(now)
        total = self._fg_bytes / FG_WINDOW_S
        for node, (t, bps) in list(self._nodes.items()):
            if now - t > NODE_REPORT_TTL_S:
                del self._nodes[node]
            else:
                total += bps
        return total

    # -- granting ------------------------------------------------------

    def rate_for(self, kind: str) -> float:
        """The rate this consumer is entitled to RIGHT NOW."""
        c = self._consumers.get(kind)
        if c is None:
            return 0.0
        base = c["base"]
        if base <= 0 or self.budget_bps <= 0:
            return base          # unpaced or arbiter disabled
        p = min(1.0, self.foreground_bps() / self.budget_bps)
        return base * max(self.floor, 1.0 - p)

    async def grant(self, kind: str, nbytes: int) -> float:
        """Admit nbytes of background work, pacing at the arbitrated
        rate; returns seconds slept (TokenBucket.consume contract)."""
        from ..stats import metrics
        from ..util import events, failpoints
        c = self._consumers.get(kind)
        if c is None:
            return 0.0
        rate = self.rate_for(kind)
        try:
            await failpoints.fail("arbiter.grant")
        except OSError:
            # chaos: squeeze this grant to the starvation floor — the
            # guarantee under test is that repair still converges
            if c["base"] > 0:
                rate = c["base"] * self.floor
        bucket = c["bucket"]
        yielded = c["base"] > 0 and rate < c["base"] - 1e-9
        if yielded:
            c["yields"] += 1
            if metrics.HAVE_PROMETHEUS:
                metrics.QOS_ARBITER_YIELDS.labels(kind).inc()
            now = self._now()
            if now - self._ev_ts.get(kind, -1e9) >= EVENT_INTERVAL_S:
                self._ev_ts[kind] = now
                events.record("arbiter_yield", kind=kind,
                              rate_bps=int(rate),
                              base_bps=int(c["base"]),
                              foreground_bps=int(self.foreground_bps()))
        bucket.rate = rate
        slept = await bucket.consume(nbytes)
        c["granted"] += nbytes
        c["slept_s"] += slept
        if metrics.HAVE_PROMETHEUS:
            metrics.QOS_ARBITER_GRANTED.labels(kind).inc(nbytes)
            metrics.QOS_ARBITER_RATE.labels(kind).set(round(rate, 1))
            metrics.QOS_FOREGROUND_BPS.set(
                round(self.foreground_bps(), 1))
        self.grants.append({"kind": kind, "bytes": int(nbytes),
                            "rate_bps": int(rate),
                            "slept_s": round(slept, 4),
                            "yielded": yielded,
                            "wall_ms": int(time.time() * 1000)})
        return slept

    # -- introspection (/debug/qos) ------------------------------------

    def to_dict(self) -> dict:
        return {
            "budget_mbps": round(self.budget_bps / MiB, 3),
            "floor": self.floor,
            "foreground_bps": round(self.foreground_bps(), 1),
            "consumers": {
                kind: {"base_bps": int(c["base"]),
                       "rate_bps": int(self.rate_for(kind)),
                       "granted_bytes": int(c["granted"]),
                       "yields": c["yields"],
                       "slept_s": round(c["slept_s"], 3)}
                for kind, c in self._consumers.items()},
            "grants": list(self.grants)[-16:],
        }
