"""Structured cluster event journal — the flight recorder's black box.

Metrics say HOW MUCH and traces say WHERE THE TIME WENT, but neither
answers "what state transitions happened around the bad minute":
breaker trips, retry-budget exhaustion, EC holder-map refreshes, scrub
corruption reports, volume mounts/vacuums, worker respawns and
group-commit fsync upgrades all used to vanish into glog.  This module
is a typed, bounded, per-process ring of exactly those transitions.

Each event records:

- ``type``    — one of :data:`TYPES` (the documented vocabulary;
  ROBUSTNESS.md catalogs what each means and which subsystem emits it)
- ``wall``    — ``time.time()`` seconds, the cross-process timeline key
  (same discipline as span ``start_ms``: wall for ALIGNMENT only)
- ``mono``    — ``time.perf_counter()`` at record time, so in-process
  deltas between events are NTP-step-proof
- ``trace``   — the active trace id when the transition happened inside
  a traced request (empty otherwise), the cross-link into
  ``/debug/traces``
- free-form small fields (upstream, vid, offset, ...)

Recording is cheap (one lock + deque append), never raises into the
caller (a breaker trip must not fail the request that tripped it), and
feeds ``SeaweedFS_events_total{type}`` so the journal and Prometheus
agree by construction.  Exposed as ``/debug/events`` on every daemon
(``/__debug__/events`` on the path-shadowing gateways), whole-host
merged under ``-workers`` like ``/metrics``.

A copy of seaweedfs_tpu/util/events.py in the PyTorch port.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import glog

# the documented event vocabulary; an unknown type is recorded anyway
# (losing evidence is worse than a typo) but logged once so the typo
# gets fixed — ROBUSTNESS.md is the human-facing catalog
TYPES = frozenset({
    "breaker_open",             # circuit breaker closed/half-open -> open
    "breaker_close",            # breaker recovered -> closed
    "retry_budget_exhausted",   # RetryPolicy denied a retry: budget empty
    "holder_refresh",           # EC holder map invalidated + forced re-lookup
    "scrub_corruption",         # parity scrubber found a corrupt window
    "ec_rot_found",             # a degraded read or a rebuild pinned rot
                                # to one survivor and left it out
    "volume_mount",             # store mounted/loaded a volume
    "volume_unmount",
    "volume_vacuum",            # compaction committed (offsets moved)
    "ec_mount",                 # EC shards mounted
    "ec_unmount",
    "worker_respawn",           # supervisor respawned a dead worker
    "fsync_upgrade",            # deepest-yet group-commit batch shared
                                # one durable fsync point
    "autopilot_action",         # maintenance plane executed (or
                                # dry-ran) a repair/vacuum/tier action,
                                # with the planner's `reason`
    "autopilot_defer",          # an action was planned but NOT run
                                # (unrepairable, no target, cooldown,
                                # queue-full, paused-too-long)
    "autopilot_pause",          # repair parked: /debug/health paged
    "raft_leader_change",       # this master observed a new quorum
                                # leader (election win, or a pulse from
                                # a successor) — wall_ms deltas across
                                # the fleet bound the failover window
    "raft_step_down",           # a LEADER lost its standing (lease
                                # expiry under partition, or a higher
                                # term appeared) and stopped assigning
    "frame_downgrade",          # a peer refused the frame handshake:
                                # its requests ride HTTP until the
                                # jittered re-probe window expires
    "tenant_shed",              # QoS admission throttled (429) or shed
                                # (503) a tenant's request — rate-
                                # bounded per tenant so an abuser can't
                                # flood the ring holding its evidence
    "arbiter_yield",            # the bandwidth arbiter squeezed a
                                # background consumer below its base
                                # rate under foreground pressure
    "shard_split",              # filer shard split phase transition
                                # (flip = routing cut over in one raft
                                # apply; done = tombstone complete)
    "shard_move",               # cross-shard rename phase transition
                                # of the journaled two-phase move
})

_MAX_FIELDS = 16                # per-event field cap (bounded memory)

_lock = threading.Lock()
_ring: deque = deque(maxlen=1024)
_seq = 0
_warned_types: set = set()

# lazily-bound prometheus counter (+ label-children cache), the same
# shape as tracing._observe
_counter: object = None
_counter_children: dict = {}


def init(ring: int = 1024) -> None:
    """Resize the journal ring (tests / future flag)."""
    global _ring
    with _lock:
        if ring != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(16, ring))


def reset() -> None:
    """Drop all recorded events (tests)."""
    global _seq
    with _lock:
        _ring.clear()
        _seq = 0


def record(etype: str, **fields) -> None:
    """Append one state transition to the journal.

    Never raises: the emit sites sit inside breaker transitions, store
    mutations and supervisor loops, where an observability bug must not
    become a data-plane bug."""
    try:
        if etype not in TYPES and etype not in _warned_types:
            _warned_types.add(etype)
            glog.warning("events: unknown event type %r (recording "
                         "anyway; add it to util/events.TYPES)", etype)
        trace = ""
        try:
            from . import tracing
            trace = tracing.current().trace
        except ImportError:  # pragma: no cover - tracing always present
            pass
        if len(fields) > _MAX_FIELDS:
            fields = dict(list(fields.items())[:_MAX_FIELDS])
        global _seq
        with _lock:
            _seq += 1
            _ring.append({
                "seq": _seq,
                "type": etype,
                "wall_ms": round(time.time() * 1000.0, 3),
                "mono": time.perf_counter(),
                "trace": trace,
                **fields,
            })
        _count(etype)
    except Exception as e:  # noqa: BLE001 — see docstring: the journal
        # must never take down the path it observes, but stay visible
        glog.warning("events.record(%s) failed: %s", etype, e)


def _count(etype: str) -> None:
    global _counter
    if _counter is None:
        try:
            from ..stats import metrics
            _counter = (metrics.EVENTS_TOTAL
                        if metrics.HAVE_PROMETHEUS else False)
        except ImportError:
            _counter = False
    if not _counter:
        return
    child = _counter_children.get(etype)
    if child is None:
        if len(_counter_children) > 256:
            _counter_children.clear()   # runaway label cardinality bound
        child = _counter_children[etype] = _counter.labels(etype)
    child.inc()


def events_dict(n: int = 100, types: "set[str] | None" = None,
                since_ms: float = 0.0) -> dict:
    """The /debug/events JSON body for THIS process's ring: newest
    first, optionally filtered by type and a wall-clock floor."""
    n = max(0, min(int(n), 10_000))
    with _lock:
        rows = list(_ring)
    if types:
        rows = [r for r in rows if r["type"] in types]
    if since_ms > 0:
        rows = [r for r in rows if r["wall_ms"] >= since_ms]
    rows = rows[-n:] if n else []
    rows.reverse()
    # copies, not the live ring rows: aggregators stamp worker tags on
    # what we hand out, and a caller's mutation must never rewrite the
    # journal every later surface (worker hops, slo evidence) reads
    return {"events": [dict(r) for r in rows], "recorded": _seq}


def merge_payloads(payloads: "list[dict]", n: int = 100) -> dict:
    """Fold several workers' /debug/events bodies into one whole-host
    view, newest first on the shared wall clock (rows keep whatever
    ``worker`` tag the aggregator stamped)."""
    n = max(0, min(int(n), 10_000))
    rows: list[dict] = []
    recorded = 0
    for p in payloads:
        rows.extend(p.get("events", ()))
        recorded += int(p.get("recorded", 0) or 0)
    rows.sort(key=lambda r: -r.get("wall_ms", 0.0))
    return {"events": rows[:n], "recorded": recorded}


def events_query(query) -> dict:
    """events_dict driven by a ?n=&type=&since_ms= query mapping — the
    one parser shared by every server's /debug/events handler (raises
    ValueError on malformed values)."""
    types = None
    if query.get("type"):
        types = {t for t in str(query["type"]).split(",") if t}
    return events_dict(n=int(query.get("n", 100)), types=types,
                       since_ms=float(query.get("since_ms", 0) or 0))


def window(from_ms: float, to_ms: float,
           types: "set[str] | None" = None) -> "list[dict]":
    """Events whose wall stamp falls in [from_ms, to_ms] — the SLO
    engine's evidence correlator."""
    with _lock:
        rows = list(_ring)
    return [r for r in rows
            if from_ms <= r["wall_ms"] <= to_ms
            and (not types or r["type"] in types)]


def debug_handler():
    """One aiohttp handler over THIS process's ring — registered by
    every non-worker-aggregating server (master, filer, S3, WebDAV) so
    the events contract cannot drift between surfaces."""
    from aiohttp import web

    async def h_events(req):
        try:
            return web.json_response(events_query(req.query))
        except ValueError:
            return web.json_response({"error": "bad n/type/since_ms"},
                                     status=400)

    return h_events
