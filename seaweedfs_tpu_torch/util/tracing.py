"""End-to-end distributed tracing + per-request introspection.

The cluster has a multi-core data plane, fault injection with retries
and breakers, and a tiered read cache — but when a request is slow
there was no way to tell WHICH tier ate the time: gateway, filer chunk
fan-out, client retries, sibling-proxy hop, volume worker, or GF(256)
reconstruction.  This module is the measurement substrate: every hop
opens a Span carrying a shared trace id, finished spans land in a
bounded in-memory ring per process, and the debug surface exposes them
as `/debug/traces` (recent + slowest traces) and `/debug/requests`
(currently in-flight spans, for spotting wedged requests).

Propagation follows the W3C `traceparent` idiom —

    traceparent: 00-<32 hex trace id>-<16 hex parent span id>-<2 hex flags>

— carried on every inter-process hop (client -> master, client ->
volume, worker sibling proxy, replication fan-out, remote EC shard
reads), so one logical request stays ONE trace across the whole fleet.
Within a process, parenthood rides a contextvar: `start()` silently
returns the no-op span when no trace is active, which is what makes
instrumentation free on untraced paths.

Design constraints honored here:

- zero-allocation no-op when disabled: at `-trace.sample 0` header-less
  requests (and child spans with no active parent) get the singleton
  `_NOOP`, whose every method is a pass — hot paths pay one contextvar
  read. An incoming SAMPLED traceparent is still joined (dropping it
  would orphan an upstream trace mid-chain), so silencing tracing
  end-to-end means sample 0 fleet-wide;
- monotonic-clock durations (`perf_counter`), wall-clock start stamps
  so rings from different processes merge on a shared timeline;
- bounded memory: ring (default 2048 spans), per-span event cap, and
  an in-flight table cap — a leak cannot grow past the caps;
- spans record (tier, op, status, bytes) and feed the
  `SeaweedFS_request_duration_seconds{tier,op,status}` histogram, so
  the trace ring and Prometheus agree by construction;
- entry spans slower than `-trace.slowms` emit one glog WARNING line
  carrying the trace id, the grep-able bridge from logs to traces.

A copy of seaweedfs_tpu/util/tracing.py in the PyTorch port.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque

from . import glog

TRACE_HEADER = "traceparent"

_sample = 1.0          # P(root span) for requests without a traceparent
_slow_ms = 0.0         # entry spans slower than this glog WARNING; 0 = off
_MAX_EVENTS = 64       # per-span event cap
_MAX_INFLIGHT = 4096   # in-flight table cap (leaked spans cannot grow it)

_lock = threading.Lock()
_ring: deque = deque(maxlen=2048)
_inflight: dict[int, "Span"] = {}

# worst (slowest) finished entry per (tier, op) since the last drain —
# the timeline exemplar feed: each histogram window links its worst
# trace id so /debug/timeline rows jump straight into
# /debug/cluster/trace/<id> (bounded like _hist_children)
_exemplars: dict[tuple[str, str], tuple[float, str]] = {}
_MAX_EXEMPLARS = 512

# per-thread tier stack for the sampling profiler (stats/profiler.py):
# a sampler thread cannot read another thread's contextvar, so span
# enter/exit maintains this map — only while tracking is on (the
# profiler armed), so unprofiled processes pay a single bool check
_track_tiers = False
_thread_tiers: dict[int, list[str]] = {}

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "swtpu_trace_span", default=None)

# lazily-bound prometheus histogram (+ label-children cache: .labels()
# is a lock + dict lookup in prometheus_client; spans are hot)
_hist: object = None
_hist_children: dict = {}


def init(sample: float = 1.0, slow_ms: float = 0.0,
         ring: int = 2048) -> None:
    """Wire from CLI flags: -trace.sample, -trace.slowms."""
    global _sample, _slow_ms, _ring
    _sample = sample
    _slow_ms = slow_ms
    with _lock:
        if ring != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(16, ring))


def reset() -> None:
    """Drop all recorded + in-flight spans (tests)."""
    with _lock:
        _ring.clear()
        _inflight.clear()
        _exemplars.clear()


def track_thread_tiers(on: bool) -> None:
    """Arm/disarm the per-thread tier map (profiler only)."""
    global _track_tiers
    _track_tiers = on
    if not on:
        _thread_tiers.clear()


def thread_tier(tid: int) -> str:
    """The tier of the span most recently entered on thread `tid`
    (empty when the thread is not inside a traced request)."""
    st = _thread_tiers.get(tid)
    return st[-1] if st else ""


def drain_exemplars() -> "dict[str, dict]":
    """Worst finished trace per ``tier.op`` since the last drain —
    consumed by timeline.snap() so each window carries its own
    exemplars ({\"tier.op\": {\"trace\": id, \"dur_ms\": ms}})."""
    with _lock:
        if not _exemplars:
            return {}
        out = {f"{tier}.{op}": {"trace": trace,
                                "dur_ms": round(dur, 3)}
               for (tier, op), (dur, trace) in _exemplars.items()}
        _exemplars.clear()
    return out


def enabled() -> bool:
    return _sample > 0


def parse_traceparent(value: str) -> "tuple[str, str, int] | None":
    """(trace_id, parent_span_id, flags) or None when malformed."""
    parts = value.strip().split("-")
    if len(parts) < 4 or parts[0] == "ff" or len(parts[0]) != 2 \
            or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16)
        int(parts[2], 16)
        flags = int(parts[3][:2], 16)
    except ValueError:
        return None
    return parts[1], parts[2], flags


class _NoopSpan:
    """Falsy do-nothing span: the disabled/untraced fast path."""

    __slots__ = ("status", "nbytes")
    trace = ""
    span_id = ""
    parent = ""

    def __init__(self):
        self.status = None
        self.nbytes = 0

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key, value) -> None:
        pass

    def event(self, name, **fields) -> None:
        pass

    def finish(self, status=None, nbytes=None) -> None:
        pass

    def cancel(self) -> None:
        pass

    def traceparent(self) -> str:
        return ""


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("trace", "span_id", "parent", "tier", "op", "status",
                 "nbytes", "attrs", "events", "t0", "wall0", "dur",
                 "entry", "_token", "_done", "_discard")

    def __init__(self, trace: str, parent: str, tier: str, op: str,
                 entry: bool, attrs: dict | None):
        self.trace = trace
        self.span_id = "%016x" % random.getrandbits(64)
        self.parent = parent
        self.tier = tier
        self.op = op
        self.status: str | None = None
        self.nbytes = 0
        self.attrs = attrs
        self.events: list | None = None
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.dur = 0.0
        self.entry = entry
        self._token = None
        self._done = False
        self._discard = False
        with _lock:
            if len(_inflight) < _MAX_INFLIGHT:
                _inflight[id(self)] = self

    # -- annotation --

    def set(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def event(self, name: str, **fields) -> None:
        """Point-in-time annotation (retry attempt, replica rotation,
        Range resume, breaker rejection, ...) with a span-relative
        millisecond timestamp."""
        evs = self.events
        if evs is None:
            evs = self.events = []
        if len(evs) < _MAX_EVENTS:
            evs.append((name, (time.perf_counter() - self.t0) * 1000.0,
                        fields or None))

    def traceparent(self) -> str:
        return f"00-{self.trace}-{self.span_id}-01"

    # -- lifecycle --

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        if _track_tiers:
            _thread_tiers.setdefault(
                threading.get_ident(), []).append(self.tier)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if _track_tiers:
            st = _thread_tiers.get(threading.get_ident())
            if st:
                st.pop()
        tok, self._token = self._token, None
        if tok is not None:
            try:
                _current.reset(tok)
            except ValueError:
                # token minted in another context (generator teardown
                # from a different task): the var is per-context anyway
                pass
        if et is not None and self.status is None:
            # an explicitly-set status (e.g. "404") survives the raise
            self.status = "error"
        self.finish()
        return False

    def cancel(self) -> None:
        """Discard without recording (e.g. a fast-path request replayed
        into the full handler, which records its own span)."""
        self._discard = True
        self._done = True
        with _lock:
            _inflight.pop(id(self), None)

    def finish(self, status: str | None = None,
               nbytes: int | None = None) -> None:
        if self._done:
            return
        self._done = True
        self.dur = (time.perf_counter() - self.t0) * 1000.0
        if status is not None:
            self.status = status
        elif self.status is None:
            self.status = "ok"
        if nbytes is not None:
            self.nbytes = nbytes
        with _lock:
            _inflight.pop(id(self), None)
            if not self._discard:
                _ring.append(self)
                # exemplar feed: every (tier, op) in the histogram
                # gets a worst-trace pointer, inner hops included
                key = (self.tier, self.op)
                ex = _exemplars.get(key)
                if ex is None or self.dur > ex[0]:
                    if len(_exemplars) > _MAX_EXEMPLARS:
                        _exemplars.clear()   # cardinality bound
                    _exemplars[key] = (self.dur, self.trace)
        if self._discard:
            return
        _observe(self.tier, self.op, self.status, self.dur / 1000.0)
        if self.entry and 0 < _slow_ms <= self.dur:
            glog.warning(
                "slow request: tier=%s op=%s status=%s %.1fms bytes=%d "
                "trace=%s", self.tier, self.op, self.status, self.dur,
                self.nbytes, self.trace)


def current():
    """The active span (never None: the no-op span when untraced)."""
    sp = _current.get()
    return sp if sp is not None else _NOOP


def start(tier: str, op: str, **attrs):
    """Child span of the context's active span; no-op when untraced."""
    parent = _current.get()
    if not parent:
        return _NOOP
    return Span(parent.trace, parent.span_id, tier, op, False,
                attrs or None)


def start_root(tier: str, op: str, headers=None,
               traceparent: str | None = None, **attrs):
    """Entry span for a request arriving at a server. An incoming
    sampled `traceparent` is ALWAYS joined (the trace was started
    upstream and losing this hop would orphan the tree); requests
    without one roll the local sample rate."""
    tp = traceparent
    if tp is None and headers is not None:
        tp = headers.get(TRACE_HEADER)
    if tp:
        parsed = parse_traceparent(tp)
        if parsed is not None:
            trace, parent, flags = parsed
            if not flags & 1:
                return _NOOP
            return Span(trace, parent, tier, op, True, attrs or None)
    if _sample <= 0.0 or (_sample < 1.0 and random.random() >= _sample):
        return _NOOP
    return Span("%032x" % random.getrandbits(128), "", tier, op, True,
                attrs or None)


def inject(headers: dict, span=None) -> None:
    """Stamp the traceparent header for an outgoing hop."""
    sp = span if span is not None else _current.get()
    if sp:
        headers[TRACE_HEADER] = sp.traceparent()


# ---------------------------------------------------------------------------
# prometheus bridge


def _observe(tier: str, op: str, status: str, dur_s: float) -> None:
    global _hist
    if _hist is None:
        try:
            from ..stats import metrics
            _hist = (metrics.REQUEST_DURATION
                     if metrics.HAVE_PROMETHEUS else False)
        except ImportError:
            _hist = False
    if not _hist:
        return
    key = (tier, op, status)
    child = _hist_children.get(key)
    if child is None:
        if len(_hist_children) > 512:
            _hist_children.clear()   # runaway label cardinality bound
        child = _hist_children[key] = _hist.labels(tier, op, status)
    child.observe(dur_s)


# ---------------------------------------------------------------------------
# debug surface (/debug/traces, /debug/requests)


def _span_dict(s: Span) -> dict:
    d = {"trace": s.trace, "span": s.span_id, "parent": s.parent,
         "tier": s.tier, "op": s.op, "status": s.status,
         "start_ms": round(s.wall0 * 1000.0, 3),
         "dur_ms": round(s.dur, 3), "bytes": s.nbytes}
    if s.attrs:
        d["attrs"] = dict(s.attrs)
    if s.events:
        d["events"] = [
            {"name": name, "t_ms": round(t, 3), **(fields or {})}
            for name, t, fields in s.events]
    return d


def _trace_groups(span_dicts: list) -> list[dict]:
    """Group span dicts by trace id (deduping repeated span ids from a
    cross-worker merge), compute per-span self-time and the per-tier
    self-time rollup — the 'which tier ate the time' attribution, which
    is non-overlapping and sums to ~the wall time of the trace."""
    groups: dict[str, dict] = {}
    for d in span_dicts:
        groups.setdefault(d["trace"], {}).setdefault(d["span"], d)
    out = []
    for tid, by_id in groups.items():
        spans = sorted(by_id.values(), key=lambda d: d["start_ms"])
        child_ms: dict[str, float] = {}
        for d in spans:
            p = d.get("parent", "")
            if p in by_id:
                child_ms[p] = child_ms.get(p, 0.0) + d["dur_ms"]
        tiers: dict[str, float] = {}
        for d in spans:
            d["self_ms"] = round(
                max(0.0, d["dur_ms"] - child_ms.get(d["span"], 0.0)), 3)
            tiers[d["tier"]] = round(
                tiers.get(d["tier"], 0.0) + d["self_ms"], 3)
        out.append({
            "trace_id": tid,
            "start_ms": min(d["start_ms"] for d in spans),
            "dur_ms": max(d["dur_ms"] for d in spans),
            "tiers": tiers,
            "spans": spans,
        })
    return out


def _payload(groups: list[dict], recent: int, slowest: int) -> dict:
    # clamp: groups[-0:] would be the WHOLE list, so ?n=0 must be an
    # explicit empty slice, and negative counts must not slice oddly
    recent = max(0, recent)
    slowest = max(0, slowest)
    groups.sort(key=lambda g: g["start_ms"])
    return {
        "spans": sum(len(g["spans"]) for g in groups),
        "traces": groups[-recent:][::-1] if recent else [],
        "slowest": sorted(groups, key=lambda g: -g["dur_ms"])[:slowest],
    }


def traces_dict(recent: int = 20, slowest: int = 10) -> dict:
    """The /debug/traces JSON body for THIS process's ring."""
    with _lock:
        spans = [_span_dict(s) for s in _ring]
    return _payload(_trace_groups(spans), recent, slowest)


def merge_payloads(payloads: list[dict], recent: int = 20,
                   slowest: int = 10) -> dict:
    """Fold several workers' /debug/traces bodies into one whole-host
    view (span ids dedupe, traces regroup across process rings)."""
    spans: list[dict] = []
    for p in payloads:
        for g in list(p.get("traces", ())) + list(p.get("slowest", ())):
            spans.extend(g.get("spans", ()))
    return _payload(_trace_groups(spans), recent, slowest)


def trace_spans_dict(trace_id: str) -> dict:
    """Every span of ONE trace known to THIS process: finished spans
    from the ring plus currently in-flight sightings (marked
    ``inflight`` with their age as dur_ms) — the per-node pull the
    cluster assembler (stats/introspect.py) fans out for."""
    now = time.perf_counter()
    with _lock:
        done = [_span_dict(s) for s in _ring if s.trace == trace_id]
        live = [s for s in _inflight.values() if s.trace == trace_id]
    for s in live:
        row = {"trace": s.trace, "span": s.span_id, "parent": s.parent,
               "tier": s.tier, "op": s.op, "status": "inflight",
               "start_ms": round(s.wall0 * 1000.0, 3),
               "dur_ms": round((now - s.t0) * 1000.0, 3),
               "bytes": s.nbytes, "inflight": True}
        attrs = s.attrs
        if attrs:
            try:
                row["attrs"] = dict(attrs)
            except RuntimeError:
                # live span: its owner may insert attrs mid-copy
                pass
        done.append(row)
    done.sort(key=lambda d: (d["start_ms"], d["span"]))
    return {"trace": trace_id, "spans": done}


def merge_trace_payloads(payloads: "list[dict]") -> dict:
    """Fold several processes' ``?trace=`` pull bodies into one: span
    ids dedupe (a finished record beats an in-flight sighting of the
    same span), ordering stays deterministic for byte-identical
    re-assembly."""
    by_id: dict[str, dict] = {}
    tid = ""
    for p in payloads:
        tid = tid or p.get("trace", "")
        for d in p.get("spans", ()):
            sid = d.get("span", "")
            cur = by_id.get(sid)
            if cur is None or (cur.get("inflight")
                               and not d.get("inflight")):
                by_id[sid] = d
    spans = sorted(by_id.values(),
                   key=lambda d: (d.get("start_ms", 0), d.get("span", "")))
    return {"trace": tid, "spans": spans}


def requests_dict() -> dict:
    """The /debug/requests JSON body: currently in-flight spans with
    their age — the wedged-request detector."""
    now = time.perf_counter()
    with _lock:
        live = list(_inflight.values())
    rows = []
    for s in live:
        row = {"trace": s.trace, "span": s.span_id, "parent": s.parent,
               "tier": s.tier, "op": s.op,
               "age_ms": round((now - s.t0) * 1000.0, 3),
               "start_ms": round(s.wall0 * 1000.0, 3)}
        attrs = s.attrs
        if attrs:
            try:
                row["attrs"] = dict(attrs)
            except RuntimeError:
                # the span is LIVE: its owner (possibly an executor
                # thread) may insert attrs mid-copy — skip them rather
                # than 500 the debug endpoint under load
                pass
        rows.append(row)
    rows.sort(key=lambda r: -r["age_ms"])
    return {"inflight": len(rows), "requests": rows}


MAX_QUERY_COUNT = 1000   # ?n=/?slowest= ceiling: the ring itself is
#                          bounded, but a huge count would still be
#                          interpolated into sibling fan-out URLs and
#                          serialized into one giant JSON body


def clamp_count(n: int, cap: int = MAX_QUERY_COUNT) -> int:
    """Clamp a user-supplied result count into [0, cap]: ?n=-5 must be
    an explicit empty slice (never a from-the-end slice) and ?n=10**9
    must not balloon the payload."""
    return max(0, min(int(n), cap))


def traces_query(query) -> dict:
    """traces_dict driven by a ?n=&slowest= query mapping — the one
    parser shared by every server's /debug/traces handler (raises
    ValueError on malformed counts; negative/huge counts clamped).
    ``?trace=<id>`` switches to the single-trace span pull instead —
    the hook cluster assembly fans out over."""
    tid = str(query.get("trace", "") or "").strip()
    if tid:
        return trace_spans_dict(tid[:64])
    return traces_dict(recent=clamp_count(query.get("n", 20)),
                       slowest=clamp_count(query.get("slowest", 10)))


def debug_handlers():
    """(h_traces, h_requests) aiohttp handlers over THIS process's
    ring — the one implementation every non-worker-aggregating server
    (filer, S3, WebDAV) registers, so the debug contract cannot drift
    between surfaces."""
    from aiohttp import web

    async def h_traces(req):
        try:
            return web.json_response(traces_query(req.query))
        except ValueError:
            return web.json_response({"error": "bad n/slowest"},
                                     status=400)

    async def h_requests(req):
        return web.json_response(requests_dict())

    return h_traces, h_requests


async def run_in_executor(fn, *args):
    """run_in_executor that carries the tracing context into the
    worker thread (asyncio does NOT propagate contextvars there), so
    store/EC spans parent under the request span; pays the context
    copy only while a trace is active."""
    import asyncio
    loop = asyncio.get_running_loop()
    if _current.get():
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(None,
                                          lambda: ctx.run(fn, *args))
    return await loop.run_in_executor(None, lambda: fn(*args))
