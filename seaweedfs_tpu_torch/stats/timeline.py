"""Metrics timelines: a bounded in-process time-series ring.

``/metrics`` is a point-in-time scrape — by the time someone looks, the
bad minute is gone.  This module snapshots every counter, gauge and
histogram registered in the process's Prometheus registry on a fixed
cadence (``-timeline.interval``, default 10s) and keeps the last
``-timeline.ring`` WINDOWS, where a window is the delta between two
consecutive snapshots:

- **counters** become per-second rates over the window;
- **gauges** keep their value at the window's end;
- **histograms** keep their raw per-window BUCKET DELTAS (plus sum and
  count deltas) — quantiles are derived at render time by walking the
  cumulative deltas with linear interpolation, and because the raw
  buckets ride in the payload, a whole-host merge under ``-workers``
  can sum siblings' buckets and recompute honest host-level quantiles
  (the same discipline as ``merge_metrics_texts``: sum per key, never
  average derived values).

Saturation probes (stats/saturation.py) run right before each
snapshot, so event-loop lag, executor queue wait, open fds, disk usage
and cache occupancy land in the SAME windows as the request-rate and
latency series — "slow at 14:02:10" becomes attributable to the
resource that saturated at 14:02:10.

Exposed at ``/debug/timeline`` (``/__debug__/timeline`` on the
path-shadowing gateways).  ``POST /debug/timeline?snap=1`` forces a
snapshot NOW — how tests and the CI smoke get deterministic windows.
The SLO engine (stats/slo.py) evaluates its burn rates over these
windows after every snapshot.

A copy of seaweedfs_tpu/stats/timeline.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque

from ..util import glog

# default cadence/ring (wired from -timeline.interval / -timeline.ring)
DEFAULT_INTERVAL_S = 10.0
DEFAULT_RING = 360              # 1h of 10s windows

_QUANTILES = (0.5, 0.95, 0.99)

_lock = threading.Lock()
_interval_s = DEFAULT_INTERVAL_S
_ring: deque = deque(maxlen=DEFAULT_RING)
_last_snap: "dict | None" = None        # (wall, mono, flat samples)
_probes: list = []                      # sync callables run pre-snapshot
_task: "asyncio.Task | None" = None
_lag_task: "asyncio.Task | None" = None


def init(interval_s: float = DEFAULT_INTERVAL_S,
         ring: int = DEFAULT_RING) -> None:
    """Wire from CLI flags: -timeline.interval, -timeline.ring."""
    global _interval_s, _ring
    _interval_s = interval_s
    with _lock:
        if ring != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(4, ring))


def reset() -> None:
    """Drop all windows and the snapshot baseline (tests)."""
    global _last_snap
    with _lock:
        _ring.clear()
        _last_snap = None


def enabled() -> bool:
    return _interval_s > 0


def interval_s() -> float:
    """The wired snapshot cadence (slo.windows_needed sizes its window
    fetch from this)."""
    return _interval_s


def register_probe(fn) -> None:
    """Register a synchronous saturation probe run before every
    snapshot (sets gauges; must be cheap and never raise)."""
    if fn not in _probes:
        _probes.append(fn)


# ---------------------------------------------------------------------------
# snapshotting


def _collect_flat() -> "tuple[dict, dict]":
    """(samples, kinds): samples maps ``name{label="v",...}`` -> value
    for every non-_created sample in the registry; kinds maps the same
    keys to "counter" | "gauge" | "hist_bucket" | "hist_sum" |
    "hist_count"."""
    from . import metrics
    samples: dict[str, float] = {}
    kinds: dict[str, str] = {}
    if not metrics.HAVE_PROMETHEUS:
        return samples, kinds
    for fam in metrics.REGISTRY.collect():
        ftype = fam.type
        for s in fam.samples:
            name = s.name
            if name.endswith("_created"):
                continue
            if ftype == "histogram":
                if name.endswith("_bucket"):
                    kind = "hist_bucket"
                elif name.endswith("_sum"):
                    kind = "hist_sum"
                elif name.endswith("_count"):
                    kind = "hist_count"
                else:
                    kind = "gauge"
            elif ftype == "counter":
                kind = "counter"
            else:
                kind = "gauge"
            if s.labels:
                lbl = ",".join(f'{k}="{v}"'
                               for k, v in sorted(s.labels.items()))
                key = f"{name}{{{lbl}}}"
            else:
                key = name
            samples[key] = float(s.value)
            kinds[key] = kind
    return samples, kinds


def split_key(key: str) -> "tuple[str, dict]":
    """``name{a="x",b="y"}`` -> ("name", {"a": "x", "b": "y"})."""
    name, brace, rest = key.partition("{")
    labels: dict[str, str] = {}
    if brace:
        for part in rest.rstrip("}").split('",'):
            if not part:
                continue
            k, _, v = part.partition('="')
            labels[k] = v.rstrip('"')
    return name, labels


def _hist_base(key: str) -> "tuple[str, str]":
    """bucket-sample key -> (base key without the le label, le value)."""
    name, labels = split_key(key)
    le = labels.pop("le", "+Inf")
    base = name[:-len("_bucket")]
    if labels:
        lbl = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return f"{base}{{{lbl}}}", le
    return base, le


def snap() -> "dict | None":
    """Take one snapshot NOW and, when a baseline exists, append the
    delta window to the ring. Returns the new window (or None for the
    very first snapshot, which only establishes the baseline)."""
    global _last_snap
    for probe in list(_probes):
        try:
            probe()
        except Exception as e:  # noqa: BLE001 — a broken probe must not
            # stop the recorder; it stays visible in the log
            glog.warning("timeline probe %s failed: %s",
                         getattr(probe, "__name__", probe), e)
    wall = time.time()
    mono = time.perf_counter()
    samples, kinds = _collect_flat()
    from ..util import tracing
    exemplars = tracing.drain_exemplars()
    with _lock:
        prev, _last_snap = _last_snap, (wall, mono, samples, kinds)
        if prev is None:
            return None
        pwall, pmono, psamples, _ = prev
        dt = max(1e-9, mono - pmono)
        win = _window(wall, dt, samples, psamples, kinds)
        if exemplars:
            # worst trace per (tier, op) observed during this window —
            # the link from a timeline row into /debug/cluster/trace/<id>
            win["exemplars"] = exemplars
        _ring.append(win)
        return win


def _window(wall: float, dt: float, cur: dict, prev: dict,
            kinds: dict) -> dict:
    rates: dict[str, float] = {}
    gauges: dict[str, float] = {}
    hist: dict[str, dict] = {}
    for key, val in cur.items():
        kind = kinds[key]
        if kind == "gauge":
            gauges[key] = val
            continue
        delta = val - prev.get(key, 0.0)
        if delta < 0:
            # counter reset (process restart mid-merge): start over
            delta = val
        if kind == "counter":
            rates[key] = round(delta / dt, 6)
        elif kind == "hist_bucket":
            base, le = _hist_base(key)
            hist.setdefault(base, {"buckets": {}, "sum": 0.0,
                                   "count": 0.0})["buckets"][le] = delta
        elif kind == "hist_sum":
            base = key[:-len("_sum")] if "{" not in key else \
                _strip_suffix(key, "_sum")
            hist.setdefault(base, {"buckets": {}, "sum": 0.0,
                                   "count": 0.0})["sum"] = round(delta, 9)
        elif kind == "hist_count":
            base = key[:-len("_count")] if "{" not in key else \
                _strip_suffix(key, "_count")
            hist.setdefault(base, {"buckets": {}, "sum": 0.0,
                                   "count": 0.0})["count"] = delta
    # drop all-zero histogram windows: they carry no information and
    # dominate payload size on an idle daemon
    hist = {k: v for k, v in hist.items() if v["count"]}
    return {"wall_ms": round(wall * 1000.0, 3), "dt_s": round(dt, 3),
            "rates": {k: v for k, v in rates.items() if v},
            "gauges": gauges, "hist": hist}


def _strip_suffix(key: str, suffix: str) -> str:
    name, brace, rest = key.partition("{")
    return name[:-len(suffix)] + (brace + rest if brace else "")


# ---------------------------------------------------------------------------
# quantiles from bucket deltas


def quantiles_from_buckets(buckets: "dict[str, float]",
                           qs=_QUANTILES) -> "dict[str, float]":
    """{le: delta-count} -> {"p50": s, ...} seconds, by walking the
    cumulative distribution with linear interpolation inside the
    containing bucket. The +Inf bucket has no finite upper edge, so a
    quantile landing there reports the largest finite bound (a FLOOR —
    honest "at least this slow")."""
    try:
        edges = sorted(((float("inf") if le in ("+Inf", "inf") else
                         float(le)), c) for le, c in buckets.items())
    except ValueError:
        return {}
    total = edges[-1][1] if edges else 0.0
    if total <= 0:
        return {}
    out: dict[str, float] = {}
    finite = [e for e, _ in edges if e != float("inf")]
    top = finite[-1] if finite else 0.0
    for q in qs:
        target = q * total
        lo_edge, lo_cum = 0.0, 0.0
        val = top
        for edge, cum in edges:
            if cum >= target:
                if edge == float("inf"):
                    val = top
                elif cum == lo_cum:
                    val = edge
                else:
                    val = lo_edge + (edge - lo_edge) * \
                        (target - lo_cum) / (cum - lo_cum)
                break
            lo_edge, lo_cum = edge, cum
        out[f"p{int(q * 100)}"] = round(val, 6)
    return out


def _render(win: dict) -> dict:
    """A ring window + derived per-histogram quantiles/rate/avg."""
    out = dict(win)
    q: dict[str, dict] = {}
    for base, h in win.get("hist", {}).items():
        count = h.get("count", 0.0)
        if not count:
            continue
        row = quantiles_from_buckets(h.get("buckets", {}))
        row["count"] = count
        row["rate"] = round(count / max(1e-9, win["dt_s"]), 3)
        if h.get("sum"):
            row["avg"] = round(h["sum"] / count, 6)
        q[base] = row
    out["quantiles"] = q
    return out


# ---------------------------------------------------------------------------
# debug surface (/debug/timeline)


def timeline_dict(n: int = 60, render: bool = True) -> dict:
    """The /debug/timeline JSON body for THIS process's ring: the last
    `n` windows, oldest first, each with derived quantiles.

    ``render=False`` skips the per-histogram quantile interpolation
    and hands out the raw ring windows — the SLO tick only reads the
    raw ``hist`` deltas, and rendering 200 windows' quantiles per
    snapshot just to discard them is measurable at
    ``-timeline.interval 1``. Raw windows are the live ring dicts:
    callers must not mutate them."""
    n = max(0, min(int(n), 10_000))
    with _lock:
        wins = list(_ring)[-n:] if n else []
    return {"interval_s": _interval_s, "ring": _ring.maxlen,
            "windows": [_render(w) for w in wins] if render
            else wins}


def _merge_gauge(key: str, old: float, new: float) -> float:
    # one non-additive policy for both whole-host merges: see
    # metrics.NON_ADDITIVE_GAUGE_PREFIXES for which gauges take max
    # (same-filesystem disk usage, per-loop latencies, build identity,
    # process start time) and why summing them fabricates a value
    from . import metrics
    if key.startswith(metrics.NON_ADDITIVE_GAUGE_PREFIXES):
        return max(old, new)
    return old + new


def _merge_exemplars(dst: dict, src: "dict | None") -> None:
    """Fold exemplar maps ({"tier.op": {"trace", "dur_ms"}}) across
    windows: the WORST (max dur_ms) trace per key wins — exemplars are
    pointers, not statistics, so there is nothing to sum."""
    for k, ex in (src or {}).items():
        cur = dst.get(k)
        if cur is None or float(ex.get("dur_ms", 0.0)) > \
                float(cur.get("dur_ms", 0.0)):
            dst[k] = ex


def _fold_same_process(windows, interval: float) -> "list[dict]":
    """Combine ONE payload's windows that land in the same wall bucket
    (a forced ``?snap=1`` a few hundred ms after the periodic snap):
    their dt_s are disjoint sub-intervals of the bucket, so summing
    their per-second rates would double-count — rates recombine as
    (count1+count2)/(dt1+dt2), gauges keep the newest sample (the SAME
    process observed both; adding them fabricates double the fds), and
    histogram deltas sum like any disjoint spans."""
    out: dict[int, dict] = {}
    for w in windows:
        bucket = int(w["wall_ms"] / 1000.0 / interval)
        m = out.get(bucket)
        if m is None:
            out[bucket] = {"wall_ms": w["wall_ms"], "dt_s": w["dt_s"],
                           "rates": dict(w.get("rates", {})),
                           "gauges": dict(w.get("gauges", {})),
                           "hist": {b: {"buckets": dict(h.get("buckets", {})),
                                        "sum": h.get("sum", 0.0),
                                        "count": h.get("count", 0.0)}
                                    for b, h in w.get("hist", {}).items()}}
            if w.get("exemplars"):
                out[bucket]["exemplars"] = dict(w["exemplars"])
            continue
        dt0, dt1 = m["dt_s"], w["dt_s"]
        span = max(1e-9, dt0 + dt1)
        for k in set(m["rates"]) | set(w.get("rates", {})):
            cnt = (m["rates"].get(k, 0.0) * dt0
                   + w.get("rates", {}).get(k, 0.0) * dt1)
            m["rates"][k] = round(cnt / span, 6)
        if w["wall_ms"] >= m["wall_ms"]:
            m["gauges"].update(w.get("gauges", {}))
        else:
            m["gauges"] = {**w.get("gauges", {}), **m["gauges"]}
        for base, h in w.get("hist", {}).items():
            mh = m["hist"].setdefault(
                base, {"buckets": {}, "sum": 0.0, "count": 0.0})
            for le, c in h.get("buckets", {}).items():
                mh["buckets"][le] = mh["buckets"].get(le, 0.0) + c
            mh["sum"] = round(mh["sum"] + h.get("sum", 0.0), 9)
            mh["count"] += h.get("count", 0.0)
        if w.get("exemplars"):
            _merge_exemplars(m.setdefault("exemplars", {}),
                             w["exemplars"])
        m["wall_ms"] = max(m["wall_ms"], w["wall_ms"])
        m["dt_s"] = round(span, 3)
    return [out[b] for b in sorted(out)]


def merge_payloads(payloads: "list[dict]", n: int = 60,
                   render: bool = True) -> dict:
    """Fold several workers' /debug/timeline bodies into one whole-host
    view: each payload's windows are first folded per wall bucket
    (_fold_same_process — a forced snap must not double-count its own
    process), then windows align on wall-clock buckets of the sampling
    interval and within a bucket rates/gauges/histogram buckets are
    SUMMED per key across processes (the /metrics merge discipline —
    except the non-additive gauges in
    metrics.NON_ADDITIVE_GAUGE_PREFIXES, which take the max), then
    quantiles recomputed from the summed buckets — the host p99 is
    derived from host-wide buckets, never averaged from per-worker
    quantiles."""
    n = max(0, min(int(n), 10_000))
    interval = max((float(p.get("interval_s") or 0) for p in payloads),
                   default=_interval_s) or DEFAULT_INTERVAL_S
    ring = max((int(p.get("ring") or 0) for p in payloads),
               default=_ring.maxlen)
    merged: dict[int, dict] = {}
    for p in payloads:
        for w in _fold_same_process(p.get("windows", ()), interval):
            bucket = int(w["wall_ms"] / 1000.0 / interval)
            m = merged.get(bucket)
            if m is None:
                m = merged[bucket] = {
                    "wall_ms": w["wall_ms"], "dt_s": w["dt_s"],
                    "rates": {}, "gauges": {}, "hist": {}}
            m["wall_ms"] = max(m["wall_ms"], w["wall_ms"])
            m["dt_s"] = max(m["dt_s"], w["dt_s"])
            for k, v in w.get("rates", {}).items():
                m["rates"][k] = round(m["rates"].get(k, 0.0) + v, 6)
            for k, v in w.get("gauges", {}).items():
                if k in m["gauges"]:
                    m["gauges"][k] = _merge_gauge(k, m["gauges"][k], v)
                else:
                    m["gauges"][k] = v
            for base, h in w.get("hist", {}).items():
                mh = m["hist"].setdefault(
                    base, {"buckets": {}, "sum": 0.0, "count": 0.0})
                for le, c in h.get("buckets", {}).items():
                    mh["buckets"][le] = mh["buckets"].get(le, 0.0) + c
                mh["sum"] = round(mh["sum"] + h.get("sum", 0.0), 9)
                mh["count"] += h.get("count", 0.0)
            if w.get("exemplars"):
                _merge_exemplars(m.setdefault("exemplars", {}),
                                 w["exemplars"])
    wins = [merged[b] for b in sorted(merged)][-n:]
    return {"interval_s": interval, "ring": ring,
            "windows": [_render(w) for w in wins] if render else wins}


def timeline_query(query) -> dict:
    """timeline_dict driven by a ?n= query mapping (raises ValueError
    on malformed counts) — shared by every server handler."""
    return timeline_dict(n=int(query.get("n", 60)))


# ---------------------------------------------------------------------------
# the recorder task


async def _run() -> None:
    while True:
        await asyncio.sleep(_interval_s)
        try:
            snap()
        except Exception as e:  # noqa: BLE001 — a collector raising
            # during the sweep must not silently kill the recorder for
            # the rest of the process lifetime (health would keep
            # serving a stale verdict off a frozen ring)
            glog.warning("timeline snapshot failed: %s", e)
        try:
            from . import slo
            slo.tick()
        except Exception as e:  # noqa: BLE001 — SLO evaluation must not
            # kill the recorder; the engine logs its own transitions
            glog.warning("slo tick failed: %s", e)


async def _lag_probe(period_s: float = 0.25) -> None:
    """Continuously measure event-loop scheduling delay; the max since
    the last snapshot is flushed to the gauge by sample_loop_lag()."""
    from . import saturation
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(period_s)
        saturation.note_loop_lag(max(0.0, loop.time() - t0 - period_s))


def start_recorder(disk_paths: "list[str] | None" = None):
    """Start the sampling loop (+ the loop-lag probe task) on the
    running event loop; idempotent per process. Returns a handle with
    ``cancel()`` for the daemon's shutdown path, or None when disabled
    (-timeline.interval 0)."""
    global _task, _lag_task
    if _interval_s <= 0:
        return None
    from . import saturation
    register_probe(saturation.sample_process)
    if disk_paths:
        register_probe(saturation.disk_probe(disk_paths))
    loop = asyncio.get_running_loop()
    if _task is None or _task.done():
        _task = loop.create_task(_run())
        snap()                       # establish the baseline NOW
    if _lag_task is None or _lag_task.done():
        _lag_task = loop.create_task(_lag_probe())
    register_probe(saturation.sample_loop_lag)
    saturation.start_executor_probe(loop)

    class _Handle:
        def cancel(self) -> None:
            global _task, _lag_task
            for t in (_task, _lag_task):
                if t is not None and not t.done():
                    t.cancel()
            _task = _lag_task = None
            saturation.stop_executor_probe()

    return _Handle()


def debug_handler():
    """One aiohttp /debug/timeline handler over THIS process's ring
    (GET ?n=; POST ?snap=1 forces a snapshot) — registered by every
    non-worker-aggregating server so the contract cannot drift."""
    from aiohttp import web

    async def h_timeline(req):
        if req.method == "POST":
            if req.query.get("snap", "") not in ("1", "true"):
                return web.json_response({"error": "POST wants ?snap=1"},
                                         status=400)
            snap()
        try:
            return web.json_response(timeline_query(req.query))
        except ValueError:
            return web.json_response({"error": "bad n"}, status=400)

    return h_timeline


def recorder_handlers():
    """(h_timeline, h_events, h_health): the flight-recorder trio over
    THIS process's rings — the one factory every non-worker-aggregating
    server (master, filer, S3, WebDAV) registers, so the recorder
    contract cannot drift between surfaces. (The volume server has its
    own -workers-merging twins.)"""
    from ..util import events
    from . import slo
    return debug_handler(), events.debug_handler(), slo.debug_handler()
