"""SLO burn-rate engine: a machine-readable health verdict.

Declarative objectives (``-slo "volume.read:p99<50ms@99.9"``) are
evaluated over the metrics timelines (stats/timeline.py) with the
standard multi-window burn-rate method (the SRE-workbook shape):

- an objective ``tier.op:pQQ<THRESHms@OBJ`` says "the QQth percentile
  of ``tier.op`` latency must stay under THRESH ms, met OBJ percent of
  the time": ``p99<50ms`` by itself already PERMITS 1% of requests
  over 50ms, so only the fraction BEYOND that allowance spends budget
  — ``p50<10ms`` is meaningfully laxer than ``p99<10ms``;
- each timeline window carries the raw bucket deltas of
  ``SeaweedFS_request_duration_seconds{tier,op,status}``, so the
  fraction of requests over the threshold is computed EXACTLY from the
  histogram (linear interpolation inside the containing bucket, summed
  across status labels — an injected 500 that returned fast still
  counts against latency only if it WAS slow; error-rate objectives
  would be a second spec kind);
- burn rate = excess violating fraction / error budget:
  ``max(0, frac_over - (1 - QQ/100)) / (1 - OBJ/100)``.  A burn of
  1.0 spends exactly the budget; 14.4 pages because it would exhaust a
  30-day budget in 2 days;
- two windows guard against both blips and slow bleeds: PAGE when the
  fast (default 60s) AND slow (default 600s) windows both burn ≥ 14.4,
  WARN when both burn ≥ 6.0. Fewer than ``MIN_COUNT`` requests in the
  fast window never pages (one slow request on an idle daemon is not
  an incident).

The verdict is served at ``/debug/health`` with EVIDENCE: the
violating timeline slice (per-window violating fractions), the journal
events (util/events.py) that correlate with the violation window
(breaker trips, retry-budget exhaustion, holder refreshes, scrub
corruption), and the worst matching trace id from the span ring — the
"what was the cluster doing when it went bad" bundle.  Verdicts also
export ``SeaweedFS_slo_status{objective}`` /
``SeaweedFS_slo_burn_rate{objective,window}`` and a glog WARNING on
every ok→page transition carrying the worst trace id.

A copy of seaweedfs_tpu/stats/slo.py in the PyTorch port.
"""

from __future__ import annotations

import re
import time

from ..util import glog

PAGE_BURN = 14.4
WARN_BURN = 6.0
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0
MIN_COUNT = 10          # fast-window request floor before paging

# journal event types worth correlating into violation evidence
# (tenant_shed / arbiter_yield: a paying tenant's burn alongside the
# abuser being shed or background repair yielding IS the explanation)
EVIDENCE_TYPES = {"breaker_open", "breaker_close",
                  "retry_budget_exhausted", "holder_refresh",
                  "scrub_corruption", "worker_respawn",
                  "tenant_shed", "arbiter_yield"}

_HIST = "SeaweedFS_request_duration_seconds"
# per-tenant objectives (`tier.op/tenant:...`) evaluate against the
# tenant-attributed entry histogram instead (qos/)
_TENANT_HIST = "SeaweedFS_qos_tenant_request_seconds"

_SPEC_RE = re.compile(
    r"^(?P<tier>[a-z0-9_]+)\.(?P<op>[a-z0-9_.]+)"
    r"(?:/(?P<tenant>[A-Za-z0-9._-]+))?:"
    r"p(?P<q>\d{1,2}(?:\.\d+)?)<(?P<thresh>\d+(?:\.\d+)?)"
    r"(?P<unit>ms|s)@(?P<obj>\d{1,2}(?:\.\d+)?)$")

STATUS_LEVELS = {"ok": 0, "warn": 1, "page": 2}


class SloSpec:
    """One parsed objective. `tier.op/tenant:pQQ<NNms@OBJ` scopes the
    objective to ONE tenant's entry-tier latency (the bounded tenant
    label from qos/) — the paying tenant keeps an armed
    objective while the abuser is shed around it."""

    __slots__ = ("raw", "tier", "op", "tenant", "quantile",
                 "threshold_s", "objective")

    def __init__(self, raw: str):
        m = _SPEC_RE.match(raw.strip())
        if m is None:
            raise ValueError(
                f"bad -slo spec {raw!r}: want "
                f"tier.op[/tenant]:pQQ<NNms@OBJ "
                f"(e.g. volume.read:p99<50ms@99.9)")
        self.raw = raw.strip()
        self.tier = m.group("tier")
        self.op = m.group("op")
        self.tenant = m.group("tenant") or ""
        self.quantile = float(m.group("q")) / 100.0
        thresh = float(m.group("thresh"))
        self.threshold_s = thresh / 1000.0 if m.group("unit") == "ms" \
            else thresh
        self.objective = float(m.group("obj")) / 100.0
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"bad -slo spec {raw!r}: objective "
                             f"{m.group('obj')} must be in (0, 100)")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def to_dict(self) -> dict:
        d = {"spec": self.raw, "tier": self.tier, "op": self.op,
             "quantile": self.quantile,
             "threshold_ms": round(self.threshold_s * 1000.0, 3),
             "objective": self.objective}
        if self.tenant:
            d["tenant"] = self.tenant
        return d


def parse_specs(raws: "list[str]") -> "list[SloSpec]":
    return [SloSpec(r) for r in raws]


# ---------------------------------------------------------------------------
# histogram math


def _matches(spec: SloSpec, base_key: str) -> bool:
    from .timeline import split_key
    name, labels = split_key(base_key)
    if spec.tenant:
        return (name == _TENANT_HIST
                and labels.get("tier") == spec.tier
                and labels.get("op") == spec.op
                and labels.get("tenant") == spec.tenant)
    return (name == _HIST and labels.get("tier") == spec.tier
            and labels.get("op") == spec.op)


def _frac_over(buckets: "dict[str, float]", threshold_s: float,
               total: float) -> float:
    """Fraction of the window's requests SLOWER than threshold_s,
    interpolated inside the containing bucket (conservative: mass in
    the +Inf bucket is always counted as over)."""
    if total <= 0:
        return 0.0
    edges = []
    for le, c in buckets.items():
        try:
            edges.append((float("inf") if le in ("+Inf", "inf")
                          else float(le), c))
        except ValueError:
            continue
    edges.sort()
    lo_edge, lo_cum = 0.0, 0.0
    under = 0.0
    for edge, cum in edges:
        if edge >= threshold_s:
            if edge == float("inf") or edge == threshold_s:
                under = cum if edge == threshold_s else lo_cum
            else:
                under = lo_cum + (cum - lo_cum) * \
                    (threshold_s - lo_edge) / (edge - lo_edge)
            break
        lo_edge, lo_cum = edge, cum
    else:
        under = total
    return max(0.0, min(1.0, 1.0 - under / total))


def _span_stats(spec: SloSpec, windows: "list[dict]",
                horizon_s: float, now_ms: float) -> dict:
    """Sum the spec's histogram deltas over the windows inside the
    horizon and derive (count, violating fraction, burn, slice)."""
    floor = now_ms - horizon_s * 1000.0
    buckets: dict[str, float] = {}
    total = 0.0
    per_window: list[dict] = []
    for w in windows:
        if w["wall_ms"] < floor:
            continue
        wcount = 0.0
        wbuckets: dict[str, float] = {}
        for base, h in w.get("hist", {}).items():
            if not _matches(spec, base):
                continue
            wcount += h.get("count", 0.0)
            for le, c in h.get("buckets", {}).items():
                wbuckets[le] = wbuckets.get(le, 0.0) + c
                buckets[le] = buckets.get(le, 0.0) + c
        total += wcount
        if wcount:
            per_window.append({
                "wall_ms": w["wall_ms"],
                "count": wcount,
                "frac_over": round(
                    _frac_over(wbuckets, spec.threshold_s, wcount), 4),
            })
    frac = _frac_over(buckets, spec.threshold_s, total)
    # pQQ<THRESH permits (1 - QQ) of requests over THRESH for free;
    # only the excess spends the @OBJ error budget (this is what makes
    # p50 in a spec actually laxer than p99)
    excess = max(0.0, frac - (1.0 - spec.quantile))
    return {"count": total, "frac_over": round(frac, 4),
            "burn": round(excess / spec.budget, 2),
            "windows": per_window}


# ---------------------------------------------------------------------------
# the engine


class SloEngine:
    def __init__(self, specs: "list[SloSpec]",
                 fast_s: float = FAST_WINDOW_S,
                 slow_s: float = SLOW_WINDOW_S,
                 page_burn: float = PAGE_BURN,
                 warn_burn: float = WARN_BURN,
                 min_count: float = MIN_COUNT):
        self.specs = specs
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.page_burn = page_burn
        self.warn_burn = warn_burn
        self.min_count = min_count
        self._last_status: dict[str, str] = {}

    def evaluate(self, windows: "list[dict]",
                 events: "list[dict] | None" = None,
                 now_ms: "float | None" = None,
                 update_metrics: bool = False) -> dict:
        """The /debug/health payload over the given timeline windows
        (local or whole-host-merged) and journal events."""
        now_ms = now_ms if now_ms is not None else time.time() * 1000.0
        objectives = []
        worst = "ok"
        for spec in self.specs:
            fast = _span_stats(spec, windows, self.fast_s, now_ms)
            slow = _span_stats(spec, windows, self.slow_s, now_ms)
            status = "ok"
            if fast["count"] >= self.min_count:
                if fast["burn"] >= self.page_burn and \
                        slow["burn"] >= self.page_burn:
                    status = "page"
                elif fast["burn"] >= self.warn_burn and \
                        slow["burn"] >= self.warn_burn:
                    status = "warn"
            row = {**spec.to_dict(), "status": status,
                   "fast": {"horizon_s": self.fast_s,
                            "count": fast["count"],
                            "frac_over": fast["frac_over"],
                            "burn": fast["burn"]},
                   "slow": {"horizon_s": self.slow_s,
                            "count": slow["count"],
                            "frac_over": slow["frac_over"],
                            "burn": slow["burn"]}}
            if status != "ok":
                row["evidence"] = self._evidence(spec, slow, events,
                                                 now_ms)
            objectives.append(row)
            if STATUS_LEVELS[status] > STATUS_LEVELS[worst]:
                worst = status
            if update_metrics:
                # only the canonical per-snapshot tick() path exports
                # gauges AND tracks transitions: a /debug/health poll
                # evaluates whole-host MERGED windows against the same
                # engine, and letting it touch _last_status would log
                # phantom ok->page->ok flaps whenever local and merged
                # verdicts disagree (e.g. only a sibling is slow)
                self._export(spec, status, fast, slow)
                self._log_transition(spec, status, row)
        return {"status": worst, "objectives": objectives,
                "now_ms": round(now_ms, 3)}

    def _evidence(self, spec: SloSpec, slow: dict,
                  events: "list[dict] | None", now_ms: float) -> dict:
        """The violating timeline slice + correlated journal events +
        the worst matching trace id from the span ring.

        Both span the whole burn episode (the SLOW horizon), not just
        the fast window: a slow-burn page can land minutes after the
        breaker trips that explain it, and evidence clipped to the
        last 60s would come up empty exactly when it matters."""
        violating = sorted(
            (w for w in slow["windows"]
             # a window violates when its own p-quantile is over the
             # threshold, i.e. more than the spec's allowance of its
             # requests were slow
             if w["frac_over"] > (1.0 - spec.quantile)),
            key=lambda w: w["wall_ms"])
        from_ms = now_ms - self.fast_s * 1000.0
        if violating:
            # correlate from the START of the damage, with one fast
            # horizon of margin for the events that caused it
            from_ms = min(from_ms,
                          violating[0]["wall_ms"] - self.fast_s * 1000.0)
        ev: dict = {
            "window": {"from_ms": round(from_ms, 3),
                       "to_ms": round(now_ms, 3)},
            "violating_total": len(violating),
            "violating_windows": violating[-200:],
        }
        if events is None:
            from ..util import events as journal
            correlated = journal.window(from_ms, now_ms,
                                        types=EVIDENCE_TYPES)
        else:
            correlated = [e for e in events
                          if e.get("type") in EVIDENCE_TYPES
                          and from_ms <= e.get("wall_ms", 0) <= now_ms]
        # journal.window is chronological but /debug/events payloads
        # arrive newest-first — normalize before truncating so every
        # path keeps the NEWEST 20 (the breaker that just fired), in
        # chronological order
        correlated.sort(key=lambda e: e.get("wall_ms", 0))
        ev["events"] = correlated[-20:]
        worst = self._worst_trace(spec, from_ms, now_ms)
        if worst:
            ev["worst_trace"] = worst
        return ev

    def _worst_trace(self, spec: SloSpec, from_ms: float,
                     to_ms: float) -> "dict | None":
        """Slowest span of the spec's (tier, op) that started inside
        the violation window — the direct pointer from a page to ONE
        reconstructable request."""
        from ..util import tracing
        payload = tracing.traces_dict(recent=0, slowest=50)
        best: dict | None = None
        for g in payload.get("slowest", ()):
            for s in g.get("spans", ()):
                if s.get("tier") != spec.tier or s.get("op") != spec.op:
                    continue
                if not from_ms <= s.get("start_ms", 0) <= to_ms:
                    continue
                if best is None or s["dur_ms"] > best["dur_ms"]:
                    best = {"trace": s["trace"],
                            "dur_ms": s["dur_ms"],
                            "status": s.get("status")}
        return best

    def _export(self, spec: SloSpec, status: str, fast: dict,
                slow: dict) -> None:
        from . import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        metrics.SLO_STATUS.labels(spec.raw).set(STATUS_LEVELS[status])
        metrics.SLO_BURN_RATE.labels(spec.raw, "fast").set(fast["burn"])
        metrics.SLO_BURN_RATE.labels(spec.raw, "slow").set(slow["burn"])

    def _log_transition(self, spec: SloSpec, status: str,
                        row: dict) -> None:
        prev = self._last_status.get(spec.raw, "ok")
        if status == prev:
            return
        self._last_status[spec.raw] = status
        if STATUS_LEVELS[status] > STATUS_LEVELS[prev]:
            trace = (row.get("evidence", {})
                     .get("worst_trace") or {}).get("trace", "")
            glog.warning(
                "SLO %s: %s -> %s (fast burn %.1f, slow burn %.1f)%s",
                spec.raw, prev, status, row["fast"]["burn"],
                row["slow"]["burn"],
                f" worst trace={trace}" if trace else "")
        else:
            glog.info("SLO %s: %s -> %s (recovered)", spec.raw, prev,
                      status)


# ---------------------------------------------------------------------------
# process-wide engine (wired from -slo flags)

_engine: "SloEngine | None" = None


def init(raw_specs: "list[str]") -> "SloEngine | None":
    """Build the process engine from -slo flags (ValueError on a bad
    spec — a daemon must refuse to start guarding nothing)."""
    global _engine
    _engine = SloEngine(parse_specs(raw_specs)) if raw_specs else None
    return _engine


def engine() -> "SloEngine | None":
    return _engine


def windows_needed(minimum: int = 200) -> int:
    """Timeline windows that cover the SLOW burn horizon at the wired
    snapshot cadence. A fixed fetch of 200 silently truncates the 600s
    slow window whenever -timeline.interval is under 3s — the slow
    burn then collapses toward the fast burn and a short blip pages
    where the 600s dilution is supposed to suppress it."""
    from . import timeline
    iv = timeline.interval_s()
    if iv <= 0:
        return minimum
    slow_s = _engine.slow_s if _engine is not None else SLOW_WINDOW_S
    return max(minimum, min(10_000, int(slow_s / iv) + 2))


def tick() -> None:
    """Per-snapshot evaluation over THIS process's local ring: keeps
    the SeaweedFS_slo_* gauges and the transition log live even when
    nobody polls /debug/health."""
    if _engine is None or not _engine.specs:
        return
    from . import timeline
    # render=False: evaluate() reads only the raw hist deltas, and
    # this runs on every snapshot
    payload = timeline.timeline_dict(n=windows_needed(), render=False)
    _engine.evaluate(payload["windows"], update_metrics=True)


def health_dict(windows: "list[dict]",
                events: "list[dict] | None" = None) -> dict:
    """The /debug/health payload (empty-engine daemons report ok with
    zero objectives, so the schema is stable for the CI smoke)."""
    if _engine is None or not _engine.specs:
        return {"status": "ok", "objectives": [],
                "now_ms": round(time.time() * 1000.0, 3)}
    return _engine.evaluate(windows, events=events)


def debug_handler():
    """One aiohttp /debug/health handler over THIS process's local
    timeline + journal — registered by every non-worker-aggregating
    server."""
    from aiohttp import web

    async def h_health(req):
        from ..util import events as journal
        from . import timeline
        payload = timeline.timeline_dict(n=windows_needed(),
                                         render=False)
        return web.json_response(health_dict(
            payload["windows"],
            events=journal.events_dict(n=500)["events"]))

    return h_health
