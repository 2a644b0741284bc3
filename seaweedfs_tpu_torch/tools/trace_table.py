"""Per-tier latency breakdown from /debug/traces payloads.

Used by `seaweedfs_tpu_torch.tools.chaos --trace`: pulls the trace rings
of one or more daemons, folds the spans into per-(tier, op) rows of
self-time — the non-overlapping "which tier ate the time" attribution
computed by util/tracing.py — and renders an aligned text table:

    tier      op       spans   p50ms   p95ms   avg_self  total_self
    volume    read      1820     0.8     2.1        0.6      1092.0
    store     read      1820     0.4     1.2        0.4       728.0

Usage as a script:

    python -m seaweedfs_tpu_torch.tools.trace_table host:port [host:port ...]
    python -m seaweedfs_tpu_torch.tools.trace_table \
        --cluster master:port <trace_id>

`--cluster` renders ONE assembled cross-host trace from the leader's
/debug/cluster/trace/<id> — per-host/per-tier self-time, one row per
(host, tier, op), plus the missing_nodes rows when members were down.
"""

from __future__ import annotations

import json
import sys
import urllib.request


def fetch(addr: str, path: str = "/debug/traces",
          n: int = 200, timeout: float = 10.0) -> dict | None:
    """One daemon's trace payload, or None when unreachable."""
    url = f"http://{addr}{path}?n={n}&slowest=50"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.load(r)
    except (OSError, ValueError):
        return None


def rows_from_payloads(payloads: list[dict]) -> list[dict]:
    """Fold trace payloads into per-(tier, op) rows, deduping spans
    repeated between the recent and slowest lists."""
    seen: set[tuple[str, str]] = set()
    per: dict[tuple[str, str], list[tuple[float, float]]] = {}
    for p in payloads:
        if not p:
            continue
        for g in list(p.get("traces", ())) + list(p.get("slowest", ())):
            for s in g.get("spans", ()):
                key = (s.get("trace", ""), s.get("span", ""))
                if key in seen:
                    continue
                seen.add(key)
                per.setdefault((s.get("tier", "?"), s.get("op", "?")),
                               []).append((s.get("dur_ms", 0.0),
                                           s.get("self_ms",
                                                 s.get("dur_ms", 0.0))))
    rows = []
    for (tier, op), vals in per.items():
        durs = sorted(d for d, _ in vals)
        selfs = [sf for _, sf in vals]

        def pct(p: float) -> float:
            return durs[min(len(durs) - 1, int(p / 100 * len(durs)))]

        rows.append({
            "tier": tier, "op": op, "spans": len(vals),
            "p50_ms": round(pct(50), 2), "p95_ms": round(pct(95), 2),
            "p99_ms": round(pct(99), 2),
            "avg_self_ms": round(sum(selfs) / len(selfs), 3),
            "total_self_ms": round(sum(selfs), 1),
        })
    rows.sort(key=lambda r: -r["total_self_ms"])
    return rows


def render(rows: list[dict]) -> str:
    if not rows:
        return "(no traced spans — is -trace.sample > 0?)"
    cols = ["tier", "op", "spans", "p50_ms", "p95_ms", "p99_ms",
            "avg_self_ms", "total_self_ms"]
    table = [cols] + [[str(r[c]) for c in cols] for r in rows]
    widths = [max(len(line[i]) for line in table)
              for i in range(len(cols))]
    out = []
    for line in table:
        out.append("  ".join(v.ljust(w) for v, w in zip(line, widths)))
    return "\n".join(out)


def breakdown(addrs: list[str], paths: dict[str, str] | None = None
              ) -> str:
    """Fetch + fold + render in one call. `paths` overrides the debug
    path per address (the filer/S3 gateways use /__debug__/traces)."""
    payloads = []
    for addr in addrs:
        path = (paths or {}).get(addr, "/debug/traces")
        payloads.append(fetch(addr, path))
    return render(rows_from_payloads([p for p in payloads if p]))


# ---------------------------------------------------------------------------
# --cluster: one assembled cross-host trace


def fetch_cluster(master_addr: str, trace_id: str,
                  extra: str = "", timeout: float = 30.0) -> dict | None:
    """One assembled trace from the leader's /debug/cluster/trace/<id>
    (extra= forwards unregistered members, e.g. 's3:host:port')."""
    url = f"http://{master_addr}/debug/cluster/trace/{trace_id}"
    if extra:
        url += f"?extra={extra}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.load(r)
    except (OSError, ValueError):
        return None


def _flatten_tree(tree: list[dict]) -> list[dict]:
    out: list[dict] = []
    stack = list(tree)
    while stack:
        d = stack.pop()
        out.append(d)
        stack.extend(d.get("children", ()))
    return out


def cluster_rows(assembled: dict) -> list[dict]:
    """Per-(host, tier, op) self-time rows from one assembled cluster
    trace — "which host's which tier ate this request's time"."""
    per: dict[tuple[str, str, str], list[float]] = {}
    for s in _flatten_tree(assembled.get("tree", ())):
        per.setdefault((s.get("host", "?"), s.get("tier", "?"),
                        s.get("op", "?")),
                       []).append(s.get("self_ms",
                                        s.get("dur_ms", 0.0)))
    rows = []
    for (host, tier, op), selfs in per.items():
        rows.append({
            "host": host, "tier": tier, "op": op, "spans": len(selfs),
            "avg_self_ms": round(sum(selfs) / len(selfs), 3),
            "total_self_ms": round(sum(selfs), 1),
        })
    rows.sort(key=lambda r: -r["total_self_ms"])
    return rows


def render_cluster(assembled: dict | None) -> str:
    if not assembled or not assembled.get("tree"):
        return "(no assembled spans — bad trace id, or rings rotated?)"
    rows = cluster_rows(assembled)
    cols = ["host", "tier", "op", "spans", "avg_self_ms",
            "total_self_ms"]
    table = [cols] + [[str(r[c]) for c in cols] for r in rows]
    widths = [max(len(line[i]) for line in table)
              for i in range(len(cols))]
    out = [f"trace {assembled.get('trace_id', '?')}: "
           f"{assembled.get('spans', 0)} spans, "
           f"{assembled.get('dur_ms', 0)}ms, hosts="
           f"{','.join(assembled.get('hosts', {}) or ['?'])}"]
    for line in table:
        out.append("  ".join(v.ljust(w) for v, w in zip(line, widths)))
    for m in assembled.get("missing_nodes", ()):
        out.append(f"missing: {m.get('node')} ({m.get('kind')}): "
                   f"{m.get('error')}")
    return "\n".join(out)


def cluster_breakdown(master_addr: str, trace_id: str,
                      extra: str = "") -> str:
    return render_cluster(fetch_cluster(master_addr, trace_id,
                                        extra=extra))


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--cluster":
        if len(sys.argv) < 4:
            print(__doc__)
            sys.exit(2)
        print(cluster_breakdown(sys.argv[2], sys.argv[3],
                                extra=(sys.argv[4]
                                       if len(sys.argv) > 4 else "")))
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(2)
    print(breakdown(sys.argv[1:]))
