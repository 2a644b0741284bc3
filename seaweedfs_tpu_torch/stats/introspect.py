"""Cluster-scope introspection: fan-out + cross-host trace assembly.

Every ``/debug/*`` surface merges only across ``-workers`` siblings of
ONE host, so a request that crosses s3 → filer shard → owner volume →
replica on three hosts fragments into three disconnected span rings.
This module is the leader-side glue that makes the recorder speak for
the CLUSTER:

- :func:`cluster_nodes` enumerates every debug-capable member the
  leader knows about — quorum peers (``-peers``), topology-fed volume
  servers (heartbeats), shard-map-fed filers — in deterministic order;
- :func:`fanout` pulls one debug path from each of them, frame-first
  over the existing fabric with HTTP fallback, under a bounded
  per-node deadline (``-introspect.deadline``) and the
  ``introspect.fanout`` failpoint, so a dead member degrades its row
  and can NEVER hang the endpoint. Every hop is counted in
  ``SeaweedFS_introspect_fanout_total{result}``;
- :func:`assemble_trace` folds the per-node span pulls into ONE tree
  with host/tier attribution, per-hop self-time, and explicit
  ``missing_nodes`` annotations — deterministically ordered, so the
  same completed trace assembles byte-identically on retry.

The timeline/events/health cluster views reuse the PR 8 whole-host
merge discipline verbatim (stats/timeline.merge_payloads,
util/events.merge_payloads, stats/slo.health_dict): sum rates and
histogram buckets, MAX the ``NON_ADDITIVE_GAUGE_PREFIXES``, recompute
quantiles from merged buckets — never average.

A copy of seaweedfs_tpu/stats/introspect.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import json

import aiohttp

from ..security import tls
from ..util import failpoints

DEFAULT_DEADLINE_S = 3.0

_deadline_s = DEFAULT_DEADLINE_S

# lazily-bound prometheus counter (same shape as tracing._observe)
_counter: object = None

# extra-node kinds -> debug path prefix (the path-shadowing gateways
# serve /__debug__/ so a stored object named "debug" can't shadow it)
KIND_PREFIX = {"master": "/debug", "volume": "/debug",
               "filer": "/__debug__", "s3": "/__debug__",
               "webdav": "/__debug__"}
# kinds that terminate frame connections (master/frameadapter.py,
# server/frameserver.py): a frame attempt against anything else would
# burn the node's whole deadline waiting on a HELLO no one answers
FRAME_KINDS = frozenset(("master", "volume"))


def init(deadline_s: float = DEFAULT_DEADLINE_S) -> None:
    """Wire from the CLI flag: -introspect.deadline (per-node budget
    for every cluster fan-out hop)."""
    global _deadline_s
    _deadline_s = max(0.1, float(deadline_s))


def deadline_s() -> float:
    return _deadline_s


def _count(result: str) -> None:
    global _counter
    if _counter is None:
        try:
            from . import metrics
            _counter = (metrics.INTROSPECT_FANOUT
                        if metrics.HAVE_PROMETHEUS else False)
        except ImportError:
            _counter = False
    if _counter:
        _counter.labels(result).inc()


# ---------------------------------------------------------------------------
# node enumeration


def cluster_nodes(ms, extra: str = "") -> "list[dict]":
    """Every debug-capable member from the leader's vantage, deduped
    by address, deterministic order: this master first, then quorum
    peers, topology volume servers, shard-map filer owners, then any
    ``extra`` nodes (comma-separated ``[kind:]host:port`` — the hook
    for members the master has no registry for, e.g. an S3 gateway).
    ``ms`` is the MasterServer (duck-typed for tests)."""
    nodes = [{"node": ms.url, "kind": "master", "prefix": "/debug",
              "local": True}]
    seen = {ms.url}
    for p in ms._peers:
        if p in seen:
            continue
        seen.add(p)
        nodes.append({"node": p, "kind": "master", "prefix": "/debug"})
    for n in ms.topo.all_nodes():
        if n.url in seen:
            continue
        seen.add(n.url)
        nodes.append({"node": n.url, "kind": "volume",
                      "prefix": "/debug"})
    owners = (ms._shard_map_dict().get("owners") or {})
    for sid in sorted(owners, key=lambda s: int(s)):
        addr = owners[sid]
        if addr in seen:
            continue
        seen.add(addr)
        nodes.append({"node": addr, "kind": "filer",
                      "prefix": "/__debug__"})
    for item in (extra or "").split(","):
        item = item.strip()
        if not item:
            continue
        kind, addr = "volume", item
        head, _, rest = item.partition(":")
        if head in KIND_PREFIX and rest:
            kind, addr = head, rest
        if addr in seen:
            continue
        seen.add(addr)
        nodes.append({"node": addr, "kind": kind,
                      "prefix": KIND_PREFIX[kind]})
    return nodes


# ---------------------------------------------------------------------------
# bounded fan-out


async def _pull(http, frame_hub, addr: str, path: str,
                params: "dict | None", timeout: float):
    """One per-node debug pull: frame-first when a hub is wired (the
    master's raft peers terminate whitelisted debug routes over
    frames; everything else answers FLAG_FALLBACK), HTTP fallback.
    Raises on failure — fanout() turns that into a missing_nodes row."""
    # chaos site: the cluster-assembly hop — error/latency/drop here
    # must degrade to a missing_node row inside the deadline, never
    # hang or 500 the whole endpoint
    await failpoints.fail("introspect.fanout")
    if frame_hub is not None:
        from ..util.frame import FrameChannelError
        try:
            chan = frame_hub.get(target=addr)
            # half the budget: a wedged frame channel must leave room
            # for the HTTP leg inside the same per-node deadline
            status, _hdrs, raw = await chan.request(
                "GET", path, query=params, timeout=timeout / 2)
            if status == 200:
                return json.loads(raw or b"{}")
        except (FrameChannelError, asyncio.TimeoutError, OSError,
                ValueError):
            pass            # the HTTP leg below is the resilient one
    async with http.get(
            tls.url(addr, path), params=params,
            timeout=aiohttp.ClientTimeout(total=timeout)) as resp:
        if resp.status != 200:
            raise OSError(f"HTTP {resp.status}")
        return await resp.json(content_type=None)


async def fanout(nodes: "list[dict]", path: str, http,
                 frame_hub=None, params: "dict | None" = None,
                 deadline: "float | None" = None,
                 local=None):
    """Pull ``prefix + path`` from every node in parallel, each under
    its own deadline. Returns ``(results, missing)`` where results is
    ``[(node_dict, payload)]`` and missing is the degraded rows —
    sorted by address, so downstream assembly is deterministic. A
    node marked ``local`` is answered by the ``local()`` callable (or
    awaitable result) instead of the network."""
    deadline = deadline if deadline is not None else _deadline_s
    results: "list[tuple[dict, dict]]" = []
    missing: "list[dict]" = []

    async def one(nd: dict) -> None:
        if nd.get("local") and local is not None:
            payload = local()
            if asyncio.iscoroutine(payload):
                payload = await payload
            results.append((nd, payload))
            return
        hub = frame_hub if nd["kind"] in FRAME_KINDS else None
        try:
            payload = await asyncio.wait_for(
                _pull(http, hub, nd["node"], nd["prefix"] + path,
                      params, deadline),
                timeout=deadline)
            _count("ok")
            results.append((nd, payload))
        except asyncio.TimeoutError:
            _count("timeout")
            missing.append({"node": nd["node"], "kind": nd["kind"],
                            "error": "timeout"})
        except (aiohttp.ClientError, OSError, ValueError) as e:
            _count("error")
            missing.append({"node": nd["node"], "kind": nd["kind"],
                            "error": str(e) or type(e).__name__})

    await asyncio.gather(*(one(nd) for nd in nodes))
    results.sort(key=lambda r: r[0]["node"])
    missing.sort(key=lambda m: m["node"])
    return results, missing


# ---------------------------------------------------------------------------
# trace assembly (pure — unit-testable without a cluster)


def assemble_trace(trace_id: str,
                   node_payloads: "list[tuple[str, dict]]",
                   missing: "list[dict] | None" = None) -> dict:
    """ONE tree from per-node ``?trace=`` span pulls.

    ``node_payloads`` is ``[(host, payload)]``; every span is stamped
    with the host that reported it, span ids dedupe across nodes (a
    finished record beats an in-flight sighting), per-span self-time
    is ``dur - Σ(direct children)`` and rolls up per tier AND per
    host — the "which host ate the time" attribution. Ordering is
    deterministic everywhere (sorted spans, sorted rollup keys,
    sorted missing rows): the same completed trace assembles
    byte-identically on retry."""
    by_id: dict[str, dict] = {}
    for host, payload in sorted(node_payloads, key=lambda hp: hp[0]):
        for d in payload.get("spans", ()):
            row = dict(d)
            row["host"] = host
            sid = row.get("span", "")
            cur = by_id.get(sid)
            if cur is None or (cur.get("inflight")
                               and not row.get("inflight")):
                by_id[sid] = row
    spans = sorted(by_id.values(),
                   key=lambda d: (d.get("start_ms", 0.0),
                                  d.get("span", "")))
    child_ms: dict[str, float] = {}
    for d in spans:
        p = d.get("parent", "")
        if p in by_id:
            child_ms[p] = child_ms.get(p, 0.0) + d.get("dur_ms", 0.0)
    tiers: dict[str, float] = {}
    hosts: dict[str, float] = {}
    children: dict[str, list] = {}
    roots: list[dict] = []
    for d in spans:
        d["self_ms"] = round(
            max(0.0, d.get("dur_ms", 0.0)
                - child_ms.get(d["span"], 0.0)), 3)
        tiers[d["tier"]] = round(
            tiers.get(d["tier"], 0.0) + d["self_ms"], 3)
        hosts[d["host"]] = round(
            hosts.get(d["host"], 0.0) + d["self_ms"], 3)
        p = d.get("parent", "")
        if p and p in by_id:
            children.setdefault(p, []).append(d)
        else:
            roots.append(d)

    visited: set = set()

    def nest(d: dict) -> dict:
        node = dict(d)
        visited.add(d["span"])
        kids = [k for k in children.get(d["span"], ())
                if k["span"] not in visited]
        if kids:
            node["children"] = [nest(k) for k in kids]
        return node

    tree = [nest(r) for r in roots if r["span"] not in visited]
    missing = sorted(missing or [], key=lambda m: m.get("node", ""))
    return {
        "trace_id": trace_id,
        "spans": len(spans),
        "start_ms": min((d.get("start_ms", 0.0) for d in spans),
                        default=0.0),
        "dur_ms": max((d.get("dur_ms", 0.0) for d in spans),
                      default=0.0),
        "inflight": sum(1 for d in spans if d.get("inflight")),
        "tiers": {k: tiers[k] for k in sorted(tiers)},
        "hosts": {k: hosts[k] for k in sorted(hosts)},
        "complete": not missing,
        "missing_nodes": missing,
        "tree": tree,
    }
