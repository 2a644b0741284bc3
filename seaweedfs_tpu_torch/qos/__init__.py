"""Multi-tenant QoS: admission, shedding, and bandwidth arbitration.

`admission.py` holds the per-tenant classification / rate-limit /
weighted-fair-queue / shed machinery; `arbiter.py` the cluster-wide
background-vs-foreground bandwidth arbiter. This module owns the
per-process singletons the servers consult, the tenant-identity
extraction shared by the filer/WebDAV tiers, and the merged
`/debug/qos` surface.

A copy of seaweedfs_tpu/qos/__init__.py in the PyTorch port.
"""

from __future__ import annotations

import base64
import contextvars
import json

from .admission import (DEFAULT, AdmissionController, Decision,  # noqa: F401
                        RateBucket, TenantClass, WFQ,
                        parse_tenant_flag, parse_tenant_flags)
from .arbiter import BandwidthArbiter, GrantBucket  # noqa: F401

_admission: "AdmissionController | None" = None
_arbiter: "BandwidthArbiter | None" = None

# the requesting tenant's CLASS, set by entry middlewares for the
# request's task context — downstream consumers (util/resilience.py
# retry-budget keying) read it without plumbing a parameter through
# every hop
_class_var: contextvars.ContextVar = contextvars.ContextVar(
    "qos_class", default="")


def init_admission(tenant_specs, *, lag_shed_ms: float = 0.0,
                   wait_shed_ms: float = 0.0,
                   inflight_limit: int = 256,
                   queue_deadline_s: float = 2.0) -> AdmissionController:
    """Parse -qos.tenant flags and install the process admission
    plane. Raises ValueError on malformed specs (boot-time refusal)."""
    global _admission
    _admission = AdmissionController(
        parse_tenant_flags(tenant_specs), lag_shed_ms=lag_shed_ms,
        wait_shed_ms=wait_shed_ms, inflight_limit=inflight_limit,
        queue_deadline_s=queue_deadline_s)
    return _admission


def admission() -> "AdmissionController | None":
    return _admission


def init_arbiter(budget_mbps: float = 0.0,
                 floor: float = 0.25) -> BandwidthArbiter:
    global _arbiter
    _arbiter = BandwidthArbiter(budget_mbps=budget_mbps, floor=floor)
    return _arbiter


def arbiter() -> "BandwidthArbiter | None":
    return _arbiter


def note_foreground(nbytes: int) -> None:
    """Hot-path foreground byte accounting (server/wire.py,
    server/fasthttp.py). Cheap no-op until an arbiter exists."""
    if _arbiter is not None and nbytes:
        _arbiter.note_foreground(nbytes)


def set_current_class(cls: str):
    """Tag the running context with the admitted tenant class;
    returns the reset token."""
    return _class_var.set(cls)


def current_class() -> str:
    return _class_var.get()


def reset(state=None) -> None:
    """Test hook: drop the singletons (and optionally restore)."""
    global _admission, _arbiter
    if state is None:
        _admission = _arbiter = None
    else:
        _admission, _arbiter = state


# ---------------------------------------------------------------------------
# tenant identity extraction (filer / WebDAV tiers; S3 uses the
# SigV4-verified access key directly)

def tenant_from_headers(headers) -> str:
    """Best-effort identity for classification: the SigV4 credential
    access key when the request is AWS-signed, else the JWT `sub`
    claim (payload-decoded only — this keys CLASSIFICATION and rate
    limits, not authorization, which stays with the verifying
    tiers), else empty (-> default class)."""
    auth = headers.get("Authorization", "") if headers else ""
    if auth.startswith("AWS4-HMAC-SHA256"):
        # ... Credential=AKID/20260101/region/s3/aws4_request, ...
        i = auth.find("Credential=")
        if i >= 0:
            cred = auth[i + len("Credential="):]
            return cred.split("/", 1)[0].split(",", 1)[0].strip()
    if auth.startswith("Bearer "):
        token = auth[7:]
        parts = token.split(".")
        if len(parts) == 3:
            try:
                pad = parts[1] + "=" * (-len(parts[1]) % 4)
                claims = json.loads(base64.urlsafe_b64decode(pad))
                sub = claims.get("sub", "")
                if isinstance(sub, str) and sub:
                    return sub
            except (ValueError, TypeError):
                pass
    return ""


# ---------------------------------------------------------------------------
# /debug/qos

def qos_dict() -> dict:
    """The process-local QoS surface (merged across -workers by
    merge_payloads, exactly like timeline/events)."""
    d: dict = {}
    if _admission is not None:
        d.update(_admission.to_dict())
    if _arbiter is not None:
        d["arbiter"] = _arbiter.to_dict()
    return {"qos": d}


def merge_payloads(payloads: "list[dict]") -> dict:
    """Fold several workers' /debug/qos payloads into one whole-host
    view: counters sum, shed level and probes take the worst worker,
    policy/config rows come from the first worker that has them."""
    merged: dict = {}
    tenants: dict = {}
    consumers: dict = {}
    grants: list = []
    for p in payloads:
        q = (p or {}).get("qos") or {}
        for label, row in (q.get("tenants") or {}).items():
            t = tenants.get(label)
            if t is None:
                tenants[label] = dict(row)
                continue
            for k in ("admitted", "throttled", "shed", "queued",
                      "queue_depth"):
                t[k] = t.get(k, 0) + row.get(k, 0)
            t["tokens"] = round(t.get("tokens", 0.0)
                                + row.get("tokens", 0.0), 3)
        for k in ("inflight", "inflight_limit", "queued"):
            if k in q:
                merged[k] = merged.get(k, 0) + q[k]
        if "shed_level" in q:
            merged["shed_level"] = max(merged.get("shed_level", 0),
                                       q["shed_level"])
        for k in ("ladder", "thresholds", "queue_deadline_s"):
            if k in q and k not in merged:
                merged[k] = q[k]
        if "probes" in q:
            cur = merged.setdefault("probes",
                                    {"lag_ms": 0.0, "wait_ms": 0.0})
            for k in ("lag_ms", "wait_ms"):
                cur[k] = max(cur[k], q["probes"].get(k, 0.0))
        a = q.get("arbiter")
        if a:
            arb = merged.setdefault(
                "arbiter", {"budget_mbps": 0.0, "floor": a.get("floor"),
                            "foreground_bps": 0.0})
            arb["budget_mbps"] = max(arb["budget_mbps"],
                                     a.get("budget_mbps", 0.0))
            arb["foreground_bps"] = round(
                arb["foreground_bps"] + a.get("foreground_bps", 0.0), 1)
            for kind, c in (a.get("consumers") or {}).items():
                m = consumers.setdefault(
                    kind, {"base_bps": 0, "rate_bps": 0,
                           "granted_bytes": 0, "yields": 0,
                           "slept_s": 0.0})
                for k in ("base_bps", "rate_bps", "granted_bytes",
                          "yields"):
                    m[k] += c.get(k, 0)
                m["slept_s"] = round(m["slept_s"]
                                     + c.get("slept_s", 0.0), 3)
            grants.extend(a.get("grants") or ())
    if tenants:
        merged["tenants"] = tenants
    if "arbiter" in merged:
        merged["arbiter"]["consumers"] = consumers
        grants.sort(key=lambda g: g.get("wall_ms", 0))
        merged["arbiter"]["grants"] = grants[-16:]
    return {"qos": merged, "workers": len(payloads)}


async def debug_handler(req):
    """GET /debug/qos — the single-process form (the -workers volume
    server merges siblings itself, server/volume_server.py)."""
    from aiohttp import web
    return web.json_response(qos_dict())
