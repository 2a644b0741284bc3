"""Prometheus metrics.

Reference: weed/stats/metrics.go:13-92 (per-tier counters/histograms/
gauges) and :109-137 (push-gateway loop; the master hands the gateway
address to nodes via heartbeat responses). Exposed here both as a /metrics
scrape endpoint on every server and an optional push loop.

A copy of seaweedfs_tpu/stats/metrics.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import platform
import time

try:
    from prometheus_client import (CollectorRegistry, Counter, Gauge,
                                   Histogram, generate_latest,
                                   push_to_gateway)
    HAVE_PROMETHEUS = True
except ImportError:  # pragma: no cover
    HAVE_PROMETHEUS = False

if HAVE_PROMETHEUS:
    REGISTRY = CollectorRegistry()

    MASTER_RECEIVED_HEARTBEATS = Counter(
        "SeaweedFS_master_received_heartbeats", "heartbeats received",
        registry=REGISTRY)
    # HA master quorum (master/election.py): the raft state every
    # failover dashboard needs — whose term, how far committed, and
    # who leads. All three are identities of ONE process, not additive
    # quantities: they join NON_ADDITIVE_GAUGE_PREFIXES below so a
    # -workers merged host reports the max (one leader), never a sum
    # (two "leaders", a doubled term)
    RAFT_TERM = Gauge(
        "SeaweedFS_raft_term",
        "current raft term of this master", registry=REGISTRY)
    RAFT_COMMIT_INDEX = Gauge(
        "SeaweedFS_raft_commit_index",
        "highest raft log index known committed on this master",
        registry=REGISTRY)
    RAFT_IS_LEADER = Gauge(
        "SeaweedFS_raft_is_leader",
        "1 when this master is the elected (or single-mode) leader",
        registry=REGISTRY)
    MASTER_ASSIGN_REQUESTS = Counter(
        "SeaweedFS_master_assign_requests", "assign requests",
        ["status"], registry=REGISTRY)
    VOLUME_REQUEST_TIME = Histogram(
        "SeaweedFS_volumeServer_request_seconds", "needle request time",
        ["type"], registry=REGISTRY)
    VOLUME_REQUEST_COUNTER = Counter(
        "SeaweedFS_volumeServer_request_total", "needle requests",
        ["type", "status"], registry=REGISTRY)
    VOLUME_COUNT = Gauge(
        "SeaweedFS_volumeServer_volumes", "volumes on this server",
        registry=REGISTRY)
    FILER_REQUEST_TIME = Histogram(
        "SeaweedFS_filer_request_seconds", "filer request time",
        ["type"], registry=REGISTRY)
    # sharded filer metadata plane (filer/shard.py): routing outcomes
    # per request, the committed map epoch this shard has adopted, and
    # entries streamed out by split/move migrations
    FILER_SHARD_REQUESTS = Counter(
        "SeaweedFS_filer_shard_requests_total",
        "shard routing outcomes",
        ["result"], registry=REGISTRY)
    FILER_SHARD_EPOCH = Gauge(
        "SeaweedFS_filer_shard_map_epoch",
        "adopted shard map epoch", registry=REGISTRY)
    FILER_SHARD_MOVED = Counter(
        "SeaweedFS_filer_shard_moved_entries_total",
        "entries migrated out by shard split/move",
        registry=REGISTRY)
    EC_ENCODE_BYTES = Counter(
        "SeaweedFS_ec_encode_bytes_total", "bytes erasure-encoded",
        registry=REGISTRY)
    EC_THROUGHPUT = Gauge(
        "SeaweedFS_ec_encode_GBps", "last measured EC encode GB/s/chip",
        registry=REGISTRY)
    # degraded-read recovers (ec/ec_volume.py): one a transform, by the
    # path it took ("card" or "host"), and the lost rows they decoded;
    # rows / recovers is how many lost intervals of one stripe row a
    # recover decodes at once
    EC_RECOVERS = Counter(
        "SeaweedFS_ec_recovers_total",
        "degraded-read recover transforms, by path",
        ["path"], registry=REGISTRY)
    EC_RECOVER_ROWS = Counter(
        "SeaweedFS_ec_recover_rows_total",
        "lost shard intervals decoded by degraded-read recovers, by path",
        ["path"], registry=REGISTRY)
    # the pieces those recovers were enqueued in (ops/gf256_cuda.py's
    # chain on the card; 1 a recover elsewhere); pieces / recovers says
    # the chain engages
    EC_RECOVER_PIECES = Counter(
        "SeaweedFS_ec_recover_pieces_total",
        "pieces degraded-read recover transforms were enqueued in, by path",
        ["path"], registry=REGISTRY)
    # remote EC shard reads (server/volume_server.py): one a holder
    # request that answered, and the interval bytes it brought, by the
    # transport it rode ("frame" or "http")
    EC_FETCHES = Counter(
        "SeaweedFS_ec_fetches_total",
        "remote EC shard-interval requests answered, by transport",
        ["transport"], registry=REGISTRY)
    EC_FETCH_BYTES = Counter(
        "SeaweedFS_ec_fetch_bytes_total",
        "EC shard-interval bytes fetched from peers, by transport",
        ["transport"], registry=REGISTRY)
    # tiered read caches (util/chunk_cache.py): one label per cache —
    # "needle" (volume hot needles), "chunk" (filer/s3/webdav whole
    # chunks), "ec_recover" (degraded-read reconstructions),
    # "lookup_neg" (client negative volume lookups)
    CACHE_HITS = Counter(
        "SeaweedFS_cache_hits_total", "read-cache hits",
        ["cache"], registry=REGISTRY)
    CACHE_MISSES = Counter(
        "SeaweedFS_cache_misses_total", "read-cache misses",
        ["cache"], registry=REGISTRY)
    CACHE_HIT_BYTES = Counter(
        "SeaweedFS_cache_hit_bytes_total", "bytes served from read caches",
        ["cache"], registry=REGISTRY)
    CACHE_EVICTIONS = Counter(
        "SeaweedFS_cache_evictions_total", "read-cache evictions",
        ["cache"], registry=REGISTRY)
    CACHE_USED_BYTES = Gauge(
        "SeaweedFS_cache_used_bytes", "bytes currently held per cache",
        ["cache"], registry=REGISTRY)
    # distributed tracing (util/tracing.py): every finished span feeds
    # this, so the trace ring and Prometheus agree by construction.
    # tier: s3|webdav|filer|client|proxy|volume|store|ec|replicate
    REQUEST_DURATION = Histogram(
        "SeaweedFS_request_duration_seconds",
        "traced span duration per tier/op/status",
        ["tier", "op", "status"], registry=REGISTRY)
    METRICS_PUSH_ERRORS = Counter(
        "SeaweedFS_metrics_push_errors_total",
        "failed pushes to the configured metrics gateway",
        registry=REGISTRY)
    # background EC parity scrubber (ec/scrub.py)
    SCRUB_BYTES = Counter(
        "SeaweedFS_scrub_scanned_bytes_total",
        "shard bytes read by the EC parity scrubber",
        registry=REGISTRY)
    SCRUB_WINDOWS = Counter(
        "SeaweedFS_scrub_windows_total",
        "stripe windows scrubbed, by parity-check result",
        ["result"], registry=REGISTRY)
    SCRUB_CORRUPTIONS = Counter(
        "SeaweedFS_scrub_corruptions_total",
        "corrupt stripe windows detected by the scrubber",
        registry=REGISTRY)
    SCRUB_PAUSES = Counter(
        "SeaweedFS_scrub_pauses_total",
        "scrub pauses yielding to hot foreground traffic",
        registry=REGISTRY)
    SCRUB_CYCLES = Counter(
        "SeaweedFS_scrub_cycles_total",
        "completed whole-store scrub cycles",
        registry=REGISTRY)
    SCRUB_BATCHES = Counter(
        "SeaweedFS_scrub_batches_total",
        "stripe-window blocks scrubbed (one GF transform dispatch each)",
        registry=REGISTRY)
    # autopilot maintenance plane (autopilot/): the leader's
    # observe -> plan -> execute loop — cycles, per-kind action
    # outcomes, why actions were deferred, the paced repair bytes the
    # token bucket admitted, and whether repair is parked behind a
    # paging fleet
    AUTOPILOT_CYCLES = Counter(
        "SeaweedFS_autopilot_cycles_total",
        "completed observe->plan->execute maintenance cycles",
        registry=REGISTRY)
    AUTOPILOT_ACTIONS = Counter(
        "SeaweedFS_autopilot_actions_total",
        "maintenance actions by kind and outcome (ok/error/dryrun)",
        ["kind", "result"], registry=REGISTRY)
    AUTOPILOT_DEFERRALS = Counter(
        "SeaweedFS_autopilot_deferrals_total",
        "planned-but-not-executed actions, by deferral reason",
        ["reason"], registry=REGISTRY)
    AUTOPILOT_REPAIR_BYTES = Counter(
        "SeaweedFS_autopilot_repair_bytes_total",
        "estimated bytes admitted through the repair token bucket",
        registry=REGISTRY)
    AUTOPILOT_PAUSES = Counter(
        "SeaweedFS_autopilot_pauses_total",
        "times the executor parked because /debug/health paged",
        registry=REGISTRY)
    AUTOPILOT_QUEUE_DEPTH = Gauge(
        "SeaweedFS_autopilot_queue_depth",
        "actions waiting in the current cycle's plan queue",
        registry=REGISTRY)
    AUTOPILOT_PAUSED = Gauge(
        "SeaweedFS_autopilot_paused",
        "1 while repair is parked behind a paging fleet",
        registry=REGISTRY)
    # binary frame wire (util/frame.py): the frame fabric's request
    # volume and its HTTP downgrades — a rising fallback rate means
    # the frame path is being severed (chaos or a peer that predates
    # the protocol). hop is low-cardinality by construction:
    # sibling (intra-host worker hop) or interhost (the cluster fabric)
    FRAME_REQUESTS = Counter(
        "SeaweedFS_frame_requests_total",
        "frame-RPC requests, by side (client = issued, server = "
        "served) and hop (sibling = intra-host, interhost = fabric)",
        ["side", "hop"], registry=REGISTRY)
    FRAME_FALLBACKS = Counter(
        "SeaweedFS_frame_fallbacks_total",
        "frame requests downgraded to the HTTP hop (server-advised "
        "FLAG_FALLBACK answers + client-observed channel failures), "
        "by hop",
        ["hop"], registry=REGISTRY)
    FRAME_OPEN_CHANNELS = Gauge(
        "SeaweedFS_frame_open_channels",
        "currently-connected frame channels this process holds, per "
        "peer target (bounded by FrameHub.MAX_CHANNELS)",
        ["peer"], registry=REGISTRY)
    # build/restart detection (scrapes and timelines both need to tell
    # a counter reset apart from a rate dip): every daemon exports who
    # it is and when this process was born
    BUILD_INFO = Gauge(
        "SeaweedFS_build_info",
        "constant 1, labeled with the build version and python version",
        ["version", "pyver"], registry=REGISTRY)
    PROCESS_START_TIME = Gauge(
        "SeaweedFS_process_start_time_seconds",
        "unix time this process imported the metrics registry",
        registry=REGISTRY)
    # cluster-scope introspection (stats/introspect.py): every
    # fan-out hop the leader makes to assemble /debug/cluster/* views,
    # by result — a rising error/timeout share means some member's
    # debug plane is dark (result is a closed set: ok|error|timeout)
    INTROSPECT_FANOUT = Counter(
        "SeaweedFS_introspect_fanout_total",
        "per-node debug pulls issued by cluster-scope assembly, "
        "by result",
        ["result"], registry=REGISTRY)
    # continuous sampling profiler (stats/profiler.py): one count per
    # sampler tick, so `samples ≈ -profile.hz × uptime` is checkable
    # and the overhead accounting is deterministic
    PROFILE_SAMPLES = Counter(
        "SeaweedFS_profile_samples_total",
        "stack-sampler ticks taken by the continuous profiler",
        registry=REGISTRY)
    # structured event journal (util/events.py): one count per recorded
    # cluster state transition, so the ring and Prometheus agree
    EVENTS_TOTAL = Counter(
        "SeaweedFS_events_total",
        "cluster state transitions recorded in the event journal",
        ["type"], registry=REGISTRY)
    # saturation probes (stats/saturation.py), sampled into the
    # timeline ring so "slow" is attributable to a saturated resource
    EVENTLOOP_LAG = Gauge(
        "SeaweedFS_eventloop_lag_seconds",
        "max asyncio scheduling delay observed since the last sample",
        registry=REGISTRY)
    EXECUTOR_WAIT = Gauge(
        "SeaweedFS_executor_wait_seconds",
        "queue wait of a probe task submitted to the default executor",
        registry=REGISTRY)
    EXECUTOR_QUEUE_DEPTH = Gauge(
        "SeaweedFS_executor_queue_depth",
        "tasks waiting in the default executor work queue",
        registry=REGISTRY)
    OPEN_FDS = Gauge(
        "SeaweedFS_open_fds",
        "file descriptors currently open in this process",
        registry=REGISTRY)
    DISK_FREE_BYTES = Gauge(
        "SeaweedFS_disk_free_bytes",
        "free bytes on the filesystem holding a data dir",
        ["path"], registry=REGISTRY)
    DISK_USED_BYTES = Gauge(
        "SeaweedFS_disk_used_bytes",
        "used bytes on the filesystem holding a data dir",
        ["path"], registry=REGISTRY)
    CACHE_BUDGET_BYTES = Gauge(
        "SeaweedFS_cache_budget_bytes",
        "configured byte budget per read cache (occupancy vs budget)",
        ["cache"], registry=REGISTRY)
    # multi-tenant QoS (seaweedfs_tpu/qos/): admission decisions,
    # weighted-fair queue depths, per-tenant latency attribution, and
    # the background-bandwidth arbiter's grant accounting. Tenant
    # labels are BOUNDED (BoundedLabelSet below): configured tenants
    # always keep their own label, unconfigured identities fold into
    # `other` past the cap — an access-key scan cannot blow up the
    # registry, the timeline ring, or merge payloads
    QOS_DECISIONS = Counter(
        "SeaweedFS_qos_decisions_total",
        "admission decisions per tenant and outcome "
        "(admit/throttle/shed)",
        ["tenant", "decision"], registry=REGISTRY)
    QOS_QUEUE_DEPTH = Gauge(
        "SeaweedFS_qos_queue_depth",
        "requests parked in the weighted-fair admission queue, per "
        "tenant class",
        ["tenant"], registry=REGISTRY)
    QOS_TENANT_REQUEST_TIME = Histogram(
        "SeaweedFS_qos_tenant_request_seconds",
        "entry-tier request duration attributed to a tenant "
        "(per-tenant -slo objectives evaluate against this)",
        ["tier", "op", "tenant"], registry=REGISTRY)
    QOS_ARBITER_GRANTED = Counter(
        "SeaweedFS_qos_arbiter_granted_bytes_total",
        "background bytes admitted through the bandwidth arbiter, "
        "per consumer",
        ["kind"], registry=REGISTRY)
    QOS_ARBITER_YIELDS = Counter(
        "SeaweedFS_qos_arbiter_yields_total",
        "arbiter grants squeezed below base rate by foreground "
        "pressure, per consumer",
        ["kind"], registry=REGISTRY)
    QOS_ARBITER_RATE = Gauge(
        "SeaweedFS_qos_arbiter_rate_bytes_s",
        "currently-granted background rate per arbiter consumer",
        ["kind"], registry=REGISTRY)
    QOS_FOREGROUND_BPS = Gauge(
        "SeaweedFS_qos_foreground_bytes_s",
        "foreground byte rate observed by the bandwidth arbiter",
        registry=REGISTRY)
    # SLO burn-rate engine (stats/slo.py)
    SLO_STATUS = Gauge(
        "SeaweedFS_slo_status",
        "health verdict per objective: 0=ok 1=warn 2=page",
        ["objective"], registry=REGISTRY)
    SLO_BURN_RATE = Gauge(
        "SeaweedFS_slo_burn_rate",
        "error-budget burn rate per objective and evaluation window",
        ["objective", "window"], registry=REGISTRY)

    from .. import __version__
    BUILD_INFO.labels(__version__, platform.python_version()).set(1)
    PROCESS_START_TIME.set(time.time())

    def metrics_text() -> bytes:
        return generate_latest(REGISTRY)
else:  # pragma: no cover
    def metrics_text() -> bytes:
        return b"# prometheus_client unavailable\n"


class BoundedLabelSet:
    """Cardinality armor for identity-derived metric labels.

    The first `cap` distinct keys keep their own label value; every
    key after that maps to `"other"`. Seed keys (the configured
    tenants) are reserved up front and can never be displaced by a
    scan — a client hammering 10k random access keys costs at most
    `cap` label values in the registry, not 10k.

    Thread-free by design: admission runs on the event loop; the set
    only grows, so a racy double-add is harmless anyway."""

    OTHER = "other"

    __slots__ = ("cap", "_seen")

    def __init__(self, cap: int = 32, seed=()):
        self.cap = max(int(cap), 1)
        self._seen = set(seed)
        self._seen.add(self.OTHER)

    def get(self, key: str) -> str:
        if key in self._seen:
            return key
        if len(self._seen) < self.cap:
            self._seen.add(key)
            return key
        return self.OTHER

    def __len__(self) -> int:
        return len(self._seen)


# Gauges where summing across workers fabricates a value no process
# ever observed: every worker samples the SAME filesystem (sum doubles
# free/used space), scheduling-delay probes are per-loop latencies (the
# host's honest number is the WORST worker), build_info is a constant 1
# per process, and process_start_time is a unix timestamp (dashboards
# compute `time() - start`; max = the most recent birth, so ANY worker
# respawn moves it — exactly the restart signal the gauge exists for).
# The SLO verdict gauges are per-process VERDICTS, not quantities: two
# workers both at warn (1+1) must merge to warn=1, not page=2, and two
# sub-threshold burn rates must not sum past the page threshold — the
# host's honest health is the WORST worker's, i.e. max.
# Everything else — open fds, queue depth, cache bytes — is a genuinely
# per-process resource and sums like counters do. Shared by this
# /metrics merge and the /debug/timeline whole-host merge.
NON_ADDITIVE_GAUGE_PREFIXES = (
    "SeaweedFS_disk_",
    "SeaweedFS_eventloop_lag_seconds",
    "SeaweedFS_executor_wait_seconds",
    "SeaweedFS_build_info",
    "SeaweedFS_process_start_time_seconds",
    "SeaweedFS_slo_",
    # raft identity gauges (term / commit_index / is_leader): summing
    # across a merged host would report 2 leaders the moment any two
    # workers each said "1" — the host's honest answer is the max
    "SeaweedFS_raft_",
    # the adopted shard-map epoch is likewise an identity, not a
    # quantity — a merged host answers with the furthest-along worker
    "SeaweedFS_filer_shard_map_epoch",
)
_NON_ADDITIVE_B = tuple(p.encode() for p in NON_ADDITIVE_GAUGE_PREFIXES)


def merge_metrics_texts(texts: "list[bytes]") -> bytes:
    """Sum Prometheus text expositions from several worker processes
    into one whole-host view (server/workers.py: each -workers worker
    has its own registry; any worker answers /metrics for all).

    Counters, gauges, and histogram buckets are summed per
    (name, labels); `*_created` timestamps take the min (first birth);
    the non-additive gauges above take the max; HELP/TYPE comments are
    kept from their first appearance.

    Integral sums are emitted WITHOUT a trailing `.0` and never in
    exponent notation: `repr(float)` rendered a summed counter of 123
    as `123.0` and a large one as `1.2e+16`, both of which surprise
    text-format consumers that treat counters as integers."""
    order: list[tuple[str, bytes]] = []   # ("comment"|"sample", key)
    seen_comments: set[bytes] = set()
    sums: dict[bytes, float] = {}
    for text in texts:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith(b"#"):
                if line not in seen_comments:
                    seen_comments.add(line)
                    order.append(("comment", line))
                continue
            i = line.rfind(b" ")
            if i <= 0:
                continue
            key, raw = line[:i], line[i + 1:]
            try:
                val = float(raw)
            except ValueError:
                continue
            if key not in sums:
                order.append(("sample", key))
                sums[key] = val
            elif key.split(b"{", 1)[0].endswith(b"_created"):
                sums[key] = min(sums[key], val)
            elif key.startswith(_NON_ADDITIVE_B):
                sums[key] = max(sums[key], val)
            else:
                sums[key] += val
    out = []
    for kind, item in order:
        if kind == "comment":
            out.append(item)
        else:
            out.append(item + b" " + _fmt_value(sums[item]))
    return b"\n".join(out) + b"\n" if out else b""


def _fmt_value(val: float) -> bytes:
    """Prometheus text-format value: integral floats render as plain
    integers (no `.0`, no exponent — `int(float)` is exact for any
    float that is_integer()); fractional values keep full precision."""
    if val != val or val in (float("inf"), float("-inf")):
        return repr(val).encode()
    if float(val).is_integer():
        return b"%d" % int(val)
    return repr(val).encode()


async def push_loop(gateway: str, job: str,
                    interval_seconds: float = 15.0,
                    max_backoff_seconds: float = 300.0) -> None:
    """LoopPushingMetric (metrics.go:109-137).

    Failures are COUNTED (SeaweedFS_metrics_push_errors_total) and
    LOGGED — the first failure and every healthy<->failing transition
    at WARNING/INFO — while the push interval backs off exponentially
    so a long-dead gateway neither floods the log nor gets hammered."""
    from ..util import glog, tracing
    if not HAVE_PROMETHEUS or not gateway:
        return
    failing = False
    delay = interval_seconds
    while True:
        try:
            await tracing.run_in_executor(
                lambda: push_to_gateway(gateway, job=job,
                                        registry=REGISTRY))
            if failing:
                glog.info("metrics push to %s recovered (job=%s)",
                          gateway, job)
            failing = False
            delay = interval_seconds
        except Exception as e:  # noqa: BLE001 — the pusher must outlive
            # any gateway-side failure shape, but never silently
            METRICS_PUSH_ERRORS.inc()
            if not failing:
                glog.warning(
                    "metrics push to %s failed: %s %s (backing off; "
                    "logged once until recovery)", gateway,
                    type(e).__name__, e)
            failing = True
            delay = min(delay * 2, max_backoff_seconds)
        await asyncio.sleep(delay)
