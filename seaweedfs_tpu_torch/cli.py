"""`weed`-style CLI of the PyTorch port: the master, the volume server,
the admin shell and the offline volume tools.

    python -m seaweedfs_tpu_torch.cli master -port 9333 [-mdir D] \\
        [-peers H:P,...] [-workers N] [-volumeSizeLimitMB 30000] ...
    python -m seaweedfs_tpu_torch.cli volume -port 8080 -dir ./data \\
        -master 127.0.0.1:9333 [-ecBackend auto|gpu|cpu] [-workers N] ...
    python -m seaweedfs_tpu_torch.cli shell -master 127.0.0.1:9333 \\
        [-c 'ec.encode -collection x']
    python -m seaweedfs_tpu_torch.cli compact|fix|export -dir D -volumeId N
    python -m seaweedfs_tpu_torch.cli backup -dir D -volumeId N -server H:P

The port of seaweedfs_tpu/cli.py's `master`, `volume`, `shell`,
`backup`, `fix`, `export` and `compact` subcommands (their flags, the
runners and the process set-up of `main`, with the `-workers N`
supervisor and master.toml's maintenance scripts and sequencer). The
other subcommands are not ported yet. Start-up of one master or volume
server process is split out as `start_master(args)` and
`start_volume(args)`, coroutines that return the started server and its
flight recorder, so a program can drive the same entry points in process
(chip_smoke.py does).

`-ecBackend` picks the EC engine through SWTPU_TORCH_EC_BACKEND (not the
JAX package's SWTPU_EC_BACKEND): `gpu` is the CUDA kernel, `cpu` its
plain PyTorch version on the host, and `auto` means `gpu`. Without a
CUDA device `auto` and `gpu` fail at start-up; the server never serves
EC on the CPU unless `-ecBackend cpu` asks for it. Under `-workers N`
the supervisor re-executes this module once per worker; each worker
checks the flag at start-up and launches its kernels in a CUDA context
of its own.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from .security import tls
from .security.guard import parse_white_list
from .util import tracing


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master", default="127.0.0.1:9333",
                   help="master host:port")
    p.add_argument("-v", type=int, default=0, dest="verbosity",
                   help="glog verbose level (V(n) guards)")
    p.add_argument("-logdir", default="",
                   help="write per-severity rotated log files here")
    p.add_argument("-logtostderr", default=True,
                   type=lambda s: s.lower() not in ("false", "0", "no"),
                   help="also log to stderr (set false with -logdir for "
                        "file-only logging)")
    p.add_argument("-cpuprofile", default="",
                   help="write cProfile stats here on exit (under "
                        "-workers N each worker writes <path>.w<index> "
                        "so the dumps don't clobber each other)")
    p.add_argument("-memprofile", default="",
                   help="write tracemalloc top allocations here on exit "
                        "(suffixed .w<index> under -workers, like "
                        "-cpuprofile)")
    p.add_argument("-trace.sample", dest="trace_sample", type=float,
                   default=1.0,
                   help="distributed-tracing sample rate for requests "
                        "arriving WITHOUT a traceparent header (0 = "
                        "start no traces here)")
    p.add_argument("-trace.slowms", dest="trace_slowms", type=float,
                   default=0.0,
                   help="glog WARNING (with the trace id) for any entry "
                        "span slower than this many ms; 0 disables")
    p.add_argument("-trace.ring", dest="trace_ring", type=int,
                   default=2048,
                   help="finished spans kept in the per-process "
                        "/debug/traces ring buffer")
    p.add_argument("-profile.hz", dest="profile_hz", type=float,
                   default=0.0,
                   help="continuous sampling profiler rate in Hz "
                        "(stats/profiler.py): folds every thread's "
                        "stack into /debug/profile; 0 (default) disables "
                        "the always-on sampler — /debug/profile?seconds=N "
                        "still records on-demand windows")
    p.add_argument("-timeline.interval", dest="timeline_interval",
                   type=float, default=10.0,
                   help="metrics-timeline snapshot cadence in seconds "
                        "(/debug/timeline flight recorder); 0 disables "
                        "the recorder on this daemon")
    p.add_argument("-timeline.ring", dest="timeline_ring", type=int,
                   default=360,
                   help="timeline windows kept per process (default "
                        "360 = 1h of 10s windows)")
    p.add_argument("-slo", action="append", default=[],
                   help="declarative latency objective evaluated over "
                        "the timeline with fast/slow burn-rate windows "
                        "and served at /debug/health, e.g. "
                        "'volume.read:p99<50ms@99.9' (repeatable)")
    p.add_argument("-qos.tenant", dest="qos_tenant", action="append",
                   default=[],
                   help="tenant QoS class 'key:weight:rps[:burst]' "
                        "(repeatable); arms per-tenant admission and "
                        "/debug/qos")
    p.add_argument("-qos.shed.lagms", dest="qos_shed_lagms",
                   type=float, default=0.0,
                   help="arm priority load shedding when the sampled "
                        "event-loop lag crosses this many ms (0 disables)")
    p.add_argument("-qos.shed.waitms", dest="qos_shed_waitms",
                   type=float, default=0.0,
                   help="arm shedding on executor queue wait above "
                        "this many ms (same ladder as -qos.shed.lagms)")
    p.add_argument("-qos.mbps", dest="qos_mbps", type=float,
                   default=0.0,
                   help="cluster foreground byte budget in MiB/s for "
                        "the bandwidth arbiter (0 disables arbitration)")
    p.add_argument("-qos.floor", dest="qos_floor", type=float,
                   default=0.25,
                   help="starvation-proof fraction of a background "
                        "consumer's base rate the arbiter always grants")


def _add_workers(p: argparse.ArgumentParser) -> None:
    p.add_argument("-workers", type=int, default=1,
                   help="process-per-core data plane: N worker "
                        "processes share the port via SO_REUSEPORT, "
                        "ownership partitioned vid %% N")
    # internal: set by the supervisor when re-executing itself as a
    # worker; never passed by operators
    p.add_argument("-workerIndex", type=int, default=-1,
                   help=argparse.SUPPRESS)
    p.add_argument("-workerStateDir", default="",
                   help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="weed-torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("master", help="start a master server")
    _add_common(m)
    _add_workers(m)
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=30_000)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-pulseSeconds", type=float, default=5.0)
    m.add_argument("-jwtKey", default="")
    m.add_argument("-peers", default="",
                   help="comma-separated peer masters host:port "
                        "(enables the raft quorum: leader election, "
                        "replicated fid/volume-id allocation, follower "
                        "307-redirect-to-leader)")
    m.add_argument("-raft.timeout", dest="raft_timeout",
                   default="1.0,2.0",
                   help="election timeout range seconds 'min,max' "
                        "(randomized per follower; failover completes "
                        "within ~2 timeouts of a leader death)")
    m.add_argument("-raft.pulse", dest="raft_pulse", type=float,
                   default=0.3,
                   help="leader AppendEntries heartbeat cadence "
                        "seconds (the lease window derives from the "
                        "election timeout, not this)")
    m.add_argument("-metricsGateway", default="",
                   help="prometheus push-gateway host:port")
    m.add_argument("-sequencer", default=None,
                   help="file-id allocator: memory | file:<path> | "
                        "etcd:<host:port> (default: master.toml "
                        "[master.sequencer], else memory)")
    m.add_argument("-mdir", default="",
                   help="master metadata dir (persists election "
                        "term/vote across restarts)")
    m.add_argument("-garbageThreshold", type=float, default=0.3,
                   help="auto-vacuum when a volume's garbage ratio "
                        "exceeds this")
    m.add_argument("-maintenanceIntervalS", type=float, default=900.0,
                   help="auto-vacuum cadence seconds; 0 disables")
    m.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs allowed to use the "
                        "API; empty = no limit (guard.go). Heartbeating "
                        "volume servers are auto-admitted; with -peers, "
                        "follower control routes 307-redirect so the "
                        "CLIENT IP is judged on the leader — only "
                        "/submit still proxies from peer master IPs")
    m.add_argument("-volumePreallocate", action="store_true",
                   help="preallocate disk space for grown volumes")
    m.add_argument("-autopilot.interval", dest="autopilot_interval",
                   type=float, default=0.0,
                   help="autopilot maintenance-plane cycle cadence "
                        "seconds (leader-only observe->plan->execute: "
                        "auto-rebuild lost/rotten EC shards, "
                        "re-replicate, vacuum, cold-tier); 0 disables "
                        "the loop (POST /debug/autopilot?run=1 still "
                        "forces one cycle)")
    m.add_argument("-autopilot.mbps", dest="autopilot_mbps",
                   type=float, default=16.0,
                   help="cluster-wide repair-bandwidth token bucket "
                        "(MB/s of estimated repair bytes); <=0 "
                        "unpaced")
    m.add_argument("-autopilot.dryrun", dest="autopilot_dryrun",
                   action="store_true",
                   help="plan, journal and report the exact action "
                        "ledger live mode would execute — but execute "
                        "nothing")
    m.add_argument("-autopilot.concurrency",
                   dest="autopilot_concurrency", type=int, default=2,
                   help="maintenance actions in flight at once")
    m.add_argument("-autopilot.tier", dest="autopilot_tier",
                   default="",
                   help="tier backend id (e.g. s3.default) for "
                        "tier_seal actions: sealed still-local "
                        "volumes are shipped to it; empty disables "
                        "cold-tiering actions")
    m.add_argument("-introspect.deadline", dest="introspect_deadline",
                   type=float, default=3.0,
                   help="per-node deadline seconds for the "
                        "/debug/cluster/* fan-out: a member that "
                        "doesn't answer within it degrades to a "
                        "missing_node row instead of stalling the "
                        "assembled view")

    v = sub.add_parser("volume", help="start a volume server")
    _add_common(v)
    _add_workers(v)
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default="./data", help="comma-separated dirs")
    v.add_argument("-max", default="8", help="comma-separated max volumes")
    v.add_argument("-dataCenter", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-pulseSeconds", type=float, default=5.0)
    v.add_argument("-compactionMBps", type=int, default=0,
                   help="vacuum copy rate limit, MB/s (0 = unthrottled)")
    v.add_argument("-index", default="auto",
                   choices=["auto", "memory", "compact", "disk"],
                   help="needle map kind (disk = sqlite-backed, "
                        "near-zero RAM)")
    v.add_argument("-jwtKey", default="")
    v.add_argument("-tierS3Endpoint", default="",
                   help="S3-compatible endpoint for volume.tier.upload "
                        "(configures backend id s3.default)")
    v.add_argument("-tierS3Bucket", default="volume-tier")
    v.add_argument("-tierMmapDir", default="",
                   help="directory for volume.tier.upload -backend "
                        "mmap.default")
    v.add_argument("-ecBackend", default="auto",
                   choices=("auto", "gpu", "cpu"),
                   help="erasure-coding engine: gpu = the CUDA kernel, "
                        "cpu = its plain PyTorch version on the host, "
                        "auto = gpu (fails without a CUDA device)")
    v.add_argument("-publicUrl", default="",
                   help="publicly accessible address advertised to "
                        "clients (host:port)")
    v.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs with needle-write "
                        "permission; empty = no limit")
    v.add_argument("-cache.mem", dest="cache_mem", type=int, default=32,
                   help="total MB for volume-side read caches, split "
                        "3/4 hot-needle + 1/4 EC reconstruction; 0 "
                        "disables all volume-side read caching")
    v.add_argument("-batch.max", dest="batch_max", type=int, default=256,
                   help="most fids one /batch multi-needle GET may carry")
    v.add_argument("-groupcommit.ms", dest="groupcommit_ms", type=float,
                   default=0.0,
                   help="extra window the group-commit leader lingers "
                        "to deepen write batches; 0 = natural batching")
    v.add_argument("-fsync", action="store_true",
                   help="fsync every group-committed append before "
                        "acking writers")
    v.add_argument("-scrub.interval", dest="scrub_interval", type=float,
                   default=0.0,
                   help="seconds between background EC parity-scrub "
                        "cycles; 0 disables the paced scrubber "
                        "(POST /debug/scrub?run=1 still forces one)")
    v.add_argument("-scrub.mbps", dest="scrub_mbps", type=float,
                   default=8.0,
                   help="token-bucket byte budget for scrub reads, "
                        "MiB/s; 0 = unpaced")
    v.add_argument("-scrub.pausems", dest="scrub_pause_ms", type=float,
                   default=50.0,
                   help="park the scrubber while any foreground "
                        "request in the last 2s ran longer than this "
                        "many ms; 0 never pauses")
    v.add_argument("-scrub.batch", dest="scrub_batch", type=int,
                   default=None,
                   help="stripe windows verified per scrub GF-transform "
                        "dispatch (default 8, the stripe-batch engine's "
                        "width)")
    v.add_argument("-ec.smallrecover", dest="ec_smallrecover", type=int,
                   default=1 << 20,
                   help="EC recover transforms smaller than this many "
                        "bytes run on the host CPU encoder instead of "
                        "the device")

    bk = sub.add_parser("backup", help="incrementally back up one volume "
                                       "from a volume server to a local dir")
    bk.add_argument("-dir", default=".")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.add_argument("-collection", default="")
    bk.add_argument("-server", required=True,
                    help="source volume server host:port")

    fx = sub.add_parser("fix", help="rebuild .idx by scanning .dat")
    fx.add_argument("-dir", default=".")
    fx.add_argument("-volumeId", type=int, required=True)
    fx.add_argument("-collection", default="")

    ex = sub.add_parser("export", help="list/dump needles in a volume")
    ex.add_argument("-dir", default=".")
    ex.add_argument("-volumeId", type=int, required=True)
    ex.add_argument("-collection", default="")
    ex.add_argument("-o", dest="output", default="",
                    help="write file contents to this .tar instead of "
                         "printing the JSON listing")
    ex.add_argument("-fileNameFormat", default="{name}",
                    help="tar member naming: {name} {id} {mime}")
    ex.add_argument("-newer", default="",
                    help="only needles modified after this "
                         "YYYY-MM-DDThh:mm:ss")
    ex.add_argument("-pattern", default="",
                    help="only file names matching this glob")
    ex.add_argument("-limit", type=int, default=0,
                    help="stop after this many entries (0 = all)")

    co = sub.add_parser("compact", help="offline-compact one volume")
    co.add_argument("-dir", default=".")
    co.add_argument("-volumeId", type=int, required=True)
    co.add_argument("-collection", default="")

    sh = sub.add_parser("shell", help="admin shell (interactive or -c)")
    _add_common(sh)
    sh.add_argument("-c", dest="command", default="",
                    help="run one command and exit, e.g. 'ec.encode "
                         "-collection x'")
    return ap


def _find_config_toml(name: str) -> tuple[str, dict] | None:
    """viper-style discovery of <name>.toml in ./, ~/.seaweedfs,
    /etc/seaweedfs (util/config.go:28-45); returns (path, parsed)."""
    from .util.toml import tomllib
    if tomllib is None:
        return None
    for d in (".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs"):
        path = os.path.join(d, f"{name}.toml")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    return path, tomllib.load(f)
            except tomllib.TOMLDecodeError as e:
                raise SystemExit(f"{path}: {e}")
    return None


def _discover_security_toml() -> None:
    """Discovered security.toml enables mTLS when [tls] is configured
    (util/config.go:28-45 search order)."""
    found = _find_config_toml("security")
    if found is not None:
        from .util import glog
        if tls.configure_from_toml(found[0], found[1]):
            glog.info("mTLS enabled from %s", found[0])


def init_daemon(args) -> None:
    """The process-wide set-up of seaweedfs_tpu/cli.py's main for a
    daemon: logging, tracing, the timeline and its SLO objectives, QoS,
    the respawn event of a worker, the profilers, armed failpoints."""
    from .util import glog
    glog.init(verbosity=args.verbosity, log_dir=args.logdir or None,
              logtostderr=args.logtostderr)
    tracing.init(sample=args.trace_sample, slow_ms=args.trace_slowms,
                 ring=args.trace_ring)
    from .stats import slo, timeline
    timeline.init(interval_s=args.timeline_interval,
                  ring=args.timeline_ring)
    try:
        slo.init(args.slo)
    except ValueError as e:
        # refuse to start guarding nothing: a typo'd objective silently
        # ignored would "pass" every soak
        raise SystemExit(str(e))
    from . import qos
    try:
        if args.qos_tenant:
            qos.init_admission(args.qos_tenant,
                               lag_shed_ms=args.qos_shed_lagms,
                               wait_shed_ms=args.qos_shed_waitms)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.qos_mbps > 0:
        qos.init_arbiter(args.qos_mbps, floor=args.qos_floor)
    if args.slo and not timeline.enabled():
        # with the recorder off no window is ever snapped, slo.tick()
        # never runs, and /debug/health would report ok forever
        raise SystemExit(
            "-slo needs the flight recorder: -timeline.interval 0 "
            "disables the timeline the burn engine evaluates")
    if args.slo:
        # the ring must hold the slow burn horizon
        needed = slo.windows_needed(minimum=0)
        if needed > args.timeline_ring:
            glog.info("-timeline.ring %d too small for the %ds SLO slow "
                      "window at interval %gs; using %d",
                      args.timeline_ring, int(slo.SLOW_WINDOW_S),
                      args.timeline_interval, needed)
            timeline.init(interval_s=args.timeline_interval, ring=needed)
    if os.environ.get("WEED_WORKER_RESPAWNS"):
        # set by the -workers supervisor on every respawn; the supervisor
        # serves no HTTP, so the respawned worker journals the event
        from .util import events
        try:
            n_respawns = int(os.environ["WEED_WORKER_RESPAWNS"])
        except ValueError:
            n_respawns = -1
        events.record("worker_respawn",
                      index=getattr(args, "workerIndex", -1),
                      respawns=n_respawns)
    if args.cpuprofile or args.memprofile:
        from .util.pprof import setup_profiling
        # -workers N: each worker suffixes the dump path with its index
        setup_profiling(args.cpuprofile, args.memprofile,
                        worker_index=getattr(args, "workerIndex", -1))
    if args.profile_hz:
        from .stats import profiler
        profiler.init(args.profile_hz)
        profiler.start()
    if os.environ.get("WEED_FAILPOINTS"):
        from .util import failpoints
        glog.warning("FAILPOINTS ARMED: %s",
                     ", ".join(f"{a['site']}={a['action']}"
                               for a in failpoints.list_armed()))


def _check_ec_backend(backend: str) -> None:
    """Pin the EC engine for this process and build it once now, so a
    missing CUDA device fails start-up instead of the first EC request.
    The flag is authoritative: an explicit `-ecBackend auto` clears an
    inherited pin from the parent environment."""
    from .ec import pipeline as ecpl
    os.environ[ecpl.BACKEND_ENV] = backend
    try:
        ecpl.get_encoder(backend)
    except RuntimeError as e:
        raise SystemExit(f"-ecBackend {backend}: {e}")


async def _serve_until_interrupt(*servers) -> None:
    """Run until SIGINT/SIGTERM/SIGHUP, then stop servers in order; the
    normal return lets atexit fire, which dumps -cpuprofile/-memprofile
    output (util/pprof.py)."""
    from .util import glog
    from .util.signals import wait_for_interrupt
    num = await wait_for_interrupt()
    glog.V(1).infof("signal %s: shutting down %d server(s)",
                    num, len(servers))
    for srv in servers:
        try:
            await srv.stop()
        except Exception as e:  # noqa: BLE001 — best-effort drain
            glog.warning("shutdown of %s: %s", type(srv).__name__, e)


def _worker_state_dir(args, kind: str) -> str:
    if args.workerStateDir:
        return args.workerStateDir
    if kind == "volume":
        return os.path.join(args.dir.split(",")[0], ".workers")
    return os.path.join(args.mdir or ".", ".workers")


async def _run_worker_supervisor(args, kind: str) -> None:
    """Parent of `master|volume -workers N`: mint the launch token,
    spawn the worker processes (this module's command line +
    -workerIndex i), restart crashed ones. No socket and no CUDA context
    live here — see server/workers.py."""
    import secrets
    from .server.workers import (Supervisor, WORKER_TOKEN_ENV,
                                 fresh_state_dir)
    if args.port == 0:
        raise SystemExit(f"{kind} -workers needs an explicit -port "
                         f"(the workers share it via SO_REUSEPORT)")
    state_dir = await tracing.run_in_executor(
        fresh_state_dir, _worker_state_dir(args, kind))
    env = dict(os.environ)
    env[WORKER_TOKEN_ENV] = env.get(WORKER_TOKEN_ENV) \
        or secrets.token_hex(16)
    env[WORKER_PARENT_ENV] = str(os.getpid())
    raw = list(getattr(args, "_raw_argv", None) or sys.argv[1:])

    def build_argv(index: int) -> list[str]:
        return ([sys.executable, "-m", "seaweedfs_tpu_torch.cli"] + raw
                + ["-workerIndex", str(index),
                   "-workerStateDir", state_dir])

    sup = Supervisor(build_argv, args.workers, env=env)
    await sup.start()
    print(f"{kind} supervisor: {args.workers} workers sharing port "
          f"{args.port} (state: {state_dir})", flush=True)
    from .util.signals import wait_for_interrupt
    await wait_for_interrupt()
    await sup.stop()


_BACKGROUND_TASKS: set = set()  # strong refs: loop tasks are weakly held

# the supervisor's pid, which it hands its workers: a worker orphaned
# while it was still starting (before it could read its parent) exits too
WORKER_PARENT_ENV = "SWTPU_WORKER_PARENT"


def _watch_parent() -> None:
    """Workers exit when the supervisor disappears (reparented to
    init), so a SIGKILLed supervisor never leaks port-holding
    orphans."""
    ppid = int(os.environ.get(WORKER_PARENT_ENV) or os.getppid())

    async def watch() -> None:
        while os.getppid() == ppid:
            await asyncio.sleep(1.0)
        os._exit(0)

    task = asyncio.get_running_loop().create_task(watch())
    _BACKGROUND_TASKS.add(task)
    task.add_done_callback(_BACKGROUND_TASKS.discard)


def _make_worker_ctx(args, kind: str):
    from .server.workers import WorkerContext
    return WorkerContext(args.workerIndex, args.workers, args.port,
                         _worker_state_dir(args, kind))


def _load_master_toml() -> dict:
    """Discovered master.toml: [master.maintenance] scripts +
    sleep_minutes and [master.sequencer] type (scaffold.go:337-371
    semantics)."""
    found = _find_config_toml("master")
    if found is None:
        return {}
    path, cfg = found
    out = {}
    maint = cfg.get("master", {}).get("maintenance", {})
    if maint.get("scripts"):
        out["admin_scripts"] = [
            ln.strip() for ln in maint["scripts"].splitlines()
            if ln.strip() and not ln.strip().startswith("#")]
    if "sleep_minutes" in maint:
        out["admin_scripts_interval_s"] = \
            float(maint["sleep_minutes"]) * 60
    seq = cfg.get("master", {}).get("sequencer", {})
    if seq.get("type") and seq["type"] != "memory":
        val = seq["type"]
        out["sequencer"] = (val if ":" in val
                            else f"{val}:{seq.get('path', '')}")
    from .util import glog
    glog.info("master config loaded from %s", path)
    return out


async def start_master(args):
    """Start the master process of parsed `master` arguments (the
    primary of a -workers fleet when -workerIndex is 0); returns
    (server, recorder handle or None). The caller stops the server and
    cancels the recorder."""
    from .master.server import MasterServer
    from .stats import introspect, timeline
    worker_ctx = None
    if args.workerIndex == 0:
        _watch_parent()
        worker_ctx = _make_worker_ctx(args, "master")
    introspect.init(args.introspect_deadline)
    toml_cfg = await tracing.run_in_executor(_load_master_toml)
    try:
        lo, _, hi = args.raft_timeout.partition(",")
        election_timeout = (float(lo), float(hi or lo))
    except ValueError:
        raise SystemExit(f"-raft.timeout {args.raft_timeout!r}: "
                         f"want 'min,max' seconds") from None
    # ctor makedirs -mdir; keep daemon construction off the loop —
    # under -workers respawn this loop is already serving
    m = await tracing.run_in_executor(lambda: MasterServer(
        ip=args.ip, port=args.port,
        volume_size_limit_mb=args.volumeSizeLimitMB,
        default_replication=args.defaultReplication,
        pulse_seconds=args.pulseSeconds, jwt_key=args.jwtKey,
        peers=[p.strip() for p in args.peers.split(",")
               if p.strip()],
        election_timeout=election_timeout,
        election_pulse=args.raft_pulse,
        # explicit CLI flag beats discovered config (None = flag not
        # given, so even an explicit `-sequencer memory` overrides a
        # master.toml sequencer)
        sequencer=(args.sequencer if args.sequencer is not None
                   else toml_cfg.get("sequencer", "memory")),
        meta_dir=args.mdir,
        garbage_threshold=args.garbageThreshold,
        maintenance_interval_s=args.maintenanceIntervalS,
        admin_scripts=toml_cfg.get("admin_scripts"),
        admin_scripts_interval_s=toml_cfg.get(
            "admin_scripts_interval_s", 17 * 60.0),
        white_list=parse_white_list(args.whiteList),
        volume_preallocate=args.volumePreallocate,
        autopilot_interval_s=args.autopilot_interval,
        autopilot_mbps=args.autopilot_mbps,
        autopilot_dryrun=args.autopilot_dryrun,
        autopilot_concurrency=args.autopilot_concurrency,
        autopilot_tier_backend=args.autopilot_tier,
        worker_ctx=worker_ctx))
    await m.start()
    return m, timeline.start_recorder()


async def _run_master(args) -> None:
    if args.workers > 1 and args.workerIndex < 0:
        await _run_worker_supervisor(args, "master")
        return
    if args.workerIndex > 0:
        # assign accelerator: shares the port, leases ids, proxies cold
        from .server.workers import AssignAccelerator
        from .stats import timeline
        _watch_parent()
        acc = AssignAccelerator(
            args.ip, args.port, _make_worker_ctx(args, "master"),
            white_list=parse_white_list(args.whiteList),
            jwt_key=args.jwtKey,
            default_replication=args.defaultReplication)
        await acc.start()
        rec = timeline.start_recorder()
        print(f"master assign worker {args.workerIndex} on {acc.url}",
              flush=True)
        try:
            await _serve_until_interrupt(acc)
        finally:
            if rec is not None:
                rec.cancel()
        return
    m, rec = await start_master(args)
    push_task = None
    if args.metricsGateway:
        from .stats.metrics import push_loop
        push_task = asyncio.create_task(
            push_loop(args.metricsGateway, "master"))
    print(f"master listening on {m.url}", flush=True)
    try:
        await _serve_until_interrupt(m)
    finally:
        if push_task is not None:
            push_task.cancel()
        if rec is not None:
            rec.cancel()


async def start_volume(args):
    """Start one volume server process from parsed `volume` arguments
    (a worker of the supervisor when -workerIndex is set); returns
    (server, recorder handle or None). The caller stops the server and
    cancels the recorder."""
    from .server.volume_server import VolumeServer
    from .storage.store import Store
    _check_ec_backend(args.ecBackend)
    worker_ctx = None
    if args.workerIndex >= 0:
        _watch_parent()
        worker_ctx = _make_worker_ctx(args, "volume")
    dirs = args.dir.split(",")
    maxes = [int(x) for x in args.max.split(",")]
    if len(maxes) == 1:
        maxes = maxes * len(dirs)
    tier_cfg = {}
    if args.tierS3Endpoint:
        tier_cfg["s3"] = {"default": {"endpoint": args.tierS3Endpoint,
                                      "bucket": args.tierS3Bucket}}
    if args.tierMmapDir:
        tier_cfg["mmap"] = {"default": {"dir": args.tierMmapDir}}
    if tier_cfg:
        from .storage.backend import load_backends
        load_backends(tier_cfg)
    # Store's ctor makedirs + scans every volume file: off the loop
    store = await tracing.run_in_executor(lambda: Store(
        dirs, max_volume_counts=maxes,
        compaction_bytes_per_second=args.compactionMBps * 1024 * 1024,
        index_type=args.index,
        partition=(None if worker_ctx is None else
                   (worker_ctx.index, worker_ctx.total)),
        needle_cache_bytes=args.cache_mem * 1024 * 1024,
        group_commit_window=args.groupcommit_ms / 1000.0,
        fsync=args.fsync,
        ec_small_recover_bytes=args.ec_smallrecover))
    vs = VolumeServer(store, args.master, ip=args.ip, port=args.port,
                      data_center=args.dataCenter, rack=args.rack,
                      pulse_seconds=args.pulseSeconds, jwt_key=args.jwtKey,
                      white_list=parse_white_list(args.whiteList),
                      public_url=args.publicUrl,
                      worker_ctx=worker_ctx,
                      batch_max=args.batch_max,
                      scrub_mbps=args.scrub_mbps,
                      scrub_interval=args.scrub_interval,
                      scrub_pause_ms=args.scrub_pause_ms,
                      scrub_batch=args.scrub_batch)
    await vs.start()
    from .stats import timeline
    rec = timeline.start_recorder(disk_paths=dirs)
    return vs, rec


async def _run_volume(args) -> None:
    if args.workers > 1 and args.workerIndex < 0:
        await _run_worker_supervisor(args, "volume")
        return
    vs, rec = await start_volume(args)
    dirs = args.dir.split(",")
    ctx = vs.worker_ctx
    if ctx is not None:
        print(f"volume worker {ctx.index}/{ctx.total}: public "
              f"{args.ip}:{ctx.public_port}, private {vs.url}, "
              f"dirs={dirs}", flush=True)
    else:
        print(f"volume server listening on {vs.url}, dirs={dirs}",
              flush=True)
    try:
        await _serve_until_interrupt(vs)
    finally:
        if rec is not None:
            rec.cancel()


async def _run_shell(args) -> None:
    from .shell.env import CommandEnv
    from .shell.runner import dispatch, run_command, HELP
    if args.command:
        await run_command(args.master, args.command)
        return
    print("seaweedfs_tpu_torch shell; 'help' for commands, 'exit' to quit")
    # one env for the whole session so fs.cd working-directory state
    # carries across commands (shell_liner.go keeps one CommandEnv)
    async with CommandEnv(args.master) as env:
        while True:
            try:
                line = await tracing.run_in_executor(input, "> ")
            except (EOFError, KeyboardInterrupt):
                break
            line = line.strip()
            if line in ("exit", "quit"):
                break
            if line == "help":
                print(HELP)
                continue
            if line:
                try:
                    res = await dispatch(env, line)
                    if res is not None:
                        print(json.dumps(res, indent=2, default=str))
                except Exception as e:
                    print(f"error: {e}")


async def _run_backup(args) -> None:
    """Incremental volume backup (command/backup.go): pull the tail of a
    remote volume newer than the local copy; falls back to a full fetch
    when compaction revisions diverge or local is ahead."""
    import aiohttp

    from .storage import volume_backup as vb
    from .storage.volume import Volume

    async with tls.make_session(
            timeout=aiohttp.ClientTimeout(total=300)) as http:
        async with http.get(
                tls.url(args.server, "/admin/volume/status"),
                params={"volume": str(args.volumeId)}) as resp:
            if resp.status != 200:
                print(f"volume {args.volumeId} not found on {args.server}")
                sys.exit(1)
            st = await resp.json()
        from .storage import types as t
        from .storage.super_block import ReplicaPlacement
        collection = args.collection or st.get("collection", "")
        # Volume's ctor replays .idx/.dat metadata from disk
        v = await tracing.run_in_executor(lambda: Volume(
            args.dir, collection, args.volumeId,
            replica_placement=ReplicaPlacement.parse(
                st.get("replication", "000")),
            ttl=t.TTL.parse(st.get("ttl", ""))))
        need_full = (
            v.super_block.compaction_revision
            != st["compaction_revision"]
            or v.last_append_at_ns > st["last_append_at_ns"])
        if need_full:
            base = v.file_name()
            v.close()
            # .idx before .dat: a racing write then at most leaves extra
            # .dat tail past the last copied idx entry, which the
            # open-time integrity check truncates. Download to .tmp and
            # swap both only on success.
            tmps: list[tuple[str, str]] = []
            try:
                for ext in (".idx", ".dat"):
                    tmp = base + ext + ".tmp"
                    async with http.get(
                            tls.url(args.server, "/admin/file"),
                            params={"volume": str(args.volumeId),
                                    "collection": collection,
                                    "ext": ext}) as resp:
                        if resp.status != 200:
                            raise RuntimeError(
                                f"fetch {ext}: http {resp.status}")
                        f = await tracing.run_in_executor(
                            open, tmp, "wb")
                        try:
                            async for chunk in \
                                    resp.content.iter_chunked(1 << 20):
                                await tracing.run_in_executor(
                                    f.write, chunk)
                        finally:
                            await tracing.run_in_executor(f.close)
                    tmps.append((tmp, base + ext))
            except (RuntimeError, aiohttp.ClientError, OSError) as e:
                for tmp, _ in tmps:
                    if os.path.exists(tmp):
                        await tracing.run_in_executor(os.remove, tmp)
                print(f"full copy failed: {e}")
                sys.exit(1)
            # swap .dat before .idx: a crash in between leaves old .idx +
            # new (superset) .dat, which the open-time check truncates
            for tmp, final in reversed(tmps):
                await tracing.run_in_executor(os.replace, tmp, final)
            v = await tracing.run_in_executor(lambda: Volume(
                args.dir, collection, args.volumeId,
                create_if_missing=False))
            size = await tracing.run_in_executor(v.data_size)
            print(f"full copy of volume {args.volumeId}: "
                  f"{size} bytes")
        else:
            since = v.last_append_at_ns
            applied = 0
            dec = vb.FrameDecoder()
            async with http.get(
                    tls.url(args.server, "/admin/volume/tail"),
                    params={"volume": str(args.volumeId),
                            "since_ns": str(since)}) as resp:
                if resp.status != 200:
                    print(f"tail from {args.server}: http {resp.status}")
                    sys.exit(1)

                def _apply_batch(records):
                    for n, is_delete in records:
                        vb.apply_needle(v, n, is_delete)

                async for chunk in resp.content.iter_chunked(1 << 20):
                    batch = list(dec.feed(chunk))
                    if batch:
                        # one executor hop per decoded chunk, not per
                        # record
                        await tracing.run_in_executor(_apply_batch, batch)
                        applied += len(batch)
            print(f"applied {applied} records to volume {args.volumeId} "
                  f"(since_ns={since})")
        v.close()


def _run_fix(args) -> None:
    """Rebuild .idx by scanning .dat (command/fix.go)."""
    from .storage import types as t
    from .storage.needle_map import pack_entry
    from .storage.volume import Volume
    v = Volume(args.dir, args.collection, args.volumeId,
               create_if_missing=False)
    entries: dict[int, tuple[int, int]] = {}

    def visit(n, offset):
        if n.size > 0 or n.data:
            entries[n.id] = (offset, n.size)
        else:
            entries[n.id] = (0, t.TOMBSTONE_FILE_SIZE)
    v.scan(visit)
    idx_path = v.file_name() + ".idx"
    with open(idx_path, "wb") as f:
        for key, (off, size) in entries.items():
            f.write(pack_entry(key, off, size))
    print(f"rebuilt {idx_path} with {len(entries)} entries")
    v.close()


def _run_export(args) -> None:
    """List needles as JSON lines, or -o out.tar to dump contents
    (command/export.go: -o tar, -fileNameFormat, -newer)."""
    import fnmatch
    import io
    import tarfile

    from .storage import types as t
    from .storage.volume import Volume
    v = Volume(args.dir, args.collection, args.volumeId,
               create_if_missing=False)
    newer_ts = 0.0
    if args.newer:
        newer_ts = time.mktime(
            time.strptime(args.newer, "%Y-%m-%dT%H:%M:%S"))
    tar = tarfile.open(args.output, "w") if args.output else None
    exported = 0

    class _LimitReached(Exception):
        pass

    def want(n) -> bool:
        name = n.name.decode(errors="replace")
        if args.pattern and not fnmatch.fnmatch(name, args.pattern):
            return False
        if newer_ts and getattr(n, "last_modified", 0) < newer_ts:
            return False
        return True

    def _is_live(n, offset) -> bool:
        # a scanned record is live only if the needle map still points at
        # THIS offset (overwritten/deleted data must not be resurrected)
        nv = v.nm.get(n.id)
        return (nv is not None and nv.offset == offset
                and nv.size != t.TOMBSTONE_FILE_SIZE)

    def visit(n, offset):
        nonlocal exported
        if args.limit > 0 and exported >= args.limit:
            raise _LimitReached
        kind = "tombstone" if n.size == 0 and not n.data else "needle"
        if tar is None:
            # listing mode keeps every historical record (incl.
            # tombstones): it is the audit view of the raw .dat
            if kind == "needle" and not want(n):
                return
            print(json.dumps({
                "key": n.id, "cookie": n.cookie, "size": n.size,
                "offset": offset, "name": n.name.decode(errors="replace"),
                "mime": n.mime.decode(errors="replace"), "type": kind,
                "live": kind == "needle" and _is_live(n, offset)}))
            exported += 1
            return
        if kind == "tombstone" or not want(n) or not _is_live(n, offset):
            return
        exported += 1
        member = args.fileNameFormat.format(
            name=n.name.decode(errors="replace") or f"{n.id:x}",
            id=f"{n.id:x}", mime=n.mime.decode(errors="replace"))
        info = tarfile.TarInfo(member)
        info.size = len(n.data)
        info.mtime = int(getattr(n, "last_modified", 0) or 0)
        tar.addfile(info, io.BytesIO(bytes(n.data)))

    try:
        v.scan(visit)
    except _LimitReached:
        pass
    v.close()
    if tar is not None:
        tar.close()
        print(f"exported {exported} files to {args.output}")


def _run_compact(args) -> None:
    from .storage import vacuum
    from .storage.volume import Volume
    v = Volume(args.dir, args.collection, args.volumeId,
               create_if_missing=False)
    before = v.data_size()
    vacuum.compact(v)
    vacuum.commit_compact(v)
    print(f"compacted volume {args.volumeId}: {before} -> {v.data_size()} "
          f"bytes")
    v.close()


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    # the worker supervisor re-executes this same command line with
    # -workerIndex appended; remember it when given programmatically
    args._raw_argv = list(argv) if argv is not None else None
    # SWTPU_OFFSET_BYTES=5: the 5-byte offset build tag as a runtime
    # switch, set before any volume or index file is opened
    env_off = os.environ.get("SWTPU_OFFSET_BYTES")
    if env_off:
        from .storage import types as _types
        _types.set_offset_size(int(env_off))
    if args.cmd in ("master", "volume", "shell"):
        init_daemon(args)
    _discover_security_toml()
    offline = {"fix": _run_fix, "export": _run_export,
               "compact": _run_compact}
    if args.cmd in offline:
        offline[args.cmd](args)
        return
    runners = {"master": _run_master, "volume": _run_volume,
               "shell": _run_shell, "backup": _run_backup}
    try:
        asyncio.run(runners[args.cmd](args))
    except KeyboardInterrupt:
        pass
    except BrokenPipeError:
        os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
