"""`weed`-style CLI of the PyTorch port: the `volume` subcommand.

    python -m seaweedfs_tpu_torch.cli volume -port 8080 -dir ./data \\
        -master 127.0.0.1:9333 [-ecBackend auto|gpu|cpu] ...

The port of seaweedfs_tpu/cli.py's `volume` subcommand (its flags,
`_run_volume` and the daemon set-up of `main`). The other subcommands
are not ported yet. Start-up is split out as `start_volume(args)`, a
coroutine that returns the started server and its flight recorder, so a
program can drive the same entry point in process (chip_smoke.py does).

`-ecBackend` picks the EC engine through SWTPU_TORCH_EC_BACKEND (not the
JAX package's SWTPU_EC_BACKEND): `gpu` is the CUDA kernel, `cpu` its
plain PyTorch version on the host, and `auto` means `gpu`. Without a
CUDA device `auto` and `gpu` fail at start-up; the server never serves
EC on the CPU unless `-ecBackend cpu` asks for it.

Not ported yet, and refused with a message naming what is missing:
`-workers` above 1 (the supervisor mode), `-slo` (stats/slo.py),
`-cpuprofile`/`-memprofile` (util/pprof.py) and `-profile.hz`
(stats/profiler.py).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from .security import tls
from .security.guard import parse_white_list
from .util import tracing

# the flags of seaweedfs_tpu/cli.py that need a module the port lacks
_UNPORTED = "is not ported to seaweedfs_tpu_torch yet"


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
                   help=f"cProfile dump on exit: util/pprof.py {_UNPORTED}")
    p.add_argument("-memprofile", default="",
                   help=f"tracemalloc dump on exit: util/pprof.py "
                        f"{_UNPORTED}")
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
                   help=f"continuous sampling profiler rate in Hz: "
                        f"stats/profiler.py {_UNPORTED}")
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
                   help=f"latency objective: stats/slo.py {_UNPORTED}")
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="weed-torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("volume", help="start a volume server")
    _add_common(v)
    v.add_argument("-workers", type=int, default=1,
                   help=f"process-per-core data plane: the supervisor "
                        f"mode {_UNPORTED}, so only 1 is accepted")
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


def _refuse_unported(args) -> None:
    """Exit with a message for every flag whose module is not ported."""
    if args.workers > 1:
        raise SystemExit(f"-workers {args.workers}: the worker supervisor "
                         f"{_UNPORTED}; run one process (-workers 1)")
    if args.slo:
        raise SystemExit(f"-slo: stats/slo.py {_UNPORTED}")
    if args.cpuprofile or args.memprofile:
        raise SystemExit(f"-cpuprofile/-memprofile: util/pprof.py "
                         f"{_UNPORTED}")
    if args.profile_hz:
        raise SystemExit(f"-profile.hz: stats/profiler.py {_UNPORTED}")


def init_daemon(args) -> None:
    """The process-wide set-up of seaweedfs_tpu/cli.py's main for a
    daemon: logging, tracing, the timeline, QoS and mTLS discovery."""
    _refuse_unported(args)
    env_off = os.environ.get("SWTPU_OFFSET_BYTES")
    if env_off:
        from .storage import types as _types
        _types.set_offset_size(int(env_off))
    from .util import glog
    glog.init(verbosity=args.verbosity, log_dir=args.logdir or None,
              logtostderr=args.logtostderr)
    tracing.init(sample=args.trace_sample, slow_ms=args.trace_slowms,
                 ring=args.trace_ring)
    from .stats import timeline
    timeline.init(interval_s=args.timeline_interval,
                  ring=args.timeline_ring)
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
    if os.environ.get("WEED_FAILPOINTS"):
        from .util import failpoints
        glog.warning("FAILPOINTS ARMED: %s",
                     ", ".join(f"{a['site']}={a['action']}"
                               for a in failpoints.list_armed()))
    _discover_security_toml()


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


async def start_volume(args):
    """Start a volume server from parsed `volume` arguments; returns
    (server, recorder handle or None). The caller stops the server and
    cancels the recorder."""
    from .server.volume_server import VolumeServer
    from .storage.store import Store
    _refuse_unported(args)
    _check_ec_backend(args.ecBackend)
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
        needle_cache_bytes=args.cache_mem * 1024 * 1024,
        group_commit_window=args.groupcommit_ms / 1000.0,
        fsync=args.fsync,
        ec_small_recover_bytes=args.ec_smallrecover))
    vs = VolumeServer(store, args.master, ip=args.ip, port=args.port,
                      data_center=args.dataCenter, rack=args.rack,
                      pulse_seconds=args.pulseSeconds, jwt_key=args.jwtKey,
                      white_list=parse_white_list(args.whiteList),
                      public_url=args.publicUrl,
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
    vs, rec = await start_volume(args)
    print(f"volume server listening on {vs.url}, dirs={args.dir.split(',')}",
          flush=True)
    from .util import glog
    from .util.signals import wait_for_interrupt
    try:
        num = await wait_for_interrupt()
        glog.V(1).infof("signal %s: shutting down the volume server", num)
        await vs.stop()
    finally:
        if rec is not None:
            rec.cancel()


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    init_daemon(args)
    try:
        asyncio.run(_run_volume(args))
    except KeyboardInterrupt:
        pass
    except BrokenPipeError:
        os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
