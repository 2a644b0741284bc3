"""`weed`-style CLI of the PyTorch port: the master, the volume server,
the filer and its gateways, the admin shell, the clients and the offline
volume tools.

    python -m seaweedfs_tpu_torch.cli master -port 9333 [-mdir D] \\
        [-peers H:P,...] [-workers N] [-volumeSizeLimitMB 30000] ...
    python -m seaweedfs_tpu_torch.cli volume -port 8080 -dir ./data \\
        -master 127.0.0.1:9333 [-ecBackend auto|gpu|cpu] [-workers N] ...
    python -m seaweedfs_tpu_torch.cli filer -port 8888 \\
        -master 127.0.0.1:9333 [-store sqlite -dbPath ./filer.db] ...
    python -m seaweedfs_tpu_torch.cli server -dir ./data [-filer] [-s3] \\
        [-masterPort 9333 -volumePort 8080 -filerPort 8888 -s3Port 8333]
    python -m seaweedfs_tpu_torch.cli s3 -port 8333 -master H:P \\
        [-store sqlite -dbPath ./s3filer.db] [-accessKey K -secretKey S]
    python -m seaweedfs_tpu_torch.cli webdav -port 7333 -master H:P \\
        [-store sqlite -dbPath ./webdav.db] [-chunkSizeMB 16]
    python -m seaweedfs_tpu_torch.cli filer.replicate -notify sqlite:Q \\
        -sourceMaster H:P -sink local:DIR [-once]
    python -m seaweedfs_tpu_torch.cli filer.copy DIR http://H:P/dir/
    python -m seaweedfs_tpu_torch.cli shell -master 127.0.0.1:9333 \\
        [-c 'ec.encode -collection x']
    python -m seaweedfs_tpu_torch.cli upload|download|benchmark ...
    python -m seaweedfs_tpu_torch.cli scaffold -config filer|version
    python -m seaweedfs_tpu_torch.cli compact|fix|export -dir D -volumeId N
    python -m seaweedfs_tpu_torch.cli backup -dir D -volumeId N -server H:P
    python -m seaweedfs_tpu_torch.cli mount -dir /mnt/weed \\
        -master 127.0.0.1:9333 [-collection C] [-chunkSizeLimitMB 4]
    python -m seaweedfs_tpu_torch.cli bench-ec

The port of seaweedfs_tpu/cli.py's `master`, `volume`, `filer`,
`filer.copy`, `s3`, `webdav`, `filer.replicate`, `server`, `shell`,
`upload`, `download`, `benchmark`, `scaffold`, `version`, `backup`,
`fix`, `export`, `compact` and `mount` subcommands (their flags, the
runners and the process set-up of `main`, with the `-workers N`
supervisor, master.toml's maintenance scripts and sequencer, the filer's
notification queue from -notify or a discovered notification.toml, and
replication.toml's defaults for filer.replicate). `mount` serves a FUSE
mount of an embedded filer (-filerStore) through mount/fuse_adapter.py,
blocking until the mount point is unmounted. `bench-ec` runs the EC
kernel benchmark, `python -m seaweedfs_tpu_torch.tools.bench`, in a
subprocess and exits with its code. Start-up of one master, volume server or filer
process, and of the combined `server`, is split out as
`start_master(args)`, `start_volume(args)`, `start_filer(args)` and
`start_server(args)`, coroutines that return the started server(s) and
the flight recorder, so a program can drive the same entry points in
process (chip_smoke.py does). `version` names this package.

`-ecBackend` picks the EC engine through SWTPU_TORCH_EC_BACKEND (not the
JAX package's SWTPU_EC_BACKEND): `gpu` is the CUDA kernel, `cpu` its
plain PyTorch version on the host, and `auto` means `gpu`. Without the
flag, an inherited SWTPU_TORCH_EC_BACKEND picks it, else `auto`. Without
a CUDA device `auto` and `gpu` fail at start-up; the server never serves
EC on the CPU unless `-ecBackend cpu` or the variable asks for it. `server` has no
`-ecBackend`, as in the reference: its volume server runs `auto`, so
SWTPU_TORCH_EC_BACKEND=cpu is how it serves EC on a host without a card.
Under `-workers N` the supervisor re-executes this module once per
worker; each worker checks the flag at start-up and launches its kernels
in a CUDA context of its own.
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
    v.add_argument("-ecBackend", default=None,
                   choices=("auto", "gpu", "cpu"),
                   help="erasure-coding engine: gpu = the CUDA kernel, "
                        "cpu = its plain PyTorch version on the host, "
                        "auto = gpu (fails without a CUDA device); "
                        "unset: SWTPU_TORCH_EC_BACKEND, else auto")
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
                        "the device (`python -m seaweedfs_tpu_torch.tools."
                        "bench_ec --mode bakeoff` measures the crossover)")

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

    f = sub.add_parser("filer", help="start a filer server")
    _add_common(f)
    f.add_argument("-port", type=int, default=8888)
    f.add_argument("-store", default="sqlite",
                   help="filer store: memory|sqlite|leveldb|leveldb2|sql "
                        "(+redis/mysql/postgres/etcd/cassandra when "
                        "drivers are installed)")
    f.add_argument("-dbPath", default="./filer.db")
    f.add_argument("-chunkSizeMB", type=int, default=32)
    f.add_argument("-collection", default="")
    f.add_argument("-replication", default="")
    f.add_argument("-notify", default="",
                   help="publish meta changes: file:<path> | sqlite:<path> "
                        "| log")
    f.add_argument("-dataCenter", default="",
                   help="prefer volumes in this data center for writes")
    f.add_argument("-redirectOnRead", action="store_true",
                   help="redirect single-chunk GETs to the volume server "
                        "instead of proxying")
    f.add_argument("-disableDirListing", action="store_true")
    f.add_argument("-dirListLimit", type=int, default=100_000,
                   help="cap on directory listing page size")
    f.add_argument("-cache.mem", dest="cache_mem", type=int, default=64,
                   help="MB of memory for the chunk read cache "
                        "(0 disables)")
    f.add_argument("-cache.dir", dest="cache_dir", default="",
                   help="directory for the mmap-backed disk cache tier "
                        "(empty = memory-only)")
    f.add_argument("-shard.id", dest="shard_id", type=int, default=0,
                   help="this filer's shard id in a sharded metadata "
                        "plane (0-based)")
    f.add_argument("-shard.of", dest="shard_of", type=int, default=1,
                   help="total filer shards; >1 enables prefix sharding "
                        "against the master's raft-committed shard map")
    f.add_argument("-shard.peers", dest="shard_peers", default="",
                   help="comma list of filer host:port addresses indexed "
                        "by shard id (fallback when the committed map "
                        "has not learned an owner yet)")
    f.add_argument("-shard.splitMbps", dest="shard_split_mbps",
                   type=float, default=8.0,
                   help="token-bucket pacing for shard split/move "
                        "migration batches (adopted by the -qos.mbps "
                        "arbiter when present)")

    fc = sub.add_parser("filer.copy",
                        help="parallel-upload local files/trees to a filer")
    fc.add_argument("paths", nargs="+",
                    help="local files or directories, then the target "
                         "http://filer:port/dir/ URL last")
    fc.add_argument("-concurrency", type=int, default=8)
    fc.add_argument("-include", default="",
                    help="only copy names matching this glob (e.g. *.txt)")
    fc.add_argument("-collection", default="")
    fc.add_argument("-replication", default="")
    fc.add_argument("-ttl", default="",
                    help="time to live, e.g. 1m, 1h, 1d")

    fr = sub.add_parser("filer.replicate",
                        help="replay filer meta events into a sink "
                             "(flags fall back to replication.toml)")
    fr.add_argument("-notify", default="",
                    help="subscription input: file:<path> | sqlite:<path> "
                         "| kafka:<hosts>/<topic>[@offsets] | "
                         "sqs:<region>/<queue> | pubsub:<project>/<topic>")
    fr.add_argument("-sourceMaster", default="",
                    help="source cluster master host:port")
    fr.add_argument("-sourceDir", default="",
                    help="replicate only this subtree")
    fr.add_argument("-sink", default="",
                    help="filer:<filerHost:port>@<targetMaster> | "
                         "s3:<endpointUrl>/<bucket> | local:<dir>")
    fr.add_argument("-sinkDir", default="")
    fr.add_argument("-progress", default="")
    fr.add_argument("-once", action="store_true",
                    help="process the backlog and exit")

    s3p = sub.add_parser("s3", help="start an S3 gateway")
    _add_common(s3p)
    s3p.add_argument("-port", type=int, default=8333)
    s3p.add_argument("-store", default="sqlite")
    s3p.add_argument("-dbPath", default="./s3filer.db")
    s3p.add_argument("-accessKey", action="append", default=[],
                     help="require SigV4 auth with this access key "
                          "(repeatable — pair each with a -secretKey "
                          "in the same order for multi-tenant "
                          "credentials; empty = anonymous)")
    s3p.add_argument("-secretKey", action="append", default=[])
    s3p.add_argument("-domainName", default="",
                     help="enable virtual-host-style requests "
                          "(Host: bucket.<domainName>)")
    s3p.add_argument("-cache.mem", dest="cache_mem", type=int, default=64,
                     help="MB of memory for the chunk read cache "
                          "(0 disables)")
    s3p.add_argument("-cache.dir", dest="cache_dir", default="",
                     help="directory for the mmap-backed disk cache tier")
    s3p.add_argument("-shard.id", dest="shard_id", type=int, default=0,
                     help="this gateway's filer shard id in a sharded "
                          "gateway fleet")
    s3p.add_argument("-shard.of", dest="shard_of", type=int, default=1,
                     help="total gateway shards; >1 enables 307 "
                          "routing of foreign buckets to siblings")
    s3p.add_argument("-shard.peers", dest="shard_peers", default="",
                     help="comma list of sibling gateway host:port "
                          "addresses indexed by shard id")

    wd = sub.add_parser("webdav", help="start a WebDAV gateway")
    _add_common(wd)
    wd.add_argument("-port", type=int, default=7333)
    wd.add_argument("-store", default="sqlite",
                    help="filer store: memory|sqlite")
    wd.add_argument("-dbPath", default="./webdav.db")
    wd.add_argument("-collection", default="")
    wd.add_argument("-replication", default="")
    wd.add_argument("-chunkSizeMB", type=int, default=16)
    wd.add_argument("-cache.mem", dest="cache_mem", type=int, default=64,
                    help="MB of memory for the chunk read cache "
                         "(0 disables)")
    wd.add_argument("-cache.dir", dest="cache_dir", default="",
                    help="directory for the mmap-backed disk cache tier")
    wd.add_argument("-shard.id", dest="shard_id", type=int, default=0,
                    help="this gateway's filer shard id in a sharded "
                         "gateway fleet")
    wd.add_argument("-shard.of", dest="shard_of", type=int, default=1,
                    help="total gateway shards; >1 enables 307 "
                         "routing of foreign paths to siblings")
    wd.add_argument("-shard.peers", dest="shard_peers", default="",
                    help="comma list of sibling gateway host:port "
                         "addresses indexed by shard id")

    srv = sub.add_parser("server",
                         help="combined master+volume+filer+s3 in one process")
    _add_common(srv)
    srv.add_argument("-dir", default="./data")
    srv.add_argument("-masterPort", type=int, default=9333)
    srv.add_argument("-volumePort", type=int, default=8080)
    srv.add_argument("-filerPort", type=int, default=8888)
    srv.add_argument("-s3Port", type=int, default=8333)
    srv.add_argument("-s3", action="store_true")
    srv.add_argument("-filer", action="store_true")
    srv.add_argument("-jwtKey", default="")

    up = sub.add_parser("upload", help="upload files via assign+PUT")
    _add_common(up)
    up.add_argument("files", nargs="*", default=[])
    up.add_argument("-collection", default="")
    up.add_argument("-replication", default="")
    up.add_argument("-ttl", default="")
    up.add_argument("-dataCenter", default="")
    up.add_argument("-dir", dest="updir", default="",
                    help="upload this folder recursively (upload.go:35)")
    up.add_argument("-include", default="",
                    help="glob of names to upload, with -dir (e.g. *.pdf)")
    up.add_argument("-maxMB", type=int, default=0,
                    help="split files larger than this into a chunk "
                         "manifest (0 = never split)")

    dl = sub.add_parser("download", help="download a fid")
    _add_common(dl)
    dl.add_argument("fid")
    dl.add_argument("-o", dest="output", default="")

    bm = sub.add_parser("benchmark", help="write/read throughput benchmark")
    _add_common(bm)
    bm.add_argument("-n", type=int, default=1024)
    bm.add_argument("-size", type=int, default=1024)
    bm.add_argument("-c", dest="concurrency", type=int, default=16)
    bm.add_argument("-collection", default="benchmark")
    bm.add_argument("-replication", default="000")
    bm.add_argument("-write", default="true", choices=("true", "false"),
                    help="enable the write phase")
    bm.add_argument("-read", default="true", choices=("true", "false"),
                    help="enable the read phase")
    bm.add_argument("-deletePercent", type=int, default=0,
                    help="percent of writes immediately deleted again")
    bm.add_argument("-list", dest="idList", default="",
                    help="file of uploaded fids (written after the write "
                         "phase; read phase loads it when -write=false)")
    bm.add_argument("-readSequentially", nargs="?", const="true",
                    default="false", choices=("true", "false"),
                    help="read fids in list order instead of shuffled")
    bm.add_argument("-readMode", default="",
                    choices=("", "shuffle", "sequential", "zipf",
                             "batch"),
                    help="read-order distribution; zipf = repeated "
                         "hot-key reads (the cache-effectiveness "
                         "workload; overrides -readSequentially); "
                         "batch = shuffled order over multi-needle "
                         "/batch GETs")
    bm.add_argument("-readN", type=int, default=0,
                    help="total read requests (0 = one per fid); with "
                         "-readMode zipf the same hot fids repeat")
    bm.add_argument("-zipfS", type=float, default=1.1,
                    help="zipf exponent for -readMode zipf")
    bm.add_argument("-batchSize", type=int, default=0,
                    help="reads per multi-needle /batch request; >0 "
                         "batches ANY -readMode's order (-readMode "
                         "batch implies 32); reports req/s and "
                         "needles/s")
    bm.add_argument("-pipeline", type=int, default=0,
                    help="in-flight reads multiplexed per persistent "
                         "binary frame connection (util/frame.py); >0 "
                         "pipelines ANY -readMode's order depth-N over "
                         "one frame socket per server per client "
                         "(channel failures fall back to HTTP; a "
                         "missing needle is fatal, like single GETs); "
                         "mutually exclusive with -batchSize")

    sc = sub.add_parser("scaffold", help="print example config TOML")
    sc.add_argument("-config", default="security",
                    choices=["security", "master", "filer",
                             "notification", "replication"])

    mt = sub.add_parser("mount", help="mount the filer as a FUSE "
                                      "filesystem (fusepy, or the built-in "
                                      "/dev/fuse binding)")
    _add_common(mt)
    mt.add_argument("-dir", required=True, help="mount point")
    mt.add_argument("-collection", default="")
    mt.add_argument("-replication", default="")
    mt.add_argument("-ttl", default="")
    mt.add_argument("-chunkSizeLimitMB", type=int, default=4)
    mt.add_argument("-filerStore", default="memory",
                    help="embedded filer store backing the mount")

    sub.add_parser("version", help="print version")
    sub.add_parser("bench-ec", help="EC kernel benchmark on the GPU "
                                    "(seaweedfs_tpu_torch.tools.bench)")

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


def _discover_notification_queue():
    """Discovered notification.toml (the scaffold's [notification.*]
    enabled sections, configuration.go:24-58). Used by every command
    that embeds a filer when -notify is not given; returns the one
    enabled queue or None. Config errors exit cleanly like the -notify
    flag path does."""
    found = _find_config_toml("notification")
    if found is None:
        return None
    path, cfg = found
    from .notification.queues import load_configuration
    try:
        q = load_configuration(cfg.get("notification"))
    except (ValueError, RuntimeError, KeyError) as e:
        raise SystemExit(f"{path}: {e}")
    if q is not None:
        from .util import glog
        glog.info("notification queue %s from %s", q.name, path)
    return q


def _attach_discovered_queue(filer) -> None:
    q = _discover_notification_queue()
    if q is not None:
        from .notification.queues import attach_to_filer
        attach_to_filer(filer, q)



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


def _check_ec_backend(backend: str | None) -> None:
    """Pin the EC engine for this process and build it once now, so a
    missing CUDA device fails start-up instead of the first EC request.
    The flag is authoritative: an explicit `-ecBackend auto` clears an
    inherited pin from the parent environment. Without the flag the
    inherited SWTPU_TORCH_EC_BACKEND stands, as it does for `server`,
    so a driver that spawns plain `volume` daemons picks the engine
    through the environment (auto when it is unset)."""
    from .ec import pipeline as ecpl
    if backend is None:
        backend = os.environ.get(ecpl.BACKEND_ENV, "auto")
    os.environ[ecpl.BACKEND_ENV] = backend
    try:
        ecpl.get_encoder(backend)
    except (RuntimeError, ValueError) as e:
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


def _store_kwargs(store: str, db_path: str) -> dict:
    if store in ("sqlite", "sql"):
        return {"path": db_path}
    if store in ("leveldb", "leveldb2"):
        return {"dir": db_path}
    return {}


async def start_filer(args):
    """Start the filer process of parsed `filer` arguments: its store,
    its notification queue (-notify, else a discovered
    notification.toml) and its server; returns (server, recorder handle
    or None). The caller stops the server and cancels the recorder."""
    from .filer.filer import Filer
    from .server.filer_server import FilerServer
    from .stats import timeline
    kwargs = _store_kwargs(args.store, args.dbPath)
    # a store's ctor opens (and may replay) its database: off the loop
    filer = await tracing.run_in_executor(
        lambda: Filer(args.store, **kwargs))
    if args.notify:
        from .notification.queues import attach_to_filer
        attach_to_filer(filer, await tracing.run_in_executor(
            _make_queue, args.notify))
    else:
        await tracing.run_in_executor(_attach_discovered_queue, filer)
    fs = FilerServer(filer, args.master,
                     ip=args.ip, port=args.port,
                     chunk_size=args.chunkSizeMB * 1024 * 1024,
                     collection=args.collection,
                     replication=args.replication,
                     data_center=args.dataCenter,
                     redirect_on_read=args.redirectOnRead,
                     disable_dir_listing=args.disableDirListing,
                     dir_list_limit=args.dirListLimit,
                     cache_mem_bytes=args.cache_mem * 1024 * 1024,
                     cache_dir=args.cache_dir,
                     shard_id=args.shard_id, shard_of=args.shard_of,
                     shard_peers={i: p.strip() for i, p in
                                  enumerate(args.shard_peers.split(","))
                                  if p.strip()},
                     shard_split_mbps=args.shard_split_mbps)
    await fs.start()
    return fs, timeline.start_recorder()


async def _run_filer(args) -> None:
    fs, rec = await start_filer(args)
    shard_note = (f", shard {args.shard_id}/{args.shard_of}"
                  if args.shard_of > 1 else "")
    print(f"filer listening on {fs.url} (store={args.store}"
          f"{shard_note})", flush=True)
    try:
        await _serve_until_interrupt(fs)
    finally:
        if rec is not None:
            rec.cancel()


def _make_queue(spec: str):
    from .notification.queues import queue_from_spec
    try:
        return queue_from_spec(spec)
    except ValueError as e:
        raise SystemExit(str(e))


async def _run_filer_copy(args) -> None:
    """Parallel tree upload to the filer HTTP surface
    (reference: weed filer.copy, command/filer_copy.go)."""
    import fnmatch

    import aiohttp

    *sources, dest = args.paths
    if not dest.startswith("http"):
        raise SystemExit("last argument must be the target "
                         "http://filer:port/dir/ URL")
    if not dest.endswith("/"):
        dest += "/"

    jobs: list[tuple[str, str]] = []  # (local path, remote rel path)
    for src in sources:
        if os.path.isdir(src):
            base = os.path.basename(os.path.abspath(src))
            walked = await tracing.run_in_executor(
                _walk_upload_files, src, args.include)
            for full in walked:
                rel = os.path.join(base, os.path.relpath(full, src))
                jobs.append((full, rel))
        elif os.path.isfile(src):
            if not args.include or fnmatch.fnmatch(
                    os.path.basename(src), args.include):
                jobs.append((src, os.path.basename(src)))
        else:
            raise SystemExit(f"no such file or directory: {src}")

    import urllib.parse

    sem = asyncio.Semaphore(args.concurrency)
    copied = errors = 0
    attr_params = {k: v for k, v in (
        ("collection", args.collection),
        ("replication", args.replication),
        ("ttl", args.ttl)) if v}

    async with tls.make_session() as http:
        async def upload(local: str, rel: str) -> bool:
            async with sem:
                try:
                    # hand the file object to FormData so aiohttp streams
                    # it instead of holding whole files in memory; open
                    # and close leave the loop — N concurrent uploads
                    # share it
                    f = await tracing.run_in_executor(open, local, "rb")
                    try:
                        form = aiohttp.FormData()
                        form.add_field("file", f,
                                       filename=os.path.basename(rel))
                        target = dest + urllib.parse.quote(
                            rel.replace(os.sep, "/"))
                        async with http.post(target, data=form,
                                             params=attr_params) as resp:
                            if resp.status not in (200, 201):
                                print(f"copy {local}: http {resp.status} "
                                      f"{await resp.text()}")
                                return False
                    finally:
                        await tracing.run_in_executor(f.close)
                except (OSError, aiohttp.ClientError,
                        asyncio.TimeoutError) as e:
                    print(f"copy {local}: {e}")
                    return False
            return True

        results = await asyncio.gather(
            *(upload(l, r) for l, r in jobs))
        copied = sum(results)
        errors = len(results) - copied
    print(f"copied {copied} files to {dest}"
          + (f", {errors} errors" if errors else ""))
    if errors:
        raise SystemExit(1)


def _make_subscription(spec: str):
    """filer.replicate consumption input: the file/sqlite queues plus the
    broker subscribers (replication/sub.py, driver-gated like the
    publishers). Broker specs:
      kafka:<host1,host2>/<topic>[@offset_file]
      sqs:<region>/<queue_name>
      pubsub:<project_id>/<topic>
    """
    kind, _, rest = spec.partition(":")
    if kind in ("file", "sqlite"):  # NOT "log": it records, can't replay
        return _make_queue(spec)
    from .replication import sub as rsub
    if kind == "kafka":
        hosts, _, rest2 = rest.partition("/")
        topic, _, offset_file = rest2.partition("@")
        q = rsub.KafkaInput()
        q.initialize({"hosts": hosts.split(","), "topic": topic,
                      "offset_file": offset_file or None})
        return q
    if kind == "sqs":
        region, _, name = rest.partition("/")
        q = rsub.SqsInput()
        q.initialize({"region": region, "sqs_queue_name": name})
        return q
    if kind == "pubsub":
        project, _, topic = rest.partition("/")
        q = rsub.GooglePubSubInput()
        q.initialize({"project_id": project, "topic": topic})
        return q
    raise SystemExit(f"bad -notify spec {spec!r}; use file:<path> | "
                     f"sqlite:<path> | kafka:<hosts>/<topic>[@offsets] | "
                     f"sqs:<region>/<queue> | pubsub:<project>/<topic>")


def _make_sink(spec: str, sink_dir: str):
    from .replication.sink import FilerSink, LocalDirSink, S3Sink
    kind, _, rest = spec.partition(":")
    if kind == "filer":
        target, _, master = rest.partition("@")
        if not (target and master):
            raise SystemExit(
                "bad -sink: filer:<filerHost:port>@<targetMaster>")
        return FilerSink(target, master, directory=sink_dir)
    if kind == "s3":
        endpoint, _, bucket = rest.rpartition("/")
        if not (endpoint and bucket):
            raise SystemExit("bad -sink: s3:<endpointUrl>/<bucket>")
        return S3Sink(endpoint, bucket, directory=sink_dir)
    if kind == "local":
        return LocalDirSink(rest)
    raise SystemExit(f"unknown sink kind {kind!r}")


async def _run_filer_replicate(args) -> None:
    from .replication.replicator import Replicator
    from .replication.runner import replicate_from_queue
    from .replication.source import FilerSource
    # flags win; replication.toml [replication] fills whatever is absent
    found = await tracing.run_in_executor(
        _find_config_toml, "replication")
    cfg = found[1].get("replication", {}) if found else {}
    notify = args.notify or cfg.get("notify", "")
    source_master = args.sourceMaster or cfg.get("sourceMaster", "")
    source_dir = args.sourceDir or cfg.get("sourceDir", "/")
    sink_spec = args.sink or cfg.get("sink", "")
    sink_dir = args.sinkDir or cfg.get("sinkDir", "/")
    progress = args.progress or cfg.get("progress",
                                        "./replicate.progress")
    missing = [f for f, v in (("-notify", notify),
                              ("-sourceMaster", source_master),
                              ("-sink", sink_spec)) if not v]
    if missing:
        raise SystemExit(
            f"filer.replicate needs {', '.join(missing)} (flags or "
            f"replication.toml [replication] keys)")
    queue = await tracing.run_in_executor(_make_subscription, notify)
    sink = _make_sink(sink_spec, sink_dir)
    async with FilerSource(source_master, source_dir) as src:
        await sink.start()
        try:
            n = await replicate_from_queue(
                queue, Replicator(src, sink), progress,
                once=args.once)
            if args.once:
                print(f"replicated {n} events")
        finally:
            await sink.close()
            closer = getattr(queue, "close", None)
            if closer is not None:
                closer()


def _gateway_router(args):
    """-shard.of > 1: build the GatewayRouter for a sharded S3/WebDAV
    fleet (one gateway per filer shard, siblings from -shard.peers)."""
    if getattr(args, "shard_of", 1) <= 1:
        return None
    from .filer.shard import GatewayRouter
    peers = {i: p.strip() for i, p in
             enumerate(args.shard_peers.split(",")) if p.strip()}
    return GatewayRouter(args.shard_id, args.master, peers)


async def _run_s3(args) -> None:
    from .filer.filer import Filer
    from .s3.gateway import S3Gateway
    from .stats import timeline
    kwargs = _store_kwargs(args.store, args.dbPath)
    if len(args.accessKey) != len(args.secretKey):
        raise SystemExit("-accessKey and -secretKey must be paired "
                         "(one -secretKey per -accessKey, same order)")
    identities = (dict(zip(args.accessKey, args.secretKey))
                  if args.accessKey else None)
    filer = await tracing.run_in_executor(
        lambda: Filer(args.store, **kwargs))
    await tracing.run_in_executor(_attach_discovered_queue, filer)
    s3 = S3Gateway(filer, args.master,
                   ip=args.ip, port=args.port, identities=identities,
                   domain_name=args.domainName,
                   cache_mem_bytes=args.cache_mem * 1024 * 1024,
                   cache_dir=args.cache_dir,
                   shard_router=_gateway_router(args))
    await s3.start()
    rec = timeline.start_recorder()
    print(f"s3 gateway listening on {s3.url}", flush=True)
    try:
        await _serve_until_interrupt(s3)
    finally:
        if rec is not None:
            rec.cancel()


async def _run_webdav(args) -> None:
    from .filer.filer import Filer
    from .server.webdav_server import WebDavServer
    from .stats import timeline
    kwargs = _store_kwargs(args.store, args.dbPath)
    filer = await tracing.run_in_executor(
        lambda: Filer(args.store, **kwargs))
    await tracing.run_in_executor(_attach_discovered_queue, filer)
    # ctor builds the disk chunk-cache tier (makedirs)
    wd = await tracing.run_in_executor(lambda: WebDavServer(
        filer, args.master,
        ip=args.ip, port=args.port,
        collection=args.collection,
        replication=args.replication,
        chunk_size=args.chunkSizeMB * 1024 * 1024,
        cache_mem_bytes=args.cache_mem * 1024 * 1024,
        cache_dir=args.cache_dir,
        shard_router=_gateway_router(args)))
    await wd.start()
    rec = timeline.start_recorder()
    print(f"webdav listening on {wd.url} (store={args.store})", flush=True)
    try:
        await _serve_until_interrupt(wd)
    finally:
        if rec is not None:
            rec.cancel()


async def start_server(args):
    """Start `weed server` (command/server.go:103+) from parsed `server`
    arguments: a master, a volume server on -dir, and with -filer or -s3 a
    filer on -dir/filer.db (its queue from a discovered
    notification.toml), and with -s3 an S3 gateway on that filer, all in
    this process. Returns ({"master", "volume", "filer", "s3"}: the
    servers, None where not started; recorder handle or None). The caller
    stops the servers, data plane first, and cancels the recorder.

    The volume server's EC engine is get_encoder("auto"): the card, or
    SWTPU_TORCH_EC_BACKEND; with neither, start-up fails."""
    from .ec import pipeline as ecpl
    from .filer.filer import Filer
    from .master.server import MasterServer
    from .s3.gateway import S3Gateway
    from .server.filer_server import FilerServer
    from .server.volume_server import VolumeServer
    from .stats import timeline
    from .storage.store import Store
    try:
        ecpl.get_encoder("auto")
    except RuntimeError as e:
        raise SystemExit(f"server: {e} (set {ecpl.BACKEND_ENV}=cpu to "
                         f"serve EC on the host)")
    up = {"master": None, "volume": None, "filer": None, "s3": None}
    try:
        m = await tracing.run_in_executor(
            lambda: MasterServer(ip=args.ip, port=args.masterPort,
                                 jwt_key=args.jwtKey))
        await m.start()
        up["master"] = m
        # combined mode gets the standalone daemons' default cache budgets
        store = await tracing.run_in_executor(
            lambda: Store([args.dir], needle_cache_bytes=32 << 20))
        vs = VolumeServer(store, m.url, ip=args.ip, port=args.volumePort,
                          jwt_key=args.jwtKey)
        await vs.start()
        up["volume"] = vs
        await vs.heartbeat_once()
        if args.filer or args.s3:
            combined_filer = await tracing.run_in_executor(
                lambda: Filer("sqlite",
                              path=os.path.join(args.dir, "filer.db")))
            await tracing.run_in_executor(
                _attach_discovered_queue, combined_filer)
            fs = FilerServer(combined_filer, m.url, ip=args.ip,
                             port=args.filerPort, cache_mem_bytes=64 << 20)
            await fs.start()
            up["filer"] = fs
        if args.s3:
            s3 = S3Gateway(fs.filer, m.url, ip=args.ip, port=args.s3Port)
            await s3.start()
            up["s3"] = s3
    except BaseException:
        await stop_server(up)
        raise
    return up, timeline.start_recorder(disk_paths=[args.dir])


async def stop_server(up: dict) -> None:
    """Stop what start_server started: the data plane drains before the
    control plane disappears."""
    for name in ("s3", "filer", "volume", "master"):
        if up.get(name) is not None:
            await up[name].stop()


async def _run_server(args) -> None:
    up, rec = await start_server(args)
    print("server up: " + " ".join(
        f"{name}={srv.url}" for name, srv in up.items() if srv is not None),
        flush=True)
    try:
        await _serve_until_interrupt(*[up[name] for name in
                                       ("s3", "filer", "volume", "master")
                                       if up[name] is not None])
    finally:
        if rec is not None:
            rec.cancel()


def _walk_upload_files(dir_path: str, include: str) -> list[str]:
    """Recursive -dir traversal filtered by the -include glob (shared by
    upload and filer.copy; upload.go:35-36)."""
    import fnmatch
    if not os.path.isdir(dir_path):
        raise SystemExit(f"no such directory: {dir_path}")
    out = []
    for root, _, names in os.walk(dir_path):
        for name in sorted(names):
            if include and not fnmatch.fnmatch(name, include):
                continue
            out.append(os.path.join(root, name))
    return out


def _read_file(path: str) -> bytes:
    """Sync whole-file read, for executor round-trips off the loop."""
    with open(path, "rb") as f:
        return f.read()


def _write_file(path: str, data: bytes) -> None:
    """Sync whole-file write, for executor round-trips off the loop."""
    with open(path, "wb") as f:
        f.write(data)


async def _run_upload(args) -> None:
    from .util.client import WeedClient
    max_mb = getattr(args, "maxMB", 0) or 0
    files = list(args.files)
    if args.updir:
        files.extend(await tracing.run_in_executor(
            _walk_upload_files, args.updir, args.include))
    if not files:
        raise SystemExit("upload: no input files (pass paths or -dir)")
    async with WeedClient(args.master) as c:
        out = []
        for path in files:
            data = await tracing.run_in_executor(_read_file, path)
            if max_mb > 0 and len(data) > max_mb * 1024 * 1024:
                # auto-split into a chunk manifest (submit.go:112-199)
                from .util.chunked import upload_in_chunks
                fid, cm = await upload_in_chunks(
                    c, data, max_mb, name=os.path.basename(path),
                    collection=args.collection,
                    replication=args.replication, ttl=args.ttl,
                    data_center=args.dataCenter)
                out.append({"fileName": os.path.basename(path),
                            "fid": fid, "size": len(data),
                            "chunks": len(cm.chunks),
                            "fileUrl": await c.lookup_file_id(fid)})
                continue
            fid = await c.upload_data(data, collection=args.collection,
                                      replication=args.replication,
                                      ttl=args.ttl,
                                      data_center=args.dataCenter)
            out.append({"fileName": os.path.basename(path), "fid": fid,
                        "size": len(data),
                        "fileUrl": await c.lookup_file_id(fid)})
        print(json.dumps(out, indent=2))


async def _run_download(args) -> None:
    from .util.client import WeedClient
    async with WeedClient(args.master) as c:
        data = await c.read(args.fid)
    out = args.output or args.fid.replace(",", "_")
    await tracing.run_in_executor(_write_file, out, data)
    print(f"wrote {len(data)} bytes to {out}")



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


class _RawConn:
    """One persistent raw HTTP/1.1 connection for the benchmark loop.

    The reference's benchmark client is a lean Go net/http loop
    (command/benchmark.go); a full aiohttp ClientSession here would
    measure the client's own parser, not the servers, on a single core."""

    __slots__ = ("r", "w", "hostport", "_hdr")

    @classmethod
    async def open(cls, hostport: str) -> "_RawConn":
        host, _, port = hostport.rpartition(":")
        c = cls.__new__(cls)
        c.hostport = hostport
        c.r, c.w = await asyncio.open_connection(
            host or "127.0.0.1", int(port), ssl=tls.client_ctx())
        c._hdr = f"\r\nHost: {hostport}\r\n".encode()
        return c

    async def request(self, method: str, path: str, body: bytes = b"",
                      ctype: str = "") -> tuple[int, bytes]:
        head = method.encode() + b" " + path.encode() + b" HTTP/1.1" \
            + self._hdr
        if body or method in ("POST", "PUT"):
            head += b"Content-Length: " + str(len(body)).encode() + b"\r\n"
        if ctype:
            head += b"Content-Type: " + ctype.encode() + b"\r\n"
        self.w.write(head + b"\r\n" + body)
        await self.w.drain()
        hdr = await self.r.readuntil(b"\r\n\r\n")
        status = int(hdr[9:12])
        i = hdr.lower().find(b"content-length:")
        cl = 0
        if i >= 0:
            cl = int(hdr[i + 15:hdr.index(b"\r\n", i)])
        data = await self.r.readexactly(cl) if cl else b""
        return status, data

    def close(self) -> None:
        try:
            self.w.close()
        except OSError:
            pass  # already-dead socket: nothing left to release


async def _run_benchmark(args) -> None:
    """weed benchmark analog (command/benchmark.go): concurrent small-file
    writes + reads with latency percentiles, over per-worker persistent
    raw connections (see _RawConn)."""
    import random

    rng = random.Random(0)
    payload = bytes(rng.getrandbits(8) for _ in range(args.size))
    write_lat: list[float] = []
    read_lat: list[float] = []
    fids: list[str] = []
    deletes = 0
    do_write = args.write == "true"
    do_read = args.read == "true"
    if not do_write:
        if not args.idList:
            raise SystemExit("-write=false needs -list <fid file> "
                             "from an earlier write run")
        raw = await tracing.run_in_executor(_read_file, args.idList)
        fids = [ln.strip() for ln in raw.decode().splitlines()
                if ln.strip()]

    master = args.master.split(",")[0]
    assign_q = "/dir/assign"
    qs = []
    if args.collection:
        qs.append(f"collection={args.collection}")
    if args.replication:
        qs.append(f"replication={args.replication}")
    if qs:
        assign_q += "?" + "&".join(qs)
    vol_locs: dict[str, str] = {}       # vid -> host:port (lookup cache)
    read_bytes = 0
    wi = ri = 0                          # shared cursors (single loop)
    # -batchSize / -readMode batch: reads ride multi-needle /batch GETs
    batch_size = args.batchSize or (32 if args.readMode == "batch"
                                    else 0)
    pipeline = args.pipeline
    if pipeline and batch_size:
        raise SystemExit("-pipeline and -batchSize are mutually "
                         "exclusive read transports")
    read_reqs = 0                        # wire requests (batch != needle)
    needles_read = 0
    frame_fallbacks = 0                  # pipeline reads downgraded to HTTP

    async def lookup(mconn: _RawConn, vid: str) -> str:
        url = vol_locs.get(vid)
        if url is None:
            st, body = await mconn.request(
                "GET", f"/dir/lookup?volumeId={vid}")
            if st != 200:
                raise RuntimeError(f"lookup {vid}: {st}")
            url = json.loads(body)["locations"][0]["url"]
            vol_locs[vid] = url
        return url

    async def worker(phase: str, order: list[str]) -> None:
        nonlocal deletes, read_bytes, wi, ri, read_reqs, needles_read
        nonlocal frame_fallbacks
        mconn = await _RawConn.open(master)
        vconns: dict[str, _RawConn] = {}
        fchannels: dict[str, object] = {}

        async def vconn(hostport: str) -> _RawConn:
            c = vconns.get(hostport)
            if c is None:
                c = vconns[hostport] = await _RawConn.open(hostport)
            return c

        def fchannel(hostport: str):
            ch = fchannels.get(hostport)
            if ch is None:
                from .util.frame import FrameChannel
                ch = fchannels[hostport] = FrameChannel(
                    target=hostport, ssl=tls.client_ctx())
            return ch

        try:
            while True:
                if phase == "write":
                    if wi >= args.n:
                        return
                    wi += 1
                    t0 = time.perf_counter()
                    st, body = await mconn.request("GET", assign_q)
                    if st != 200:
                        raise RuntimeError(f"assign: {body[:200]!r}")
                    a = json.loads(body)
                    fid = a["fid"]
                    vc = await vconn(a["url"])
                    path = "/" + fid
                    auth = a.get("auth", "")
                    if auth:
                        # JWT rides as a query param the server accepts
                        path += "?jwt=" + auth
                    st, body = await vc.request("POST", path, payload)
                    if st not in (200, 201):
                        raise RuntimeError(f"upload {fid}: {st} "
                                           f"{body[:200]!r}")
                    # sample BEFORE any delete: the write percentiles
                    # must measure writes, not write+delete round trips
                    write_lat.append(time.perf_counter() - t0)
                    # random sampling like the reference (rand.Intn(100)):
                    # a modulo scheme front-loads deletes and skews the
                    # rate whenever n is not a multiple of 100
                    if args.deletePercent > 0 and \
                            rng.randrange(100) < args.deletePercent:
                        await vc.request("DELETE", "/" + fid)
                        deletes += 1
                    else:
                        fids.append(fid)
                elif pipeline:
                    if ri >= len(order):
                        return
                    group = order[ri:ri + pipeline]
                    ri += len(group)
                    by_server: dict[str, list[str]] = {}
                    for fid in group:
                        by_server.setdefault(
                            await lookup(mconn, fid.split(",")[0]),
                            []).append(fid)
                    from .util.frame import FrameChannelError
                    for server, fids_here in by_server.items():
                        ch = fchannel(server)
                        failed: list[str] = []

                        async def one(fid: str) -> None:
                            nonlocal read_bytes, needles_read
                            nonlocal read_reqs
                            t0 = time.perf_counter()
                            try:
                                st, _, data = await ch.request(
                                    "GET", "/" + fid)
                            except (FrameChannelError, OSError):
                                failed.append(fid)
                                return
                            read_lat.append(time.perf_counter() - t0)
                            if st != 200:
                                raise RuntimeError(
                                    f"pipelined read {fid}: {st}")
                            read_reqs += 1
                            needles_read += 1
                            read_bytes += len(data)

                        # depth-`pipeline` window: every request is in
                        # flight on ONE multiplexed frame connection
                        await asyncio.gather(*(one(f)
                                               for f in fids_here))
                        # channel-level failures ride HTTP, serially on
                        # this worker's keep-alive conn (rare path)
                        for fid in failed:
                            frame_fallbacks += 1
                            vc = await vconn(server)
                            t0 = time.perf_counter()
                            st, data = await vc.request("GET", "/" + fid)
                            if st != 200:
                                raise RuntimeError(f"read {fid}: {st}")
                            read_lat.append(time.perf_counter() - t0)
                            read_reqs += 1
                            needles_read += 1
                            read_bytes += len(data)
                elif batch_size:
                    if ri >= len(order):
                        return
                    group = order[ri:ri + batch_size]
                    ri += len(group)
                    # one /batch request per holding server (single
                    # server in this harness, but correct regardless)
                    by_server: dict[str, list[str]] = {}
                    for fid in group:
                        by_server.setdefault(
                            await lookup(mconn, fid.split(",")[0]),
                            []).append(fid)
                    from .util.batchframe import parse_all
                    for server, fids_here in by_server.items():
                        vc = await vconn(server)
                        t0 = time.perf_counter()
                        st, data = await vc.request(
                            "GET", "/batch?fids=" + ",".join(fids_here))
                        read_lat.append(time.perf_counter() - t0)
                        if st != 200:
                            raise RuntimeError(f"batch read: {st} "
                                               f"{data[:200]!r}")
                        read_reqs += 1
                        for meta, body in parse_all(data):
                            if meta.get("status") != 200:
                                raise RuntimeError(
                                    f"batch row {meta.get('fid')}: "
                                    f"{meta.get('status')}")
                            needles_read += 1
                            read_bytes += len(body)
                else:
                    if ri >= len(order):
                        return
                    fid = order[ri]
                    ri += 1
                    t0 = time.perf_counter()
                    vc = await vconn(
                        await lookup(mconn, fid.split(",")[0]))
                    st, data = await vc.request("GET", "/" + fid)
                    if st != 200:
                        raise RuntimeError(f"read {fid}: {st}")
                    read_lat.append(time.perf_counter() - t0)
                    read_bytes += len(data)
                    read_reqs += 1
                    needles_read += 1
        finally:
            mconn.close()
            for c in vconns.values():
                c.close()
            for ch in fchannels.values():
                await ch.close()

    wdt = 0.0
    if do_write:
        t0 = time.perf_counter()
        await asyncio.gather(*(worker("write", [])
                               for _ in range(args.concurrency)))
        wdt = time.perf_counter() - t0
        if args.idList:
            await tracing.run_in_executor(
                _write_file, args.idList,
                ("\n".join(fids) + "\n").encode())

    rdt = 0.0
    n_reads = 0
    if do_read and fids:
        mode = args.readMode or ("sequential"
                                 if args.readSequentially == "true"
                                 else "shuffle")
        if mode == "zipf":
            # zipf over a shuffled ranking: rank r drawn with weight
            # 1/r^s, so a small hot set dominates — the classic
            # read-mostly object-store mix the caches target
            ranked = list(fids)
            rng.shuffle(ranked)
            weights = [1.0 / (r + 1) ** args.zipfS
                       for r in range(len(ranked))]
            order = rng.choices(ranked, weights=weights,
                                k=args.readN or len(ranked))
        elif mode == "sequential":
            order = list(fids)
        else:
            order = list(fids)
            rng.shuffle(order)
        n_reads = len(order)
        t0 = time.perf_counter()
        await asyncio.gather(*(worker("read", order)
                               for _ in range(args.concurrency)))
        rdt = time.perf_counter() - t0

    def pct(xs, p):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(p / 100 * len(xs)))] * 1e3

    if do_write:
        print(f"write: {args.n / wdt:.1f} req/s, "
              f"{args.n * args.size / wdt / 1024:.1f} KB/s"
              + (f" ({deletes} deletes)" if deletes else ""))
        print(f"  latency ms p50/p95/p99/max: {pct(write_lat, 50):.1f}/"
              f"{pct(write_lat, 95):.1f}/{pct(write_lat, 99):.1f}/"
              f"{max(write_lat) * 1e3:.1f}")
    if do_read and fids:
        # measured bytes, not -size: a -write=false run may read fids
        # written with a different size
        print(f"read:  {read_reqs / rdt:.1f} req/s, "
              f"{read_bytes / rdt / 1024:.1f} KB/s")
        if batch_size:
            # the amortization headline: needles served per second vs
            # wire round trips spent serving them
            print(f"  needles/s: {needles_read / rdt:.1f} "
                  f"(batch={batch_size}, {needles_read} needles over "
                  f"{read_reqs} requests)")
        if pipeline:
            # the overlap headline: depth-N multiplexed frames on one
            # socket per server, no round-trip wait per needle
            print(f"  needles/s: {needles_read / rdt:.1f} "
                  f"(pipeline={pipeline} over frames, "
                  f"{frame_fallbacks} HTTP fallbacks)")
        print(f"  latency ms p50/p95/p99/max: {pct(read_lat, 50):.1f}/"
              f"{pct(read_lat, 95):.1f}/{pct(read_lat, 99):.1f}/"
              f"{max(read_lat) * 1e3:.1f}")


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


def _run_mount(args) -> None:
    """Serve a FUSE mount of an embedded filer until it is unmounted
    (mount_std.go runMount): node metadata in -filerStore, chunk data
    through the master at -master."""
    from .filer.filer import Filer
    from .mount.fuse_adapter import mount as fuse_mount
    from .mount.wfs import MountOptions
    fuse_mount(
        Filer(args.filerStore), args.master, args.dir,
        MountOptions(collection=args.collection,
                     replication=args.replication, ttl=args.ttl,
                     chunk_size_limit=args.chunkSizeLimitMB << 20))


_SCAFFOLDS = {
    "security": """# security.toml (reference: weed scaffold -config=security)
[jwt.signing]
key = ""            # base64 or raw secret; empty disables write tokens
expires_after_seconds = 10

[tls]
# mutual TLS for the inter-server mesh (master + volume servers), like the
# reference's [grpc.*] sections (weed/security/tls.go). Client-facing
# surfaces (filer HTTP, S3, WebDAV) stay plaintext + JWT so standard
# clients keep working. All three paths required.
ca = ""             # CA certificate that signed every server cert
cert = ""           # this process's certificate
key = ""            # this process's private key
require_client_cert = true
""",
    "master": """# master.toml
[master.maintenance]
scripts = \"\"\"
  ec.encode -fullPercent=95 -quietFor=1h
  ec.rebuild -force
  ec.balance -force
  volume.balance -force
  # parity scrub reads every EC stripe — run it on its own master.toml
  # with a long sleep_minutes (e.g. daily), not every cycle:
  # ec.verify -collection important
\"\"\"
sleep_minutes = 17
[master.sequencer]
type = "memory"
""",
    "filer": """# filer.toml
[memory]
enabled = false
[sqlite]
enabled = true
path = "./filer.db"
""",
    "notification": """# notification.toml (weed scaffold -config=notification)
# exactly ONE queue may be enabled; the filer publishes an
# EventNotification per meta change to it (filer_notify.go:9-31)

[notification.log]
enabled = false

[notification.file]
enabled = false
path = "./filer.events"

[notification.sqlite]
enabled = false
path = "./filer.events.db"

[notification.kafka]
enabled = false
hosts = ["localhost:9092"]
topic = "seaweedfs_filer"

[notification.aws_sqs]
enabled = false
region = "us-east-2"
sqs_queue_name = "my_sqs_queue"

[notification.google_pub_sub]
enabled = false
project_id = ""
topic = "seaweedfs_filer_topic"
""",
    "replication": """# replication.toml (weed scaffold -config=replication)
# Consumed by `weed-tpu filer.replicate` when the corresponding flags
# are not given. Every key maps 1:1 to a flag (see -h).

[replication]
# -notify: subscription input
#   file:<path> | sqlite:<path> | kafka:<hosts>/<topic>[@offsets] |
#   sqs:<region>/<queue> | pubsub:<project>/<topic>
notify = "file:./filer.events"
# -sourceMaster / -sourceDir: cluster + subtree the events refer to
sourceMaster = "localhost:9333"
sourceDir = "/"
# -sink / -sinkDir: replication target
#   filer:<filerHost:port>@<targetMaster> | s3:<endpointUrl>/<bucket>
#   | local:<dir>
sink = "local:/data/backup"
sinkDir = "/"
# -progress: consumed-offset checkpoint file (resume-after-restart)
progress = "./replicate.progress"
""",
}


def _run_bench_ec() -> int:
    """Run the port's benchmark as `python -m` in a subprocess (the
    checkout root on its PYTHONPATH); returns its exit code."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ,
               PYTHONPATH=root if not path else root + os.pathsep + path)
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.tools.bench"],
        env=env).returncode


def main(argv: list[str] | None = None) -> int | None:
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
    if hasattr(args, "verbosity"):
        init_daemon(args)
    _discover_security_toml()
    if args.cmd == "version":
        from . import __version__
        print(f"seaweedfs_tpu_torch {__version__}")
        return
    if args.cmd == "scaffold":
        try:
            print(_SCAFFOLDS[args.config])
        except BrokenPipeError:
            os._exit(0)
        return
    if args.cmd == "bench-ec":
        return _run_bench_ec()
    offline = {"fix": _run_fix, "export": _run_export,
               "compact": _run_compact, "mount": _run_mount}
    if args.cmd in offline:
        offline[args.cmd](args)
        return
    runners = {"master": _run_master, "volume": _run_volume,
               "filer": _run_filer, "filer.copy": _run_filer_copy,
               "upload": _run_upload, "download": _run_download,
               "benchmark": _run_benchmark, "shell": _run_shell,
               "backup": _run_backup, "s3": _run_s3,
               "webdav": _run_webdav, "server": _run_server,
               "filer.replicate": _run_filer_replicate}
    try:
        asyncio.run(runners[args.cmd](args))
    except KeyboardInterrupt:
        pass
    except BrokenPipeError:
        os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
