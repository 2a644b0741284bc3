"""Needle data-plane benchmark driver, multi-worker aware.

The port of the JAX package's tools/bench_needle.py: starts a master +
volume server as real CLI processes (`python -m seaweedfs_tpu_torch.cli`,
PYTHONPATH the checkout root, the caller's environment otherwise: the
volume server runs its default -ecBackend, the GPU, unless
SWTPU_TORCH_EC_BACKEND=cpu says otherwise), runs the port's `benchmark`
client against them over real sockets, and repeats for each requested
`-workers` value so single-core regressions and multi-core scaling are
one command. Each daemon is started once its fixed port can be bound
(procutil.wait_bindable). `python -m seaweedfs_tpu_torch.tools.bench
--needle [ARG ...]` runs it too, as the JAX package's `bench.py
--needle` does.

    python -m seaweedfs_tpu_torch.tools.bench_needle        # workers 1, 2
    python -m seaweedfs_tpu_torch.tools.bench_needle 1 2 4  # a sweep
    SWTPU_TORCH_BENCH_N=20000 python -m \
        seaweedfs_tpu_torch.tools.bench_needle 1 4

and with the same module, `bench_needle`:

    bench_needle zipf 1       # Zipfian hot-read mix, cache on vs off,
                              # with needle-cache hit rate
    bench_needle batch 1      # multi-needle /batch vs single-GET A/B,
                              # zipf + uniform orders
    bench_needle trace 2      # after each run, pull /debug/traces
                              # (merged across workers) and print the
                              # per-tier latency breakdown
    bench_needle pipeline 1   # depth-8 multiplexed frame reads vs
                              # single GETs
    bench_needle hop          # deterministic sibling-hop accounting,
                              # HTTP vs frame: overhead bytes + round
                              # trips on the zipf batch mix (wall-clock
                              # stays informational)

Prints one JSON line per configuration:
    {"workers": 1, "write_rps": ..., "read_rps": ...}
zipf mode adds {"cache": "on"|"off", "reads": ..., "hit_rate": ...}
(hit rate scraped from the volume server's /metrics, summed across
workers).

Scaling expectation: each worker runs the full single-core fast path
independently behind SO_REUSEPORT, so throughput scales with PHYSICAL
cores; on a one-core host extra workers only add scheduling overhead —
run the sweep on the target host.

Env knobs (apart from the JAX package's SWTPU_BENCH_*):
SWTPU_TORCH_BENCH_N, _SIZE, _C, _READN, _BATCH, _PIPELINE and _VOLFLAGS.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from . import procutil

REPO = procutil.REPO
BASE_PORT = 21700
ENV_PREFIX = "SWTPU_TORCH_BENCH_"

_RPS = re.compile(r"^(write|read):\s+([0-9.]+) req/s", re.M)
_NEEDLES = re.compile(r"needles/s: ([0-9.]+) \(batch=(\d+)")
_PIPE = re.compile(r"needles/s: ([0-9.]+) \(pipeline=(\d+) over "
                   r"frames, (\d+) HTTP fallbacks\)")


def _wait_assign(master: str, tries: int = 60) -> None:
    for _ in range(tries):
        try:
            with urllib.request.urlopen(
                    f"http://{master}/dir/assign", timeout=3) as r:
                if b"fid" in r.read():
                    return
        except OSError:
            pass
        time.sleep(0.5)
    raise RuntimeError("cluster never became assignable")


def _needle_cache_hit_rate(vol: str) -> "tuple[float, float] | None":
    """(hits, misses) of the needle cache from /metrics (any worker
    answers for the whole host; counters are summed server-side)."""
    try:
        with urllib.request.urlopen(f"http://{vol}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
    except OSError:
        return None
    hits = misses = 0.0
    for line in body.splitlines():
        if 'cache="needle"' not in line:
            continue
        if line.startswith("SeaweedFS_cache_hits_total"):
            hits += float(line.rsplit(" ", 1)[1])
        elif line.startswith("SeaweedFS_cache_misses_total"):
            misses += float(line.rsplit(" ", 1)[1])
    return hits, misses


def bench_one(workers: int, n: int, size: int, conc: int,
              cache_mb: "int | None" = None,
              read_mode: str = "", read_n: int = 0,
              batch_size: int = 0, pipeline: int = 0,
              trace: bool = False,
              scrape_frames: bool = False,
              base_port: int = BASE_PORT,
              tmp: "str | None" = None) -> dict:
    """One configuration: a master on base_port and a volume server on
    base_port + 1 (its -workers beside it), the benchmark client against
    them; returns the row. The daemons' directories and logs
    (proc<N>.log) go into tmp, by default a fresh temporary directory,
    which is left for the logs."""
    tmp = tmp or tempfile.mkdtemp(prefix=f"swtpu_torch_bn_w{workers}_")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs: list[subprocess.Popen] = []
    master = f"127.0.0.1:{base_port}"
    vol_addr = f"127.0.0.1:{base_port + 1}"

    def spawn(*args: str) -> None:
        for port in procutil.fixed_ports(args):
            procutil.wait_bindable(port)
        log = open(os.path.join(tmp, f"proc{len(procs)}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp))

    try:
        spawn("master", "-port", str(base_port),
              "-mdir", os.path.join(tmp, "m"), "-pulseSeconds", "2")
        time.sleep(2)
        vol = ["volume", "-port", str(base_port + 1),
               "-dir", os.path.join(tmp, "v"), "-max", "50",
               "-master", master, "-pulseSeconds", "2"]
        if workers > 1:
            vol += ["-workers", str(workers)]
        if cache_mb is not None:
            vol += ["-cache.mem", str(cache_mb)]
        # extra volume-server flags, e.g. the tracing-overhead A/B:
        #   SWTPU_TORCH_BENCH_VOLFLAGS="-trace.sample 0" ... bench_needle zipf 1
        vol += os.environ.get(ENV_PREFIX + "VOLFLAGS", "").split()
        spawn(*vol)
        _wait_assign(master)
        bench = [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "benchmark",
                 "-master", master, "-n", str(n), "-size", str(size),
                 "-c", str(conc)]
        if read_mode:
            bench += ["-readMode", read_mode]
        if read_n:
            bench += ["-readN", str(read_n)]
        if batch_size:
            bench += ["-batchSize", str(batch_size)]
        if pipeline:
            bench += ["-pipeline", str(pipeline)]
        out = subprocess.run(bench, capture_output=True, text=True,
                             env=env, cwd=tmp, timeout=1800).stdout
        rates = dict(_RPS.findall(out))
        row = {"workers": workers,
               "write_rps": float(rates.get("write", 0.0)),
               "read_rps": float(rates.get("read", 0.0)),
               "n": n, "size": size, "concurrency": conc}
        if batch_size:
            m = _NEEDLES.search(out)
            if m:
                # the A/B headline: needles served per second — for
                # batch rows read_rps counts WIRE requests, not needles
                row["needles_rps"] = float(m.group(1))
                row["batch"] = int(m.group(2))
        if pipeline:
            m = _PIPE.search(out)
            if m:
                row["needles_rps"] = float(m.group(1))
                row["pipeline"] = int(m.group(2))
                row["frame_fallbacks"] = int(m.group(3))
        if read_mode:
            row["read_mode"] = read_mode
            row["reads"] = read_n or n
        if cache_mb is not None:
            row["cache"] = "off" if cache_mb == 0 else "on"
        if scrape_frames:
            # live sibling frame channel counters (whole-host /status
            # merge): every number is a plain event/byte count
            try:
                with urllib.request.urlopen(
                        f"http://{vol_addr}/status", timeout=10) as r:
                    frames = json.load(r).get("frames", {})
                agg: dict = {}
                for per_w in frames.values():
                    for chs in per_w.values():
                        for k, v in chs.items():
                            agg[k] = agg.get(k, 0) + v
                if agg:
                    row["sibling_frames"] = agg
            except (OSError, ValueError):
                pass
        hm = _needle_cache_hit_rate(vol_addr)
        if hm is not None and sum(hm) > 0:
            row["hit_rate"] = round(hm[0] / (hm[0] + hm[1]), 4)
        if trace:
            # per-tier latency breakdown from the volume fleet's span
            # ring (/debug/traces is whole-host: any worker merges its
            # siblings' rings before answering)
            from . import trace_table
            print(f"--- per-tier trace breakdown (workers={workers}) "
                  f"---", file=sys.stderr)
            print(trace_table.breakdown([vol_addr]), file=sys.stderr)
            # flight-recorder pull: force one timeline window covering
            # the run and report the health verdict (the whole-host
            # merged /debug surfaces, same fan-out as /metrics)
            try:
                req = urllib.request.Request(
                    f"http://{vol_addr}/debug/timeline?snap=1",
                    method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    tl = json.load(r)
                with urllib.request.urlopen(
                        f"http://{vol_addr}/debug/health",
                        timeout=10) as r:
                    health = json.load(r)
                # only report a verdict when an objective is armed
                # (SWTPU_TORCH_BENCH_VOLFLAGS="-slo ..."): the empty-engine
                # stub says "ok" no matter what happened, and a bench
                # row must not launder that into a health claim
                if health.get("objectives"):
                    row["health"] = health.get("status", "?")
                win = (tl.get("windows") or [{}])[-1]
                for base, q in win.get("quantiles", {}).items():
                    if "request_duration" in base and "read" in base:
                        row.setdefault("p99_s", {})[base] = q.get("p99")
                # exemplar link: the window's worst read trace id,
                # chased through the leader's cluster assembly for a
                # per-host/per-tier self-time table of THAT request
                worst = None
                for key, ex in (win.get("exemplars") or {}).items():
                    if "read" in key or "get" in key:
                        if worst is None or ex.get("dur_ms", 0) > \
                                worst.get("dur_ms", 0):
                            worst = ex
                if worst and worst.get("trace"):
                    print(f"--- cluster trace of worst read "
                          f"({worst['dur_ms']}ms) ---", file=sys.stderr)
                    print(trace_table.cluster_breakdown(
                        master, worst["trace"]), file=sys.stderr)
            except (OSError, ValueError) as e:
                print(f"(flight recorder pull failed: {e})",
                      file=sys.stderr)
        return row
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=10)
        time.sleep(1)   # workers notice the dead supervisor and exit


def hop_accounting(n_files: int = 2000, reads: int = 6000,
                   batch: int = 32, depth: int = 8,
                   seed: int = 9) -> dict:
    """Deterministic sibling-hop accounting, HTTP vs frame, on the
    zipf batch mix — every number is computed from the REAL codecs
    over a seeded workload, so two runs produce identical output (no
    wall-clock anywhere).

    Workload: `reads` zipf-ordered needle reads over `n_files` fids
    spread across both vid-parity partitions, grouped into /batch
    requests of `batch`, entering at worker 0 — each batch's odd-vid
    rows cross the sibling hop as ONE sub-request.

    Accounting per sub-request:
      * frame overhead  = the REAL encoded frame bytes minus payload
        (util/frame.encode_frame, via overhead_model);
      * HTTP overhead   = the request line + headers the HTTP hop
        sends (worker token, traceparent, aiohttp's standard headers)
        plus the raw listener's response head — same fids string on
        both sides, so the delta is pure protocol framing.

    Round trips count serialized response-waits for the single-GET
    shape of the same zipf mix: HTTP/1.1 keep-alive blocks its
    connection per request (one wait per needle); a depth-N frame
    channel overlaps N (one wait per window) — the client-pipelining
    half of the PR."""
    import random

    from ..server.workers import WORKER_HEADER
    from ..util import batchframe
    from ..util.frame import overhead_model

    rng = random.Random(seed)
    fids = [f"{(i % 10) + 1},{i:016x}35c2" for i in range(n_files)]
    ranked = list(fids)
    rng.shuffle(ranked)
    weights = [1.0 / (r + 1) ** 1.1 for r in range(len(ranked))]
    order = rng.choices(ranked, weights=weights, k=reads)
    token = "ab" * 16                 # launch tokens are 32 hex chars
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"

    http_over = frame_over = sub_requests = sib_needles = 0
    spec_bytes = 0                    # the fids string, same both sides
    for lo in range(0, len(order), batch):
        group = order[lo:lo + batch]
        sib = [f for f in group if int(f.split(",")[0]) % 2 == 1]
        if not sib:
            continue
        sub_requests += 1
        sib_needles += len(sib)
        q = ",".join(sib)
        spec_bytes += len(q)
        frame_over += overhead_model(
            "GET", "/batch", query={"fids": q},
            headers={"traceparent": tp},
            resp_headers={}, resp_ct=batchframe.CONTENT_TYPE)
        req_head = (f"GET /batch?fids={q} HTTP/1.1\r\n"
                    f"Host: 127.0.0.1:20000\r\n"
                    f"{WORKER_HEADER}: {token}\r\n"
                    f"traceparent: {tp}\r\n"
                    f"Accept: */*\r\n"
                    f"Accept-Encoding: gzip, deflate\r\n"
                    f"User-Agent: Python/3.10 aiohttp/3.8\r\n\r\n")
        resp_head = (f"HTTP/1.1 200 OK\r\n"
                     f"Content-Type: {batchframe.CONTENT_TYPE}\r\n"
                     f"Content-Length: 1048576\r\n\r\n")
        http_over += len(req_head) + len(resp_head)

    http_rts = reads                  # one blocking wait per needle
    frame_rts = -(-reads // depth)    # one wait per depth-N window
    return {
        "mode": "hop", "hop": "sibling", "reads": reads, "batch": batch,
        "sibling_sub_requests": sub_requests,
        "sibling_needles": sib_needles,
        # the fids spec rides both transports identically; protocol_*
        # rows subtract it so the framing cost itself is visible
        "fids_spec_bytes": spec_bytes,
        "http": {"overhead_bytes": http_over,
                 "per_needle": round(http_over / sib_needles, 2),
                 "protocol_per_needle": round(
                     (http_over - spec_bytes) / sib_needles, 2),
                 "single_get_round_trips": http_rts},
        "frame": {"overhead_bytes": frame_over,
                  "per_needle": round(frame_over / sib_needles, 2),
                  "protocol_per_needle": round(
                      (frame_over - spec_bytes) / sib_needles, 2),
                  "pipelined_round_trips": frame_rts,
                  "pipeline_depth": depth},
    }


def interhost_accounting(n_needles: int = 2000, depth: int = 8,
                         seed: int = 9) -> list:
    """Deterministic INTER-HOST hop accounting for the frame fabric:
    for each of the three cluster hop types the fabric carries —
    replication fan-out, client->volume single-needle reads, and
    cross-host EC shard gather — compute the per-request protocol
    bytes and the serialized round-trip waits for a seeded workload,
    frame vs HTTP, from the REAL codecs (util/frame.encode_frame on
    the frame side, the literal request/response heads aiohttp and the
    listeners emit on the HTTP side). No wall-clock anywhere: two runs
    print identical JSON.

    Also proves payload byte-identity through the frame codec: every
    needle body in the seeded corpus is encoded with encode_frame and
    re-decoded with FrameDecoder, and must come back bit-exact — the
    fabric's transport-equivalence invariant (the integration tests
    assert the same thing against live servers)."""
    import random

    from ..util.frame import (FrameDecoder, REQ, encode_frame,
                              overhead_model)

    rng = random.Random(seed)
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    fids = [f"{(i % 10) + 1},{i:016x}35c2" for i in range(n_needles)]
    sizes = [rng.randint(300, 8000) for _ in fids]

    # codec byte-identity over the corpus: encode -> decode -> compare
    dec = FrameDecoder()
    checked = 0
    for fid, size in zip(fids[:256], sizes[:256]):
        body = bytes((i * 31 + size) % 256 for i in range(size))
        wire = encode_frame(REQ, checked + 1,
                            {"m": "POST", "p": f"/{fid}"}, body)
        frames = list(dec.feed(wire))
        assert len(frames) == 1 and frames[0].payload == body, \
            f"frame codec tore payload for {fid}"
        checked += 1

    std_http_req = ("Accept: */*\r\n"
                    "Accept-Encoding: gzip, deflate\r\n"
                    "User-Agent: Python/3.10 aiohttp/3.8\r\n")
    resp_head_json = ("HTTP/1.1 200 OK\r\n"
                      "Content-Type: application/json\r\n"
                      "Content-Length: 64\r\n\r\n")

    def http_req_head(method: str, path_q: str,
                      extra: str = "", blen: int = 0) -> int:
        head = (f"{method} {path_q} HTTP/1.1\r\n"
                f"Host: 127.0.0.1:20000\r\n"
                f"traceparent: {tp}\r\n" + extra + std_http_req)
        if blen:
            head += (f"Content-Length: {blen}\r\n"
                     f"Content-Type: application/octet-stream\r\n")
        return len(head + "\r\n")

    rows = []

    def account(hop_type: str, frame_over: int, http_over: int,
                n_reqs: int) -> None:
        # HTTP/1.1 keep-alive serializes one response wait per
        # request; a depth-N frame channel overlaps N
        rows.append({
            "mode": "hop", "hop": "interhost", "type": hop_type,
            "requests": n_reqs,
            "http": {"overhead_bytes": http_over,
                     "per_needle": round(http_over / n_reqs, 2),
                     "round_trips": n_reqs},
            "frame": {"overhead_bytes": frame_over,
                      "per_needle": round(frame_over / n_reqs, 2),
                      "round_trips": -(-n_reqs // depth),
                      "pipeline_depth": depth},
        })

    # 1. replication fan-out: POST /<fid>?type=replicate, raw needle
    #    body, X-Raw-Needle marker (server/volume_server._replicate)
    f_over = h_over = 0
    for fid, size in zip(fids, sizes):
        f_over += overhead_model(
            "POST", f"/{fid}", query={"type": "replicate"},
            headers={"x-raw-needle": "1", "traceparent": tp},
            resp_headers={}, resp_ct="application/json")
        h_over += http_req_head(
            "POST", f"/{fid}?type=replicate",
            extra="X-Raw-Needle: 1\r\n", blen=size)
        h_over += len(resp_head_json)
    account("replication_fanout", f_over, h_over, len(fids))

    # 2. client->volume whole-needle read: GET /<fid>
    #    (util/client._read_stream_net's frame fast path)
    f_over = h_over = 0
    for fid in fids:
        f_over += overhead_model(
            "GET", f"/{fid}", headers={"traceparent": tp},
            resp_headers={"Etag": "35c2"},
            resp_ct="application/octet-stream")
        h_over += http_req_head("GET", f"/{fid}")
        h_over += len("HTTP/1.1 200 OK\r\n"
                      "Content-Type: application/octet-stream\r\n"
                      "Etag: \"35c2\"\r\n"
                      "Accept-Ranges: bytes\r\n"
                      "Content-Length: 4096\r\n\r\n")
    account("client_read", f_over, h_over, len(fids))

    # 3. cross-host EC shard gather: GET /admin/ec/shard_read with
    #    volume/shard/offset/size (server/volume_server._sync_shard_fetch)
    f_over = h_over = 0
    gathers = [(rng.randint(1, 10), rng.randint(0, 13),
                rng.randrange(0, 1 << 30, 4096),
                rng.choice((4096, 65536)))
               for _ in range(n_needles)]
    for vid, shard, off, size in gathers:
        q = {"volume": str(vid), "shard": str(shard),
             "offset": str(off), "size": str(size)}
        f_over += overhead_model(
            "GET", "/admin/ec/shard_read", query=q,
            headers={"traceparent": tp}, resp_headers={},
            resp_ct="application/octet-stream")
        qs = "&".join(f"{k}={v}" for k, v in q.items())
        h_over += http_req_head("GET", f"/admin/ec/shard_read?{qs}")
        h_over += len("HTTP/1.1 200 OK\r\n"
                      "Content-Type: application/octet-stream\r\n"
                      "Content-Length: 65536\r\n\r\n")
    account("ec_shard_gather", f_over, h_over, len(gathers))

    for row in rows:
        row["codec_payloads_checked"] = checked
    return rows


def _env(name: str, default: str) -> int:
    return int(os.environ.get(ENV_PREFIX + name, default))


def main(argv: "list[str] | None" = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    zipf = "zipf" in args
    batch = "batch" in args
    pipeline = "pipeline" in args
    hop = "hop" in args
    trace = "trace" in args
    sweep = [int(a) for a in args if a.isdigit()] or (
        [1] if zipf or batch else [1, 2])
    n = _env("N", "10000")
    size = _env("SIZE", "1024")
    conc = _env("C", "64")
    if hop:
        # deterministic sibling-hop accounting (the acceptance gate:
        # frames strictly cheaper per needle, fewer round trips) ...
        acct = hop_accounting()
        print(json.dumps(acct), flush=True)
        assert acct["frame"]["overhead_bytes"] < \
            acct["http"]["overhead_bytes"], "frame overhead not lower"
        assert acct["frame"]["pipelined_round_trips"] < \
            acct["http"]["single_get_round_trips"], \
            "frame round trips not fewer"
        # ... the INTER-HOST fabric hops under the same gate: on every
        # hop type the frame wire must be strictly cheaper per needle
        # AND serialize strictly fewer round-trip waits at depth 8,
        # with payload byte-identity proven through the real codec
        for row in interhost_accounting():
            print(json.dumps(row), flush=True)
            assert row["frame"]["overhead_bytes"] < \
                row["http"]["overhead_bytes"], \
                f"{row['type']}: frame overhead not lower"
            assert row["frame"]["round_trips"] < \
                row["http"]["round_trips"], \
                f"{row['type']}: frame round trips not fewer"
            assert row["codec_payloads_checked"] > 0
        # ... plus one LIVE -workers 2 zipf batch run: wall-clock
        # informational (±2x container band, PERF_JAX.md round 8), the
        # scraped sibling frame channel counters are the real-wire
        # confirmation of the model
        read_n = _env("READN", str(2 * n))
        print(json.dumps(bench_one(
            2, n, size, conc, cache_mb=32, read_mode="zipf",
            read_n=read_n, batch_size=32, trace=trace,
            scrape_frames=True)), flush=True)
        return
    if pipeline:
        # round-12 A/B: depth-8 multiplexed frame reads vs single
        # GETs over the same zipf order, cache on
        read_n = _env("READN", str(3 * n))
        depth = _env("PIPELINE", "8")
        for w in sweep:
            for d in (depth, 0):
                print(json.dumps(bench_one(
                    w, n, size, conc, cache_mb=32,
                    read_mode="zipf", read_n=read_n,
                    pipeline=d, trace=trace)), flush=True)
        return
    if batch:
        # round-9 A/B: multi-needle /batch vs single GET, zipf +
        # uniform read orders, cache on (the production shape)
        read_n = _env("READN", str(3 * n))
        bs = _env("BATCH", "32")
        for w in sweep:
            for mode in ("zipf", "shuffle"):
                for bsz in (bs, 0):
                    print(json.dumps(bench_one(
                        w, n, size, conc, cache_mb=32,
                        read_mode=mode, read_n=read_n,
                        batch_size=bsz, trace=trace)), flush=True)
        return
    if zipf:
        # Zipfian hot-read mix, 3 reads per written needle: the cache-on
        # vs cache-off rows are the BENCH_NEEDLE.md comparison
        read_n = _env("READN", str(3 * n))
        for w in sweep:
            for cache_mb in (32, 0):
                print(json.dumps(bench_one(
                    w, n, size, conc, cache_mb=cache_mb,
                    read_mode="zipf", read_n=read_n,
                    trace=trace)), flush=True)
        return
    for w in sweep:
        print(json.dumps(bench_one(w, n, size, conc, trace=trace)),
              flush=True)


if __name__ == "__main__":
    main()
