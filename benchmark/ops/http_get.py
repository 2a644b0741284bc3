"""GETs of parts over HTTP from a volume server of a cluster: the
server `ec.encode` spread each volume's shards from, with one of its
peers lost, so that every recover fetches most of its survivors from the
peers that are left (`benchmark/cluster.py`).

A closed loop, as `ops/get.py`'s: each of "clients" threads sends its
next `GET /<vid>,<fid>` over its own keep-alive connection when its last
returns, for a part drawn uniformly at random, each GET timed from the
request to the last byte of its body. Every GET goes to the card's
server. In a traced run each GET opens the `bench`/`get` root span and
sends its `traceparent`, so the server's and its peers' spans join the
GET's trace.

The check holds every sampled body to the bytes the set-up wrote, as
`ops/get.py`'s does, and decodes 8 of the sampled parts with the plain
reference (`benchmark/reference/ec_rs.py`) from the live servers' shard
files, on the cell's device.
"""

from __future__ import annotations

import http.client
import os
import threading
import time
from dataclasses import dataclass, field

from .. import cluster, data, roofline
from .get import Keys, Reservoir, parts_of

# the seed's stream that draws the parts the reference decodes
STREAM_REFERENCE = 4
REFERENCE_PARTS = 8
FETCHES = "SeaweedFS_ec_fetches_total"
FETCH_BYTES = "SeaweedFS_ec_fetch_bytes_total"
TRANSPORTS = ("frame", "http")
GET_TIMEOUT_S = 120.0


@dataclass
class Outcome:
    # (start, end, ok, part index) of every GET, by the host's clock
    requests: list = field(default_factory=list)
    samples: list = field(default_factory=list)     # (part index, bytes)
    wrong_sizes: int = 0
    errors: list = field(default_factory=list)
    # the program's fetch counters over the window, by transport (None
    # where the program has no such counter)
    fetches: dict = field(default_factory=dict)
    fetch_bytes: dict = field(default_factory=dict)
    launches: int = 0            # K1 launches in the window
    # bytes the live peers' stores served to shard reads in the window
    peer_bytes: int = 0
    # vid -> {shard id: path} of the live servers' shard files
    survivors: dict = field(default_factory=dict)
    ecx: dict = field(default_factory=dict)         # vid -> .ecx path

    def in_window(self, t0: float, t1: float) -> list:
        return [r for r in self.requests if t0 <= r[1] <= t1]


class Client:
    """One keep-alive HTTP connection to the card's server."""

    def __init__(self, url: str):
        host, _, port = url.rpartition(":")
        self.conn = http.client.HTTPConnection(host, int(port),
                                               timeout=GET_TIMEOUT_S)

    def get(self, part, traced: bool) -> bytes:
        from seaweedfs_tpu_torch.util import tracing
        path = f"/{part.vid},{part.nid:x}{part.cookie:08x}"
        if not traced:
            return self._get(path, {})
        with tracing.start_root("bench", "get") as sp:
            return self._get(path, {"traceparent": sp.traceparent()})

    def _get(self, path: str, headers: dict) -> bytes:
        try:
            self.conn.request("GET", path, headers=headers)
            r = self.conn.getresponse()
            body = r.read()
        except (OSError, http.client.HTTPException):
            self.conn.close()
            raise
        if r.status != 200:
            raise RuntimeError(f"GET {path}: status {r.status}: "
                               f"{body[:200]!r}")
        return body

    def close(self) -> None:
        self.conn.close()


def _counter(attr: str, name: str, **labels) -> float | None:
    """A counter's value in the port's registry (`stats/metrics.py`):
    None where the program registers no such counter, 0 where no sample
    has the labels yet."""
    from seaweedfs_tpu_torch.stats import metrics
    if not metrics.HAVE_PROMETHEUS or not hasattr(metrics, attr):
        return None
    return metrics.REGISTRY.get_sample_value(name, labels) or 0.0


def _counters() -> dict:
    return {(n, t): _counter(attr, n, transport=t)
            for attr, n in (("EC_FETCHES", FETCHES),
                            ("EC_FETCH_BYTES", FETCH_BYTES))
            for t in TRANSPORTS}


def _delta(a, b) -> float | None:
    if a is None or b is None:
        return None
    return b - a


class PeerBytes:
    """Counts the bytes the live peers' stores serve to shard reads, a
    count of the peers' work that needs nothing of the program's own
    counters."""

    def __init__(self, servers: list):
        self.lock = threading.Lock()
        self.total = 0
        self.undo = []
        for s in servers:
            store = s.vs.store
            read = store.read_ec_shard_intervals

            def counted(vid, reads, read=read):
                out = read(vid, reads)
                n = sum(len(d) for d in out if d is not None)
                with self.lock:
                    self.total += n
                return out
            store.read_ec_shard_intervals = counted
            self.undo.append(store)

    def remove(self) -> None:
        for store in self.undo:
            del store.read_ec_shard_intervals


def warm(cell) -> None:
    """Start the cluster, spread the shards, lose one server, then GET
    every part once over the cell's clients at once."""
    cfg = cell.cfg
    store = cell.built.store
    source_dir = store.dirs[0]
    store.close()
    dep = cluster.Deployment()
    cell.deployment = dep
    try:
        dep.start(cfg, source_dir, os.path.join(source_dir, "cluster"),
                  "gpu" if str(cell.device).startswith("cuda") else "cpu",
                  [p.vid for p in cell.built.plans])
        # the card's server is the set-up's store from here on: the
        # faults of benchmark/faults.py are put into it
        cell.built.store = dep.source.vs.store
        cell.built.split.update(dep.split)
        t = time.perf_counter()
        _warm_gets(cell, dep.source.vs.url)
        cell.built.split["warm_gets_s"] = time.perf_counter() - t
    except BaseException:
        dep.stop()
        raise


def _warm_gets(cell, url: str) -> None:
    parts = parts_of(cell)
    clients = int(cell.traffic["clients"])
    errs: list = []

    def run(c: int) -> None:
        client = Client(url)
        try:
            for p in parts[c::clients]:
                body = client.get(p, False)
                if len(body) != p.size:
                    raise RuntimeError(f"warm-up GET of needle {p.nid}: "
                                       f"{len(body)} bytes, not {p.size}")
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errs.append(e)
        finally:
            client.close()

    ts = [threading.Thread(target=run, args=(c,), daemon=True)
          for c in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


def window(cell, clock) -> Outcome:
    """Drive the window: GETs start until clock.close and each one
    started runs to its end. The cluster is stopped once every GET has
    returned. K1's launches are counted over the window as `ops/get.py`
    counts them: the peers recover nothing, so all are the source's."""
    dep = cell.deployment
    try:
        return _window(cell, clock, dep)
    finally:
        dep.stop()


def _window(cell, clock, dep) -> Outcome:
    from seaweedfs_tpu_torch.ops import gf256_cuda
    traffic = cell.traffic
    parts = parts_of(cell)
    out = Outcome()
    lock = threading.Lock()
    traced = cell.trace
    clients = int(traffic["clients"])
    per = max(1, int(traffic["samples"]) // clients)
    kept: list[Reservoir] = []
    url = dep.source.vs.url

    def client(c: int) -> None:
        keys = Keys(len(parts), data.rng(cell.seed, data.STREAM_CLIENT, c))
        sample = Reservoir(per, data.rng(cell.seed, data.STREAM_SAMPLE, c))
        conn = Client(url)
        with lock:
            kept.append(sample)
        clock.go.wait()
        try:
            while True:
                t_start = time.perf_counter()
                if t_start >= clock.close:
                    return
                i = next(keys)
                p = parts[i]
                ok, body, err = True, None, None
                try:
                    body = conn.get(p, traced)
                except Exception as e:  # noqa: BLE001 — a failed GET counts
                    ok, err = False, repr(e)
                t_end = time.perf_counter()
                if ok and len(body) == p.size:
                    sample.offer((i, body))
                with lock:
                    out.requests.append((t_start, t_end, ok, i))
                    if err is not None and len(out.errors) < 8:
                        out.errors.append(err)
                    if ok and len(body) != p.size:
                        out.wrong_sizes += 1
        finally:
            conn.close()

    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(clients)]
    for t in ts:
        t.start()
    peers = PeerBytes([s for s in dep.servers[1:] if s.live])
    try:
        before = _counters()
        launched = gf256_cuda.launches
        clock.start()
        clock.wait_close()
        out.launches = gf256_cuda.launches - launched
        clock.closed()
        for t in ts:
            t.join()
        after = _counters()
    finally:
        peers.remove()
    out.peer_bytes = peers.total
    for t in TRANSPORTS:
        out.fetches[t] = _delta(before[(FETCHES, t)], after[(FETCHES, t)])
        out.fetch_bytes[t] = _delta(before[(FETCH_BYTES, t)],
                                    after[(FETCH_BYTES, t)])
    out.samples = [s for r in kept for s in r.kept]
    for p in cell.built.plans:
        out.survivors[p.vid] = dep.survivors(p.vid)
        out.ecx[p.vid] = dep.source.vs.store.ec_volumes[p.vid].base_name \
            + ".ecx"
    return out


def k1_bytes(run) -> float | None:
    """HBM bytes of the card's recovers in the traced window: each
    `ec.recover` span with `path` "card" ran K1 on 10 survivor rows of L
    bytes into its `rows` lost rows, (10 + rows) x L."""
    if run.spans is None:
        return None
    lo, hi = run.clock.trace_wall
    k = run.cell.cfg["data_shards"]
    total = 0
    for s in run.spans:
        a = s.get("attrs") or {}
        if s["tier"] == "ec" and s["op"] == "recover" \
                and a.get("path") == "card" and a.get("rows") \
                and lo <= s["start_ms"] / 1e3 \
                and s["start_ms"] / 1e3 + s["dur_ms"] / 1e3 <= hi:
            total += roofline.transform_bytes(k, a["rows"],
                                              s["bytes"] // a["rows"])
    return float(total) or None


def reference_mismatches(cell, out: Outcome) -> int:
    """Of 8 sampled parts drawn from the seed, how many the plain
    reference, decoding from the live servers' shard files on the cell's
    device, does not return as the bytes the seed wrote."""
    from ..reference import ec_rs
    parts = parts_of(cell)
    if not out.samples:
        return 0
    r = data.rng(cell.seed, STREAM_REFERENCE)
    pick = r.choice(len(out.samples), min(REFERENCE_PARTS, len(out.samples)),
                    replace=False)
    bad = 0
    for j in sorted(int(x) for x in pick):
        p = parts[out.samples[j][0]]
        want = cell.built.buffers[p.vid][p.start:p.start + p.size]
        try:
            got = ec_rs.decode_needle(
                out.survivors[p.vid], out.ecx[p.vid], p.nid,
                device=cell.device,
                large_block=cell.cfg["large_block_bytes"],
                small_block=cell.cfg["small_block_bytes"])
        except (OSError, ValueError, KeyError):
            got = None
        if got != want.tobytes():
            bad += 1
    return bad


def check(cell, out: Outcome) -> dict:
    """The numbers `correct` is judged by, each with its limit."""
    parts = parts_of(cell)
    mismatched = 0
    for i, body in out.samples:
        p = parts[i]
        want = cell.built.buffers[p.vid][p.start:p.start + p.size]
        if body != want.tobytes():
            mismatched += 1
    failed = sum(1 for r in out.requests if not r[2])
    fetched = [v for v in out.fetch_bytes.values() if v is not None]
    # where the program counts no fetched bytes (before the counters
    # existed), the peers' stores say whether they served any
    peers_idle = (sum(fetched) <= 0) if fetched else out.peer_bytes <= 0
    return {"failed_gets": (failed, 0),
            "wrong_sizes": (out.wrong_sizes, 0),
            "mismatched_parts": (mismatched, 0),
            "no_parts_compared": (int(not out.samples), 0),
            "reference_mismatches": (reference_mismatches(cell, out), 0),
            "no_remote_fetches": (int(peers_idle), 0)}
