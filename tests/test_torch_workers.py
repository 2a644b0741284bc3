"""-workers N process-per-core data plane of the port (server/workers.py
and the supervisor of seaweedfs_tpu_torch/cli.py).

The in-process cases of tests/test_workers.py (store partitioning,
WorkerContext state files, the prometheus merge, the worker route
middleware) and its `volume -workers 2` wire case, pointed at the port:
`python -m seaweedfs_tpu_torch.cli volume -workers 2 -ecBackend cpu`
behind one SO_REUSEPORT port, under the JAX package's master run in
this process on port 0. The fleet's port is one found free, and every
wait is a bounded loop on readiness, never a fixed sleep or a fixed
port. The master-side cases (seq lease, assign accelerator, `master
-workers`) run on the port's master in tests/test_torch_master_workers.py.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_cluster_util import Cluster, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# in-proc units


def test_store_partition_filters_ownership(tmp_path):
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import VolumeError
    d = str(tmp_path)
    full = Store([d], max_volume_counts=[8])
    for vid in (1, 2, 3, 4):
        full.add_volume(vid)
    full.close()

    s0 = Store([d], partition=(0, 2))
    s1 = Store([d], partition=(1, 2))
    try:
        assert sorted(s0.volumes) == [2, 4]
        assert sorted(s1.volumes) == [1, 3]
        assert s0.owns(6) and not s0.owns(7)
        with pytest.raises(VolumeError):
            s0.add_volume(5)          # 5 % 2 == 1: not worker 0's
        with pytest.raises(VolumeError):
            s1.mount_volume("", 2)
        # the slot budget is split so the master never sees N x capacity
        hb0 = s0.collect_heartbeat()
        hb1 = s1.collect_heartbeat()
        assert hb0.max_volume_count + hb1.max_volume_count == 8
    finally:
        s0.close()
        s1.close()


def test_worker_context_state_files(tmp_path):
    from seaweedfs_tpu_torch.server.workers import WorkerContext
    a = WorkerContext(0, 2, 8080, str(tmp_path), token="secret")
    b = WorkerContext(1, 2, 8080, str(tmp_path), token="secret")
    a.write_state(ip="127.0.0.1", port=4001, role="volume")
    b.write_state(ip="127.0.0.1", port=4002, role="volume")
    assert a.owns(2) and not a.owns(3)
    assert b.sibling_addr(0) == "127.0.0.1:4001"
    assert a.owner_addr(3) == "127.0.0.1:4002"
    assert a.token_ok("secret") and not a.token_ok("wrong")
    assert not a.token_ok(None)
    states = a.all_states()
    assert [s["port"] for s in states] == [4001, 4002]


def test_merge_metrics_texts():
    from seaweedfs_tpu_torch.stats.metrics import merge_metrics_texts
    t1 = (b"# HELP w writes\n# TYPE w counter\n"
          b'w_total{op="write"} 3.0\nvols 2.0\nw_created 100.0\n'
          b"w_ratio 0.25\n")
    t2 = (b"# HELP w writes\n# TYPE w counter\n"
          b'w_total{op="write"} 4.0\nvols 5.0\nw_created 90.0\n'
          b"w_ratio 0.5\n")
    merged = merge_metrics_texts([t1, t2]).decode()
    # integral sums render as plain integers (no `.0`, no exponent)
    assert 'w_total{op="write"} 7\n' in merged
    assert "vols 7\n" in merged
    assert "w_created 90\n" in merged          # min, not sum
    assert "w_ratio 0.75" in merged            # fractions keep precision
    assert merged.count("# HELP w writes") == 1


def test_worker_route_middleware_in_proc(tmp_path):
    """Two in-proc volume servers partitioned 2 ways on one store dir:
    a needle owned by worker 1 written/read THROUGH worker 0 is proxied
    (fast path replays into aiohttp, middleware hops to the sibling)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.server.workers import WorkerContext
    from seaweedfs_tpu_torch.storage.store import Store

    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            state_dir = str(tmp_path / "wstate")
            d = str(tmp_path / "wdata")
            workers = []
            for i in range(2):
                ctx = WorkerContext(i, 2, 0, state_dir, token="tok")
                store = Store([os.path.join(d)], max_volume_counts=[8],
                              partition=(i, 2))
                vs = VolumeServer(store, c.master.url, port=0,
                                  pulse_seconds=0.2, worker_ctx=ctx)
                await vs.start()
                ctx.public_port = vs.port  # irrelevant for this test
                await vs.heartbeat_once()
                workers.append(vs)
            try:
                # volume 3 is owned by worker 1 (3 % 2)
                workers[1].store.add_volume(3)
                await workers[1].heartbeat_once()
                fid = "3,0101deadbe"
                # write through worker 0 -> proxied to worker 1
                st, out = await c.put(fid, workers[0].url, b"hop")
                assert st == 201, out
                assert 3 in workers[1].store.volumes
                n = workers[1].store.read_needle(3, 0x01)
                assert n.data == b"hop"
                # read back through worker 0 too
                st, got = await c.get(fid, workers[0].url)
                assert st == 200 and got == b"hop"
                # and directly from the owner
                st, got = await c.get(fid, workers[1].url)
                assert st == 200 and got == b"hop"
                # batch delete THROUGH the non-owner splits by owner
                async with c.http.post(
                        f"http://{workers[0].url}/admin/batch_delete",
                        json={"fileIds": [fid]}) as resp:
                    rows = (await resp.json())["results"]
                assert rows[0]["status"] == 202, rows
            finally:
                for vs in workers:
                    await vs.stop()
    run(body())



def test_worker_registers_only_once_its_siblings_listen(tmp_path,
                                                        monkeypatch):
    """A -workers worker holds its first heartbeat until every sibling
    listens, so the master never offers the fleet while a worker that
    must take half its vids is still starting (under load the drivers'
    smokes grew volumes through the first worker and it answered 500
    for the sibling's). A sibling that never comes up holds it
    SIBLING_START_S at most."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.server.workers import WorkerContext
    from seaweedfs_tpu_torch.storage.store import Store

    def node_count(c) -> int:
        return len(list(c.master.topo.all_nodes()))

    async def body():
        async with Cluster(str(tmp_path), n_servers=0) as c:
            state_dir = str(tmp_path / "wstate")
            workers = []

            async def start(i: int) -> VolumeServer:
                ctx = WorkerContext(i, 2, 0, state_dir, token="tok")
                store = Store([str(tmp_path / f"w{i}")],
                              max_volume_counts=[8], partition=(i, 2))
                vs = VolumeServer(store, c.master.url, port=0,
                                  pulse_seconds=0.2, worker_ctx=ctx)
                await vs.start()
                workers.append(vs)
                return vs

            try:
                await start(0)
                await asyncio.sleep(1.5)
                # worker 1 not started: worker 0 has not registered
                assert node_count(c) == 0
                await start(1)
                for _ in range(50):
                    if node_count(c) == 2:
                        break
                    await asyncio.sleep(0.1)
                assert node_count(c) == 2
            finally:
                for vs in workers:
                    await vs.stop()

        # a sibling that never starts holds the first heartbeat only
        # SIBLING_START_S
        monkeypatch.setattr(VolumeServer, "SIBLING_START_S", 0.5)
        async with Cluster(str(tmp_path / "b"), n_servers=0) as c:
            ctx = WorkerContext(0, 2, 0, str(tmp_path / "bstate"),
                                token="tok")
            store = Store([str(tmp_path / "b0")], max_volume_counts=[8],
                          partition=(0, 2))
            vs = VolumeServer(store, c.master.url, port=0,
                              pulse_seconds=0.2, worker_ctx=ctx)
            await vs.start()
            try:
                for _ in range(50):
                    if node_count(c) == 1:
                        break
                    await asyncio.sleep(0.1)
                assert node_count(c) == 1
            finally:
                await vs.stop()
    run(body())

def test_multipart_write_through_a_sibling_is_parsed(tmp_path):
    """A multipart upload of a needle owned by worker 1, written through
    worker 0, is parsed like one written to the owner: the sibling hop
    falls back from the frame channel to HTTP for it, instead of storing
    the raw multipart body as the needle (the reference's frame hop
    does)."""
    import aiohttp
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.server.workers import WorkerContext
    from seaweedfs_tpu_torch.storage.store import Store

    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            state_dir = str(tmp_path / "wstate")
            d = str(tmp_path / "wdata")
            workers = []
            for i in range(2):
                ctx = WorkerContext(i, 2, 0, state_dir, token="tok")
                store = Store([d], max_volume_counts=[8], partition=(i, 2))
                vs = VolumeServer(store, c.master.url, port=0,
                                  pulse_seconds=0.2, worker_ctx=ctx)
                await vs.start()
                ctx.public_port = vs.port
                workers.append(vs)
            try:
                workers[1].store.add_volume(3)
                for nid, via in ((1, 0), (2, 1), (3, 0)):
                    data = f"multipart needle {nid}".encode() * 50
                    form = aiohttp.FormData()
                    form.add_field("file", data, filename=f"f{nid}.txt",
                                   content_type="text/plain")
                    fid = f"3,{nid:02x}deadbeef"
                    async with c.http.post(
                            f"http://{workers[via].url}/{fid}",
                            data=form) as resp:
                        assert resp.status == 201, await resp.text()
                    n = workers[1].store.read_needle(3, nid)
                    assert (n.data, n.name, n.mime) == (
                        data, f"f{nid}.txt".encode(), b"text/plain")
                    for vs in workers:
                        st, got = await c.get(fid, vs.url)
                        assert st == 200 and got == data
            finally:
                for vs in workers:
                    await vs.stop()
    run(body())


# ---------------------------------------------------------------------------
# wire-level subprocess fleet


def _get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _post(url: str, data: bytes, timeout: float = 10.0) -> bytes:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _wait(fn, tries: int = 50, delay: float = 0.3):
    last = None
    for _ in range(tries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — startup polling
            last = e
            time.sleep(delay)
    raise AssertionError(f"never became ready: {last}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Master:
    """The JAX package's MasterServer on port 0, on an event loop of its
    own in a thread of this process."""

    def __init__(self, meta_dir: str):
        self.meta_dir = meta_dir
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.server = None

    def __enter__(self) -> "_Master":
        from seaweedfs_tpu.master.server import MasterServer
        self.thread.start()

        async def start():
            m = MasterServer(port=0, meta_dir=self.meta_dir,
                             volume_size_limit_mb=8, pulse_seconds=1)
            await m.start()
            return m

        self.server = asyncio.run_coroutine_threadsafe(
            start(), self.loop).result(timeout=60)
        return self

    def __exit__(self, *exc) -> None:
        if self.server is not None:
            asyncio.run_coroutine_threadsafe(
                self.server.stop(), self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.loop.close()

    @property
    def port(self) -> int:
        return self.server.port


class _Fleet:
    """The reference master in process + the port's `volume -workers N`
    as a CLI subprocess on a free port."""

    def __init__(self, tmp: str, workers: int = 2):
        self.tmp = tmp
        self.workers = workers
        self.master = _Master(os.path.join(tmp, "m"))
        self.mport = 0
        self.vport = free_port()
        self.procs: list[subprocess.Popen] = []
        self.env = {k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH"}
        self.env["OMP_NUM_THREADS"] = "1"

    def __enter__(self) -> "_Fleet":
        self.master.__enter__()
        self.mport = self.master.port
        log = open(os.path.join(self.tmp, "volume.log"), "w")
        self.procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume",
             "-port", str(self.vport), "-dir", os.path.join(self.tmp, "v"),
             "-max", "20", "-master", f"127.0.0.1:{self.mport}",
             "-pulseSeconds", "1", "-workers", str(self.workers),
             "-ecBackend", "cpu"],
            stdout=log, stderr=subprocess.STDOUT, env=self.env, cwd=REPO))
        log.close()
        try:
            _wait(lambda: json.loads(_get(
                f"http://127.0.0.1:{self.mport}/dir/assign"))["fid"],
                tries=300)
            # both workers registered (state files + live pids)
            _wait(lambda: self.all_alive()
                  or (_ for _ in ()).throw(AssertionError("workers")),
                  tries=300)
            # each worker finds its siblings (a worker caches a sibling's
            # missing state file for STATE_TTL after its own start, and
            # answers 503 for the sibling's volumes until then)
            _wait(lambda: self.siblings_known()
                  or (_ for _ in ()).throw(AssertionError("siblings")),
                  tries=300)
            # and both known to the master: a grow placed while the
            # topology holds one worker asks it for a volume the other
            # owns
            _wait(lambda: len(self.topology_nodes()) == self.workers
                  or (_ for _ in ()).throw(AssertionError("nodes")),
                  tries=300)
        except BaseException:
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc) -> None:
        # worker pids come from the on-disk state files, captured before
        # the fleet dies
        pids: list[int] = []
        state_dir = os.path.join(self.tmp, "v", ".workers")
        try:
            for fn in os.listdir(state_dir):
                if not fn.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(state_dir, fn)) as f:
                        pid = json.load(f).get("pid")
                except (OSError, ValueError):
                    continue
                if pid:
                    pids.append(int(pid))
        except OSError:
            pass
        # and the supervisor's children, a worker still starting (no state
        # file yet) among them
        for p in self.procs:
            out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(p.pid)],
                                 capture_output=True, text=True).stdout
            pids += [int(x) for x in out.split()]
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in self.procs:
            p.wait(timeout=10)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        for pid in pids:
            for _ in range(40):
                try:
                    os.kill(pid, 0)
                except OSError:
                    break
                time.sleep(0.1)
        self.master.__exit__()

    def worker_rows(self) -> list[dict]:
        try:
            return json.loads(_get(
                f"http://127.0.0.1:{self.vport}/stats/workers",
                timeout=3))["workers"]
        except Exception:  # noqa: BLE001
            return []

    def all_alive(self) -> bool:
        rows = self.worker_rows()
        return len(rows) == self.workers and all(w["alive"] for w in rows)

    def siblings_known(self) -> bool:
        """Every worker's private listener routes a volume another worker
        owns instead of answering 503 for it."""
        for row in self.worker_rows():
            vid = self.workers + (row["index"] + 1) % self.workers
            try:
                _get(f"http://{row['ip']}:{row['port']}/admin/volume/"
                     f"status?volume={vid}", timeout=3)
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    return False
        return True

    def topology_nodes(self) -> list[dict]:
        topo = json.loads(_get(
            f"http://127.0.0.1:{self.mport}/dir/status"))["topology"]
        return [n for dc in topo["datacenters"] for rack in dc["racks"]
                for n in rack["nodes"]]

    def assign(self, **params) -> dict:
        q = "&".join(f"{k}={v}" for k, v in params.items())
        return json.loads(_get(
            f"http://127.0.0.1:{self.mport}/dir/assign"
            + (f"?{q}" if q else "")))


def test_volume_workers_wire(tmp_path):
    """The acceptance scenario: -workers 2 serves the shared port —
    owned and sibling-owned needles both round-trip through it, stats
    stay whole-host, and a killed worker is respawned and serves
    again."""
    with _Fleet(str(tmp_path)) as f:
        shared = f"http://127.0.0.1:{f.vport}"
        # grow several volumes so BOTH partitions (vid % 2) own some
        _get(f"http://127.0.0.1:{f.mport}/vol/grow?count=3")
        payloads: dict[str, bytes] = {}
        for i in range(24):
            a = f.assign()
            data = f"needle-{i}".encode() * (i % 5 + 1)
            _post(f"http://{a['url']}/{a['fid']}", data)
            payloads[a["fid"]] = data
        vids = {int(fid.split(",")[0]) for fid in payloads}
        rows = _wait(lambda: [r for r in f.worker_rows()
                              if r.get("volumes")] and f.worker_rows())
        # every needle reads back through the SHARED port, whichever
        # worker accepts the connection (sibling proxy covers the rest)
        for fid, want in payloads.items():
            assert _get(f"{shared}/{fid}") == want
        # raw keep-alive pipelining through the shared port: one
        # connection (= one worker), POST + 2 GETs, with the needle
        # owned by EITHER partition — responses must stay in sequence
        # whether served locally or via the sibling proxy
        async def pipelined(fid: str, data: bytes) -> bytes:
            r, w = await asyncio.open_connection("127.0.0.1", f.vport)
            host = f"127.0.0.1:{f.vport}"
            blob = (
                f"POST /{fid} HTTP/1.1\r\nHost: {host}\r\n"
                f"Content-Length: {len(data)}\r\n\r\n".encode() + data
                + f"GET /{fid} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode()
                + f"GET /{fid} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
            w.write(blob)
            await w.drain()
            out = b""
            # proxied responses stream headers and body in separate
            # writes: read until both GET bodies fully arrived, not
            # just until the third status line shows up
            while out.count(b"HTTP/1.1 ") < 3 or out.count(data) < 2:
                try:
                    chunk = await asyncio.wait_for(r.read(65536), 10)
                except asyncio.TimeoutError:
                    break
                if not chunk:
                    break
                out += chunk
            w.close()
            return out

        for parity in (0, 1):
            a = _wait(lambda p=parity: [x for x in (f.assign(),)
                      if int(x["fid"].split(",")[0]) % 2 == p][0],
                      tries=60, delay=0.1)
            data = f"pipelined-{parity}".encode()
            out = asyncio.run(pipelined(a["fid"], data))
            assert out.count(b"HTTP/1.1 201 ") == 1, out[:200]
            assert out.count(b"HTTP/1.1 200 ") == 2
            assert out.count(data) == 2
            payloads[a["fid"]] = data

        # whole-host status: all vids visible via one worker
        st = json.loads(_get(f"{shared}/status"))
        assert st.get("workers") == 2
        assert {m["id"] for m in st["volumes"]} >= vids
        # aggregated metrics count every write, not one worker's share
        metrics = _get(f"{shared}/metrics").decode()
        wrote = [ln for ln in metrics.splitlines()
                 if ln.startswith("SeaweedFS_volumeServer_request_total")
                 and 'type="write"' in ln and 'status="ok"' in ln]
        assert wrote and float(wrote[0].rsplit(" ", 1)[1]) >= \
            len(payloads)

        # ---- crash -> respawn -> serve again ----
        victim = [r for r in f.worker_rows() if r["index"] == 1][0]
        os.kill(victim["pid"], signal.SIGKILL)
        _wait(lambda: [r for r in f.worker_rows()
                       if r["index"] == 1 and r["alive"]
                       and r["pid"] != victim["pid"]][0], tries=80)
        # a needle owned by the killed worker serves again (retry
        # through the respawn window)
        odd = [fid for fid in payloads
               if int(fid.split(",")[0]) % 2 == 1]
        for fid in odd or list(payloads):
            _wait(lambda: _get(f"{shared}/{fid}") == payloads[fid]
                  or (_ for _ in ()).throw(AssertionError("stale")),
                  tries=40)

        # the respawn is journaled where /debug/events can see it: the
        # supervisor serves no HTTP, so the respawned worker records
        # the event in its OWN ring at boot (regression: it used to
        # land only in the supervisor's unserved journal)
        def respawn_journaled():
            body = json.loads(_get(f"{shared}/debug/events?n=200"))
            row = [e for e in body["events"]
                   if e["type"] == "worker_respawn"][0]
            assert row["index"] == 1 and row["respawns"] >= 1
            return True
        _wait(respawn_journaled, tries=40)
