"""`master -workers N` of the port: the primary's seq-lease and
assign-state endpoints, an in-process AssignAccelerator answering off
them, and a `python -m seaweedfs_tpu_torch.cli master -workers 2` fleet
behind one SO_REUSEPORT port.

The master-side cases of tests/test_workers.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
The fleet's port is one the kernel picked free, the volume server binds
port 0, and every wait is a bounded loop on readiness, never a fixed
sleep or a fixed port.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

from test_torch_cluster_util import Cluster, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_master_seq_lease_and_assign_state(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            # grow one volume so the writable set is non-empty
            a = await c.assign()
            assert "fid" in a
            async with c.http.get(
                    f"http://{c.master.url}/cluster/seq_lease",
                    params={"count": "512"}) as resp:
                assert resp.status == 200
                l1 = await resp.json()
            async with c.http.get(
                    f"http://{c.master.url}/cluster/seq_lease",
                    params={"count": "512"}) as resp:
                l2 = await resp.json()
            assert l1["count"] == l2["count"] == 512
            # non-overlapping blocks
            assert l2["start"] >= l1["start"] + 512
            async with c.http.get(
                    f"http://{c.master.url}/cluster/assign_state",
                    params={"collection": "", "replication": "000",
                            "ttl": ""}) as resp:
                assert resp.status == 200
                st = await resp.json()
            assert st["entries"], st
            entry = st["entries"][0]
            assert entry["url"] == c.servers[0].url
    run(body())


def test_assign_accelerator_in_proc(tmp_path):
    """An AssignAccelerator wired to a live master answers /dir/assign
    locally (unique keys from its lease, valid volume pick) and falls
    back to None (=> proxy) for knobs it does not understand."""
    import aiohttp

    from seaweedfs_tpu_torch.security import tls
    from seaweedfs_tpu_torch.server.workers import (AssignAccelerator,
                                                    WorkerContext)

    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            await c.assign()          # ensure a writable volume
            state_dir = str(tmp_path / "wstate")
            primary = WorkerContext(0, 2, c.master.port, state_dir,
                                    token="tok")
            primary.write_state(ip="127.0.0.1", port=c.master.port,
                                role="master")
            ctx = WorkerContext(1, 2, c.master.port, state_dir,
                                token="tok")
            acc = AssignAccelerator("127.0.0.1", 0, ctx)
            # port 0: skip the listener, drive fast_assign directly
            acc._http = tls.make_session(
                timeout=aiohttp.ClientTimeout(total=10))
            try:
                await acc._refill()
                await acc._refresh("", "000", "")
                assert acc._lease_end > acc._lease_next
                outs = [acc.fast_assign(b"", "127.0.0.1")
                        for _ in range(5)]
                assert all(o is not None for o in outs)
                fids = [json.loads(o.split(b"\r\n\r\n", 1)[1])["fid"]
                        for o in outs]
                keys = {f.split(",")[1][:-8] for f in fids}
                assert len(keys) == 5                  # unique file keys
                body0 = json.loads(outs[0].split(b"\r\n\r\n", 1)[1])
                assert body0["url"] == c.servers[0].url
                # a fast assign's needle is uploadable + readable
                st, _ = await c.put(fids[0], body0["url"], b"acc-needle")
                assert st == 201
                st, got = await c.get(fids[0], body0["url"])
                assert st == 200 and got == b"acc-needle"
                # unknown knob -> None (the primary must decide)
                assert acc.fast_assign(b"?dataCenter=dc9",
                                       "127.0.0.1") is None
                # count rides through and consumes count keys
                o = acc.fast_assign(b"?count=7", "127.0.0.1")
                assert json.loads(
                    o.split(b"\r\n\r\n", 1)[1])["count"] == 7
            finally:
                await acc._http.close()
    run(body())


def _get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _post(url: str, data: bytes, timeout: float = 10.0) -> bytes:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _wait(fn, deadline_s: float = 60.0, delay: float = 0.2):
    """fn() until it returns without raising, within deadline_s."""
    end = time.monotonic() + deadline_s
    while True:
        try:
            return fn()
        except Exception:  # noqa: BLE001 — start-up polling
            if time.monotonic() > end:
                raise
            time.sleep(delay)


def _true(value):
    assert value, "not ready yet"
    return value


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_master_workers_wire(tmp_path):
    """`master -workers 2`: assigns through the shared port stay unique
    (accelerator lease blocks), cold master routes answer via the
    transparent proxy, and heartbeats landing on the accelerator still
    register with the primary."""
    tmp = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    mport = _free_port()
    state_dir = os.path.join(tmp, "m", ".workers")
    procs = []

    def spawn(name: str, *args) -> str:
        """Start one CLI process logging to <tmp>/<name>.log; returns
        the log's path (a pipe nobody drains could stall the process)."""
        path = os.path.join(tmp, f"{name}.log")
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        return path

    def listening(path: str) -> str:
        with open(path) as f:
            m = re.search(r"listening on (\S+),", f.read())
        assert m, "not listening yet"
        return m.group(1)

    def worker_pids() -> list[int]:
        pids = []
        for i in range(2):
            try:
                with open(os.path.join(state_dir, f"worker{i}.json")) as f:
                    pids.append(int(json.load(f)["pid"]))
            except (OSError, ValueError, KeyError):
                pass
        return pids

    try:
        spawn("master", "master", "-port", str(mport),
              "-mdir", os.path.join(tmp, "m"), "-pulseSeconds", "1",
              "-timeline.interval", "0", "-workers", "2")
        # both workers up: the primary and the accelerator each wrote
        # their state file, and the shared port answers status
        _wait(lambda: _true(len(worker_pids()) == 2))
        _wait(lambda: _true(json.loads(_get(
            f"http://127.0.0.1:{mport}/cluster/status"))["leader"]
            == f"127.0.0.1:{mport}"))
        vlog = spawn("volume", "volume", "-port", "0",
                     "-dir", os.path.join(tmp, "v"), "-max", "20",
                     "-master", f"127.0.0.1:{mport}", "-pulseSeconds", "1",
                     "-ecBackend", "cpu", "-timeline.interval", "0")
        vurl = _wait(lambda: listening(vlog))
        # the volume server registered (its heartbeat may land on either
        # worker): an assign through the shared port names it
        _wait(lambda: json.loads(_get(
            f"http://127.0.0.1:{mport}/dir/assign"))["fid"])
        keys = set()
        payload = None
        for _ in range(30):
            # a 503 during the accelerator's lease-refill window is a
            # transient a real client retries; key uniqueness below
            # still catches any actual assign regression
            a = _wait(lambda: json.loads(_get(
                f"http://127.0.0.1:{mport}/dir/assign")), deadline_s=10)
            key = a["fid"].split(",")[1][:-8]
            assert key not in keys, f"duplicate file key {a['fid']}"
            keys.add(key)
            if payload is None:
                assert a["url"] == vurl
                payload = (a["fid"], b"via-master-workers")
                _post(f"http://{a['url']}/{a['fid']}", payload[1])
        assert _get(f"http://{vurl}/{payload[0]}") == payload[1]
        # cold routes through the shared port (proxy on the accelerator)
        for _ in range(6):
            st = json.loads(_get(f"http://127.0.0.1:{mport}/dir/status"))
            assert "topology" in st
            cs = json.loads(_get(
                f"http://127.0.0.1:{mport}/cluster/status"))
            assert cs["leader"] == f"127.0.0.1:{mport}"
    finally:
        pids = worker_pids()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        # a worker the supervisor could not stop is stopped here
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
