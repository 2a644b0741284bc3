"""~20s inter-host frame-fabric smoke of the port's CLI.

Boots a REAL master (-defaultReplication 001) + two volume servers as
CLI processes and proves the cluster fabric end to end:

  1. replicated writes enter over HTTP; the volume->volume fan-out hop
     rides the frame fabric, and BOTH holders serve byte-identical
     bodies;
  2. the live /metrics confirm hop-labeled inter-host frame traffic
     (SeaweedFS_frame_requests_total{hop="interhost",...} > 0) — the
     heartbeat, lookup and fan-out hops really used the wire;
  3. with `replication.frame` armed (error) on every server the frame
     leg is severed: writes still replicate byte-identically over the
     HTTP fallback, and the armed site's hit counter proves the frame
     leg was actually cut (not silently skipped);
  4. a jwt-secured master refuses an identity-less AND a wrong-key
     frame HELLO at the handshake — before any request payload — while
     the correct key is served.

Fabric regressions fail here in seconds, before tier-1 runs.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT = int(os.environ.get("SWTPU_TORCH_SMOKE_PORT", "22150"))


def get_json(addr: str, path: str, method: str = "GET") -> dict:
    req = urllib.request.Request(f"http://{addr}{path}", method=method)
    with urllib.request.urlopen(req, timeout=15) as r:
        return json.load(r)


def wait_assign(master: str, tries: int = 60) -> None:
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"fabric smoke: {what}")


def write_replicated(master: str, body: bytes) -> str:
    a = get_json(master, "/dir/assign?replication=001")
    check("fid" in a, f"assign failed: {a}")
    req = urllib.request.Request(
        f"http://{a['url']}/{a['fid']}", data=body, method="POST",
        headers={"X-Raw-Needle": "0"})
    with urllib.request.urlopen(req, timeout=10) as r:
        check(r.status in (200, 201), f"write {r.status}")
    return a["fid"]


def read_from(vol: str, fid: str) -> bytes:
    with urllib.request.urlopen(f"http://{vol}/{fid}", timeout=10) as r:
        check(r.status == 200, f"read {fid} from {vol}: {r.status}")
        return r.read()


def frame_counters(addr: str) -> dict:
    """hop-labeled SeaweedFS_frame_requests_total rows from /metrics."""
    with urllib.request.urlopen(f"http://{addr}/metrics",
                                timeout=10) as r:
        body = r.read().decode()
    out: dict = {}
    for line in body.splitlines():
        if line.startswith("SeaweedFS_frame_requests_total"):
            key, _, val = line.rpartition(" ")
            out[key] = out.get(key, 0.0) + float(val)
    return out


def hello_refusal_check(tmp: str, env: dict) -> None:
    """A jwt-secured master must refuse identity-less / wrong-key frame
    HELLOs at the handshake and serve the correct key."""
    from seaweedfs_tpu_torch.util.frame import FrameChannel, FrameChannelError

    port = PORT + 10
    log = open(os.path.join(tmp, "jwtmaster.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "master",
         "-port", str(port), "-mdir", os.path.join(tmp, "mjwt"),
         "-pulseSeconds", "1", "-jwtKey", "fabric-smoke-secret"],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp)
    target = f"127.0.0.1:{port}"
    try:
        # a bare master (no volumes) can't assign: probe /cluster/status
        for _ in range(60):
            try:
                if "leader" in get_json(target, "/cluster/status"):
                    break
            except OSError:
                pass
            time.sleep(0.5)
        else:
            raise RuntimeError("jwt master never came up")

        async def drive():
            for key, want_refused in (("", True),
                                      ("wrong-secret", True),
                                      ("fabric-smoke-secret", False)):
                chan = FrameChannel(target=target, jwt_key=key)
                try:
                    status, _, _ = await chan.request(
                        "GET", "/dir/lookup",
                        query={"volumeId": "1"}, timeout=5.0)
                    refused = False
                except FrameChannelError as e:
                    refused = "handshake refused" in str(e)
                    check(refused, f"unexpected channel error: {e}")
                finally:
                    await chan.close()
                check(refused == want_refused,
                      f"jwt key {key!r}: refused={refused}, "
                      f"wanted {want_refused}")

        asyncio.run(drive())
        print("  hello: identity-less + wrong-key HELLOs refused at "
              "handshake, correct key served")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="swtpu_fabric_smoke_")
    env = dict(os.environ, PYTHONPATH=REPO)
    master = f"127.0.0.1:{PORT}"
    vols = [f"127.0.0.1:{PORT + 1}", f"127.0.0.1:{PORT + 2}"]
    procs: list[subprocess.Popen] = []

    def spawn(*args: str) -> None:
        log = open(os.path.join(tmp, f"proc{len(procs)}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp))

    try:
        spawn("master", "-port", str(PORT), "-mdir",
              os.path.join(tmp, "m"), "-pulseSeconds", "1",
              "-defaultReplication", "001")
        time.sleep(1.5)
        for i, vol in enumerate(vols):
            spawn("volume", "-port", vol.rsplit(":", 1)[1], "-dir",
                  os.path.join(tmp, f"v{i}"), "-max", "10",
                  "-master", master, "-pulseSeconds", "1")
        wait_assign(master)

        # -- 1. replicated writes: fan-out rides frames ----------------
        blobs = {}
        for i in range(6):
            body = f"fabric-{i}-".encode() * (64 + i)
            blobs[write_replicated(master, body)] = body
        for fid, body in blobs.items():
            got = [read_from(v, fid) for v in vols]
            check(got[0] == got[1] == body,
                  f"replica bodies diverge for {fid}")
        print(f"  fanout: {len(blobs)} replicated writes, both holders "
              f"byte-identical")

        # -- 2. live wire evidence: hop-labeled frame counters ---------
        rows: dict = {}
        for v in vols:
            for k, n in frame_counters(v).items():
                rows[k] = rows.get(k, 0.0) + n
        inter_client = sum(n for k, n in rows.items()
                           if 'hop="interhost"' in k
                           and 'side="client"' in k)
        inter_server = sum(n for k, n in rows.items()
                           if 'hop="interhost"' in k
                           and 'side="server"' in k)
        check(inter_client > 0,
              f"no client-side interhost frame traffic (saw {rows})")
        check(inter_server > 0,
              f"no server-side interhost frame traffic (saw {rows})")
        print(f"  wire: interhost frames client={int(inter_client)} "
              f"server={int(inter_server)}")

        # -- 3. sever the frame leg: HTTP fallback, still identical ----
        for v in vols:
            out = get_json(v, "/debug/failpoints?site=replication.frame"
                              "&spec=error:*", method="POST")
            check(any(a["site"] == "replication.frame"
                      for a in out.get("armed", [])), f"arm failed: {out}")
        blobs2 = {}
        for i in range(4):
            body = f"fallback-{i}-".encode() * (64 + i)
            blobs2[write_replicated(master, body)] = body
        for fid, body in blobs2.items():
            got = [read_from(v, fid) for v in vols]
            check(got[0] == got[1] == body,
                  f"HTTP-fallback replica bodies diverge for {fid}")
        hits = 0
        for v in vols:
            for a in get_json(v, "/debug/failpoints")["failpoints"]:
                if a["site"] == "replication.frame":
                    hits += a["hits"]
            get_json(v, "/debug/failpoints?site=replication.frame",
                     method="DELETE")
        check(hits >= len(blobs2),
              f"armed replication.frame fired {hits} < {len(blobs2)} — "
              f"the frame leg was not actually severed")
        print(f"  fallback: {len(blobs2)} writes with the frame leg cut "
              f"({hits} fires), replicas still byte-identical over HTTP")

        # -- 4. HELLO auth on a jwt-secured master ---------------------
        hello_refusal_check(tmp, env)
        print("fabric smoke: OK")
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        time.sleep(1)


if __name__ == "__main__":
    sys.exit(main())
