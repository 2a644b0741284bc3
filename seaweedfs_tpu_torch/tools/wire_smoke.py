"""~30s data-plane wire smoke of the port's CLI.

Boots a REAL master + single-worker volume server as CLI processes and
drives the unified wire end to end over raw sockets:

  1. group-commit write burst — concurrent POSTs to one volume, all
     acked, /status shows coalesced batches;
  2. batch GET round trip — hot + cold + missing fids, order and bytes
     verified against single GETs;
  3. sendfile read — a large cold needle byte-verified against the
     buffered path, Range resume included;
  4. binary frame hop — a second master + `-workers 2` volume fleet:
     single reads and one cross-partition /batch driven over the
     frame protocol, byte-equal with the SAME requests over HTTP,
     with the sibling frame channels asserted in use via /status.

Data-plane regressions fail here in seconds, before tier-1 runs.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT = int(os.environ.get("SWTPU_TORCH_SMOKE_PORT", "21950"))


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


def req(vol: str, method: str, path: str, body: bytes = b""
        ) -> "tuple[int, dict, bytes]":
    host, _, port = vol.rpartition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=20)
    try:
        c.request(method, path, body=body or None)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def assign(master: str) -> dict:
    with urllib.request.urlopen(f"http://{master}/dir/assign",
                                timeout=5) as r:
        return json.load(r)


def main() -> int:
    from seaweedfs_tpu_torch.util.batchframe import parse_all

    tmp = tempfile.mkdtemp(prefix="swtpu_wire_smoke_")
    env = dict(os.environ, PYTHONPATH=REPO)
    master = f"127.0.0.1:{PORT}"
    vol = f"127.0.0.1:{PORT + 1}"
    procs: list[subprocess.Popen] = []

    def spawn(*args: str) -> None:
        log = open(os.path.join(tmp, f"proc{len(procs)}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp))

    try:
        spawn("master", "-port", str(PORT), "-mdir",
              os.path.join(tmp, "m"), "-pulseSeconds", "1")
        time.sleep(1.5)
        spawn("volume", "-port", str(PORT + 1), "-dir",
              os.path.join(tmp, "v"), "-max", "10", "-master", master,
              "-pulseSeconds", "1", "-groupcommit.ms", "2")
        wait_assign(master)

        # -- 1. group-commit write burst --------------------------------
        assigns = [assign(master) for _ in range(16)]
        bodies = {a["fid"]: f"gc-{i}-".encode() * 40
                  for i, a in enumerate(assigns)}
        errs: list[str] = []

        def put(a: dict) -> None:
            st, _, out = req(a["url"], "POST", "/" + a["fid"],
                             bodies[a["fid"]])
            if st != 201:
                errs.append(f"POST {a['fid']}: {st} {out[:120]!r}")

        threads = [threading.Thread(target=put, args=(a,))
                   for a in assigns]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
        assert not errs, errs
        st, _, out = req(vol, "GET", "/status")
        gc = json.loads(out).get("group_commit", {})
        assert gc.get("appended", 0) >= 16, gc
        print(f"  group commit: 16/16 concurrent writes acked, "
              f"batches={gc.get('batches')} max_batch="
              f"{gc.get('max_batch')}")

        # -- 2. batch GET round trip ------------------------------------
        fids = [a["fid"] for a in assigns[:6]]
        missing = fids[0].split(",")[0] + ",ffffffffdeadbeef"
        ask = fids[:3] + [missing] + fids[3:]
        st, hdrs, raw = req(vol, "GET", "/batch?fids=" + ",".join(ask))
        assert st == 200, (st, raw[:200])
        rows = parse_all(raw)
        assert [m["fid"] for m, _ in rows] == ask
        ok = 0
        for meta, got in rows:
            if meta["fid"] == missing:
                assert meta["status"] == 404, meta
            else:
                assert meta["status"] == 200, meta
                assert got == bodies[meta["fid"]], meta["fid"]
                ok += 1
        print(f"  batch GET: {ok} needles + 1 expected 404 in one "
              f"round trip, order preserved")

        # -- 3. sendfile cold read --------------------------------------
        big = assign(master)
        payload = bytes((i * 131 + 17) % 256 for i in range(300_000))
        st, _, _ = req(big["url"], "POST", "/" + big["fid"], payload)
        assert st == 201
        st, hdrs, got = req(vol, "GET", "/" + big["fid"])
        assert st == 200 and got == payload, \
            f"sendfile body mismatch ({len(got)}/{len(payload)})"
        c = http.client.HTTPConnection("127.0.0.1", PORT + 1,
                                       timeout=20)
        try:
            c.request("GET", "/" + big["fid"],
                      headers={"Range": "bytes=250000-"})
            r = c.getresponse()
            tail = r.read()
            assert r.status == 206 and tail == payload[250000:]
        finally:
            c.close()
        print(f"  sendfile: {len(payload)}-byte cold body + ranged "
              f"resume byte-verified over the raw listener")

        # -- 4. binary frame hop on a -workers 2 fleet ------------------
        m2 = f"127.0.0.1:{PORT + 2}"
        v2 = f"127.0.0.1:{PORT + 3}"
        spawn("master", "-port", str(PORT + 2), "-mdir",
              os.path.join(tmp, "m2"), "-pulseSeconds", "1")
        time.sleep(1.5)
        spawn("volume", "-port", str(PORT + 3), "-dir",
              os.path.join(tmp, "v2"), "-max", "10", "-master", m2,
              "-pulseSeconds", "1", "-workers", "2")
        wait_assign(m2)
        # grow past one volume so assigns cover BOTH vid-parity
        # partitions (vid % 2 owns the worker)
        with urllib.request.urlopen(f"http://{m2}/vol/grow?count=4",
                                    timeout=10) as r:
            r.read()
        fleet_fids: dict = {}
        vids = set()
        for i in range(32):
            a = assign(m2)
            vid = int(a["fid"].split(",")[0])
            body = f"frame-hop-{i}-".encode() * 50
            st, _, out = req(a["url"], "POST", "/" + a["fid"], body)
            assert st == 201, (st, out[:120])
            fleet_fids[a["fid"]] = body
            vids.add(vid % 2)
            if len(fleet_fids) >= 4 and len(vids) == 2:
                break
        assert len(vids) == 2, "assigns never covered both partitions"

        import asyncio

        async def frame_phase() -> None:
            from seaweedfs_tpu_torch.util.frame import FrameChannel
            ch = FrameChannel(target=v2)
            try:
                # single reads over frames: whichever worker accepted
                # the connection forwards other-parity vids over its
                # sibling frame channel — byte-equal with HTTP
                for fid, want in fleet_fids.items():
                    fst, _, fbody = await ch.request("GET", "/" + fid)
                    hst, _, hbody = req(v2, "GET", "/" + fid)
                    assert fst == hst == 200, (fid, fst, hst)
                    assert fbody == hbody == want, fid
                # one cross-partition batch over frames vs HTTP
                ask = ",".join(fleet_fids)
                fst, _, fraw = await ch.request(
                    "GET", "/batch", query={"fids": ask})
                hst, _, hraw = req(v2, "GET", "/batch?fids=" + ask)
                assert fst == hst == 200, (fst, hst)
                assert fraw == hraw, "frame/HTTP batch bytes differ"
            finally:
                await ch.close()

        asyncio.run(frame_phase())
        st, _, out = req(v2, "GET", "/status")
        frames = json.loads(out).get("frames", {})
        hop_requests = sum(chs["requests"]
                           for per_w in frames.values()
                           for chs in per_w.values())
        assert hop_requests > 0, \
            f"sibling frame channels never used: {frames}"
        print(f"  frame hop: {len(fleet_fids)} single reads + 1 "
              f"cross-partition batch byte-equal over frames vs HTTP "
              f"({hop_requests} sibling frame requests)")
        print("wire smoke: OK")
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
        time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
