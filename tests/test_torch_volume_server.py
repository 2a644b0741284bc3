"""The port's volume server against the JAX package's, over HTTP.

A reference `VolumeServer` and a port `VolumeServer` hold the same sealed
.dat: it is written through the reference server, and its .dat/.idx are
copied into the port server's directory and mounted there (needle writes
stamp an append time, so two servers written alike hold different
files). Then both get the same requests, and the answers must be equal
byte for byte: the 14 shard files and the .ecx of /admin/ec/generate and
its window/dispatch counts, the /admin/ec/verify reports clean and after
a flipped byte, the files /admin/ec/rebuild writes after the same four
shards are deleted, and every needle GET (status, body, ETag,
Content-Length) intact and with the four shards lost, where every
recover of the port runs on its EC engine. No master runs:
each server's heartbeat fails and retries, and everything is served
locally. The port's EC engine is the kernel's plain PyTorch version
(SWTPU_TORCH_EC_BACKEND=cpu).

Also here: /admin/ec/generate_batch over two volumes, byte-equal to the
reference with the nibble-table kernel and with SWTPU_TORCH_EC_METHOD=mxu
(the GF(2) bit-matrix product, K4's port); two /admin/ec/verify requests
in flight at once on the port server; a failpoint armed in the
reference's registry that leaves the port server alone; and the handlers
of the modules the last slice ported, which now answer without naming a
missing module or loading seaweedfs_tpu. What is still missing (the
filer route cache of util/client.py) raises an ImportError naming the
port module.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import sys

import aiohttp
import numpy as np
import pytest

from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.util import failpoints as ref_fp
from seaweedfs_tpu_torch.ec.pipeline import BACKEND_ENV, METHOD_ENV
from seaweedfs_tpu_torch.ops import gf256_mxu
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.util import failpoints as fp
from test_torch_cluster_util import dead_master

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VID = 7
LOST = [0, 3, 7, 9]
# the reference harness's EC geometry (tests/cluster_util.py)
EC_BLOCKS = {"ec_large_block": 16 * 1024, "ec_small_block": 1024}
N_NEEDLES = 60


def _needles(seed: int = 3, vid: int = VID
             ) -> list[tuple[str, bytes, str]]:
    """(fid, body, content type): sizes from 1 byte to 3 large blocks, so
    needles cross block and shard boundaries."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, N_NEEDLES + 1):
        size = int(rng.integers(1, 3 * EC_BLOCKS["ec_large_block"]))
        cookie = int(rng.integers(1, 1 << 32))
        ctype = ("text/plain", "application/octet-stream",
                 "application/json")[i % 3]
        out.append((f"{vid},{i:x}{cookie:08x}", rng.bytes(size), ctype))
    return out


class Pair:
    """A reference and a port volume server on one event loop."""

    def __init__(self, tmp: str):
        self.dirs = (os.path.join(tmp, "ref"), os.path.join(tmp, "port"))
        master = dead_master()
        self.ref = RefServer(RefStore([self.dirs[0]], **EC_BLOCKS), master,
                             port=0, pulse_seconds=60)
        # every degraded recover of the port goes through its EC engine
        # (TorchEncoder), none through the host CpuEncoder
        self.port = VolumeServer(Store([self.dirs[1]], **EC_BLOCKS,
                                       ec_small_recover_bytes=0),
                                 master, port=0, pulse_seconds=60)
        self.http: aiohttp.ClientSession | None = None

    async def __aenter__(self) -> "Pair":
        await self.ref.start()
        await self.port.start()
        self.http = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=60))
        return self

    async def __aexit__(self, *exc) -> None:
        await self.http.close()
        for vs in (self.port, self.ref):
            await vs.stop()

    async def post(self, vs, path: str, **params):
        async with self.http.post(f"http://{vs.url}{path}",
                                  params=params) as r:
            return r.status, await r.json()

    async def both(self, path: str, **params):
        """POST `path` to both servers; returns (ref, port) answers."""
        return (await self.post(self.ref, path, **params),
                await self.post(self.port, path, **params))

    async def get(self, vs, fid: str):
        async with self.http.get(f"http://{vs.url}/{fid}") as r:
            return (r.status, await r.read(), r.headers.get("ETag"),
                    r.headers.get("Content-Length"))

    def base(self, side: int, vid: int = VID) -> str:
        return os.path.join(self.dirs[side], str(vid))

    async def seed_volume(self, vid: int = VID, seed: int = 3
                          ) -> list[tuple[str, bytes, str]]:
        """Write the needles through the reference server, seal the
        volume and mount a copy of its .dat/.idx on the port server."""
        st, body = await self.post(self.ref, "/admin/volume/allocate",
                                   volume=str(vid))
        assert st == 200, body
        needles = _needles(seed, vid)
        for fid, data, ctype in needles:
            async with self.http.post(f"http://{self.ref.url}/{fid}",
                                      data=data,
                                      headers={"Content-Type": ctype}) as r:
                assert r.status == 201, await r.text()
        assert (await self.post(self.ref, "/admin/volume/readonly",
                                volume=str(vid)))[0] == 200
        assert (await self.post(self.ref, "/admin/volume/unmount",
                                volume=str(vid)))[0] == 200
        for ext in (".dat", ".idx"):
            shutil.copyfile(self.base(0, vid) + ext, self.base(1, vid) + ext)
        for vs in (self.ref, self.port):
            st, body = await self.post(vs, "/admin/volume/mount",
                                       volume=str(vid))
            assert st == 200, body
        return needles

    async def to_ec(self) -> None:
        """Mount all 14 shards and drop the normal volume on both."""
        for path in ("/admin/ec/mount", "/admin/volume/delete"):
            ref, port = await self.both(path, volume=str(VID))
            assert ref == port and ref[0] == 200, (path, ref, port)

    def files(self, side: int, exts, vid: int = VID) -> dict[str, bytes]:
        out = {}
        for ext in exts:
            with open(self.base(side, vid) + ext, "rb") as f:
                out[ext] = f.read()
        return out

    async def all_gets(self, needles) -> None:
        for fid, data, _ in needles:
            ref, port = await self.get(self.ref, fid), \
                await self.get(self.port, fid)
            assert port == ref, fid
            assert port[0] == 200 and port[1] == data, fid


SHARD_EXTS = [".ec%02d" % s for s in range(14)]


@pytest.fixture
def ec_backend_cpu(monkeypatch):
    monkeypatch.setenv(BACKEND_ENV, "cpu")


def _flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


def test_ec_http_surface_matches_reference(tmp_path, ec_backend_cpu):
    async def go():
        async with Pair(str(tmp_path)) as p:
            needles = await p.seed_volume()
            await p.all_gets(needles)

            # generate: same counts, byte-identical shards and .ecx
            ref, port = await p.both("/admin/ec/generate", volume=str(VID))
            assert ref == port and ref[0] == 200, (ref, port)
            assert port[1]["dispatches"] >= 1
            exts = SHARD_EXTS + [".ecx"]
            assert p.files(1, exts) == p.files(0, exts)
            await p.to_ec()
            await p.all_gets(needles)

            # verify: equal reports, clean and after a flipped byte
            ref, port = await p.both("/admin/ec/verify", volume=str(VID))
            assert ref == port and port[1]["bad_windows"] == [], (ref, port)
            for side in (0, 1):
                _flip(p.base(side) + ".ec12", 1000)
            ref, port = await p.both("/admin/ec/verify", volume=str(VID))
            assert ref == port and port[1]["bad_windows"] == [0], (ref, port)
            for side in (0, 1):
                _flip(p.base(side) + ".ec12", 1000)

            # 4 shards lost: degraded GETs, then rebuild
            lost = ",".join(map(str, LOST))
            originals = p.files(1, [SHARD_EXTS[s] for s in LOST])
            for path in ("/admin/ec/unmount", "/admin/ec/delete_shards"):
                ref, port = await p.both(path, volume=str(VID), shards=lost)
                assert ref == port and ref[0] == 200, (path, ref, port)
            assert not os.path.exists(p.base(1) + ".ec00")
            await p.all_gets(needles)
            ref, port = await p.both("/admin/ec/rebuild", volume=str(VID))
            assert ref == port and port[1]["rebuilt"] == LOST, (ref, port)
            rebuilt = p.files(1, [SHARD_EXTS[s] for s in LOST])
            assert rebuilt == p.files(0, [SHARD_EXTS[s] for s in LOST])
            assert rebuilt == originals
    asyncio.run(go())


@pytest.mark.parametrize("method", ["", "mxu"])
def test_ec_generate_batch_matches_reference(tmp_path, ec_backend_cpu,
                                             monkeypatch, method):
    """/admin/ec/generate_batch over two sealed volumes: the same answer,
    and every shard file and .ecx of both volumes byte-equal to the
    reference's. Under SWTPU_TORCH_EC_METHOD=mxu each launch of the
    batch goes through K4's port, which the JAX package's own variable
    leaves alone."""
    monkeypatch.setenv(METHOD_ENV, method)
    monkeypatch.setenv("SWTPU_EC_METHOD", "mxu")
    calls = []
    real = gf256_mxu.gf2_bitmatrix_transform
    monkeypatch.setattr(gf256_mxu, "gf2_bitmatrix_transform",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    async def go():
        async with Pair(str(tmp_path)) as p:
            await p.seed_volume()
            await p.seed_volume(VID + 1, seed=4)
            vols = f"{VID},{VID + 1}"
            ref, port = await p.both("/admin/ec/generate_batch",
                                     volumes=vols)
            assert ref == port and ref[0] == 200, (ref, port)
            exts = SHARD_EXTS + [".ecx"]
            for vid in (VID, VID + 1):
                assert p.files(1, exts, vid) == p.files(0, exts, vid), vid
    asyncio.run(go())
    assert bool(calls) == (method == "mxu")


def test_concurrent_verifies_both_match_reference(tmp_path, ec_backend_cpu):
    """Two verifies in flight on one server run in two executor threads,
    each through the EC engine at once; both report what the reference
    reports, clean and with a flipped byte."""
    async def go():
        async with Pair(str(tmp_path)) as p:
            await p.seed_volume()
            await p.both("/admin/ec/generate", volume=str(VID))
            await p.to_ec()
            for flip in (False, True):
                if flip:
                    for side in (0, 1):
                        _flip(p.base(side) + ".ec11", 20000)
                want = await p.post(p.ref, "/admin/ec/verify",
                                    volume=str(VID))
                got = await asyncio.gather(*(
                    p.post(p.port, "/admin/ec/verify", volume=str(VID))
                    for _ in range(2)))
                assert got == [want, want], (flip, want, got)
                assert (want[1]["bad_windows"] != []) == flip
    asyncio.run(go())


def test_reference_failpoint_leaves_port_server_alone(tmp_path,
                                                      ec_backend_cpu):
    """A read failpoint armed in the JAX package's registry fails the
    reference server's reads and none of the port server's, and the
    port's /debug/failpoints lists nothing armed."""
    async def go():
        async with Pair(str(tmp_path)) as p:
            needles = await p.seed_volume()
            fid, data, _ = needles[0]
            ref_fp.arm("store.read", "error")
            try:
                assert (await p.get(p.ref, fid))[0] >= 500
                assert (await p.get(p.port, fid))[:2] == (200, data)
                async with p.http.get(
                        f"http://{p.port.url}/debug/failpoints") as r:
                    armed = await r.json()
                assert fp.list_armed() == []
                assert "store.read" not in json.dumps(armed)
            finally:
                ref_fp.reset()
            assert (await p.get(p.ref, fid))[:2] == (200, data)
    asyncio.run(go())


# -- the handlers of the modules the last slice ported, against the
# reference's on the same volumes and requests

JSON_VID = VID + 2
N_JSON = 24


def _json_needles() -> list[tuple[str, bytes]]:
    """(fid, body): JSON records for the query and vacuum cases."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(1, N_JSON + 1):
        rec = {"name": f"n{i}", "age": int(rng.integers(0, 90)),
               "city": ("Oslo", "Lima", "Pune")[i % 3],
               "tags": [int(x) for x in rng.integers(0, 9, i % 4)],
               "pad": "x" * int(rng.integers(0, 3000))}
        out.append((f"{JSON_VID},{i:x}{int(rng.integers(1, 1 << 32)):08x}",
                    json.dumps(rec).encode()))
    return out


async def _request(p: Pair, vs, method: str, path: str, params: dict,
                   body=None) -> tuple[int, bytes]:
    async with p.http.request(method, f"http://{vs.url}{path}",
                              params=params, json=body) as r:
        return r.status, await r.read()


async def _same(p: Pair, method: str, path: str, params: dict,
                body=None, drop=()) -> tuple[int, bytes]:
    """Send one request to both servers; the port's status and body (a
    JSON body without the keys in `drop`) equal the reference's."""
    ref = await _request(p, p.ref, method, path, params, body)
    port = await _request(p, p.port, method, path, params, body)
    if drop:
        ref, port = [(st, {k: v for k, v in json.loads(b).items()
                           if k not in drop}) for st, b in (ref, port)]
    assert port == ref, (method, path, params, ref, port)
    return port


async def _json_volume(p: Pair, deleted=()) -> list[tuple[str, bytes]]:
    """A writable volume of JSON records on both servers, written alike
    through each, with the needles at `deleted` (indices) deleted."""
    needles = _json_needles()
    for vs in (p.ref, p.port):
        assert (await p.post(vs, "/admin/volume/allocate",
                             volume=str(JSON_VID)))[0] == 200
        for fid, data in needles:
            async with p.http.post(
                    f"http://{vs.url}/{fid}", data=data,
                    headers={"Content-Type": "application/json"}) as r:
                assert r.status == 201, await r.text()
        for i in deleted:
            async with p.http.delete(f"http://{vs.url}/{needles[i][0]}") as r:
                assert r.status == 200, await r.text()
    return needles


def _exists(p: Pair, side: int, ext: str) -> bool:
    return os.path.exists(p.base(side, JSON_VID) + ext)


async def _scenario(p: Pair, path: str) -> None:
    q = {"volume": str(JSON_VID)}
    if path == "/debug/health":
        await _same(p, "GET", path, {}, drop=("now_ms",))
    elif path == "/debug/profile":
        # the aggregate's samples and stacks are each process's own
        await _same(p, "GET", path, {}, drop=("samples", "folded"))
        await _same(p, "GET", path, {"seconds": "junk"})
    elif path == "/debug/pprof":
        await _same(p, "GET", path, {})
        await _same(p, "GET", path, {"dump": "1"})
    elif path == "/admin/query":
        needles = await _json_volume(p, deleted=(4,))
        fids = [f for f, _ in needles] + ["99,1234", "junk"]
        for flt, sel in (({"field": "age", "operand": ">", "value": "40"},
                          ["name", "age"]),
                         ({"field": "city", "operand": "=",
                           "value": "Lima"}, []),
                         ({"field": "name", "operand": "like",
                           "value": "n1"}, ["tags"]),
                         (None, ["city"])):
            st, body = await _same(p, "POST", path, {}, {
                "fromFileIds": fids, "filter": flt, "selections": sel})
            assert st == 200 and body, (flt, body)
        await _same(p, "POST", path, {}, {"fids": fids, "filter": {
            "field": "age", "operand": "~", "value": "1"}})
        await _same(p, "POST", path, {}, {})
    elif path == "/admin/vacuum/check":
        await _json_volume(p, deleted=(1, 5, 6, 20))
        st, body = await _same(p, "POST", path, q)
        assert st == 200 and json.loads(body)["garbage_ratio"] > 0
        await _same(p, "POST", path, {"volume": "999"})
    elif path in ("/admin/vacuum/compact", "/admin/vacuum/commit",
                  "/admin/vacuum/cleanup"):
        deleted = (0, 3, 9, 10, 23)
        needles = await _json_volume(p, deleted=deleted)
        assert (await _same(p, "POST", "/admin/vacuum/compact", q))[0] == 200
        assert all(_exists(p, side, ".cpd") for side in (0, 1))
        if path == "/admin/vacuum/commit":
            assert (await _same(p, "POST", path, q))[0] == 200
            st, body = await _same(p, "POST", "/admin/vacuum/check", q)
            assert json.loads(body)["garbage_ratio"] == 0
            for i, (fid, data) in enumerate(needles):
                ref, port = await p.get(p.ref, fid), await p.get(p.port, fid)
                assert port == ref, fid
                assert port[0] == (404 if i in deleted else 200), fid
        elif path == "/admin/vacuum/cleanup":
            assert (await _same(p, "POST", path, q))[0] == 200
            assert not any(_exists(p, side, ext) for side in (0, 1)
                           for ext in (".cpd", ".cpx"))
            await _same(p, "POST", path, {"volume": "999"})
        await _same(p, "POST", path, {"volume": "999"})
    elif path == "/admin/volume/tail":
        # the same sealed .dat on both: the same framed records
        for since in ("0", "1"):
            st, body = await _same(p, "GET", path, {"volume": str(VID),
                                                    "since_ns": since})
            assert st == 200 and body
        await _same(p, "GET", path, {"volume": "999"})
    elif path == "/admin/volume/tail_receive":
        await _json_volume(p)
        await _same(p, "POST", path, q)                    # no source
        await _same(p, "POST", path, {**q, "source": dead_master()})
        await _same(p, "POST", path, {"volume": "999",
                                      "source": dead_master()})
    elif path in ("/admin/tier/upload", "/admin/tier/download"):
        await _json_volume(p)
        await _same(p, "POST", path, q)                    # no backend
        await _same(p, "POST", path, {**q, "backend": "s3.nowhere"})
        await _same(p, "POST", path, {"volume": "999"})
    else:
        raise AssertionError(f"no scenario for {path}")


@pytest.mark.parametrize("path", [
    "/debug/health", "/debug/profile", "/debug/pprof", "/admin/query",
    "/admin/vacuum/check", "/admin/vacuum/compact", "/admin/vacuum/commit",
    "/admin/vacuum/cleanup", "/admin/volume/tail",
    "/admin/volume/tail_receive", "/admin/tier/upload",
    "/admin/tier/download"])
def test_ported_handler_matches_reference(tmp_path, ec_backend_cpu, path):
    """Each handler of the modules the last slice ported, on a reference
    and a port server holding the same volumes: every request of its
    case gets the same status and the same body from both (JSON bodies
    without their clock and each process's own profiler samples)."""
    async def go():
        async with Pair(str(tmp_path)) as p:
            await p.seed_volume()
            await _scenario(p, path)
    asyncio.run(go())


# the handlers whose modules are not ported yet: (method, path, query,
# the port module its ImportError must name); none is left
UNPORTED: list[tuple] = []

# the handlers whose modules the last slice ported (stats/slo,
# stats/profiler, util/pprof, query/, storage/vacuum, volume_backup,
# volume_tier), with the status each answers on an empty volume 1 with
# an empty JSON body, as the reference's do: tail_receive without its
# `source` parameter fails on the missing key, and the tier handlers find
# no backend and no tiered volume
PORTED = [
    ("GET", "/debug/health", {}, 200),
    ("GET", "/debug/profile", {}, 200),
    ("GET", "/debug/pprof", {}, 200),
    ("POST", "/admin/query", {}, 200),
    ("POST", "/admin/vacuum/check", {"volume": "1"}, 200),
    ("POST", "/admin/vacuum/compact", {"volume": "1"}, 200),
    ("POST", "/admin/vacuum/commit", {"volume": "1"}, 200),
    ("POST", "/admin/vacuum/cleanup", {"volume": "1"}, 200),
    ("GET", "/admin/volume/tail", {"volume": "1"}, 200),
    ("POST", "/admin/volume/tail_receive", {"volume": "1"}, 500),
    ("POST", "/admin/tier/upload", {"volume": "1"}, 502),
    ("POST", "/admin/tier/download", {"volume": "1"}, 502),
]

_UNPORTED_SCRIPT = r"""
import asyncio, json, sys
import aiohttp
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.util.client import FilerHttpClient

CASES = json.loads(sys.argv[2])

async def main():
    store = Store([sys.argv[1]])
    store.add_volume(1)
    vs = VolumeServer(store, sys.argv[3], port=0, pulse_seconds=60)
    await vs.start()
    out = []
    try:
        async with aiohttp.ClientSession() as http:
            for method, path, query, _ in CASES:
                async with http.request(method, f"http://{vs.url}{path}",
                                        params=query, json={}) as r:
                    out.append([path, r.status, await r.text()])
    finally:
        await vs.stop()
    try:
        FilerHttpClient(["127.0.0.1:1"])
        out.append(["FilerHttpClient", 0, "constructed"])
    except ImportError as e:
        out.append(["FilerHttpClient", 500, str(e)])
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "seaweedfs_tpu"))
    print(json.dumps({"answers": out, "leaked": leaked}))

asyncio.run(main())
"""


def test_unported_handlers_answer_500_naming_the_port(tmp_path):
    """Run in a process of its own with only the port imported: no
    handler is left that reaches a module not ported yet (the name is
    kept from when some did), and util/client.py's filer route cache,
    the last such path, now builds on the port's filer/shard.py.
    Afterwards neither jax nor any seaweedfs_tpu module is loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _UNPORTED_SCRIPT, str(tmp_path),
         json.dumps(UNPORTED), dead_master()],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    assert UNPORTED == []
    assert report["answers"] == [["FilerHttpClient", 0, "constructed"]]


def test_handlers_of_the_ported_modules_answer(tmp_path):
    """The same process of its own: each handler of a module the last
    slice ported answers its expected status without a "not ported yet"
    error and without loading jax or any seaweedfs_tpu module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _UNPORTED_SCRIPT, str(tmp_path),
         json.dumps(PORTED), dead_master()],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    answers = {path: (status, text)
               for path, status, text in report["answers"]}
    for _, path, _, want in PORTED:
        status, text = answers[path]
        assert status == want and "not ported" not in text, \
            (path, status, text)
