"""Degraded reads and rebuilds that check their survivors, in the port.

A rotten survivor (one flipped byte in a shard file that is still
served) is found, left out and reported, by a degraded read after a
needle CRC mismatch (EcVolume._reread_without_culprit) and by a rebuild
that reads check rows beyond the k it decodes from
(pipeline._rebuild_rows). Each case builds one volume with the port's
encoder from a seeded generator and runs both packages on the same shard
files: the port gives the encoded bytes, or refuses, and the JAX
package, which keeps the fault, is shown to fail on the same input."""

import asyncio
import hashlib
import os
import random
import shutil

import pytest

from seaweedfs_tpu_torch.autopilot.observe import Observer
from seaweedfs_tpu_torch.autopilot.plan import (KIND_REBUILD,
                                                ClusterSnapshot,
                                                EcVolumeState, NodeState,
                                                PlannerConfig, plan)
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.locate import locate_data
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import CrcMismatch, Needle
from seaweedfs_tpu_torch.storage.needle_map import walk_index_blob
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.chunk_cache import EcRecoverCache
from test_torch_cluster_util import Cluster

K = gf.DATA_SHARDS
N = gf.TOTAL_SHARDS
LB = 16 * 1024
SB = 1024
VID = 9
# the needle header before a v3 needle's data: cookie, id, size, then
# the data length
DATA_AT = t.NEEDLE_HEADER_SIZE + 4


@pytest.fixture(autouse=True)
def _cpu_backend(monkeypatch):
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")


def build_volume(d: str, seed: int = 3, count: int = 60) -> dict:
    """A volume of `count` seeded needles (100-3000 bytes), encoded with
    the port's encoder into 14 shard files and an .ecx in `d`; returns
    {needle id: (cookie, data)}."""
    os.makedirs(d, exist_ok=True)
    v = Volume(d, "", VID)
    rng = random.Random(seed)
    contents = {}
    for i in range(1, count + 1):
        data = rng.randbytes(rng.randint(100, 3000))
        v.write_needle(Needle(cookie=i * 7, id=i, data=data))
        contents[i] = (i * 7, data)
    v.close()
    base = os.path.join(d, str(VID))
    pl.write_ec_files(base, encoder=pl.get_encoder("cpu"), large_block=LB,
                      small_block=SB, buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    return contents


def shard_size(base: str) -> int:
    return os.path.getsize(base + pl.to_ext(N - 1))


def data_byte_on(base: str, shard: int, skip: int = 0,
                 avoid=()) -> "tuple[int, int]":
    """(needle id, shard offset) of a byte in the middle of a needle's
    data that lies on data shard `shard`, located from the .ecx; the
    `skip`-th such needle, none of `avoid`."""
    with open(base + ".ecx", "rb") as f:
        index = sorted(walk_index_blob(f.read()), key=lambda e: e[1])
    dat_size = K * shard_size(base)
    found = []
    for key, off, size in index:
        if key in avoid:
            continue
        data_len = size - 4 - 1 - 1        # data, flags, no name or mime
        mid = off + DATA_AT + data_len // 2
        (iv,) = locate_data(LB, SB, dat_size, mid, 1)
        sid, soff = iv.to_shard_and_offset(LB, SB)
        if sid == shard:
            found.append((key, soff))
    return found[skip]


def flip(base: str, shard: int, offset: int, mask: int = 0x5A) -> None:
    with open(base + pl.to_ext(shard), "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def lose(base: str, shards) -> dict:
    """Delete the shard files `shards`; returns their sha256."""
    out = {}
    for s in shards:
        out[s] = sha(base + pl.to_ext(s))
        os.remove(base + pl.to_ext(s))
    return out


def open_port(d: str, recover_cache=None):
    reports = []
    ev = EcVolume(d, "", VID, large_block=LB, small_block=SB,
                  recover_cache=recover_cache, report_rot=reports.append)
    return ev, reports


def open_ref(d: str):
    from seaweedfs_tpu.ec.ec_volume import EcVolume as RefEcVolume
    return RefEcVolume(d, "", VID, large_block=LB, small_block=SB)


def needle_keys(ev, base: str, nid: int) -> list:
    """The recover-cache keys of needle nid's intervals on every shard."""
    off, size = ev.find_needle(nid)
    keys = []
    for iv in locate_data(LB, SB, K * shard_size(base), off,
                          t.actual_size(size, t.CURRENT_VERSION)):
        sid, soff = iv.to_shard_and_offset(LB, SB)
        keys += [(VID, s, soff, iv.size) for s in range(N)]
    return keys


# ---------------------------------------------------------------------
# degraded reads
# ---------------------------------------------------------------------

@pytest.mark.parametrize("culprit", [5, 12])
def test_degraded_read_leaves_out_the_rotten_survivor(tmp_path, culprit):
    """Shards {0,3,7} lost (11 survivors) and one byte of survivor
    `culprit` flipped where a needle on shard 0 is recovered from it:
    the port serves every needle CRC-correct and reports exactly
    [culprit] in the scrubber's form; the reference raises CrcMismatch
    on the same files."""
    d = str(tmp_path / "v")
    contents = build_volume(d)
    base = os.path.join(d, str(VID))
    lose(base, (0, 3, 7))
    nid, x = data_byte_on(base, 0)
    flip(base, culprit, x)
    ev, reports = open_port(d)
    try:
        for key, (cookie, data) in contents.items():
            n = ev.read_needle(key, cookie)
            assert n.data == data, key
    finally:
        ev.close()
    assert reports and all(r["shards"] == [culprit] for r in reports)
    assert {"volume", "window", "offset", "size", "shards"} <= set(reports[0])
    # the report names the flipped byte itself
    assert all((r["volume"], r["offset"], r["size"], r["window"])
               == (VID, x, 1, x // (1 << 20)) for r in reports)
    assert ev.rereads == len(reports)
    ref = open_ref(d)
    try:
        from seaweedfs_tpu.storage.needle import CrcMismatch as RefCrc
        with pytest.raises(RefCrc):
            ref.read_needle(nid, contents[nid][0])
    finally:
        ref.close()


def test_direct_read_of_a_rotten_shard_is_decoded_around_it(tmp_path):
    """A byte flipped inside a needle that is read straight from its own
    shard (no shard lost): the read decodes that interval from k others,
    serves the written bytes and reports the shard."""
    d = str(tmp_path / "v")
    contents = build_volume(d)
    base = os.path.join(d, str(VID))
    nid, x = data_byte_on(base, 5)
    flip(base, 5, x)
    ev, reports = open_port(d)
    try:
        assert ev.read_needle(nid, contents[nid][0]).data == contents[nid][1]
    finally:
        ev.close()
    assert [(r["shards"], r["offset"], r["size"]) for r in reports] == \
        [([5], x, 1)]
    ref = open_ref(d)
    try:
        with pytest.raises(Exception, match="crc mismatch"):
            ref.read_needle(nid, contents[nid][0])
    finally:
        ref.close()


def test_failed_decode_is_not_left_in_the_recover_cache(tmp_path):
    """The recover cache holds only decodes that passed: after a read
    that failed, no entry of the needle's intervals; after a read that
    was decoded again without the culprit, the lost rows' true bytes."""
    d = str(tmp_path / "v")
    contents = build_volume(d)
    base = os.path.join(d, str(VID))
    truth = {}
    for s in range(N):
        with open(base + pl.to_ext(s), "rb") as f:
            truth[s] = f.read()
    nid, x = data_byte_on(base, 0)
    flip(base, 12, x)
    # 10 survivors: the read fails and leaves nothing cached
    lose(base, (0, 3, 7, 9))
    rc = EcRecoverCache(8 << 20)
    ev, reports = open_port(d, rc)
    try:
        with pytest.raises(CrcMismatch):
            ev.read_needle(nid, contents[nid][0])
        assert not any(rc.peek_contains(k) for k in needle_keys(ev, base,
                                                                nid))
    finally:
        ev.close()
    assert reports == []
    # 11 survivors: the passing decode is cached, and it is the truth
    with open(base + pl.to_ext(9), "wb") as f:
        f.write(truth[9])
    rc = EcRecoverCache(8 << 20)
    ev, reports = open_port(d, rc)
    try:
        assert ev.read_needle(nid, contents[nid][0]).data == \
            contents[nid][1]
        cached = [k for k in needle_keys(ev, base, nid)
                  if rc.peek_contains(k)]
        assert cached and all(k[1] in (0, 3, 7) for k in cached)
        for _, sid, off, size in cached:
            assert rc.get((VID, sid, off, size)) == \
                truth[sid][off:off + size]
    finally:
        ev.close()
    assert [r["shards"] for r in reports] == [[12]]


def test_fewer_than_eleven_survivors_still_fail_and_report_nothing(tmp_path):
    """With 4 shards lost no survivor can be left out: the read raises
    CrcMismatch as before, and nothing is reported."""
    d = str(tmp_path / "v")
    contents = build_volume(d)
    base = os.path.join(d, str(VID))
    lose(base, (0, 3, 7, 9))
    nid, x = data_byte_on(base, 0)
    flip(base, 5, x)
    ev, reports = open_port(d)
    try:
        with pytest.raises(CrcMismatch):
            ev.read_needle(nid, contents[nid][0])
        # the intact needles still read
        other = next(k for k in contents if k != nid)
        assert ev.read_needle(other, contents[other][0]).data == \
            contents[other][1]
    finally:
        ev.close()
    assert reports == []


def test_two_rotten_survivors_fail_the_read(tmp_path):
    """Rot in two survivors under one needle: no single survivor left
    out makes it pass, so the read fails and nothing is reported."""
    d = str(tmp_path / "v")
    contents = build_volume(d)
    base = os.path.join(d, str(VID))
    lose(base, (0, 3, 7))
    nid, x = data_byte_on(base, 0)
    flip(base, 5, x)
    flip(base, 12, x)
    ev, reports = open_port(d)
    try:
        with pytest.raises(CrcMismatch):
            ev.read_needle(nid, contents[nid][0])
    finally:
        ev.close()
    assert reports == []


def test_a_rotten_survivor_of_a_three_row_group_is_left_out(tmp_path,
                                                           monkeypatch):
    """Shards {1,2,3} lost (11 survivors) under a needle that covers all
    three whole blocks of one stripe row, so one recover decodes the
    three from the same 10 survivors, and one byte of survivor 5 flipped
    in that row: the needle is served, shard 5 is reported once at the
    flipped byte, and the three intervals are cached with their true
    bytes. The reference raises CrcMismatch on the same files."""
    d = str(tmp_path / "v")
    os.makedirs(d)
    v = Volume(d, "", VID)
    rng = random.Random(31)
    data = rng.randbytes(9 * SB)
    for i, n in enumerate((700, 9 * SB, 1500), 1):
        v.write_needle(Needle(cookie=i * 7, id=i,
                              data=data if i == 2 else rng.randbytes(n)))
    v.close()
    base = os.path.join(d, str(VID))
    pl.write_ec_files(base, encoder=pl.get_encoder("cpu"), large_block=LB,
                      small_block=SB, buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    truth = {}
    for s in (1, 2, 3):
        with open(base + pl.to_ext(s), "rb") as f:
            truth[s] = f.read()
    lose(base, (1, 2, 3))
    rc = EcRecoverCache(8 << 20)
    ev, reports = open_port(d, rc)
    groups = []
    real = ev._recover_rows_src

    def spy(want_sids, offset, size):
        groups.append((tuple(want_sids), offset, size))
        return real(want_sids, offset, size)

    monkeypatch.setattr(ev, "_recover_rows_src", spy)
    try:
        off, n = ev.find_needle(2)
        ivs = [iv.to_shard_and_offset(LB, SB) + (iv.size,)
               for iv in locate_data(LB, SB, K * shard_size(base), off,
                                     t.actual_size(n, t.CURRENT_VERSION))]
        want = (1, 2, 3)
        ((soff, size),) = {(o, m) for sid, o, m in ivs if sid in want}
        assert size == SB
        x = soff + 100
        flip(base, 5, x)
        assert ev.read_needle(2, 14).data == data
        assert groups == [(want, soff, size)]
        for s in want:
            assert rc.get((VID, s, soff, size)) == \
                truth[s][soff:soff + size]
    finally:
        ev.close()
    assert [(r["shards"], r["offset"], r["size"]) for r in reports] == \
        [([5], x, 1)]
    assert ev.rereads == 1
    ref = open_ref(d)
    try:
        from seaweedfs_tpu.storage.needle import CrcMismatch as RefCrc
        with pytest.raises(RefCrc):
            ref.read_needle(2, 14)
    finally:
        ref.close()


# ---------------------------------------------------------------------
# rebuilds
# ---------------------------------------------------------------------

def ref_rebuild(base: str) -> list:
    from seaweedfs_tpu.ec import pipeline as ref_pl
    from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder
    return ref_pl.rebuild_ec_files(base, encoder=CpuEncoder(),
                                   buffer_size=SB)


def port_rebuild(base: str, rot: list, stats: dict | None = None) -> list:
    return pl.rebuild_ec_files(base, encoder=pl.get_encoder("cpu"),
                               buffer_size=SB, large_block=LB,
                               small_block=SB, rot_found=rot, stats=stats)


def two_copies(tmp_path) -> "tuple[str, str, dict]":
    d = str(tmp_path / "port")
    contents = build_volume(d)
    shutil.copytree(d, str(tmp_path / "ref"))
    return (os.path.join(d, str(VID)),
            os.path.join(str(tmp_path / "ref"), str(VID)), contents)


def test_rebuild_with_twelve_inputs_pins_the_culprit(tmp_path):
    """Shards {0,3} lost, 12 present, one byte of data shard 5 flipped:
    the check rows disagree in that window only, the culprit is pinned
    to [5] there, and the rebuilt files equal the encoded ones. The
    reference decodes from the first 10, shard 5 among them, and writes
    a shard that differs."""
    base, ref_base, _ = two_copies(tmp_path)
    x = 3 * SB + 321
    for b in (base, ref_base):
        flip(b, 5, x)
    want = lose(base, (0, 3))
    lose(ref_base, (0, 3))
    rot, stats = [], {}
    assert port_rebuild(base, rot, stats) == [0, 3]
    assert {s: sha(base + pl.to_ext(s)) for s in (0, 3)} == want
    assert rot == [{"window": 3, "offset": 3 * SB, "size": SB,
                    "shards": [5], "found_by": "rebuild"}]
    windows = -(-shard_size(base) // SB)
    assert stats["launches"] == -(-windows // pl.DEFAULT_BATCH_WINDOWS)
    assert stats["pin_launches"] == K + gf.REBUILD_CHECK_ROWS
    assert ref_rebuild(ref_base) == [0, 3]
    assert {s: sha(ref_base + pl.to_ext(s)) for s in (0, 3)} != want


def test_rebuild_with_eleven_inputs_decides_by_needle_crcs(tmp_path):
    """Shards {0,3,7} lost, 11 present, one byte flipped in data shard 5
    where a needle of shard 0 is decoded from it: one check row cannot
    pin the culprit, the needle CRCs of the window decide it, and the
    rebuilt files equal the encoded ones. The reference writes shards
    that differ."""
    base, ref_base, _ = two_copies(tmp_path)
    _, x = data_byte_on(base, 0)
    for b in (base, ref_base):
        flip(b, 5, x)
    want = lose(base, (0, 3, 7))
    lose(ref_base, (0, 3, 7))
    rot = []
    assert port_rebuild(base, rot) == [0, 3, 7]
    assert {s: sha(base + pl.to_ext(s)) for s in (0, 3, 7)} == want
    assert [(r["window"], r["shards"]) for r in rot] == [(x // SB, [5])]
    ref_rebuild(ref_base)
    assert {s: sha(ref_base + pl.to_ext(s)) for s in (0, 3, 7)} != want


@pytest.mark.parametrize("lost", [(0, 3), (0, 3, 7)])
def test_rebuild_refuses_what_it_cannot_pin(tmp_path, lost):
    """Two inputs rotten in one window: with 12 or with 11 inputs no
    single input can be left out, so the rebuild raises RebuildRotError
    and writes no shard file at all (not even a temporary one), where
    the reference writes shards that differ from the encoded ones.
    (The two flips differ: one check row cannot see two flips that
    cancel in it, which is the limit of a code of distance 2.)"""
    base, ref_base, _ = two_copies(tmp_path)
    _, x = data_byte_on(base, 0)
    for b in (base, ref_base):
        flip(b, 5, x)
        flip(b, 12, x, 0x01)
    want = lose(base, lost)
    lose(ref_base, lost)
    rot = []
    with pytest.raises(pl.RebuildRotError):
        port_rebuild(base, rot)
    assert rot == []
    assert [f for f in os.listdir(os.path.dirname(base))
            if any(f.startswith(f"{VID}{pl.to_ext(s)}") for s in lost)] == []
    ref_rebuild(ref_base)
    assert {s: sha(ref_base + pl.to_ext(s)) for s in lost} != want


def test_rebuild_from_exactly_k_inputs_checks_nothing(tmp_path):
    """With exactly k inputs there is nothing to check against: the
    rebuild keeps its old behaviour, finds nothing and reports nothing
    (its docstring says so)."""
    base, _, _ = two_copies(tmp_path)
    flip(base, 5, 77)
    lose(base, (0, 3, 7, 9))
    rot, stats = [], {}
    assert port_rebuild(base, rot, stats) == [0, 3, 7, 9]
    assert rot == [] and "pin_launches" not in stats
    assert "exactly" in pl.rebuild_ec_files.__doc__
    assert "nothing is checked" in pl.rebuild_ec_files.__doc__


def test_clean_rebuild_launches_as_before(tmp_path):
    """No rot: the check rows ride the same launches (one per block),
    and nothing is pinned."""
    base, _, _ = two_copies(tmp_path)
    want = lose(base, (2, 12))
    rot, stats = [], {}
    assert port_rebuild(base, rot, stats) == [2, 12]
    assert {s: sha(base + pl.to_ext(s)) for s in (2, 12)} == want
    windows = -(-shard_size(base) // SB)
    assert stats["launches"] == -(-windows // pl.DEFAULT_BATCH_WINDOWS)
    assert rot == [] and "pin_launches" not in stats


# ---------------------------------------------------------------------
# over HTTP: the volume server, the scrubber's report, the planner
# ---------------------------------------------------------------------

def _run(coro):
    return asyncio.run(coro)


async def _encoded_volume(c, rng, n: int = 40) -> "tuple[int, dict]":
    """Write n needles through the cluster into one volume, EC-encode
    and mount it on its server; returns (vid, {fid: data})."""
    vs = c.servers[0]
    written, vid = {}, None
    for _ in range(n):
        a = await c.assign(collection="rot")
        if vid is None:
            vid = int(a["fid"].split(",")[0])
        if int(a["fid"].split(",")[0]) != vid:
            continue
        data = rng.randbytes(rng.randint(200, 3000))
        assert (await c.put(a["fid"], a["url"], data))[0] == 201
        written[a["fid"]] = data
    for path in ("/admin/volume/readonly", "/admin/ec/generate",
                 "/admin/ec/mount", "/admin/volume/delete"):
        async with c.http.post(f"http://{vs.url}{path}",
                               params={"volume": str(vid),
                                       "collection": "rot"}) as r:
            assert r.status == 200, (path, await r.text())
    return vid, written


def test_http_rebuild_shard_gathers_check_inputs_and_pins(tmp_path):
    """/admin/ec/rebuild_shard of shard 12 in place, with every other
    shard listed as a source: the server gathers k + 2 inputs, the rot
    planted in input 5 is pinned and reported (the response and
    /debug/scrub found_windows), and shard 12 comes out as encoded."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            vid, _ = await _encoded_volume(c, random.Random(21))
            base = vs._base_name(vid, "rot")
            want = sha(base + pl.to_ext(12))
            flip(base, 5, 100)
            sources = ",".join(f"{s}:{vs.url}" for s in range(N) if s != 12)
            async with c.http.post(
                    f"http://{vs.url}/admin/ec/rebuild_shard",
                    params={"volume": str(vid), "collection": "rot",
                            "shards": "12", "sources": sources}) as r:
                body = await r.json()
                assert r.status == 200, body
            assert body["inputs"] == list(range(K + gf.REBUILD_CHECK_ROWS))
            assert [(w["volume"], w["shards"]) for w in body["rot"]] == \
                [(vid, [5])]
            assert sha(base + pl.to_ext(12)) == want
            async with c.http.get(f"http://{vs.url}/debug/scrub") as r:
                found = (await r.json())["scrub"]["found_windows"]
            assert [(w["volume"], w["shards"], w["found_by"])
                    for w in found] == [(vid, [5], "rebuild")]
    _run(go())


def test_http_rebuild_shard_restores_the_rot_copy_when_it_refuses(tmp_path):
    """Two inputs rotten in one window: the rebuild refuses, the server
    answers 500, and the copy of shard 12 it had set aside comes back,
    byte for byte and mounted; no rebuilt or temporary file stays."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            vid, _ = await _encoded_volume(c, random.Random(22))
            base = vs._base_name(vid, "rot")
            flip(base, 12, 50)          # the copy to set aside and keep
            before = sha(base + pl.to_ext(12))
            flip(base, 1, 700)
            flip(base, 2, 700)
            sources = ",".join(f"{s}:{vs.url}" for s in range(N) if s != 12)
            async with c.http.post(
                    f"http://{vs.url}/admin/ec/rebuild_shard",
                    params={"volume": str(vid), "collection": "rot",
                            "shards": "12", "sources": sources}) as r:
                assert r.status == 500, await r.text()
            assert sha(base + pl.to_ext(12)) == before
            assert 12 in vs.store.ec_volumes[vid].shards
            left = [f for f in os.listdir(os.path.dirname(base))
                    if f.endswith((".rot", ".rebuild"))]
            assert left == []
    _run(go())


def test_degraded_get_over_http_reports_to_the_planner(tmp_path):
    """Shards {0,3,7} unmounted and deleted, one byte of parity 12
    flipped under a needle of shard 0: every GET returns the written
    bytes, /debug/scrub lists the read's report, the autopilot's
    observer reads it as a corruption of shard 12, and the planner
    drops shard 12 from the rebuild's sources and rebuilds it in
    place."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            vid, written = await _encoded_volume(c, random.Random(23))
            base = vs._base_name(vid, "rot")
            for path in ("/admin/ec/unmount", "/admin/ec/delete_shards"):
                async with c.http.post(
                        f"http://{vs.url}{path}",
                        params={"volume": str(vid), "collection": "rot",
                                "shards": "0,3,7"}) as r:
                    assert r.status == 200, await r.text()
            # a byte in the middle of a needle on lost shard 0
            dat_size = vs.store.ec_volumes[vid].dat_size
            x = None
            with open(base + ".ecx", "rb") as f:
                index = sorted(walk_index_blob(f.read()), key=lambda e: e[1])
            for key, noff, nsize in index:
                mid = noff + DATA_AT + (nsize - 6) // 2
                (iv,) = locate_data(vs.store.ec_large_block,
                                    vs.store.ec_small_block, dat_size,
                                    mid, 1)
                sid, soff = iv.to_shard_and_offset(
                    vs.store.ec_large_block, vs.store.ec_small_block)
                if sid == 0:
                    x = soff
                    break
            assert x is not None
            flip(base, 12, x)
            vs.store.drop_cached_volume(vid)
            for fid, data in written.items():
                async with c.http.get(f"http://{vs.url}/{fid}") as r:
                    assert r.status == 200, fid
                    assert await r.read() == data, fid
            async with c.http.get(f"http://{vs.url}/debug/scrub") as r:
                found = (await r.json())["scrub"]["found_windows"]
            assert found and {w["found_by"] for w in found} == {"read"}
            assert all(w["volume"] == vid and w["shards"] == [12]
                       for w in found)

            obs = Observer(c.master)
            corrupt, errors = {}, []
            await obs._probe_node(vs.url, corrupt, errors)
            reps = list(corrupt.values())
            assert reps and all(r.vid == vid and r.shards == (12,)
                                for r in reps)
            held = tuple((s, (vs.url,)) for s in range(N)
                         if s not in (0, 3, 7))
            snap = ClusterSnapshot(
                nodes=(NodeState(url=vs.url, free_slots=10),),
                ec_volumes=(EcVolumeState(vid=vid, collection="rot",
                                          shards=held),),
                corruptions=tuple(reps))
            actions, _ = plan(snap, PlannerConfig())
            rebuilds = [a for a in actions if a.kind == KIND_REBUILD]
            assert rebuilds
            for a in rebuilds:
                assert 12 not in [s for s, _ in a.sources]
            assert any(a.shards == (12,) and a.target == vs.url
                       for a in rebuilds)
            # 10 clean survivors: all of them are gathered and paid for
            assert all(a.bytes_est == K * (1 << 20) for a in rebuilds)
    _run(go())
