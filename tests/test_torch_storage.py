"""The port's storage engine (seaweedfs_tpu_torch.storage): the cases of
tests/test_storage.py and tests/test_needle_fuzz.py pointed at the port,
then parity with the JAX package: the same seeded needles give the same
.dat and .idx bytes, and a store written by either package is mounted
and read by the other.
"""

import hashlib
import os
import random

import numpy as np
import pytest

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import (
    FLAG_HAS_LAST_MODIFIED, FLAG_HAS_NAME, CrcMismatch, Needle)
from seaweedfs_tpu_torch.storage.needle_map import (
    MemoryNeedleMap, SortedFileNeedleMap, write_sorted_index)
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement, SuperBlock
from seaweedfs_tpu_torch.storage.volume import (
    AlreadyDeleted, NotFound, Volume, VolumeError)
from seaweedfs_tpu_torch.util import crc32c


def test_crc32c_known_vectors():
    # RFC 3720 test vector: 32 bytes of zeros -> 0x8A9136AA
    assert crc32c.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    # python fallback must agree with native
    assert crc32c._crc32c_py(0, b"123456789") == 0xE3069283


def test_needle_roundtrip_v3():
    n = Needle(cookie=0x12345678, id=0xABCDEF, data=b"hello world",
               name=b"x.txt", mime=b"text/plain", last_modified=1700000000,
               ttl=t.TTL.parse("3h"), pairs=b'{"a":"b"}')
    blob = n.to_bytes(t.VERSION3)
    assert len(blob) % 8 == 0
    m = Needle.from_bytes(blob, t.VERSION3)
    assert (m.cookie, m.id, m.data) == (n.cookie, n.id, b"hello world")
    assert m.name == b"x.txt"
    assert m.mime == b"text/plain"
    assert m.last_modified == 1700000000
    assert m.ttl == t.TTL.parse("3h")
    assert m.pairs == b'{"a":"b"}'
    assert m.append_at_ns == n.append_at_ns


def test_needle_roundtrip_versions():
    for version in (t.VERSION1, t.VERSION2, t.VERSION3):
        n = Needle(cookie=7, id=42, data=b"payload")
        m = Needle.from_bytes(n.to_bytes(version), version)
        assert m.data == b"payload", version


def test_needle_crc_check():
    n = Needle(cookie=1, id=2, data=b"data")
    blob = bytearray(n.to_bytes(t.VERSION3))
    blob[t.NEEDLE_HEADER_SIZE + 4] ^= 0xFF  # corrupt data byte
    with pytest.raises(CrcMismatch):
        Needle.from_bytes(bytes(blob), t.VERSION3)


def test_needle_empty_data_tombstone_shape():
    n = Needle(cookie=1, id=2, data=b"")
    blob = n.to_bytes(t.VERSION3)
    m = Needle.from_bytes(blob, t.VERSION3)
    assert m.size == 0 and m.data == b""


def test_file_id_roundtrip():
    fid = t.FileId(3, 0x01637037, 0xD6000000)
    s = str(fid)
    assert s.startswith("3,")
    back = t.FileId.parse(s)
    assert back == fid
    # known reference formatting: leading zero bytes of the key stripped
    assert t.FileId.parse("3,01637037d6aabbcc") is not None
    with pytest.raises(ValueError):
        t.FileId.parse("nocomma")


def test_ttl_parse_format():
    assert t.TTL.parse("") == t.TTL()
    assert str(t.TTL.parse("5d")) == "5d"
    assert t.TTL.parse("90") == t.TTL(90, t.TTL_MINUTE)
    tt = t.TTL.parse("7M")
    assert t.TTL.from_uint32(tt.to_uint32()) == tt
    assert t.TTL.parse("2w").minutes == 2 * 10080


def test_replica_placement():
    rp = ReplicaPlacement.parse("012")
    assert rp.copy_count == 4
    assert str(ReplicaPlacement.from_byte(rp.to_byte())) == "012"
    with pytest.raises(ValueError):
        ReplicaPlacement.parse("9zz")


def test_super_block_roundtrip():
    sb = SuperBlock(version=3, replica_placement=ReplicaPlacement.parse("001"),
                    ttl=t.TTL.parse("1h"), compaction_revision=5)
    back = SuperBlock.from_bytes(sb.to_bytes())
    assert back == sb


def test_memory_needle_map_idx_replay(tmp_path):
    idx = str(tmp_path / "1.idx")
    nm = MemoryNeedleMap(idx)
    nm.put(1, 8, 100)
    nm.put(2, 120, 50)
    nm.put(1, 256, 120)   # overwrite
    nm.delete(2, 512)
    nm.close()

    nm2 = MemoryNeedleMap(idx)
    assert nm2.get(1).offset == 256
    assert nm2.get(1).size == 120
    assert nm2.get(2).size == t.TOMBSTONE_FILE_SIZE  # tombstone retained
    assert nm2.file_count == 2
    assert nm2.deleted_count == 2  # one overwrite + one delete
    nm2.destroy()
    assert not os.path.exists(idx)


def test_sorted_file_map(tmp_path):
    path = str(tmp_path / "1.sdx")
    entries = [(k, k * 64, 10 + k) for k in range(0, 200, 3)]
    write_sorted_index(entries, path)
    sm = SortedFileNeedleMap(path)
    assert sm.get(3).size == 13
    assert sm.get(198).offset == 198 * 64
    assert sm.get(4) is None
    sm.close()


def test_volume_write_read_delete(tmp_path):
    v = Volume(str(tmp_path), "", 1)
    n = Needle(cookie=0xAA, id=1, data=b"first")
    off, size = v.write_needle(n)
    assert off == 8  # right after superblock
    got = v.read_needle(1, cookie=0xAA)
    assert got.data == b"first"

    # overwrite with same cookie
    v.write_needle(Needle(cookie=0xAA, id=1, data=b"second"))
    assert v.read_needle(1).data == b"second"

    # overwrite with wrong cookie rejected
    with pytest.raises(VolumeError):
        v.write_needle(Needle(cookie=0xBB, id=1, data=b"evil"))

    # delete -> AlreadyDeleted on read
    reclaimed = v.delete_needle(Needle(cookie=0xAA, id=1))
    assert reclaimed > 0
    with pytest.raises(AlreadyDeleted):
        v.read_needle(1)
    with pytest.raises(NotFound):
        v.read_needle(999)
    v.close()


def test_volume_reload_after_crash(tmp_path):
    v = Volume(str(tmp_path), "c", 7)
    for i in range(10):
        v.write_needle(Needle(cookie=i, id=i, data=bytes([i]) * (i + 1)))
    v.delete_needle(Needle(cookie=3, id=3))
    v.close()

    v2 = Volume(str(tmp_path), "c", 7, create_if_missing=False)
    assert v2.read_needle(5).data == b"\x05" * 6
    with pytest.raises(AlreadyDeleted):
        v2.read_needle(3)
    st = v2.stat()
    assert st.file_count == 10
    assert st.deleted_count == 1
    v2.close()


def test_volume_torn_tail_truncated(tmp_path):
    v = Volume(str(tmp_path), "", 9)
    v.write_needle(Needle(cookie=1, id=1, data=b"good"))
    end = v.data_size()
    v.close()
    # simulate a torn write past the last indexed needle
    with open(str(tmp_path / "9.dat"), "ab") as f:
        f.write(b"\xde\xad\xbe\xef" * 3)
    v2 = Volume(str(tmp_path), "", 9, create_if_missing=False)
    assert v2.data_size() == end
    assert v2.read_needle(1).data == b"good"
    v2.close()


def test_volume_scan(tmp_path):
    v = Volume(str(tmp_path), "", 11)
    for i in range(1, 4):
        v.write_needle(Needle(cookie=i, id=i, data=b"x" * i))
    v.delete_needle(Needle(cookie=2, id=2))
    seen = []
    v.scan(lambda n, off: seen.append((n.id, n.size, off)))
    assert len(seen) == 4  # 3 writes + 1 tombstone
    assert seen[-1][1] == 0  # tombstone has size 0
    v.close()


def test_volume_rewrite_after_delete(tmp_path):
    v = Volume(str(tmp_path), "", 21)
    v.write_needle(Needle(cookie=1, id=7, data=b"one"))
    v.delete_needle(Needle(cookie=1, id=7))
    # re-writing a deleted id must succeed, even with a new cookie
    v.write_needle(Needle(cookie=2, id=7, data=b"two"))
    assert v.read_needle(7, cookie=2).data == b"two"
    v.close()


def test_volume_reopen_all_deleted(tmp_path):
    v = Volume(str(tmp_path), "", 22)
    v.write_needle(Needle(cookie=1, id=1, data=b"x"))
    v.delete_needle(Needle(cookie=1, id=1))
    v.close()
    v2 = Volume(str(tmp_path), "", 22, create_if_missing=False)
    with pytest.raises(AlreadyDeleted):
        v2.read_needle(1)
    v2.close()


def test_volume_reopen_keeps_trailing_tombstone(tmp_path):
    v = Volume(str(tmp_path), "", 23)
    v.write_needle(Needle(cookie=1, id=1, data=b"a"))
    v.write_needle(Needle(cookie=2, id=2, data=b"b"))
    v.delete_needle(Needle(cookie=1, id=1))
    end = v.data_size()
    v.close()
    v2 = Volume(str(tmp_path), "", 23, create_if_missing=False)
    assert v2.data_size() == end  # tombstone record NOT truncated
    records = []
    v2.scan(lambda n, off: records.append((n.id, n.size)))
    assert records[-1] == (1, 0)
    v2.close()


def test_needle_field_limits():
    from seaweedfs_tpu_torch.storage.needle import NeedleError
    with pytest.raises(NeedleError):
        Needle(cookie=1, id=1, data=b"x", mime=b"m" * 256).to_bytes()
    with pytest.raises(NeedleError):
        Needle(cookie=1, id=1, data=b"x", pairs=b"p" * 65536).to_bytes()
    # name is clamped, not an error (reference truncates at 255)
    n = Needle(cookie=1, id=1, data=b"x", name=b"n" * 300)
    m = Needle.from_bytes(n.to_bytes(), 3)
    assert len(m.name) == 255


def test_volume_ttl_expiry(tmp_path):
    v = Volume(str(tmp_path), "", 13, ttl=t.TTL.parse("1m"))
    n = Needle(cookie=1, id=1, data=b"z", last_modified=100)  # long ago
    n.set_flag(0x08)  # has last modified
    v.write_needle(n)
    with pytest.raises(NotFound):
        v.read_needle(1)
    v.close()


def test_preallocate_keeps_append_offsets(tmp_path):
    """Preallocation must reserve blocks WITHOUT moving the append tail
    (FALLOC_FL_KEEP_SIZE, volume_create_linux.go:19): appends derive
    their offset from st_size."""
    from seaweedfs_tpu_torch.storage.volume import Volume
    from seaweedfs_tpu_torch.storage.needle import Needle

    v = Volume(str(tmp_path), "", 31, preallocate=1 << 20)
    off, _ = v.write_needle(Needle(cookie=5, id=1, data=b"pre" * 50))
    assert off < 4096, "append landed past the preallocated region"
    assert v.data_size() < 4096
    assert v.read_needle(1, cookie=5).data == b"pre" * 50
    v.close()
    # reload: integrity check passes, appends continue at the tail
    v2 = Volume(str(tmp_path), "", 31, create_if_missing=False)
    off2, _ = v2.write_needle(Needle(cookie=6, id=2, data=b"y"))
    assert off < off2 < 8192
    v2.close()


def test_ttl_volume_expiry_reclaims(tmp_path):
    """Whole-volume TTL reclamation rides the heartbeat walk
    (store.go:165-200 + volume.go expired/expiredLongEnough)."""
    import os
    import time as _time

    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    st = Store([str(tmp_path)])
    v = st.add_volume(5, ttl="1m")
    v.write_needle(Needle(cookie=1, id=1, data=b"short-lived"))
    hb = st.collect_heartbeat()
    assert [m.id for m in hb.volumes] == [5]

    # age past ttl but inside the grace window: no longer advertised,
    # files still on disk
    v.last_modified_ts = _time.time() - 63  # just past the 1m ttl
    hb = st.collect_heartbeat()
    assert hb.volumes == []
    assert os.path.exists(os.path.join(str(tmp_path), "5.dat"))
    assert 5 in st.volumes

    # age past ttl + removal delay: destroyed and reported deleted
    v.last_modified_ts = _time.time() - 3600
    hb = st.collect_heartbeat()
    assert hb.volumes == []
    assert [m.id for m in hb.deleted_volumes] == [5]
    assert 5 not in st.volumes
    assert not os.path.exists(os.path.join(str(tmp_path), "5.dat"))

    # non-TTL volumes are never reclaimed
    v2 = st.add_volume(6)
    v2.write_needle(Needle(cookie=1, id=1, data=b"eternal"))
    v2.last_modified_ts = _time.time() - 10_000_000
    hb = st.collect_heartbeat()
    assert [m.id for m in hb.volumes] == [6]
    st.close()


def test_ttl_watermark_survives_restart(tmp_path):
    """last_modified_ts must be restored on load, or TTL reclamation
    (store.go expired()) goes dead after a volume-server restart."""
    import time as _time

    from seaweedfs_tpu_torch.storage.needle import (FLAG_HAS_LAST_MODIFIED,
                                              Needle)
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(str(tmp_path), "", 9)
    n = Needle(cookie=1, id=1, data=b"x",
               last_modified=int(_time.time()))
    n.set_flag(FLAG_HAS_LAST_MODIFIED)
    v.write_needle(n)
    wm = v.last_modified_ts
    assert wm > 0
    v.close()
    v2 = Volume(str(tmp_path), "", 9, create_if_missing=False)
    assert v2.last_modified_ts == wm
    v2.close()


# ---- tests/test_needle_fuzz.py ----

def _rand_needle(rng: random.Random, live: bool = False) -> Needle:
    n = Needle(
        cookie=rng.randrange(1 << 32),
        id=rng.randrange(1, 1 << 63),
        data=rng.randbytes(rng.randint(0, 2000)),
        name=rng.randbytes(rng.randint(0, 80)) if rng.random() < 0.5
        else b"",
        mime=(b"application/x-" + rng.randbytes(5).hex().encode())
        if rng.random() < 0.4 else b"",
        pairs=(b'{"k":"' + rng.randbytes(4).hex().encode() + b'"}')
        if rng.random() < 0.3 else b"",
        ttl=t.TTL(rng.randint(1, 255), rng.choice((1, 2, 3, 4)))
        if rng.random() < 0.3 else t.TTL(),
    )
    if live:
        # volume reads enforce TTL expiry against last_modified; keep
        # these needles alive
        import time
        n.ttl = t.TTL()
        n.last_modified = int(time.time())
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
    elif rng.random() < 0.5:
        n.last_modified = rng.randrange(1, 1 << 38)
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
    if rng.random() < 0.5:
        n.append_at_ns = rng.randrange(1, 1 << 62)
    return n


def test_needle_roundtrip_fuzz():
    rng = random.Random(99)
    for case in range(400):
        version = rng.choice((2, 3))
        n = _rand_needle(rng)
        blob = n.to_bytes(version)
        assert len(blob) % 8 == 0, "record not 8-byte aligned"
        m = Needle.from_bytes(blob, version)
        assert m.cookie == n.cookie and m.id == n.id, case
        assert m.data == n.data, case
        assert m.name == n.name, case
        assert m.mime == n.mime, case
        assert m.pairs == n.pairs, case
        assert (m.ttl.count, m.ttl.unit) == (n.ttl.count, n.ttl.unit), case
        if n.has(FLAG_HAS_LAST_MODIFIED):
            assert m.last_modified == n.last_modified, case
        if version == 3:
            assert m.append_at_ns == n.append_at_ns, case
        # re-serialization is byte-stable
        assert m.to_bytes(version) == blob, case
        # v1 keeps only cookie/id/data
        n1 = Needle(cookie=n.cookie, id=n.id, data=n.data)
        b1 = n1.to_bytes(1)
        m1 = Needle.from_bytes(b1, 1)
        assert (m1.cookie, m1.id, m1.data) == (n.cookie, n.id, n.data)


def test_needle_volume_roundtrip_fuzz(tmp_path):
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = random.Random(7)
    v = Volume(str(tmp_path), "", 77)
    wrote = []
    for i in range(60):
        n = _rand_needle(rng, live=True)
        n.id = i + 1
        v.write_needle(n)
        wrote.append(n)
    for n in wrote:
        got = v.read_needle(n.id, n.cookie)
        assert got.data == n.data
        assert got.name == n.name
        assert got.mime == n.mime
        assert got.pairs == n.pairs
    v.close()
    # reload from disk: integrity check + reads still agree
    v2 = Volume(str(tmp_path), "", 77, create_if_missing=False)
    for n in wrote:
        assert v2.read_needle(n.id, n.cookie).data == n.data
    v2.close()


# ---- parity with the JAX package ----

def _seeded_needles(seed: int, count: int) -> list[tuple]:
    """(id, cookie, data, name, mime, last_modified, pairs) from a seed,
    with a spread of record sizes and optional fields."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        size = int(rng.integers(0, 3000)) if i % 7 else 70_000 + i
        out.append((
            i + 1, int(rng.integers(1, 1 << 32)), rng.bytes(size),
            f"file-{i}.bin".encode() if i % 2 else b"",
            b"application/octet-stream" if i % 3 else b"",
            1_700_000_000 + i if i % 4 == 0 else 0,
            b'{"k":"v"}' if i % 5 == 0 else b""))
    return out


def _write_volume(pkg: str, dirname: str, specs: list[tuple],
                  monkeypatch) -> None:
    """Write specs (then delete every ninth needle) into volume 3 of
    collection "c" through `pkg`'s Volume, with append_at_ns taken from
    one deterministic counter."""
    import importlib
    import time as _time
    needle = importlib.import_module(f"{pkg}.storage.needle")
    volume = importlib.import_module(f"{pkg}.storage.volume")
    clock = iter(range(1_700_000_000_000_000_000, 1 << 62, 1000))
    monkeypatch.setattr(_time, "time_ns", lambda: next(clock))
    v = volume.Volume(dirname, "c", 3)
    for nid, cookie, data, name, mime, lm, pairs in specs:
        v.write_needle(needle.Needle(cookie=cookie, id=nid, data=data,
                                     name=name, mime=mime,
                                     last_modified=lm, pairs=pairs))
    for nid, cookie, *_ in specs[::9]:
        v.delete_needle(needle.Needle(cookie=cookie, id=nid))
    v.close()
    monkeypatch.undo()


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_volume_files_equal_the_jax_package(tmp_path, monkeypatch):
    """The same seeded needles, written and partly deleted through each
    package's Volume, give byte-identical .dat and .idx files."""
    specs = _seeded_needles(11, 40)
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    _write_volume("seaweedfs_tpu", str(ref), specs, monkeypatch)
    _write_volume("seaweedfs_tpu_torch", str(port), specs, monkeypatch)
    for ext in (".dat", ".idx"):
        assert _digest(str(ref / ("c_3" + ext))) == \
            _digest(str(port / ("c_3" + ext))), ext
    assert os.path.getsize(str(port / "c_3.dat")) > 70_000


def _fill_store(pkg: str, dirname: str, monkeypatch) -> dict:
    """Through `pkg`: a Store with a plain volume 1 and an EC volume 2
    (encoded with `pkg`'s host path, one needle deleted after the
    encode, shard 4 removed). Returns {(vid, nid): (cookie, data) or
    None for deleted}."""
    import importlib
    needle = importlib.import_module(f"{pkg}.storage.needle")
    store_mod = importlib.import_module(f"{pkg}.storage.store")
    pl = importlib.import_module(f"{pkg}.ec.pipeline")
    if pkg == "seaweedfs_tpu":
        from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder
        encoder = CpuEncoder()
    else:
        encoder = pl.get_encoder("cpu")
    rng = random.Random(5)
    want = {}
    st = store_mod.Store([dirname])
    for vid in (1, 2):
        st.add_volume(vid)
        for nid in range(1, 31):
            data = rng.randbytes(rng.choice((10, 3000, 40_000)))
            cookie = rng.randrange(1, 1 << 32)
            st.write_needle(vid, needle.Needle(
                cookie=cookie, id=nid, data=data, name=b"n%d" % nid,
                mime=b"text/plain"))
            want[(vid, nid)] = (cookie, data)
    base = st.volumes[2].file_name()
    st.mark_readonly(2)
    st.unmount_volume(2)
    pl.encode_volume(base, encoder=encoder, large_block=1 << 20,
                     small_block=4096)
    pl.write_sorted_file_from_idx(base)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    st.ec_large_block, st.ec_small_block = 1 << 20, 4096
    st.mount_ec_shards("", 2)
    cookie, _ = want[(2, 7)]
    st.delete_needle(2, needle.Needle(cookie=cookie, id=7))
    want[(2, 7)] = None
    st.close()
    os.remove(base + pl.to_ext(4))
    return want


def _read_all(pkg: str, dirname: str, want: dict) -> None:
    import importlib
    store_mod = importlib.import_module(f"{pkg}.storage.store")
    volume = importlib.import_module(f"{pkg}.storage.volume")
    st = store_mod.Store([dirname], ec_large_block=1 << 20,
                         ec_small_block=4096)
    assert sorted(st.volumes) == [1] and sorted(st.ec_volumes) == [2]
    assert 4 not in st.ec_volumes[2].shards
    for (vid, nid), spec in want.items():
        if spec is None:
            with pytest.raises(volume.NotFound):
                st.read_needle(vid, nid)
            continue
        n = st.read_needle(vid, nid, spec[0])
        assert n.data == spec[1], (vid, nid)
        assert (n.name, n.mime) == (b"n%d" % nid, b"text/plain")
    st.close()


@pytest.mark.parametrize("writer,reader", [
    ("seaweedfs_tpu", "seaweedfs_tpu_torch"),
    ("seaweedfs_tpu_torch", "seaweedfs_tpu")],
    ids=["jax-writes-port-reads", "port-writes-jax-reads"])
def test_store_directory_mounts_across_packages(tmp_path, monkeypatch,
                                                writer, reader):
    """A store directory (.dat, .idx, .ecx, .ecj, .ec00-.ec13 with one
    shard lost) written by one package is mounted by the other's Store,
    which reads every needle byte-equal, degraded reads included, and
    sees the deleted EC needle as deleted."""
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    want = _fill_store(writer, str(tmp_path), monkeypatch)
    assert os.path.getsize(str(tmp_path / "2.ecj")) == 8
    _read_all(reader, str(tmp_path), want)
