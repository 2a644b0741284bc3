"""DiskNeedleMap (LevelDbNeedleMap analog), vacuum throttler, tar export.

The cases of tests/test_disk_map_export.py pointed at the port,
test_truncated_aws_chunked_rejected at the port's s3/auth.py."""

from __future__ import annotations

import io
import tarfile
import time

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle_map import DiskNeedleMap, MemoryNeedleMap
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.vacuum import _Throttler
from seaweedfs_tpu_torch.storage.volume import Volume


def test_disk_needle_map_matches_memory(tmp_path):
    ops = [("put", k, k * 8, 100 + k) for k in range(1, 200)]
    ops += [("del", k, 10_000 + k * 8) for k in range(1, 200, 5)]
    ops += [("put", k, 20_000 + k * 8, 77) for k in range(1, 200, 9)]

    def replay(cls, path):
        nm = cls(path)
        for op in ops:
            if op[0] == "put":
                nm.put(op[1], op[2], op[3])
            else:
                nm.delete(op[1], op[2])
        return nm

    a = replay(MemoryNeedleMap, str(tmp_path / "a.idx"))
    b = replay(DiskNeedleMap, str(tmp_path / "b.idx"))
    try:
        assert len(a) == len(b)
        assert (a.file_count, a.deleted_count, a.deleted_bytes,
                a.max_file_key) == (b.file_count, b.deleted_count,
                                    b.deleted_bytes, b.max_file_key)
        for k in range(1, 200):
            va, vb = a.get(k), b.get(k)
            assert (va is None) == (vb is None)
            if va:
                assert (va.offset, va.size) == (vb.offset, vb.size)
    finally:
        a.close()
        b.close()

    # reopen from .idx: state survives (sqlite rebuilt by replay)
    b2 = DiskNeedleMap(str(tmp_path / "b.idx"))
    try:
        assert len(b2) == len(a)
        assert b2.get(10).size == a.get(10).size
    finally:
        b2.close()


def test_store_index_type_disk(tmp_path):
    from seaweedfs_tpu_torch.storage.needle_map import DiskNeedleMap
    from seaweedfs_tpu_torch.storage.store import Store
    st = Store([str(tmp_path)], index_type="disk")
    v = st.add_volume(1, "", "")
    assert isinstance(v.nm, DiskNeedleMap)
    v.write_needle(Needle(id=5, cookie=2, data=b"disk-map", name=b"x"))
    got = st.read_needle(1, 5, cookie=2)
    assert bytes(got.data) == b"disk-map"
    st.close()


def test_truncated_aws_chunked_rejected():
    import pytest
    from seaweedfs_tpu_torch.s3.auth import AuthError, decode_aws_chunked
    # missing the terminal 0-size chunk: must not decode as complete
    with pytest.raises(AuthError):
        decode_aws_chunked(b"5;chunk-signature=aa\r\nhello\r\n")


def test_throttler_paces_copy():
    th = _Throttler(1_000_000)  # 1 MB/s
    t0 = time.monotonic()
    for _ in range(4):
        th.maybe_sleep(100_000)  # 400KB total -> ~0.4s at 1MB/s
    elapsed = time.monotonic() - t0
    assert elapsed >= 0.25, elapsed
    # unthrottled: no sleep at all
    th0 = _Throttler(0)
    t0 = time.monotonic()
    th0.maybe_sleep(10**9)
    assert time.monotonic() - t0 < 0.05


def test_export_tar_and_pattern(tmp_path):
    v = Volume(str(tmp_path), "", 7)
    for i, name in enumerate([b"a.txt", b"b.log", b"c.txt"], start=1):
        n = Needle(id=i, cookie=0x11, data=b"data-" + name, name=name)
        v.write_needle(n)
    v.close()

    from seaweedfs_tpu_torch.cli import main
    out = tmp_path / "dump.tar"
    main(["export", "-dir", str(tmp_path), "-volumeId", "7",
          "-o", str(out), "-pattern", "*.txt"])
    with tarfile.open(out) as tar:
        names = tar.getnames()
        assert sorted(names) == ["a.txt", "c.txt"]
        data = tar.extractfile("a.txt").read()
        assert data == b"data-a.txt"


def test_export_tar_skips_deleted_and_stale(tmp_path):
    """Overwritten and deleted needle data must never be resurrected by
    export (the scan sees every historical .dat record)."""
    v = Volume(str(tmp_path), "", 9)
    v.write_needle(Needle(id=1, cookie=1, data=b"OLD", name=b"a.txt"))
    v.write_needle(Needle(id=1, cookie=1, data=b"NEW", name=b"a.txt"))
    v.write_needle(Needle(id=2, cookie=1, data=b"SECRET", name=b"b.txt"))
    v.delete_needle(Needle(id=2, cookie=1))
    v.close()

    from seaweedfs_tpu_torch.cli import main
    out = tmp_path / "dump.tar"
    main(["export", "-dir", str(tmp_path), "-volumeId", "9",
          "-o", str(out)])
    with tarfile.open(out) as tar:
        assert tar.getnames() == ["a.txt"]
        assert tar.extractfile("a.txt").read() == b"NEW"
