"""4/5-byte offset widths (reference: storage/types/offset_5bytes.go,
Makefile:16 `5BytesOffset` build tag) and the silent-wrap guards around
the 32 GiB boundary.

The cases of tests/test_offsets.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries. A last case holds the index bytes to the JAX package's.
"""

import numpy as np
import pytest

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle_map import (MemoryNeedleMap, NeedleValue,
                                              pack_entry, unpack_entry,
                                              walk_index_blob,
                                              write_sorted_index,
                                              SortedFileNeedleMap)


@pytest.fixture
def five_byte():
    t.set_offset_size(5)
    yield
    t.set_offset_size(4)


def test_defaults_match_reference_4byte_layout():
    assert t.OFFSET_SIZE == 4
    assert t.NEEDLE_MAP_ENTRY_SIZE == 16
    assert t.max_volume_size() == 32 * 1024 ** 3


def test_4byte_offset_overflow_raises():
    """Past 32 GiB the 4-byte width must refuse, not wrap (wrapping maps
    reads to the wrong needle — silent corruption)."""
    with pytest.raises(OverflowError, match="set_offset_size"):
        t.offset_to_bytes(32 * 1024 ** 3)
    # largest representable offset still round-trips
    top = 32 * 1024 ** 3 - 8
    assert t.offset_from_bytes(t.offset_to_bytes(top)) == top


def test_5byte_wire_layout_matches_reference(five_byte):
    """offset_5bytes.go:18-24 stores the LOW 32 bits big-endian in
    bytes[0..3] and the HIGH byte LAST — pin the exact wire bytes so a
    reference-written 5-byte index parses identically."""
    units = (0x07 << 32) | 0x0A0B0C0D
    blob = pack_entry(0x11, units * 8, 5)
    # key(8) + low32-BE + high byte + size(4)
    assert blob[8:13] == bytes([0x0A, 0x0B, 0x0C, 0x0D, 0x07])
    assert t.offset_to_bytes(units * 8) == bytes(
        [0x0A, 0x0B, 0x0C, 0x0D, 0x07])
    assert t.offset_from_bytes(blob[8:13]) == units * 8


def test_5byte_entry_roundtrip_past_32gb(five_byte):
    """Synthetic >32 GiB offsets round-trip through the 17-byte entry
    (offset_5bytes.go:14-16: 8 TB volumes)."""
    assert t.NEEDLE_MAP_ENTRY_SIZE == 17
    assert t.max_volume_size() == 8 * 1024 ** 4
    for off in (0, 8, 32 * 1024 ** 3, 5 * 1024 ** 4, 8 * 1024 ** 4 - 8):
        blob = pack_entry(0x1234, off, 777)
        assert len(blob) == 17
        key, got_off, size = unpack_entry(blob)
        assert (key, got_off, size) == (0x1234, off, 777)
    with pytest.raises(OverflowError):
        t.offset_to_bytes(8 * 1024 ** 4)


def test_5byte_idx_log_and_walk(five_byte, tmp_path):
    """MemoryNeedleMap .idx append log + reload with 5-byte entries,
    including an offset far past the 4-byte range."""
    path = str(tmp_path / "v.idx")
    nm = MemoryNeedleMap(path)
    big = 40 * 1024 ** 3  # > 32 GiB
    nm.put(1, 8, 100)
    nm.put(2, big, 200)
    nm.delete(1, big + 1024)
    nm.close()

    nm2 = MemoryNeedleMap(path)
    assert nm2.get(2).offset == big
    assert nm2.get(1).size == t.TOMBSTONE_FILE_SIZE
    with open(path, "rb") as fh:
        entries = list(walk_index_blob(fh.read()))
    assert entries[1] == (2, big, 200)
    nm2.close()


def test_5byte_sorted_index(five_byte, tmp_path):
    path = str(tmp_path / "v.ecx")
    big = 100 * 1024 ** 3
    write_sorted_index([(7, big, 50), (3, 16, 20)], path)
    sm = SortedFileNeedleMap(path)
    assert sm.get(7).offset == big
    assert sm.get(3).offset == 16
    assert sm.get(99) is None
    sm.close()


def test_native_compact_map_refuses_past_32gb():
    """ADVICE: the native uint32 store must raise instead of letting
    ctypes silently truncate offsets past 32 GiB."""
    from seaweedfs_tpu_torch.native import needle_map as native_nm

    if not native_nm.available():
        pytest.skip("native map not built")
    from seaweedfs_tpu_torch.storage.needle_map import _NativeMapAdapter

    ad = _NativeMapAdapter()
    ad[1] = NeedleValue(1, 8, 10)
    assert ad.get(1).offset == 8
    with pytest.raises(OverflowError, match="32 GiB"):
        ad[2] = NeedleValue(2, 33 * 1024 ** 3, 10)
    ad.close()


def test_best_needle_map_5byte_avoids_native(five_byte):
    from seaweedfs_tpu_torch.storage.needle_map import (CompactNeedleMap,
                                                  best_needle_map)

    nm = best_needle_map(kind="auto")
    assert not isinstance(nm, CompactNeedleMap)
    nm.close()
    with pytest.raises(ValueError, match="5-byte"):
        best_needle_map(kind="compact")


def test_volume_roundtrip_with_5byte_offsets(five_byte, tmp_path):
    """A whole volume written/read under the 5-byte width (same data
    path, wider index entries)."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    d = str(tmp_path)
    v = Volume(d, "", 9)
    rng = np.random.default_rng(5)
    blobs = {i: rng.integers(0, 256, 100 + i).astype(np.uint8).tobytes()
             for i in range(1, 20)}
    for i, data in blobs.items():
        v.write_needle(Needle(cookie=i, id=i, data=data))
    v.close()

    v2 = Volume(d, "", 9, create_if_missing=False)
    for i, data in blobs.items():
        assert v2.read_needle(i, cookie=i).data == data
    v2.close()


@pytest.mark.parametrize("width", [4, 5])
def test_index_bytes_equal_the_reference(width, tmp_path):
    """At both offset widths the port's pack_entry, walk_index_blob and
    write_sorted_index give the JAX package's bytes and entries for the
    same seeded entries (the sorted index with some keys written twice)."""
    from seaweedfs_tpu.storage import needle_map as ref_nm
    from seaweedfs_tpu.storage import types as ref_t
    rng = np.random.default_rng(width)
    t.set_offset_size(width)
    ref_t.set_offset_size(width)
    try:
        top = (1 << 32) if width == 4 else (1 << 40)
        entries = [(int(rng.integers(1, 1 << 60)),
                    int(rng.integers(0, top)) * t.NEEDLE_PADDING_SIZE,
                    int(rng.integers(0, 1 << 31))) for _ in range(300)]
        blob = b"".join(pack_entry(k, o, s) for k, o, s in entries)
        assert blob == b"".join(ref_nm.pack_entry(k, o, s)
                                for k, o, s in entries)
        assert list(walk_index_blob(blob)) == \
            list(ref_nm.walk_index_blob(blob))
        entries += entries[:20]  # overwritten keys: the last one wins
        write_sorted_index(entries, str(tmp_path / "port.sdx"))
        ref_nm.write_sorted_index(entries, str(tmp_path / "ref.sdx"))
        assert (tmp_path / "port.sdx").read_bytes() == \
            (tmp_path / "ref.sdx").read_bytes()
    finally:
        t.set_offset_size(4)
        ref_t.set_offset_size(4)
