"""Incremental volume backup / tail sync.

Reference: weed/storage/volume_backup.go (BinarySearchByAppendAtNs,
IncrementalBackup), weed/command/backup.go, VolumeTailSender/Receiver.

The cases of tests/test_backup.py pointed at the port's
storage/volume_backup.py and its volume servers
(tests/test_torch_cluster_util.py), and its tail frames held byte for
byte to the JAX package's on the same volume files."""


from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.storage import volume_backup as vb
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume


def _write(v: Volume, key: int, data: bytes, cookie: int = 0x42) -> None:
    v.write_needle(Needle(cookie=cookie, id=key, data=data))


def test_binary_search_by_append_at_ns(tmp_path):
    v = Volume(str(tmp_path), "", 1)
    for i in range(1, 21):
        _write(v, i, b"x" * i)
    # remember the watermark halfway
    mid_ts = v.last_append_at_ns
    for i in range(21, 31):
        _write(v, i, b"y" * i)
    off = vb.binary_search_by_append_at_ns(v, mid_ts)
    assert off is not None
    tail = list(vb.tail_needles(v, mid_ts))
    assert [n.id for n in tail] == list(range(21, 31))
    # nothing newer than the final watermark
    assert vb.binary_search_by_append_at_ns(v, v.last_append_at_ns) is None
    assert list(vb.tail_needles(v, v.last_append_at_ns)) == []
    # everything from 0
    assert len(list(vb.tail_needles(v, 0))) == 30
    v.close()


def test_tail_includes_tombstones_and_apply(tmp_path):
    src = Volume(str(tmp_path / "src"), "", 1)
    for i in range(1, 6):
        _write(src, i, f"data{i}".encode())
    ts = src.last_append_at_ns

    dst = Volume(str(tmp_path / "dst"), "", 1)
    for n, is_del in vb.tail_records(src, 0):
        vb.apply_needle(dst, n, is_del)
    assert dst.read_needle(3).data == b"data3"

    # overwrite + delete on source, incremental replay
    _write(src, 2, b"data2-v2")
    src.delete_needle(Needle(cookie=0x42, id=4))
    for n, is_del in vb.tail_records(src, ts):
        vb.apply_needle(dst, n, is_del)
    assert dst.read_needle(2).data == b"data2-v2"
    import pytest
    from seaweedfs_tpu_torch.storage.volume import AlreadyDeleted
    with pytest.raises(AlreadyDeleted):
        dst.read_needle(4)
    # watermarks converge
    assert dst.last_append_at_ns == src.last_append_at_ns
    src.close()
    dst.close()


def test_zero_byte_write_is_not_a_delete(tmp_path):
    """A legitimate empty-file write must not replicate as a tombstone;
    the tail frame carries an explicit delete flag (reference tail RPC
    semantics)."""
    src = Volume(str(tmp_path / "src"), "", 1)
    _write(src, 1, b"")          # zero-byte file
    _write(src, 2, b"real")
    src.delete_needle(Needle(cookie=0x42, id=2))
    recs = list(vb.tail_records(src, 0))
    flags = {n.id: is_del for n, is_del in recs}
    assert flags[1] is False
    assert [is_del for n, is_del in recs if n.id == 2] == [False, True]
    # wire round-trip preserves the flag
    wire = b"".join(vb.frame_needle(n, d) for n, d in recs)
    decoded = list(vb.iter_frames([wire]))
    assert [(n.id, d) for n, d in decoded] == [(n.id, d) for n, d in recs]
    dst = Volume(str(tmp_path / "dst"), "", 1)
    for n, d in decoded:
        vb.apply_needle(dst, n, d)
    assert dst.read_needle(1).data == b""
    src.close()
    dst.close()


def test_watermark_survives_reopen(tmp_path):
    v = Volume(str(tmp_path), "", 7)
    _write(v, 1, b"hello")
    ts = v.last_append_at_ns
    assert ts > 0
    v.close()
    v2 = Volume(str(tmp_path), "", 7, create_if_missing=False)
    assert v2.last_append_at_ns == ts
    v2.close()


def test_server_tail_and_receive(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"needle one")
            assert st == 201
            vid = int(a["fid"].split(",")[0])
            src = next(vs for vs in c.servers
                       if vs.store.has_volume(vid))
            dst = next(vs for vs in c.servers if vs is not src)
            # allocate an empty copy of the volume on dst
            async with c.http.post(
                    f"http://{dst.url}/admin/volume/allocate",
                    params={"volume": str(vid)}) as resp:
                assert resp.status == 200
            # status endpoint
            async with c.http.get(
                    f"http://{src.url}/admin/volume/status",
                    params={"volume": str(vid)}) as resp:
                stat = await resp.json()
            assert stat["last_append_at_ns"] > 0
            # pull the tail into the dst copy
            async with c.http.post(
                    f"http://{dst.url}/admin/volume/tail_receive",
                    params={"volume": str(vid),
                            "source": src.url}) as resp:
                assert resp.status == 200
                assert (await resp.json())["applied"] == 1
            # dst now serves the needle locally
            stc, data = await c.get(a["fid"], dst.url)
            assert stc == 200 and data == b"needle one"
            # incremental: second write then second receive applies only 1
            a2 = await c.assign()  # may land elsewhere; write to same fid vol
            st, _ = await c.put(a["fid"].split(",")[0] + ",02deadbeef",
                                src.url, b"needle two")
            assert st == 201
            async with c.http.post(
                    f"http://{dst.url}/admin/volume/tail_receive",
                    params={"volume": str(vid),
                            "source": src.url}) as resp:
                assert (await resp.json())["applied"] == 1
    run(body())


def test_tail_frames_equal_the_reference(tmp_path):
    """The port's tail of a volume the JAX package wrote is the JAX
    package's tail, frame for frame, so a port server and a reference
    server can back each other up."""
    from seaweedfs_tpu.storage import volume_backup as ref_vb
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle
    from seaweedfs_tpu.storage.volume import Volume as RefVolume
    ref = RefVolume(str(tmp_path), "", 3)
    for i in range(1, 9):
        ref.write_needle(RefNeedle(cookie=0x42, id=i, data=b"z" * i))
    ref.delete_needle(RefNeedle(cookie=0x42, id=5))
    mid = ref.last_append_at_ns
    ref.write_needle(RefNeedle(cookie=0x42, id=2, data=b"again"))
    want = {since: b"".join(ref_vb.frame_needle(n, d)
                            for n, d in ref_vb.tail_records(ref, since))
            for since in (0, mid)}
    ref.close()
    v = Volume(str(tmp_path), "", 3, create_if_missing=False)
    for since, wire in want.items():
        got = b"".join(vb.frame_needle(n, d)
                       for n, d in vb.tail_records(v, since))
        assert got == wire, since
        assert [(n.id, d) for n, d in vb.iter_frames([wire])] == \
            [(n.id, d) for n, d in vb.tail_records(v, since)]
    v.close()
