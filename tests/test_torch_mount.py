"""The port's mount layer (seaweedfs_tpu_torch/mount/) against the port's
in-process cluster (tests/test_torch_cluster_util.py, SWTPU_TORCH_EC_BACKEND
cpu while it is up).

The copies of tests/test_mount.py's ten cases (write-back dirty pages:
contiguous coalescing, non-contiguous flush, oversized split; chunk overlay
on overwrite; rename/remove with data GC; truncate clipping; xattrs on
Entry.extended; sparse reads; fsync then coalescing), and a parity case:
one seeded sequence of creates, writes (aligned, unaligned, oversized,
overwriting), flushes, truncates, renames, removes and xattrs run through
the JAX package's WFS on the reference's cluster and through the port's
WFS on the port's, each held to the same entries (paths, chunk offsets,
sizes and counts, xattrs, modes), the same errors and the same bytes read
back. Fids and times may differ. Last, the one fault of the reference's
mount that the port repairs: a file renamed while a handle holds it open
(the port moves the handle with it; the reference's flush re-creates the
old name over the same chunks).
"""

import numpy as np
import pytest

import cluster_util
from seaweedfs_tpu_torch.filer.filechunks import total_size
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.mount.dir import Dir, MountError
from seaweedfs_tpu_torch.mount.wfs import WFS, MountOptions

from test_torch_cluster_util import Cluster, run


async def _with_wfs(tmpdir, fn, chunk_limit=1024, store="memory"):
    # the sql and leveldb stores hand out fresh copies of their entries
    # where the memory store hands out the objects it keeps
    where = {"memory": {}, "sqlite": {"path": f"{tmpdir}/filer.db"},
             "leveldb": {"dir": f"{tmpdir}/filerldb"}}[store]
    async with Cluster(str(tmpdir), n_servers=2) as c:
        wfs = WFS(Filer(store, **where), c.master.url.replace("http://", ""),
                  MountOptions(chunk_size_limit=chunk_limit))
        await wfs.start()
        try:
            return await fn(c, wfs)
        finally:
            await wfs.close()


def test_write_read_roundtrip(tmp_path):
    async def body(c, wfs):
        root = wfs.root
        f, fh = await root.create("hello.txt")
        data = b"hello, tpu-native world"
        assert await fh.write(0, data) == len(data)
        await fh.flush()
        await fh.release()

        # fresh node: read through views
        node = await root.lookup("hello.txt")
        fh2 = node.open()
        assert await fh2.read(0, 4096) == data
        assert await fh2.read(7, 3) == data[7:10]
        a = await node.attr()
        assert a["size"] == len(data)
        await fh2.release()

    run(_with_wfs(tmp_path, body))


def test_contiguous_writes_coalesce_one_chunk(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("seq.bin")
        for i in range(8):
            await fh.write(i * 100, bytes([i]) * 100)
        await fh.flush()
        assert len(f.entry.chunks) == 1  # coalesced in the dirty buffer
        fh2 = (await wfs.root.lookup("seq.bin")).open()
        got = await fh2.read(0, 800)
        assert got == b"".join(bytes([i]) * 100 for i in range(8))

    run(_with_wfs(tmp_path, body))


def test_noncontiguous_write_forces_flush(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("gap.bin")
        await fh.write(0, b"a" * 100)
        await fh.write(500, b"b" * 100)   # gap -> flush first range
        await fh.write(100, b"c" * 100)   # backwards -> flush again
        await fh.flush()
        assert len(f.entry.chunks) == 3
        fh2 = (await wfs.root.lookup("gap.bin")).open()
        got = await fh2.read(0, 600)
        assert got[:100] == b"a" * 100
        assert got[100:200] == b"c" * 100
        assert got[500:600] == b"b" * 100

    run(_with_wfs(tmp_path, body))


def test_oversized_write_splits_chunks(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("big.bin")
        blob = bytes(range(256)) * 16  # 4096 bytes, chunk limit 1024
        await fh.write(0, blob)
        await fh.flush()
        assert len(f.entry.chunks) == 4
        fh2 = (await wfs.root.lookup("big.bin")).open()
        assert await fh2.read(0, len(blob)) == blob

    run(_with_wfs(tmp_path, body))


def test_overwrite_overlay_and_gc(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("ow.bin")
        await fh.write(0, b"x" * 300)
        await fh.flush()
        await fh.write(100, b"y" * 100)
        await fh.flush()
        fh2 = (await wfs.root.lookup("ow.bin")).open()
        got = await fh2.read(0, 300)
        assert got == b"x" * 100 + b"y" * 100 + b"x" * 100

    run(_with_wfs(tmp_path, body))


def test_mkdir_readdir_rename_remove(tmp_path):
    async def body(c, wfs):
        d = await wfs.root.mkdir("docs")
        f, fh = await d.create("a.txt")
        await fh.write(0, b"A")
        await fh.flush()
        await fh.release()
        names = [e.name for e in await d.read_dir_all()]
        assert names == ["a.txt"]

        # rename into a sibling dir
        d2 = await wfs.root.mkdir("archive")
        await d.rename("a.txt", d2, "b.txt")
        assert [e.name for e in await d2.read_dir_all()] == ["b.txt"]
        with pytest.raises(MountError):
            await d.lookup("a.txt")
        node = await d2.lookup("b.txt")
        assert await node.open().read(0, 10) == b"A"

        # rmdir non-empty fails; file remove drops chunks
        with pytest.raises(MountError):
            await wfs.root.remove("archive", is_dir=True)
        await d2.remove("b.txt")
        deleted = await wfs.drain_deletes()
        assert deleted >= 1
        await wfs.root.remove("archive", is_dir=True)

    run(_with_wfs(tmp_path, body))


def test_truncate_clips_chunks(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("t.bin")
        await fh.write(0, b"q" * 1000)
        await fh.write(1000, b"r" * 1000)  # second chunk after flush
        await fh.flush()
        node = await wfs.root.lookup("t.bin")
        await node.setattr(size=1500)
        entry = wfs.filer.find_entry("/t.bin")
        assert total_size(entry.chunks) == 1500
        await node.setattr(size=0)
        entry = wfs.filer.find_entry("/t.bin")
        assert entry.chunks == []

    run(_with_wfs(tmp_path, body, chunk_limit=1000))


def test_xattr(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("x.txt")
        await fh.flush()
        node = await wfs.root.lookup("x.txt")
        await node.set_xattr("user.tag", b"\x01\x02")
        assert await node.get_xattr("user.tag") == b"\x01\x02"
        assert await node.list_xattr() == ["user.tag"]
        await node.remove_xattr("user.tag")
        with pytest.raises(MountError):
            await node.get_xattr("user.tag")

        d = await wfs.root.mkdir("xd")
        await d.set_xattr("user.k", b"v")
        assert await d.get_xattr("user.k") == b"v"

    run(_with_wfs(tmp_path, body))


def test_sparse_read_zero_fills_and_eof(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("sp.bin")
        await fh.write(0, b"a" * 10)
        await fh.write(20, b"b" * 10)  # hole [10,20)
        await fh.flush()
        node = await wfs.root.lookup("sp.bin")
        fh2 = node.open()
        assert await fh2.read(0, 30) == b"a" * 10 + b"\0" * 10 + b"b" * 10
        assert await fh2.read(12, 5) == b"\0" * 5   # inside the hole
        assert await fh2.read(0, 15) == b"a" * 10 + b"\0" * 5
        assert await fh2.read(30, 10) == b""        # EOF
    run(_with_wfs(tmp_path, body))


def test_fsync_then_sequential_writes_still_coalesce(tmp_path):
    async def body(c, wfs):
        f, fh = await wfs.root.create("fs.bin")
        await fh.write(0, b"x" * 500)
        await fh.flush()                 # periodic fsync
        for i in range(5):
            await fh.write(500 + i * 100, bytes([i]) * 100)
        await fh.flush()
        # post-fsync sequential writes coalesce into ONE more chunk
        assert len(f.entry.chunks) == 2
    run(_with_wfs(tmp_path, body))


# ---------------------------------------------------------------------------
# parity with the JAX package's mount
# ---------------------------------------------------------------------------

PARITY_LIMIT = 1024


def _write_ops(rng: np.random.Generator) -> list[tuple]:
    """One file's writes and flushes from `rng`: ("w", offset, data) and
    ("f",) steps of each kind the dirty pages treat apart."""
    kind = int(rng.integers(0, 4))
    ops: list[tuple] = []
    if kind == 0:        # aligned appends, flushed now and then
        for i in range(int(rng.integers(3, 12))):
            ops.append(("w", i * 256, rng.bytes(256)))
            if rng.random() < 0.2:
                ops.append(("f",))
    elif kind == 1:      # unaligned: gaps, backwards, re-writes
        for _ in range(int(rng.integers(3, 9))):
            ops.append(("w", int(rng.integers(0, 3000)),
                        rng.bytes(int(rng.integers(1, 700)))))
    elif kind == 2:      # oversized: split into chunk-limit pieces
        ops.append(("w", int(rng.integers(0, 500)),
                    rng.bytes(int(rng.integers(PARITY_LIMIT + 1,
                                               4 * PARITY_LIMIT)))))
    else:                # overwrite inside flushed data
        ops.append(("w", 0, rng.bytes(1500)))
        ops.append(("f",))
        for _ in range(3):
            ops.append(("w", int(rng.integers(0, 1400)),
                        rng.bytes(int(rng.integers(1, 300)))))
            ops.append(("f",))
    return ops + [("f",)]


def _scenario(seed: int) -> dict:
    """The sequence from `seed`, before it runs: each file's directory and
    writes, and the files truncated, renamed and removed."""
    rng = np.random.default_rng(seed)
    files = [(("d0", "d1", "d0/e", "")[int(rng.integers(0, 4))],
              f"f{k}.bin", _write_ops(rng)) for k in range(8)]
    return {"files": files,
            "truncate": [(1, int(rng.integers(0, 800))), (2, 0)],
            "rename": 3, "remove": 4, "xattr": 5,
            "value": rng.bytes(int(rng.integers(1, 64)))}


async def _run_scenario(seed: int, wfs, dir_cls, error_cls) -> dict:
    """Drive one package's mount nodes through _scenario(seed); return
    every entry the filer holds (path, kind, mode, chunk offsets and
    sizes in stored order, xattrs), every file's bytes read back, the
    errors raised and the deletes drained."""
    sc = _scenario(seed)
    root = wfs.root
    d0 = await root.mkdir("d0")
    await root.mkdir("d1")
    await d0.mkdir("e")

    def node_dir(path: str):
        return dir_cls("/" + path if path else "/", wfs)

    for where, name, ops in sc["files"]:
        _, fh = await node_dir(where).create(name, mode=0o644)
        for op in ops:
            if op[0] == "w":
                assert await fh.write(op[1], op[2]) == len(op[2])
            else:
                await fh.flush()
        await fh.release()
    files = sc["files"]
    for k, size in sc["truncate"]:
        where, name, _ = files[k]
        node = await node_dir(where).lookup(name)
        await node.setattr(size=size, mode=0o600)
    where, name, _ = files[sc["rename"]]
    await node_dir(where).rename(name, node_dir("d1"), "moved.bin")
    await node_dir("d0").rename("e", node_dir("d1"), "e2")
    where, name, _ = files[sc["remove"]]
    where = where.replace("d0/e", "d1/e2")
    await node_dir(where).remove(name)
    where, name, _ = files[sc["xattr"]]
    where = where.replace("d0/e", "d1/e2")
    node = await node_dir(where).lookup(name)
    await node.set_xattr("user.a", sc["value"])
    await node.set_xattr("user.b", b"2")
    await node.remove_xattr("user.b")
    await node_dir("d1").set_xattr("user.dir", b"d")

    errors = []
    for call in (lambda: node_dir("").lookup("nope"),
                 lambda: node_dir("").remove("d1", is_dir=True),
                 lambda: node_dir("").remove("d1"),
                 lambda: node.get_xattr("user.b"),
                 lambda: node_dir("").mkdir("d0")):
        try:
            await call()
            errors.append(None)
        except error_cls as e:
            errors.append(e.errno_name)

    entries, data = [], {}

    async def walk(path: str) -> None:
        for e in await dir_cls(path, wfs).read_dir_all():
            entries.append((e.full_path, e.is_directory, e.attr.mode,
                            [(c.offset, c.size) for c in e.chunks],
                            dict(e.extended)))
            if e.is_directory:
                await walk(e.full_path)
            else:
                parent, _, name = e.full_path.rpartition("/")
                f = await dir_cls(parent or "/", wfs).lookup(name)
                fh = f.open()
                data[e.full_path] = await fh.read(0, 1 << 16)
                await fh.release()

    await walk("/")
    return {"entries": entries, "data": data, "errors": errors,
            "deleted": await wfs.drain_deletes()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mount_matches_the_reference(tmp_path, seed):
    from seaweedfs_tpu.filer.filer import Filer as RefFiler
    from seaweedfs_tpu.mount.dir import Dir as RefDir
    from seaweedfs_tpu.mount.dir import MountError as RefMountError
    from seaweedfs_tpu.mount.wfs import WFS as RefWFS
    from seaweedfs_tpu.mount.wfs import MountOptions as RefOptions

    async def side(cluster_cls, filer_cls, wfs_cls, opts_cls, dir_cls,
                   error_cls, sub):
        async with cluster_cls(str(tmp_path / sub), n_servers=2) as c:
            # no background GC pass: the deletes are counted by the
            # scenario's own drain at its end, however long it runs
            wfs = wfs_cls(filer_cls("memory"),
                          c.master.url.replace("http://", ""),
                          opts_cls(chunk_size_limit=PARITY_LIMIT,
                                   gc_interval=3600))
            await wfs.start()
            try:
                return await _run_scenario(seed, wfs, dir_cls, error_cls)
            finally:
                await wfs.close()

    ref = run(side(cluster_util.Cluster, RefFiler, RefWFS, RefOptions,
                   RefDir, RefMountError, "ref"))
    port = run(side(Cluster, Filer, WFS, MountOptions, Dir, MountError,
                    "port"))
    assert port["entries"] == ref["entries"]
    assert port["data"] == ref["data"]
    assert port["errors"] == ref["errors"]
    assert port["deleted"] == ref["deleted"]
    # the sequence reached every kind of write and change
    kinds = [e for e in ref["entries"] if not e[1]]
    assert any(len(e[3]) > 2 for e in kinds)
    assert any(e[4] for e in kinds)
    assert any(e[0] == "/d1/moved.bin" for e in kinds)
    assert any(e[0].startswith("/d1/e2/") or e[0] == "/d1/e2"
               for e in ref["entries"])
    assert ref["errors"] == ["ENOENT", "ENOTEMPTY", "EISDIR", "ENODATA",
                             "EEXIST"]


# ---------------------------------------------------------------------------
# a fault of the reference's mount, fixed in the port
# ---------------------------------------------------------------------------

async def _rename_while_open(wfs) -> dict:
    """Write a file in two flushes of its dirty pages, rename it between
    them while its handle stays open (a log rotated under its writer, a
    download renamed before it is closed), close it, then remove any
    entry left at the old name and read the new one back: its chunks
    one at a time (a gathered read that fails on one would leave the
    others in flight as the cluster stops), then the file."""
    _, fh = await wfs.root.create("dl.part")
    await fh.write(0, b"x" * 2000)          # one chunk saved, the rest held
    await wfs.root.rename("dl.part", wfs.root, "dl")
    await fh.write(2000, b"y" * 10)
    await fh.flush()
    await fh.release()
    names = [e.name for e in await wfs.root.read_dir_all()]
    if "dl.part" in names:
        await wfs.root.remove("dl.part")
    await wfs.drain_deletes()
    lost = 0
    for c in wfs.filer.find_entry("/dl").chunks:
        try:
            await wfs.read_chunk(c.file_id, 0, c.size)
        except Exception:  # noqa: BLE001 — the chunk was deleted
            lost += 1
    data = b""
    if not lost:
        fh2 = (await wfs.root.lookup("dl")).open()
        data = await fh2.read(0, 4096)
    return {"names": names, "lost": lost, "data": data}


@pytest.mark.parametrize("store", ["memory", "leveldb", "sqlite"])
def test_rename_of_an_open_file_moves_its_handle(tmp_path, store):
    """After a rename, the open handle's flush writes the entry under the
    new name: one entry, and its bytes survive the cleanup of the old
    name, on a store that keeps its entries as objects and on stores that
    keep them serialised (the chunk saved before the rename lives only in
    the handle's entry until the flush). The JAX package's mount
    re-creates the old entry at the flush
    (test_reference_resurrects_a_file_renamed_while_open)."""
    got = run(_with_wfs(tmp_path, lambda c, wfs: _rename_while_open(wfs),
                        store=store))
    assert got["names"] == ["dl"]
    assert got["lost"] == 0
    assert got["data"] == b"x" * 2000 + b"y" * 10


def test_reference_resurrects_a_file_renamed_while_open(tmp_path):
    """The fault the port's Dir.rename repairs, on the JAX package's mount:
    the handle's flush re-creates "dl.part" beside "dl" with the same
    chunks, and removing "dl.part" deletes the data "dl" points at."""
    from seaweedfs_tpu.filer.filer import Filer as RefFiler
    from seaweedfs_tpu.mount.wfs import WFS as RefWFS
    from seaweedfs_tpu.mount.wfs import MountOptions as RefOptions

    async def body():
        async with cluster_util.Cluster(str(tmp_path), n_servers=2) as c:
            wfs = RefWFS(RefFiler("memory"),
                         c.master.url.replace("http://", ""),
                         RefOptions(chunk_size_limit=1024))
            await wfs.start()
            try:
                return await _rename_while_open(wfs)
            finally:
                await wfs.close()

    got = run(body())
    assert got["names"] == ["dl", "dl.part"]
    assert got["lost"] == 3
