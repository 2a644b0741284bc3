"""Notification queues + async replication between two in-proc clusters.

Mirrors weed filer.replicate: filer meta events -> queue -> Replicator ->
sink (filer on a second cluster / S3 gateway / local dir), with
incremental chunk diff on updates and offset-file resume.

The cases of tests/test_replication.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

import asyncio
import os

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.notification.queues import (FileQueue, SqliteQueue,
                                               attach_to_filer,
                                               load_configuration)
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.runner import replicate_from_queue
from seaweedfs_tpu_torch.replication.sink import (FilerSink, LocalDirSink, S3Sink)
from seaweedfs_tpu_torch.replication.source import FilerSource


def _src_cluster(tmp_path, **kw):
    c = Cluster(str(tmp_path / "src"), **kw)
    c.with_filer = True
    return c


async def _post(c, path, data):
    async with c.http.post(f"http://{c.filer.url}{path}", data=data) as r:
        assert r.status == 201, await r.text()


def test_queue_configuration_registry(tmp_path):
    q = load_configuration(
        {"file": {"enabled": True, "path": str(tmp_path / "q.jsonl")}})
    assert isinstance(q, FileQueue)
    assert load_configuration({}) is None
    with pytest.raises(ValueError):
        load_configuration({
            "file": {"enabled": True, "path": "x"},
            "sqlite": {"enabled": True, "path": "y"}})


def test_file_queue_offsets(tmp_path):
    q = FileQueue(str(tmp_path / "q.jsonl"))
    q.send_message("/a", {"n": 1})
    q.send_message("/b", {"n": 2})
    msgs, off = q.read_from(0)
    assert [m["key"] for m in msgs] == ["/a", "/b"]
    q.send_message("/c", {"n": 3})
    msgs2, off2 = q.read_from(off)
    assert [m["key"] for m in msgs2] == ["/c"]
    assert off2 > off


def test_sqlite_queue(tmp_path):
    q = SqliteQueue(str(tmp_path / "q.db"))
    q.send_message("/x", {"n": 1})
    q.send_message("/y", {"n": 2})
    rows = q.read_after(0)
    assert [m["key"] for _, m in rows] == ["/x", "/y"]
    assert q.read_after(rows[-1][0]) == []
    q.close()


def test_replicate_to_local_dir_sink(tmp_path):
    async def body():
        async with _src_cluster(tmp_path) as c:
            queue = SqliteQueue(str(tmp_path / "events.db"))
            attach_to_filer(c.filer.filer, queue)

            await _post(c, "/docs/a.txt", b"alpha")
            await _post(c, "/docs/sub/b.txt", b"beta" * 1000)
            await _post(c, "/docs/a.txt", b"ALPHA2")  # overwrite
            await _post(c, "/other/skip.txt", b"outside")

            dest = str(tmp_path / "mirror")
            sink = LocalDirSink(dest)
            async with FilerSource(c.master.url, "/docs") as src:
                await sink.start()
                n = await replicate_from_queue(
                    queue, Replicator(src, sink),
                    str(tmp_path / "progress.json"), once=True)
                await sink.close()
            assert n > 0
            with open(os.path.join(dest, "a.txt"), "rb") as f:
                assert f.read() == b"ALPHA2"
            with open(os.path.join(dest, "sub/b.txt"), "rb") as f:
                assert f.read() == b"beta" * 1000
            assert not os.path.exists(os.path.join(dest, "skip.txt"))

            # delete propagates; progress file resumes past old events
            async with c.http.delete(
                    f"http://{c.filer.url}/docs/a.txt") as r:
                assert r.status == 204, r.status
            async with FilerSource(c.master.url, "/docs") as src:
                sink2 = LocalDirSink(dest)
                await sink2.start()
                await replicate_from_queue(
                    queue, Replicator(src, sink2),
                    str(tmp_path / "progress.json"), once=True)
                await sink2.close()
            assert not os.path.exists(os.path.join(dest, "a.txt"))
            queue.close()
    run(body())


def test_replicate_filer_to_filer(tmp_path):
    async def body():
        async with _src_cluster(tmp_path) as src_c:
            dst_c = Cluster(str(tmp_path / "dst"), n_servers=2)
            dst_c.with_filer = True
            async with dst_c:
                queue = FileQueue(str(tmp_path / "events.jsonl"))
                attach_to_filer(src_c.filer.filer, queue)

                blob = os.urandom(300 * 1024)  # multi-chunk at 256KB
                await _post(src_c, "/data/file.bin", blob)

                sink = FilerSink(dst_c.filer.url, dst_c.master.url,
                                 directory="/backup")
                async with FilerSource(src_c.master.url, "/") as src:
                    await sink.start()
                    await replicate_from_queue(
                        queue, Replicator(src, sink),
                        str(tmp_path / "p.json"), once=True)
                    await sink.close()

                # target cluster serves the bytes from its OWN volumes
                async with dst_c.http.get(
                        f"http://{dst_c.filer.url}/backup/data/file.bin"
                        ) as resp:
                    assert resp.status == 200
                    assert await resp.read() == blob
    run(body())


def test_replicate_update_incremental(tmp_path):
    """An overwrite event reaches the target as an in-place update via
    MinusChunks diff (filer_sink.go:136-209)."""
    async def body():
        async with _src_cluster(tmp_path) as src_c:
            dst_c = Cluster(str(tmp_path / "dst"), n_servers=2)
            dst_c.with_filer = True
            async with dst_c:
                queue = FileQueue(str(tmp_path / "ev.jsonl"))
                sink = FilerSink(dst_c.filer.url, dst_c.master.url)
                async with FilerSource(src_c.master.url, "/") as src:
                    await sink.start()
                    rep = Replicator(src, sink)
                    attach_to_filer(src_c.filer.filer, queue)

                    await _post(src_c, "/f.txt", b"one")
                    await replicate_from_queue(
                        queue, rep, str(tmp_path / "p.json"), once=True)
                    await _post(src_c, "/f.txt", b"two-two")
                    await replicate_from_queue(
                        queue, rep, str(tmp_path / "p.json"), once=True)
                    await sink.close()

                async with dst_c.http.get(
                        f"http://{dst_c.filer.url}/f.txt") as resp:
                    assert await resp.read() == b"two-two"
    run(body())


def test_replicate_to_s3_sink(tmp_path):
    async def body():
        async with _src_cluster(tmp_path) as src_c:
            from seaweedfs_tpu_torch.s3.gateway import S3Gateway
            s3 = S3Gateway(Filer("memory"), src_c.master.url, port=0)
            await s3.start()
            try:
                queue = FileQueue(str(tmp_path / "e.jsonl"))
                attach_to_filer(src_c.filer.filer, queue)
                await _post(src_c, "/pics/cat.jpg", b"\xff\xd8meow")

                sink = S3Sink(f"http://{s3.url}", "mirror")
                async with FilerSource(src_c.master.url, "/") as src:
                    await sink.start()
                    await replicate_from_queue(
                        queue, Replicator(src, sink),
                        str(tmp_path / "p.json"), once=True)
                    await sink.close()

                async with src_c.http.get(
                        f"http://{s3.url}/mirror/pics/cat.jpg") as resp:
                    assert resp.status == 200
                    assert await resp.read() == b"\xff\xd8meow"
            finally:
                await s3.stop()
    run(body())


def test_once_drains_a_backlog_over_one_batch(tmp_path):
    """`once` replays the whole backlog: a sqlite queue hands it over 1,024
    events at a time, and 2,500 events (outside the replicated subtree, so
    each is read and skipped) are all consumed and the progress file
    points past the last (the reference stops after the first batch)."""
    import json

    async def body():
        queue = SqliteQueue(str(tmp_path / "q.db"))
        for i in range(2500):
            queue.send_message(f"/elsewhere/f{i}", {"new_entry": None,
                                                     "old_entry": None})
        progress = str(tmp_path / "progress.json")
        async with FilerSource("127.0.0.1:1", "/docs") as src:
            sink = LocalDirSink(str(tmp_path / "mirror"))
            await sink.start()
            n = await replicate_from_queue(queue, Replicator(src, sink),
                                           progress, once=True)
            await sink.close()
        assert n == 2500
        with open(progress) as f:
            assert json.load(f)["offset"] == queue.read_after(0, 2500)[-1][0]
        queue.close()
    run(body())
