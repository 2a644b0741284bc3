"""Fake-driver contract tests for the GCS/Azure/B2 replication sinks.

A real in-proc source cluster feeds chunk bytes; the cloud drivers are
replaced by fakes exposing the exact client surface gcs_sink.go /
azure_sink.go / b2_sink.go use, so the full create/update/delete logic
executes in CI.

The cases of tests/test_cloud_sinks.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

import os

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.notification.queues import SqliteQueue, attach_to_filer
from seaweedfs_tpu_torch.replication.cloud_sinks import (AzureSink, B2Sink,
                                                   GcsSink)
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.runner import replicate_from_queue
from seaweedfs_tpu_torch.replication.sink import SINKS
from seaweedfs_tpu_torch.replication.source import FilerSource


# ---- fake drivers ---------------------------------------------------------


class FakeGcsBlob:
    def __init__(self, bucket, name):
        self.bucket, self.name = bucket, name

    def upload_from_string(self, data):
        self.bucket.objects[self.name] = (
            data.encode() if isinstance(data, str) else bytes(data))

    def delete(self):
        if self.name not in self.bucket.objects:
            raise KeyError(self.name)
        del self.bucket.objects[self.name]


class FakeGcsBucket:
    def __init__(self):
        self.objects = {}

    def blob(self, name):
        return FakeGcsBlob(self, name)


class FakeGcsClient:
    def __init__(self):
        self.buckets = {}

    def bucket(self, name):
        return self.buckets.setdefault(name, FakeGcsBucket())


class FakeAzureContainer:
    def __init__(self):
        self.blobs = {}

    def upload_blob(self, name, data, overwrite=False):
        if name in self.blobs and not overwrite:
            raise ValueError("exists")
        self.blobs[name] = bytes(data)

    def delete_blob(self, name):
        del self.blobs[name]


class FakeAzureServiceClient:
    def __init__(self):
        self.containers = {}

    def get_container_client(self, name):
        return self.containers.setdefault(name, FakeAzureContainer())


class _B2Version:
    def __init__(self, id_, name):
        self.id_, self.file_name = id_, name


class FakeB2Bucket:
    def __init__(self, api):
        self.api = api
        self.files = {}
        self._next = 0

    def upload_bytes(self, data, name):
        self._next += 1
        self.files[name] = (f"v{self._next}", bytes(data))

    def list_file_versions(self, prefix):
        for name, (vid, _) in list(self.files.items()):
            if name.startswith(prefix):
                yield _B2Version(vid, name), None


class FakeB2Api:
    def __init__(self):
        self.bucket = FakeB2Bucket(self)

    def get_bucket_by_name(self, name):
        return self.bucket

    def delete_file_version(self, id_, name):
        self.bucket.files.pop(name, None)


# ---- the shared contract scenario ----------------------------------------


def _drive_sink(tmp_path, sink, fetch, absent):
    """create -> overwrite -> delete through the replicator runner, then
    assert the fake cloud store saw the right objects."""
    async def body():
        c = Cluster(str(tmp_path / "src"), n_servers=1)
        c.with_filer = True
        async with c:
            queue = SqliteQueue(str(tmp_path / "q.db"))
            attach_to_filer(c.filer.filer, queue)

            blob = os.urandom(300 * 1024)  # multi-chunk at 256KB
            async with c.http.post(f"http://{c.filer.url}/docs/x.bin",
                                   data=blob) as r:
                assert r.status == 201
            async with c.http.post(f"http://{c.filer.url}/docs/y.txt",
                                   data=b"first") as r:
                assert r.status == 201
            async with c.http.post(f"http://{c.filer.url}/docs/y.txt",
                                   data=b"second!") as r:
                assert r.status == 201
            async with c.http.delete(
                    f"http://{c.filer.url}/docs/x.bin") as r:
                assert r.status == 204

            async with FilerSource(c.master.url, "/docs") as src:
                await sink.start()
                n = await replicate_from_queue(
                    queue, Replicator(src, sink),
                    str(tmp_path / "p.json"), once=True)
                await sink.close()
            assert n >= 4
            assert fetch("y.txt") == b"second!"
            assert absent("x.bin")
            queue.close()
    run(body())


def test_gcs_sink_contract(tmp_path):
    fake = FakeGcsClient()
    sink = GcsSink("bkt", client=fake)
    _drive_sink(tmp_path, sink,
                fetch=lambda k: fake.buckets["bkt"].objects.get(k),
                absent=lambda k: k not in fake.buckets["bkt"].objects)


def test_azure_sink_contract(tmp_path):
    fake = FakeAzureServiceClient()
    sink = AzureSink("ctr", client=fake)
    _drive_sink(tmp_path, sink,
                fetch=lambda k: fake.containers["ctr"].blobs.get(k),
                absent=lambda k: k not in fake.containers["ctr"].blobs)


def test_b2_sink_contract(tmp_path):
    fake = FakeB2Api()
    sink = B2Sink("bkt", client=fake)
    _drive_sink(
        tmp_path, sink,
        fetch=lambda k: (fake.bucket.files.get(k) or (None, None))[1],
        absent=lambda k: k not in fake.bucket.files)


def test_sink_registry_has_cloud_sinks():
    assert SINKS["google_cloud_storage"] is GcsSink
    assert SINKS["azure"] is AzureSink
    assert SINKS["backblaze"] is B2Sink
