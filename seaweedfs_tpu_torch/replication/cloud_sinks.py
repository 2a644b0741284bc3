"""Cloud replication sinks: GCS, Azure Blob, Backblaze B2.

Reference: weed/replication/sink/gcssink/gcs_sink.go,
azuresink/azure_sink.go, b2sink/b2_sink.go — whole-object materialization
of filer entries into a cloud bucket/container (directories are skipped;
updates are delete+rewrite or overwrite; deletes remove the object).

Drivers (google-cloud-storage / azure-storage-blob / b2sdk) are optional
dependencies, so they import lazily at start() and every sink accepts an
injected `client`, letting the fake-driver contract tests
(tests/test_torch_cloud_sinks.py) execute the full create/update/delete
logic.

A copy of seaweedfs_tpu/replication/cloud_sinks.py in the PyTorch port.
"""

from __future__ import annotations

from ..filer.entry import Entry
from ..filer.stream import stream_chunk_views
from ..util import glog
from .sink import ReplicationSink


class _WholeObjectCloudSink(ReplicationSink):
    """Shared create/update/delete shape of the three cloud sinks: they
    differ only in the driver verbs (_put/_delete)."""

    def __init__(self, directory: str = "/", client=None):
        super().__init__()
        self.directory = directory.rstrip("/") or "/"
        self._client = client

    @property
    def sink_dir(self) -> str:
        return self.directory

    async def _object_bytes(self, entry: Entry) -> bytes:
        buf = bytearray()
        async for block in stream_chunk_views(
                self.source.client, entry.chunks, 0, entry.size):
            buf.extend(block)
        return bytes(buf)

    def _key(self, key: str) -> str:
        return key.lstrip("/")

    def _put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def _delete(self, key: str) -> None:
        raise NotImplementedError

    async def create_entry(self, key: str, entry: Entry) -> None:
        if entry.is_directory:
            return  # object stores have no directories (gcs_sink.go:83)
        self._put(self._key(key), await self._object_bytes(entry))

    async def update_entry(self, key: str, old: Entry, new: Entry,
                           delete_chunks: bool) -> bool:
        # whole-object overwrite (the reference's sinks do delete +
        # re-create; an overwriting put is the same end state)
        await self.create_entry(key, new)
        return True

    async def delete_entry(self, key: str, is_directory: bool,
                           delete_chunks: bool) -> None:
        if is_directory:
            return
        self._delete(self._key(key))


class GcsSink(_WholeObjectCloudSink):
    """gcssink/gcs_sink.go — google-cloud-storage bucket writer."""

    name = "google_cloud_storage"

    def __init__(self, bucket: str, directory: str = "/", client=None):
        super().__init__(directory, client)
        self.bucket_name = bucket
        self._bucket = None

    async def start(self) -> None:
        if self._client is None:
            try:
                from google.cloud import storage  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "replication sink 'google_cloud_storage' requires "
                    "google-cloud-storage, which is not available in "
                    "this environment") from e
            self._client = storage.Client()
        self._bucket = self._client.bucket(self.bucket_name)

    def _put(self, key: str, data: bytes) -> None:
        self._bucket.blob(key).upload_from_string(data)

    def _delete(self, key: str) -> None:
        blob = self._bucket.blob(key)
        try:
            blob.delete()
        except Exception as e:
            # absent object: delete is idempotent (gcs_sink.go:66) —
            # but an auth/network fault must not hide behind that
            glog.V(1).infof("gcs delete %s swallowed: %r", key, e)


class AzureSink(_WholeObjectCloudSink):
    """azuresink/azure_sink.go — container blob writer."""

    name = "azure"

    def __init__(self, container: str, directory: str = "/",
                 account_name: str = "", account_key: str = "",
                 client=None):
        super().__init__(directory, client)
        self.container = container
        self.account_name = account_name
        self.account_key = account_key
        self._container = None

    async def start(self) -> None:
        if self._client is None:
            try:
                from azure.storage.blob import (  # type: ignore
                    BlobServiceClient)
            except ImportError as e:
                raise RuntimeError(
                    "replication sink 'azure' requires "
                    "azure-storage-blob, which is not available in this "
                    "environment") from e
            self._client = BlobServiceClient(
                account_url=(f"https://{self.account_name}"
                             f".blob.core.windows.net"),
                credential=self.account_key)
        self._container = self._client.get_container_client(self.container)

    def _put(self, key: str, data: bytes) -> None:
        self._container.upload_blob(key, data, overwrite=True)

    def _delete(self, key: str) -> None:
        try:
            self._container.delete_blob(key)
        except Exception as e:
            # idempotent delete (azure_sink.go:77-88), fault still logged
            glog.V(1).infof("azure delete %s swallowed: %r", key, e)


class B2Sink(_WholeObjectCloudSink):
    """b2sink/b2_sink.go — Backblaze B2 bucket writer via b2sdk."""

    name = "backblaze"

    def __init__(self, bucket: str, directory: str = "/",
                 key_id: str = "", application_key: str = "",
                 client=None):
        super().__init__(directory, client)
        self.bucket_name = bucket
        self.key_id = key_id
        self.application_key = application_key
        self._bucket = None

    async def start(self) -> None:
        if self._client is None:
            try:
                from b2sdk.v2 import (  # type: ignore
                    B2Api, InMemoryAccountInfo)
            except ImportError as e:
                raise RuntimeError(
                    "replication sink 'backblaze' requires b2sdk, which "
                    "is not available in this environment") from e
            api = B2Api(InMemoryAccountInfo())
            api.authorize_account("production", self.key_id,
                                  self.application_key)
            self._client = api
        self._bucket = self._client.get_bucket_by_name(self.bucket_name)

    def _put(self, key: str, data: bytes) -> None:
        self._bucket.upload_bytes(data, key)

    def _delete(self, key: str) -> None:
        try:
            for version, _ in self._bucket.list_file_versions(key):
                if version.file_name == key:
                    self._client.delete_file_version(version.id_,
                                                     version.file_name)
        except Exception as e:
            # idempotent delete across versions; log so a dead bucket
            # doesn't masquerade as "nothing to delete"
            glog.V(1).infof("b2 delete %s swallowed: %r", key, e)
