"""Tiered-storage backends: move sealed .dat files to remote object
storage while reads keep flowing through the volume transparently.

Reference: weed/storage/backend/backend.go:15-75 (`BackendStorageFile` /
`BackendStorage` / factory registry loaded from `[storage.backend.*]`
TOML) and weed/storage/backend/s3_backend/s3_backend.go:113-146
(`S3BackendStorage` serving ReadAt via ranged GETs). The volume info
sidecar (.vif, reference pb/volume_info.go) records which backend holds
the .dat and under what key.

The S3 backend speaks plain S3 REST (PUT/ranged GET/DELETE) against any
S3-compatible endpoint — including this package's own gateway — via
synchronous HTTP, because volume reads run in executor threads.

A copy of seaweedfs_tpu/storage/backend.py in the PyTorch port.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Callable, Protocol

from ..util import failpoints


class BackendError(Exception):
    pass


class BackendStorageFile(Protocol):
    """File-shaped handle the Volume reads through
    (backend.go:15-23: ReadAt/GetStat/Name)."""

    def read_at(self, offset: int, size: int) -> bytes: ...
    def size(self) -> int: ...
    def name(self) -> str: ...
    def close(self) -> None: ...


class BackendStorage(Protocol):
    """A configured remote tier (backend.go:25-39)."""

    def new_storage_file(self, key: str) -> BackendStorageFile: ...
    def copy_file(self, local_path: str, key: str) -> int: ...
    def download_file(self, key: str, local_path: str) -> int: ...
    def delete_file(self, key: str) -> None: ...


# ---- S3-compatible backend ----


class S3BackendStorageFile:
    def __init__(self, backend: "S3BackendStorage", key: str,
                 known_size: int = -1):
        self._b = backend
        self._key = key
        self._size = known_size

    def read_at(self, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        # chaos site: a degraded remote tier (erroring or slow ranged
        # GETs) must surface as a bounded read error through the normal
        # OSError paths — never a wedged executor thread (sync: volume
        # reads run in executor threads)
        failpoints.sync_fail("tier.read")
        req = urllib.request.Request(
            self._b._url(self._key),
            headers={"Range": f"bytes={offset}-{offset + size - 1}"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()
        except urllib.error.URLError as e:
            raise BackendError(f"s3 read {self._key}@{offset}: {e}") from e

    def size(self) -> int:
        if self._size >= 0:
            return self._size
        req = urllib.request.Request(self._b._url(self._key), method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                self._size = int(r.headers.get("Content-Length", 0))
        except urllib.error.URLError as e:
            raise BackendError(f"s3 head {self._key}: {e}") from e
        return self._size

    def name(self) -> str:
        return f"s3://{self._b.bucket}/{self._key}"

    def close(self) -> None:
        pass


class S3BackendStorage:
    """Plain S3 REST client (unsigned; for gated/authenticated endpoints
    front it with a proxy or extend with SigV4 — the reference reads its
    credentials from the same backend config section)."""

    def __init__(self, backend_id: str, endpoint: str, bucket: str,
                 storage_class: str = ""):
        self.id = backend_id
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.startswith("http"):
            self.endpoint = "http://" + self.endpoint
        self.bucket = bucket
        self.storage_class = storage_class

    def _url(self, key: str) -> str:
        return f"{self.endpoint}/{self.bucket}/{key}"

    def ensure_bucket(self) -> None:
        req = urllib.request.Request(
            f"{self.endpoint}/{self.bucket}", method="PUT")
        try:
            urllib.request.urlopen(req, timeout=30).read()
        except urllib.error.HTTPError as e:
            if e.code not in (200, 409):  # exists is fine
                raise BackendError(f"create bucket: http {e.code}") from e
        except urllib.error.URLError as e:
            raise BackendError(f"create bucket: {e}") from e

    def new_storage_file(self, key: str,
                         known_size: int = -1) -> S3BackendStorageFile:
        return S3BackendStorageFile(self, key, known_size)

    def copy_file(self, local_path: str, key: str) -> int:
        self.ensure_bucket()
        size = os.path.getsize(local_path)
        with open(local_path, "rb") as f:
            # stream the PUT: urllib sends file-like bodies in chunks when
            # Content-Length is set, so a 30GB .dat never sits in RAM
            req = urllib.request.Request(
                self._url(key), data=f, method="PUT",
                headers={"Content-Length": str(size)})
            try:
                urllib.request.urlopen(req, timeout=600).read()
            except urllib.error.URLError as e:
                raise BackendError(f"s3 upload {key}: {e}") from e
        return size

    def download_file(self, key: str, local_path: str) -> int:
        try:
            with urllib.request.urlopen(self._url(key), timeout=600) as r:
                with open(local_path, "wb") as f:
                    total = 0
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
                        total += len(chunk)
                    return total
        except urllib.error.URLError as e:
            raise BackendError(f"s3 download {key}: {e}") from e

    def delete_file(self, key: str) -> None:
        req = urllib.request.Request(self._url(key), method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=60).read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise BackendError(f"s3 delete {key}: http {e.code}") from e
        except urllib.error.URLError as e:
            raise BackendError(f"s3 delete {key}: {e}") from e


# ---- memory-mapped local backend ----


class MmapBackendStorageFile:
    """read_at served straight from a read-only memory map: the OS page
    cache holds hot volume pages, and a pread-style slice is a memcpy,
    no syscall-per-read (reference: weed/storage/backend/memory_map/
    memory_map_backend.go, re-expressed POSIX-first instead of the
    reference's Windows CreateFileMapping path)."""

    def __init__(self, path: str):
        import mmap
        self._path = path
        self._f = None
        try:
            self._f = open(path, "rb")
            self._size = os.fstat(self._f.fileno()).st_size
            self._mm = (mmap.mmap(self._f.fileno(), self._size,
                                  prot=mmap.PROT_READ)
                        if self._size else None)
        except OSError as e:
            if self._f is not None:
                self._f.close()
            raise BackendError(f"mmap open {path}: {e}") from e

    def read_at(self, offset: int, size: int) -> bytes:
        # same site as the S3 path: every tiered read is breakable,
        # whichever backend serves it
        failpoints.sync_fail("tier.read")
        if self._mm is None or offset >= self._size:
            return b""
        return self._mm[offset:offset + size]

    def size(self) -> int:
        return self._size

    def name(self) -> str:
        return f"mmap://{self._path}"

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._f.close()


class MmapBackendStorage:
    """Local-directory tier with memory-mapped reads — point it at a
    tmpfs/ramdisk for an in-memory tier, or a big slow disk for a cold
    tier. Second in-tree BackendStorage (backend.go factory plurality)."""

    def __init__(self, backend_id: str, dirname: str):
        self.id = backend_id
        self.dir = dirname
        os.makedirs(dirname, exist_ok=True)

    def _path(self, key: str) -> str:
        # keys look like "1.dat.<random>"; keep them flat
        return os.path.join(self.dir, key.replace("/", "_"))

    def new_storage_file(self, key: str,
                         known_size: int = -1) -> MmapBackendStorageFile:
        return MmapBackendStorageFile(self._path(key))

    def copy_file(self, local_path: str, key: str) -> int:
        dst = self._path(key)
        tmp = dst + ".tmp"
        # durable before rename: tier_upload deletes the only local copy
        # right after this returns, so the bytes must be ON the tier
        # medium, not just in page cache (the S3 backend gets the same
        # guarantee from the server ack)
        try:
            with open(local_path, "rb") as src, open(tmp, "wb") as out:
                while True:
                    chunk = src.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
                out.flush()
                os.fsync(out.fileno())
            os.replace(tmp, dst)
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            return os.path.getsize(dst)
        except OSError as e:
            # don't pin tier space: a failed upload must leave neither a
            # partial temp file nor (when the rename already happened and
            # a later fsync failed) an orphaned dst — the caller reports
            # failure and retries under a fresh key
            for leftover in (tmp, dst):
                try:
                    os.remove(leftover)
                except OSError:
                    pass
            raise BackendError(f"mmap upload {key}: {e}") from e

    def download_file(self, key: str, local_path: str) -> int:
        import shutil
        src = self._path(key)
        try:
            shutil.copyfile(src, local_path)
        except OSError as e:
            raise BackendError(f"mmap download {key}: {e}") from e
        return os.path.getsize(local_path)

    def delete_file(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        except OSError as e:
            raise BackendError(f"mmap delete {key}: {e}") from e


# ---- registry (backend.go:24-45 factory map + LoadConfiguration) ----

_FACTORIES: dict[str, Callable[..., BackendStorage]] = {}
_STORAGES: dict[str, BackendStorage] = {}


def register_backend_factory(type_name: str,
                             factory: Callable[..., BackendStorage]) -> None:
    _FACTORIES[type_name] = factory


register_backend_factory(
    "s3", lambda backend_id, conf: S3BackendStorage(
        backend_id, conf["endpoint"], conf["bucket"],
        conf.get("storage_class", "")))

register_backend_factory(
    "mmap", lambda backend_id, conf: MmapBackendStorage(
        backend_id, conf["dir"]))


def load_backends(config: dict) -> None:
    """Configure backends from {"s3": {"default": {endpoint, bucket}}}
    (the shape of the reference's [storage.backend.s3.default] TOML)."""
    for type_name, instances in config.items():
        factory = _FACTORIES.get(type_name)
        if factory is None:
            raise BackendError(f"unknown backend type {type_name!r}")
        for inst_name, conf in instances.items():
            if not conf.get("enabled", True):
                continue
            backend_id = f"{type_name}.{inst_name}"
            _STORAGES[backend_id] = factory(backend_id, conf)


def get_backend(backend_id: str) -> BackendStorage:
    try:
        return _STORAGES[backend_id]
    except KeyError:
        raise BackendError(f"backend {backend_id!r} not configured "
                           f"(have: {sorted(_STORAGES)})") from None


def clear_backends() -> None:
    _STORAGES.clear()


# ---- .vif sidecar (pb/volume_info.go analog, JSON instead of pb) ----


def vif_path(base: str) -> str:
    return base + ".vif"


def save_volume_info(base: str, backend_id: str, key: str,
                     size: int, version: int) -> None:
    info = {"version": version,
            "files": [{"backend_id": backend_id, "key": key,
                       "file_size": size}]}
    tmp = vif_path(base) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, vif_path(base))


def load_volume_info(base: str) -> dict | None:
    p = vif_path(base)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


class RemoteDatFile:
    """Adapter giving a BackendStorageFile the seek/read/tell surface
    Volume._dat expects, so tiered volumes read transparently
    (volume reads become ranged GETs, s3_backend.go:113-146)."""

    def __init__(self, bf: BackendStorageFile):
        self._bf = bf
        self._pos = 0

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        elif whence == os.SEEK_END:
            self._pos = self._bf.size() + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int = -1) -> bytes:
        if size < 0:
            size = max(0, self._bf.size() - self._pos)
        data = self._bf.read_at(self._pos, size)
        self._pos += len(data)
        return data

    def pread(self, size: int, offset: int) -> bytes:
        # positioned read (os.pread argument order) — no shared seek state
        return self._bf.read_at(offset, size)

    def size(self) -> int:
        return self._bf.size()

    def write(self, data: bytes) -> int:
        raise BackendError("tiered volume is read-only")

    def flush(self) -> None:
        pass

    def truncate(self, size: int) -> None:
        raise BackendError("tiered volume is read-only")

    def close(self) -> None:
        self._bf.close()
