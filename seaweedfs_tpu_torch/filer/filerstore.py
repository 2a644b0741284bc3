"""FilerStore plugin contract + registry.

Reference: weed/filer2/filerstore.go:13-29 (the 8-store plugin interface)
and the blank-import registration pattern (server/filer_server.go:23-35).
Stores register themselves on import; unavailable backends (missing
drivers) simply don't register.

A copy of seaweedfs_tpu/filer/filerstore.py in the PyTorch port, with
one change: _load_builtin imports the stores gated on a client library by
this package's own name, so a store whose client library is missing
never loads the JAX package.
"""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod

from .entry import Entry


class FilerStore(ABC):
    name: str = "abstract"

    @abstractmethod
    def insert_entry(self, entry: Entry) -> None: ...

    @abstractmethod
    def update_entry(self, entry: Entry) -> None: ...

    @abstractmethod
    def find_entry(self, path: str) -> Entry | None: ...

    @abstractmethod
    def delete_entry(self, path: str) -> None: ...

    @abstractmethod
    def delete_folder_children(self, path: str) -> None: ...

    @abstractmethod
    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]: ...

    def count_entries(self) -> int:
        """Total entries held (shard observability); -1 = unsupported."""
        return -1

    def begin_transaction(self):  # optional
        return None

    def commit_transaction(self):
        return None

    def rollback_transaction(self):
        return None

    def close(self) -> None:
        return None


_REGISTRY: dict[str, type[FilerStore]] = {}


def register_store(cls: type[FilerStore]) -> type[FilerStore]:
    _REGISTRY[cls.name] = cls
    return cls


def available_stores() -> list[str]:
    _load_builtin()
    return sorted(_REGISTRY)


def create_store(name: str, **kwargs) -> FilerStore:
    _load_builtin()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown filer store {name!r}; available: {available_stores()}")
    return _REGISTRY[name](**kwargs)


def _load_builtin() -> None:
    from .stores import (abstract_sql_store, leveldb2_store,  # noqa: F401
                         leveldb_store, memory_store, sqlite_store)
    # driver-gated plugins (reference: mysql/postgres via abstract_sql —
    # registered inside abstract_sql_store when drivers import — plus
    # cassandra/redis/etcd below)
    for mod in ("redis_store", "etcd_store", "cassandra_store",
                "tikv_store"):
        try:
            importlib.import_module(f".stores.{mod}", __package__)
        except ImportError:
            pass
