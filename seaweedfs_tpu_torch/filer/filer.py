"""Filer core: path metadata over a pluggable store.

Reference: weed/filer2/filer.go:26-174 (CreateEntry with recursive parent
mkdir + overwritten-chunk deletion), filer_delete_entry.go:11-116
(recursive delete, batched), filer_deletion.go (async volume-grouped chunk
deletes), filer_notify.go (meta change events).

A copy of seaweedfs_tpu/filer/filer.py in the PyTorch port.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..util import glog
from .entry import Attr, Entry, new_directory_entry
from .filechunks import FileChunk, minus_chunks
from .filerstore import FilerStore, create_store


class FilerError(Exception):
    pass


class Filer:
    def __init__(self, store: FilerStore | str = "memory",
                 chunk_deleter: Callable[[list[str]], None] | None = None,
                 **store_kwargs):
        self.store = (store if isinstance(store, FilerStore)
                      else create_store(store, **store_kwargs))
        # async chunk GC: fids queue drained by a background worker
        # (filer_deletion.go:11-52)
        self._pending_chunk_deletes: list[str] = []
        self._lock = threading.Lock()
        self.chunk_deleter = chunk_deleter
        # meta event listeners (NotifyUpdateEvent, filer_notify.go:9-31)
        self.listeners: list[Callable[[Entry | None, Entry | None], None]] = []

    # ---- notifications ----

    def _notify(self, old: Entry | None, new: Entry | None) -> None:
        for fn in self.listeners:
            try:
                fn(old, new)
            except Exception as e:
                # a broken listener must not block the mutation, but a
                # replication sink silently missing events is data loss
                glog.warning("filer listener %s failed: %r",
                             getattr(fn, "__name__", fn), e)

    # ---- entry CRUD ----

    def create_entry(self, entry: Entry) -> None:
        """Insert + mkdir -p of parents + delete overwritten chunks
        (filer.go:75-174)."""
        self._ensure_parents(entry.dir_path)
        old = self.store.find_entry(entry.full_path)
        if old is not None and not old.is_directory and not entry.is_directory:
            dropped = minus_chunks(old.chunks, entry.chunks)
            if dropped:
                self.delete_chunks([c.file_id for c in dropped])
        if old is not None and old.is_directory and not entry.is_directory:
            raise FilerError(
                f"cannot overwrite directory {entry.full_path} with a file")
        self.store.insert_entry(entry)
        self._notify(old, entry)

    def _ensure_parents(self, dir_path: str) -> None:
        if dir_path in ("", "/"):
            return
        existing = self.store.find_entry(dir_path)
        if existing is not None:
            if not existing.is_directory:
                raise FilerError(f"{dir_path} is a file, not a directory")
            return
        parent = dir_path.rsplit("/", 1)[0] or "/"
        self._ensure_parents(parent)
        self.store.insert_entry(new_directory_entry(dir_path))

    def find_entry(self, path: str) -> Entry | None:
        if path == "/":
            return new_directory_entry("/")
        return self.store.find_entry(path.rstrip("/") or "/")

    def update_entry(self, old: Entry | None, entry: Entry) -> None:
        self.store.update_entry(entry)
        self._notify(old, entry)

    def list_directory_entries(self, dir_path: str, start_file: str = "",
                               inclusive: bool = False,
                               limit: int = 1024) -> list[Entry]:
        return self.store.list_directory_entries(
            dir_path.rstrip("/") or "/", start_file, inclusive, limit)

    def delete_entry(self, path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False) -> None:
        """Recursive meta+data delete (filer_delete_entry.go:11-116)."""
        entry = self.find_entry(path)
        if entry is None:
            raise FilerError(f"not found: {path}")
        if entry.is_directory:
            limit = 1024
            while True:
                children = self.list_directory_entries(path, limit=limit)
                if not children:
                    break
                if not recursive:
                    raise FilerError(f"directory not empty: {path}")
                for child in children:
                    try:
                        self.delete_entry(child.full_path, recursive=True)
                    except FilerError:
                        if not ignore_recursive_error:
                            raise
                if len(children) < limit:
                    break
        if entry.chunks:
            self.delete_chunks([c.file_id for c in entry.chunks])
        self.store.delete_entry(entry.full_path)
        self._notify(entry, None)

    # ---- rename (filer_grpc_server_rename.go AtomicRenameEntry) ----

    def rename_entry(self, old_path: str, new_path: str) -> None:
        entry = self.find_entry(old_path)
        if entry is None:
            raise FilerError(f"not found: {old_path}")
        self._move_recursive(entry, new_path)

    def _move_recursive(self, entry: Entry, new_path: str) -> None:
        if entry.is_directory:
            children = self.list_directory_entries(entry.full_path,
                                                   limit=1 << 30)
        else:
            children = []
        new_entry = Entry(full_path=new_path, attr=entry.attr,
                          chunks=entry.chunks, extended=entry.extended)
        self.create_entry(new_entry)
        for child in children:
            self._move_recursive(child, f"{new_path}/{child.name}")
        self.store.delete_entry(entry.full_path)
        self._notify(entry, new_entry)

    # ---- chunk GC ----

    def delete_chunks(self, fids: list[str]) -> None:
        if self.chunk_deleter is not None:
            self.chunk_deleter(fids)
            return
        with self._lock:
            self._pending_chunk_deletes.extend(fids)

    def drain_pending_chunk_deletes(self) -> list[str]:
        with self._lock:
            out = self._pending_chunk_deletes[:]
            self._pending_chunk_deletes.clear()
            return out

    def close(self) -> None:
        self.store.close()
