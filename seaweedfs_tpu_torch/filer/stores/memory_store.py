"""In-memory filer store (test/default store; the reference's baseline is
leveldb — filer2/leveldb/leveldb_store.go).

A copy of seaweedfs_tpu/filer/stores/memory_store.py in the PyTorch port.
"""

from __future__ import annotations

import bisect
import threading

from ..entry import Entry
from ..filerstore import FilerStore, register_store


@register_store
class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self, **_):
        self._lock = threading.RLock()
        # dir_path -> sorted list of child names; full_path -> Entry
        self._dirs: dict[str, list[str]] = {}
        self._entries: dict[str, Entry] = {}

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            path = entry.full_path
            self._entries[path] = entry
            if path != "/":
                names = self._dirs.setdefault(entry.dir_path, [])
                i = bisect.bisect_left(names, entry.name)
                if i >= len(names) or names[i] != entry.name:
                    names.insert(i, entry.name)

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        with self._lock:
            return self._entries.get(path)

    def delete_entry(self, path: str) -> None:
        with self._lock:
            e = self._entries.pop(path, None)
            if e is not None and path != "/":
                names = self._dirs.get(e.dir_path, [])
                i = bisect.bisect_left(names, e.name)
                if i < len(names) and names[i] == e.name:
                    names.pop(i)

    def count_entries(self) -> int:
        with self._lock:
            # root stub excluded: it exists on every shard
            return sum(1 for p in self._entries if p != "/")

    def delete_folder_children(self, path: str) -> None:
        with self._lock:
            prefix = path.rstrip("/") or "/"
            doomed = [d for d in self._dirs
                      if d == prefix or d.startswith(
                          (prefix if prefix != "/" else "") + "/")]
            for d in doomed:
                for name in self._dirs.pop(d, []):
                    child = ("" if d == "/" else d) + "/" + name
                    self._entries.pop(child, None)

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        with self._lock:
            prefix = dir_path.rstrip("/") or ""
            names = self._dirs.get(prefix or "/", [])
            i = bisect.bisect_left(names, start_file) if start_file else 0
            if start_file and not inclusive and i < len(names) \
                    and names[i] == start_file:
                i += 1
            out = []
            for name in names[i:i + limit]:
                e = self._entries.get(f"{prefix}/{name}")
                if e is not None:
                    out.append(e)
            return out
