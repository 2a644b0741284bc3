"""Embedded durable KV filer store (leveldb-class).

Reference: weed/filer2/leveldb/leveldb_store.go — entries keyed by
`dir \\x00 name`, prefix scans for listings. No goleveldb binding exists
here, so this is a small log-structured store of its own: a JSONL
write-ahead log replayed into the in-memory sorted index on open, with
snapshot compaction once the log accumulates enough dead records. Same
durability class (fsync'd WAL), same contract.

A copy of seaweedfs_tpu/filer/stores/leveldb_store.py in the PyTorch port.
"""

from __future__ import annotations

import json
import os
import threading

from ..entry import Entry
from ..filerstore import FilerStore, register_store
from .memory_store import MemoryStore


@register_store
class LevelDbStore(FilerStore):
    name = "leveldb"

    def __init__(self, dir: str = "./filerldb", sync: bool = False,
                 compact_threshold: int = 50_000, **_):
        os.makedirs(dir, exist_ok=True)
        self.dir = dir
        self.sync = sync
        self.compact_threshold = compact_threshold
        self._lock = threading.RLock()
        self._mem = MemoryStore()
        self._ops_since_compact = 0
        self._log_path = os.path.join(dir, "wal.jsonl")
        self._snap_path = os.path.join(dir, "snapshot.jsonl")
        self._replay()
        self._log = open(self._log_path, "a")

    # -- persistence --

    def _replay(self) -> None:
        for path in (self._snap_path, self._log_path):
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for raw in f:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        continue  # torn tail write after a crash
                    if rec["op"] == "put":
                        self._mem.insert_entry(Entry.from_dict(rec["e"]))
                    elif rec["op"] == "del":
                        self._mem.delete_entry(rec["path"])
                    elif rec["op"] == "delchildren":
                        self._mem.delete_folder_children(rec["path"])

    def _append(self, rec: dict) -> None:
        self._log.write(json.dumps(rec) + "\n")
        self._log.flush()
        if self.sync:
            os.fsync(self._log.fileno())
        self._ops_since_compact += 1
        if self._ops_since_compact >= self.compact_threshold:
            self._compact()

    def _compact(self) -> None:
        """Rewrite state as a snapshot, truncate the WAL."""
        tmp = self._snap_path + ".tmp"
        with open(tmp, "w") as f:
            for entry in self._mem._entries.values():
                f.write(json.dumps(
                    {"op": "put", "e": entry.to_dict()}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        self._log.close()
        self._log = open(self._log_path, "w")
        self._ops_since_compact = 0

    # -- FilerStore contract --

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._mem.insert_entry(entry)
            self._append({"op": "put", "e": entry.to_dict()})

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        with self._lock:
            return self._mem.find_entry(path)

    def delete_entry(self, path: str) -> None:
        with self._lock:
            self._mem.delete_entry(path)
            self._append({"op": "del", "path": path})

    def delete_folder_children(self, path: str) -> None:
        with self._lock:
            self._mem.delete_folder_children(path)
            self._append({"op": "delchildren", "path": path})

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        with self._lock:
            return self._mem.list_directory_entries(
                dir_path, start_file, inclusive, limit)

    def close(self) -> None:
        with self._lock:
            self._compact()
            self._log.close()
