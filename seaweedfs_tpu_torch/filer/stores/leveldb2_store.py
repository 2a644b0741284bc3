"""8-way sharded embedded store.

Reference: weed/filer2/leveldb2/leveldb2_store.go — 8 leveldb instances,
a directory's children all land in the shard picked by md5(dir)[0] %
dbCount (genKey/genDirectoryKeyPrefix), so listings stay single-shard
while load spreads across DBs.

A copy of seaweedfs_tpu/filer/stores/leveldb2_store.py in the PyTorch port.
"""

from __future__ import annotations

import hashlib
import os

from ..entry import Entry
from ..filerstore import FilerStore, register_store
from .leveldb_store import LevelDbStore


@register_store
class LevelDb2Store(FilerStore):
    name = "leveldb2"

    def __init__(self, dir: str = "./filerldb2", db_count: int = 8, **kw):
        self.db_count = db_count
        self.shards = [
            LevelDbStore(dir=os.path.join(dir, f"{i:02d}"), **kw)
            for i in range(db_count)]

    def _shard_of(self, dir_path: str) -> LevelDbStore:
        h = hashlib.md5((dir_path.rstrip("/") or "/").encode()).digest()
        return self.shards[h[0] % self.db_count]

    def _shard_for_path(self, path: str) -> LevelDbStore:
        parent = path.rstrip("/").rsplit("/", 1)[0] or "/"
        return self._shard_of(parent if path != "/" else "/")

    def insert_entry(self, entry: Entry) -> None:
        self._shard_of(entry.dir_path if entry.full_path != "/"
                       else "/").insert_entry(entry)

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        return self._shard_for_path(path).find_entry(path)

    def delete_entry(self, path: str) -> None:
        self._shard_for_path(path).delete_entry(path)

    def delete_folder_children(self, path: str) -> None:
        # children live in shard(path); recurse so grandchildren (in
        # other shards) go too
        children = self._shard_of(path).list_directory_entries(
            path, "", False, 1 << 30)
        for child in children:
            if child.is_directory:
                self.delete_folder_children(child.full_path)
            self.delete_entry(child.full_path)

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        return self._shard_of(dir_path).list_directory_entries(
            dir_path, start_file, inclusive, limit)

    def close(self) -> None:
        for s in self.shards:
            s.close()
