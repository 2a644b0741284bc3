"""Redis filer store (driver-gated).

Reference: weed/filer2/redis/universal_redis_store.go — entry JSON at
key=full path, directory listings as a sorted set `<dir>\\x00children`
(here a zset named `dir:<path>`); import fails cleanly when the redis
client library is absent.

A copy of seaweedfs_tpu/filer/stores/redis_store.py in the PyTorch port.
"""

from __future__ import annotations

import json

import redis  # gated: ImportError skips registration (_load_builtin)

from ..entry import Entry
from ..filerstore import FilerStore, register_store


@register_store
class RedisStore(FilerStore):
    name = "redis"

    DIR_LIST_KEY = "dir:{}"

    def __init__(self, host: str = "localhost", port: int = 6379,
                 password: str = "", database: int = 0, **_):
        self._r = redis.Redis(host=host, port=port, password=password,
                              db=database)

    def insert_entry(self, entry: Entry) -> None:
        self._r.set(entry.full_path, json.dumps(entry.to_dict()))
        if entry.full_path != "/":
            self._r.zadd(self.DIR_LIST_KEY.format(entry.dir_path),
                         {entry.name: 0})

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        raw = self._r.get(path)
        if raw is None:
            return None
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        self._r.delete(path)
        if path != "/":
            d, _, name = (path.rstrip("/")).rpartition("/")
            self._r.zrem(self.DIR_LIST_KEY.format(d or "/"), name)

    def delete_folder_children(self, path: str) -> None:
        p = path.rstrip("/") or "/"
        key = self.DIR_LIST_KEY.format(p)
        for name in self._r.zrange(key, 0, -1):
            child = f"{p.rstrip('/')}/{name.decode()}"
            e = self.find_entry(child)
            if e is not None and e.is_directory:
                self.delete_folder_children(child)
            self._r.delete(child)
        self._r.delete(key)

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        p = dir_path.rstrip("/") or "/"
        lo = f"[{start_file}" if start_file else "-"
        names = self._r.zrangebylex(self.DIR_LIST_KEY.format(p), lo, "+")
        out: list[Entry] = []
        for raw in names:
            name = raw.decode()
            if not inclusive and name == start_file:
                continue
            e = self.find_entry(f"{p.rstrip('/')}/{name}")
            if e is not None:
                out.append(e)
            if len(out) >= limit:
                break
        return out

    def close(self) -> None:
        self._r.close()
