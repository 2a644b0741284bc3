"""Etcd filer store (driver-gated).

Reference: weed/filer2/etcd/etcd_store.go — keys `dir \\x00 name`, range
scans for listings. Registration is skipped when etcd3 is absent.

A copy of seaweedfs_tpu/filer/stores/etcd_store.py in the PyTorch port.
"""

from __future__ import annotations

import json

import etcd3  # gated: ImportError skips registration (_load_builtin)

from ..entry import Entry
from ..filerstore import FilerStore, register_store

SEP = "\x00"


@register_store
class EtcdStore(FilerStore):
    name = "etcd"

    def __init__(self, servers: str = "localhost:2379", prefix: str = "sw/",
                 **_):
        host, _, port = servers.partition(":")
        self._c = etcd3.client(host=host, port=int(port or 2379))
        self.prefix = prefix

    def _key(self, dir_path: str, name: str) -> str:
        return f"{self.prefix}{dir_path.rstrip('/') or '/'}{SEP}{name}"

    def _split(self, path: str) -> tuple[str, str]:
        p = path.rstrip("/") or "/"
        if p == "/":
            return "/", ""
        d, _, name = p.rpartition("/")
        return d or "/", name

    def insert_entry(self, entry: Entry) -> None:
        d, name = self._split(entry.full_path)
        self._c.put(self._key(d, name), json.dumps(entry.to_dict()))

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        d, name = self._split(path)
        raw, _ = self._c.get(self._key(d, name))
        if raw is None:
            return None
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        self._c.delete(self._key(d, name))

    def delete_folder_children(self, path: str) -> None:
        p = path.rstrip("/") or "/"
        # direct children live under `p \x00`; every deeper descendant's
        # key starts with `p /` (its dir path extends p) — both ranges
        # must go or grandchildren are orphaned. For the root, "p/"
        # collapses to "/" (not "//", which matches nothing).
        self._c.delete_prefix(f"{self.prefix}{p}{SEP}")
        self._c.delete_prefix(
            self.prefix + (p if p != "/" else "") + "/")

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        p = dir_path.rstrip("/") or "/"
        out: list[Entry] = []
        for raw, _meta in self._c.get_prefix(f"{self.prefix}{p}{SEP}",
                                             sort_order="ascend"):
            e = Entry.from_dict(json.loads(raw))
            if start_file:
                if e.name < start_file:
                    continue
                if not inclusive and e.name == start_file:
                    continue
            out.append(e)
            if len(out) >= limit:
                break
        return out
