"""TiKV filer store (driver-gated).

Reference: weed/filer2/tikv/tikv_store.go — raw KV keys
`dir \\x00 name`, Scan for listings, DeleteRange for subtree removal.
Registration is skipped when the tikv_client package is absent.

A copy of seaweedfs_tpu/filer/stores/tikv_store.py in the PyTorch port.
"""

from __future__ import annotations

import json

import tikv_client  # gated: ImportError skips registration (_load_builtin)

from ..entry import Entry
from ..filerstore import FilerStore, register_store

SEP = "\x00"


@register_store
class TikvStore(FilerStore):
    name = "tikv"

    def __init__(self, pdaddrs: str = "localhost:2379", client=None, **_):
        self._c = client if client is not None else \
            tikv_client.RawClient.connect(pdaddrs)

    def _key(self, dir_path: str, name: str) -> bytes:
        return f"{dir_path.rstrip('/') or '/'}{SEP}{name}".encode()

    def _split(self, path: str) -> tuple[str, str]:
        p = path.rstrip("/") or "/"
        if p == "/":
            return "/", ""
        d, _, name = p.rpartition("/")
        return d or "/", name

    def insert_entry(self, entry: Entry) -> None:
        d, name = self._split(entry.full_path)
        self._c.put(self._key(d, name),
                    json.dumps(entry.to_dict()).encode())

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        d, name = self._split(path)
        raw = self._c.get(self._key(d, name))
        if raw is None:
            return None
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        self._c.delete(self._key(d, name))

    def delete_folder_children(self, path: str) -> None:
        # recurse into subdirectories first (their children live under
        # different key prefixes), then DeleteRange this directory's span
        for e in self.list_directory_entries(path, "", False, 1 << 30):
            if e.is_directory:
                self.delete_folder_children(e.full_path)
        p = path.rstrip("/") or "/"
        # end key must be raw bytes: "\xff".encode() UTF-8s to C3 BF,
        # excluding names whose bytes sort above it
        self._c.delete_range(f"{p}{SEP}".encode(),
                             f"{p}{SEP}".encode() + b"\xff")

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        p = dir_path.rstrip("/") or "/"
        start = f"{p}{SEP}{start_file}".encode()
        end = f"{p}{SEP}".encode() + b"\xff"
        out: list[Entry] = []
        for key, raw in self._c.scan(start, end, limit + 1):
            name = key.decode().split(SEP, 1)[1]
            if start_file and not inclusive and name == start_file:
                continue
            out.append(Entry.from_dict(json.loads(raw)))
            if len(out) >= limit:
                break
        return out
