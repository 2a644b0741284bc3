"""Filer entries: path -> attributes + chunk list.

Reference: weed/filer2/entry.go, entry_codec.go (pb-encoded attrs+chunks);
here entries serialize to JSON dicts for the embedded stores.

A copy of seaweedfs_tpu/filer/entry.py in the PyTorch port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .filechunks import FileChunk, total_size


@dataclass
class Attr:
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    replication: str = ""
    collection: str = ""
    ttl_sec: int = 0

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & 0o40000)


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    @property
    def name(self) -> str:
        return self.full_path.rstrip("/").rsplit("/", 1)[-1]

    @property
    def dir_path(self) -> str:
        p = self.full_path.rstrip("/").rsplit("/", 1)[0]
        return p or "/"

    @property
    def size(self) -> int:
        return total_size(self.chunks)

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "attr": {
                "mtime": self.attr.mtime, "crtime": self.attr.crtime,
                "mode": self.attr.mode, "uid": self.attr.uid,
                "gid": self.attr.gid, "mime": self.attr.mime,
                "replication": self.attr.replication,
                "collection": self.attr.collection,
                "ttl_sec": self.attr.ttl_sec,
            },
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        a = dict(d.get("attr", {}))
        known = {f for f in Attr.__dataclass_fields__}
        return cls(
            full_path=d["full_path"],
            attr=Attr(**{k: v for k, v in a.items() if k in known}),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
        )


def new_directory_entry(path: str, mode: int = 0o770) -> Entry:
    now = time.time()
    return Entry(full_path=path,
                 attr=Attr(mtime=now, crtime=now, mode=mode | 0o40000))
