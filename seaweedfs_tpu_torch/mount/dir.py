"""Directory node ops.

Reference: weed/filesys/dir.go:1-426 (Lookup/Create/Mkdir/ReadDirAll/
Remove/Setattr + xattr), dir_rename.go (rename via filer atomic rename).

A copy of seaweedfs_tpu/mount/dir.py in the PyTorch port, with one
change: a rename moves the nodes of the files open under the old path
with it, as the reference's fsNodeCache.Move does. The JAX package's copy
leaves an open handle on the old path, so its next flush re-creates the
old entry beside the new one, both holding the same chunks: deleting
either (a log rotated while its writer holds it open, a download renamed
before it is closed) deletes the other's data.
"""

from __future__ import annotations

import time

from ..filer.entry import Attr, Entry, new_directory_entry
from ..filer.filer import FilerError


class MountError(Exception):
    def __init__(self, errno_name: str, msg: str = ""):
        self.errno_name = errno_name  # ENOENT / EEXIST / ENOTEMPTY / ...
        super().__init__(f"{errno_name}: {msg}")


class Dir:
    def __init__(self, path: str, wfs):
        self.path = path
        self.wfs = wfs

    def _child_path(self, name: str) -> str:
        return f"{self.path.rstrip('/')}/{name}"

    # ---- lookup / attr ----

    async def lookup(self, name: str):
        """dir.go Lookup (:194-235): resolve a child to a Dir or File
        node, with the entry cache standing in for fuse attr Valid."""
        from .file import File

        path = self._child_path(name)
        entry = self.wfs.cache_get(path)
        if entry is None:
            entry = self.wfs.filer.find_entry(path)
            if entry is not None:
                self.wfs.cache_set(path, entry)
        if entry is None:
            raise MountError("ENOENT", path)
        if entry.is_directory:
            return Dir(path, self.wfs)
        return File(name, self, entry=entry)

    async def attr(self) -> Attr:
        if self.path == "/":
            return Attr(mode=0o40777)
        entry = self.wfs.filer.find_entry(self.path)
        if entry is None:
            raise MountError("ENOENT", self.path)
        return entry.attr

    # ---- create / mkdir ----

    async def create(self, name: str, mode: int = 0o660,
                     uid: int = 0, gid: int = 0):
        """dir.go Create (:93-134): insert an empty entry, return the
        File node and an open FileHandle."""
        from .file import File

        path = self._child_path(name)
        now = time.time()
        entry = Entry(full_path=path, attr=Attr(
            mtime=now, crtime=now, mode=mode & 0o7777, uid=uid, gid=gid,
            collection=self.wfs.option.collection,
            replication=self.wfs.option.replication))
        self.wfs.filer.create_entry(entry)
        self.wfs.cache_set(path, entry)
        f = File(name, self, entry=entry)
        return f, f.open(uid=uid, gid=gid)

    async def mkdir(self, name: str, mode: int = 0o770) -> "Dir":
        path = self._child_path(name)
        if self.wfs.filer.find_entry(path) is not None:
            raise MountError("EEXIST", path)
        self.wfs.filer.create_entry(
            new_directory_entry(path, mode & 0o7777))
        return Dir(path, self.wfs)

    # ---- readdir ----

    async def read_dir_all(self) -> list[Entry]:
        """dir.go ReadDirAll (:237-258), paginated like the reference's
        1024-entry filer pages."""
        out: list[Entry] = []
        start = ""
        while True:
            page = self.wfs.filer.list_directory_entries(
                self.path, start_file=start, inclusive=False, limit=1024)
            out.extend(page)
            if len(page) < 1024:
                return out
            start = page[-1].name

    # ---- remove / rename ----

    async def remove(self, name: str, is_dir: bool = False) -> None:
        """dir.go Remove (:260-303): file removal deletes data chunks
        too; directory removal requires empty (rmdir semantics)."""
        path = self._child_path(name)
        entry = self.wfs.filer.find_entry(path)
        if entry is None:
            raise MountError("ENOENT", path)
        if is_dir != entry.is_directory:
            raise MountError("ENOTDIR" if is_dir else "EISDIR", path)
        try:
            self.wfs.filer.delete_entry(path, recursive=False)
        except FilerError as e:
            if "not empty" in str(e):
                raise MountError("ENOTEMPTY", path) from e
            raise
        self.wfs.cache_invalidate(path)

    async def rename(self, old_name: str, new_dir: "Dir",
                     new_name: str) -> None:
        """dir_rename.go: delegates to the filer's atomic rename, then
        moves the open files' nodes to the new path."""
        old_path = self._child_path(old_name)
        new_path = new_dir._child_path(new_name)
        try:
            self.wfs.filer.rename_entry(old_path, new_path)
        except FilerError as e:
            raise MountError("ENOENT", str(e)) from e
        self.wfs.cache_invalidate(old_path)
        self.wfs.cache_invalidate(new_path)
        _move_open_files(self.wfs, old_path, new_path)

    # ---- setattr / xattr (dir.go:305-358, xattr.go) ----

    async def setattr(self, mode: int | None = None,
                      uid: int | None = None,
                      gid: int | None = None,
                      mtime: float | None = None) -> None:
        entry = self.wfs.filer.find_entry(self.path)
        if entry is None:
            raise MountError("ENOENT", self.path)
        if mode is not None:
            entry.attr.mode = (entry.attr.mode & ~0o7777) | (mode & 0o7777)
        if uid is not None:
            entry.attr.uid = uid
        if gid is not None:
            entry.attr.gid = gid
        if mtime is not None:
            entry.attr.mtime = mtime
        self.wfs.filer.update_entry(None, entry)
        self.wfs.cache_invalidate(self.path)

    async def get_xattr(self, name: str) -> bytes:
        return await _get_xattr(self.wfs, self.path, name)

    async def set_xattr(self, name: str, value: bytes) -> None:
        await _set_xattr(self.wfs, self.path, name, value)

    async def list_xattr(self) -> list[str]:
        return await _list_xattr(self.wfs, self.path)

    async def remove_xattr(self, name: str) -> None:
        await _remove_xattr(self.wfs, self.path, name)


def _move_open_files(wfs, old_path: str, new_path: str) -> None:
    """Move every open handle's File at or under `old_path` to its place
    under `new_path`, so that its flushes write there (the reference's
    fsNodeCache.Move on rename). The handle keeps its own entry: it holds
    the chunks saved since the last flush, which no store has yet."""
    for fh in list(wfs.handles.values()):
        f = fh.file
        path = f.full_path
        if path != old_path and not path.startswith(old_path + "/"):
            continue
        moved = new_path + path[len(old_path):]
        parent, _, f.name = moved.rpartition("/")
        f.dir = Dir(parent or "/", wfs)
        if f.entry is not None:
            f.entry.full_path = moved


# ---- shared xattr helpers (xattr.go:15-144; stored in Entry.extended) ----

async def _entry_of(wfs, path: str) -> Entry:
    entry = wfs.filer.find_entry(path)
    if entry is None:
        raise MountError("ENOENT", path)
    return entry


async def _get_xattr(wfs, path: str, name: str) -> bytes:
    entry = await _entry_of(wfs, path)
    if name not in entry.extended:
        raise MountError("ENODATA", name)
    return bytes.fromhex(entry.extended[name])


async def _set_xattr(wfs, path: str, name: str, value: bytes) -> None:
    entry = await _entry_of(wfs, path)
    entry.extended[name] = value.hex()
    wfs.filer.update_entry(None, entry)
    wfs.cache_invalidate(path)


async def _list_xattr(wfs, path: str) -> list[str]:
    entry = await _entry_of(wfs, path)
    return sorted(entry.extended)


async def _remove_xattr(wfs, path: str, name: str) -> None:
    entry = await _entry_of(wfs, path)
    if name not in entry.extended:
        raise MountError("ENODATA", name)
    del entry.extended[name]
    wfs.filer.update_entry(None, entry)
    wfs.cache_invalidate(path)
