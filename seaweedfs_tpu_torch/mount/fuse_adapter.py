"""Kernel FUSE bridge (optional).

Reference: weed/command/mount_std.go:26-139 wires filesys nodes into
bazil-fork fuse. Here the bridge targets the `fusepy` Operations API when
the library is present; the node layer itself (wfs/dir/file) carries all
semantics and is exercised in-proc by the tests, so environments without
a FUSE binding lose only the kernel hookup.

A copy of seaweedfs_tpu/mount/fuse_adapter.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import errno
import stat
import threading

from .dir import Dir, MountError
from .file import File
from .wfs import WFS, MountOptions

try:  # pragma: no cover - not installed in the build image
    from fuse import FUSE, FuseOSError, Operations
    KERNEL_BINDING = "fusepy"
except ImportError:
    # built-in /dev/fuse wire-protocol binding (fusekernel.py) — same
    # Operations surface, no third-party dependency
    from .fusekernel import FUSE, FuseOSError, Operations
    KERNEL_BINDING = "builtin"
HAVE_FUSE = True


def _errno_of(e: MountError) -> int:
    return getattr(errno, e.errno_name, errno.EIO)


class _LoopThread:
    """Run the async node ops on a dedicated event loop; FUSE callbacks
    arrive on kernel threads."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro):
        try:
            return asyncio.run_coroutine_threadsafe(coro, self.loop).result()
        except MountError as e:
            raise FuseOSError(_errno_of(e)) from e

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


class SeaweedFuseOps(Operations):  # pragma: no cover - needs a kernel
    """fusepy Operations over the WFS node tree."""

    def __init__(self, wfs: WFS):
        self.wfs = wfs
        self.lt = _LoopThread()
        self.lt.run(wfs.start())
        self._handles: dict[int, object] = {}
        self._next_fh = 1
        self._fh_lock = threading.Lock()

    def _alloc_fh(self, handle) -> int:
        # kernel callbacks run on concurrent threads (nothreads=False)
        with self._fh_lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = handle
            return fh

    def _node(self, path: str):
        if path in ("/", ""):
            return self.wfs.root
        parent, _, name = path.rstrip("/").rpartition("/")
        d = Dir(parent or "/", self.wfs)
        return self.lt.run(d.lookup(name))

    # -- metadata --

    def getattr(self, path, fh=None):
        node = self._node(path)
        if isinstance(node, Dir):
            a = self.lt.run(node.attr())
            return {"st_mode": stat.S_IFDIR | (a.mode & 0o7777),
                    "st_nlink": 2, "st_uid": a.uid, "st_gid": a.gid,
                    "st_mtime": a.mtime, "st_ctime": a.crtime, "st_size": 0}
        a = self.lt.run(node.attr())
        return {"st_mode": stat.S_IFREG | (a["mode"] & 0o7777),
                "st_nlink": 1, "st_size": a["size"], "st_uid": a["uid"],
                "st_gid": a["gid"], "st_mtime": a["mtime"]}

    def readdir(self, path, fh):
        d = self._node(path)
        entries = self.lt.run(d.read_dir_all())
        return [".", ".."] + [e.name for e in entries]

    def mkdir(self, path, mode):
        parent, _, name = path.rstrip("/").rpartition("/")
        self.lt.run(Dir(parent or "/", self.wfs).mkdir(name, mode))

    def rmdir(self, path):
        parent, _, name = path.rstrip("/").rpartition("/")
        self.lt.run(Dir(parent or "/", self.wfs).remove(name, is_dir=True))

    def unlink(self, path):
        parent, _, name = path.rstrip("/").rpartition("/")
        self.lt.run(Dir(parent or "/", self.wfs).remove(name))

    def rename(self, old, new):
        op, _, on = old.rstrip("/").rpartition("/")
        np, _, nn = new.rstrip("/").rpartition("/")
        self.lt.run(Dir(op or "/", self.wfs).rename(
            on, Dir(np or "/", self.wfs), nn))

    def chmod(self, path, mode):
        node = self._node(path)
        self.lt.run(node.setattr(mode=mode))

    def chown(self, path, uid, gid):
        node = self._node(path)
        self.lt.run(node.setattr(uid=uid, gid=gid))

    def truncate(self, path, length, fh=None):
        node = self._node(path)
        self.lt.run(node.setattr(size=length))

    # -- file I/O --

    def create(self, path, mode, fi=None):
        parent, _, name = path.rstrip("/").rpartition("/")
        _, handle = self.lt.run(
            Dir(parent or "/", self.wfs).create(name, mode))
        return self._alloc_fh(handle)

    def open(self, path, flags):
        node = self._node(path)
        if not isinstance(node, File):
            raise FuseOSError(errno.EISDIR)
        return self._alloc_fh(node.open())

    def read(self, path, size, offset, fh):
        return self.lt.run(self._handles[fh].read(offset, size))

    def write(self, path, data, offset, fh):
        return self.lt.run(self._handles[fh].write(offset, data))

    def flush(self, path, fh):
        if fh in self._handles:
            self.lt.run(self._handles[fh].flush())
        return 0

    def release(self, path, fh):
        handle = self._handles.pop(fh, None)
        if handle is not None:
            self.lt.run(handle.flush())
            self.lt.run(handle.release())
        return 0

    # -- xattr --

    def getxattr(self, path, name, position=0):
        # missing path propagates as ENOENT; missing attr is already
        # ENODATA from the node layer
        return self.lt.run(self._node(path).get_xattr(name))

    def setxattr(self, path, name, value, options, position=0):
        self.lt.run(self._node(path).set_xattr(name, value))

    def listxattr(self, path):
        return self.lt.run(self._node(path).list_xattr())

    def removexattr(self, path, name):
        self.lt.run(self._node(path).remove_xattr(name))

    def destroy(self, path):
        self.lt.run(self.wfs.close())
        self.lt.stop()


def mount(filer, master_url: str, mountpoint: str,
          option: MountOptions | None = None,
          foreground: bool = True) -> None:  # pragma: no cover
    """command/mount_std.go runMount equivalent."""
    wfs = WFS(filer, master_url, option)
    FUSE(SeaweedFuseOps(wfs), mountpoint, foreground=foreground,
         nothreads=False, allow_other=False)
