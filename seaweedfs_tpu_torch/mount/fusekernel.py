"""Kernel FUSE binding over /dev/fuse — no third-party library.

Reference: weed/command/mount_std.go:26-139 hooks the filesystem into
the kernel via the bazil fuse fork (which itself speaks the FUSE wire
protocol over /dev/fuse). This module is that kernel hookup for the
tpu repo, implemented directly against the FUSE 7.x wire protocol
(include/uapi/linux/fuse.h layouts re-derived from the protocol docs):
open /dev/fuse, mount(2) (fusermount fallback), then a request loop of
fuse_in_header + opcode body -> fuse_out_header + reply body.

The public surface is fusepy-compatible (`FUSE`, `Operations`,
`FuseOSError`) because `fuse_adapter.SeaweedFuseOps` targets that API;
when fusepy is absent the adapter falls back to this binding, so the
kernel VFS -> WFS -> filer -> volume path works out of the box.

A copy of seaweedfs_tpu/mount/fusekernel.py in the PyTorch port. The
source name it hands mount(2), b"seaweedfs_tpu", is the reference's wire
value (what /proc/mounts shows for the mount), not an import; the copy
keeps it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import socket
import stat as stat_m
import struct
import subprocess
import threading

from ..util import glog

# ---------------------------------------------------------------------------
# fusepy-compatible surface
# ---------------------------------------------------------------------------


class FuseOSError(OSError):
    def __init__(self, eno: int):
        super().__init__(eno, os.strerror(eno))


class Operations:  # minimal default base, fusepy-style
    def __call__(self, op, *args):
        if not hasattr(self, op):
            raise FuseOSError(errno.ENOSYS)
        return getattr(self, op)(*args)


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

FUSE_KERNEL_VERSION = 7
FUSE_KERNEL_MINOR = 31          # the layout set this module speaks

# opcodes
OP_LOOKUP, OP_FORGET, OP_GETATTR, OP_SETATTR = 1, 2, 3, 4
OP_MKDIR, OP_UNLINK, OP_RMDIR, OP_RENAME = 9, 10, 11, 12
OP_OPEN, OP_READ, OP_WRITE, OP_STATFS, OP_RELEASE = 14, 15, 16, 17, 18
OP_FSYNC, OP_SETXATTR, OP_GETXATTR, OP_LISTXATTR = 20, 21, 22, 23
OP_REMOVEXATTR, OP_FLUSH, OP_INIT, OP_OPENDIR = 24, 25, 26, 27
OP_READDIR, OP_RELEASEDIR, OP_FSYNCDIR = 28, 29, 30
OP_ACCESS, OP_CREATE, OP_INTERRUPT = 34, 35, 36
OP_DESTROY, OP_BATCH_FORGET, OP_RENAME2 = 38, 42, 45

_NO_REPLY = {OP_FORGET, OP_BATCH_FORGET, OP_INTERRUPT}

IN_HEADER = struct.Struct("<IIQQIIII")      # len op unique nodeid uid gid pid pad
OUT_HEADER = struct.Struct("<IiQ")          # len error unique

# fuse_attr (7.9+ layout, 88 bytes)
ATTR = struct.Struct("<QQQQQQIIIIIIIIII")

ENTRY_OUT = struct.Struct("<QQQQII")        # nodeid gen entry_valid attr_valid nsecs
ATTR_OUT = struct.Struct("<QII")            # attr_valid attr_valid_nsec dummy
OPEN_OUT = struct.Struct("<QII")            # fh open_flags padding
WRITE_OUT = struct.Struct("<II")
GETXATTR_OUT = struct.Struct("<II")
INIT_OUT = struct.Struct("<IIIIHHIIHHI28x")  # ..flags2 + unused[7] tail
STATFS_OUT = struct.Struct("<QQQQQIIII24x")

MAX_WRITE = 128 * 1024
FUSE_BIG_WRITES = 1 << 5
ATTR_TTL = 1.0


def _pack_attr(ino: int, a: dict) -> bytes:
    mode = a["st_mode"]
    size = a.get("st_size", 0)
    mt = int(a.get("st_mtime", 0))
    ct = int(a.get("st_ctime", mt))
    return ATTR.pack(ino, size, (size + 511) // 512, mt, mt, ct,
                     0, 0, 0, mode, a.get("st_nlink", 1),
                     a.get("st_uid", 0), a.get("st_gid", 0), 0, 4096, 0)


def _entry_reply(ino: int, a: dict) -> bytes:
    ttl = int(ATTR_TTL)
    nsec = int((ATTR_TTL - ttl) * 1e9)
    return ENTRY_OUT.pack(ino, 0, ttl, ttl, nsec, nsec) + _pack_attr(ino, a)


def _dirent(ino: int, off: int, name: bytes, dtype: int) -> bytes:
    ent = struct.pack("<QQII", ino, off, len(name), dtype) + name
    pad = (8 - len(ent) % 8) % 8
    return ent + b"\0" * pad


# ---------------------------------------------------------------------------
# mounting
# ---------------------------------------------------------------------------

_libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                    use_errno=True)
_libc.mount.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                        ctypes.c_ulong, ctypes.c_char_p]
MS_NOSUID, MS_NODEV = 0x2, 0x4


def _mount_dev_fuse(mountpoint: str, allow_other: bool) -> int:
    """Open /dev/fuse and mount(2) it; fall back to fusermount's
    _FUSE_COMMFD fd-passing protocol when mount(2) is not permitted."""
    try:
        fd = os.open("/dev/fuse", os.O_RDWR)
    except OSError as e:
        raise RuntimeError(f"cannot open /dev/fuse: {e}") from e
    opts = (f"fd={fd},rootmode=40000,user_id={os.getuid()},"
            f"group_id={os.getgid()},default_permissions")
    if allow_other:
        opts += ",allow_other"
    r = _libc.mount(b"seaweedfs_tpu", mountpoint.encode(), b"fuse",
                    MS_NOSUID | MS_NODEV, opts.encode())
    if r == 0:
        return fd
    os.close(fd)
    return _mount_fusermount(mountpoint, allow_other)


def _mount_fusermount(mountpoint: str, allow_other: bool) -> int:
    """fusermount passes the mounted /dev/fuse fd back over a unix
    socketpair named by $_FUSE_COMMFD (SCM_RIGHTS)."""
    s0, s1 = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    opts = "rootmode=40000,default_permissions"
    if allow_other:
        opts += ",allow_other"
    env = dict(os.environ, _FUSE_COMMFD=str(s1.fileno()))
    proc = subprocess.Popen(
        ["fusermount", "-o", opts, "--", mountpoint],
        env=env, pass_fds=(s1.fileno(),))
    s1.close()
    msg, anc, _, _ = s0.recvmsg(4, socket.CMSG_SPACE(4))
    proc.wait()
    s0.close()
    for level, ctype, data in anc:
        if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
            return struct.unpack("<i", data[:4])[0]
    raise RuntimeError(
        f"fusermount did not hand back a fd (exit {proc.returncode})")


def unmount(mountpoint: str) -> None:
    # non-lazy first: it aborts the fuse connection so the serve loop's
    # blocked read returns ENODEV immediately; MNT_DETACH only detaches
    if _libc.umount2(mountpoint.encode(), 0) == 0:
        return
    if _libc.umount2(mountpoint.encode(), 2) == 0:  # MNT_DETACH
        return
    # already-unmounted is fine (the serve loop also unmounts on exit)
    subprocess.call(["fusermount", "-u", "-z", "--", mountpoint],
                    stderr=subprocess.DEVNULL)


# ---------------------------------------------------------------------------
# the kernel session
# ---------------------------------------------------------------------------


class FUSE:
    """Mount `operations` (fusepy path-based API) at `mountpoint` and
    serve the kernel request loop until unmounted."""

    def __init__(self, operations, mountpoint: str, foreground: bool = True,
                 nothreads: bool = True, allow_other: bool = False,
                 ready_event: threading.Event | None = None):
        self.ops = operations
        self.mountpoint = os.path.abspath(mountpoint)
        # nodeid <-> path; nodeid doubles as st_ino
        self._paths: dict[int, str] = {1: "/"}
        self._ids: dict[str, int] = {"/": 1}
        self._next_id = 2
        self._lock = threading.Lock()
        self._fd = _mount_dev_fuse(self.mountpoint, allow_other)
        self._destroyed = False
        if ready_event is not None:
            ready_event.set()
        try:
            self._loop()
        finally:
            try:
                os.close(self._fd)
            except OSError:
                pass
            if not self._destroyed:
                unmount(self.mountpoint)
            if hasattr(self.ops, "destroy"):
                try:
                    self.ops.destroy(self.mountpoint)
                except Exception as e:
                    # teardown must finish unmounting either way, but a
                    # destroy() fault means dirty pages may not have
                    # flushed — that must be visible
                    glog.warning("fuse destroy(%s) failed: %r",
                                 self.mountpoint, e)

    # -- node table --

    def _id_of(self, path: str) -> int:
        with self._lock:
            nid = self._ids.get(path)
            if nid is None:
                nid = self._next_id
                self._next_id += 1
                self._ids[path] = nid
                self._paths[nid] = path
            return nid

    def _rename_tree(self, old: str, new: str) -> None:
        with self._lock:
            for nid, p in list(self._paths.items()):
                if p == old or p.startswith(old + "/"):
                    np = new + p[len(old):]
                    self._ids.pop(p, None)
                    self._paths[nid] = np
                    self._ids[np] = nid

    def _drop(self, path: str) -> None:
        with self._lock:
            nid = self._ids.pop(path, None)
            if nid is not None:
                self._paths.pop(nid, None)

    @staticmethod
    def _join(parent: str, name: str) -> str:
        return (parent.rstrip("/") or "") + "/" + name

    # -- request loop --

    def _loop(self) -> None:
        bufsize = MAX_WRITE + 4096
        while True:
            try:
                req = os.read(self._fd, bufsize)
            except OSError as e:
                if e.errno == errno.EINTR:
                    continue
                # ENODEV: unmounted; EBADF: fd closed
                break
            if not req:
                break
            (length, op, unique, nodeid, uid, gid, pid,
             _pad) = IN_HEADER.unpack_from(req)
            body = req[IN_HEADER.size:length]
            try:
                out = self._dispatch(op, nodeid, body)
            except FuseOSError as e:
                out = -(e.errno or errno.EIO)
            except OSError as e:
                out = -(e.errno or errno.EIO)
            except Exception:
                out = -errno.EIO
            if op in _NO_REPLY:
                continue
            if isinstance(out, int) and out < 0:
                reply = OUT_HEADER.pack(OUT_HEADER.size, out, unique)
            else:
                payload = out or b""
                reply = OUT_HEADER.pack(
                    OUT_HEADER.size + len(payload), 0, unique) + payload
            try:
                os.write(self._fd, reply)
            except OSError as e:
                if e.errno in (errno.ENOENT, errno.EINTR):
                    continue        # request was interrupted/aborted
                break
            if op == OP_DESTROY:
                self._destroyed = True
                break

    # -- dispatch --

    def _dispatch(self, op, nodeid, body):
        path = self._paths.get(nodeid, "/")
        if op == OP_INIT:
            major, minor, max_ra, flags = struct.unpack_from("<IIII", body)
            if major != FUSE_KERNEL_VERSION:
                # kernel re-INITs when we reply just our major
                return struct.pack("<I", FUSE_KERNEL_VERSION) + b"\0" * 60
            return INIT_OUT.pack(
                FUSE_KERNEL_VERSION, min(minor, FUSE_KERNEL_MINOR),
                max_ra, flags & FUSE_BIG_WRITES, 12, 8, MAX_WRITE, 1,
                0, 0, 0)
        if op == OP_LOOKUP:
            name = body.rstrip(b"\0").decode()
            child = self._join(path, name)
            a = self.ops.getattr(child, None)
            return _entry_reply(self._id_of(child), a)
        if op == OP_GETATTR:
            a = self.ops.getattr(path, None)
            ttl = int(ATTR_TTL)
            return ATTR_OUT.pack(ttl, 0, 0) + _pack_attr(nodeid, a)
        if op == OP_SETATTR:
            (valid, _pad, fh, size, _lo, _at, mt, _ct, _ans, _mns,
             _cns, mode, _u4, uid, gid, _u5) = struct.unpack_from(
                "<IIQQQQQQIIIIIIII", body)
            FATTR_MODE, FATTR_UID, FATTR_GID, FATTR_SIZE = 1, 2, 4, 8
            if valid & FATTR_SIZE:
                self.ops.truncate(path, size, None)
            if valid & FATTR_MODE:
                self.ops.chmod(path, mode)
            if valid & (FATTR_UID | FATTR_GID):
                a0 = self.ops.getattr(path, None)
                self.ops.chown(
                    path,
                    uid if valid & FATTR_UID else a0["st_uid"],
                    gid if valid & FATTR_GID else a0["st_gid"])
            a = self.ops.getattr(path, None)
            return ATTR_OUT.pack(int(ATTR_TTL), 0, 0) + _pack_attr(nodeid, a)
        if op == OP_MKDIR:
            mode, _umask = struct.unpack_from("<II", body)
            name = body[8:].rstrip(b"\0").decode()
            child = self._join(path, name)
            self.ops.mkdir(child, mode)
            return _entry_reply(self._id_of(child),
                                self.ops.getattr(child, None))
        if op in (OP_UNLINK, OP_RMDIR):
            name = body.rstrip(b"\0").decode()
            child = self._join(path, name)
            (self.ops.rmdir if op == OP_RMDIR else self.ops.unlink)(child)
            self._drop(child)
            return b""
        if op in (OP_RENAME, OP_RENAME2):
            off = 8 if op == OP_RENAME else 16
            (newdir,) = struct.unpack_from("<Q", body)
            oldn, newn = body[off:].rstrip(b"\0").split(b"\0")[:2]
            old = self._join(path, oldn.decode())
            new = self._join(self._paths.get(newdir, "/"), newn.decode())
            self.ops.rename(old, new)
            self._rename_tree(old, new)
            return b""
        if op in (OP_OPEN, OP_OPENDIR):
            (flags, _) = struct.unpack_from("<II", body)
            if op == OP_OPENDIR:
                return OPEN_OUT.pack(0, 0, 0)
            fh = self.ops.open(path, flags)
            return OPEN_OUT.pack(fh, 0, 0)
        if op == OP_CREATE:
            flags, mode, _umask, _ = struct.unpack_from("<IIII", body)
            name = body[16:].rstrip(b"\0").decode()
            child = self._join(path, name)
            fh = self.ops.create(child, mode & 0o7777)
            a = self.ops.getattr(child, fh)
            return (_entry_reply(self._id_of(child), a)
                    + OPEN_OUT.pack(fh, 0, 0))
        if op == OP_READ:
            fh, off, size = struct.unpack_from("<QQI", body)
            return bytes(self.ops.read(path, size, off, fh))
        if op == OP_WRITE:
            fh, off, size, _wf = struct.unpack_from("<QQII", body)
            data = body[struct.calcsize("<QQIIQII"):]
            if len(data) < size:       # header grew in 7.9; recompute
                data = body[-size:]
            n = self.ops.write(path, data[:size], off, fh)
            return WRITE_OUT.pack(n, 0)
        if op == OP_READDIR:
            fh, off, size = struct.unpack_from("<QQI", body)
            names = self.ops.readdir(path, fh)
            out = b""
            for i, name in enumerate(names[off:], start=off + 1):
                if name in (".", ".."):
                    ino, dtype = 1, stat_m.S_IFDIR >> 12
                else:
                    child = self._join(path, name)
                    ino = self._id_of(child)
                    dtype = 0
                ent = _dirent(ino, i, name.encode(), dtype)
                if len(out) + len(ent) > size:
                    break
                out += ent
            return out
        if op == OP_FLUSH:
            fh, = struct.unpack_from("<Q", body)
            self.ops.flush(path, fh)
            return b""
        if op in (OP_RELEASE, OP_RELEASEDIR):
            fh, = struct.unpack_from("<Q", body)
            if op == OP_RELEASE:
                self.ops.release(path, fh)
            return b""
        if op in (OP_FSYNC, OP_FSYNCDIR):
            fh, = struct.unpack_from("<Q", body)
            if op == OP_FSYNC and hasattr(self.ops, "flush"):
                self.ops.flush(path, fh)
            return b""
        if op == OP_STATFS:
            return STATFS_OUT.pack(1 << 30, 1 << 29, 1 << 29, 1 << 20,
                                   1 << 19, 4096, 255, 4096, 0)
        if op == OP_ACCESS:
            return b""
        if op == OP_GETXATTR:
            size, _ = struct.unpack_from("<II", body)
            name = body[8:].rstrip(b"\0").decode()
            try:
                val = self.ops.getxattr(path, name)
            except FuseOSError:
                raise
            if size == 0:
                return GETXATTR_OUT.pack(len(val), 0)
            if len(val) > size:
                return -errno.ERANGE
            return bytes(val)
        if op == OP_LISTXATTR:
            size, _ = struct.unpack_from("<II", body)
            names = self.ops.listxattr(path)
            blob = b"".join(n.encode() + b"\0" for n in names)
            if size == 0:
                return GETXATTR_OUT.pack(len(blob), 0)
            if len(blob) > size:
                return -errno.ERANGE
            return blob
        if op == OP_SETXATTR:
            vsize, _flags = struct.unpack_from("<II", body)
            rest = body[8:]
            nul = rest.index(b"\0")
            name = rest[:nul].decode()
            value = rest[nul + 1:nul + 1 + vsize]
            self.ops.setxattr(path, name, value, 0)
            return b""
        if op == OP_REMOVEXATTR:
            name = body.rstrip(b"\0").decode()
            self.ops.removexattr(path, name)
            return b""
        if op == OP_DESTROY:
            return b""
        if op in _NO_REPLY:
            return b""
        return -errno.ENOSYS
