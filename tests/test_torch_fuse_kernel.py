"""The port's /dev/fuse binding (seaweedfs_tpu_torch/mount/fusekernel.py)
and its adapter over the mount's nodes (mount/fuse_adapter.py).

- The copy of tests/test_fuse_kernel.py's kernel round trip, on the port's
  cluster and mount: VFS -> fusekernel -> WFS -> filer -> volume through a
  real kernel mount, with the reference test's syscalls (`_exercise`) and
  skipped where the reference's is (its `_can_mount`: no /dev/fuse, no
  mount permission, no user xattrs).
- Wire cases that need no kernel: one stream of FUSE 7.31 requests, sent
  through a SOCK_SEQPACKET socketpair (chip_smoke.serve_fuse replaces
  _mount_dev_fuse for the call) into the reference's fusekernel.FUSE and
  into the port's, over the same stub Operations, gives byte-equal replies;
  and the port's SeaweedFuseOps on the port's CPU cluster, driven through
  the same socketpair as chip_smoke.py's phase 14 drives it.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import os
import stat
import struct
import sys
import threading

import pytest

from test_fuse_kernel import _can_mount, _exercise
from test_torch_cluster_util import Cluster, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernel_mount_roundtrip(tmp_path):
    reason = _can_mount(tmp_path)
    if reason:
        pytest.skip(reason)

    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.mount import fusekernel
    from seaweedfs_tpu_torch.mount.fuse_adapter import SeaweedFuseOps
    from seaweedfs_tpu_torch.mount.wfs import WFS, MountOptions

    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            wfs = WFS(Filer("memory"),
                      c.master.url.replace("http://", ""),
                      MountOptions(chunk_size_limit=64 * 1024))
            ops = SeaweedFuseOps(wfs)   # runs WFS on its own loop thread
            mp = tmp_path / "mnt"
            mp.mkdir()
            ready = threading.Event()
            t = threading.Thread(
                target=lambda: fusekernel.FUSE(ops, str(mp),
                                               ready_event=ready),
                daemon=True)
            t.start()
            assert ready.wait(10), "kernel mount did not come up"
            try:
                await asyncio.to_thread(_exercise, str(mp))
            finally:
                await asyncio.to_thread(fusekernel.unmount, str(mp))
                # join via a thread: destroy() drains deletes over HTTP
                # served by THIS event loop — a sync join would deadlock
                await asyncio.to_thread(t.join, 10)
            assert not t.is_alive(), "serve loop did not exit on unmount"

    run(body())


# ---------------------------------------------------------------------------
# the wire, without a kernel
# ---------------------------------------------------------------------------

def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


MTIME = 1_700_000_000


class StubOps:
    """A path-based in-memory filesystem in fusepy's Operations API, the
    same for both bindings: fixed times, handles numbered from 1, and
    fusepy's errors (FuseOSError of the binding under test)."""

    def __init__(self, error_cls) -> None:
        self.err = error_cls
        self.dirs = {"/": 0o755}
        self.files: dict[str, bytearray] = {}
        self.modes: dict[str, int] = {}
        self.xattrs: dict[str, dict[str, bytes]] = {}
        self.fh = 0
        self.destroyed = False

    def _new_fh(self) -> int:
        self.fh += 1
        return self.fh

    def getattr(self, path, fh=None):
        if path in self.dirs:
            return {"st_mode": stat.S_IFDIR | self.dirs[path],
                    "st_nlink": 2, "st_mtime": MTIME, "st_ctime": MTIME}
        if path in self.files:
            return {"st_mode": stat.S_IFREG | self.modes[path],
                    "st_nlink": 1, "st_size": len(self.files[path]),
                    "st_uid": 7, "st_gid": 8, "st_mtime": MTIME + 1}
        raise self.err(errno.ENOENT)

    def readdir(self, path, fh):
        prefix = path.rstrip("/") + "/"
        kids = sorted(p[len(prefix):] for p in list(self.dirs)
                      + list(self.files)
                      if p.startswith(prefix) and p != path
                      and "/" not in p[len(prefix):])
        return [".", ".."] + kids

    def mkdir(self, path, mode):
        self.dirs[path] = mode & 0o7777

    def rmdir(self, path):
        if self.readdir(path, None)[2:]:
            raise self.err(errno.ENOTEMPTY)
        del self.dirs[path]

    def unlink(self, path):
        del self.files[path]

    def rename(self, old, new):
        self.files[new] = self.files.pop(old)
        self.modes[new] = self.modes.pop(old)

    def chmod(self, path, mode):
        self.modes[path] = mode & 0o7777

    def chown(self, path, uid, gid):
        pass

    def truncate(self, path, length, fh=None):
        del self.files[path][length:]

    def create(self, path, mode, fi=None):
        self.files[path] = bytearray()
        self.modes[path] = mode
        return self._new_fh()

    def open(self, path, flags):
        if path not in self.files:
            raise self.err(errno.EISDIR)
        return self._new_fh()

    def read(self, path, size, offset, fh):
        return bytes(self.files[path][offset:offset + size])

    def write(self, path, data, offset, fh):
        buf = self.files[path]
        buf[offset:offset + len(data)] = data
        return len(data)

    def flush(self, path, fh):
        return 0

    def release(self, path, fh):
        return 0

    def getxattr(self, path, name, position=0):
        try:
            return self.xattrs[path][name]
        except KeyError:
            raise self.err(errno.ENODATA)

    def setxattr(self, path, name, value, options, position=0):
        self.xattrs.setdefault(path, {})[name] = value

    def listxattr(self, path):
        return sorted(self.xattrs.get(path, {}))

    def removexattr(self, path, name):
        del self.xattrs[path][name]

    def destroy(self, path):
        self.destroyed = True


def _requests(k) -> list[tuple]:
    """The request stream: (opcode, nodeid, body) in the 7.31 layouts,
    nodeids as both bindings hand them out (1 the root, then 2, 3, ...
    in the order of first sight). None stands for FORGET, which gets no
    reply."""
    n, rw, s = k.name, k.RW, struct.pack
    data = bytes(range(256)) * 500          # under max_write, as a kernel sends
    return [
        ("INIT", 0, s("<IIII", 7, 31, 1 << 17, k.BIG_WRITES | 1)),
        ("LOOKUP", 1, n("missing")),
        ("MKDIR", 1, s("<II", 0o40755, 0o022) + n("d")),       # node 2
        ("CREATE", 2, s("<IIII", os.O_WRONLY | os.O_CREAT, 0o100640,
                        0o022, 0) + n("f")),                     # node 3
        ("WRITE", 3, rw.pack(1, 0, len(data), 0, 0, 0, 0) + data),
        ("WRITE", 3, rw.pack(1, len(data), 5, 0, 0, 0, 0) + b"tail!"),
        ("FLUSH", 3, s("<QIIQ", 1, 0, 0, 0)),
        ("FSYNC", 3, s("<QII", 1, 0, 0)),
        ("RELEASE", 3, s("<QIIQ", 1, 0, 0, 0)),
        ("LOOKUP", 2, n("f")),
        ("GETATTR", 3, s("<IIQ", 0, 0, 0)),
        ("GETATTR", 1, s("<IIQ", 0, 0, 0)),
        ("SETATTR", 3, s("<IIQQQQQQIIIIIIII", 1 | 8, 0, 0, 1000, 0, 0, 0,
                         0, 0, 0, 0, 0o600, 0, 0, 0, 0)),
        ("OPEN", 3, s("<II", os.O_RDONLY, 0)),
        ("READ", 3, rw.pack(2, 0, 1 << 17, 0, 0, 0, 0)),
        ("READ", 3, rw.pack(2, 990, 100, 0, 0, 0, 0)),
        ("RELEASE", 3, s("<QIIQ", 2, 0, 0, 0)),
        ("OPENDIR", 2, s("<II", 0, 0)),
        ("READDIR", 2, rw.pack(0, 0, 4096, 0, 0, 0, 0)),
        ("READDIR", 2, rw.pack(0, 2, 4096, 0, 0, 0, 0)),
        ("READDIR", 2, rw.pack(0, 0, 40, 0, 0, 0, 0)),
        ("RELEASEDIR", 2, s("<QIIQ", 0, 0, 0, 0)),
        ("SETXATTR", 3, s("<II", 3, 0) + n("user.a") + b"abc"),
        ("SETXATTR", 3, s("<II", 1, 0) + n("user.b") + b"z"),
        ("GETXATTR", 3, s("<II", 0, 0) + n("user.a")),
        ("GETXATTR", 3, s("<II", 3, 0) + n("user.a")),
        ("GETXATTR", 3, s("<II", 2, 0) + n("user.a")),
        ("GETXATTR", 3, s("<II", 8, 0) + n("user.none")),
        ("LISTXATTR", 3, s("<II", 0, 0)),
        ("LISTXATTR", 3, s("<II", 64, 0)),
        ("REMOVEXATTR", 3, n("user.b")),
        ("LISTXATTR", 3, s("<II", 64, 0)),
        ("RENAME", 2, s("<Q", 1) + n("f") + n("g")),
        ("LOOKUP", 1, n("g")),
        ("LOOKUP", 2, n("f")),
        ("STATFS", 1, b""),
        ("ACCESS", 1, s("<II", 4, 0)),
        ("MKDIR", 2, s("<II", 0o40700, 0) + n("sub")),         # node 4
        ("RMDIR", 1, n("d")),
        ("RMDIR", 2, n("sub")),
        ("RMDIR", 1, n("d")),
        None,                                                    # FORGET
        (46, 1, s("<QQI", 0, 0, 0)),                             # LSEEK
        ("UNLINK", 1, n("g")),
        ("LOOKUP", 1, n("g")),
        ("DESTROY", 1, b""),
    ]


def _replay(fusekernel, error_cls) -> tuple[list[bytes], StubOps]:
    """Send the stream into `fusekernel`'s FUSE loop over a socketpair;
    return every raw reply and the stub it served."""
    cs = _chip_smoke()
    ops = StubOps(error_cls)
    kernel, t = cs.serve_fuse(fusekernel, ops, "/nonexistent-mount-point")
    replies = []
    try:
        for req in _requests(kernel):
            if req is None:
                kernel.sock.send(kernel.IN.pack(kernel.IN.size + 8, 2, 0,
                                                3, 0, 0, 0, 0)
                                 + struct.pack("<Q", 1))
                continue
            replies.append(kernel.raw(*req))
    finally:
        t.join(10)
        kernel.sock.close()
    assert not t.is_alive(), "the FUSE loop did not end after DESTROY"
    return replies, ops


def test_wire_replies_equal_the_reference():
    """Every reply of the port's FUSE loop equals the reference's, byte
    for byte, over the same stub filesystem: INIT, LOOKUP (found and
    ENOENT), MKDIR, CREATE, WRITE, FLUSH, FSYNC, RELEASE, GETATTR,
    SETATTR (size and mode), OPEN, READ, OPENDIR, READDIR (from an offset
    and cut to a small buffer), RELEASEDIR, the xattrs (a size query,
    ERANGE, ENODATA), RENAME, STATFS, ACCESS, RMDIR (ENOTEMPTY and done),
    a FORGET (no reply), an opcode the binding does not serve (ENOSYS),
    UNLINK and DESTROY."""
    from seaweedfs_tpu.mount import fusekernel as ref_kernel
    from seaweedfs_tpu_torch.mount import fusekernel as port_kernel

    ref, ref_ops = _replay(ref_kernel, ref_kernel.FuseOSError)
    port, port_ops = _replay(port_kernel, port_kernel.FuseOSError)
    assert len(port) == len(ref) == 45
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"reply {i} differs"
    assert ref_ops.destroyed and port_ops.destroyed
    cs = _chip_smoke()
    out = cs.FuseKernel.OUT
    errors = [out.unpack_from(r)[1] for r in port]
    want = {1: -errno.ENOENT, 26: -errno.ERANGE, 27: -errno.ENODATA,
            34: -errno.ENOENT, 38: -errno.ENOTEMPTY, 41: -errno.ENOSYS,
            43: -errno.ENOENT}
    assert {i: e for i, e in enumerate(errors) if e} == want
    # INIT: 7.31, big writes kept, max_write 128 KiB
    major, minor, _, flags, _, _, max_write = struct.unpack_from(
        "<IIIIHHI", port[0], out.size)
    assert (major, minor, flags, max_write) == (7, 31, 1 << 5, 1 << 17)
    # READ after the truncate to 1000 bytes: 128 KiB asked, 1000 given
    assert len(port[14]) == out.size + 1000
    assert port[14][out.size:] == (bytes(range(256)) * 4)[:1000]


def test_seaweed_fuse_ops_serve_the_wire_end_to_end(tmp_path):
    """The port's SeaweedFuseOps over a WFS on the port's CPU cluster,
    served by the port's FUSE loop over a socketpair: a tree written in
    128 KiB WRITEs and read back (sha256), a truncate through SETATTR, a
    RENAME, the xattrs, UNLINK and RMDIR, each held to the filer's
    entries; DESTROY closes the WFS."""
    cs = _chip_smoke()
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.mount import fuse_adapter, fusekernel
    from seaweedfs_tpu_torch.mount.wfs import WFS, MountOptions

    assert fuse_adapter.KERNEL_BINDING == "builtin"
    blob = os.urandom(300_000)

    def drive(k, wfs) -> None:
        major, minor, _, max_write = k.init()
        assert (major, minor, max_write) == (7, 31, 1 << 17)
        d = k.mkdir(1, "docs")
        f, fh = k.create(d, "big.bin")
        for off in range(0, len(blob), 1 << 17):
            assert k.write(f, fh, off, blob[off:off + (1 << 17)]) == \
                len(blob[off:off + (1 << 17)])
        k.flush(f, fh)
        k.release(f, fh)
        entry = wfs.filer.find_entry("/docs/big.bin")
        assert [(c.offset, c.size) for c in entry.chunks] == \
            [(0, 65536 * 4), (65536 * 4, len(blob) - 65536 * 4)]
        assert k.readdir(1) == ["docs"] and k.readdir(d) == ["big.bin"]
        node, a = k.lookup(d, "big.bin")
        assert node == f and a["size"] == len(blob)
        fh = k.open(f)
        got = b"".join(k.read(f, fh, off) for off in
                       range(0, len(blob) + 1, 1 << 17))
        k.release(f, fh)
        assert hashlib.sha256(got).digest() == hashlib.sha256(blob).digest()
        k.ok("SETATTR", f, struct.pack("<IIQQQQQQIIIIIIII", 8, 0, 0, 1000,
                                       0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0))
        assert k.getattr(f)["size"] == 1000
        k.rename(d, "big.bin", 1, "moved.bin")
        assert k.call("LOOKUP", d, k.name("big.bin"))[0] == -errno.ENOENT
        fh = k.open(f)
        assert k.read(f, fh, 0) == blob[:1000]
        k.release(f, fh)
        k.setxattr(f, "user.tag", b"tpu")
        assert k.getxattr(f, "user.tag", 16) == b"tpu"
        assert k.listxattr(f) == ["user.tag"]
        assert wfs.filer.find_entry("/moved.bin").extended == \
            {"user.tag": b"tpu".hex()}
        k.unlink(1, "moved.bin")
        k.ok("RMDIR", 1, k.name("docs"))
        assert k.readdir(1) == []
        k.destroy()

    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            wfs = WFS(Filer("memory"), c.master.url.replace("http://", ""),
                      MountOptions(chunk_size_limit=256 * 1024))
            ops = await asyncio.to_thread(fuse_adapter.SeaweedFuseOps, wfs)
            k, t = await asyncio.to_thread(
                cs.serve_fuse, fusekernel, ops, str(tmp_path / "mnt"))
            try:
                await asyncio.to_thread(drive, k, wfs)
            finally:
                await asyncio.to_thread(t.join, 10)
                k.sock.close()
            assert not t.is_alive()
            assert not ops.lt.thread.is_alive()
            assert wfs._pending_fids == []

    run(body())
