"""FUSE-style mount layer: filer-backed VFS nodes with write-back caching.

Reference: weed/filesys/ (wfs.go, dir.go, file.go, filehandle.go,
dirty_page.go, xattr.go, wfs_deletion.go — 1,631 LoC). The node layer here
is kernel-agnostic: ops are plain async methods so the full semantics are
testable in-proc; `fuse_adapter` bridges to a real kernel mount when a
FUSE binding is importable.

A copy of seaweedfs_tpu/mount/__init__.py in the PyTorch port.
"""

from .wfs import WFS, MountOptions  # noqa: F401
