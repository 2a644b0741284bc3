"""ctypes binding for the native compact needle map (needle_map.c).

The memory-dense replacement for a Python dict in the per-volume needle
index — the role of the reference's CompactMap
(storage/needle_map/compact_map.go, perf-tested at 100M entries).

A copy of seaweedfs_tpu/native/needle_map.py in the PyTorch port.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build

_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def available() -> bool:
    lib = build.load()
    return lib is not None and hasattr(lib, "swtpu_nm_new")


class NativeMap:
    """16-bytes-per-entry key -> (offset, size) map. key must be > 0."""

    def __init__(self):
        lib = build.load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.swtpu_nm_new()
        if not self._h:
            raise MemoryError("swtpu_nm_new failed")

    def close(self) -> None:
        if self._h:
            self._lib.swtpu_nm_free(self._h)
            self._h = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except (OSError, AttributeError):
            pass  # interpreter teardown: ctypes lib may be half-gone

    def set(self, key: int, offset: int, size: int) -> tuple[int, int] | None:
        """Insert/replace; returns the previous (offset, size) or None."""
        old_off = ctypes.c_uint32()
        old_size = ctypes.c_uint32()
        r = self._lib.swtpu_nm_set(self._h, key, offset, size,
                                   ctypes.byref(old_off),
                                   ctypes.byref(old_size))
        if r < 0:
            raise MemoryError("needle map allocation failure")
        if r == 1:
            return (old_off.value, old_size.value)
        return None

    def get(self, key: int) -> tuple[int, int] | None:
        off = ctypes.c_uint32()
        size = ctypes.c_uint32()
        if self._lib.swtpu_nm_get(self._h, key, ctypes.byref(off),
                                  ctypes.byref(size)):
            return (off.value, size.value)
        return None

    def __len__(self) -> int:
        return int(self._lib.swtpu_nm_len(self._h))

    def items(self, batch: int = 65536):
        """Yield (key, offset, size) in unspecified order."""
        state = ctypes.c_uint64(0)
        keys = np.empty(batch, np.uint64)
        offs = np.empty(batch, np.uint32)
        sizes = np.empty(batch, np.uint32)
        while True:
            n = self._lib.swtpu_nm_scan(
                self._h, ctypes.byref(state),
                keys.ctypes.data_as(_u64p), offs.ctypes.data_as(_u32p),
                sizes.ctypes.data_as(_u32p), batch)
            for i in range(int(n)):
                yield int(keys[i]), int(offs[i]), int(sizes[i])
            if n < batch:
                return
