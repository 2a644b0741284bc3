"""CRC32-Castagnoli with the reference's stored-value masking.

Matches weed/storage/needle/crc.go: the stored checksum is the "masked"
rotation used by snappy/leveldb: rotl(crc, 17) + 0xa282ead8. Raw CRC is the
reflected Castagnoli polynomial, same as klauspost/crc32's table.

Fast path is the native C library (SSE4.2 hardware CRC); fallback is a
pure-Python slicing table (slow, correctness-only).

A copy of seaweedfs_tpu/util/crc32c.py in the PyTorch port.
"""

from __future__ import annotations

from ..native import build as _build

_POLY = 0x82F63B78


def _make_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (_POLY ^ (c >> 1)) if (c & 1) else (c >> 1)
        table.append(c)
    return table


_TABLE = _make_table()


def _crc32c_py(crc: int, data: bytes) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# Resolved at the first call, not at import: importing the port builds
# nothing. load() may shell out to g++ when no library is built yet, so
# a server calls warm() at start-up, before its event loop serves a
# request, as the JAX package does by resolving the library at import.
_NATIVE = None
_resolved = False


def warm():
    """Resolve the native library once (building it if needed); returns
    it, or None when the toolchain is unavailable."""
    global _NATIVE, _resolved
    if not _resolved:
        _NATIVE = _build.load()
        _resolved = True
    return _NATIVE


def crc32c(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """Raw CRC32C of data, continuing from crc."""
    lib = _NATIVE if _resolved else warm()
    if lib is not None:
        data = bytes(data) if not isinstance(data, bytes) else data
        return lib.swtpu_crc32c(crc, data, len(data))
    return _crc32c_py(crc, bytes(data))


def masked(crc: int) -> int:
    """Stored-checksum masking (crc.go Value())."""
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def checksum_value(data: bytes | bytearray | memoryview) -> int:
    """Masked CRC32C as written into a needle footer."""
    return masked(crc32c(data))


def unmasked(value: int) -> int:
    """Inverse of masked(): recover the raw CRC32C from a stored
    footer checksum (zero-copy reads derive the ETag from the footer
    without pulling the body into userspace)."""
    v = (value - 0xA282EAD8) & 0xFFFFFFFF
    return ((v >> 17) | (v << 15)) & 0xFFFFFFFF
