"""Needle: one stored blob record in a volume file.

Binary layout follows the reference byte-for-byte so .dat files are
interchangeable (weed/storage/needle/needle.go:26-46,
needle_read_write.go:31-151):

  header : cookie(4) id(8) size(4)                       -- big-endian
  body v2/v3 (present only when size > 0):
    dataSize(4) data flags(1)
    [nameSize(1) name]         if FlagHasName
    [mimeSize(1) mime]         if FlagHasMime
    [lastModified(5)]          if FlagHasLastModifiedDate
    [ttl(2)]                   if FlagHasTtl
    [pairsSize(2) pairs]       if FlagHasPairs
  footer : checksum(4 masked crc32c of data)
           appendAtNs(8)                                  -- v3 only
           zero padding to 8-byte alignment of the whole record
  size   = 4 + dataSize + 1 + optional-field bytes (0 when no data)

A copy of seaweedfs_tpu/storage/needle.py in the PyTorch port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..util import crc32c
from . import types as t

FLAG_GZIP = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5

MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB w/ 4B offsets


class NeedleError(Exception):
    pass


class CrcMismatch(NeedleError):
    pass


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    data: bytes = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0
    ttl: t.TTL = field(default_factory=t.TTL)
    flags: int = 0
    append_at_ns: int = 0
    # populated on read:
    size: int = 0
    checksum: int = 0

    # ---- flag helpers ----
    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set_flag(self, flag: int, on: bool = True) -> None:
        if on:
            self.flags |= flag
        else:
            self.flags &= ~flag

    @property
    def is_gzipped(self) -> bool:
        return self.has(FLAG_GZIP)

    @property
    def is_chunked_manifest(self) -> bool:
        return self.has(FLAG_IS_CHUNK_MANIFEST)

    def etag(self) -> str:
        if not self.data and self.checksum:
            # meta-only read (zero-copy ref): derive the same CRC the
            # buffered path computes, from the stored footer checksum
            return "%08x" % crc32c.unmasked(self.checksum)
        return "%08x" % (crc32c.crc32c(self.data) & 0xFFFFFFFF)

    # ---- serialization ----

    def _body_size(self) -> int:
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + min(len(self.name), 255)
        if self.has(FLAG_HAS_MIME):
            size += 1 + len(self.mime)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            size += 2
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = t.CURRENT_VERSION) -> bytes:
        """Serialized record incl. footer + padding (prepareWriteBuffer)."""
        if version == t.VERSION1:
            self.size = len(self.data)
            out = bytearray()
            out += self.cookie.to_bytes(4, "big")
            out += self.id.to_bytes(8, "big")
            out += self.size.to_bytes(4, "big")
            out += self.data
            out += crc32c.checksum_value(self.data).to_bytes(4, "big")
            out += b"\x00" * t.padding_length(self.size, version)
            return bytes(out)
        if version not in (t.VERSION2, t.VERSION3):
            raise NeedleError(f"unsupported needle version {version}")

        if len(self.mime) > 255:
            raise NeedleError(f"mime too long: {len(self.mime)} > 255")
        if len(self.pairs) > 65535:
            raise NeedleError(f"pairs too long: {len(self.pairs)} > 65535")
        # auto-set flags for populated optional fields
        if self.name:
            self.set_flag(FLAG_HAS_NAME)
        if self.mime:
            self.set_flag(FLAG_HAS_MIME)
        if self.last_modified:
            self.set_flag(FLAG_HAS_LAST_MODIFIED)
        if self.ttl.count:
            self.set_flag(FLAG_HAS_TTL)
        if self.pairs:
            self.set_flag(FLAG_HAS_PAIRS)

        self.size = self._body_size()
        out = bytearray()
        out += self.cookie.to_bytes(4, "big")
        out += self.id.to_bytes(8, "big")
        out += self.size.to_bytes(4, "big")
        if self.data:
            out += len(self.data).to_bytes(4, "big")
            out += self.data
            out += bytes([self.flags])
            if self.has(FLAG_HAS_NAME):
                name = self.name[:255]
                out += bytes([len(name)]) + name
            if self.has(FLAG_HAS_MIME):
                out += bytes([len(self.mime)]) + self.mime
            if self.has(FLAG_HAS_LAST_MODIFIED):
                out += self.last_modified.to_bytes(8, "big")[-LAST_MODIFIED_BYTES:]
            if self.has(FLAG_HAS_TTL):
                out += self.ttl.to_bytes()
            if self.has(FLAG_HAS_PAIRS):
                out += len(self.pairs).to_bytes(2, "big") + self.pairs
        out += crc32c.checksum_value(self.data).to_bytes(4, "big")
        if version == t.VERSION3:
            if not self.append_at_ns:
                self.append_at_ns = time.time_ns()
            out += self.append_at_ns.to_bytes(8, "big")
        out += b"\x00" * t.padding_length(self.size, version)
        return bytes(out)

    @classmethod
    def from_bytes(cls, blob: bytes, version: int = t.CURRENT_VERSION,
                   check_crc: bool = True) -> "Needle":
        """Parse a full record blob (header..padding) — ReadBytes/ReadData."""
        n = cls()
        n.cookie = int.from_bytes(blob[0:4], "big")
        n.id = int.from_bytes(blob[4:12], "big")
        n.size = int.from_bytes(blob[12:16], "big")
        body = blob[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + n.size]
        if version == t.VERSION1:
            n.data = bytes(body)
        elif n.size > 0:
            n._parse_body(body)
        footer_off = t.NEEDLE_HEADER_SIZE + n.size
        n.checksum = int.from_bytes(blob[footer_off:footer_off + 4], "big")
        if version == t.VERSION3:
            n.append_at_ns = int.from_bytes(
                blob[footer_off + 4:footer_off + 12], "big")
        if check_crc and n.size > 0:
            if crc32c.checksum_value(n.data) != n.checksum:
                raise CrcMismatch(
                    f"needle {n.id:x} crc mismatch: "
                    f"stored {n.checksum:08x}")
        return n

    def _parse_body(self, body: bytes) -> None:
        idx = 0
        data_size = int.from_bytes(body[idx:idx + 4], "big")
        idx += 4
        self.data = bytes(body[idx:idx + data_size])
        idx += data_size
        self.flags = body[idx]
        idx += 1
        if self.has(FLAG_HAS_NAME):
            ln = body[idx]
            idx += 1
            self.name = bytes(body[idx:idx + ln])
            idx += ln
        if self.has(FLAG_HAS_MIME):
            ln = body[idx]
            idx += 1
            self.mime = bytes(body[idx:idx + ln])
            idx += ln
        if self.has(FLAG_HAS_LAST_MODIFIED):
            self.last_modified = int.from_bytes(
                body[idx:idx + LAST_MODIFIED_BYTES], "big")
            idx += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            self.ttl = t.TTL.from_bytes(body[idx:idx + 2])
            idx += 2
        if self.has(FLAG_HAS_PAIRS):
            ln = int.from_bytes(body[idx:idx + 2], "big")
            idx += 2
            self.pairs = bytes(body[idx:idx + ln])
            idx += ln

    def disk_size(self, version: int = t.CURRENT_VERSION) -> int:
        return t.actual_size(self._body_size() if not self.size else self.size,
                             version)

    def has_expired(self, now: float | None = None) -> bool:
        """TTL check against last_modified (volume_read_write.go:152-163)."""
        if not self.ttl.minutes:
            return False
        now = now if now is not None else time.time()
        return now >= self.last_modified + self.ttl.minutes * 60
