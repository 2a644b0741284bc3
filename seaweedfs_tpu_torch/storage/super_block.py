"""Volume superblock + replica placement encoding.

Reference: weed/storage/super_block/super_block.go:16-39 (8-byte header:
version, replica-placement byte, ttl 2B, compaction revision 2B, 2B
reserved/extra-size) and replica_placement.go:8-31 ("xyz" digit policy:
x = copies on different DCs, y = different racks same DC, z = different
servers same rack).

A copy of seaweedfs_tpu/storage/super_block.py in the PyTorch port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import types as t

SUPER_BLOCK_SIZE = 8


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack: int = 0       # z
    diff_rack: int = 0       # y
    diff_dc: int = 0         # x

    @classmethod
    def parse(cls, s: str | int | None) -> "ReplicaPlacement":
        if s is None or s == "":
            return cls()
        if isinstance(s, int):
            s = f"{s:03d}"
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"invalid replication {s!r}")
        x, y, z = (int(c) for c in s)
        if x > 2 or y > 2 or z > 2:
            raise ValueError(f"replication counts must be <= 2: {s!r}")
        return cls(same_rack=z, diff_rack=y, diff_dc=x)

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(same_rack=b % 10, diff_rack=(b // 10) % 10,
                   diff_dc=b // 100)

    @property
    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


@dataclass
class SuperBlock:
    version: int = t.CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: t.TTL = field(default_factory=t.TTL)
    compaction_revision: int = 0

    def to_bytes(self) -> bytes:
        out = bytearray(SUPER_BLOCK_SIZE)
        out[0] = self.version
        out[1] = self.replica_placement.to_byte()
        out[2:4] = self.ttl.to_bytes()
        out[4:6] = self.compaction_revision.to_bytes(2, "big")
        return bytes(out)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        return cls(
            version=b[0],
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=t.TTL.from_bytes(b[2:4]),
            compaction_revision=int.from_bytes(b[4:6], "big"),
        )
