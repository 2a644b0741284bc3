"""Wire messages for inter-server RPC.

The reference defines these in protobuf (pb/master.proto, volume_server.proto,
filer.proto) over gRPC; this build carries the same fields as JSON over the
asyncio HTTP mesh (bulk shard/needle bytes travel as raw HTTP bodies, not
JSON). Field names follow the protos so the mapping stays auditable.

A copy of seaweedfs_tpu/pb/messages.py in the PyTorch port.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class VolumeInformationMessage:
    """master.proto VolumeInformationMessage (heartbeat volume entry)."""
    id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: int = 0
    version: int = 3
    ttl: int = 0
    compact_revision: int = 0
    # .dat lives on a tier backend (volume_tier.py): the autopilot
    # must never re-plan tier_seal for an already-remote volume
    remote: bool = False

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeInformationMessage":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class VolumeEcShardInformationMessage:
    """master.proto VolumeEcShardInformationMessage: vid + shard bitmask."""
    id: int
    collection: str = ""
    ec_index_bits: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeEcShardInformationMessage":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class Heartbeat:
    """master.proto Heartbeat: full + delta volume/EC-shard sync."""
    ip: str = ""
    port: int = 0
    public_url: str = ""
    max_volume_count: int = 0
    max_file_key: int = 0
    data_center: str = ""
    rack: str = ""
    volumes: list[VolumeInformationMessage] = field(default_factory=list)
    new_volumes: list[VolumeInformationMessage] = field(default_factory=list)
    deleted_volumes: list[VolumeInformationMessage] = field(default_factory=list)
    ec_shards: list[VolumeEcShardInformationMessage] = field(default_factory=list)
    new_ec_shards: list[VolumeEcShardInformationMessage] = field(default_factory=list)
    deleted_ec_shards: list[VolumeEcShardInformationMessage] = field(default_factory=list)
    has_no_volumes: bool = False
    has_no_ec_shards: bool = False

    def to_dict(self) -> dict:
        return {
            "ip": self.ip, "port": self.port, "public_url": self.public_url,
            "max_volume_count": self.max_volume_count,
            "max_file_key": self.max_file_key,
            "data_center": self.data_center, "rack": self.rack,
            "volumes": [v.to_dict() for v in self.volumes],
            "new_volumes": [v.to_dict() for v in self.new_volumes],
            "deleted_volumes": [v.to_dict() for v in self.deleted_volumes],
            "ec_shards": [s.to_dict() for s in self.ec_shards],
            "new_ec_shards": [s.to_dict() for s in self.new_ec_shards],
            "deleted_ec_shards": [s.to_dict() for s in self.deleted_ec_shards],
            "has_no_volumes": self.has_no_volumes,
            "has_no_ec_shards": self.has_no_ec_shards,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Heartbeat":
        h = cls(**{k: d.get(k, cls.__dataclass_fields__[k].default)
                   for k in ("ip", "port", "public_url", "max_volume_count",
                             "max_file_key", "data_center", "rack",
                             "has_no_volumes", "has_no_ec_shards")})
        h.volumes = [VolumeInformationMessage.from_dict(x)
                     for x in d.get("volumes", [])]
        h.new_volumes = [VolumeInformationMessage.from_dict(x)
                         for x in d.get("new_volumes", [])]
        h.deleted_volumes = [VolumeInformationMessage.from_dict(x)
                             for x in d.get("deleted_volumes", [])]
        h.ec_shards = [VolumeEcShardInformationMessage.from_dict(x)
                       for x in d.get("ec_shards", [])]
        h.new_ec_shards = [VolumeEcShardInformationMessage.from_dict(x)
                           for x in d.get("new_ec_shards", [])]
        h.deleted_ec_shards = [VolumeEcShardInformationMessage.from_dict(x)
                               for x in d.get("deleted_ec_shards", [])]
        return h


def shard_bits_add(bits: int, shard_id: int) -> int:
    """ShardBits bitmask ops (ec_volume_info.go:61-113)."""
    return bits | (1 << shard_id)


def shard_bits_remove(bits: int, shard_id: int) -> int:
    return bits & ~(1 << shard_id)


def shard_bits_list(bits: int) -> list[int]:
    return [i for i in range(32) if bits & (1 << i)]


def shard_bits_count(bits: int) -> int:
    return bin(bits).count("1")
