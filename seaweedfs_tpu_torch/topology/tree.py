"""Cluster topology tree: Topology -> DataCenter -> Rack -> DataNode.

Reference: weed/topology/node.go:16-63 (Node hierarchy with up-propagated
counters), data_node.go, rack.go, data_center.go, topology.go:20-39,
topology_ec.go (EC shard registry), node.go:275-291 (dead node / full
volume detection).

A copy of seaweedfs_tpu/topology/tree.py in the PyTorch port. Its
randomness is explicit: a Topology draws from the `random.Random` it is
given (DEFAULT_RNG, one process-wide instance, when none is), where the
reference draws from the module-global `random`.
"""

from __future__ import annotations

import random
import time

from ..pb import messages as pb

# the stream a Topology draws from when its caller passes none
DEFAULT_RNG = random.Random()


class DataNode:
    def __init__(self, node_id: str, ip: str, port: int, public_url: str,
                 max_volume_count: int):
        self.id = node_id
        self.ip = ip
        self.port = port
        self.public_url = public_url
        self.max_volume_count = max_volume_count
        self.volumes: dict[int, pb.VolumeInformationMessage] = {}
        self.ec_shards: dict[int, pb.VolumeEcShardInformationMessage] = {}
        self.last_seen = time.time()
        self.rack: "Rack | None" = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def volume_count(self) -> int:
        return len(self.volumes)

    def ec_shard_count(self) -> int:
        return sum(pb.shard_bits_count(m.ec_index_bits)
                   for m in self.ec_shards.values())

    def free_space(self) -> int:
        # EC shards consume slots at shard granularity (10 shards ~ 1 volume)
        from ..ec import gf
        ec_slots = -(-self.ec_shard_count() // gf.DATA_SHARDS)
        return self.max_volume_count - len(self.volumes) - ec_slots

    def update_volumes(self, msgs: list[pb.VolumeInformationMessage]
                       ) -> tuple[list, list]:
        """Full-state sync; returns (new, deleted) volume messages."""
        incoming = {m.id: m for m in msgs}
        new = [m for vid, m in incoming.items() if vid not in self.volumes]
        deleted = [m for vid, m in self.volumes.items()
                   if vid not in incoming]
        self.volumes = incoming
        return new, deleted

    def update_ec_shards(self, msgs: list[pb.VolumeEcShardInformationMessage]
                         ) -> tuple[list, list]:
        """Full-state sync; returns (changed, deleted). For each changed vid
        the OLD message (whose bits must be unregistered first) is paired in
        deleted so shrunken shard masks heal (topology_ec.go:15-34)."""
        incoming = {m.id: m for m in msgs}
        changed, deleted = [], []
        for vid, m in incoming.items():
            old = self.ec_shards.get(vid)
            if old is None or old.ec_index_bits != m.ec_index_bits:
                if old is not None and old.ec_index_bits != m.ec_index_bits:
                    deleted.append(old)
                changed.append(m)
        for vid, m in self.ec_shards.items():
            if vid not in incoming:
                deleted.append(m)
        self.ec_shards = incoming
        return changed, deleted


class Rack:
    def __init__(self, rack_id: str):
        self.id = rack_id
        self.nodes: dict[str, DataNode] = {}
        self.data_center: "DataCenter | None" = None

    def get_or_create_node(self, node_id: str, ip: str, port: int,
                           public_url: str, max_volumes: int) -> DataNode:
        n = self.nodes.get(node_id)
        if n is None:
            n = DataNode(node_id, ip, port, public_url, max_volumes)
            n.rack = self
            self.nodes[node_id] = n
        n.max_volume_count = max_volumes
        # refresh on every pulse: a server that learns/changes its
        # -publicUrl after registration (workers bind ephemeral ports
        # at start) must not stay pinned to the stale advertisement
        n.public_url = public_url
        n.last_seen = time.time()
        return n

    def free_space(self) -> int:
        return sum(n.free_space() for n in self.nodes.values())


class DataCenter:
    def __init__(self, dc_id: str):
        self.id = dc_id
        self.racks: dict[str, Rack] = {}

    def get_or_create_rack(self, rack_id: str) -> Rack:
        r = self.racks.get(rack_id)
        if r is None:
            r = Rack(rack_id)
            r.data_center = self
            self.racks[rack_id] = r
        return r

    def free_space(self) -> int:
        return sum(r.free_space() for r in self.racks.values())


class Topology:
    def __init__(self, pulse_seconds: float = 5.0,
                 rng: random.Random | None = None):
        self.data_centers: dict[str, DataCenter] = {}
        # placement's random stream (pick_weighted, layout's picks)
        self.rng = rng if rng is not None else DEFAULT_RNG
        self.pulse_seconds = pulse_seconds
        # vid -> {node_id -> DataNode} for normal volumes
        self.volume_locations: dict[int, dict[str, DataNode]] = {}
        # vid -> {shard_id -> [DataNode]} for EC (topology_ec.go:15-63)
        self.ec_shard_locations: dict[int, dict[int, list[DataNode]]] = {}
        self.collections: dict[int, str] = {}
        self.max_volume_id = 0

    # ---- membership ----

    def get_or_create_data_center(self, dc_id: str) -> DataCenter:
        dc = self.data_centers.get(dc_id)
        if dc is None:
            dc = DataCenter(dc_id)
            self.data_centers[dc_id] = dc
        return dc

    def all_nodes(self) -> list[DataNode]:
        return [n for dc in self.data_centers.values()
                for r in dc.racks.values() for n in r.nodes.values()]

    def find_node(self, node_id: str) -> DataNode | None:
        for n in self.all_nodes():
            if n.id == node_id:
                return n
        return None

    def register_heartbeat(self, hb: pb.Heartbeat) -> DataNode:
        dc = self.get_or_create_data_center(hb.data_center or "DefaultDataCenter")
        rack = dc.get_or_create_rack(hb.rack or "DefaultRack")
        node = rack.get_or_create_node(
            f"{hb.ip}:{hb.port}", hb.ip, hb.port, hb.public_url,
            hb.max_volume_count)
        if hb.volumes or hb.has_no_volumes:
            new, deleted = node.update_volumes(hb.volumes)
            for m in new:
                self.register_volume(m, node)
            for m in deleted:
                self.unregister_volume(m, node)
        for m in hb.new_volumes:
            node.volumes[m.id] = m
            self.register_volume(m, node)
        for m in hb.deleted_volumes:
            node.volumes.pop(m.id, None)
            self.unregister_volume(m, node)
        if hb.ec_shards or hb.has_no_ec_shards:
            changed, deleted = node.update_ec_shards(hb.ec_shards)
            for m in deleted:
                self.unregister_ec_shards(m, node)
            for m in hb.ec_shards:
                self.register_ec_shards(m, node)
        for m in hb.new_ec_shards:
            node.ec_shards[m.id] = m
            self.register_ec_shards(m, node)
        for m in hb.deleted_ec_shards:
            self.unregister_ec_shards(m, node)
        return node

    def unregister_node(self, node: DataNode) -> list[int]:
        """Node loss: drop all its volume/shard locations
        (master_grpc_server.go:22-48). Returns affected vids."""
        affected = []
        for vid, m in list(node.volumes.items()):
            self.unregister_volume(m, node)
            affected.append(vid)
        for m in list(node.ec_shards.values()):
            self.unregister_ec_shards(m, node)
            affected.append(m.id)
        if node.rack:
            node.rack.nodes.pop(node.id, None)
        return affected

    # ---- volume location registry ----

    def register_volume(self, m: pb.VolumeInformationMessage,
                        node: DataNode) -> None:
        self.volume_locations.setdefault(m.id, {})[node.id] = node
        self.collections[m.id] = m.collection
        self.max_volume_id = max(self.max_volume_id, m.id)

    def unregister_volume(self, m: pb.VolumeInformationMessage,
                          node: DataNode) -> None:
        locs = self.volume_locations.get(m.id)
        if locs:
            locs.pop(node.id, None)
            if not locs:
                del self.volume_locations[m.id]

    def register_ec_shards(self, m: pb.VolumeEcShardInformationMessage,
                           node: DataNode) -> None:
        by_shard = self.ec_shard_locations.setdefault(m.id, {})
        for sid in pb.shard_bits_list(m.ec_index_bits):
            nodes = by_shard.setdefault(sid, [])
            if node not in nodes:
                nodes.append(node)
        self.collections[m.id] = m.collection
        self.max_volume_id = max(self.max_volume_id, m.id)

    def unregister_ec_shards(self, m: pb.VolumeEcShardInformationMessage,
                             node: DataNode) -> None:
        by_shard = self.ec_shard_locations.get(m.id)
        if not by_shard:
            return
        for sid in pb.shard_bits_list(m.ec_index_bits):
            nodes = by_shard.get(sid, [])
            if node in nodes:
                nodes.remove(node)
            if not nodes:
                by_shard.pop(sid, None)
        if not by_shard:
            self.ec_shard_locations.pop(m.id, None)

    def lookup(self, vid: int) -> list[DataNode]:
        """volumeId -> servers (normal or EC) — topology.go:89."""
        locs = self.volume_locations.get(vid)
        if locs:
            return list(locs.values())
        by_shard = self.ec_shard_locations.get(vid)
        if by_shard:
            seen: dict[str, DataNode] = {}
            for nodes in by_shard.values():
                for n in nodes:
                    seen[n.id] = n
            return list(seen.values())
        return []

    def next_volume_id(self) -> int:
        self.max_volume_id += 1
        return self.max_volume_id

    # ---- liveness (node.go:275-291) ----

    def dead_nodes(self, now: float | None = None) -> list[DataNode]:
        now = now or time.time()
        limit = 3 * self.pulse_seconds
        return [n for n in self.all_nodes() if now - n.last_seen > limit]

    # ---- placement-support queries ----

    def pick_weighted(self, candidates: list, k: int = 1) -> list:
        """Randomly pick k candidates weighted by free_space
        (node.go:65-117 RandomlyPickNodes analog)."""
        pool = [c for c in candidates if c.free_space() > 0]
        picked = []
        for _ in range(min(k, len(pool))):
            total = sum(c.free_space() for c in pool)
            if total <= 0:
                break
            r = self.rng.randint(1, total)
            for c in pool:
                r -= c.free_space()
                if r <= 0:
                    picked.append(c)
                    pool.remove(c)
                    break
        return picked
