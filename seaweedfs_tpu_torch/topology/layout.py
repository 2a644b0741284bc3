"""Volume layouts and rack-aware replica placement.

Reference: weed/topology/volume_layout.go (per-(collection, replication,
ttl) writable sets), volume_growth.go:106-202 (findEmptySlotsForOneVolume:
3-level constrained random placement over DC -> rack -> server).

A copy of seaweedfs_tpu/topology/layout.py in the PyTorch port. Its
random picks draw from the Topology's stream (`topo.rng`), never from the
module-global `random`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..storage.super_block import ReplicaPlacement
from .tree import DataCenter, DataNode, Rack, Topology


class PlacementError(Exception):
    pass


@dataclass(frozen=True)
class LayoutKey:
    collection: str
    replication: str
    ttl: str


class VolumeLayout:
    """Tracks writable volume ids for one layout key
    (volume_layout.go:17-32)."""

    def __init__(self, key: LayoutKey, volume_size_limit: int):
        self.key = key
        self.volume_size_limit = volume_size_limit
        self.writable: set[int] = set()

    def set_writable(self, vid: int, writable: bool) -> None:
        if writable:
            self.writable.add(vid)
        else:
            self.writable.discard(vid)

    def pick_for_write(self, topo: Topology,
                       replica_count: int) -> int | None:
        """Random writable vid that still has enough replicas registered
        (volume_layout.go:165 PickForWrite)."""
        candidates = [vid for vid in self.writable
                      if len(topo.volume_locations.get(vid, {}))
                      >= replica_count]
        if not candidates:
            return None
        return topo.rng.choice(candidates)


def rank_repair_targets(nodes, holder_urls) -> "list[str]":
    """Deterministic rack-aware candidate ranking for placing a
    repaired replica or rebuilt EC shard (the autopilot planner's
    placement primitive — the pure, seedless sibling of
    find_empty_slots' randomized growth placement).

    `nodes` is any iterable of objects with ``url``, ``data_center``,
    ``rack`` and ``free_slots`` attributes (autopilot/plan.NodeState);
    `holder_urls` the urls already holding a copy/shard of the volume.
    Candidates exclude current holders and full nodes, and are ordered:

      1. racks holding the FEWEST existing copies first (a repair must
         widen failure domains, not deepen one — the reference's
         command_volume_fix_replication.go preference);
      2. more free slots first (capacity-weighted like pick_weighted,
         but deterministically);
      3. url ascending (the total-order tiebreak that makes identical
         snapshots produce identical plans).
    """
    by_url = {n.url: n for n in nodes}
    rack_load: dict[tuple, int] = {}
    for u in holder_urls:
        n = by_url.get(u)
        if n is not None:
            key = (n.data_center, n.rack)
            rack_load[key] = rack_load.get(key, 0) + 1
    candidates = [n for n in by_url.values()
                  if n.url not in holder_urls and n.free_slots > 0]
    candidates.sort(key=lambda n: (
        rack_load.get((n.data_center, n.rack), 0),
        -n.free_slots, n.url))
    return [n.url for n in candidates]


def find_empty_slots(topo: Topology, rp: ReplicaPlacement,
                     preferred_dc: str | None = None
                     ) -> list[DataNode]:
    """Pick rp.copy_count() servers satisfying the xyz constraints:
    1 main server; rp.same_rack more on other servers of the same rack;
    rp.diff_rack more on other racks of the same DC; rp.diff_dc more on
    other DCs (volume_growth.go:106-202).
    """
    dcs = [dc for dc in topo.data_centers.values()
           if preferred_dc in (None, "", dc.id)]
    topo.rng.shuffle(dcs)
    last_err = "no data centers with capacity"
    for dc in dcs:
        try:
            return _place_in_dc(topo, dc, rp)
        except PlacementError as e:
            last_err = str(e)
    raise PlacementError(last_err)


def _place_in_dc(topo: Topology, main_dc: DataCenter,
                 rp: ReplicaPlacement) -> list[DataNode]:
    # main rack must supply 1 + same_rack servers; main DC must supply
    # 1 + diff_rack racks; cluster must supply 1 + diff_dc DCs.
    other_dcs = [d for d in topo.data_centers.values()
                 if d is not main_dc and d.free_space() > 0]
    if len(other_dcs) < rp.diff_dc:
        raise PlacementError(
            f"need {rp.diff_dc} other DCs with capacity, "
            f"have {len(other_dcs)}")

    racks = [r for r in main_dc.racks.values() if r.free_space() > 0]
    topo.rng.shuffle(racks)
    for main_rack in racks:
        other_racks = [r for r in main_dc.racks.values()
                       if r is not main_rack and r.free_space() > 0]
        if len(other_racks) < rp.diff_rack:
            continue
        nodes = [n for n in main_rack.nodes.values() if n.free_space() > 0]
        if len(nodes) < 1 + rp.same_rack:
            continue
        picked = topo.pick_weighted(nodes, 1 + rp.same_rack)
        if len(picked) < 1 + rp.same_rack:
            continue
        # one server from each of rp.diff_rack other racks
        for r in topo.pick_weighted(other_racks, rp.diff_rack):
            n = topo.pick_weighted(list(r.nodes.values()), 1)
            if not n:
                raise PlacementError(f"rack {r.id} has no free server")
            picked += n
        # one server from each of rp.diff_dc other DCs
        for d in topo.pick_weighted(other_dcs, rp.diff_dc):
            all_nodes = [n for r in d.racks.values()
                         for n in r.nodes.values()]
            n = topo.pick_weighted(all_nodes, 1)
            if not n:
                raise PlacementError(f"dc {d.id} has no free server")
            picked += n
        if len(picked) == rp.copy_count:
            return picked
    raise PlacementError(
        f"dc {main_dc.id}: no rack satisfies replication "
        f"{rp} (need 1+{rp.same_rack} servers in one rack, "
        f"{rp.diff_rack} other racks)")
