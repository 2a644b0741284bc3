"""The port's topology (seaweedfs_tpu_torch/topology/) against the JAX
package's: the same heartbeats build the same tree, and under one seeded
random stream the same placements come out.

The reference draws from the module-global `random`; the port draws from
the `random.Random` its Topology holds. Seeding `random.seed(s)` on one
side and `Topology(rng=random.Random(s))` on the other gives both the
same Mersenne Twister stream, so every pick must be equal: the tolerance
is exact, node for node and vid for vid.
"""

from __future__ import annotations

import random

import pytest

from seaweedfs_tpu.pb import messages as ref_pb
from seaweedfs_tpu.shell import ec_commands as ref_ec
from seaweedfs_tpu.storage.super_block import ReplicaPlacement as RefRP
from seaweedfs_tpu.topology import layout as ref_layout
from seaweedfs_tpu.topology import tree as ref_tree
from seaweedfs_tpu_torch.pb import messages as pb
from seaweedfs_tpu_torch.shell import ec_commands as ec
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.topology import layout
from seaweedfs_tpu_torch.topology import tree


def _heartbeats(seed: int) -> list[dict]:
    """Heartbeat bodies of a cluster of 3 DCs x up to 3 racks x up to 3
    servers, with some volumes and EC shards each."""
    rng = random.Random(seed)
    out = []
    vid = 0
    for d in range(3):
        for r in range(rng.randint(1, 3)):
            for s in range(rng.randint(1, 3)):
                vols = []
                for _ in range(rng.randint(0, 3)):
                    vid += 1
                    vols.append({"id": vid, "size": rng.randint(0, 1 << 20),
                                 "collection": rng.choice(("", "c")),
                                 "replica_placement": 0})
                ec = [{"id": 1000 + rng.randint(0, 3), "collection": "",
                       "ec_index_bits": rng.getrandbits(14)}
                      for _ in range(rng.randint(0, 2))]
                out.append({
                    "ip": f"10.{d}.{r}.{s}", "port": 8080,
                    "public_url": f"10.{d}.{r}.{s}:8080",
                    "max_volume_count": rng.randint(2, 12),
                    "data_center": f"dc{d}", "rack": f"rack{r}",
                    "volumes": vols, "ec_shards": ec})
    return out


def _pair(seed: int):
    """(reference Topology, port Topology) from the same heartbeats;
    the reference's global stream and the port's own, seeded alike."""
    ref = ref_tree.Topology(pulse_seconds=5.0)
    port = tree.Topology(pulse_seconds=5.0, rng=random.Random(seed))
    for hb in _heartbeats(seed):
        ref.register_heartbeat(ref_pb.Heartbeat.from_dict(hb))
        port.register_heartbeat(pb.Heartbeat.from_dict(hb))
    random.seed(seed)
    return ref, port


def _tree(t) -> list:
    return [(dc.id, r.id, n.id, n.free_space(), n.volume_count(),
             n.ec_shard_count())
            for dc in t.data_centers.values()
            for r in dc.racks.values() for n in r.nodes.values()]


@pytest.mark.parametrize("seed", range(4))
def test_heartbeats_build_the_same_tree(seed):
    ref, port = _pair(seed)
    assert _tree(port) == _tree(ref)
    assert port.max_volume_id == ref.max_volume_id
    assert {v: sorted(n) for v, n in port.volume_locations.items()} == \
        {v: sorted(n) for v, n in ref.volume_locations.items()}
    assert {v: {s: [n.id for n in ns] for s, ns in m.items()}
            for v, m in port.ec_shard_locations.items()} == \
        {v: {s: [n.id for n in ns] for s, ns in m.items()}
         for v, m in ref.ec_shard_locations.items()}


@pytest.mark.parametrize("seed", range(4))
def test_pick_weighted_is_the_same_under_one_stream(seed):
    ref, port = _pair(seed)
    ref_nodes, port_nodes = ref.all_nodes(), port.all_nodes()
    for k in (1, 2, 3, 5):
        for _ in range(20):
            assert [n.id for n in port.pick_weighted(port_nodes, k)] == \
                [n.id for n in ref.pick_weighted(ref_nodes, k)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rp", ["000", "001", "010", "100", "011", "110",
                                "200", "020"])
def test_find_empty_slots_is_the_same_under_one_stream(seed, rp):
    ref, port = _pair(seed)
    for dc in (None, "dc1"):
        for _ in range(10):
            try:
                want = [n.id for n in ref_layout.find_empty_slots(
                    ref, RefRP.parse(rp), dc)]
            except ref_layout.PlacementError as e:
                with pytest.raises(layout.PlacementError) as got:
                    layout.find_empty_slots(port, ReplicaPlacement.parse(rp),
                                            dc)
                assert str(got.value) == str(e)
                continue
            assert [n.id for n in layout.find_empty_slots(
                port, ReplicaPlacement.parse(rp), dc)] == want


@pytest.mark.parametrize("seed", range(4))
def test_pick_for_write_is_the_same_under_one_stream(seed):
    ref, port = _pair(seed)
    key = ("", "000", "")
    ref_lay = ref_layout.VolumeLayout(ref_layout.LayoutKey(*key), 1 << 30)
    port_lay = layout.VolumeLayout(layout.LayoutKey(*key), 1 << 30)
    for vid in sorted(ref.volume_locations):
        ref_lay.set_writable(vid, True)
        port_lay.set_writable(vid, True)
    for _ in range(50):
        assert port_lay.pick_for_write(port, 1) == \
            ref_lay.pick_for_write(ref, 1)


def test_default_stream_is_one_per_process():
    """A Topology given no stream draws from the process-wide default,
    never from the module-global `random`."""
    a, b = tree.Topology(), tree.Topology()
    assert a.rng is b.rng is tree.DEFAULT_RNG
    assert a.rng is not random._inst


def test_rank_repair_targets_equal():
    rng = random.Random(3)
    from seaweedfs_tpu.autopilot.plan import NodeState as RefNode
    from seaweedfs_tpu_torch.autopilot.plan import NodeState
    for _ in range(40):
        specs = [dict(url=f"10.0.0.{i}:80", data_center=f"dc{rng.randint(0, 1)}",
                      rack=f"r{rng.randint(0, 2)}",
                      free_slots=rng.randint(0, 4))
                 for i in range(rng.randint(1, 8))]
        holders = [s["url"] for s in specs if rng.random() < 0.3]
        assert layout.rank_repair_targets(
            [NodeState(**s) for s in specs], holders) == \
            ref_layout.rank_repair_targets(
                [RefNode(**s) for s in specs], holders)


@pytest.mark.parametrize("seed", range(8))
def test_balanced_ec_distribution_equal(seed):
    rng = random.Random(seed)
    nodes = [{"url": f"10.0.0.{i}:8080", "freeSlots": rng.randint(-1, 6)}
             for i in range(rng.randint(0, 9))]
    source = nodes[0]["url"] if nodes else "10.0.0.0:8080"
    got = ec.balanced_ec_distribution(nodes, source)
    assert got == ref_ec.balanced_ec_distribution(nodes, source)
    assert sorted(s for ss in got.values() for s in ss) == list(range(14))
